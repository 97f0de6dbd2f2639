"""Scene-stack compositing: cloud-masked temporal median and
nearest-to-date valid-pixel mosaic.

Counterparts of the JAX package's ops/compositing.py, for the two
mosaic strategies of the reference:

* ``create_cloudmasked_s2_array`` -- np.ma.median over the scene axis
  of a cloud-masked stack (dl_segmentation_utils/_descartes_img_chips.py:
  557-567). :func:`masked_median` is the plain PyTorch version;
  :func:`masked_median_kernel` launches the hand-written CUDA kernel
  (csrc/masked_median.cu) for a CUDA tensor and runs the plain version
  for a CPU tensor.
* ``create_img_array_for_tile`` -- "last wins" mosaic over scenes
  sorted by descending |date - ref_date| (_descartes_img_chips.py:
  617-627), as an argmin over date distance masked by validity
  (:func:`nearest_valid_mosaic`, plain PyTorch on any device).

Layouts are the JAX package's: stack (S, H, W, B), valid (S, H, W).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import kernels
from ..device import resolve_device

# invalid samples take this value so they sort last (the JAX package's
# _INF; the kernel's float32 path ranks them by the same value)
_INF = 3.0e38

# element budget of one chunk of the plain median's sort, which would
# otherwise hold the float stack, its sorted copy and int64 indices at once
_CHUNK_ELEMS = 1 << 24

# stack dtypes the kernel reads directly (codes of csrc/masked_median.cu):
# uint16 is what the Sentinel-2 catalog delivers; others are converted to
# float32 first, which gives the values the kernel's conversion would
_KERNEL_DTYPES = {torch.uint16: 0, torch.float32: 1}


def masked_median(stack: torch.Tensor, valid: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Median over axis 0 of ``stack`` (S, H, W, B) counting only
    samples where ``valid`` (S, H, W) or (S, H, W, B) is True.

    Returns (median (H, W, B) float32, any_valid (H, W, B) bool). Pixels
    with zero valid samples return 0 with any_valid False; even counts
    average the two middle values. Sort-based, in row chunks so that memory stays bounded."""
    S, H, W, B = stack.shape
    if valid.dim() == stack.dim() - 1:
        valid = valid[..., None]
    rows = max(1, _CHUNK_ELEMS // max(1, S * W * B))
    meds, anys = [], []
    for r0 in range(0, H, rows):
        x = stack[:, r0:r0 + rows].float()
        v = valid[:, r0:r0 + rows].expand(x.shape)
        vals = torch.where(v, x, torch.tensor(_INF, dtype=torch.float32,
                                              device=x.device))
        svals = torch.sort(vals, dim=0).values
        n = v.sum(dim=0)
        nz = n.clamp(min=1)
        lo = torch.gather(svals, 0, ((nz - 1) // 2)[None])[0]
        hi = torch.gather(svals, 0, (nz // 2)[None])[0]
        med = (lo + hi) * 0.5
        any_valid = n > 0
        meds.append(torch.where(any_valid, med, torch.zeros_like(med)))
        anys.append(any_valid)
    return torch.cat(meds), torch.cat(anys)


def masked_median_kernel(stack: torch.Tensor, valid: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked median (same contract as :func:`masked_median`) through
    the CUDA kernel for a CUDA ``stack``; the plain version for a CPU
    ``stack``.

    stack: (S, H, W, B) uint16 or float32, contiguous;
    valid: (S, H, W) bool on the same device."""
    if stack.device.type == "cpu":
        return masked_median(stack, valid)
    if stack.device.type != "cuda" or valid.device != stack.device:
        raise ValueError(f"masked_median_kernel: stack on {stack.device}, "
                         f"valid on {valid.device}")
    if stack.dim() != 4 or tuple(valid.shape) != tuple(stack.shape[:3]):
        raise ValueError(f"masked_median_kernel: stack {tuple(stack.shape)}"
                         f" needs valid (S, H, W), got {tuple(valid.shape)}")
    if stack.dtype not in _KERNEL_DTYPES or valid.dtype != torch.bool:
        raise TypeError(f"masked_median_kernel: stack {stack.dtype}, "
                        f"valid {valid.dtype}")
    if not (stack.is_contiguous() and valid.is_contiguous()):
        raise ValueError("masked_median_kernel: inputs must be contiguous")
    max_scenes = kernels.library("masked_median").masked_median_max_scenes()
    S, H, W, B = stack.shape
    if not 1 <= S <= max_scenes:
        raise ValueError(
            f"masked_median_kernel: {S} scenes; the kernel takes 1.."
            f"{max_scenes} and never drops scenes")
    if stack.numel() >= 1 << 31:
        raise ValueError(f"masked_median_kernel: {stack.numel()} samples; "
                         "the kernel's offsets are 32-bit (below 2^31)")
    med = torch.empty((H, W, B), dtype=torch.float32, device=stack.device)
    any_valid = torch.empty((H, W, B), dtype=torch.bool, device=stack.device)
    _launch_masked_median(stack, valid, med, any_valid)
    return med, any_valid


def _launch_masked_median(stack, valid, med, any_valid) -> None:
    """Launch the kernel onto ``med`` and ``any_valid`` (H, W, B) on the
    current stream and count the launch; inputs as checked by
    :func:`masked_median_kernel`."""
    S, H, W, B = stack.shape
    rc = kernels.library("masked_median").masked_median_launch(
        stack.data_ptr(), _KERNEL_DTYPES[stack.dtype], valid.data_ptr(),
        med.data_ptr(), any_valid.data_ptr(), S, H * W * B, B,
        kernels.stream_ptr(stack.device))
    kernels.check(rc, "masked_median")
    kernels.MASKED_MEDIAN.add()


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def masked_median_composite(stack, valid, device=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked median of a numpy or torch stack (S, H, W, B) with validity
    (S, H, W), on ``device`` (None -> CUDA): the CUDA kernel on the card,
    the plain version on the CPU. Returns (median (H, W, B) float32,
    any_valid (H, W, B) bool) on ``device``."""
    dev = resolve_device(device)
    x = _as_tensor(stack, dev)
    if x.dtype not in _KERNEL_DTYPES:
        x = x.float()
    v = _as_tensor(valid, dev).bool()
    return masked_median_kernel(x.contiguous(), v.contiguous())


def nearest_valid_mosaic(stack, valid, date_dist, device=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel select the valid scene minimising ``date_dist``.

    stack: (S, H, W, B); valid: (S, H, W) or (S, H, W, B); date_dist:
    (S,) absolute days from the reference date, or (S, H, W) per-pixel
    distances (the batched multi-tile compositor). Numpy or torch
    inputs, computed on ``device`` (None -> CUDA).

    Exactly reproduces sorted-descending last-wins mosaicking
    (_descartes_img_chips.py:617-627): ties break toward the LATER scene
    in the original ordering, done exactly by an argmin over the
    REVERSED scene axis (torch.argmin returns the first minimal index).
    Returns (mosaic (H, W, B) float32, any_valid (H, W, B) bool)."""
    dev = resolve_device(device)
    x = _as_tensor(stack, dev).float()
    v = _as_tensor(valid, dev).bool()
    if v.dim() == x.dim() - 1:
        v = v[..., None]
    v = v.expand(x.shape)
    S = x.shape[0]
    dd = _as_tensor(date_dist, dev).float()
    if dd.dim() == 1:
        dd = dd[:, None, None]
    score = torch.where(v, dd[..., None].expand(x.shape),
                        torch.tensor(_INF, dtype=torch.float32, device=dev))
    sel = (S - 1) - torch.argmin(score.flip(0), dim=0)
    mosaic = torch.gather(x, 0, sel[None])[0]
    any_valid = v.any(dim=0)
    return (torch.where(any_valid, mosaic, torch.zeros_like(mosaic)),
            any_valid)


def pad_stack(stack: np.ndarray, valid: np.ndarray, to_depth: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad the scene axis to a static depth (padding scenes invalid).

    Never truncates: dropping scenes would silently change the
    composite -- raise so the caller picks to_depth >= S."""
    S = stack.shape[0]
    if S > to_depth:
        raise ValueError(
            f"stack has {S} scenes, more than to_depth={to_depth}; "
            "padding must not silently drop scenes")
    if S == to_depth:
        return stack, valid
    pad_s = [(0, to_depth - S)] + [(0, 0)] * (stack.ndim - 1)
    pad_v = [(0, to_depth - S)] + [(0, 0)] * (valid.ndim - 1)
    return (np.pad(stack, pad_s), np.pad(valid, pad_v))
