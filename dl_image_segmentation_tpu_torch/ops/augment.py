"""Batch augmentation of segmentation pairs on the device.

A port of the JAX package's ``ops/augment.py``. Each random op has two
parts: a draw function that takes its random numbers from an explicit
``torch.Generator`` (on the batch's device), and a pure apply function
that takes those draws as tensors, so the same draws (the JAX package's,
in the tests) give the same output. Geometric ops are the dihedral
group (flips and 90-degree rotations: exact, label-safe), applied to
image and label alike; photometric ops touch the image only. The order
is the JAX package's: hflip, vflip, rot90, invert, contrast, then
brightness with clip. :func:`rotate_pairs` rotates by any angle, as the
JAX package's ``random_rotate_pairs`` does with ``map_coordinates``.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import math
from typing import Dict, Optional, Tuple

import torch

from .rasterize import _fma32

__all__ = ["apply_augment", "augment_pairs", "draw_augment", "normalize",
           "random_invert_pairs", "random_rotate_pairs", "rotate_pairs"]


def draw_augment(generator: torch.Generator, n: int, hflip: bool = True,
                 vflip: bool = True, rot90: bool = True,
                 invert_prob: float = 0.0, brightness: float = 0.0,
                 contrast: float = 0.0, device=None
                 ) -> Dict[str, torch.Tensor]:
    """The random draws of :func:`apply_augment` for ``n`` examples: bool
    masks ``hflip``, ``vflip``, ``invert`` (n,), rotation counts ``k``
    in [0, 4) (n,), contrast factors ~ U(1 - c, 1 + c) and brightness
    deltas ~ U(-b, b) (n, 1, 1, 1); only the enabled ones."""
    dev = generator.device if device is None else device
    d: Dict[str, torch.Tensor] = {}

    def coin(p):
        return torch.rand(n, generator=generator, device=dev) < p

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand((n, 1, 1, 1), generator=generator,
                                           device=dev)
    if hflip:
        d["hflip"] = coin(0.5)
    if vflip:
        d["vflip"] = coin(0.5)
    if rot90:
        d["k"] = torch.randint(0, 4, (n,), generator=generator, device=dev)
    if invert_prob > 0:
        d["invert"] = coin(invert_prob)
    if contrast > 0:
        d["contrast"] = uniform(1.0 - contrast, 1.0 + contrast)
    if brightness > 0:
        d["brightness"] = uniform(-brightness, brightness)
    return d


def _select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    return torch.where(mask.view((-1,) + (1,) * (a.dim() - 1)), a, b)


def apply_augment(images: torch.Tensor, labels: torch.Tensor,
                  draws: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply the draws of :func:`draw_augment`: images (N, H, W, C)
    float, labels (N, H, W). A key missing from ``draws`` is an op that
    is off."""
    if "hflip" in draws:
        m = draws["hflip"]
        images = _select(m, images.flip(2), images)
        labels = _select(m, labels.flip(2), labels)
    if "vflip" in draws:
        m = draws["vflip"]
        images = _select(m, images.flip(1), images)
        labels = _select(m, labels.flip(1), labels)
    if "k" in draws:
        if images.shape[1] != images.shape[2]:
            raise ValueError(
                f"rot90 augmentation needs square tiles, got "
                f"{images.shape[1]}x{images.shape[2]}; pass rot90=False "
                "for rectangular chips")
        k = draws["k"]
        out_i, out_l = images, labels
        for j in (1, 2, 3):
            out_i = _select(k == j, torch.rot90(images, j, dims=(1, 2)),
                            out_i)
            out_l = _select(k == j, torch.rot90(labels, j, dims=(1, 2)),
                            out_l)
        images, labels = out_i, out_l
    if "invert" in draws:
        images = _select(draws["invert"], 1.0 - images, images)
    if "contrast" in draws:
        mean = images.mean(dim=(1, 2), keepdim=True)
        images = mean + (images - mean) * draws["contrast"]
    if "brightness" in draws:
        images = torch.clamp(images + draws["brightness"], 0.0, 1.0)
    return images, labels


def augment_pairs(images: torch.Tensor, labels: torch.Tensor,
                  generator: torch.Generator, hflip: bool = True,
                  vflip: bool = True, rot90: bool = True,
                  invert_prob: float = 0.0, brightness: float = 0.0,
                  contrast: float = 0.0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random dihedral and photometric augmentation: draws from
    ``generator``, then :func:`apply_augment`. Photometric knobs, per
    example: ``invert_prob`` (images on [0, 1]), ``brightness`` (additive
    U(-b, b), clipped to [0, 1]) and ``contrast`` (factor U(1 - c, 1 + c)
    around the per-example, per-channel mean)."""
    draws = draw_augment(generator, images.shape[0], hflip, vflip, rot90,
                         invert_prob, brightness, contrast,
                         device=images.device)
    return apply_augment(images, labels, draws)


def normalize(images: torch.Tensor, mean: torch.Tensor,
              std: torch.Tensor) -> torch.Tensor:
    """(x - mean) / std per channel."""
    return (images - mean) / std


def random_invert_pairs(images: torch.Tensor, labels: torch.Tensor,
                        prob: float = 0.5, max_value: float = 1.0,
                        generator: Optional[torch.Generator] = None,
                        flip: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-example intensity inversion ``max_value - x`` with probability
    ``prob``; labels unchanged. ``flip`` (n,) bool is the draw; without
    it, ``torch.rand(n) < prob`` from ``generator``."""
    if flip is None:
        if generator is None:
            raise ValueError("pass a generator or the flip draws")
        flip = torch.rand(images.shape[0], generator=generator,
                          device=images.device) < prob
    return _select(flip, max_value - images, images), labels


_libm = None


def _cos_sin(angles: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 cos and sin of ``angles`` (N,), each (N, 1, 1) on their
    device. XLA:CPU lowers ``jnp.cos``/``jnp.sin`` of float32 to the C
    library's ``cosf``/``sinf``, which are not correctly rounded (up to
    0.56 ulp), and torch's differ from them in ~5% of angles; so the
    values come from the same ``cosf``/``sinf``, on the host (one value
    per image: a copy of N floats)."""
    global _libm
    if _libm is None:
        lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
        for fn in (lib.cosf, lib.sinf):
            fn.restype = ctypes.c_float
            fn.argtypes = [ctypes.c_float]
        _libm = lib
    host = angles.detach().to("cpu", torch.float32).tolist()
    cos = torch.tensor([_libm.cosf(a) for a in host], dtype=torch.float32)
    sin = torch.tensor([_libm.sinf(a) for a in host], dtype=torch.float32)
    return (cos.view(-1, 1, 1).to(angles.device),
            sin.view(-1, 1, 1).to(angles.device))


def _round_away(v: torch.Tensor) -> torch.Tensor:
    """Round half away from zero (XLA's round-nearest-afz); ``v - trunc(v)``
    is exact, where ``floor(|v| + 0.5)`` would round 0.49999997 up."""
    t = torch.trunc(v)
    return t + torch.where((v - t).abs() >= 0.5, torch.sign(v), 0.0)


def rotate_pairs(images: torch.Tensor, labels: torch.Tensor,
                 angles: torch.Tensor, fill_label: int = 255
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate each pair about its centre by ``angles`` (N,) float32
    radians: images (N, H, W, C) float bilinearly with 0 outside, labels
    (N, H, W) by nearest neighbour with ``fill_label`` outside. The
    semantics of ``jax.scipy.ndimage.map_coordinates`` (mode
    ``constant``: order 1 weighs each in-range corner, order 0 rounds
    half away from zero), with the multiply-adds that XLA:CPU fuses
    computed fused (``_fma32``). XLA rounds the source row twice: as
    ``fma(dy, ca, cy) - dx * sa`` where it becomes an index (the labels'
    rounding, the images' corners) and as ``fma(-dx, sa, fma(dy, ca,
    cy))`` where it becomes a weight; at a coordinate within an ulp of an
    integer the two may take different corners, and so does this. The
    four corner terms sum as ``fma(w11, v11, fma(w10, v10, fma(w00, v00,
    w01 * v01)))``."""
    n, h, w = labels.shape
    dev = images.device
    ca, sa = _cos_sin(angles)
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    cy = torch.tensor((h - 1) / 2.0, device=dev)
    cx = torch.tensor((w - 1) / 2.0, device=dev)
    dy, dx = yy - cy, xx - cx
    b = torch.arange(n, device=dev).view(n, 1, 1)

    def inside(iy, ix):
        return (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)

    def at(src, iy, ix):
        return src[b, iy.clamp(0, h - 1), ix.clamp(0, w - 1)]

    # the source coordinates where they index
    sy = _fma32(dy, ca, cy) - dx * sa
    sx = _fma32(dy, sa, cx) + dx * ca
    # labels: order 0
    iy, ix = _round_away(sy).to(torch.int64), _round_away(sx).to(torch.int64)
    rot_l = torch.where(inside(iy, ix), at(labels.to(torch.float32), iy, ix),
                        float(fill_label)).to(labels.dtype)
    # images: order 1, corners from the index rounding, weights from the
    # fused one
    iy0, ix0 = torch.floor(sy).to(torch.int64), torch.floor(sx).to(torch.int64)
    fy = _fma32(-dx, sa, _fma32(dy, ca, cy))
    fx = _fma32(dx, ca, _fma32(dy, sa, cx))
    wy1, wx1 = fy - torch.floor(fy), fx - torch.floor(fx)
    wy0, wx0 = 1 - wy1, 1 - wx1
    img = images.to(torch.float32)
    terms = []
    for iy, wy in ((iy0, wy0), (iy0 + 1, wy1)):
        for ix, wx in ((ix0, wx0), (ix0 + 1, wx1)):
            v = torch.where(inside(iy, ix).unsqueeze(-1), at(img, iy, ix),
                            0.0)
            terms.append(((wy * wx).unsqueeze(-1).expand_as(v), v))
    (w00, v00), (w01, v01), (w10, v10), (w11, v11) = terms
    acc = _fma32(w00, v00, w01 * v01)
    acc = _fma32(w11, v11, _fma32(w10, v10, acc))
    return acc.to(images.dtype), rot_l


def random_rotate_pairs(generator: torch.Generator, images: torch.Tensor,
                        labels: torch.Tensor, max_degrees: float = 180.0,
                        fill_label: int = 255
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Arbitrary-angle rotation augmentation: one angle per example,
    uniform in [-max_degrees, max_degrees), drawn from ``generator``
    (on the batch's device), then :func:`rotate_pairs`."""
    u = torch.rand(images.shape[0], generator=generator,
                   device=images.device) * 2.0 - 1.0
    return rotate_pairs(images, labels,
                        u * float(max_degrees * math.pi / 180.0),
                        fill_label)
