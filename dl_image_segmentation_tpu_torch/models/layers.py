"""Layers that the port's three model families share, with the flax
numerics of the JAX package's models.

* ``same_pads`` / ``pad_same``: lax's SAME rule for any kernel, stride
  and dilation (``total = max((ceil(n/s) - 1) s + (k - 1) d + 1 - n,
  0)``, the smaller half before), applied with ``F.pad`` before a conv.
* ``_conv2d``: ``F.conv2d`` whose result, in an inference forward on the
  card, does not depend on an image's slot in the batch.
* ``layer_norm``: flax's ``nn.LayerNorm`` (epsilon 1e-6, float32
  statistics with the fast variance ``max(E[x^2] - E[x]^2, 0)``, output
  in the compute dtype).
* ``gelu``: flax's default tanh approximation.
* ``resize_bilinear``: ``jax.image.resize(method="bilinear")`` as two
  matrix contractions, H first, in the input's dtype, with JAX's weight
  matrices (half-pixel centres, renormalised at the edges, zero outside
  ``[-0.5, n - 0.5]``). Matmuls, unlike ``F.interpolate``, have a
  deterministic backward on the card and give the same bits as JAX at
  bfloat16.
* ``lecun_normal_``: flax's default kernel init from a torch Generator.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["GN_EPS", "LN_EPS", "call_layer", "conv_same", "gelu", "group_norm",
           "layer_norm", "lecun_normal_", "linear", "pad_same",
           "resize_bilinear", "resize_flops", "same_pads"]

GN_EPS = 1e-6  # flax nn.GroupNorm's epsilon (torch's default is 1e-5)
LN_EPS = 1e-6  # flax nn.LayerNorm's epsilon (torch's default is 1e-5)

# flax lecun_normal: truncated normal on [-2, 2], rescaled so that the
# truncated distribution's stddev is sqrt(1 / fan_in)
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator]) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


def same_pads(n: int, k: int, s: int = 1, d: int = 1) -> Tuple[int, int]:
    """(before, after) zero padding of an extent ``n`` under lax's SAME
    rule for a kernel ``k`` with stride ``s`` and dilation ``d``."""
    total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, k: int, s: int = 1, d: int = 1
             ) -> torch.Tensor:
    """``x`` (N, C, H, W) padded with zeros for a SAME k x k conv."""
    top, bottom = same_pads(x.shape[2], k, s, d)
    left, right = same_pads(x.shape[3], k, s, d)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
    return x


# (shapes, strides, dtype, conv arguments, cuDNN switches) -> whether
# cuDNN's engine for that conv gives an image other bits in another slot
# of the batch
_SLOT_DEPENDENT: dict = {}


def _slot_dependent(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    stride, padding, dilation=1, groups=1) -> bool:
    """Whether the conv that ``F.conv2d`` picks for these shapes computes
    an image with other bits when it sits in another slot of the batch,
    as an engine that splits its reduction by output tile does: the conv
    of seeded random data and of the same data rolled by one image (in
    ``x``'s strides) are compared. Random data, so that no zero input
    hides a split."""
    g = torch.Generator(device=x.device).manual_seed(0)
    xr, wr, br = (torch.empty_like(t).normal_(generator=g) for t in (x, w, b))
    rolled = torch.empty_like(xr).copy_(xr.roll(1, 0))
    kw = dict(stride=stride, padding=padding, dilation=dilation,
              groups=groups)
    y = F.conv2d(xr, wr, br, **kw)
    yr = F.conv2d(rolled, wr, br, **kw)
    return not torch.equal(yr, y.roll(1, 0))


def _conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride=1,
            padding=0, dilation=1, groups=1) -> torch.Tensor:
    """``F.conv2d``, and in an inference forward on the card an image's
    result does not depend on its slot in the batch (a served chip's
    class map must equal ``predict``'s whichever slot it was given): a
    conv whose cuDNN engine is slot dependent (one bf16 conv of the
    full-width s2d 2 U-Net is) runs without cuDNN, as an im2col and a
    GEMM per image. Each shape is tested once (``_slot_dependent``).
    Callers hold the Trainer's lock on the cuDNN switches, which this
    flips."""
    kw = dict(stride=stride, padding=padding, dilation=dilation,
              groups=groups)
    if x.is_cuda and x.shape[0] > 1 and not torch.is_grad_enabled():
        cudnn = torch.backends.cudnn
        key = (tuple(x.shape), x.stride(), tuple(w.shape), x.dtype,
               x.device, stride, padding, dilation, groups,
               cudnn.benchmark, cudnn.allow_tf32)
        if key not in _SLOT_DEPENDENT:
            _SLOT_DEPENDENT[key] = _slot_dependent(x, w, b, **kw)
        if _SLOT_DEPENDENT[key]:
            saved = cudnn.enabled
            cudnn.enabled = False
            try:
                return F.conv2d(x, w, b, **kw)
            finally:
                cudnn.enabled = saved
    return F.conv2d(x, w, b, **kw)


def call_layer(layer: nn.Module, x: torch.Tensor, fn) -> torch.Tensor:
    """``fn(x, weight, bias)``, the op of ``layer`` on its parameters. A
    layer that ``parallel/spmd.py:shard_model`` sharded carries its
    wrapper as ``layer.spmd``, which runs ``fn`` on the gathered kernel,
    this rank's output channels, or a height band with its halo rows."""
    spmd = layer.__dict__.get("spmd")
    if spmd is None:
        return fn(x, layer.weight, layer.bias)
    return spmd(x, fn)


def conv_same(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype,
              stride: int = 1, dilation: int = 1) -> torch.Tensor:
    """flax ``nn.Conv(padding="SAME")`` of ``conv``'s kernel and bias in
    the compute dtype (params stay float32); a depthwise kernel (one
    input channel a group) takes a group per input channel."""
    k = conv.weight.shape[-1]
    return call_layer(
        conv, pad_same(x.to(dtype), k, stride, dilation),
        lambda x, w, b: _conv2d(x, w.to(dtype), b.to(dtype), stride=stride,
                                dilation=dilation,
                                groups=x.shape[1] // w.shape[1]))


def linear(dense: nn.Linear, x: torch.Tensor, dtype: torch.dtype
           ) -> torch.Tensor:
    """flax ``nn.Dense`` in the compute dtype (params stay float32)."""
    return call_layer(dense, x.to(dtype), lambda x, w, b: F.linear(
        x, w.to(dtype), b.to(dtype)))


def group_norm(norm: nn.GroupNorm, x: torch.Tensor, dtype: torch.dtype
               ) -> torch.Tensor:
    """flax ``nn.GroupNorm``: float32 statistics and normalisation, the
    output in the compute dtype."""
    y = call_layer(norm, x.float(), lambda x, w, b: F.group_norm(
        x, norm.num_groups, w, b, norm.eps))
    return y.to(dtype)


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype
               ) -> torch.Tensor:
    """flax ``nn.LayerNorm`` over the last axis: float32 mean and the fast
    variance ``max(E[x^2] - E[x]^2, 0)``, ``(x - mean) * (rsqrt(var +
    eps) * scale) + bias`` in float32, cast to the compute dtype."""
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
    mul = torch.rsqrt(var + norm.eps) * norm.weight
    return ((x - mean) * mul + norm.bias).to(dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu`` (approximate=True: the tanh form)."""
    return F.gelu(x, approximate="tanh")


@functools.lru_cache(maxsize=128)
def _resize_weights(m: int, n: int, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """(m, n) weights of ``jax.image.resize``'s linear kernel from an
    extent m to n (JAX's ``compute_weight_mat`` at scale n / m, no
    translation, antialiasing when it shrinks), in float32 and then
    cast to ``dtype``."""
    f32 = np.float32
    scale = n / m
    inv = f32(1.0 / scale)
    kernel_scale = max(inv, f32(1.0))
    sample = (np.arange(n, dtype=f32) + f32(0.5)) * inv - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(m, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    w = np.where(inside[None, :], w, f32(0.0)).astype(f32)
    # a normal tensor even when first asked for under inference_mode, so
    # that a train step can save it for backward
    with torch.inference_mode(False):
        return torch.from_numpy(w).to(device=device, dtype=dtype)


def resize_bilinear(x: torch.Tensor, height: int, width: int
                    ) -> torch.Tensor:
    """``jax.image.resize(x, ..., method="bilinear")`` of an (N, C, H, W)
    tensor to (N, C, height, width), in ``x``'s dtype: H is contracted
    with its weight matrix first, then W; an extent that does not change
    is left alone, as JAX skips it."""
    h, w = x.shape[2], x.shape[3]
    if height != h:
        wh = _resize_weights(h, height, x.dtype, x.device)
        x = torch.matmul(wh.t(), x)
    if width != w:
        ww = _resize_weights(w, width, x.dtype, x.device)
        x = torch.matmul(x, ww)
    return x


def resize_flops(c: int, h: int, w: int, ho: int, wo: int) -> int:
    """FLOPs of ``resize_bilinear``'s two contractions of a c-channel map
    from (h, w) to (ho, wo) (H first; an unchanged extent is skipped)."""
    total = 0
    if ho != h:
        total += 2 * c * ho * w * h
    if wo != w:
        total += 2 * c * ho * wo * w
    return total
