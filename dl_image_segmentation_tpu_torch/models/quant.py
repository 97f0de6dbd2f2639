"""Int8 post-training quantization for serving (a port of the JAX
package's ``models/quant.py``).

``Int8Conv`` is an ``nn.Conv2d`` with the float conv's parameters
(``weight`` OIHW float32, ``bias`` float32), so a float checkpoint serves
quantized with no conversion; in the U-Net the int8 model shares the
float model's parameter tensors. Its forward:

* weights quantized per output channel (symmetric max-abs / 127 over
  each kernel's I, H, W);
* activations quantized per example (max-abs / 127 over C, H, W), or,
  ``static``, with one calibrated constant scale: the ``act_amax``
  buffer, a running max-abs that only a calibration pass updates;
* the int8 x int8 -> int32 conv as an im2col of ``Tensor.unfold`` views
  (``F.unfold`` has no int8) and ``torch._int_mm``, with SAME zero
  padding on the int8 tensor and K padded with zeros to a multiple of 8;
  integer sums are exact, so the card's int32 output equals the CPU's
  and XLA's bit for bit. ``_int_mm`` is a library GEMM, as the JAX
  package's is an XLA conv; a shape it refuses raises, there is no float
  fallback;
* the rescale ``y.float() * (x_scale * w_scale) + bias`` rounded once,
  as the fused multiply-add that XLA compiles it to (``ops/rasterize.py:
  _fma32``: a float64 round-to-odd emulation, the same bits on the card
  and the CPU), cast to the compute dtype. Rounded twice, one output in
  four took another float32 value, and a quantization step later the
  flips cascaded to 2-3% of the largest logit.

On a sharded model the int8 conv runs through its layer's wrapper, as
the float conv does (``Int8Conv.quantized``), and on height bands its
activation max-abs is the maximum over the bands.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.rasterize import _fma32
from .layers import Window, call_layer, same_pads

__all__ = ["Int8Conv", "int8_conv2d", "quantize_tensor"]

_INV_127 = 1.0 / 127.0  # float32(1 / 127) = 0.00787401572 once applied


def quantize_tensor(x: torch.Tensor, dims=None, keepdim: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric max-abs int8 quantization: (q, scale) with ``x ~= q *
    scale``. ``scale`` is float32, max(amax / 127, 1e-12), per remaining
    axis when ``dims`` (the reduced axes) is given, else a scalar; q is
    round-half-even of ``x / scale`` (a division, as XLA divides) clipped
    to +-127. XLA compiles ``amax / 127`` to ``amax * float32(1 / 127)``,
    and so does this: the JAX package's jitted scales, bit for bit."""
    ax = x.abs()
    amax = ax.amax() if dims is None else ax.amax(dim=dims, keepdim=True)
    scale = _scale(amax)
    q = _quantize(x, scale)
    if dims is not None and not keepdim:
        scale = scale.squeeze(dims)
    return q, scale


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(amax.float() * _INV_127, min=1e-12)


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(
        torch.int8)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_conv2d(qx: torch.Tensor, qw: torch.Tensor, stride: int = 1,
                band: bool = False) -> torch.Tensor:
    """int8 (N, C, H, W) x int8 (O, C, kh, kw) -> int32 (N, Ho, Wo, O),
    SAME zero padding, as ``lax.conv_general_dilated(...,
    preferred_element_type=int32)``. An im2col of ``unfold`` views (rows
    (n, i, j), columns (c, a, b), the kernel's order) and one
    ``torch._int_mm``; K and O are padded with zeros to multiples of 8
    and M to at least 24, which the card's int8 GEMM needs, and the
    padding is cut from the result. ``band``: the rows of a height band
    that the output rows read, padded in height already (SAME in width
    only)."""
    n, c, h, w = qx.shape
    o, _, kh, kw = qw.shape
    top, bottom = (0, 0) if band else same_pads(h, kh, stride)
    left, right = same_pads(w, kw, stride)
    if top or bottom or left or right:
        qx = F.pad(qx, (left, right, top, bottom))
    # (N, C, Ho, Wo, kh, kw) view -> rows (n, i, j), columns (c, a, b)
    cols = qx.unfold(2, kh, stride).unfold(3, kw, stride)
    ho, wo = cols.shape[2], cols.shape[3]
    a = cols.permute(0, 2, 3, 1, 4, 5).reshape(n * ho * wo, c * kh * kw)
    b = qw.reshape(o, c * kh * kw)
    m, k = a.shape
    k8, o8, m8 = _round_up(k, 8), _round_up(o, 8), max(m, 24)
    if k8 != k or m8 != m:
        a = F.pad(a, (0, k8 - k, 0, m8 - m))
    if k8 != k or o8 != o:
        b = F.pad(b, (0, k8 - k, 0, o8 - o))
    y = torch._int_mm(a, b.t())
    return y[:m, :o].reshape(n, ho, wo, o)


class Int8Conv(nn.Conv2d):
    """``nn.Conv2d``-compatible int8 convolution with SAME padding (the
    JAX package's ``Int8Conv``). ``static``: activations take the
    calibrated constant scale ``act_amax / 127`` (buffer, float32 scalar);
    while ``calibrating`` is set, each forward first folds its input's
    max-abs into ``act_amax``."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, stride: int = 1, static: bool = False):
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride)
        self.static = static
        self.calibrating = False
        if static:
            self.register_buffer("act_amax", torch.zeros((),
                                                         dtype=torch.float32))

    def quantized(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """(N, C, H, W) activations -> (N, O, Ho, Wo) in ``dtype``. On a
        sharded model the conv runs through its ``spmd`` wrapper as the
        float conv does: a column-parallel conv quantizes its own output
        channels' kernels (the scale is per output channel), a stored
        shard is gathered in float and then quantized, and on a height
        band the activation max-abs (per example, or the calibrated
        ``act_amax``) is the maximum over all bands."""
        spmd = self.__dict__.get("spmd")
        bands = getattr(spmd, "bands", None)
        if self.static:
            if self.calibrating:
                with torch.no_grad():
                    amax = _band_max(x.abs().amax().float(), bands)
                    self.act_amax.copy_(torch.maximum(self.act_amax, amax))
            x_scale = _scale(self.act_amax)
        else:
            x_scale = _scale(_band_max(
                x.abs().amax(dim=(1, 2, 3), keepdim=True), bands))
        qx = _quantize(x, x_scale)
        stride, k = self.stride[0], self.kernel_size[0]

        def fn(qx, w, b, band=False):
            qw, w_scale = quantize_tensor(w, dims=(1, 2, 3))  # (O,)
            y = int8_conv2d(qx, qw, stride, band)
            # scalar (static) or (N, 1, 1, 1) times (O,): one combined
            # scale; XLA fuses the multiply-add, so the port rounds it
            # once too
            y = _fma32(y.float(), x_scale * w_scale, b)
            # contiguous NCHW, as a gathered column-parallel output is:
            # the GroupNorm after it sums in the order its layout gives
            return y.permute(0, 3, 1, 2).to(dtype).contiguous()
        return call_layer(self, qx, fn, Window(k, stride))


def _band_max(amax: torch.Tensor, bands) -> torch.Tensor:
    """``amax``, or on a height band its maximum over every band."""
    if bands is None:
        return amax
    import torch.distributed as dist
    from ..parallel.spmd import all_reduce
    return all_reduce(amax, bands.group, dist.ReduceOp.MAX)
