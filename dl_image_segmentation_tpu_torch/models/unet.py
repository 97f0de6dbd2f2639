"""U-Net segmentation model (PyTorch port of the JAX package's flax U-Net).

The same network, layer for layer, as the reference's
``models/unet.py``: ``levels`` ConvBlocks down (each followed by a 2x2
stride-2 conv), a bottom ConvBlock, ``levels`` 2x2 stride-2 transposed
convs up (each followed by a concat with its skip and a ConvBlock), and
a 1x1 float32 logits head; optionally a space-to-depth stem and a
depth-to-space (sub-pixel) head. Convs, GroupNorm and the transposed
convs are cuDNN/cuBLAS calls through ``torch.nn.functional``.

The module takes NCHW images and returns NCHW float32 logits; it keeps
the flax numerics:

* compute dtype ``dtype`` (bfloat16 by default): input, kernels and
  biases are cast to it, params stay float32. The head runs in float32
  on the compute-dtype activations.
* GroupNorm with ``group_size = min(16, C)`` and epsilon 1e-6; its
  statistics and normalisation run in float32 and the output is cast
  to the compute dtype.
* SAME padding of the 2x2 stride-2 down-conv pads one row/column at the
  END of an odd extent; the upsample is cropped back to its skip.
* ``space_to_depth`` orders channels (b_h, b_w, C), unlike
  ``F.pixel_unshuffle``'s (C, b_h, b_w).

The one difference in arithmetic: a conv's bias is added inside the
conv call (one rounding to the compute dtype) where flax rounds the
conv output and then adds the bias in the compute dtype (two
roundings); at float32 the two agree.

Params are laid out so that ``models/convert.py`` can fill them from
the flax param tree; their default init follows flax's scheme
(``lecun_normal`` kernels, zero biases, GroupNorm scale 1 and bias 0)
from the caller's ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["ConvBlock", "UNet", "space_to_depth", "depth_to_space",
           "GN_EPS"]

GN_EPS = 1e-6  # flax nn.GroupNorm's epsilon (torch's default is 1e-5)

# flax lecun_normal: truncated normal on [-2, 2], rescaled so that the
# truncated distribution's stddev is sqrt(1 / fan_in)
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(weight: torch.Tensor, fan_in: int,
                   generator: Optional[torch.Generator]) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


def space_to_depth(x: torch.Tensor, block: int) -> torch.Tensor:
    """(N, C, H, W) -> (N, C*b*b, H/b, W/b), channel index
    (b_h * b + b_w) * C + c, as the JAX package's NHWC function."""
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // block, block, w // block, block)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, block * block * c, h // block, w // block)


def depth_to_space(x: torch.Tensor, block: int) -> torch.Tensor:
    """(N, C*b*b, H, W) -> (N, C, H*b, W*b); inverse of
    :func:`space_to_depth`."""
    n, cbb, h, w = x.shape
    c = cbb // (block * block)
    x = x.reshape(n, block, block, c, h, w)
    x = x.permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c, h * block, w * block)


# (shapes, strides, dtype, conv arguments, cuDNN switches) -> whether
# cuDNN's engine for that conv gives an image other bits in another slot
# of the batch
_SLOT_DEPENDENT: dict = {}


def _slot_dependent(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    stride, padding) -> bool:
    """Whether the conv that ``F.conv2d`` picks for these shapes computes
    an image with other bits when it sits in another slot of the batch,
    as an engine that splits its reduction by output tile does: the conv
    of seeded random data and of the same data rolled by one image (in
    ``x``'s strides) are compared. Random data, so that no zero input
    hides a split."""
    g = torch.Generator(device=x.device).manual_seed(0)
    xr, wr, br = (torch.empty_like(t).normal_(generator=g) for t in (x, w, b))
    rolled = torch.empty_like(xr).copy_(xr.roll(1, 0))
    y = F.conv2d(xr, wr, br, stride=stride, padding=padding)
    yr = F.conv2d(rolled, wr, br, stride=stride, padding=padding)
    return not torch.equal(yr, y.roll(1, 0))


def _conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride=1,
            padding=0) -> torch.Tensor:
    """``F.conv2d``, and in an inference forward on the card an image's
    result does not depend on its slot in the batch (a served chip's
    class map must equal ``predict``'s whichever slot it was given): a
    conv whose cuDNN engine is slot dependent (one bf16 conv of the
    full-width s2d 2 tree is) runs without cuDNN, as an im2col and a GEMM
    per image. Each shape is tested once (``_slot_dependent``). Callers
    hold the Trainer's lock on the cuDNN switches, which this flips."""
    if x.is_cuda and x.shape[0] > 1 and not torch.is_grad_enabled():
        cudnn = torch.backends.cudnn
        key = (tuple(x.shape), x.stride(), tuple(w.shape), x.dtype,
               x.device, stride, padding, cudnn.benchmark, cudnn.allow_tf32)
        if key not in _SLOT_DEPENDENT:
            _SLOT_DEPENDENT[key] = _slot_dependent(x, w, b, stride, padding)
        if _SLOT_DEPENDENT[key]:
            saved = cudnn.enabled
            cudnn.enabled = False
            try:
                return F.conv2d(x, w, b, stride=stride, padding=padding)
            finally:
                cudnn.enabled = saved
    return F.conv2d(x, w, b, stride=stride, padding=padding)


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype,
          padding=0, stride=1) -> torch.Tensor:
    return _conv2d(x.to(dtype), conv.weight.to(dtype), conv.bias.to(dtype),
                   stride=stride, padding=padding)


def _upsample(up: nn.ConvTranspose2d, x: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """The 2x2 stride-2 transposed conv as a 1x1 conv to 4x the channels
    and a pixel shuffle: the 2x2 output blocks do not overlap, so
    ``out[o, 2i + a, 2j + b] = sum_c x[c, i, j] W[c, o, a, b] + bias[o]``
    exactly. A forward conv, where ``conv_transpose2d`` runs cuDNN's
    backward-data pass, some of whose algorithms cuDNN documents as
    non-deterministic (atomic adds): a served chip's class map must equal
    ``predict``'s bit for bit."""
    cin, cout, kh, kw = up.weight.shape
    w = up.weight.permute(1, 2, 3, 0).reshape(cout * kh * kw, cin, 1, 1)
    b = up.bias.repeat_interleave(kh * kw)
    return F.pixel_shuffle(_conv2d(x, w.to(dtype), b.to(dtype)), kh)


class ConvBlock(nn.Module):
    """Two (3x3 conv SAME -> GroupNorm -> ReLU)."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.features = features
        self.dtype = dtype
        groups = features // min(16, features)
        self.conv0 = nn.Conv2d(in_features, features, 3)
        self.norm0 = nn.GroupNorm(groups, features, eps=GN_EPS)
        self.conv1 = nn.Conv2d(features, features, 3)
        self.norm1 = nn.GroupNorm(groups, features, eps=GN_EPS)

    def _norm(self, norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
        # float32 statistics and normalisation, output in the compute
        # dtype (flax: force_float32_reductions, then cast)
        y = F.group_norm(x.float(), norm.num_groups, norm.weight,
                         norm.bias, norm.eps)
        return F.relu(y.to(self.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self._norm(self.norm0, _conv(self.conv0, x, self.dtype, 1))
        return self._norm(self.norm1, _conv(self.conv1, x, self.dtype, 1))


class UNet(nn.Module):
    """num_classes: segmentation classes (float32 logits out);
    base_features: width of the first stage (doubles per level);
    s2d > 1: space-to-depth stem and sub-pixel logits head."""

    def __init__(self, num_classes: int = 2, base_features: int = 32,
                 levels: int = 4, dtype: torch.dtype = torch.bfloat16,
                 quant=False, s2d: int = 1, in_channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if quant:
            raise NotImplementedError(
                "int8 U-Net (quant) is not ported yet: ROADMAP queue 1 "
                "item 7 (models/quant.py)")
        self.num_classes = num_classes
        self.base_features = base_features
        self.levels = levels
        self.dtype = dtype
        self.s2d = s2d
        self.in_channels = in_channels
        f = base_features
        c = in_channels * s2d * s2d
        self.down_blocks = nn.ModuleList()
        self.downs = nn.ModuleList()
        for lvl in range(levels):
            w = f * 2 ** lvl
            self.down_blocks.append(ConvBlock(c, w, dtype))
            self.downs.append(nn.Conv2d(w, w, 2, stride=2))
            c = w
        self.bottom = ConvBlock(c, f * 2 ** levels, dtype)
        c = f * 2 ** levels
        self.ups = nn.ModuleList()
        self.up_blocks = nn.ModuleList()
        for lvl in reversed(range(levels)):
            w = f * 2 ** lvl
            self.ups.append(nn.ConvTranspose2d(c, w, 2, stride=2))
            self.up_blocks.append(ConvBlock(2 * w, w, dtype))
            c = w
        self.head = nn.Conv2d(c, num_classes * s2d * s2d, 1)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's init scheme: lecun_normal kernels (fan_in = kh * kw *
        in, for the transposed convs too), zero biases, GroupNorm scale 1
        and bias 0."""
        for m in self.modules():
            if isinstance(m, nn.ConvTranspose2d):
                cin, _, kh, kw = m.weight.shape
                _lecun_normal_(m.weight, cin * kh * kw, generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Conv2d):
                _, cin, kh, kw = m.weight.shape
                _lecun_normal_(m.weight, cin * kh * kw, generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.GroupNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)

    def conv_flops(self, height: int, width: int) -> int:
        """Floating-point operations (2 per multiply-add) of the convs,
        transposed convs and head of one forward on one (height, width)
        image, counted from the layer shapes this forward gives them."""
        def conv(h, w, cin, cout, k):
            return 2 * h * w * cin * cout * k * k

        h, w = height // self.s2d, width // self.s2d
        total, sizes = 0, []
        for block, down in zip(self.down_blocks, self.downs):
            total += (conv(h, w, block.conv0.in_channels, block.features, 3)
                      + conv(h, w, block.features, block.features, 3))
            sizes.append((h, w))
            h, w = -(-h // 2), -(-w // 2)
            total += conv(h, w, down.in_channels, down.out_channels, 2)
        b = self.bottom
        total += (conv(h, w, b.conv0.in_channels, b.features, 3)
                  + conv(h, w, b.features, b.features, 3))
        for up, block, (h, w) in zip(self.ups, self.up_blocks,
                                     reversed(sizes)):
            # the transposed conv computes the uncropped 2x upsample
            total += conv(-(-h // 2), -(-w // 2), up.in_channels,
                          up.out_channels, 2)
            total += (conv(h, w, block.conv0.in_channels, block.features, 3)
                      + conv(h, w, block.features, block.features, 3))
        return total + conv(h, w, self.head.in_channels,
                            self.head.out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, C, H, W) float images -> (N, num_classes, H, W) float32
        logits."""
        dt = self.dtype
        x = x.to(dt)
        if self.s2d > 1:
            x = space_to_depth(x, self.s2d)
        skips = []
        for block, down in zip(self.down_blocks, self.downs):
            x = block(x)
            skips.append(x)
            # SAME for a 2x2 stride-2 conv: an odd extent gets one row /
            # column of zeros at its end
            x = F.pad(x, (0, x.shape[3] % 2, 0, x.shape[2] % 2))
            x = _conv(down, x, dt, stride=2)
        x = self.bottom(x)
        for up, block, skip in zip(self.ups, self.up_blocks,
                                   reversed(skips)):
            # flax's ConvTranspose does not flip its kernel; the
            # converter flips it into torch's layout
            x = _upsample(up, x, dt)
            x = x[:, :, :skip.shape[2], :skip.shape[3]]
            x = block(torch.cat([x, skip.to(dt)], dim=1))
        logits = _conv2d(x.float(), self.head.weight, self.head.bias)
        if self.s2d > 1:
            logits = depth_to_space(logits, self.s2d)
        return logits
