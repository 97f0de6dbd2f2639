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

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (GN_EPS, _conv2d, call_layer, group_norm,
                     lecun_normal_)
from .quant import Int8Conv

__all__ = ["ConvBlock", "UNet", "space_to_depth", "depth_to_space",
           "GN_EPS", "share_parameters"]


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


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype,
          padding=0, stride=1) -> torch.Tensor:
    if isinstance(conv, Int8Conv):
        # SAME padding on the int8 tensor: the zeros the float path pads
        # quantize to zeros
        return conv.quantized(x, dtype)
    return call_layer(conv, x.to(dtype), lambda x, w, b: _conv2d(
        x, w.to(dtype), b.to(dtype), stride=stride, padding=padding))


def _upsample(up: nn.ConvTranspose2d, x: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """The 2x2 stride-2 transposed conv as a 1x1 conv to 4x the channels
    and a pixel shuffle: the 2x2 output blocks do not overlap, so
    ``out[o, 2i + a, 2j + b] = sum_c x[c, i, j] W[c, o, a, b] + bias[o]``
    exactly. A forward conv, where ``conv_transpose2d`` runs cuDNN's
    backward-data pass, some of whose algorithms cuDNN documents as
    non-deterministic (atomic adds): a served chip's class map must equal
    ``predict``'s bit for bit."""
    def fn(x, w, b):
        cin, cout, kh, kw = w.shape
        w = w.permute(1, 2, 3, 0).reshape(cout * kh * kw, cin, 1, 1)
        b = b.repeat_interleave(kh * kw)
        return F.pixel_shuffle(_conv2d(x, w.to(dtype), b.to(dtype)), kh)
    return call_layer(up, x, fn)


def _conv_layer(cin: int, cout: int, k: int, stride: int, quant):
    """nn.Conv2d, or with ``quant`` (True: dynamic, "static": calibrated
    scales) an Int8Conv with the same parameters."""
    if quant:
        return Int8Conv(cin, cout, k, stride=stride, static=quant == "static")
    return nn.Conv2d(cin, cout, k, stride=stride)


class ConvBlock(nn.Module):
    """Two (3x3 conv SAME -> GroupNorm -> ReLU); ``quant`` makes both
    convs int8."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.bfloat16, quant=False):
        super().__init__()
        self.features = features
        self.dtype = dtype
        groups = features // min(16, features)
        self.conv0 = _conv_layer(in_features, features, 3, 1, quant)
        self.norm0 = nn.GroupNorm(groups, features, eps=GN_EPS)
        self.conv1 = _conv_layer(features, features, 3, 1, quant)
        self.norm1 = nn.GroupNorm(groups, features, eps=GN_EPS)

    def _norm(self, norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
        return F.relu(group_norm(norm, x, self.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self._norm(self.norm0, _conv(self.conv0, x, self.dtype, 1))
        return self._norm(self.norm1, _conv(self.conv1, x, self.dtype, 1))


class UNet(nn.Module):
    """num_classes: segmentation classes (float32 logits out);
    base_features: width of the first stage (doubles per level);
    s2d > 1: space-to-depth stem and sub-pixel logits head; quant (True:
    int8 with dynamic per-example activation scales, "static": calibrated
    constant scales) makes the ConvBlocks' 3x3 convs and the 2x2 down
    convs int8 (``models/quant.py``), with the float model's parameter
    names; the upsamplers and the float32 head stay float."""

    def __init__(self, num_classes: int = 2, base_features: int = 32,
                 levels: int = 4, dtype: torch.dtype = torch.bfloat16,
                 quant=False, s2d: int = 1, in_channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if quant not in (False, True, "static"):
            raise ValueError(f"quant={quant!r} (expected False, True or "
                             "'static')")
        self.quant = quant
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
            self.down_blocks.append(ConvBlock(c, w, dtype, quant))
            self.downs.append(_conv_layer(w, w, 2, 2, quant))
            c = w
        self.bottom = ConvBlock(c, f * 2 ** levels, dtype, quant)
        c = f * 2 ** levels
        self.ups = nn.ModuleList()
        self.up_blocks = nn.ModuleList()
        for lvl in reversed(range(levels)):
            w = f * 2 ** lvl
            self.ups.append(nn.ConvTranspose2d(c, w, 2, stride=2))
            self.up_blocks.append(ConvBlock(2 * w, w, dtype, quant))
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
                lecun_normal_(m.weight, cin * kh * kw, generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Conv2d):
                _, cin, kh, kw = m.weight.shape
                lecun_normal_(m.weight, cin * kh * kw, generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.GroupNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)

    def spatial_layers(self):
        """The (3x3 SAME conv, GroupNorm) pairs whose windows and
        statistics cross the image height, which a step with the height
        sharded into bands replaces (``parallel/spmd.py:shard_model``).
        The 2x2 stride-2 down convs, the upsamplers and the 1x1 head stay
        local to a band whose height is a multiple of ``s2d * 2 **
        levels``."""
        for blk in (*self.down_blocks, self.bottom, *self.up_blocks):
            yield blk.conv0, blk.norm0
            yield blk.conv1, blk.norm1

    def flops(self, height: int, width: int) -> int:
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
            if not self.quant:
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
        logits = call_layer(self.head, x.float(), _conv2d)
        if self.s2d > 1:
            logits = depth_to_space(logits, self.s2d)
        return logits


def share_parameters(src: nn.Module, dst: nn.Module) -> nn.Module:
    """Make ``dst`` (a model of ``src``'s structure, e.g. its int8 twin)
    hold ``src``'s parameter tensors themselves, so that a train step or
    a loaded checkpoint changes what ``dst`` computes; returns ``dst``."""
    src_mods = dict(src.named_modules())
    for name, mod in dst.named_modules():
        for pname in list(mod._parameters):
            mod._parameters[pname] = src_mods[name]._parameters[pname]
    return dst
