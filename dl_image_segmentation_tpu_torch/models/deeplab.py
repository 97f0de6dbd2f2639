"""DeepLab-lite (PyTorch port of the JAX package's ``models/deeplab.py``):
a dilated-conv encoder to 1/8 resolution, ASPP, and a decoder that
upsamples to the 1/2-resolution skip, fuses it and resizes the logits
to the input.

NCHW in, NCHW float32 logits out, with the flax numerics of
``models/layers.py``: convs in the compute dtype with float32 params and
SAME padding (lax's rule, dilation included), GroupNorm of
``min(16, C)``-channel groups in float32 with its output in the compute
dtype, bilinear resizes as ``jax.image.resize`` computes them (the
features' in the compute dtype, the logits' in float32), a float32 head.
Submodules are created in flax's call order, so that
``models/convert.py`` maps the flax tree by name.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (GN_EPS, band_rows, call_layer, conv_same,
                     group_norm, lecun_normal_, resize_bilinear,
                     resize_flops)

__all__ = ["ASPP", "ConvBNAct", "DeepLabLite"]


class ConvBNAct(nn.Module):
    """k x k conv (stride, dilation, SAME) -> GroupNorm -> ReLU (flax
    ``_ConvBNAct``: ``Conv_0``, ``GroupNorm_0``)."""

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 dilation: int = 1, kernel: int = 3):
        super().__init__()
        self.strides = strides
        self.dilation = dilation
        self.conv = nn.Conv2d(in_features, features, kernel)
        self.norm = nn.GroupNorm(features // min(16, features), features,
                                 eps=GN_EPS)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = conv_same(self.conv, x, dtype, self.strides, self.dilation)
        return F.relu(group_norm(self.norm, x, dtype))

    def flops(self, h: int, w: int) -> int:
        """Conv FLOPs on an (h, w) input (2 per multiply-add)."""
        s = self.strides
        o, i, kh, kw = self.conv.weight.shape
        return 2 * (-(-h // s)) * (-(-w // s)) * o * i * kh * kw


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling: a 1x1 branch, 3x3 branches at rates
    6, 12, 18, and the image-level pooled branch, concatenated in that
    order and projected by a 1x1 ConvBNAct. On height bands
    (``bands``) the image-level mean adds every band's sums."""

    bands = None

    def __init__(self, in_features: int, features: int = 256,
                 rates: Sequence[int] = (1, 6, 12, 18)):
        super().__init__()
        self.features = features
        self.branches = nn.ModuleList(
            ConvBNAct(in_features, features, dilation=r,
                      kernel=1 if r == 1 else 3) for r in rates)
        self.pooled = ConvBNAct(in_features, features, kernel=1)
        self.project = ConvBNAct(features * (len(rates) + 1), features,
                                 kernel=1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        outs = [b(x, dtype) for b in self.branches]
        mean = (x.mean(dim=(2, 3), keepdim=True) if self.bands is None
                else self.bands.mean(x))
        pooled = self.pooled(mean, dtype)
        outs.append(pooled.expand(-1, -1, x.shape[2], x.shape[3]))
        return self.project(torch.cat(outs, dim=1), dtype)

    def flops(self, h: int, w: int) -> int:
        return (sum(b.flops(h, w) for b in self.branches)
                + self.pooled.flops(1, 1) + self.project.flops(h, w))


class DeepLabLite(nn.Module):
    """num_classes: segmentation classes (float32 logits at input size);
    base_features: encoder width f (f, 2f, 2f, 4f, 4f, 8f);
    aspp_features: ASPP and decoder width. ``bands``:
    ``parallel/spmd.py:Bands`` when a spatial step shards the height."""

    bands = None

    def __init__(self, num_classes: int = 2, base_features: int = 32,
                 aspp_features: int = 128,
                 dtype: torch.dtype = torch.bfloat16, in_channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes = num_classes
        self.base_features = base_features
        self.dtype = dtype
        f = base_features
        self.encoder = nn.ModuleList([
            ConvBNAct(in_channels, f, strides=2),        # 1/2
            ConvBNAct(f, f * 2),                         # the skip
            ConvBNAct(f * 2, f * 2, strides=2),          # 1/4
            ConvBNAct(f * 2, f * 4),
            ConvBNAct(f * 4, f * 4, strides=2),          # 1/8
            ConvBNAct(f * 4, f * 8)])
        self.aspp = ASPP(f * 8, aspp_features)
        self.low = ConvBNAct(f * 2, 48, kernel=1)
        self.fuse = ConvBNAct(aspp_features + 48, aspp_features)
        self.head = nn.Conv2d(aspp_features, num_classes, 1)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's init scheme: lecun_normal kernels, zero biases,
        GroupNorm scale 1 and bias 0."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                _, cin, kh, kw = m.weight.shape
                lecun_normal_(m.weight, cin * kh * kw, generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.GroupNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)

    def spatial_layers(self):
        """The layers whose windows or statistics cross the image height,
        which a step with the height sharded into bands runs on bands
        (``parallel/spmd.py:wrap_layers``): every conv and GroupNorm but
        the image-level branch's, which sees the mean of the whole
        image. The resizes and that mean go through ``bands`` in
        ``forward``; the 1x1 head is local."""
        for layer in (*self.encoder, *self.aspp.branches, self.aspp.project,
                      self.low, self.fuse):
            yield from (layer.conv, layer.norm)

    def flops(self, height: int, width: int) -> int:
        """FLOPs (2 per multiply-add) of one forward on one (height, width)
        image: the convs, the head, and the resizes' matrix contractions,
        from the shapes this forward gives them."""
        h, w, total = height, width, 0
        for i, layer in enumerate(self.encoder):
            total += layer.flops(h, w)
            h, w = -(-h // layer.strides), -(-w // layer.strides)
            if i == 1:
                low = (h, w)
        total += self.aspp.flops(h, w)
        c = self.aspp.features
        lh, lw = low
        total += resize_flops(c, h, w, lh, lw)
        total += self.low.flops(lh, lw) + self.fuse.flops(lh, lw)
        total += 2 * lh * lw * self.head.in_channels * self.num_classes
        return total + resize_flops(self.num_classes, lh, lw, height, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, C, H, W) float images -> (N, num_classes, H, W) float32
        logits."""
        dt, bands = self.dtype, self.bands
        rows = band_rows(bands)
        h, w = rows(x), x.shape[3]
        x = x.to(dt)
        for i, layer in enumerate(self.encoder):
            x = layer(x, dt)
            if i == 1:
                low = x
        x = self.aspp(x, dt)
        # upsample to the skip's actual size (stride-2 SAME convs keep
        # ceil(h / 2))
        x = resize_bilinear(x, rows(low), low.shape[3], bands).to(dt)
        x = self.fuse(torch.cat([x, self.low(low, dt)], dim=1), dt)
        logits = call_layer(self.head, x.float(), F.conv2d)
        return resize_bilinear(logits, h, w, bands)
