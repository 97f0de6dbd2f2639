"""SegFormer-lite (PyTorch port of the JAX package's
``models/segformer.py``): a 4-stage MiT-B0-style encoder of overlapping
patch embeddings, spatial-reduction attention and Mix-FFN blocks, and an
all-MLP decoder.

NCHW images in, NCHW float32 logits out. Inside a stage the tokens are
(N, h * w, C). The flax numerics of ``models/layers.py`` hold: Dense
layers and convs in the compute dtype with float32 params, SAME padding,
LayerNorm with flax's epsilon and fast variance, tanh GELU. Attention is
two ``torch.matmul``s in JAX's dtype order: float32 scores, divided by
sqrt(head_dim) after the product, a float32 softmax, probabilities cast
to the compute dtype, PV with a float32 result cast back to the compute
dtype (no fused attention: the JAX package runs no kernel here, and a
fused one scales and rounds elsewhere). The decoder resizes each stage
in float32 and casts, runs its head Dense in float32, and resizes the
logits x4 in float32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from .layers import (LN_EPS, band_rows, conv_same, gelu, layer_norm,
                     lecun_normal_, linear, resize_bilinear, resize_flops)

__all__ = ["Block", "MixFFN", "SRAttention", "SegFormerLite"]


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """(N, C, h, w) -> (N, h * w, C)."""
    return x.flatten(2).transpose(1, 2)


def _image(t: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, h * w, C) -> (N, C, h, w)."""
    return t.transpose(1, 2).reshape(t.shape[0], t.shape[2], h, w)


class SRAttention(nn.Module):
    """Self-attention whose keys and values come from tokens reduced by a
    k = s = sr conv and a LayerNorm (flax: ``Dense_0`` q, ``Conv_0``,
    ``LayerNorm_0``, ``Dense_1`` k, ``Dense_2`` v, ``Dense_3`` out). On
    height bands (``bands``) the queries stay local and the keys and
    values of every band are gathered, so each query attends to the
    whole image's."""

    bands = None

    def __init__(self, dim: int, heads: int, sr_ratio: int):
        super().__init__()
        self.dim, self.heads, self.sr_ratio = dim, heads, sr_ratio
        self.q = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio)
            self.sr_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, h: int, w: int,
                dtype: torch.dtype) -> torch.Tensor:
        n, hw, c = x.shape
        hd = self.dim // self.heads
        q = linear(self.q, x, dtype)
        kh, kw = h, w
        if self.sr_ratio > 1:
            kv = conv_same(self.sr, _image(x, h, w), dtype, self.sr_ratio)
            kh, kw = kv.shape[2], kv.shape[3]
            kv = layer_norm(self.sr_norm, _tokens(kv), dtype)
        else:
            kv = x
        k = linear(self.k, kv, dtype)
        v = linear(self.v, kv, dtype)
        if self.bands is not None:
            k, v = self.bands.gather_tokens(
                torch.cat([k, v], -1), self.bands.rows(kh), kw).split(
                    self.dim, -1)

        def split(t):
            return t.reshape(n, -1, self.heads, hd).transpose(1, 2)
        q, k, v = split(q), split(k), split(v)
        # preferred_element_type=float32: products of the compute dtype
        # summed in float32
        att = torch.matmul(q.float(), k.float().transpose(-1, -2))
        att = torch.softmax(att / float(np.sqrt(np.float32(hd))), dim=-1)
        out = torch.matmul(att.to(dtype).float(), v.float())
        out = out.transpose(1, 2).reshape(n, hw, self.dim)
        return linear(self.out, out.to(dtype), dtype)

    def flops(self, h: int, w: int) -> int:
        hw, d = h * w, self.dim
        kv = hw
        total = 2 * hw * d * d * 2  # q, out
        if self.sr_ratio > 1:
            s = self.sr_ratio
            kv = (-(-h // s)) * (-(-w // s))
            total += 2 * kv * d * d * s * s
        total += 2 * kv * d * d * 2  # k, v
        return total + 2 * 2 * hw * kv * d  # scores, PV over the heads


class MixFFN(nn.Module):
    """Dense to 4x the width, a 3x3 depthwise conv, GELU, Dense back
    (flax: ``Dense_0``, ``Conv_0``, ``Dense_1``)."""

    def __init__(self, dim: int, expand: int = 4):
        super().__init__()
        hidden = dim * expand
        self.fc1 = nn.Linear(dim, hidden)
        self.dw = nn.Conv2d(hidden, hidden, 3, groups=hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, h: int, w: int,
                dtype: torch.dtype) -> torch.Tensor:
        x = linear(self.fc1, x, dtype)
        x = _tokens(conv_same(self.dw, _image(x, h, w), dtype))
        return linear(self.fc2, gelu(x), dtype)

    def flops(self, h: int, w: int) -> int:
        hw, d, hidden = h * w, self.fc1.in_features, self.fc1.out_features
        return 2 * hw * d * hidden * 2 + 2 * hw * hidden * 9


class Block(nn.Module):
    """x + SRAttention(LayerNorm(x)), then x + MixFFN(LayerNorm(x))."""

    def __init__(self, dim: int, heads: int, sr_ratio: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = SRAttention(dim, heads, sr_ratio)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.ffn = MixFFN(dim)

    def forward(self, x: torch.Tensor, h: int, w: int,
                dtype: torch.dtype) -> torch.Tensor:
        x = x + self.attn(layer_norm(self.norm1, x, dtype), h, w, dtype)
        return x + self.ffn(layer_norm(self.norm2, x, dtype), h, w, dtype)


# (kernel, stride) of each stage's overlapping patch embedding
PATCH = ((7, 4), (3, 2), (3, 2), (3, 2))


class SegFormerLite(nn.Module):
    """num_classes: segmentation classes (float32 logits at input size);
    base_features: stage-0 width (stages f, 2f, 5f, 8f). ``bands``:
    ``parallel/spmd.py:Bands`` when a spatial step shards the height."""

    bands = None

    def __init__(self, num_classes: int = 2, base_features: int = 32,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 heads: Sequence[int] = (1, 2, 4, 8),
                 sr_ratios: Sequence[int] = (8, 4, 2, 1),
                 decoder_dim: int = 256,
                 dtype: torch.dtype = torch.bfloat16, in_channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes = num_classes
        self.base_features = base_features
        self.dtype = dtype
        f = base_features
        self.dims = (f, f * 2, f * 5, f * 8)
        self.embeds = nn.ModuleList()
        self.embed_norms = nn.ModuleList()
        self.stages = nn.ModuleList()
        self.stage_norms = nn.ModuleList()
        c = in_channels
        for s, d in enumerate(self.dims):
            self.embeds.append(nn.Conv2d(c, d, PATCH[s][0]))
            self.embed_norms.append(nn.LayerNorm(d, eps=LN_EPS))
            self.stages.append(nn.ModuleList(
                Block(d, heads[s], sr_ratios[s]) for _ in range(depths[s])))
            self.stage_norms.append(nn.LayerNorm(d, eps=LN_EPS))
            c = d
        self.proj = nn.ModuleList(nn.Linear(d, decoder_dim)
                                  for d in self.dims)
        self.fuse = nn.Linear(decoder_dim * 4, decoder_dim)
        self.head = nn.Linear(decoder_dim, num_classes)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's init scheme: lecun_normal kernels (fan_in = kh * kw *
        in / groups for convs), zero biases, LayerNorm scale 1 and bias
        0."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                _, cin, kh, kw = m.weight.shape
                lecun_normal_(m.weight, cin * kh * kw, generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Linear):
                lecun_normal_(m.weight, m.in_features, generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)

    def spatial_layers(self):
        """The layers whose windows cross the image height, which a step
        with the height sharded into bands runs on bands
        (``parallel/spmd.py:wrap_layers``): the overlapping patch
        embeddings, the spatial-reduction convs and Mix-FFN's depthwise
        convs. Attention gathers its keys and values, and the decoder's
        resizes move rows, through ``bands``; LayerNorm and Dense layers
        act per token."""
        yield from self.embeds
        for stage in self.stages:
            for blk in stage:
                if blk.attn.sr_ratio > 1:
                    yield blk.attn.sr
                yield blk.ffn.dw

    def _sizes(self, height: int, width: int):
        sizes, h, w = [], height, width
        for k, s in PATCH:
            h, w = -(-h // s), -(-w // s)
            sizes.append((h, w))
        return sizes

    def flops(self, height: int, width: int) -> int:
        """FLOPs (2 per multiply-add) of one forward on one (height, width)
        image: patch-embedding convs, every Dense, the depthwise convs,
        both attention matmuls, and the resizes' matrix contractions."""
        sizes = self._sizes(height, width)
        total, c = 0, self.embeds[0].in_channels
        dd = self.fuse.out_features
        th, tw = sizes[0]
        for s, (h, w) in enumerate(sizes):
            k = PATCH[s][0]
            total += 2 * h * w * self.dims[s] * c * k * k
            for blk in self.stages[s]:
                total += blk.attn.flops(h, w) + blk.ffn.flops(h, w)
            total += 2 * h * w * self.dims[s] * dd
            if h != th:
                total += resize_flops(dd, h, w, th, tw)
            c = self.dims[s]
        total += 2 * th * tw * (4 * dd * dd + dd * self.num_classes)
        return total + resize_flops(self.num_classes, th, tw, height, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, C, H, W) float images -> (N, num_classes, H, W) float32
        logits."""
        dt, bands = self.dtype, self.bands
        rows = band_rows(bands)
        h0, w0 = rows(x), x.shape[3]
        x = x.to(dt)
        feats = []
        for s in range(4):
            x = conv_same(self.embeds[s], x, dt, PATCH[s][1])
            h, w = x.shape[2], x.shape[3]
            t = layer_norm(self.embed_norms[s], _tokens(x), dt)
            for blk in self.stages[s]:
                t = blk(t, h, w, dt)
            t = layer_norm(self.stage_norms[s], t, dt)
            x = _image(t, h, w)
            feats.append(x)
        th, tw = rows(feats[0]), feats[0].shape[3]
        ups = []
        for proj, f in zip(self.proj, feats):
            p = linear(proj, f.permute(0, 2, 3, 1), dt).permute(0, 3, 1, 2)
            if rows(p) != th:
                p = resize_bilinear(p.float(), th, tw, bands).to(dt)
            ups.append(p)
        y = torch.cat(ups, dim=1).permute(0, 2, 3, 1)
        y = gelu(linear(self.fuse, y, dt))
        logits = linear(self.head, y, torch.float32).permute(0, 3, 1, 2)
        return resize_bilinear(logits, h0, w0, bands)
