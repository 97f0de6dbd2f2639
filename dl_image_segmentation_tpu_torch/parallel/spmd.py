"""Collectives inside autograd, and the sharded layers of the trainer.

In the JAX package GSPMD derives every collective of a sharded step
from the parameter and batch shardings. Here they are written out:

* ``all_reduce``, ``all_gather`` and ``reduce_scatter`` run on the
  group's backend. Gloo moves host tensors: a CUDA tensor in a gloo
  group (two ranks on one card, where NCCL refuses a shared card) is
  staged through pinned host memory, 16-bit floats are summed in
  float32, and a dtype gloo does not move (bfloat16, uint16, bool,
  ...) is gathered as its bytes. The choice is made from the
  group's backend, never by catching a failure. A group of one rank
  (None) moves nothing.
* Autograd functions: ``gather`` (all-gather forward, the rank's slice
  of the gradient backward: the ranks of a model group see the same
  upstream gradient, so a reduce-scatter there would count it n_model
  times), ``split`` (its transpose), ``copy`` (identity forward, sum of
  the ranks' partial input gradients backward), ``gather_param`` (a
  stored shard all-gathered before use, its gradient reduce-scattered),
  ``psum`` (all-reduce both ways), ``fetch_rows`` (rows of a banded
  tensor from the ranks that hold them, zeros beyond the global top and
  bottom; each fetched row's gradient goes back and is added to its
  owner's row) and ``Bands.gather_tokens`` (bands of unequal length
  all-gathered; backward the sum over the ranks, each rank's own part,
  for each rank's queries send their own gradient to every key).
* Row bands (GSPMD's padded split): a tensor of h rows lives in blocks
  of ceil(h / n) rows a rank, the last ranks' shorter or empty
  (``band_split``); ``band_plan`` says which global rows a conv's output
  band reads under lax's SAME padding and who holds them. ``Bands`` runs
  every op of a spatial step that reads other bands' rows: SAME convs of
  any kernel, stride and dilation, an upsample cropped to its skip, the
  bilinear resize, space-to-depth, the image mean and attention's keys
  and values; a band's global height is all-gathered once for each
  image height and kept.
* ``shard_model(model, mesh, config)`` keeps this rank's shard of each
  parameter that ``param_shardings`` shards and ``wrap_layers`` attaches
  a wrapper to its layer as ``layer.spmd``, which
  ``models/layers.py:call_layer`` calls in place of the plain op: a
  column-parallel conv, upsample or depthwise conv (its output channels
  computed here and gathered over "model"), a gathered-storage kernel
  (FSDP), and with ``spatial`` the layers of the model's
  ``spatial_layers()`` on bands (every conv that reads other rows, and
  GroupNorms whose statistics cover the whole height: float64 sums
  all-reduced over "model", flax's variance ``max(E[x^2] - E[x]^2,
  0)``). An int8 twin on the same shards gets wrappers of its own.
* ``GradSync`` sums each gradient over the ranks that hold the rest of
  the batch, coalesced into one buffer a group.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..models.layers import (_resize_matrix, _resize_weights,
                             group_norm_flax, same_pads)
from .sharding import (Mesh, Sharding, cout_dim, param_shardings,
                       shard_slice)

__all__ = ["BandPlan", "Bands", "GradSync", "ShardedLayer", "ShardedNorm",
           "all_gather", "all_reduce", "band_owners", "band_plan",
           "band_split", "copy", "fetch_rows", "full_tensor", "gather",
           "gather_param", "group_norm_sharded", "local_shard",
           "norm_group", "psum", "reduce_scatter", "shard_model", "split",
           "spec_axes", "wrap_layers"]

# dtypes that gloo gathers as they are; others go as their bytes
_GLOO_TYPES = (torch.float32, torch.float64, torch.int32, torch.int64,
               torch.uint8, torch.int8)


def _gloo(group) -> bool:
    return dist.get_backend(group) == dist.Backend.GLOO


def _host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of a CUDA tensor."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
    """``op`` (default the sum) of ``t`` over the group, as a new tensor
    (``t`` itself for a group of one)."""
    if group is None:
        return t
    work = t.detach()
    if _gloo(group):
        if work.dtype in (torch.bfloat16, torch.float16):
            work = work.float()
        work = _host(work) if work.is_cuda else work.clone()
    else:
        work = work.clone()
    dist.all_reduce(work, op=op, group=group)
    return work.to(device=t.device, dtype=t.dtype)


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors (equal shapes) concatenated along ``dim`` in
    group-rank order."""
    if group is None:
        return t
    work = t.detach().contiguous()
    bits = _gloo(group) and work.dtype not in _GLOO_TYPES
    if bits:
        work = work.view(torch.uint8)
    if _gloo(group) and work.is_cuda:
        work = _host(work)
    parts = [torch.empty_like(work) for _ in range(dist.get_world_size(
        group))]
    dist.all_gather(parts, work, group=group)
    out = torch.cat(parts, dim)
    if bits:
        out = out.view(t.dtype)
    return out.to(t.device)


def reduce_scatter(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum of ``t`` over the group, this rank's chunk along ``dim``
    (gloo: an all-reduce and the chunk)."""
    if group is None:
        return t
    n, i = dist.get_world_size(group), dist.get_rank(group)
    if _gloo(group):
        return all_reduce(t, group).chunk(n, dim)[i].contiguous()
    chunks = [c.contiguous() for c in t.detach().chunk(n, dim)]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=group)
    return out


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        n, i = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return g.chunk(n, ctx.dim)[i].contiguous(), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n, i = dist.get_world_size(group), dist.get_rank(group)
        return x.chunk(n, dim)[i].contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


def gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """All-gather ``x`` along ``dim``; backward: this rank's slice."""
    return x if group is None else _Gather.apply(x, group, dim)


def split(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's chunk of ``x`` along ``dim``; backward: all-gather."""
    return x if group is None else _Split.apply(x, group, dim)


def copy(x: torch.Tensor, group) -> torch.Tensor:
    """``x``; backward: the sum of the group's gradients."""
    return x if group is None else _Copy.apply(x, group)


def gather_param(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """A stored shard all-gathered along ``dim``; backward:
    reduce-scatter (the gradient summed over the group)."""
    return x if group is None else _GatherParam.apply(x, group, dim)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group, both ways."""
    return x if group is None else _Psum.apply(x, group)


# -- row bands ---------------------------------------------------------

def band_split(h: int, n: int, rank: int) -> Tuple[int, int]:
    """The rows [lo, hi) of an extent of ``h`` rows that ``rank`` of
    ``n`` holds: blocks of ceil(h / n) rows, the last ranks' shorter or
    empty (GSPMD's padded split). Every band of a spatial step follows
    it, so a layer's output band and its skip's line up."""
    c = -(-h // n)
    lo = min(rank * c, h)
    return lo, min(lo + c, h)


def band_owners(h: int, n: int, lo: int, hi: int
                ) -> Tuple[Tuple[int, int, int], ...]:
    """(rank, a, b): the ranks that hold the rows [a, b) of the global
    rows [lo, hi) that lie in [0, h), in rank order."""
    out = []
    for j in range(n):
        a, b = band_split(h, n, j)
        a, b = max(a, lo), min(b, hi)
        if b > a:
            out.append((j, a, b))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class BandPlan:
    """``out``: this rank's output rows [o0, o1); ``rows``: the global
    input rows [lo, hi) that they read (rows outside [0, h_in) are the
    SAME padding's zeros); ``owners``: who holds the rest."""
    out: Tuple[int, int]
    rows: Tuple[int, int]
    owners: Tuple[Tuple[int, int, int], ...]


def band_plan(h_in: int, h_out: int, n: int, rank: int, kernel: int,
              stride: int = 1, dilation: int = 1,
              pads: Optional[Tuple[int, int]] = None) -> BandPlan:
    """The rows a k x k conv's output band reads: output row o reads
    input rows ``o * stride - pads[0] + i * dilation`` for i < kernel
    (``pads`` default lax's SAME rule on ``h_in``, as
    ``models/layers.py:same_pads``). A pure function of its arguments:
    every rank computes every rank's plan."""
    if pads is None:
        pads = same_pads(h_in, kernel, stride, dilation)
    o0, o1 = band_split(h_out, n, rank)
    lo = o0 * stride - pads[0]
    hi = lo if o1 == o0 else (o1 - 1) * stride - pads[0] + (
        kernel - 1) * dilation + 1
    return BandPlan((o0, o1), (lo, hi), band_owners(h_in, n, lo, hi))


def _rows(t: torch.Tensor) -> torch.Tensor:
    """(N, C, h, W) -> (h, N * C * W) contiguous, a row a line."""
    n, c, h, w = t.shape
    return t.permute(2, 0, 1, 3).reshape(h, n * c * w)


def _unrows(t: torch.Tensor, like: Tuple[int, ...]) -> torch.Tensor:
    n, c, _, w = like
    return t.reshape(t.shape[0], n, c, w).permute(1, 2, 0, 3)


def _exchange(send: torch.Tensor, sizes_out: List[int],
              sizes_in: List[int], group) -> torch.Tensor:
    """All-to-all of rows: ``send`` (S, F) holds ``sizes_out[j]`` rows
    for rank j in rank order; returns (R, F) of ``sizes_in[j]`` rows from
    rank j in rank order. Gloo moves host tensors, and a dtype it does
    not move goes as its bytes."""
    work = send.contiguous()
    bits = _gloo(group) and work.dtype not in _GLOO_TYPES
    if bits:
        work = work.view(torch.uint8)
    if _gloo(group) and work.is_cuda:
        work = _host(work)
    out = work.new_empty((sum(sizes_in), work.shape[1]))
    dist.all_to_all_single(out, work, sizes_in, sizes_out, group=group)
    if bits:
        out = out.view(send.dtype)
    return out.to(send.device)


def _moves(h: int, needs) -> bool:
    """Whether any rank reads a row that another rank holds."""
    n = len(needs)
    return any(j != i for i, (lo, hi) in enumerate(needs)
               for j, _, _ in band_owners(h, n, lo, hi))


class _FetchRows(torch.autograd.Function):
    """Rows of a banded tensor from the ranks that hold them (zeros
    beyond the global top and bottom); backward: each fetched row's
    gradient added back into its owner's row."""

    @staticmethod
    def forward(ctx, x, group, h, needs):
        n, me = len(needs), dist.get_rank(group)
        m0, m1 = band_split(h, n, me)
        lo, hi = needs[me]
        # sent[j]: the rows of mine that rank j reads
        sent = [(max(a, m0), min(b, m1)) for a, b in needs]
        sizes_out = [max(0, b - a) for a, b in sent]
        sizes_in = [0] * n
        for j, a, b in band_owners(h, n, lo, hi):
            sizes_in[j] = b - a
        top, bottom = max(0, min(hi, 0) - lo), max(0, hi - max(lo, h))
        ctx.group, ctx.shape, ctx.m0, ctx.sent = group, x.shape, m0, sent
        ctx.sizes, ctx.pad = (sizes_out, sizes_in), (top, bottom)
        ctx.moves = _moves(h, needs)
        xr = _rows(x)
        if ctx.moves:
            mid = _exchange(torch.cat([xr[a - m0:b - m0] for a, b in sent
                                       if b > a] or [xr[:0]]),
                            sizes_out, sizes_in, group)
        else:
            mid = xr[max(lo, m0) - m0:max(min(hi, m1) - m0, 0)]
        if top or bottom:
            mid = torch.cat([mid.new_zeros((top, mid.shape[1])), mid,
                             mid.new_zeros((bottom, mid.shape[1]))])
        return _unrows(mid, x.shape).contiguous()

    @staticmethod
    def backward(ctx, g):
        top, bottom = ctx.pad
        gr = _rows(g)
        gr = gr[top:gr.shape[0] - bottom]
        sizes_out, sizes_in = ctx.sizes
        back = (_exchange(gr, sizes_in, sizes_out, ctx.group) if ctx.moves
                else gr)
        dx = gr.new_zeros((ctx.shape[2], gr.shape[1]))
        offset = 0
        for a, b in ctx.sent:
            if b > a:
                dx[a - ctx.m0:b - ctx.m0] += back[offset:offset + b - a]
                offset += b - a
        return _unrows(dx, ctx.shape).contiguous(), None, None, None


def fetch_rows(x: torch.Tensor, group, h: int, needs) -> torch.Tensor:
    """(N, C, rows, W): the global rows ``needs[rank]`` = [lo, hi) of the
    banded tensor ``x`` (this rank's ``band_split`` of ``h`` rows),
    zeros outside [0, h). ``needs`` holds every rank's [lo, hi), so that
    each rank knows what to send; a fetch in which every rank reads only
    its own rows moves nothing."""
    return _FetchRows.apply(x, group, h, tuple(needs))


class _GatherBands(torch.autograd.Function):
    """Bands of unequal length all-gathered along ``dim`` in rank order;
    backward: the sum over the group of the whole gradient, this rank's
    part of it (each rank's queries send their own gradient to every
    key, unlike ``gather``'s ranks, which all see the same one)."""

    @staticmethod
    def forward(ctx, x, group, counts, dim):
        ctx.group, ctx.counts, ctx.dim = group, counts, dim
        top = max(counts)
        pad = list(x.shape)
        pad[dim] = top - x.shape[dim]
        full = all_gather(torch.cat([x, x.new_zeros(pad)], dim), group, dim)
        return torch.cat([full.narrow(dim, j * top, c)
                          for j, c in enumerate(counts)], dim)

    @staticmethod
    def backward(ctx, g):
        me = dist.get_rank(ctx.group)
        start = sum(ctx.counts[:me])
        return (all_reduce(g, ctx.group).narrow(ctx.dim, start,
                                                ctx.counts[me])
                .contiguous(), None, None, None)


class Bands:
    """The height bands of one model's activations over ``group`` (the
    mesh's "model" axis): every band is its rank's ``band_split`` of
    the tensor's global height, and every op that reads rows of other
    bands runs here: SAME convs of any kernel, stride and dilation
    (``conv``), an upsample cropped to a given height (``up``), the
    bilinear resize (``resize``), space-to-depth (``space_to_depth``),
    the mean over the image (``mean``) and the gather of attention's
    keys and values (``gather_tokens``).

    A band's global height is learned once (``rows``): the model's
    forward pre-hook (:meth:`hook`) names the global image height, and
    the i-th height asked for under it is all-gathered the first time
    and kept. Every rank asks in the same order, so every rank gathers
    or finds the same heights."""

    def __init__(self, group):
        self.group = group
        self.n, self.rank = dist.get_world_size(group), dist.get_rank(group)
        self._key, self._calls, self._heights = None, 0, {}

    def hook(self, module, args) -> None:
        """Forward pre-hook of the model: its input is a band of an
        image whose height divides by the model axis."""
        self._key, self._calls = args[0].shape[2] * self.n, 0

    def rows(self, x) -> int:
        """The global height of the band ``x`` (a tensor, or its height)."""
        key = (self._key, self._calls)
        self._calls += 1
        h = self._heights.get(key)
        if h is None:
            here = x if isinstance(x, int) else x.shape[2]
            local = torch.tensor([here], dtype=torch.int64)
            if not _gloo(self.group):
                local = local.cuda()
            got = all_gather(local, self.group, 0).tolist()
            h = sum(got)
            want = [b - a for a, b in (band_split(h, self.n, j)
                                       for j in range(self.n))]
            if got != want:
                raise AssertionError(f"bands of {got} rows are not the "
                                     f"split of {h} rows ({want})")
            self._heights[key] = h
        return h

    def _fetch(self, x, h, needs):
        return fetch_rows(x, self.group, h, needs)

    def conv(self, x: torch.Tensor, op, kernel: int, stride: int = 1,
             dilation: int = 1) -> torch.Tensor:
        """A SAME conv of the band ``x``: ``op`` is the conv on input rows
        already padded in height (VALID there, SAME in width)."""
        h = self.rows(x)
        h_out = -(-h // stride)
        plans = [band_plan(h, h_out, self.n, j, kernel, stride, dilation)
                 for j in range(self.n)]
        xr = self._fetch(x, h, [p.rows for p in plans])
        o0, o1 = plans[self.rank].out
        if o1 == o0:
            # an empty band: the op on one window of zeros, cut to no rows,
            # so that its parameters still get a (zero) gradient
            extent = (kernel - 1) * dilation + 1
            return op(x.new_zeros(x.shape[:2] + (extent, x.shape[3])))[
                :, :, :0]
        return op(xr)

    def up(self, x: torch.Tensor, op, factor: int, h_out: int
           ) -> torch.Tensor:
        """``op`` (an upsample of rows by ``factor``: input row i gives
        output rows [factor i, factor (i + 1))) cropped to ``h_out``
        rows, banded as ``h_out``."""
        h = self.rows(x)
        needs = []
        for j in range(self.n):
            o0, o1 = band_split(h_out, self.n, j)
            needs.append((o0 // factor, (o1 - 1) // factor + 1)
                         if o1 > o0 else (0, 0))
        xr = self._fetch(x, h, needs)
        o0, o1 = band_split(h_out, self.n, self.rank)
        if o1 == o0:
            return op(x.new_zeros(x.shape[:2] + (1, x.shape[3])))[:, :, :0]
        skip = o0 - factor * (o0 // factor)
        return op(xr)[:, :, skip:skip + o1 - o0]

    def space_to_depth(self, x: torch.Tensor, block: int, op
                       ) -> torch.Tensor:
        """``op`` (space-to-depth by ``block``) of the band ``x``, banded
        as the packed height."""
        h = self.rows(x)
        h_out = h // block
        needs = [band_plan(h, h_out, self.n, j, block, block,
                           pads=(0, 0)).rows for j in range(self.n)]
        return op(self._fetch(x, h, needs))

    def resize(self, x: torch.Tensor, height: int, width: int
               ) -> torch.Tensor:
        """``models/layers.py:resize_bilinear`` of the band ``x`` to the
        global ``height``: the source rows that this band's output rows'
        weights reach are fetched and contracted; then the width, as
        there."""
        h = self.rows(x)
        if height != h:
            m = _resize_matrix(h, height)
            needs, spans = [], []
            for j in range(self.n):
                o0, o1 = band_split(height, self.n, j)
                nz = np.nonzero(m[:, o0:o1].any(axis=1))[0]
                needs.append((int(nz[0]), int(nz[-1]) + 1) if len(nz)
                             else (0, 0))
                spans.append((o0, o1))
            xr = self._fetch(x, h, needs)
            (o0, o1), (a, b) = spans[self.rank], needs[self.rank]
            wh = _resize_weights(h, height, x.dtype, x.device)
            # the contraction at the one-process shapes, zeros in the rows
            # this band does not read, cut to its output rows: a matmul's
            # sums depend on its shapes, and so its bits are the
            # one-process resize's
            x = torch.matmul(wh.t(), F.pad(xr, (0, 0, a, h - b)))[
                :, :, o0:o1].contiguous()
        if width != x.shape[3]:
            ww = _resize_weights(x.shape[3], width, x.dtype, x.device)
            x = torch.matmul(x, ww)
        return x

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the image's height and width, (N, C, 1, 1) in
        ``x``'s dtype: float32 sums added over the bands."""
        h = self.rows(x)
        total = psum(x.float().sum((2, 3), keepdim=True), self.group)
        return (total / (h * x.shape[3])).to(x.dtype)

    def gather_tokens(self, t: torch.Tensor, h: int, w: int
                      ) -> torch.Tensor:
        """(N, tokens, C) of every band (``h`` rows of ``w`` tokens in
        all, row major), gathered in rank order: the whole image's
        tokens; backward: the gradient summed over the ranks, this
        rank's tokens of it."""
        counts = tuple((b - a) * w for a, b in (band_split(h, self.n, j)
                                                for j in range(self.n)))
        return _GatherBands.apply(t, self.group, counts, 1)


def group_norm_sharded(x: torch.Tensor, norm: nn.GroupNorm, group
                       ) -> torch.Tensor:
    """flax ``nn.GroupNorm`` of a float32 (N, C, h, W) band whose height
    is sharded over ``group``: the sums and counts of
    ``models/layers.py:group_norm_flax`` all-reduced (bands may differ
    in height), the statistics those of the whole height."""
    return group_norm_flax(x, norm, lambda t: psum(t, group))


class ShardedLayer:
    """A layer's op on sharded parameters or a sharded input, called as
    ``spmd(x, fn, rows)`` with ``fn(x, weight, bias)`` the plain op:

    * ``fsdp_group``: the weight is a stored shard along ``dim``,
      gathered before use;
    * ``tp_group``: column parallel: the (gathered) weight holds this
      rank's output channels; the bias is sliced to them, the input is
      the same on every rank (a depthwise conv's input channels are
      sliced with its outputs), and the output's channels are gathered;
    * ``bands``: the input is a height band (:class:`Bands`) and
      ``rows`` says how the op's output rows read its input rows
      (``models/layers.py:Window`` for a SAME conv, ``Upsample`` for an
      upsample cropped to a height); ``fn(x, weight, bias, band=True)``
      then gets the input rows it reads, padded in height already. An op
      called without ``rows`` is local to its rows."""

    def __init__(self, module: nn.Module, dim: int, tp_group=None,
                 fsdp_group=None, bands: Optional[Bands] = None):
        self.module, self.dim = module, dim
        self.tp_group, self.fsdp_group = tp_group, fsdp_group
        self.bands = bands

    def __call__(self, x, fn, rows=None):
        m = self.module
        w, b = m.weight, m.bias
        if self.fsdp_group is not None:
            w = gather_param(w, self.fsdp_group, self.dim)
        if self.bands is not None and rows is not None:
            return rows.band(self.bands, x,
                             lambda xr: fn(xr, w, b, band=True))
        if self.tp_group is None:
            return fn(x, w, b)
        g = self.tp_group
        b = split(b, g, 0)
        if isinstance(m, nn.Conv2d) and m.groups > 1:
            x = split(x, g, 1)
        else:
            x = copy(x, g)
        return gather(fn(x, w, b), g, -1 if isinstance(m, nn.Linear) else 1)


class ShardedNorm:
    """A GroupNorm over a height band sharded over ``group``."""

    def __init__(self, module: nn.GroupNorm, group):
        self.module, self.group = module, group

    def __call__(self, x, fn, rows=None):
        return group_norm_sharded(x, self.module, self.group)


def spec_axes(sharding: Sharding) -> List[str]:
    """The mesh axes a tensor is sharded over."""
    out: List[str] = []
    for entry in sharding.spec:
        if entry is not None:
            out += [entry] if isinstance(entry, str) else list(entry)
    return out


def norm_group(sharding: Sharding):
    """The group over which a tensor's shards add up to the whole (None
    for a replicated one)."""
    axes = set(spec_axes(sharding))
    if not axes:
        return None
    mesh = sharding.mesh
    return mesh.group("world" if axes == {"data", "model"} else axes.pop())


def local_shard(full: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """This rank's shard of a full tensor."""
    index = tuple(slice(None) if entry is None
                  else shard_slice(full.shape[i], entry, sharding.mesh)
                  for i, entry in enumerate(sharding.spec))
    return full[index]


def full_tensor(t: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """The full tensor of this rank's shard ``t`` (every rank calls)."""
    for dim, entry in enumerate(sharding.spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else entry
        for axis in reversed(axes):  # the minor axis first
            t = all_gather(t, sharding.mesh.group(axis), dim)
    return t


def shard_model(model: nn.Module, mesh: Mesh, config
                ) -> Dict[str, Sharding]:
    """Shard ``model`` in place for this rank of ``mesh`` under
    ``config`` (its ``spatial`` and ``fsdp``): every parameter the rule
    shards keeps this rank's shard, and the layers get their wrappers
    (:func:`wrap_layers`). Returns the parameters' shardings by name."""
    shardings = param_shardings(
        mesh, model, tp_min_features=(1 << 30) if config.spatial else 256,
        fsdp=config.fsdp)
    modules = dict(model.named_modules())
    with torch.no_grad():
        for name, sh in shardings.items():
            if not sh.is_fully_replicated:
                mod_name, _, pname = name.rpartition(".")
                mod = modules[mod_name]
                mod._parameters[pname] = nn.Parameter(
                    local_shard(mod._parameters[pname], sh).clone())
    wrap_layers(model, mesh, config, shardings)
    return shardings


def wrap_layers(model: nn.Module, mesh: Mesh, config,
                shardings: Dict[str, Sharding]) -> None:
    """Attach to each layer of ``model`` (whose parameters are this
    rank's shards already: a sharded model, or a twin that shares its
    tensors) its ``ShardedLayer``; with ``spatial`` (and more than one
    model rank) the model gets its :class:`Bands` (``model.bands``, and
    on every submodule that declares a ``bands`` attribute, each read by
    the model's own forward), the convs and upsamplers of its
    ``spatial_layers()`` run on bands, and its GroupNorms there take
    their statistics over the whole height."""
    modules = dict(model.named_modules())
    for name, sh in shardings.items():
        if sh.is_fully_replicated:
            continue
        mod = modules[name.rpartition(".")[0]]
        axes = spec_axes(sh)
        mod.spmd = ShardedLayer(
            mod, cout_dim(mod),
            tp_group=mesh.group("model") if "model" in axes else None,
            fsdp_group=mesh.group("data") if "data" in axes else None)
    group = mesh.group("model")
    if not (config.spatial and group is not None):
        return
    bands = Bands(group)
    model.register_forward_pre_hook(bands.hook)
    for mod in model.modules():
        if hasattr(type(mod), "bands"):
            mod.bands = bands
    for mod in model.spatial_layers():
        if isinstance(mod, nn.GroupNorm):
            mod.spmd = ShardedNorm(mod, group)
        elif "spmd" in mod.__dict__:
            mod.spmd.bands = bands
        else:
            mod.spmd = ShardedLayer(mod, cout_dim(mod), bands=bands)


class GradSync:
    """Sums each gradient over the ranks that hold the rest of the
    batch: over "data" (and, for a spatial step, "model" too, whose
    ranks hold other rows), less the axes a gathered parameter's
    reduce-scatter has summed already. A column-parallel layer's
    replicated parameters get their whole gradient on every model rank
    (``gather``'s backward), so TP adds no model-axis sum."""

    def __init__(self, mesh: Mesh, shardings: Dict[str, Sharding],
                 spatial: bool):
        buckets: Dict[tuple, List[str]] = {}
        for name, sh in shardings.items():
            axes = spec_axes(sh)
            need = [a for a in (("data", "model") if spatial else ("data",))
                    if a not in axes and mesh.shape[a] > 1]
            if not need:
                continue
            key = ("world",) if len(need) == 2 else tuple(need)
            buckets.setdefault(key, []).append(name)
        self.buckets = [(mesh.group(key[0]), names)
                        for key, names in sorted(buckets.items())]

    @torch.no_grad()
    def __call__(self, params: Dict[str, torch.Tensor]) -> None:
        for group, names in self.buckets:
            grads = [params[n].grad for n in names]
            flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]),
                              group)
            offset = 0
            for g in grads:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()
