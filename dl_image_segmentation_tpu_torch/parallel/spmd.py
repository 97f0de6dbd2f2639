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
  ``psum`` (all-reduce both ways) and ``halo`` (one row from each
  neighbour over "model", zeros at the global top and bottom; the halo
  rows' gradient goes back and is added to the neighbour's rows).
* ``shard_model(model, mesh, config)`` keeps this rank's shard of each
  parameter that ``param_shardings`` shards and attaches a wrapper to
  its layer as ``layer.spmd``, which ``models/layers.py:call_layer``
  calls in place of the plain op: a column-parallel conv, upsample or
  depthwise conv (its output channels computed here and gathered over
  "model"), a gathered-storage kernel (FSDP), and for a model that names
  its ``spatial_layers()`` (the U-Net) a 3x3 SAME conv with halo rows
  and a GroupNorm whose statistics cover the whole height (float32 sums
  all-reduced over "model", flax's variance ``max(E[x^2] - E[x]^2,
  0)``).
* ``GradSync`` sums each gradient over the ranks that hold the rest of
  the batch, coalesced into one buffer a group.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.distributed as dist
from torch import nn

from .sharding import (Mesh, Sharding, cout_dim, param_shardings,
                       shard_slice)

__all__ = ["GradSync", "ShardedLayer", "ShardedNorm", "all_gather",
           "all_reduce", "copy", "full_tensor", "gather", "gather_param",
           "group_norm_sharded", "halo", "local_shard", "norm_group",
           "psum", "reduce_scatter", "shard_model", "split",
           "spec_axes"]

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


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n, i = dist.get_world_size(group), dist.get_rank(group)
        edges = all_gather(torch.cat([x[:, :, :1], x[:, :, -1:]], 2)
                           .unsqueeze(0), group, 0)
        zero = x.new_zeros(x[:, :, :1].shape)
        above = edges[i - 1][:, :, 1:2] if i > 0 else zero
        below = edges[i + 1][:, :, 0:1] if i < n - 1 else zero
        return torch.cat([above, x, below], 2)

    @staticmethod
    def backward(ctx, g):
        n, i = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        sent = all_gather(torch.cat([g[:, :, :1], g[:, :, -1:]], 2)
                          .unsqueeze(0), ctx.group, 0)
        dx = g[:, :, 1:-1].clone()
        if i > 0:  # my first row was the row below of rank i - 1
            dx[:, :, :1] += sent[i - 1][:, :, 1:2]
        if i < n - 1:  # my last row was the row above of rank i + 1
            dx[:, :, -1:] += sent[i + 1][:, :, 0:1]
        return dx, None


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


def halo(x: torch.Tensor, group) -> torch.Tensor:
    """(N, C, h, W) band -> (N, C, h + 2, W) with the neighbours' edge
    rows (zeros at the global top and bottom)."""
    return _Halo.apply(x, group)


def group_norm_sharded(x: torch.Tensor, norm: nn.GroupNorm, group
                       ) -> torch.Tensor:
    """flax ``nn.GroupNorm`` of a float32 (N, C, h, W) band whose height
    is sharded over ``group``: per (image, group) sums of x and x^2 are
    all-reduced, mean and ``max(E[x^2] - E[x]^2, 0)`` taken over the
    whole height, ``(x - mean) * (rsqrt(var + eps) * scale) + bias``."""
    n, c, h, w = x.shape
    g = norm.num_groups
    xg = x.reshape(n, g, c // g, h, w)
    sums = psum(torch.stack([xg.sum((2, 3, 4)), (xg * xg).sum((2, 3, 4))]),
                group)
    count = (c // g) * w * h * dist.get_world_size(group)
    mean = sums[0] / count
    var = torch.clamp(sums[1] / count - mean * mean, min=0.0)
    inv = torch.rsqrt(var + norm.eps)[:, :, None, None, None]
    y = (xg - mean[:, :, None, None, None]) * inv
    return (y.reshape(n, c, h, w) * norm.weight[None, :, None, None]
            + norm.bias[None, :, None, None])


class ShardedLayer:
    """A layer's op on sharded parameters or a sharded input, called as
    ``spmd(x, fn)`` with ``fn(x, weight, bias)`` the plain op:

    * ``fsdp_group``: the weight is a stored shard along ``dim``,
      gathered before use;
    * ``tp_group``: column parallel: the (gathered) weight holds this
      rank's output channels; the bias is sliced to them, the input is
      the same on every rank (a depthwise conv's input channels are
      sliced with its outputs), and the output's channels are gathered;
    * ``halo_group``: a stride-1 3x3 SAME conv on a height band: the band
      with its neighbours' rows, the two extra output rows dropped."""

    def __init__(self, module: nn.Module, dim: int, tp_group=None,
                 fsdp_group=None, halo_group=None):
        self.module, self.dim = module, dim
        self.tp_group, self.fsdp_group = tp_group, fsdp_group
        self.halo_group = halo_group

    def __call__(self, x, fn):
        m = self.module
        w, b = m.weight, m.bias
        if self.fsdp_group is not None:
            w = gather_param(w, self.fsdp_group, self.dim)
        if self.halo_group is not None:
            return fn(halo(x, self.halo_group), w, b)[:, :, 1:-1]
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

    def __call__(self, x, fn):
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
    shards keeps this rank's shard, and its layer gets its
    ``ShardedLayer``; with ``spatial`` (and more than one model rank) the
    (conv, norm) pairs of the model's ``spatial_layers()`` get halo convs
    and sharded GroupNorms. Returns the parameters' shardings by name."""
    shardings = param_shardings(
        mesh, model, tp_min_features=(1 << 30) if config.spatial else 256,
        fsdp=config.fsdp)
    modules = dict(model.named_modules())
    with torch.no_grad():
        for name, sh in shardings.items():
            if sh.is_fully_replicated:
                continue
            mod_name, _, pname = name.rpartition(".")
            mod = modules[mod_name]
            axes = spec_axes(sh)
            mod._parameters[pname] = nn.Parameter(
                local_shard(mod._parameters[pname], sh).clone())
            mod.spmd = ShardedLayer(
                mod, cout_dim(mod),
                tp_group=mesh.group("model") if "model" in axes else None,
                fsdp_group=mesh.group("data") if "data" in axes else None)
    group = mesh.group("model")
    if config.spatial and group is not None:
        for conv, norm in model.spatial_layers():
            layer = conv.__dict__.get("spmd")
            if layer is None:
                conv.spmd = ShardedLayer(conv, 0, halo_group=group)
            else:
                layer.halo_group = group
            norm.spmd = ShardedNorm(norm, group)
    return shardings


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
