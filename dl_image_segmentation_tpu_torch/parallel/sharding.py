"""The ("data", "model") mesh and the sharding rules of the trainer.

A port of the JAX package's ``parallel/sharding.py``. The world's ranks
form a 2-D mesh, row major (``rank = d * n_model + m``, as
``np.array(devices).reshape(n_data, n_model)``), held as a torch
``DeviceMesh`` with dims ``("data", "model")``. Batches are sharded over
"data" (with ``spatial``, the image height over "model" too); conv
kernels of stages at least ``tp_min_features`` wide are sharded over
"model" on their output channels, and with ``fsdp`` large kernels are
stored sharded over "data". Where GSPMD derives the collectives from
these seeds in the JAX package, ``parallel/spmd.py`` writes them out.

A ``Sharding`` is a mesh and a spec: one entry per tensor dim, None or
an axis name or a tuple of axis names (the first the major one), the
JAX ``PartitionSpec``'s meaning. ``param_shardings`` is a pure function
of the mesh's axis sizes and the parameter shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from .distributed import local_device, world_size

__all__ = ["Mesh", "Sharding", "batch_sharding", "cout_dim", "make_mesh",
           "param_shardings", "replicated_sharding", "shard_batch_local",
           "shard_slice"]


class Mesh:
    """``shape`` {"data": n_data, "model": n_model}; ``device`` this rank's
    device; ``device_mesh`` the torch DeviceMesh in a world (None in one
    process). ``coords`` is this rank's (d, m); ``group(axis)`` the
    process group of the ranks that share this rank's other coordinate
    ("data", "model", or "world"), None where that axis has one rank."""

    def __init__(self, n_data: int = 1, n_model: int = 1, device=None,
                 device_mesh=None):
        self.shape = {"data": int(n_data), "model": int(n_model)}
        self.device = torch.device(device) if device is not None else None
        self.device_mesh = device_mesh
        r = dist.get_rank() if device_mesh is not None else 0
        self.coords = (r // self.shape["model"], r % self.shape["model"])

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]

    def group(self, axis: str):
        if self.device_mesh is None:
            return None
        if axis == "world":
            return dist.group.WORLD if self.size > 1 else None
        if self.shape[axis] == 1:
            return None
        return self.device_mesh.get_group(axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"


@dataclasses.dataclass(frozen=True)
class Sharding:
    mesh: Mesh
    spec: Tuple = ()

    @property
    def is_fully_replicated(self) -> bool:
        return all(s is None for s in self.spec)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device=None) -> Mesh:
    """The ("data", "model") mesh over the world's ranks, one device a
    rank (``device``: this rank's, default :func:`local_device`).
    ``n_data`` defaults to world size // n_model. Outside a world the
    mesh is this process's one device; a mesh of more ranks than the
    world has raises ``ValueError`` naming the world it needs."""
    n = world_size()
    if n_model < 1 or (n_data is not None and n_data < 1):
        raise ValueError(f"mesh axes must be >= 1: n_data={n_data}, "
                         f"n_model={n_model}")
    if n_data is None:
        n_data = n // n_model
    if n_data * n_model != n or n_data == 0:
        need = n_model * max(1, n_data)
        raise ValueError(
            f"a mesh of n_data={n_data} x n_model={n_model} needs a world "
            f"of {need} processes (one device each); this world has {n} "
            f"-- start {need} ranks, e.g. torchrun --nproc-per-node {need} "
            "-m dl_image_segmentation_tpu_torch.cli ..., or set "
            "DLSEG_NUM_PROCESSES, DLSEG_PROCESS_ID and COORDINATOR_ADDRESS")
    device = local_device(device)
    if n == 1 and not dist.is_initialized():
        return Mesh(1, 1, device)
    from torch.distributed.device_mesh import init_device_mesh
    # the DeviceMesh holds the process groups; a gloo world on cards
    # (ranks that share one) keeps its groups on gloo as a CPU mesh
    kind = ("cpu" if dist.get_backend() == dist.Backend.GLOO
            else device.type)
    dm = init_device_mesh(kind, (n_data, n_model),
                          mesh_dim_names=("data", "model"))
    return Mesh(n_data, n_model, device, dm)


def _axis_sizes(mesh) -> Tuple[int, int]:
    shape = mesh.shape if isinstance(mesh, Mesh) else mesh
    return int(shape["data"]), int(shape["model"])


def batch_sharding(mesh: Mesh, ndim: int = 4,
                   spatial: bool = False) -> Sharding:
    """The leading (batch) axis over "data"; with ``spatial`` axis 1
    (the image height of an NHWC batch or an NHW label map) over
    "model" too."""
    if spatial and ndim >= 2:
        return Sharding(mesh, ("data", "model") + (None,) * (ndim - 2))
    return Sharding(mesh, ("data",) + (None,) * (ndim - 1))


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def cout_dim(module: nn.Module) -> Optional[int]:
    """The torch dim of ``module.weight`` that is the flax kernel's last
    (output feature) axis: dim 0 of a Conv2d (a depthwise one too) and
    of a Linear, dim 1 of a ConvTranspose2d's (cin, cout, kh, kw); None
    for a layer without a kernel (norms)."""
    if isinstance(module, nn.ConvTranspose2d):
        return 1
    if isinstance(module, (nn.Conv2d, nn.Linear)):
        return 0
    return None


def param_shardings(mesh: Union[Mesh, Mapping[str, int]],
                    params: nn.Module, tp_min_features: int = 256,
                    fsdp: bool = False, fsdp_min_size: int = 16384
                    ) -> Dict[str, Sharding]:
    """A Sharding per parameter of the model ``params``, by name: the JAX
    package's rule on the flax-equivalent axis (:func:`cout_dim`). A
    4-D kernel with >= ``tp_min_features`` output channels that divide
    by the model axis is sharded over "model" on them; with ``fsdp``, a
    kernel of ndim >= 2 and >= ``fsdp_min_size`` elements whose output
    channels divide by the ranks that share it is stored sharded over
    "data" too (over ("model", "data") where it is also model sharded).
    Everything else (biases, norm scales) is replicated. ``mesh`` may
    be a Mesh or a mapping of axis sizes."""
    data_size, model_size = _axis_sizes(mesh)
    modules = dict(params.named_modules())
    out = {}
    for name, p in params.named_parameters():
        mod_name, _, pname = name.rpartition(".")
        dim = cout_dim(modules[mod_name])
        spec: Tuple = (None,) * p.ndim
        if dim is not None and pname == "weight":
            cout = p.shape[dim]
            tp = (model_size > 1 and p.ndim == 4
                  and cout >= tp_min_features and cout % model_size == 0)
            need = data_size * (model_size if tp else 1)
            zero = (fsdp and data_size > 1 and p.ndim >= 2
                    and p.numel() >= fsdp_min_size and cout % need == 0)
            axes = (["model"] if tp else []) + (["data"] if zero else [])
            if axes:
                entry = axes[0] if len(axes) == 1 else tuple(axes)
                spec = tuple(entry if i == dim else None
                             for i in range(p.ndim))
        out[name] = Sharding(mesh, spec)
    return out


def shard_slice(size: int, entry, mesh: Mesh) -> slice:
    """This rank's slice of an extent ``size`` sharded by the spec entry
    ``entry`` (an axis name or a tuple of them, the first the major)."""
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    index, count = 0, 1
    for axis in axes:
        coord = mesh.coords[0] if axis == "data" else mesh.coords[1]
        index = index * mesh.shape[axis] + coord
        count *= mesh.shape[axis]
    if size % count:
        raise ValueError(f"an extent of {size} does not divide over "
                         f"{axes} ({count} ranks)")
    step = size // count
    return slice(index * step, (index + 1) * step)


def _local(x, sharding: Sharding):
    index = tuple(slice(None) if entry is None
                  else shard_slice(x.shape[i], entry, sharding.mesh)
                  for i, entry in enumerate(sharding.spec))
    return x[index]


def shard_batch_local(mesh: Mesh, batch, spatial: bool = False):
    """This rank's part of a global batch (an array or a tuple of them;
    every rank passes the same global batch): its rows over "data" and,
    with ``spatial``, its band of image rows over "model". A host numpy
    batch becomes tensors on the mesh's device (pinned and copied
    without blocking on the card); a batch of tensors is cut where it
    lies."""
    def put(x):
        if isinstance(x, torch.Tensor):
            return _local(x, batch_sharding(mesh, x.ndim, spatial))
        part = np.ascontiguousarray(_local(
            np.asarray(x), batch_sharding(mesh, np.ndim(x), spatial)))
        t = torch.from_numpy(part)
        if mesh.device.type == "cuda":
            t = t.pin_memory()
        return t.to(mesh.device, non_blocking=True)
    if isinstance(batch, (tuple, list)):
        return type(batch)(put(x) for x in batch)
    return put(batch)
