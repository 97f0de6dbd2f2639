"""A pool of examples kept on the device, sampled by ``train_scanned``.

A port of the JAX package's ``train/pool.py``: a pool of examples lives
in device memory in the source dtype (a 2,000-chip 256 px RGB uint8
pool is ~400 MB), batches are gathered on the device, and the pool is
refreshed from the host feed between dispatches. Sampling is uniform
with replacement; the indices are drawn by the caller (from a
``torch.Generator`` on the device, or replayed) and passed in.

In a world, a pool given a data-axis sharding (``batch_sharding(mesh)``,
as the JAX package's ``_rank_adapted`` places one sharding on the 4-D
images and the 3-D labels alike) stores on each rank its contiguous
slice of the examples; every rank is given the same host arrays.
``take`` fetches the examples at global indices, wherever they live.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["DeviceDataPool", "sample_batch"]


class DeviceDataPool:
    """images (N, H, W, C) and labels (N, H, W) on ``device`` (None =
    the sharding's mesh's device, else the CUDA card), each in the dtype
    the source gave; with a ``sharding`` over "data", this rank's rows
    only (N must divide by the data axis)."""

    def __init__(self, images: np.ndarray, labels: np.ndarray, device=None,
                 sharding=None):
        self.sharding = None
        self._rows = slice(0, len(images))
        if sharding is not None and sharding.spec[:1] == ("data",) \
                and sharding.mesh.shape["data"] > 1:
            from ..parallel.sharding import shard_slice
            self.sharding = sharding
            self._rows = shard_slice(len(images), "data", sharding.mesh)
        if device is None and sharding is not None:
            device = sharding.mesh.device
        self.device = resolve_device(device)
        self._size = len(images)
        self.images = torch.from_numpy(np.ascontiguousarray(
            images[self._rows])).to(self.device)
        self.labels = torch.from_numpy(np.ascontiguousarray(
            labels[self._rows])).to(self.device)

    @property
    def size(self) -> int:
        """The number of examples in the whole pool."""
        return self._size

    def take(self, idx: torch.Tensor):
        """(images, labels int32) of the examples at the global indices
        ``idx``. A sharded pool gathers them over "data": each rank
        contributes the rows it holds of every index every rank asked
        for (the draws are the same on every rank), and keeps its own."""
        if self.sharding is None:
            return sample_batch(self.images, self.labels, idx)
        from ..parallel.spmd import all_gather
        mesh = self.sharding.mesh
        group = mesh.group("data")
        everyone = all_gather(idx.unsqueeze(0), group, 0)
        lo, n = self._rows.start, self.images.shape[0]
        mine = (everyone >= lo) & (everyone < lo + n)
        local = torch.where(mine, everyone - lo, 0).reshape(-1)
        shape = everyone.shape

        def held(pool):
            rows = pool[local]
            keep = mine.reshape(-1).reshape((-1,) + (1,) * (rows.ndim - 1))
            return torch.where(keep, rows, torch.zeros_like(rows)).reshape(
                shape + tuple(pool.shape[1:]))
        d = mesh.coords[0]
        owner = (everyone[d] // n).long()
        out = []
        for pool in (self.images, self.labels):
            got = all_gather(held(pool).unsqueeze(0), group, 0)
            out.append(got[owner, d, torch.arange(len(idx),
                                                  device=idx.device)])
        return out[0], out[1].to(torch.int32)

    @classmethod
    def from_feed(cls, batches: Iterator, n_examples: int,
                  device=None, sharding=None) -> "DeviceDataPool":
        """Fill a pool of ``n_examples`` from a batch iterator (e.g. a
        TFRecordFeed with ``scale="raw"``, which keeps uint8 sources
        uint8: a float scale would quadruple the pool's memory)."""
        imgs, lbls, have = [], [], 0
        for bi, bl in batches:
            imgs.append(bi)
            lbls.append(bl)
            have += len(bi)
            if have >= n_examples:
                break
        if not imgs:
            raise ValueError("feed produced no batches; cannot build a "
                             "device data pool")
        return cls(np.concatenate(imgs)[:n_examples],
                   np.concatenate(lbls)[:n_examples], device=device,
                   sharding=sharding)

    def refresh(self, images: np.ndarray, labels: np.ndarray,
                offset: int = 0) -> None:
        """Overwrite a contiguous slice of the pool with host data (one
        copy each, ordered on the current stream after the steps that
        read the pool). Like ``lax.dynamic_update_slice``, an offset
        that would run past the end is moved back so the slice fits."""
        n = len(images)
        if n > self.size:
            raise ValueError(
                f"refresh batch ({n} examples) larger than the pool "
                f"({self.size}); use a pool at least one refresh batch "
                "deep or a smaller feed batch size")
        offset = max(0, min(int(offset), self.size - n))
        # the part of [offset, offset + n) that this rank holds
        lo = max(offset, self._rows.start)
        hi = min(offset + n, self._rows.stop)
        if hi <= lo:
            return
        for dst, src in ((self.images, images), (self.labels, labels)):
            host = torch.from_numpy(np.ascontiguousarray(
                src[lo - offset:hi - offset])).to(dst.dtype)
            if dst.is_cuda:
                host = host.pin_memory()
            dst[lo - self._rows.start:hi - self._rows.start].copy_(
                host, non_blocking=True)


def sample_batch(pool_images: torch.Tensor, pool_labels: torch.Tensor,
                 idx: torch.Tensor):
    """The examples at ``idx`` (a batch of indices into the pool), on
    the device: images in the pool's dtype (the train step scales them
    with ``normalize_images``), labels int32."""
    return pool_images[idx], pool_labels[idx].to(torch.int32)
