"""A pool of examples kept on the device, sampled by ``train_scanned``.

A port of the JAX package's ``train/pool.py``: a pool of examples lives
in device memory in the source dtype (a 2,000-chip 256 px RGB uint8
pool is ~400 MB), batches are gathered on the device, and the pool is
refreshed from the host feed between dispatches. Sampling is uniform
with replacement; the indices are drawn by the caller (from a
``torch.Generator`` on the device, or replayed) and passed in.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["DeviceDataPool", "sample_batch"]


class DeviceDataPool:
    """images (N, H, W, C) and labels (N, H, W) on ``device`` (None =
    the CUDA card), each in the dtype the source gave."""

    def __init__(self, images: np.ndarray, labels: np.ndarray, device=None):
        self.device = resolve_device(device)
        self.images = torch.from_numpy(np.ascontiguousarray(images)).to(
            self.device)
        self.labels = torch.from_numpy(np.ascontiguousarray(labels)).to(
            self.device)

    @property
    def size(self) -> int:
        return self.images.shape[0]

    @classmethod
    def from_feed(cls, batches: Iterator, n_examples: int,
                  device=None) -> "DeviceDataPool":
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
                   np.concatenate(lbls)[:n_examples], device=device)

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
        for dst, src in ((self.images, images), (self.labels, labels)):
            host = torch.from_numpy(np.ascontiguousarray(src)).to(dst.dtype)
            if dst.is_cuda:
                host = host.pin_memory()
            dst[offset:offset + n].copy_(host, non_blocking=True)


def sample_batch(pool_images: torch.Tensor, pool_labels: torch.Tensor,
                 idx: torch.Tensor):
    """The examples at ``idx`` (a batch of indices into the pool), on
    the device: images in the pool's dtype (the train step scales them
    with ``normalize_images``), labels int32."""
    return pool_images[idx], pool_labels[idx].to(torch.int32)
