"""Profiling and throughput observability.

The port's counterpart of the JAX package's ``utils/profiling.py``:

* ``StageTimer`` -- per-stage wall time and item/byte counters for host
  pipelines (a copy of the JAX package's);
* ``trace`` -- a context manager around ``torch.profiler`` that writes
  a Chrome trace of host and CUDA activity (``trace.json``; open it in
  Perfetto or chrome://tracing), where the JAX package writes a
  ``jax.profiler`` trace;
* ``duty_cycle`` -- a step function's end-to-end rate and its device
  busy fraction, from two windows: one fed by the input iterator, one
  on a device-resident batch rolled each step;
* ``duty`` -- the busy share of a wall-clock window, which
  ``duty_cycle`` and ``Trainer.throughput_stats`` both report.

``trace`` and ``duty_cycle`` run on the CUDA card unless called with
``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator

__all__ = ["StageTimer", "duty", "duty_cycle", "trace"]


class StageTimer:
    """Accumulates wall time + item/byte counts per named stage."""

    def __init__(self):
        self.seconds: Dict[str, float] = defaultdict(float)
        self.items: Dict[str, int] = defaultdict(int)
        self.bytes: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 1, nbytes: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] += time.perf_counter() - t0
            self.items[name] += items
            self.bytes[name] += nbytes

    def report(self) -> str:
        lines = []
        for name in sorted(self.seconds):
            s = self.seconds[name]
            line = f"{name:24s} {s:8.3f}s"
            if self.items[name]:
                line += f"  {self.items[name] / max(s, 1e-9):10.1f} items/s"
            if self.bytes[name]:
                line += f"  {self.bytes[name] / max(s, 1e-9) / 1e6:8.1f} MB/s"
            lines.append(line)
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str, device=None):
    """``torch.profiler`` over the block, host and (on the card) CUDA
    activity; writes ``logdir/trace.json``. Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..device import resolve_device
    activities = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def duty(busy_seconds: float, wall_seconds: float) -> float:
    """The busy share of a wall-clock window (0 for an empty one)."""
    return busy_seconds / wall_seconds if wall_seconds else 0.0


def duty_cycle(step_fn: Callable, batches: Iterator, n_steps: int,
               device_only_batch=None, device=None) -> Dict[str, float]:
    """End-to-end step rate and the device-busy fraction of ``step_fn``.

    Runs ``n_steps`` steps on batches from ``batches`` (launched without
    a sync, one ``torch.cuda.synchronize`` at the end), then the same
    count on a device-resident batch (``device_only_batch``, else the
    first batch copied to the device) whose first tensor is rolled by a
    different amount each step, as the JAX package does. duty =
    device time / end-to-end time, at most 1."""
    import numpy as np
    import torch

    from ..device import resolve_device
    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    first = next(batches)
    step_fn(*first)
    sync()

    t0 = time.perf_counter()
    for _ in range(n_steps):
        step_fn(*next(batches))
    sync()
    e2e = time.perf_counter() - t0

    # the device-only window keeps its batch on the device: a host batch
    # would be copied in every step of the timed window
    resident = device_only_batch if device_only_batch is not None else first
    resident = tuple(
        (x if torch.is_tensor(x)
         else torch.from_numpy(np.ascontiguousarray(x))).to(dev)
        for x in resident)
    sync()
    rest = resident[1:]
    t0 = time.perf_counter()
    for i in range(n_steps):
        step_fn(torch.roll(resident[0], i + 1), *rest)
    sync()
    dev_s = time.perf_counter() - t0

    return {"e2e_seconds": e2e, "device_seconds": dev_s,
            "steps_per_sec": n_steps / e2e,
            "duty_cycle": min(duty(dev_s, e2e), 1.0)}
