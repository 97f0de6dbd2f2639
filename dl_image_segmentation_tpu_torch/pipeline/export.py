"""Chip export: resumable, fault-tolerant chip-creation fan-out.

PyTorch counterpart of the JAX package's pipeline/export.py, the
programmatic replacement for the reference's notebook orchestration
(run_export_for_year, create_training_samples.ipynb cells 76-87):
idempotent resume via output-file existence, a bounded retry loop for
tiles whose catalog gather failed, pre-created output dirs (avoids the
makedirs race the notebook documents), thread-pool fan-out (the codecs
release the GIL).

Unlike the JAX package, errors of the device stage (ops, kernels, CUDA)
are not retried and never turn a batched attempt into a per-tile one:
they propagate to the caller."""

from __future__ import annotations

import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

from .. import storage
from ..device import resolve_device
from .chips import DLTileJobConfig, create_chips_for_tile, is_done


@dataclass
class ExportReport:
    total_jobs: int = 0
    completed: int = 0
    skipped_existing: int = 0
    failed: List[str] = field(default_factory=list)
    attempts: int = 0
    seconds: float = 0.0

    @property
    def ok(self) -> bool:
        return not self.failed


def run_export(jobs: Sequence[DLTileJobConfig],
               n_workers: int = 8,
               max_attempts: int = 20,
               progress: Optional[Callable[[str], None]] = print,
               low_priority: bool = False,
               host_index: int = 0, host_count: int = 1,
               batch_tiles: int = 0, device=None
               ) -> ExportReport:
    """Run chip creation for all jobs with resume + retry, on ``device``
    (None -> CUDA; the CPU only with ``device="cpu"``).

    Mirrors the notebook protocol: each attempt runs every not-yet-done
    job; tiles whose catalog gather failed (None results) are retried
    up to ``max_attempts`` times (create nb cells 82-83). Device-stage
    exceptions propagate. ``low_priority``
    renices the process so a big oversubscribed export doesn't starve
    an interactive machine (the notebook's psutil priority drop,
    create nb cell 78).

    host_index/host_count partition the job list round-robin across
    hosts (same per-host ownership as the TFRecord writers); exports
    are idempotent per output file, so overlapping runs are safe and
    the union equals a single-host run.

    batch_tiles > 0 switches to the BATCHED compositor
    (pipeline/batch.py): K tiles composited + burned per kernel launch
    instead of one; the same bytes as the JAX package's batched export
    (see pipeline/batch.py on label pixels at polygon boundaries)."""
    device = resolve_device(device)
    if host_count > 1:
        jobs = [j for k, j in enumerate(jobs) if k % host_count == host_index]
    t0 = time.perf_counter()
    report = ExportReport(total_jobs=len(jobs))
    if not jobs:
        return report
    if low_priority:
        try:
            os.nice(10)
        except OSError:
            pass  # already at/below priority, or not permitted

    # pre-create directories once (notebook cell 76: avoids the
    # parallel-makedirs race in workers)
    for j in jobs:
        storage.makedirs(storage.join(j.OUTFOLDER, "images"), exist_ok=True)
        storage.makedirs(storage.join(j.OUTFOLDER, "labels"), exist_ok=True)

    pending = [j for j in jobs if not is_done(j)]
    report.skipped_existing = len(jobs) - len(pending)

    def attempt_one(job):
        _, img, _ = create_chips_for_tile(job, device=device)
        return job, img is not None

    for attempt in range(max_attempts):
        if not pending:
            break
        report.attempts = attempt + 1
        if progress:
            progress(f"attempt {attempt + 1}: {len(pending)} tiles")
            sys.stdout.flush()
        if batch_tiles > 0:
            from .batch import create_chips_for_tiles_batched
            outs = create_chips_for_tiles_batched(
                pending, batch_tiles=batch_tiles,
                gather_workers=n_workers, device=device)
            results = [(j, img is not None) for j, img, _ in outs]
        elif n_workers <= 1 or len(pending) == 1:
            results = [attempt_one(j) for j in pending]
        else:
            with ThreadPoolExecutor(max_workers=n_workers) as ex:
                results = list(ex.map(attempt_one, pending))
        next_pending = [j for j, ok in results if not ok]
        report.completed += len(pending) - len(next_pending)
        pending = next_pending

    report.failed = [j.DLTILE.key for j in pending]
    report.seconds = time.perf_counter() - t0
    if progress:
        progress(f"export done: {report.completed} created, "
                 f"{report.skipped_existing} already existed, "
                 f"{len(report.failed)} failed, "
                 f"{report.seconds:.1f}s")
    return report
