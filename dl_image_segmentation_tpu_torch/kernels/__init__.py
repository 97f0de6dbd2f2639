"""Hand-written CUDA kernels for Hopper: build, load, count launches.

Each ``csrc/*.cu`` source is compiled with nvcc for ``sm_90a`` into the
checkout's ``build/`` directory at first use, exposes a plain C
interface, and is called through ctypes with pointers and the current
CUDA stream passed as ``c_void_p``. Nothing is compiled or loaded at
import time, so the CPU tests can import every module.

The wrappers that launch the kernels live beside their plain PyTorch
versions (ops/compositing.py, ops/rasterize.py). Each wrapper adds one
to its :class:`LaunchCounter` where it launches its kernel and nowhere
else, so a run can show that the main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import threading
import time
from typing import Dict, List, Tuple

from .. import _build

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")

# --fmad=false: no contraction nvcc was not asked for (the burn predicate
# must round exactly as XLA:CPU does; see csrc/burn.cu). -Xptxas -v keeps
# registers, shared memory and spills in each library's build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
SOURCES: Dict[str, Tuple[str, Dict[str, Tuple[object, List[object]]]]] = {
    "masked_median": ("masked_median.cu", {
        "masked_median_max_scenes": (_I, []),
        "masked_median_launch": (_I, [_P, _I, _P, _P, _P, _I,
                                      ctypes.c_longlong, _I, _P]),
    }),
    "burn": ("burn.cu", {
        "burn_dense_launch": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                   ctypes.c_float, _I, _I, _I, _P, _P]),
        "burn_binned_launch": (_I, [_P, _P, _P, _P, _P, _I, _I, _P, _P,
                                    _I, _I, _I, ctypes.c_float, _I, _I,
                                    _I, _P, _P]),
    }),
}


class LaunchCounter:
    """Launches of one kernel: a plain integer, incremented under a lock
    (the export launches from several threads)."""

    def __init__(self, name: str, source: str, replaces: str):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.count = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self.count += 1

    def reset(self) -> None:
        with self._lock:
            self.count = 0


MASKED_MEDIAN = LaunchCounter(
    "masked_median", "dl_image_segmentation_tpu_torch/csrc/masked_median.cu",
    "dl_image_segmentation_tpu/ops/compositing.py:133")
BURN_DENSE = LaunchCounter(
    "burn_dense", "dl_image_segmentation_tpu_torch/csrc/burn.cu",
    "dl_image_segmentation_tpu/ops/rasterize.py:342")
BURN_BINNED = LaunchCounter(
    "burn_binned", "dl_image_segmentation_tpu_torch/csrc/burn.cu",
    "dl_image_segmentation_tpu/ops/rasterize.py:430")
COUNTERS = (MASKED_MEDIAN, BURN_DENSE, BURN_BINNED)


def nvcc() -> str:
    """Path of nvcc; raises where there is none (no CUDA toolkit)."""
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "on a machine with the CUDA toolkit")
    return path


@functools.lru_cache(maxsize=None)
def _cmd() -> Tuple[str, ...]:
    return (nvcc(), *NVCC_FLAGS)


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (a key of SOURCES), built from
    its source now if ``build/`` does not hold it yet."""
    src, signatures = SOURCES[name]
    return _build.load(_cmd(), os.path.join(CSRC, src), signatures)


def build_all() -> Dict[str, Tuple[float, str]]:
    """Build every kernel source at once, one nvcc each, started
    together. Returns {name: (seconds, compiler log)}; the log holds
    ptxas' registers, shared memory and spills per kernel."""
    cmd = _cmd()
    t0 = time.perf_counter()
    started = {}
    for name, (src, _) in SOURCES.items():
        path = os.path.join(CSRC, src)
        out = _build.output_path(path, cmd)
        if not os.path.exists(out):
            started[name] = _build.start(cmd, path)
    results = {}
    for name, (src, _) in SOURCES.items():
        if name in started:
            out = _build.finish(*started[name])
        else:
            out = _build.output_path(os.path.join(CSRC, src), cmd)
        with open(out + ".log") as f:
            results[name] = (time.perf_counter() - t0, f.read())
    return results


def check(rc: int, what: str) -> None:
    """Raise unless a launch function returned cudaSuccess."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{rc}")


def stream_ptr(device) -> int:
    """The current CUDA stream of ``device`` as an integer pointer."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream


__all__ = ["COUNTERS", "MASKED_MEDIAN", "BURN_DENSE", "BURN_BINNED",
           "LaunchCounter", "build_all", "check", "library", "nvcc",
           "stream_ptr"]
