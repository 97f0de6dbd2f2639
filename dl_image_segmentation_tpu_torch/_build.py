"""Build native sources into the checkout's ``build/`` directory at first
use and load them with ctypes.

Outputs are named by a hash of the source and the compiler command, so
an edited source or flag rebuilds and a stale library is never loaded.
Each build links to a pid-unique temporary file and is renamed into
place, so concurrent first uses from several processes cannot promote a
torn library."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, List, Sequence, Tuple

BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build")

_lock = threading.Lock()
_loaded: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}


def output_path(src: str, cmd: Sequence[str]) -> str:
    with open(src, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update("\0".join(cmd).encode())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:12]}.so")


def start(cmd: Sequence[str], src: str) -> Tuple[subprocess.Popen, str, str]:
    """Start ``cmd + [-o tmp, src]``; returns (process, tmp, final path).
    The compiler's stderr is kept beside the library as ``.log``."""
    out = output_path(src, cmd)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.Popen(list(cmd) + ["-o", tmp, src],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, tmp, out


def finish(proc: subprocess.Popen, tmp: str, out: str,
           timeout: float = 900) -> str:
    """Wait for a build started by :func:`start`; raise with the
    compiler's output if it failed."""
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise RuntimeError(f"build of {out} timed out after {timeout}s")
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"build of {out} failed "
                           f"(exit {proc.returncode}):\n{stdout}{stderr}")
    with open(out + ".log", "w") as f:
        f.write(stdout + stderr)
    os.replace(tmp, out)
    return out


def build(cmd: Sequence[str], src: str) -> str:
    """Path of the built library, building it now if it is missing."""
    out = output_path(src, cmd)
    if not os.path.exists(out):
        finish(*start(cmd, src))
    return out


def load(cmd: Sequence[str], src: str,
         signatures: Dict[str, Tuple[object, List[object]]]) -> ctypes.CDLL:
    """Build (if needed) and load ``src``, declaring ``restype`` and
    ``argtypes`` for each function in ``signatures``. Loaded once per
    process; later calls are a dictionary lookup, with no hashing of the
    source, because every kernel launch and chip write comes here."""
    key = (src, tuple(cmd))
    lib = _loaded.get(key)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(key)
        if lib is None:
            lib = ctypes.CDLL(build(cmd, src))
            for name, (restype, argtypes) in signatures.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _loaded[key] = lib
    return lib
