"""CRC32C (Castagnoli) and TFRecord's masked CRC.

Every TFRecord frame checksums its length and its payload with a masked
CRC32C. :func:`crc32c` is the pure-Python slicing-by-8 version, the
reference the native one is tested against; :func:`crc32c_native` is the
C++ copy in ``csrc/host/crc32c.cc``, built with g++ into ``build/`` at
first use and called through ctypes. The record writer and the CRC check
of the reader use the native one: the Python loop takes about 0.2 s for
one ~1 MB tifarr record.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from .. import _build

__all__ = ["crc32c", "crc32c_native", "masked_crc32c",
           "masked_crc32c_native", "mask"]

_POLY = 0x82F63B78  # reflected Castagnoli polynomial
_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "host", "crc32c.cc")
_CMD = ("g++", "-O3", "-shared", "-fPIC")
_SIGNATURES = {"fc_crc32c": (ctypes.c_uint32, [
    ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint32])}


def _build_tables():
    t = np.zeros((8, 256), dtype=np.uint64)
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (_POLY if crc & 1 else 0)
        t[0, i] = crc
    for k in range(1, 8):
        for i in range(256):
            prev = int(t[k - 1, i])
            t[k, i] = (prev >> 8) ^ int(t[0, prev & 0xFF])
    return [row.tolist() for row in t.astype(np.uint32)]


_T = _build_tables()


def crc32c(data, initial: int = 0) -> int:
    """CRC32C of bytes-like ``data``, table-driven slicing-by-8."""
    buf = np.frombuffer(memoryview(data), dtype=np.uint8)
    crc = (~initial) & 0xFFFFFFFF
    n = len(buf)
    head = n % 8
    t0 = _T[0]
    for i in range(head):
        crc = (crc >> 8) ^ t0[(crc ^ int(buf[i])) & 0xFF]
    if n - head:
        T = _T
        for row in buf[head:].reshape(-1, 8).tolist():
            crc ^= row[0] | (row[1] << 8) | (row[2] << 16) | (row[3] << 24)
            crc = (T[7][crc & 0xFF] ^ T[6][(crc >> 8) & 0xFF]
                   ^ T[5][(crc >> 16) & 0xFF] ^ T[4][(crc >> 24) & 0xFF]
                   ^ T[3][row[4]] ^ T[2][row[5]] ^ T[1][row[6]]
                   ^ T[0][row[7]])
    return (~crc) & 0xFFFFFFFF


def crc32c_native(data, initial: int = 0) -> int:
    """CRC32C of ``data`` by the C++ copy; the same value as
    :func:`crc32c`. Raises if g++ cannot build it."""
    lib = _build.load(_CMD, _SRC, _SIGNATURES)
    data = bytes(data) if not isinstance(data, bytes) else data
    return lib.fc_crc32c(data, len(data), initial)


def mask(crc: int) -> int:
    """TFRecord's mask: rotate right by 15 and add a constant."""
    return ((((crc >> 15) | (crc << 17)) & 0xFFFFFFFF)
            + 0xA282EAD8) & 0xFFFFFFFF


def masked_crc32c(data) -> int:
    return mask(crc32c(data))


def masked_crc32c_native(data) -> int:
    return mask(crc32c_native(data))
