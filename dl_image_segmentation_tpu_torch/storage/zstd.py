"""Zstandard frames for the orbax checkpoint reader and writer.

:func:`decompress` is the port's own zstd decoder (RFC 8878), the C++ of
``csrc/host/zstd.cc``, built with g++ into ``build/`` at first use and
called through ctypes: every OCDBT node, manifest and zarr chunk of an
orbax checkpoint is a zstd frame, and the card's machine has no
``zstandard``. There is no fallback: if the library does not build, the
call raises. :func:`compress_raw` writes one frame of Raw blocks (no
entropy coding), which every zstd decoder reads.
"""

from __future__ import annotations

import ctypes
import os

from .. import _build

__all__ = ["ZstdError", "compress_raw", "content_size", "decompress",
           "decompress_stream", "xxh64"]

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "host", "zstd.cc")
_CMD = ("g++", "-O2", "-shared", "-fPIC")
_SIGNATURES = {
    "zs_decompress": (ctypes.c_int64, [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint64,
        ctypes.c_char_p, ctypes.c_uint64]),
    "zs_decompress_stream": (ctypes.c_int64, [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint64,
        ctypes.c_char_p, ctypes.c_uint64]),
    "zs_content_size": (ctypes.c_int64, [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64]),
    "zs_raw_bound": (ctypes.c_uint64, [ctypes.c_uint64]),
    "zs_encode_raw": (ctypes.c_uint64, [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint64,
        ctypes.c_int]),
    "zs_xxh64": (ctypes.c_uint64, [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64]),
}


class ZstdError(ValueError):
    """A corrupt or unsupported zstd stream."""


def _lib():
    return _build.load(_CMD, _SRC, _SIGNATURES)


def content_size(data: bytes) -> int:
    """The total content size that the frames of ``data`` declare, or -1
    when a frame declares none. Raises ZstdError on corrupt frames."""
    data = bytes(data)
    err = ctypes.create_string_buffer(128)
    n = _lib().zs_content_size(data, len(data), err, len(err))
    if n == -2:
        raise ZstdError(f"corrupt zstd stream: {err.value.decode()}")
    return n


def decompress(data: bytes, max_size: int) -> bytes:
    """Decode every frame of ``data`` (skippable frames are skipped).

    ``max_size`` bounds the output: the caller knows how large the
    content may be (a zarr chunk's bytes, an OCDBT node's limit), and a
    corrupt header must not make this allocate more. Raises ZstdError on
    a corrupt stream, a checksum mismatch, a frame that needs a
    dictionary, or content larger than ``max_size``."""
    if max_size < 0:
        raise ValueError(f"max_size {max_size} is negative")
    data = bytes(data)
    lib = _lib()
    known = content_size(data)
    if known > max_size:
        raise ZstdError(f"zstd content of {known} bytes exceeds the "
                        f"{max_size} expected")
    cap = known if known >= 0 else min(max_size, max(4 * len(data), 1 << 16))
    err = ctypes.create_string_buffer(128)
    while True:
        buf = ctypes.create_string_buffer(max(cap, 1))
        n = lib.zs_decompress(data, len(data), buf, len(buf) if cap else 0,
                              err, len(err))
        if n >= 0:
            return buf.raw[:n]
        if n == -2 and known < 0 and cap < max_size:
            cap = min(max_size, cap * 2)
            continue
        if n == -2:
            raise ZstdError(
                f"zstd content exceeds the {known} bytes its frames declare"
                if known >= 0 else
                f"zstd content exceeds the {max_size} bytes expected")
        kind = "unsupported" if n == -3 else "corrupt"
        raise ZstdError(f"{kind} zstd stream: {err.value.decode()}")


def decompress_stream(data: bytes, size: int) -> bytes:
    """What libtiff's zstd codec reads into a ``size``-byte strip: libzstd's
    streaming decoder, called until the strip is full, the frame ends or
    the input runs out. A frame that declares a content size of at most
    ``size`` and lies whole in ``data`` is decoded and checked in one
    pass; any other block by block, up to the first block that overfills
    the strip, and nothing after it is read. Returns the bytes written
    (fewer than ``size`` where libtiff's read falls short); raises
    ZstdError where libzstd reports an error first."""
    data = bytes(data)
    buf = ctypes.create_string_buffer(max(size, 1))
    err = ctypes.create_string_buffer(128)
    n = _lib().zs_decompress_stream(data, len(data), buf, size, err, len(err))
    if n < 0:
        kind = "unsupported" if n == -3 else "corrupt"
        raise ZstdError(f"{kind} zstd stream: {err.value.decode()}")
    return buf.raw[:n]


def compress_raw(data: bytes, checksum: bool = True) -> bytes:
    """One zstd frame of Raw blocks holding ``data``, with its content
    size and (``checksum``) its XXH64 checksum."""
    data = bytes(data)
    lib = _lib()
    cap = lib.zs_raw_bound(len(data))
    buf = ctypes.create_string_buffer(cap)
    n = lib.zs_encode_raw(data, len(data), buf, cap, int(checksum))
    return buf.raw[:n]


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of ``data`` (the hash of zstd's frame checksum)."""
    data = bytes(data)
    return _lib().zs_xxh64(data, len(data), seed)
