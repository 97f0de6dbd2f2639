"""TIFF-variant LZW codec for GeoTIFF chips.

The chip contract requires LZW-compressed GeoTIFFs
(dl_segmentation_utils/_descartes_img_chips.py:784: COMPRESS=LZW).
:func:`lzw_encode_native` is the encoder that writes chips: the C++ copy
in ``csrc/host/lzw.cc``, built with g++ into ``build/`` at first use and
called through ctypes. :func:`lzw_encode` is the pure-Python reference it
is tested against; it is far too slow for full-width chips, so the chip
writer never falls back to it. :func:`lzw_decode_native` is the decoder
the GeoTIFF reader uses (request bodies of the server, chips read back
by stitch), from the same C++ source; :func:`lzw_decode` is its
pure-Python reference.

TIFF LZW specifics (TIFF 6.0 spec + the universally-implemented
"early change" quirk): MSB-first bit packing, 9->12 bit codes,
ClearCode=256, EOI=257, code width bumps one code EARLY (when the next
code to assign equals 2^bits - 1), table reset after code 4093.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

from .. import _build

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "host", "lzw.cc")
_CMD = ("g++", "-O3", "-shared", "-fPIC")
_SIGNATURES = {
    "fc_lzw_encode": (ctypes.c_uint64, [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64]),
    "fc_lzw_decode": (ctypes.c_uint64, [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64,
        ctypes.c_uint64]),
    "fc_gif_lzw_decode": (ctypes.c_int64, [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_uint64, ctypes.c_void_p]),
}
_scratch = threading.local()

_CLEAR = 256
_EOI = 257
_FIRST = 258
_MAX_BITS = 12
_RESET_AT = 4094  # emit Clear when next_code reaches this (early change incl.)


def lzw_encode(data: bytes) -> bytes:
    out = bytearray()
    bitbuf = 0
    bitcnt = 0

    def put(code: int, bits: int):
        nonlocal bitbuf, bitcnt
        bitbuf = (bitbuf << bits) | code
        bitcnt += bits
        while bitcnt >= 8:
            bitcnt -= 8
            out.append((bitbuf >> bitcnt) & 0xFF)

    table = {bytes([i]): i for i in range(256)}
    next_code = _FIRST
    bits = 9
    put(_CLEAR, bits)
    w = b""
    for ch in data:
        k = bytes([ch])
        wk = w + k
        if wk in table:
            w = wk
            continue
        put(table[w], bits)
        table[wk] = next_code
        next_code += 1
        w = k
        if next_code >= _RESET_AT:
            # table full: emit Clear, reset, keep current pending prefix
            put(_CLEAR, bits)
            table = {bytes([i]): i for i in range(256)}
            next_code = _FIRST
            bits = 9
        elif next_code == (1 << bits) and bits < _MAX_BITS:
            # encoder widens when the next code to assign overflows the
            # current width; because the decoder's table add lags the
            # encoder's by one code, its matching check is
            # len(table) == 2^bits - 1 (the TIFF "early change").
            # Both directions validated against libtiff/PIL streams.
            bits += 1
    if w:
        put(table[w], bits)
    put(_EOI, bits)
    if bitcnt:
        out.append((bitbuf << (8 - bitcnt)) & 0xFF)
    return bytes(out)


def lzw_encode_native(data: bytes) -> bytes:
    """LZW-encode ``data`` with the native encoder; same bytes as
    :func:`lzw_encode`. Raises if the encoder cannot be built."""
    lib = _build.load(_CMD, _SRC, _SIGNATURES)
    cap = len(data) + (len(data) >> 1) + 1024
    # 0 also signals table OOM inside the encoder: past 5x the input even
    # pathological LZW expansion (~1.5x) cannot be the cause
    limit = len(data) * 5 + (1 << 16)
    while True:
        # per-thread scratch, reused across chips
        buf = getattr(_scratch, "buf", None)
        if buf is None or len(buf) < cap:
            buf = bytearray(max(cap, 1 << 20))
            _scratch.buf = buf
        cbuf = (ctypes.c_char * len(buf)).from_buffer(buf)
        n = lib.fc_lzw_encode(data, len(data), cbuf, len(buf))
        del cbuf
        if n:
            return bytes(memoryview(buf)[:n])
        cap = len(buf) * 2
        if cap > limit:
            raise MemoryError(
                f"native LZW encoder failed on {len(data)} bytes")


def lzw_decode_native(data: bytes, max_size: Optional[int] = None) -> bytes:
    """LZW-decode ``data`` with the native decoder; same bytes as
    :func:`lzw_decode`. Raises ValueError on a corrupt stream."""
    if max_size == 0:
        return b""
    lib = _build.load(_CMD, _SRC, _SIGNATURES)
    stop_at = max_size or 0
    # with a stop point: room for it and one table string past it
    cap = (max_size + 4096 if max_size is not None
           else max(len(data) * 8, 1 << 16))
    while True:
        buf = ctypes.create_string_buffer(cap)
        n = lib.fc_lzw_decode(data, len(data), buf, cap, stop_at)
        if n == (1 << 64) - 1:
            raise ValueError("corrupt LZW stream")
        if n != (1 << 64) - 2:
            return buf.raw[:n]
        cap *= 2


def gif_lzw_decode_native(data: bytes, min_size: int, npix: int):
    """GIF's LZW variant (``csrc/host/lzw.cc:fc_gif_lzw_decode``): the
    indices of one image from its joined sub-blocks; (``npix`` uint8
    indices, 0 past the last decoded, the count decoded, whether an end
    code was read). Raises ValueError on a corrupt stream."""
    import numpy as np
    lib = _build.load(_CMD, _SRC, _SIGNATURES)
    out = np.zeros(npix, np.uint8)
    ended = ctypes.c_int(0)
    n = lib.fc_gif_lzw_decode(data, len(data), min_size, out.ctypes.data,
                              npix, ctypes.byref(ended))
    if n < 0:
        raise ValueError("corrupt GIF LZW stream")
    return out, n, bool(ended.value)


def lzw_decode(data: bytes, max_size: int | None = None) -> bytes:
    """LZW-decode ``data``; at most ``max_size`` bytes when it is given.
    Running out of input ends the stream as EOI does."""
    out = bytearray()
    pos = 0
    bitbuf = 0
    bitcnt = 0
    n = len(data)

    bits = 9

    def get() -> int:
        nonlocal pos, bitbuf, bitcnt
        while bitcnt < bits:
            if pos >= n:
                return _EOI
            bitbuf = (bitbuf << 8) | data[pos]
            pos += 1
            bitcnt += 8
        bitcnt -= bits
        code = (bitbuf >> bitcnt) & ((1 << bits) - 1)
        return code

    table: list[bytes] = []

    def reset():
        nonlocal table, bits
        table = [bytes([i]) for i in range(256)] + [b"", b""]
        bits = 9

    reset()
    old: bytes | None = None
    while True:
        code = get()
        if code == _EOI:
            break
        if code == _CLEAR:
            reset()
            code = get()
            if code == _EOI:
                break
            entry = table[code]
            out += entry
            old = entry
            continue
        if code < len(table):
            entry = table[code]
        elif code == len(table) and old is not None:
            entry = old + old[:1]
        else:
            raise ValueError(f"corrupt LZW stream (code {code})")
        out += entry
        if old is not None:
            table.append(old + entry[:1])
            # early change on decode: width grows when the NEXT entry
            # index would be 2^bits - 1
            if len(table) == (1 << bits) - 1 and bits < _MAX_BITS:
                bits += 1
        old = entry
        if max_size is not None and len(out) >= max_size:
            break
    if max_size is not None and len(out) > max_size:
        # exact cap, matching the native decoder's truncation -- the
        # two paths must return identical bytes for identical inputs
        return bytes(out[:max_size])
    return bytes(out)
