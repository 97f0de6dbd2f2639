"""TIFF-variant LZW encoder for GeoTIFF chips.

The chip contract requires LZW-compressed GeoTIFFs
(dl_segmentation_utils/_descartes_img_chips.py:784: COMPRESS=LZW).
:func:`lzw_encode_native` is the encoder that writes chips: the C++ copy
in ``csrc/host/lzw.cc``, built with g++ into ``build/`` at first use and
called through ctypes. :func:`lzw_encode` is the pure-Python reference it
is tested against; it is far too slow for full-width chips, so the chip
writer never falls back to it.

TIFF LZW specifics (TIFF 6.0 spec + the universally-implemented
"early change" quirk): MSB-first bit packing, 9->12 bit codes,
ClearCode=256, EOI=257, code width bumps one code EARLY (when the next
code to assign equals 2^bits - 1), table reset after code 4093.
"""

from __future__ import annotations

import ctypes
import os
import threading

from .. import _build

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "host", "lzw.cc")
_CMD = ("g++", "-O3", "-shared", "-fPIC")
_SIGNATURES = {"fc_lzw_encode": (ctypes.c_uint64, [
    ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64])}
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
