"""HDF5 / NetCDF-4 raster decoder: the port's own reader.

The JAX package reads these containers through h5py
(``raster/hdf5.py``); the port parses the HDF5 file format itself, on
``memoryview`` and ``struct``, as ``raster/hdf4.py`` does for HDF4, and
keeps the JAX module's names and selection rules:

* superblock versions 0-3, at 0 or after a userblock, every address
  read relative to the base address;
* object headers v1 and v2 with continuation blocks (``OCHK``); the
  Jenkins lookup3 checksums of version 2 structures are checked;
* groups: symbol tables (v1 B-tree type 0, local heap, ``SNOD``), compact
  link messages, and dense links (fractal heap, v2 B-trees types 5 and
  6); hard links and soft links (resolved along the path);
* datatypes: fixed-point, IEEE float (2, 4, 8 bytes), bitfields, enums
  (h5py's ``{FALSE, TRUE}`` enum reads as ``bool``), fixed and
  variable-length strings, committed types; compound, array, opaque,
  reference and vlen types are listed with their shapes and skipped as
  non-numeric;
* dataspaces scalar, simple and null; layout messages v1-v4, compact,
  contiguous and chunked, with the v1 B-tree, single chunk, implicit,
  fixed array, extensible array and v2 B-tree chunk indexes; partial
  edge chunks; unallocated chunks and datasets read as the fill value;
* filters deflate, shuffle, fletcher32 (verified), n-bit and
  scale-offset, and LZF and szip (``csrc/host/h5filters.cc``);
* attributes in compact (message versions 1-3) and dense storage (type 8
  v2 B-tree), converted as h5py converts them: fixed-length strings to
  ``np.bytes_``, variable-length strings to ``str``, numbers to numpy,
  ``DIMENSION_LIST`` resolved through the global heap (``GCOL``).

Refused before anything is read, in every context: external raw data
storage, virtual datasets and external links (each would read another
file), and shared object header messages (the SOHM table). They raise
:class:`HDF5Unsupported`, which names ROADMAP queue 1 item 14.

Work on hostile bytes is bounded: B-tree and fractal-heap depth,
continuation chains (cycles detected), soft-link hops, and a count of
structures visited per file. Sizes read from the file are checked before
anything is allocated for them: a raster side above 65,536; a dataset or
a chunk of more bytes than ``max(64 x file size, 256 MiB)``; an LZF size
parameter above the chunk's size; szip parameters outside libaec's
ranges; and an LZF or szip chunk larger than its stream can code.

Selection, CF georeferencing and the error texts are the JAX module's:
the default variable is the first, in h5py's ``visititems`` order, of
the numeric datasets of rank >= 2 with the most ``H*W`` pixels that are
not dimension scales; leading dimensions flatten into bands last.
"""

from __future__ import annotations

import ctypes
import math
import os
import posixpath
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import cf
from .geotiff import GeoTIFF, RasterInfo

__all__ = ["is_hdf5", "decode_hdf5", "sniff_hdf5_info", "hdf5_variables",
           "HDF5Unsupported", "MAX_SIDE"]

_HDF5_SIG = b"\x89HDF\r\n\x1a\n"

# the NITF and GeoPackage decoders' cap on a raster side
MAX_SIDE = 65536
_MAX_DEPTH = 64          # B-tree levels, fractal-heap indirection
_MAX_SOFT = 16           # soft-link hops in one lookup (HDF5's default)
_MAX_CHAIN = 4096        # object header blocks of one object


class HDF5Unsupported(ValueError):
    """A part of the HDF5 format that the port does not read."""


def _unsupported(what: str) -> HDF5Unsupported:
    return HDF5Unsupported(
        f"unsupported HDF5 feature: {what}. The port's reader does not "
        "read it yet (ROADMAP queue 1 item 14); convert the file (e.g. "
        "with h5repack or gdal_translate) first.")


def _refused(what: str) -> HDF5Unsupported:
    return HDF5Unsupported(
        f"HDF5 {what} refused: it reads data outside this input (ROADMAP "
        "queue 1 item 14)")


def _superblock_at(data) -> Optional[int]:
    """Where the superblock starts: at 0, or after a userblock of a
    power of two from 512 up to 65,536 bytes."""
    if bytes(data[:8]) == _HDF5_SIG:
        return 0
    off = 512
    while off + 8 <= len(data) and off <= 65536:
        if bytes(data[off:off + 8]) == _HDF5_SIG:
            return off
        off *= 2
    return None


def is_hdf5(data: bytes) -> bool:
    return _superblock_at(data) is not None


def _max_bytes(f: "_File") -> int:
    """The most bytes a dataset or a chunk of this file may declare."""
    return max(64 * f.n, 1 << 28)


# ---------------------------------------------------------------------------
# checksums
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _rot(x: int, k: int) -> int:
    return ((x << k) | (x >> (32 - k))) & _M32


def lookup3(data: bytes, initval: int = 0) -> int:
    """Bob Jenkins' lookup3 ``hashlittle``: HDF5's metadata checksum."""
    n = len(data)
    a = b = c = (0xDEADBEEF + n + initval) & _M32
    if n == 0:
        return c
    pad = (-n) % 12
    words = struct.unpack(f"<{(n + pad) // 4}I", bytes(data) + bytes(pad))
    last = len(words) - 3
    for i in range(0, last, 3):
        a = (a + words[i]) & _M32
        b = (b + words[i + 1]) & _M32
        c = (c + words[i + 2]) & _M32
        a = (a - c) & _M32; a ^= _rot(c, 4); c = (c + b) & _M32
        b = (b - a) & _M32; b ^= _rot(a, 6); a = (a + c) & _M32
        c = (c - b) & _M32; c ^= _rot(b, 8); b = (b + a) & _M32
        a = (a - c) & _M32; a ^= _rot(c, 16); c = (c + b) & _M32
        b = (b - a) & _M32; b ^= _rot(a, 19); a = (a + c) & _M32
        c = (c - b) & _M32; c ^= _rot(b, 4); b = (b + a) & _M32
    a = (a + words[last]) & _M32
    b = (b + words[last + 1]) & _M32
    c = (c + words[last + 2]) & _M32
    c ^= b; c = (c - _rot(b, 14)) & _M32
    a ^= c; a = (a - _rot(c, 11)) & _M32
    b ^= a; b = (b - _rot(a, 25)) & _M32
    c ^= b; c = (c - _rot(b, 16)) & _M32
    a ^= c; a = (a - _rot(c, 4)) & _M32
    b ^= a; b = (b - _rot(a, 14)) & _M32
    c ^= b; c = (c - _rot(b, 24)) & _M32
    return c


def _fold(s: int, positive: bool) -> int:
    # HDF5's Fletcher sums fold the carry back in: a positive sum ends in
    # 1..65535 (65535 for a multiple of 65535), a zero sum stays 0
    return ((s - 1) % 65535) + 1 if positive else 0


def fletcher32(data: bytes) -> int:
    """``H5_checksum_fletcher32`` over big-endian 16-bit words (an odd
    last byte is the high byte of a word)."""
    buf = bytes(data)
    if len(buf) % 2:
        buf += b"\0"
    w = np.frombuffer(buf, ">u2").astype(np.uint64)
    if w.size == 0:
        return 0
    positive = bool(w.any())
    s1 = int(w.sum() % 65535)
    weights = (np.arange(w.size, 0, -1, dtype=np.uint64) % 65535)
    s2 = int(((w % 65535) * weights).sum() % 65535)
    return (_fold(s2, positive) << 16) | _fold(s1, positive)


# ---------------------------------------------------------------------------
# the native filters
# ---------------------------------------------------------------------------

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "host", "h5filters.cc")
_CMD = ("g++", "-O3", "-shared", "-fPIC")
_SIGNATURES = {
    "h5_lzf_decompress": (ctypes.c_int64, [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint64]),
    "h5_szip_decompress": (ctypes.c_int64, [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint64,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32]),
}


def _filters_lib():
    from .. import _build
    return _build.load(_CMD, _SRC, _SIGNATURES)


def _lzf(raw: bytes, out_size: int) -> bytes:
    # a 3-byte back reference writes at most 264 bytes: no stream of
    # len(raw) bytes fills more than 88 times its length
    out_size = min(out_size, 88 * len(raw))
    out = ctypes.create_string_buffer(max(out_size, 1))
    n = _filters_lib().h5_lzf_decompress(raw, len(raw), out, out_size)
    if n < 0:
        raise ValueError("corrupt LZF chunk")
    return out.raw[:n]


def _szip(raw: bytes, size: int, vals: tuple) -> bytes:
    # HDF5 stores the decoded size ahead of the stream; cd_values are the
    # option mask, pixels per block, bits per pixel, pixels per scanline
    if len(vals) < 4 or len(raw) < 4:
        raise ValueError("HDF5 szip chunk or parameters are truncated")
    if int.from_bytes(raw[:4], "little") != size:
        raise ValueError("HDF5 szip chunk of another size")
    # the densest code: 64 zero blocks of 64 samples of 4 bytes in 9 bits
    if size > 4 * 4096 * ((len(raw) - 4) * 8 // 9 + 1):
        raise ValueError("HDF5 szip chunk larger than its stream can code")
    _mask, ppb, bpp, scanline = vals[:4]
    # libaec's ranges: a scanline of at least one block (as HDF5 sets
    # it), and at most 4,096 blocks to a reference sample interval (CCSDS
    # 121.0-B), which bound the decoder's own buffers
    if not (0 < ppb <= 64 and ppb % 2 == 0 and bpp in (*range(1, 33), 64)
            and ppb <= scanline and -(-scanline // ppb) <= 4096):
        raise ValueError("HDF5 szip parameters are out of range")
    out = ctypes.create_string_buffer(max(size, 1))
    n = _filters_lib().h5_szip_decompress(raw[4:], len(raw) - 4, out, size,
                                          *[v & 0xFFFFFFFF for v in vals[:4]])
    if n != size:
        raise ValueError("corrupt szip chunk")
    return out.raw[:size]


# ---------------------------------------------------------------------------
# the file
# ---------------------------------------------------------------------------

class _Cur:
    """A bounded little-endian cursor over the file's bytes."""

    __slots__ = ("f", "p", "end")

    def __init__(self, f: "_File", pos: int, end: int):
        if pos < 0 or end > f.n or pos > end:
            raise ValueError(f"HDF5 structure at {pos} lies outside the "
                             f"file ({f.n} bytes)")
        self.f, self.p, self.end = f, pos, end

    def u(self, n: int) -> int:
        p = self.p
        if p + n > self.end:
            raise ValueError("HDF5 structure is truncated")
        self.p = p + n
        return int.from_bytes(self.f.data[p:p + n], "little")

    def addr(self) -> Optional[int]:
        return self.f.addr(self.u(self.f.so))

    def length(self) -> int:
        return self.u(self.f.sl)

    def raw(self, n: int) -> bytes:
        p = self.p
        if n < 0 or p + n > self.end:
            raise ValueError("HDF5 structure is truncated")
        self.p = p + n
        return bytes(self.f.data[p:p + n])

    def skip(self, n: int) -> None:
        if n < 0 or self.p + n > self.end:
            raise ValueError("HDF5 structure is truncated")
        self.p += n

    def sig(self, want: bytes) -> None:
        got = self.raw(4)
        if got != want:
            raise ValueError(f"HDF5 {want.decode()} signature expected at "
                             f"{self.p - 4}, found {got!r}")


class _Bytes:
    """Bytes that structures are parsed from: the file itself, or a heap
    object or attribute message; addresses always name the file."""

    def cur(self, pos: int, size: Optional[int] = None) -> _Cur:
        end = self.n if size is None else pos + size
        return _Cur(self, pos, end)


class _BytesFile(_Bytes):
    def __init__(self, raw: bytes, f: "_File"):
        self.data = raw
        self.n = len(raw)
        self.so, self.sl = f.so, f.sl
        self.file = f

    def addr(self, v: int) -> Optional[int]:
        return self.file.addr(v)


class _File(_Bytes):
    def __init__(self, data):
        self.data = memoryview(data).cast("B") if not isinstance(
            data, bytes) else data
        self.n = len(self.data)
        self.steps = 0
        self.max_steps = 200_000 + self.n // 4
        self.headers: Dict[int, "_Header"] = {}
        self.links_cache: Dict[int, "_Links"] = {}
        sb = _superblock_at(self.data)
        if sb is None:
            raise ValueError("no HDF5 superblock signature")
        self._superblock(sb)

    # -- bookkeeping ------------------------------------------------------
    def step(self, n: int = 1) -> None:
        self.steps += n
        if self.steps > self.max_steps:
            raise ValueError("HDF5 metadata visits exceed the bound for a "
                             f"file of {self.n} bytes (cyclic or hostile "
                             "structure)")

    def addr(self, v: int) -> Optional[int]:
        if v == self.undef:
            return None
        a = self.base + v
        if a >= self.n:
            raise ValueError(f"HDF5 address {v} lies past the end of the "
                             f"file ({self.n} bytes)")
        return a

    def check(self, pos: int, size: int, what: str) -> None:
        """Verify the lookup3 checksum stored after ``size`` bytes."""
        c = self.cur(pos, size + 4)
        body = c.raw(size)
        stored = c.u(4)
        if lookup3(body) != stored:
            raise ValueError(f"HDF5 {what} checksum mismatch at {pos}")

    # -- superblock -------------------------------------------------------
    def _superblock(self, sb: int) -> None:
        c = _Cur(self, sb, self.n)
        c.skip(8)
        ver = c.u(1)
        if ver in (0, 1):
            c.skip(3)                    # free space, root stab, reserved
            shared_ver = c.u(1)
            self.so, self.sl = c.u(1), c.u(1)
            self._sizes()
            c.skip(1)
            c.skip(4)                    # group leaf / internal K
            c.skip(4)                    # consistency flags
            if ver == 1:
                c.skip(4)                # indexed storage K, reserved
            base = c.u(self.so)
            self.base = 0
            self.undef = (1 << (8 * self.so)) - 1
            c.u(self.so)                 # free-space info address
            eof = c.u(self.so)
            c.u(self.so)                 # driver info
            c.u(self.so)                 # root entry: link name offset
            root = c.u(self.so)
            del shared_ver
        elif ver in (2, 3):
            self.so, self.sl = c.u(1), c.u(1)
            self._sizes()
            c.skip(1)                    # consistency flags
            base = c.u(self.so)
            self.base = 0
            self.undef = (1 << (8 * self.so)) - 1
            ext = c.u(self.so)
            eof = c.u(self.so)
            root = c.u(self.so)
            self.check(sb, c.p - sb, "superblock")
        else:
            raise ValueError(f"HDF5 superblock version {ver} is not defined")
        if base == self.undef or base > self.n:
            raise ValueError(f"HDF5 base address {base} lies outside the "
                             "file")
        self.base = base
        if eof != self.undef and eof > self.n:
            # libhdf5 refuses a file shorter than its stored end of file
            raise ValueError(f"truncated file: eof = {self.n - base}, "
                             f"sblock->base_addr = {base}, stored_eof = "
                             f"{eof}")
        if ver in (2, 3) and ext != self.undef:
            # the superblock extension: a shared-message table means that
            # messages may live in the SOHM heap
            hdr = self.header(self.addr(ext))
            if hdr.first(0x000F) is not None:
                raise _unsupported("shared object header messages (SOHM)")
        self.root_addr = self.addr(root)
        if self.root_addr is None:
            raise ValueError("HDF5 file has no root group")

    def _sizes(self) -> None:
        if self.so not in (2, 4, 8) or self.sl not in (2, 4, 8):
            raise ValueError(f"HDF5 offset/length sizes {self.so}/{self.sl} "
                             "are not 2, 4 or 8")

    # -- object headers ---------------------------------------------------
    def header(self, addr: Optional[int]) -> "_Header":
        if addr is None:
            raise ValueError("HDF5 object at an undefined address")
        h = self.headers.get(addr)
        if h is None:
            h = _Header(self, addr)
            self.headers[addr] = h
        return h

    def node(self, addr: int, name: str) -> "_Node":
        hdr = self.header(addr)
        if hdr.first(0x0008) is not None:
            return _Dataset(self, addr, name)
        if (hdr.first(0x0011) is not None or hdr.first(0x0002) is not None
                or hdr.first(0x0006) is not None):
            return _Group(self, addr, name)
        if hdr.first(0x0003) is not None:
            return _Datatype(self, addr, name)
        if addr == self.root_addr:
            return _Group(self, addr, name)
        raise ValueError(f"HDF5 object {name!r} is of no known type")

    @property
    def root(self) -> "_Group":
        return _Group(self, self.root_addr, "/")


class _Header:
    """The messages of one object header: [(type, flags, pos, size)]."""

    def __init__(self, f: _File, addr: int):
        self.f = f
        self.addr = addr
        self.messages: List[Tuple[int, int, int, int]] = []
        self.attr_table: Optional[Dict[str, tuple]] = None
        self.meta = None              # a dataset's (type, shape, maxshape)
        f.step()
        if bytes(f.data[addr:addr + 4]) == b"OHDR":
            self._v2(addr)
        else:
            self._v1(addr)

    def _v1(self, addr: int) -> None:
        f = self.f
        c = f.cur(addr, 16)
        if c.u(1) != 1:
            raise ValueError(f"HDF5 object header at {addr}: version "
                             f"{f.data[addr] if addr < f.n else None} is "
                             "not 1 or 2")
        c.skip(1)
        c.skip(6)                               # message and reference counts
        size = c.u(4)
        blocks = [(addr + 16, size)]
        seen = set()
        while blocks:
            pos, size = blocks.pop(0)
            if (pos, size) in seen or len(seen) >= _MAX_CHAIN:
                raise ValueError("HDF5 object header continuation cycle")
            seen.add((pos, size))
            f.step()
            c = f.cur(pos, size)
            while c.end - c.p >= 8:
                mtype, msize, flags = c.u(2), c.u(2), c.u(1)
                c.skip(3)
                mpos = c.p
                c.skip(msize)
                blocks.extend(self._add(mtype, flags, mpos, msize))

    def _v2(self, addr: int) -> None:
        f = self.f
        c = f.cur(addr)
        c.skip(4)
        if c.u(1) != 2:
            raise ValueError(f"HDF5 object header at {addr}: OHDR version "
                             "is not 2")
        flags = c.u(1)
        if flags & 0x20:
            c.skip(16)                          # times
        if flags & 0x10:
            c.skip(4)                           # attribute phase change
        size = c.u(1 << (flags & 3))
        self.crt_order = bool(flags & 0x04)
        start = c.p
        f.check(addr, start - addr + size, "object header")
        blocks = self._v2_messages(start, size)
        seen = set()
        while blocks:
            pos, size = blocks.pop(0)
            if (pos, size) in seen or len(seen) >= _MAX_CHAIN:
                raise ValueError("HDF5 object header continuation cycle")
            seen.add((pos, size))
            f.step()
            c = f.cur(pos, size)
            c.sig(b"OCHK")
            f.check(pos, size - 4, "object header continuation")
            blocks.extend(self._v2_messages(pos + 4, size - 8))

    def _v2_messages(self, pos: int, size: int):
        c = self.f.cur(pos, size)
        hsize = 6 if self.crt_order else 4
        more = []
        while c.end - c.p >= hsize:
            mtype, msize, flags = c.u(1), c.u(2), c.u(1)
            if self.crt_order:
                c.skip(2)
            mpos = c.p
            c.skip(msize)
            more.extend(self._add(mtype, flags, mpos, msize))
        return more

    def _add(self, mtype: int, flags: int, pos: int, size: int):
        f = self.f
        if mtype == 0x0010:                     # continuation
            c = f.cur(pos, size)
            where, length = c.addr(), c.length()
            if where is None or length <= 0 or where + length > f.n:
                raise ValueError("HDF5 continuation block lies outside "
                                 "the file")
            return [(where, length)]
        if mtype > 0x0018 and flags & 0x80:
            raise _unsupported(f"object header message type {mtype}")
        self.messages.append((mtype, flags, pos, size))
        return []

    def first(self, mtype: int):
        for m in self.messages:
            if m[0] == mtype:
                return m
        return None

    def all(self, mtype: int):
        return [m for m in self.messages if m[0] == mtype]

    def message(self, mtype: int):
        """(pos, size) of the first message of ``mtype``, resolving a
        message shared in another object's header; None if absent."""
        m = self.first(mtype)
        if m is None:
            return None
        return self.f_shared(m)

    def f_shared(self, m):
        mtype, flags, pos, size = m
        if not flags & 0x02:
            return pos, size
        other = _shared_target(self.f, pos, size)
        hdr = self.f.header(other)
        if hdr is self:
            raise ValueError("HDF5 shared message refers to its own object")
        got = hdr.first(mtype)
        if got is None:
            raise ValueError(f"HDF5 shared message type {mtype} not found "
                             "in the object it names")
        if got[1] & 0x02:
            raise ValueError("HDF5 shared message chain")
        return got[2], got[3]


def _shared_target(f: _File, pos: int, size: int) -> int:
    """Object header address named by a shared message reference."""
    c = f.cur(pos, size)
    ver, kind = c.u(1), c.u(1)
    if ver == 1:
        c.skip(6)
        where = c.addr()
    elif ver == 2:
        where = c.addr()
    elif ver == 3:
        if kind == 1:
            raise _unsupported("shared object header messages (SOHM)")
        where = c.addr()
    else:
        raise ValueError(f"HDF5 shared message version {ver}")
    if where is None:
        raise ValueError("HDF5 shared message at an undefined address")
    return where


# ---------------------------------------------------------------------------
# datatypes and dataspaces
# ---------------------------------------------------------------------------

class _Type:
    """A datatype: ``cls`` (HDF5 class), ``size``, ``dtype`` (h5py's numpy
    dtype, or None where the port does not read the values), and the
    conversion details."""

    __slots__ = ("cls", "size", "dtype", "order", "signed", "prec", "off",
                 "pad", "base", "vlen_str", "enum", "is_bool")

    def __init__(self):
        self.dtype = None
        self.order = "<"
        self.signed = False
        self.prec = self.off = 0
        self.pad = 0
        self.base = None
        self.vlen_str = False
        self.enum = None
        self.is_bool = False

    @property
    def numeric(self) -> bool:
        return self.dtype is not None and self.dtype.kind in "iufb"


def _datatype(f: _File, pos: int, size: int, depth: int = 0) -> _Type:
    if depth > 16:
        raise ValueError("HDF5 datatype nests too deeply")
    c = f.cur(pos, size)
    t = _Type()
    cv = c.u(1)
    t.cls, ver = cv & 0x0F, cv >> 4
    bits = c.u(3)
    t.size = c.u(4)
    if t.size == 0 and t.cls != 9:
        raise ValueError("HDF5 datatype of size 0")
    if t.cls in (0, 4):                          # fixed-point, bitfield
        t.order = ">" if bits & 1 else "<"
        t.signed = bool(bits & 0x08) and t.cls == 0
        t.off, t.prec = c.u(2), c.u(2)
        if t.size in (1, 2, 4, 8):
            t.dtype = np.dtype(f"{t.order}{'i' if t.signed else 'u'}"
                               f"{t.size}")
    elif t.cls == 1:                             # IEEE float
        if bits & 0x40:
            raise _unsupported("VAX-order floating point")
        t.order = ">" if bits & 1 else "<"
        t.off, t.prec = c.u(2), c.u(2)
        eloc, esize, mloc, msize = c.u(1), c.u(1), c.u(1), c.u(1)
        bias = c.u(4)
        std = {2: (0, 16, 10, 5, 0, 10, 15),
               4: (0, 32, 23, 8, 0, 23, 127),
               8: (0, 64, 52, 11, 0, 52, 1023)}.get(t.size)
        if std is not None:
            t.dtype = np.dtype(f"{t.order}f{t.size}")
            if (t.off, t.prec, eloc, esize, mloc, msize, bias) != std:
                t.dtype = None  # a custom layout: not read
    elif t.cls == 3:                             # fixed-length string
        t.pad = bits & 0x0F
        t.dtype = np.dtype(f"S{t.size}")
    elif t.cls == 9:                             # variable-length
        t.vlen_str = (bits & 0x0F) == 1
        t.base = _datatype(f, c.p, c.end - c.p, depth + 1)
        t.dtype = np.dtype(object)
    elif t.cls == 7:                             # reference
        t.dtype = np.dtype(object)
    elif t.cls == 8:                             # enum
        t.base = _datatype(f, c.p, c.end - c.p, depth + 1)
        c.p += _datatype_size(f, c.p, c.end - c.p)
        n = bits & 0xFFFF
        names = []
        for _ in range(n):
            start = c.p
            while c.u(1) != 0:
                pass
            names.append(bytes(f.data[start:c.p - 1]))
            if ver < 3:
                c.skip((-(c.p - start)) % 8)
        bsize = t.base.size
        vals = []
        for _ in range(n):
            vals.append(c.raw(bsize))
        if t.base.dtype is not None and t.base.dtype.kind in "iu":
            ints = [int(np.frombuffer(v, t.base.dtype)[0]) for v in vals]
            t.enum = dict(zip(names, ints))
            t.order = t.base.order
            if t.enum == {b"FALSE": 0, b"TRUE": 1}:
                t.is_bool = True
                t.dtype = np.dtype(bool)
            else:
                t.dtype = t.base.dtype
    elif t.cls == 10:                            # array
        if ver < 3:
            nd = c.u(1)
            c.skip(3)
            c.skip(4 * nd)
            c.skip(4 * nd)
        else:
            nd = c.u(1)
            c.skip(4 * nd)
        t.dtype = np.dtype("V")
    elif t.cls in (5, 6):                        # opaque, compound
        t.dtype = np.dtype(f"V{t.size}")
    elif t.cls == 2:                             # time: h5py reads none
        t.dtype = None
    else:
        raise ValueError(f"HDF5 datatype class {t.cls} is not defined")
    return t


def _datatype_size(f: _File, pos: int, size: int) -> int:
    """Encoded length of the datatype message at ``pos`` (for an enum's
    base type, which is followed by the names)."""
    c = f.cur(pos, size)
    cv = c.u(1)
    cls = cv & 0x0F
    c.skip(3)
    c.u(4)
    if cls in (0, 4):
        return 12
    if cls == 1:
        return 20
    raise ValueError(f"HDF5 enum base type of class {cls}")


def _dataspace(f: _File, pos: int, size: int):
    """(shape or None for a null dataspace, maxshape)."""
    c = f.cur(pos, size)
    ver, rank, flags = c.u(1), c.u(1), c.u(1)
    if ver == 1:
        c.skip(5)
        kind = 1 if rank else 0
    elif ver == 2:
        kind = c.u(1)
    else:
        raise ValueError(f"HDF5 dataspace version {ver}")
    if rank > 32:
        raise ValueError(f"HDF5 dataspace of rank {rank}")
    dims = tuple(c.length() for _ in range(rank))
    maxd = tuple(c.length() for _ in range(rank)) if flags & 1 else dims
    if kind == 2:
        return None, None
    if kind == 0:
        return (), ()
    if kind != 1:
        raise ValueError(f"HDF5 dataspace type {kind}")
    return dims, maxd


def _npcount(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


# ---------------------------------------------------------------------------
# heaps and B-trees
# ---------------------------------------------------------------------------

def _local_heap(f: _File, addr: int) -> Tuple[int, int]:
    """(data segment address, size) of a local heap."""
    c = f.cur(addr)
    c.sig(b"HEAP")
    c.skip(4)
    size = c.length()
    c.length()
    where = c.addr()
    if where is None or where + size > f.n:
        raise ValueError("HDF5 local heap lies outside the file")
    return where, size


def _heap_string(f: _File, heap: Tuple[int, int], off: int) -> bytes:
    where, size = heap
    if off >= size:
        raise ValueError("HDF5 local heap offset out of range")
    end = bytes(f.data[where + off:where + size]).find(b"\0")
    if end < 0:
        raise ValueError("HDF5 local heap string is not terminated")
    return bytes(f.data[where + off:where + off + end])


def _btree1(f: _File, addr: int, ntype: int, nkey_bytes: int):
    """Children of a v1 B-tree of node type ``ntype``, in key order, as
    (left key bytes, child address) at level 0."""
    out = []
    seen = set()

    def walk(a: int, depth: int, want_level: Optional[int]):
        if a in seen or depth > _MAX_DEPTH:
            raise ValueError("HDF5 v1 B-tree cycle or depth")
        seen.add(a)
        f.step()
        c = f.cur(a)
        c.sig(b"TREE")
        if c.u(1) != ntype:
            raise ValueError("HDF5 v1 B-tree node of another type")
        level = c.u(1)
        if want_level is not None and level != want_level:
            raise ValueError("HDF5 v1 B-tree levels are inconsistent")
        used = c.u(2)
        c.addr()
        c.addr()
        for _ in range(used):
            key = c.raw(nkey_bytes)
            child = c.addr()
            if child is None:
                raise ValueError("HDF5 v1 B-tree child is undefined")
            if level:
                walk(child, depth + 1, level - 1)
            else:
                out.append((key, child))
        c.raw(nkey_bytes)
    walk(addr, 0, None)
    return out


def _btree2(f: _File, addr: int):
    """(type, records) of a v2 B-tree, records as bytes in key order."""
    c = f.cur(addr)
    c.sig(b"BTHD")
    c.u(1)
    btype = c.u(1)
    node_size, rec_size, depth = c.u(4), c.u(2), c.u(2)
    c.skip(2)
    root = c.addr()
    nroot = c.u(2)
    total = c.length()
    f.check(addr, c.p - addr, "v2 B-tree header")
    if depth > _MAX_DEPTH or rec_size == 0 or node_size < 16:
        raise ValueError("HDF5 v2 B-tree header is out of range")
    if root is None or total == 0:
        return btype, []
    if total > f.n:
        raise ValueError("HDF5 v2 B-tree holds more records than the file "
                         "has bytes")
    # sizes of the per-child record counts (H5B2__hdr_init)
    so = f.so
    max_nrec = [(node_size - 10) // rec_size]
    cum = [max_nrec[0]]
    cum_size = [0]

    def enc(v: int) -> int:
        return (v.bit_length() - 1) // 8 + 1 if v > 0 else 1
    nrec_size = enc(max_nrec[0])
    for d in range(1, depth + 1):
        ptr = so + nrec_size + (cum_size[d - 1] if d > 1 else 0)
        m = (node_size - (10 + ptr)) // (rec_size + ptr)
        if m <= 0:
            raise ValueError("HDF5 v2 B-tree nodes hold no records")
        max_nrec.append(m)
        cum.append((m + 1) * cum[d - 1] + m)
        cum_size.append(enc(cum[d]))
    out: List[bytes] = []
    seen = set()

    def walk(a: int, nrec: int, d: int):
        if a in seen:
            raise ValueError("HDF5 v2 B-tree cycle")
        seen.add(a)
        f.step()
        if nrec > max_nrec[d]:
            raise ValueError("HDF5 v2 B-tree node overfull")
        c = f.cur(a, node_size)
        c.sig(b"BTIN" if d else b"BTLF")
        c.u(1)
        if c.u(1) != btype:
            raise ValueError("HDF5 v2 B-tree node of another type")
        recs = [c.raw(rec_size) for _ in range(nrec)]
        if d == 0:
            f.check(a, c.p - a, "v2 B-tree leaf")
            out.extend(recs)
            return
        kids = []
        for _ in range(nrec + 1):
            child = c.addr()
            n = c.u(nrec_size)
            if d > 1:
                c.u(cum_size[d - 1])
            if child is None:
                raise ValueError("HDF5 v2 B-tree child is undefined")
            kids.append((child, n))
        f.check(a, c.p - a, "v2 B-tree internal node")
        for i, (child, n) in enumerate(kids):
            walk(child, n, d - 1)
            if i < nrec:
                out.append(recs[i])
    walk(root, nroot, depth)
    return btype, out


class _FractalHeap:
    def __init__(self, f: _File, addr: int):
        self.f = f
        c = f.cur(addr)
        c.sig(b"FRHP")
        c.u(1)
        self.id_len = c.u(2)
        filt_len = c.u(2)
        self.flags = c.u(1)
        self.max_man = c.u(4)
        c.length()
        c.addr()                     # huge objects' B-tree
        c.length()
        c.addr()                     # free-space manager
        for _ in range(8):
            c.length()
        self.width = c.u(2)
        self.start = c.length()
        self.max_direct = c.length()
        self.max_heap_bits = c.u(2)
        c.u(2)                       # starting rows of the root block
        self.root = c.addr()
        self.root_rows = c.u(2)
        if filt_len:
            raise _unsupported("filtered fractal heap")
        f.check(addr, c.p - addr, "fractal heap header")
        if (self.width == 0 or self.width & (self.width - 1)
                or self.start == 0 or self.start & (self.start - 1)
                or self.max_direct < self.start
                or self.max_direct & (self.max_direct - 1)
                or not 0 < self.max_heap_bits <= 64):
            raise ValueError("HDF5 fractal heap doubling table is out of "
                             "range")
        self.off_size = (self.max_heap_bits + 7) // 8
        dir_bits = self.max_direct.bit_length() - 1
        self.len_size = min((dir_bits + 7) // 8,
                            (self.max_man.bit_length() - 1) // 8 + 1
                            if self.max_man else 1)
        self.max_direct_rows = dir_bits - (self.start.bit_length() - 1) + 2
        self.first_row_bits = ((self.start.bit_length() - 1)
                               + (self.width.bit_length() - 1))

    def row_size(self, r: int) -> int:
        return self.start if r == 0 else self.start << (r - 1)

    def row_start(self, r: int) -> int:
        return 0 if r == 0 else self.width * self.start << (r - 1)

    def get(self, hid: bytes) -> bytes:
        if len(hid) < 1:
            raise ValueError("HDF5 fractal heap ID is empty")
        kind = (hid[0] >> 4) & 3
        if hid[0] & 0xC0:
            raise ValueError("HDF5 fractal heap ID version")
        if kind == 2:                                  # tiny
            n = (hid[0] & 0x0F) + 1
            if self.id_len > 18:
                raise _unsupported("extended tiny fractal heap objects")
            if 1 + n > len(hid):
                raise ValueError("HDF5 tiny heap object overruns its ID")
            return bytes(hid[1:1 + n])
        if kind != 0:
            raise _unsupported("huge fractal heap objects")
        off = int.from_bytes(hid[1:1 + self.off_size], "little")
        n = int.from_bytes(hid[1 + self.off_size:
                               1 + self.off_size + self.len_size], "little")
        if self.root is None:
            raise ValueError("HDF5 fractal heap has no root block")
        if self.root_rows == 0:
            return self._direct(self.root, 0, self.start, off, n)
        return self._indirect(self.root, 0, self.root_rows, off, n, 0)

    def _direct(self, addr, block_off, size, off, n) -> bytes:
        f = self.f
        f.step()
        c = f.cur(addr, size)
        c.sig(b"FHDB")
        c.u(1)
        c.addr()
        if c.u(self.off_size) != block_off:
            raise ValueError("HDF5 fractal heap direct block offset")
        if self.flags & 0x02:
            at = c.p
            stored = c.u(4)
            image = bytearray(f.data[addr:addr + size])
            image[at - addr:at - addr + 4] = b"\0\0\0\0"
            if lookup3(bytes(image)) != stored:
                raise ValueError("HDF5 fractal heap direct block checksum "
                                 "mismatch")
        rel = off - block_off
        if rel < c.p - addr or rel + n > size:
            raise ValueError("HDF5 fractal heap object lies outside its "
                             "block")
        return bytes(f.data[addr + rel:addr + rel + n])

    def _indirect(self, addr, block_off, nrows, off, n, depth) -> bytes:
        f = self.f
        if depth > _MAX_DEPTH or nrows > 64:
            raise ValueError("HDF5 fractal heap is too deep")
        f.step()
        c = f.cur(addr)
        c.sig(b"FHIB")
        c.u(1)
        c.addr()
        if c.u(self.off_size) != block_off:
            raise ValueError("HDF5 fractal heap indirect block offset")
        entries = []
        for r in range(nrows):
            for col in range(self.width):
                entries.append((r, col, c.addr()))
        f.check(addr, c.p - addr, "fractal heap indirect block")
        for r, col, child in entries:
            size = self.row_size(r)
            start = block_off + self.row_start(r) + col * size
            if not start <= off < start + size:
                continue
            if child is None:
                raise ValueError("HDF5 fractal heap object in an "
                                 "unallocated block")
            if r < self.max_direct_rows:
                return self._direct(child, start, size, off, n)
            rows = (size.bit_length() - 1) - self.first_row_bits + 1
            return self._indirect(child, start, rows, off, n, depth + 1)
        raise ValueError("HDF5 fractal heap offset out of range")


def _global_heap(f: _File, addr: int, index: int) -> bytes:
    c = f.cur(addr)
    c.sig(b"GCOL")
    c.skip(4)
    size = c.length()
    if size < 16 or addr + size > f.n:
        raise ValueError("HDF5 global heap collection lies outside the file")
    c = f.cur(c.p, size - (c.p - addr))
    while c.end - c.p >= 8 + f.sl:
        f.step()
        idx = c.u(2)
        c.skip(6)
        n = c.length()
        if idx == 0:
            break
        if idx == index:
            return c.raw(n)
        c.skip(n + (-n) % 8)
    raise ValueError(f"HDF5 global heap object {index} not found")


# ---------------------------------------------------------------------------
# links
# ---------------------------------------------------------------------------

class _Links:
    """A group's links: name -> ("hard", addr) | ("soft", path) |
    ("external", None); ``order`` is ``Group.items()``' order."""

    def __init__(self, names: Dict[str, tuple], order: List[str]):
        self.map = names
        self.order = order


def _link_message(f: _File, raw: bytes):
    """(name, link, creation order) of an encoded link message."""
    c = _Cur(_BytesFile(raw, f), 0, len(raw))
    if c.u(1) != 1:
        raise ValueError("HDF5 link message version")
    flags = c.u(1)
    ltype = c.u(1) if flags & 0x08 else 0
    crt = c.u(8) if flags & 0x04 else None
    if flags & 0x10:
        c.u(1)
    nlen = c.u(1 << (flags & 3))
    name = c.raw(nlen).decode("utf-8", "replace")
    if ltype == 0:
        link = ("hard", f.addr(c.u(f.so)))
    elif ltype == 1:
        n = c.u(2)
        link = ("soft", c.raw(n).decode("utf-8", "replace"))
    elif ltype == 64:
        link = ("external", None)
    else:
        link = ("user", None)
    return name, link, crt


def _group_links(f: _File, g: "_Group") -> _Links:
    cached = f.links_cache.get(g.addr)
    if cached is not None:
        return cached
    hdr = g.header
    names: Dict[str, tuple] = {}
    crt: Dict[str, int] = {}
    tracked = False
    stab = hdr.message(0x0011)
    if stab is not None:
        c = f.cur(*stab)
        bt, hp = c.addr(), c.addr()
        if bt is None or hp is None:
            raise ValueError("HDF5 symbol table is undefined")
        heap = _local_heap(f, hp)
        for _, snod in _btree1(f, bt, 0, f.sl):
            f.step()
            c = f.cur(snod)
            c.sig(b"SNOD")
            c.skip(2)
            nsym = c.u(2)
            for _ in range(nsym):
                name_off = c.u(f.so)
                obj = c.addr()
                cache = c.u(4)
                c.skip(4)
                scratch = c.raw(16)
                name = _heap_string(f, heap, name_off).decode(
                    "utf-8", "replace")
                if cache == 2:
                    off = int.from_bytes(scratch[:4], "little")
                    names[name] = ("soft", _heap_string(
                        f, heap, off).decode("utf-8", "replace"))
                else:
                    names[name] = ("hard", obj)
    else:
        info = hdr.message(0x0002)
        heap_addr = name_bt = None
        if info is not None:
            c = f.cur(*info)
            c.u(1)
            flags = c.u(1)
            tracked = bool(flags & 1)
            if flags & 1:
                c.u(8)
            heap_addr, name_bt = c.addr(), c.addr()
        for m in hdr.all(0x0006):
            pos, size = hdr.f_shared(m)
            name, link, order = _link_message(f, bytes(f.data[pos:pos + size]))
            names[name] = link
            crt[name] = order if order is not None else 0
        if heap_addr is not None and name_bt is not None:
            heap = _FractalHeap(f, heap_addr)
            btype, recs = _btree2(f, name_bt)
            if btype != 5:
                raise ValueError("HDF5 link name index is not a type 5 "
                                 "B-tree")
            for rec in recs:
                raw = heap.get(rec[4:4 + 7])
                name, link, order = _link_message(f, raw)
                names[name] = link
                crt[name] = order if order is not None else 0
    by_name = sorted(names, key=lambda s: s.encode("utf-8"))
    order = (sorted(by_name, key=lambda s: crt.get(s, 0)) if tracked
             else by_name)
    links = _Links(names, order)
    f.links_cache[g.addr] = links
    return links


# ---------------------------------------------------------------------------
# objects: h5py's Group / Dataset / Datatype, as far as the JAX code uses
# them
# ---------------------------------------------------------------------------

class _Empty:
    """h5py's ``Empty``: the value of a null dataspace."""

    def __init__(self, dtype):
        self.dtype = dtype

    def __repr__(self):
        return f"Empty(dtype={self.dtype!r})"


class _Ref:
    """An object reference (the address of an object header)."""

    def __init__(self, addr):
        self.addr = addr


class _Node:
    def __init__(self, f: _File, addr: int, name: str):
        self.f, self.addr, self.name = f, addr, name

    @property
    def header(self) -> _Header:
        return self.f.header(self.addr)

    @property
    def attrs(self) -> "_Attrs":
        return _Attrs(self)

    @property
    def parent(self) -> "_Node":
        return self.f.root[posixpath.dirname(self.name)]


class _Datatype(_Node):
    pass


def _split(path: str) -> List[str]:
    return [p for p in path.split("/") if p != ""]


class _Group(_Node):
    def links(self) -> _Links:
        return _group_links(self.f, self)

    def _follow(self, link, nsoft: List[int]) -> "_Node":
        """The object a link names; ``nsoft`` counts soft-link hops."""
        kind, val = link[0], link[1]
        if kind == "hard":
            if val is None:
                raise KeyError("Unable to synchronously open object "
                               "(undefined address)")
            return self.f.node(val, "")
        if kind == "soft":
            nsoft[0] += 1
            if nsoft[0] > _MAX_SOFT:
                raise KeyError("Unable to synchronously open object (too "
                               "many links)")
            return self._open(val, nsoft)
        if kind == "external":
            raise _refused("external link")
        raise _unsupported("user-defined links")

    def _open(self, path: str, nsoft: List[int]) -> "_Node":
        loc = self.f.root if path.startswith("/") else self
        parts = _split(path) or ["."]
        for p in parts:
            if p == ".":
                continue
            if not isinstance(loc, _Group):
                raise KeyError("Unable to synchronously open object "
                               "(not a group)")
            link = loc.links().map.get(p)
            if link is None:
                raise KeyError("Unable to synchronously open object "
                               "(component not found)")
            loc = loc._follow(link, nsoft)
        return loc

    def _exists(self, p: str) -> bool:
        """h5o.exists_by_name: the link resolves to an object."""
        link = self.links().map.get(p)
        if link is None:
            return False
        try:
            self._follow(link, [0])
        except KeyError:
            return False
        return True

    def __contains__(self, path) -> bool:
        # h5py's _path_valid: every component but the last must resolve
        # to a group; the last need only exist as a link
        path = str(path)
        if not path:
            return False
        loc = self.f.root if path.startswith("/") else self
        parts = _split(path) or ["."]
        for i, p in enumerate(parts):
            if p == ".":
                continue
            if p not in loc.links().map:
                return False
            if i == len(parts) - 1:
                return True
            if not loc._exists(p):
                return False
            nxt = loc._follow(loc.links().map[p], [0])
            if not isinstance(nxt, _Group):
                return False
            loc = nxt
        return True

    def __getitem__(self, path):
        if not isinstance(path, (str, bytes)):
            raise TypeError("Accessing a group is done with bytes or str, "
                            f"not {type(path)}")
        if isinstance(path, bytes):
            path = path.decode("utf-8")
        node = self._open(path, [0])
        node.name = _name_of(self.name, path)
        return node

    def get(self, name):
        try:
            return self[name]
        except KeyError:
            return None

    def items(self):
        for name in self.links().order:
            yield name, self.get(name)

    def visit_datasets(self) -> List["_Dataset"]:
        """h5py's ``visititems`` order (H5Ovisit, name index increasing):
        depth first, a parent before its children, each object once under
        the first path that reaches it, hard links only."""
        out: List[_Dataset] = []
        visited = {self.addr}

        def walk(g: _Group, prefix: str, depth: int):
            if depth > 256:
                raise ValueError("HDF5 groups nest too deeply")
            links = g.links()
            for name in sorted(links.map, key=lambda s: s.encode("utf-8")):
                kind, addr = links.map[name]
                if kind != "hard" or addr is None or addr in visited:
                    continue
                visited.add(addr)
                self.f.step()
                node = self.f.node(addr, prefix + name)
                if isinstance(node, _Dataset):
                    out.append(node)
                elif isinstance(node, _Group):
                    walk(node, prefix + name + "/", depth + 1)
        walk(self, "/" if self.name == "/" else self.name + "/", 0)
        return out


def _name_of(base: str, path: str) -> str:
    parts = [p for p in _split(path) if p != "."]
    if path.startswith("/"):
        return "/" + "/".join(parts)
    prefix = "" if base == "/" else base
    return prefix + "/" + "/".join(parts) if parts else base


class _Attrs:
    """``obj.attrs``, read-only, values converted as h5py converts them."""

    def __init__(self, node: _Node):
        self.node = node
        self._raw = None

    def _table(self) -> Dict[str, tuple]:
        if self._raw is not None:
            return self._raw
        f = self.node.f
        hdr = self.node.header
        if hdr.attr_table is not None:
            self._raw = hdr.attr_table
            return self._raw
        table: Dict[str, tuple] = {}
        for m in hdr.all(0x000C):
            pos, size = hdr.f_shared(m)
            name, attr = _attribute(f, bytes(f.data[pos:pos + size]))
            table[name] = attr
        info = hdr.message(0x0015)
        if info is not None:
            c = f.cur(*info)
            c.u(1)
            flags = c.u(1)
            if flags & 1:
                c.u(2)
            heap_addr, name_bt = c.addr(), c.addr()
            if heap_addr is not None and name_bt is not None:
                heap = _FractalHeap(f, heap_addr)
                btype, recs = _btree2(f, name_bt)
                if btype != 8:
                    raise ValueError("HDF5 attribute name index is not a "
                                     "type 8 B-tree")
                for rec in recs:
                    if rec[8] & 0x02:
                        raise _unsupported("shared attribute messages (SOHM)")
                    name, attr = _attribute(f, heap.get(rec[:8]))
                    table[name] = attr
        self._raw = hdr.attr_table = table
        return table

    def __contains__(self, key) -> bool:
        return str(key) in self._table()

    def __getitem__(self, key):
        t = self._table()
        if key not in t:
            raise KeyError(f"Can't open attribute (can't locate attribute: "
                           f"'{key}')")
        return _attr_value(self.node.f, *t[key])

    def get(self, key, default=None):
        if key not in self._table():
            return default
        return self[key]

    def keys(self):
        return list(self._table())


def _attribute(f: _File, raw: bytes):
    """(name, (type, shape, data bytes)) of an encoded attribute message."""
    bf = _BytesFile(raw, f)
    c = _Cur(bf, 0, len(raw))
    ver = c.u(1)
    flags = c.u(1)
    nlen, tlen, slen = c.u(2), c.u(2), c.u(2)
    if ver == 3:
        c.u(1)
    elif ver not in (1, 2):
        raise ValueError(f"HDF5 attribute message version {ver}")

    def field(n):
        start = c.p
        c.skip(n)
        if ver == 1:
            c.skip((-n) % 8)
        return start
    npos = field(nlen)
    name = raw[npos:npos + nlen].split(b"\0", 1)[0].decode("utf-8",
                                                           "replace")
    tpos = field(tlen)
    spos = field(slen)
    if flags & 0x01:
        hdr = f.header(_shared_target(bf, tpos, tlen))
        got = hdr.message(0x0003)
        if got is None:
            raise ValueError("HDF5 shared attribute type not found")
        dtype = _datatype(f, *got)
    else:
        dtype = _datatype(bf, tpos, tlen)
    if flags & 0x02:
        hdr = f.header(_shared_target(bf, spos, slen))
        got = hdr.message(0x0001)
        if got is None:
            raise ValueError("HDF5 shared attribute dataspace not found")
        shape, _ = _dataspace(f, *got)
    else:
        shape, _ = _dataspace(bf, spos, slen)
    data = raw[c.p:]
    return name, (dtype, shape, data)


def _vlen_items(f: _File, t: _Type, data: bytes, count: int) -> List[bytes]:
    """The bytes of each variable-length element (global heap)."""
    step = 4 + f.so + 4
    if len(data) < step * count:
        raise ValueError("HDF5 variable-length data is truncated")
    out = []
    for i in range(count):
        n = int.from_bytes(data[i * step:i * step + 4], "little")
        a = int.from_bytes(data[i * step + 4:i * step + 4 + f.so], "little")
        idx = int.from_bytes(data[i * step + 4 + f.so:(i + 1) * step],
                             "little")
        if n == 0:
            out.append(b"")
            continue
        where = f.addr(a)
        if where is None:
            raise ValueError("HDF5 variable-length data at an undefined "
                             "address")
        out.append(_global_heap(f, where, idx))
    return out


def _strings(t: _Type, raw: bytes, count: int) -> np.ndarray:
    arr = np.frombuffer(raw, f"S{t.size}", count).copy()
    if t.pad == 0:                       # null-terminated: cut at a NUL
        arr = np.array([x.split(b"\0", 1)[0] for x in arr.tolist()],
                       dtype=f"S{t.size}") if count else arr
    elif t.pad == 2:                     # space-padded
        arr = np.array([x.rstrip(b" ") for x in arr.tolist()],
                       dtype=f"S{t.size}") if count else arr
    return arr


def _attr_value(f: _File, t: _Type, shape, data: bytes):
    if shape is None:
        return _Empty(t.dtype)
    count = _npcount(shape)
    if count > len(data) + 1 and t.size:
        raise ValueError("HDF5 attribute data is truncated")
    if t.cls == 9:
        items = _vlen_items(f, t, data, count)
        if t.vlen_str:
            vals = [x.decode("utf-8", "surrogateescape") for x in items]
        elif t.base is not None and t.base.cls == 7:
            vals = [[_Ref(f.addr(int.from_bytes(x[k:k + f.so], "little")))
                     for k in range(0, len(x) - f.so + 1, f.so)]
                    for x in items]
        elif t.base is not None and t.base.numeric:
            vals = [_convert(t.base, np.frombuffer(
                x, _raw_dtype(t.base), len(x) // t.base.size))
                for x in items]
        else:
            return _Empty(t.dtype)
        if shape == ():
            return vals[0]
        arr = np.empty(count, object)
        for i, v in enumerate(vals):
            arr[i] = v
        return arr.reshape(shape)
    if t.cls == 7:
        refs = [_Ref(f.addr(int.from_bytes(data[k * f.so:(k + 1) * f.so],
                                           "little"))) for k in range(count)]
        if shape == ():
            return refs[0]
        arr = np.empty(count, object)
        for i, r in enumerate(refs):
            arr[i] = r
        return arr.reshape(shape)
    if t.dtype is None or t.cls in (5, 6, 10):
        return _Empty(t.dtype)     # compound (REFERENCE_LIST), opaque...
    need = count * t.size
    if len(data) < need:
        raise ValueError("HDF5 attribute data is truncated")
    if t.cls == 3:
        arr = _strings(t, data[:need], count)
    else:
        arr = _convert(t, np.frombuffer(data[:need], _raw_dtype(t), count))
    arr = arr.reshape(shape)
    return arr[()] if shape == () else arr


def _raw_dtype(t: _Type) -> np.dtype:
    if t.cls == 8:
        return t.base.dtype
    return t.dtype


def _convert(t: _Type, raw: np.ndarray) -> np.ndarray:
    """File values -> what h5py returns for them."""
    if t.cls == 8:
        members = np.array(sorted(t.enum.values()), dtype=np.int64) \
            if t.enum else np.zeros(0, np.int64)
        vals = raw.astype(np.int64)
        ok = np.isin(vals, members)
        if t.is_bool:
            out = np.where(ok, vals, 0xFF).astype(np.uint8)
            return out.view(np.bool_)
        out = raw.copy()
        if not ok.all():
            out[~ok] = np.array(-1).astype(raw.dtype) if \
                raw.dtype.kind == "i" else np.iinfo(raw.dtype).max
        return out
    if t.cls in (0, 4) and (t.off, t.prec) != (0, 8 * t.size):
        if t.prec == 0 or t.off + t.prec > 8 * t.size:
            raise ValueError("HDF5 integer precision is out of range")
        u = raw.astype(raw.dtype.newbyteorder("=")).view(
            f"u{t.size}").astype(np.uint64)
        v = (u >> np.uint64(t.off)) & np.uint64((1 << t.prec) - 1)
        if t.signed:
            sign = np.uint64(1 << (t.prec - 1))
            v = (v ^ sign).astype(np.int64) - np.int64(1 << (t.prec - 1)) \
                if t.prec < 64 else v.view(np.int64)
        return v.astype(t.dtype.newbyteorder("=")).astype(t.dtype)
    return raw


class _Dataset(_Node):
    def __init__(self, f, addr, name):
        super().__init__(f, addr, name)
        hdr = self.header
        if hdr.meta is None:
            got = hdr.message(0x0003)
            if got is None:
                raise ValueError(f"HDF5 dataset {name!r} has no datatype")
            dtype = _datatype(f, *got)
            got = hdr.message(0x0001)
            if got is None:
                raise ValueError(f"HDF5 dataset {name!r} has no dataspace")
            hdr.meta = (dtype,) + _dataspace(f, *got)
        self.type, self.shape, self.maxshape = hdr.meta

    @property
    def dtype(self):
        return self.type.dtype

    @property
    def ndim(self) -> int:
        return 0 if self.shape is None else len(self.shape)

    # -- dimension scales (h5py's ds.dims through the H5DS API) ------------
    def dim_scales(self, axis: int) -> List["_Dataset"]:
        lst = self.attrs.get("DIMENSION_LIST")
        if lst is None:
            return []
        if not isinstance(lst, np.ndarray) or lst.dtype != object or \
                lst.shape != (self.ndim,):
            raise ValueError("HDF5 DIMENSION_LIST is not a vlen of object "
                             "references per dimension")
        return [self.f.node(ref.addr, "") for ref in lst[axis]]

    # -- reading ------------------------------------------------------------
    def read(self):
        """``ds[()]``: an array, a numpy scalar, or ``_Empty``."""
        if self.shape is None:
            return _Empty(self.dtype)
        t = self.type
        if t.dtype is None or t.cls in (5, 6, 7, 9, 10):
            raise _unsupported(f"reading datasets of datatype class {t.cls}")
        hdr = self.header
        f = self.f
        if hdr.first(0x0007) is not None:
            raise _refused("external raw data storage")
        count = _npcount(self.shape)
        if len(self.shape) >= 2 and max(self.shape[-2:]) > MAX_SIDE:
            raise ValueError(f"HDF5 dataset {self.name!r} of shape "
                             f"{self.shape}: a side above {MAX_SIDE}")
        nbytes = count * t.size
        got = hdr.message(0x0008)
        c = f.cur(*got)
        layout = _layout(f, c, len(self.shape))
        fill = _fill(f, hdr)
        if layout["class"] == 3:
            raise _refused("virtual dataset")
        if layout["class"] != 0 and nbytes > _max_bytes(f):
            raise ValueError(f"HDF5 dataset {self.name!r} declares "
                             f"{nbytes} bytes, more than the file can hold")
        raw_dtype = _raw_dtype(t)
        if layout["class"] == 0:
            buf = layout["data"]
            if len(buf) < nbytes:
                raise ValueError("HDF5 compact data is truncated")
            arr = np.frombuffer(buf, raw_dtype, count).reshape(self.shape)
        elif layout["class"] == 1:
            where = layout["addr"]
            if where is None:
                arr = _filled(fill, self.shape, raw_dtype, t)
            else:
                if where + nbytes > f.n:
                    raise ValueError("HDF5 contiguous data lies past the end "
                                     "of the file")
                arr = np.frombuffer(f.data, raw_dtype, count,
                                    where).reshape(self.shape)
        elif layout["class"] == 2:
            arr = _read_chunked(self, layout, fill, raw_dtype)
        else:
            raise ValueError(f"HDF5 layout class {layout['class']}")
        if t.cls == 3:
            arr = _strings(t, arr.tobytes(), count).reshape(self.shape)
        else:
            arr = _convert(t, np.array(arr))
        return arr[()] if self.shape == () else arr


def _fill(f: _File, hdr: _Header):
    """(value bytes or None for zeros, fill time, "user" | "default" |
    "undefined"); fill times 0 alloc, 1 never, 2 if set."""
    got = hdr.message(0x0005)
    if got is not None:
        c = f.cur(*got)
        ver = c.u(1)
        if ver in (1, 2):
            c.u(1)                               # allocation time
            ftime, defined = c.u(1), c.u(1)
            if ver == 2 and not defined:
                return None, ftime, "undefined"
            n = c.u(4)
            return (c.raw(n) if n else None), ftime, "user" if n else \
                "default"
        if ver == 3:
            flags = c.u(1)
            ftime = (flags >> 2) & 3
            if flags & 0x10:
                return None, ftime, "undefined"
            if flags & 0x20:
                n = c.u(4)
                return (c.raw(n) if n else None), ftime, "user"
            return None, ftime, "default"
        raise ValueError(f"HDF5 fill value message version {ver}")
    got = hdr.message(0x0004)
    if got is not None:
        c = f.cur(*got)
        n = c.u(4)
        return (c.raw(n) if n else None), 2, "user" if n else "default"
    return None, 2, "default"


def _filled(fill, shape, dtype, t: _Type, strict: bool = True
            ) -> np.ndarray:
    value, ftime, status = fill
    if strict and status == "undefined" and ftime in (0, 2):
        raise ValueError("read failed: dataset doesn't exist, no data can "
                         "be read")
    arr = np.zeros(shape, dtype)
    if value is not None and ftime != 1:
        if len(value) != t.size:
            raise ValueError("HDF5 fill value of another size")
        arr[...] = np.frombuffer(value, dtype, 1)[0]
    return arr


def _layout(f: _File, c: _Cur, rank: int) -> dict:
    ver = c.u(1)
    out: dict = {"version": ver}
    if ver in (1, 2):
        nd = c.u(1)
        cls = c.u(1)
        c.skip(5)
        out["class"] = cls
        if cls != 0:
            out["addr"] = c.addr()
        dims = [c.u(4) for _ in range(nd)]
        if cls == 2:
            out["chunk"] = dims[:-1]
            out["esize"] = dims[-1] if dims else 0
            c.u(4)
            out["index"] = 0
        elif cls == 0:
            n = c.u(4)
            out["data"] = c.raw(n)
        return out
    if ver not in (3, 4, 5):
        raise ValueError(f"HDF5 data layout version {ver}")
    cls = c.u(1)
    out["class"] = cls
    if cls == 0:
        n = c.u(2)
        out["data"] = c.raw(n)
    elif cls == 1:
        out["addr"] = c.addr()
        out["size"] = c.length()
    elif cls == 2:
        if ver == 3:
            nd = c.u(1)
            out["addr"] = c.addr()
            dims = [c.u(4) for _ in range(nd)]
            out["chunk"], out["esize"] = dims[:-1], dims[-1]
            out["index"] = 0
        else:
            flags = c.u(1)
            out["edge_raw"] = bool(flags & 0x01)
            nd = c.u(1)
            w = c.u(1)
            if not 1 <= w <= 8:
                raise ValueError("HDF5 chunk dimension width")
            dims = [c.u(w) for _ in range(nd)]
            out["chunk"], out["esize"] = dims[:-1], dims[-1]
            idx = c.u(1)
            out["index"] = idx
            if idx == 1:                        # single chunk
                if flags & 0x02:
                    out["fsize"] = c.length()
                    out["fmask"] = c.u(4)
            elif idx == 3:                      # fixed array
                c.u(1)
            elif idx == 4:                      # extensible array
                c.skip(5)
            elif idx == 5:                      # v2 B-tree
                c.skip(6)
            elif idx != 2:
                raise ValueError(f"HDF5 chunk index type {idx}")
            out["addr"] = c.addr()
        if len(out["chunk"]) != rank:
            raise ValueError("HDF5 chunk rank differs from the dataspace's")
        if any(d == 0 for d in out["chunk"]):
            raise ValueError("HDF5 chunk of zero size")
    elif cls == 3:
        pass
    else:
        raise ValueError(f"HDF5 layout class {cls}")
    return out


def _pipeline(f: _File, hdr: _Header) -> List[Tuple[int, int, tuple]]:
    got = hdr.message(0x000B)
    if got is None:
        return []
    c = f.cur(*got)
    ver = c.u(1)
    n = c.u(1)
    if ver == 1:
        c.skip(6)
    elif ver != 2:
        raise ValueError(f"HDF5 filter pipeline version {ver}")
    out = []
    for _ in range(n):
        fid = c.u(2)
        nlen = c.u(2) if ver == 1 or fid >= 256 else 0
        flags = c.u(2)
        nvals = c.u(2)
        c.skip(nlen + ((-nlen) % 8 if ver == 1 else 0))
        vals = tuple(c.u(4) for _ in range(nvals))
        if ver == 1 and nvals % 2:
            c.skip(4)
        out.append((fid, flags, vals))
    return out


def _unfilter(filters, mask: int, raw: bytes, size: int, t: _Type,
              nelem: int) -> bytes:
    for i in range(len(filters) - 1, -1, -1):
        if mask & (1 << i):
            continue
        fid, _flags, vals = filters[i]
        if fid == 1:
            d = zlib.decompressobj()
            out = d.decompress(raw, size + 1)
            if len(out) > size or d.unconsumed_tail:
                raise ValueError("HDF5 deflate chunk inflates past its size")
            raw = out
        elif fid == 2:
            es = vals[0] if vals else t.size
            if es > 1 and len(raw) >= es:
                n = len(raw) // es
                body = np.frombuffer(raw, np.uint8, n * es)
                out = np.empty((n, es), np.uint8)
                for k in range(es):        # a column at a time is fastest
                    out[:, k] = body[k * n:(k + 1) * n]
                raw = out.tobytes() + raw[n * es:]
        elif fid == 3:
            if len(raw) < 4:
                raise ValueError("HDF5 fletcher32 chunk is truncated")
            body = raw[:-4]
            stored = int.from_bytes(raw[-4:], "little")
            want = fletcher32(body)
            swapped = ((want & 0x00FF00FF) << 8) | ((want >> 8) & 0x00FF00FF)
            if stored not in (want, swapped):
                raise ValueError("data error detected by Fletcher32 checksum")
            raw = body
        elif fid == 32000:
            # cd_values[2] is the chunk's size as h5py's filter recorded it
            if len(vals) > 2 and vals[2] > size:
                raise ValueError("HDF5 LZF size parameter exceeds the "
                                 "chunk's size")
            # room for what a filter applied before LZF adds: fletcher32's
            # 4-byte checksum, scale-offset's 21-byte header
            raw = _lzf(raw, size + 64)
        elif fid == 5:
            raw = _nbit(raw, vals, size)
        elif fid == 6:
            raw = _scaleoffset(raw, vals, size, t, nelem)
        elif fid == 4:
            raw = _szip(raw, size, vals)
        else:
            raise _unsupported(f"filter {fid}")
    return raw


def _bits_msb(raw: bytes, nbits_total: int) -> np.ndarray:
    bits = np.unpackbits(np.frombuffer(raw, np.uint8))
    if bits.size < nbits_total:
        raise ValueError("HDF5 packed chunk is truncated")
    return bits[:nbits_total]


def _pack_values(bits: np.ndarray, n: int, width: int) -> np.ndarray:
    """n unsigned values of ``width`` bits each, MSB first."""
    if width == 0:
        return np.zeros(n, np.uint64)
    b = bits.reshape(n, width).astype(np.uint64)
    weights = np.uint64(1) << np.arange(width - 1, -1, -1, dtype=np.uint64)
    return (b * weights).sum(axis=1, dtype=np.uint64)


def _nbit(raw: bytes, vals: tuple, size: int) -> bytes:
    # cd_values: nparms, need-not-compress, elements, class, size, order,
    # precision, offset (an atomic type; compound and array types are
    # described recursively and are not read here)
    if len(vals) < 8:
        raise ValueError("HDF5 n-bit parameters are truncated")
    if vals[1]:
        return raw
    n, cls, esize, order, prec, off = vals[2], vals[3], vals[4], vals[5], \
        vals[6], vals[7]
    if cls != 1:
        raise _unsupported("the n-bit filter on compound or array types")
    if n * esize != size or not 0 < prec <= 8 * esize or off + prec > \
            8 * esize or esize not in (1, 2, 4, 8):
        raise ValueError("HDF5 n-bit parameters are out of range")
    v = _pack_values(_bits_msb(raw, n * prec), n, prec) << np.uint64(off)
    out = v.astype(f"<u{esize}" if order == 0 else f">u{esize}")
    return out.tobytes()


def _scaleoffset(raw: bytes, vals: tuple, size: int, t: _Type,
                 nelem: int) -> bytes:
    # cd_values: scale type, scale factor, elements, class (0 int, 1
    # float), size, sign, order, fill available, fill value words
    if len(vals) < 8:
        raise ValueError("HDF5 scale-offset parameters are truncated")
    stype, sfactor, n, cls, esize, sign, order, filavail = vals[:8]
    if n * esize != size or esize not in (1, 2, 4, 8) or len(raw) < 21:
        raise ValueError("HDF5 scale-offset parameters are out of range")
    minbits = int.from_bytes(raw[:4], "little")
    msize = min(8, raw[4])
    minval = int.from_bytes(raw[5:5 + msize], "little")
    endian = "<" if order == 0 else ">"
    if minbits > 8 * esize:
        raise ValueError("HDF5 scale-offset width is out of range")
    if minbits == 8 * esize:
        body = raw[21:21 + size]
        if len(body) < size:
            raise ValueError("HDF5 scale-offset chunk is truncated")
        if order == 1:
            body = np.frombuffer(body, f"<u{esize}").astype(
                f">u{esize}").tobytes()
        return body
    # with no bits per value every value is the minimum: compute one
    m = n if minbits else 1
    if minbits:
        v = _pack_values(_bits_msb(raw[21:], n * minbits), n, minbits)
    else:
        v = np.zeros(1, np.uint64)
    fillv = None
    if filavail:
        words = vals[8:]
        fb = b"".join(int(w).to_bytes(4, "little") for w in words)[:esize]
        if len(fb) < esize:
            raise ValueError("HDF5 scale-offset fill value is truncated")
        fillv = fb
    if cls == 0:
        dt = np.dtype(f"{endian}{'i' if sign else 'u'}{esize}")
        if sign:
            base = np.int64(minval - (1 << 64) if minval >= 1 << 63
                            else minval)
            out = (v.view(np.int64) + base).astype(dt.newbyteorder("="))
        else:
            out = (v + np.uint64(minval)).astype(dt.newbyteorder("="))
        if fillv is not None and minbits:
            mark = v == np.uint64((1 << minbits) - 1)
            out[mark] = np.frombuffer(fillv, dt.newbyteorder("="), 1)[0]
        return out.astype(dt).tobytes() * (n // m)
    if cls == 1 and stype == 0:
        if esize not in (4, 8):
            raise _unsupported("scale-offset on a float of this size")
        ft = np.dtype(f"f{esize}")
        minf = np.frombuffer(minval.to_bytes(8, "little")[:esize], ft, 1)[0]
        vi = v.view(np.int64).astype(f"i{esize}")
        if sfactor >= 1 << 31:
            sfactor -= 1 << 32
        # (type)ival / 10^D + min, in the type's own arithmetic
        out = vi.astype(ft) / ft.type(math.pow(10.0, sfactor)) + minf
        if fillv is not None and minbits:
            mark = v == np.uint64((1 << minbits) - 1)
            out[mark] = np.frombuffer(fillv, ft, 1)[0]
        return out.astype(ft.newbyteorder(endian)).tobytes() * (n // m)
    raise _unsupported("scale-offset with E-scaling")


def _chunk_records(ds: _Dataset, layout: dict):
    """[(scaled chunk coords, address, stored size, filter mask)] of the
    allocated chunks."""
    f = ds.f
    chunk = layout["chunk"]
    rank = len(chunk)
    csize = _npcount(chunk) * layout["esize"]
    idx = layout["index"]
    addr = layout.get("addr")
    if addr is None:
        return []
    filtered = ds.header.first(0x000B) is not None
    grid = [-(-int(s) // c) for s, c in zip(ds.shape, chunk)]
    unlim = (1 << (8 * f.sl)) - 1
    maxgrid = [g if m == unlim else max(g, -(-int(m) // c))
               for g, m, c in zip(grid, ds.maxshape, chunk)]
    out = []
    if idx == 0:                                        # v1 B-tree
        nkey = 8 + 8 * (rank + 1)
        for key, child in _btree1(f, addr, 1, nkey):
            size, mask = struct.unpack_from("<II", key)
            offs = struct.unpack_from(f"<{rank + 1}Q", key, 8)
            if any(o % c for o, c in zip(offs, chunk)):
                raise ValueError("HDF5 chunk offset is not on the grid")
            out.append((tuple(o // c for o, c in zip(offs, chunk)), child,
                        size, mask))
        return out
    if idx == 1:                                        # single chunk
        return [((0,) * rank, addr, layout.get("fsize", csize),
                 layout.get("fmask", 0))]
    if idx == 2:                                        # implicit
        n = _npcount(maxgrid)
        if addr + n * csize > f.n:
            raise ValueError("HDF5 implicit chunk index lies past the end "
                             "of the file")
        f.step(n)
        return [(tuple(int(v) for v in np.unravel_index(i, maxgrid)),
                 addr + i * csize, csize, 0) for i in range(n)]
    if idx == 3:                                        # fixed array
        elems = _fixed_array(f, addr, filtered)
        order = list(range(rank))
    elif idx == 4:                                      # extensible array
        elems = _ext_array(f, addr, filtered)
        u = [i for i, m in enumerate(ds.maxshape) if m == unlim]
        u = u[0] if u else 0
        order = [u] + [i for i in range(rank) if i != u]
    elif idx == 5:                                      # v2 B-tree
        btype, recs = _btree2(f, addr)
        if btype not in (10, 11):
            raise ValueError("HDF5 chunk index is not a type 10/11 B-tree")
        for rec in recs:
            a = f.addr(int.from_bytes(rec[:f.so], "little"))
            if btype == 10:
                s, m, p = csize, 0, f.so
            else:
                slen = len(rec) - f.so - 4 - 8 * rank
                if slen <= 0:
                    raise ValueError("HDF5 filtered chunk record size")
                s = int.from_bytes(rec[f.so:f.so + slen], "little")
                m = int.from_bytes(rec[f.so + slen:f.so + slen + 4],
                                   "little")
                p = f.so + slen + 4
            coords = struct.unpack_from(f"<{rank}Q", rec, p)
            if a is not None:
                out.append((coords, a, s, m))
        return out
    else:
        raise ValueError(f"HDF5 chunk index type {idx}")
    # the linear index runs over the chunk grid of the maximum shape, the
    # unlimited dimension (extensible array) moved first
    sw = [maxgrid[i] for i in order]
    if idx == 4:
        sw[0] = max(1, -(-len(elems) // max(1, _npcount(sw[1:]))))
    for lin, (a, s, m) in enumerate(elems):
        if a is None:
            continue
        swc = np.unravel_index(lin, sw)
        coords = [0] * rank
        for k, i in enumerate(order):
            coords[i] = int(swc[k])
        out.append((tuple(coords), a, s if filtered else csize, m))
    return out


def _elements(f: _File, c: _Cur, n: int, esize: int, filtered: bool):
    out = []
    for _ in range(n):
        a = c.addr()
        if filtered:
            slen = esize - f.so - 4
            if slen <= 0:
                raise ValueError("HDF5 filtered chunk element size")
            s, m = c.u(slen), c.u(4)
        else:
            s, m = 0, 0
        out.append((a, s, m))
    return out


def _fixed_array(f: _File, addr: int, filtered: bool):
    c = f.cur(addr)
    c.sig(b"FAHD")
    c.u(1)
    client = c.u(1)
    esize = c.u(1)
    page_bits = c.u(1)
    n = c.length()
    dblk = c.addr()
    f.check(addr, c.p - addr, "fixed array header")
    if (client == 1) != filtered or n > f.n or page_bits > 32:
        raise ValueError("HDF5 fixed array header is out of range")
    if dblk is None:
        return []
    c = f.cur(dblk)
    c.sig(b"FADB")
    c.u(1)
    c.u(1)
    c.addr()
    page = 1 << page_bits
    if n <= page:
        elems = _elements(f, c, n, esize, filtered)
        f.check(dblk, c.p - dblk, "fixed array data block")
        return elems
    npages = -(-n // page)
    bitmap = c.raw((npages + 7) // 8)
    f.check(dblk, c.p - dblk, "fixed array data block")
    c.skip(4)
    out = []
    for p in range(npages):
        k = min(page, n - p * page)
        start = c.p
        f.step()
        elems = _elements(f, c, k, esize, filtered)
        f.check(start, c.p - start, "fixed array page")
        c.skip(4)
        if bitmap[p // 8] & (0x80 >> (p % 8)):
            out.extend(elems)
        else:
            out.extend([(None, 0, 0)] * k)
    return out


def _ext_array(f: _File, addr: int, filtered: bool):
    c = f.cur(addr)
    c.sig(b"EAHD")
    c.u(1)
    client = c.u(1)
    esize = c.u(1)
    max_bits = c.u(1)
    idx_elmts = c.u(1)
    dblk_min = c.u(1)
    sblk_min_ptrs = c.u(1)
    page_bits = c.u(1)
    for _ in range(4):
        c.length()
    max_set = c.length()
    c.length()
    iblk = c.addr()
    f.check(addr, c.p - addr, "extensible array header")
    if ((client == 1) != filtered or not 0 < max_bits <= 64
            or dblk_min == 0 or dblk_min & (dblk_min - 1)
            or sblk_min_ptrs == 0 or sblk_min_ptrs & (sblk_min_ptrs - 1)
            or max_set > f.n or page_bits > 32):
        raise ValueError("HDF5 extensible array header is out of range")
    if iblk is None:
        return []
    off_size = (max_bits + 7) // 8
    nsblks = 1 + max_bits - (dblk_min.bit_length() - 1)
    info = []
    start_idx = start_dblk = 0
    for s in range(nsblks):
        ndblks = 1 << (s // 2)
        nel = (1 << ((s + 1) // 2)) * dblk_min
        info.append((ndblks, nel, start_idx, start_dblk))
        start_idx += ndblks * nel
        start_dblk += ndblks
    ib_nsblks = 2 * (sblk_min_ptrs.bit_length() - 1)
    ndblk_addrs = 2 * (sblk_min_ptrs - 1)
    nsblk_addrs = nsblks - ib_nsblks
    page = 1 << page_bits
    c = f.cur(iblk)
    c.sig(b"EAIB")
    c.u(1)
    c.u(1)
    c.addr()
    out = _elements(f, c, idx_elmts, esize, filtered)
    dblks = [c.addr() for _ in range(ndblk_addrs)]
    sblks = [c.addr() for _ in range(nsblk_addrs)]
    f.check(iblk, c.p - iblk, "extensible array index block")

    def dblock(a, nel, bitmap=None):
        if a is None:
            return [(None, 0, 0)] * nel
        f.step()
        d = f.cur(a)
        d.sig(b"EADB")
        d.u(1)
        d.u(1)
        d.addr()
        d.u(off_size)
        if nel <= page:
            elems = _elements(f, d, nel, esize, filtered)
            f.check(a, d.p - a, "extensible array data block")
            return elems
        f.check(a, d.p - a, "extensible array data block")
        d.skip(4)
        got = []
        for p in range(nel // page):
            start = d.p
            elems = _elements(f, d, page, esize, filtered)
            f.check(start, d.p - start, "extensible array page")
            d.skip(4)
            if bitmap is None or bitmap[p // 8] & (0x80 >> (p % 8)):
                got.extend(elems)
            else:
                got.extend([(None, 0, 0)] * page)
        return got

    k = 0
    for s in range(min(ib_nsblks, nsblks)):
        ndblks, nel = info[s][0], info[s][1]
        for _ in range(ndblks):
            if len(out) >= max_set or k >= len(dblks):
                return out[:max_set]
            out.extend(dblock(dblks[k], nel))
            k += 1
    for j, sa in enumerate(sblks):
        s = ib_nsblks + j
        ndblks, nel = info[s][0], info[s][1]
        if len(out) >= max_set:
            break
        if sa is None:
            out.extend([(None, 0, 0)] * (ndblks * nel))
            continue
        f.step()
        d = f.cur(sa)
        d.sig(b"EASB")
        d.u(1)
        d.u(1)
        d.addr()
        d.u(off_size)
        npages = nel // page if nel > page else 0
        bitmaps = [d.raw((npages + 7) // 8) for _ in range(ndblks)] \
            if npages else [None] * ndblks
        addrs = [d.addr() for _ in range(ndblks)]
        f.check(sa, d.p - sa, "extensible array super block")
        for a, bm in zip(addrs, bitmaps):
            if len(out) >= max_set:
                break
            out.extend(dblock(a, nel, bm))
    return out[:max_set]


def _read_chunked(ds: _Dataset, layout: dict, fill, raw_dtype) -> np.ndarray:
    f = ds.f
    t = ds.type
    shape = tuple(int(s) for s in ds.shape)
    chunk = [int(c) for c in layout["chunk"]]
    if layout["esize"] != t.size:
        raise ValueError("HDF5 chunk element size differs from the type's")
    csize = _npcount(chunk) * t.size
    if csize > _max_bytes(f):
        raise ValueError(f"HDF5 chunk of {csize} bytes, more than the file "
                         "can hold")
    # a missing chunk reads as the fill value; with no index at all, as an
    # unallocated dataset does
    arr = _filled(fill, shape, raw_dtype, t,
                  strict=layout.get("addr") is None)
    if _npcount(shape) == 0:
        return arr
    filters = _pipeline(f, ds.header)
    nel = _npcount(chunk)
    recs = _chunk_records(ds, layout)
    f.step(len(recs))
    for coords, where, size, mask in recs:
        lo = [c * k for c, k in zip(coords, chunk)]
        if any(a >= s for a, s in zip(lo, shape)):
            continue
        if where is None or where + size > f.n or size < 0:
            raise ValueError("HDF5 chunk lies past the end of the file")
        raw = bytes(f.data[where:where + size])
        edge = any(a + k > s for a, k, s in zip(lo, chunk, shape))
        if filters and not (edge and layout.get("edge_raw")):
            raw = _unfilter(filters, mask, raw, csize, t, nel)
        if len(raw) != csize:
            raise ValueError(f"HDF5 chunk of {len(raw)} bytes, not {csize}")
        block = np.frombuffer(raw, raw_dtype, nel).reshape(chunk)
        sl = tuple(slice(a, min(a + k, s)) for a, k, s in
                   zip(lo, chunk, shape))
        arr[sl] = block[tuple(slice(0, s.stop - s.start) for s in sl)]
    return arr


# ---------------------------------------------------------------------------
# the JAX module's selection and georeferencing
# ---------------------------------------------------------------------------

def _is_dimension_scale(ds) -> bool:
    cls = ds.attrs.get("CLASS")
    if isinstance(cls, bytes):
        cls = cls.decode("latin-1", "replace")
    return cls == "DIMENSION_SCALE"


def _numeric(ds) -> bool:
    return ds.dtype is not None and ds.dtype.kind in "iufb"


def _walk_datasets(f: _File) -> List[_Dataset]:
    return f.root.visit_datasets()


def _pick_dataset(f: _File, variable: Optional[str]):
    root = f.root
    if variable is not None:
        if variable not in root:
            raise ValueError(
                f"HDF5 dataset {variable!r} not found; file has: "
                f"{sorted(n for n, s in hdf5_paths(f))}")
        return root[variable]
    best, best_px = None, -1
    for ds in _walk_datasets(f):
        if not _numeric(ds) or ds.ndim < 2 or _is_dimension_scale(ds):
            continue
        px = int(ds.shape[-1]) * int(ds.shape[-2])
        if px > best_px:
            best, best_px = ds, px
    if best is None:
        raise ValueError(
            "no 2-D+ numeric raster dataset in HDF5 file; datasets: "
            + str(dict(hdf5_paths(f))))
    return best


def hdf5_paths(f: _File) -> List[Tuple[str, Tuple[int, ...]]]:
    return [(ds.name, tuple(ds.shape)) for ds in _walk_datasets(f)]


def hdf5_variables(data: bytes) -> Dict[str, Tuple[int, ...]]:
    """path -> shape for every dataset (inspection helper)."""
    return dict(hdf5_paths(_File(data)))


def _coord_array(f, ds, axis_index: int, want_x: bool
                 ) -> Optional[np.ndarray]:
    """1-D coordinate for one axis of ``ds``: the attached dimension
    scale (NetCDF-4) if present, else a sibling 1-D dataset with
    CF axis attrs and the matching length."""
    try:
        scales = ds.dim_scales(axis_index)
        if axis_index < ds.ndim and len(scales) > 0:
            scale = scales[0]
            if scale.shape is not None and len(scale.shape) == 1 and \
                    scale.shape[0] != ds.shape[axis_index]:
                raise ValueError("size differs")   # h5py reads it first
            arr = np.asarray(scale.read(), dtype=np.float64)
            if arr.ndim == 1 and arr.size == ds.shape[axis_index]:
                return arr
    except Exception:
        pass
    parent = ds.parent
    for name, obj in parent.items():
        if not isinstance(obj, _Dataset) or obj is ds:
            continue
        if obj.ndim != 1 or obj.shape[0] != ds.shape[axis_index]:
            continue
        if not _numeric(obj):
            continue
        ok = (cf.is_x_coordinate(name, obj.attrs) if want_x
              else cf.is_y_coordinate(name, obj.attrs))
        if ok:
            return np.asarray(obj.read(), dtype=np.float64)
    return None


def _georeference(f, ds, info: RasterInfo) -> None:
    nd = ds.ndim
    x = _coord_array(f, ds, nd - 1, want_x=True)
    y = _coord_array(f, ds, nd - 2, want_x=False)
    info.geotransform = cf.geotransform_from_coords(x, y)
    gm_name = ds.attrs.get("grid_mapping")
    if gm_name is not None:
        gm_name = cf._text(gm_name)
        gm = None
        if gm_name in ds.parent:
            gm = ds.parent[gm_name]
        elif gm_name in f.root:
            gm = f.root[gm_name]
        if gm is not None:
            info.epsg, info.wkt = cf.epsg_from_grid_mapping(gm.attrs)
            return
    # no grid_mapping: bare lon/lat coordinate scales imply WGS84
    # (GDAL's netCDF driver default). Identified by degree units on
    # the x-axis scale (attached dimension scale or CF sibling).
    if x is None or y is None:
        return
    lon_like = False
    try:
        scales = ds.dim_scales(nd - 1)
        if nd and len(scales) > 0:
            scale = scales[0]
            lon_like = cf._text(
                scale.attrs.get("units", b"")).lower().startswith("degrees")
    except Exception:
        pass
    if not lon_like:
        for name, obj in ds.parent.items():
            if (isinstance(obj, _Dataset) and obj.ndim == 1
                    and obj.shape[0] == ds.shape[nd - 1]
                    and cf.is_x_coordinate(name, obj.attrs)
                    and cf._text(obj.attrs.get("units", b"")).lower()
                    .startswith("degrees")):
                lon_like = True
                break
    if lon_like:
        info.epsg = 4326


def _nodata(ds) -> Optional[float]:
    for key in ("_FillValue", "missing_value"):
        v = ds.attrs.get(key)
        if v is not None and not isinstance(v, (bytes, str)):
            return float(np.asarray(v).ravel()[0])
    return None


def decode_hdf5(data: bytes, variable: Optional[str] = None) -> GeoTIFF:
    """HDF5 / NetCDF-4 bytes -> bands-last GeoTIFF container.

    Same selection and layout rules as ``decode_netcdf``: default
    variable = the non-coordinate numeric dataset with the most
    pixels; dims (..., y, x) with leading dims flattened into bands;
    raw values (scale/offset stay metadata)."""
    f = _File(data)
    ds = _pick_dataset(f, variable)
    if not isinstance(ds, _Dataset):
        if isinstance(ds, _Group):
            ds[()]
        raise TypeError(f"HDF5 object {ds.name!r} is not a dataset")
    arr = np.asarray(ds.read())
    if arr.ndim < 2:
        raise ValueError(
            f"HDF5 dataset {ds.name!r} is not a raster "
            f"(shape {arr.shape})")
    h, w = arr.shape[-2], arr.shape[-1]
    arr = arr.reshape(-1, h, w).transpose(1, 2, 0)
    if arr.dtype.byteorder not in ("=", "|"):
        arr = arr.astype(arr.dtype.newbyteorder("="))
    info = RasterInfo(width=w, height=h, count=arr.shape[2],
                      dtype=arr.dtype.name, nodata=_nodata(ds))
    _georeference(f, ds, info)
    return GeoTIFF(np.ascontiguousarray(arr), info)


def sniff_hdf5_info(data: bytes, variable: Optional[str] = None
                    ) -> RasterInfo:
    """Shape/geo sniff without reading the raster payload (only
    metadata + the 1-D coordinate datasets)."""
    f = _File(data)
    ds = _pick_dataset(f, variable)
    if not isinstance(ds, _Dataset):
        raise AttributeError(f"'{type(ds).__name__.strip('_')}' object has "
                             "no attribute 'shape'")
    shape = tuple(ds.shape)
    h, w = shape[-2], shape[-1]
    count = 1
    for s in shape[:-2]:
        count *= int(s)
    if ds.dtype is None:
        raise _unsupported(f"datatype class {ds.type.cls}")
    info = RasterInfo(
        width=w, height=h, count=count,
        dtype=np.dtype(ds.dtype).newbyteorder("=").name,
        nodata=_nodata(ds))
    _georeference(f, ds, info)
    return info
