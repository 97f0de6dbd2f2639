"""HDF4 scientific-data-set decoder and encoder.

A copy of the JAX package's ``raster/hdf4.py``: the HDF 4.2 wire
format, scoped to what raster ingestion needs:

* the data-descriptor (DD) block chain and extended-tag special
  elements: SPECIAL_COMP (deflate or stored) and SPECIAL_CHUNKED
  (chunk-table VDatas, per-chunk elements, themselves possibly
  compressed);
* scientific data sets: DFTAG_NDG groups -> DFTAG_SDD dimension
  records + DFTAG_NT number types (big-endian wire or DFNT_LITEND)
  + DFTAG_SD payloads;
* names from the SD API's "Var0.0" Vgroups, ``_FillValue`` from the
  attached "Attr0.0" VDatas -> nodata metadata;
* variable selection and bands-last layout as in the NetCDF decoder
  (leading dims flatten into bands).

No georeferencing: MODIS grids live on the sinusoidal projection of the
ECS StructMetadata text, which has no EPSG code, so arrays decode like
PNG (no geotransform).

``encode_hdf4`` writes single/multi-SDS files (plain, deflate, or
chunked+deflate storage), byte for byte the JAX package's.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from .geotiff import GeoTIFF, RasterInfo

__all__ = ["is_hdf4", "decode_hdf4", "sniff_hdf4_info",
           "hdf4_variables", "encode_hdf4"]

_MAGIC = b"\x0e\x03\x13\x01"

# tags
_NULL, _VERSION = 1, 30
_COMPRESSED, _CHUNK = 40, 61
_NT, _SDD, _SD, _NDG = 106, 701, 702, 720
_VH, _VS, _VG = 1962, 1963, 1965
_EXT = 0x4000          # extended-tag bit: special-element header
_SPECIAL_COMP, _SPECIAL_CHUNKED = 3, 6
_COMP_NONE, _COMP_DEFLATE = 0, 4

# DFNT number types (DFNT_LITEND = | 0x4000 -> little-endian wire)
_DFNT = {3: "uint8", 4: "uint8", 5: "float32", 6: "float64",
         20: "int8", 21: "uint8", 22: "int16", 23: "uint16",
         24: "int32", 25: "uint32", 26: "int64", 27: "uint64"}
_DFNT_REV = {"uint8": 21, "int8": 20, "int16": 22, "uint16": 23,
             "int32": 24, "uint32": 25, "int64": 26, "uint64": 27,
             "float32": 5, "float64": 6}


def is_hdf4(data: bytes) -> bool:
    return data[:4] == _MAGIC


def _dd_list(data: bytes) -> Dict[Tuple[int, int], Tuple[int, int]]:
    """(tag, ref) -> (offset, length) over the whole DD block chain."""
    out: Dict[Tuple[int, int], Tuple[int, int]] = {}
    pos = 4
    seen = set()
    while pos and pos not in seen and pos + 6 <= len(data):
        seen.add(pos)
        ndd, nxt = struct.unpack_from(">hi", data, pos)
        for i in range(ndd):
            o = pos + 6 + 12 * i
            tag, ref, off, ln = struct.unpack_from(">HHii", data, o)
            if tag != _NULL:
                out[(tag, ref)] = (off, ln)
        pos = nxt
    if not out:
        raise ValueError("HDF4 file has an empty descriptor chain")
    return out


class _File:
    def __init__(self, data: bytes):
        if not is_hdf4(data):
            raise ValueError("not an HDF4 file (bad magic)")
        self.data = data
        self.dds = _dd_list(data)

    # -- element resolution (plain / compressed / chunked) ---------------
    def element(self, tag: int, ref: int) -> bytes:
        dd = self.dds.get((tag, ref))
        if dd is not None:
            off, ln = dd
            return self.data[off:off + ln]
        dd = self.dds.get((tag | _EXT, ref))
        if dd is None:
            raise ValueError(
                f"HDF4 element (tag {tag}, ref {ref}) not found")
        off, ln = dd
        (special,) = struct.unpack_from(">h", self.data, off)
        if special == _SPECIAL_COMP:
            return self._read_comp(off)
        if special == _SPECIAL_CHUNKED:
            return self._read_chunked(off)
        raise ValueError(
            f"HDF4 special storage {special} is not supported "
            "(3 compressed, 6 chunked)")

    def _read_comp(self, off: int) -> bytes:
        # int16 SPECIAL_COMP, uint16 version, int32 uncompressed
        # length, uint16 comp ref, uint16 model, uint16 comp type
        _, _, length, cref, _, ctype = struct.unpack_from(
            ">hHiHHH", self.data, off)
        raw = self.element(_COMPRESSED, cref)
        if ctype == _COMP_DEFLATE:
            raw = zlib.decompress(raw)
        elif ctype != _COMP_NONE:
            raise ValueError(
                f"HDF4 compression type {ctype} is not supported "
                "(0 none, 4 deflate)")
        return raw[:length]

    def _read_chunked(self, off: int) -> bytes:
        # int16 SPECIAL_CHUNKED, uint8 version, int32 flag,
        # int32 total length, int32 chunk bytes, int32 nt size,
        # uint16/uint16 chunk-table tag/ref, uint16/uint16 spare,
        # int32 ndims, ndims x (int32 flag, int32 dim, int32 chunk)
        p = off
        _, _ver, _flag, total, _cbytes, nt_size, ttag, tref = \
            struct.unpack_from(">hBiiiiHH", self.data, p)
        p += 2 + 1 + 4 * 4 + 4
        p += 4  # spare sp_tag/sp_ref
        (ndims,) = struct.unpack_from(">i", self.data, p)
        p += 4
        dims, chunk = [], []
        for _ in range(ndims):
            _df, d, c = struct.unpack_from(">iii", self.data, p)
            dims.append(d)
            chunk.append(c)
            p += 12
        table = self._read_vdata(ttag, tref)
        nchunk = [-(-d // c) for d, c in zip(dims, chunk)]
        # assemble in BYTE space: the fastest dim scales by nt_size
        shape_b = [n * c for n, c in zip(nchunk, chunk)]
        shape_b[-1] *= nt_size
        full = np.zeros(shape_b, np.uint8)
        cshape_b = list(chunk)
        cshape_b[-1] *= nt_size
        for rec in table:
            origin = rec["origin"]
            blob = self.element(int(rec["chk_tag"]),
                                int(rec["chk_ref"]))
            arr = np.frombuffer(
                blob[:int(np.prod(cshape_b))], np.uint8)
            arr = arr.reshape(cshape_b)
            sl = tuple(
                slice(int(o) * c, (int(o) + 1) * c)
                for o, c in zip(origin[:-1], chunk[:-1])
            ) + (slice(int(origin[-1]) * cshape_b[-1],
                       (int(origin[-1]) + 1) * cshape_b[-1]),)
            full[sl] = arr
        dims_b = list(dims)
        dims_b[-1] *= nt_size
        crop = tuple(slice(0, d) for d in dims_b)
        return full[crop].tobytes()[:total]

    # -- VData ------------------------------------------------------------
    def _read_vdata(self, tag: int, ref: int) -> List[dict]:
        """Records of a VData as dicts of field -> numpy value(s)."""
        if tag != _VH:
            raise ValueError(f"expected a VData header tag, got {tag}")
        hdr = self.element(_VH, ref)
        p = 0
        _interlace, nrec, ivsize, nfields = struct.unpack_from(
            ">hiHh", hdr, p)
        p += 10
        types = struct.unpack_from(f">{nfields}h", hdr, p)
        p += 2 * nfields
        isizes = struct.unpack_from(f">{nfields}h", hdr, p)
        p += 2 * nfields
        _offsets = struct.unpack_from(f">{nfields}H", hdr, p)
        p += 2 * nfields
        orders = struct.unpack_from(f">{nfields}h", hdr, p)
        p += 2 * nfields
        names = []
        for _ in range(nfields):
            (ln,) = struct.unpack_from(">h", hdr, p)
            p += 2
            names.append(hdr[p:p + ln].decode("latin-1"))
            p += ln
        body = self.element(_VS, ref)
        out = []
        pos = 0
        for _ in range(nrec):
            rec = {}
            for name, t, isz, order in zip(names, types, isizes,
                                           orders):
                dt = _dfnt_dtype(t)
                n = order
                rec[name] = np.frombuffer(
                    body, dt, count=n, offset=pos)
                if n == 1:
                    rec[name] = rec[name][0]
                pos += isz
            out.append(rec)
        return out

    def vdata_meta(self, ref: int) -> Tuple[str, str]:
        """(name, class) of a VData header."""
        hdr = self.element(_VH, ref)
        p = 0
        _i, _n, _iv, nfields = struct.unpack_from(">hiHh", hdr, p)
        p += 10 + 2 * nfields * 4
        for _ in range(nfields):
            (ln,) = struct.unpack_from(">h", hdr, p)
            p += 2 + ln
        (ln,) = struct.unpack_from(">h", hdr, p)
        p += 2
        name = hdr[p:p + ln].decode("latin-1")
        p += ln
        (ln,) = struct.unpack_from(">h", hdr, p)
        p += 2
        cls = hdr[p:p + ln].decode("latin-1")
        return name, cls

    # -- Vgroups ----------------------------------------------------------
    def vgroups(self) -> List[dict]:
        out = []
        for (tag, ref), (off, ln) in self.dds.items():
            if tag != _VG:
                continue
            raw = self.data[off:off + ln]
            (nelt,) = struct.unpack_from(">H", raw, 0)
            p = 2
            tags = struct.unpack_from(f">{nelt}H", raw, p)
            p += 2 * nelt
            refs = struct.unpack_from(f">{nelt}H", raw, p)
            p += 2 * nelt
            (nl,) = struct.unpack_from(">H", raw, p)
            p += 2
            name = raw[p:p + nl].decode("latin-1")
            p += nl
            (cl,) = struct.unpack_from(">H", raw, p)
            p += 2
            cls = raw[p:p + cl].decode("latin-1")
            out.append({"ref": ref, "name": name, "class": cls,
                        "members": list(zip(tags, refs))})
        return out


def _dfnt_dtype(code: int) -> np.dtype:
    little = bool(code & 0x4000)
    base = _DFNT.get(code & ~0x4000)
    if base is None:
        raise ValueError(f"HDF4 number type {code} is not supported")
    return np.dtype(base).newbyteorder("<" if little else ">")


class _SDS:
    def __init__(self, f: _File, ndg_ref: int):
        self.f = f
        self.ndg_ref = ndg_ref
        self.name = f"NDG_{ndg_ref}"
        self.nodata: Optional[float] = None
        raw = f.element(_NDG, ndg_ref)
        members = [struct.unpack_from(">HH", raw, i)
                   for i in range(0, len(raw) - 3, 4)]
        self.sd_ref = None
        sdd_ref = None
        for tag, ref in members:
            if tag == _SDD:
                sdd_ref = ref
            elif tag == _SD:
                self.sd_ref = ref
        if sdd_ref is None or self.sd_ref is None:
            raise ValueError(
                f"HDF4 NDG {ndg_ref} lacks SDD/SD members")
        sdd = f.element(_SDD, sdd_ref)
        (rank,) = struct.unpack_from(">H", sdd, 0)
        self.shape = struct.unpack_from(f">{rank}i", sdd, 2)
        nt_tag, nt_ref = struct.unpack_from(">HH", sdd, 2 + 4 * rank)
        nt = f.element(_NT, nt_ref)
        # NT record: version, type, width-bits, class. DFNT_LITEND
        # files mark little-endian wire via class DFNTC_BYTE order;
        # mfhdf writes big-endian (class 0/1), which nt[1] reflects.
        self.dtype = _dfnt_dtype(nt[1])

    @property
    def pixels(self) -> int:
        return (int(self.shape[-1]) * int(self.shape[-2])
                if len(self.shape) >= 2 else 0)

    def read(self) -> np.ndarray:
        raw = self.f.element(_SD, self.sd_ref)
        n = int(np.prod(self.shape))
        arr = np.frombuffer(raw, self.dtype, count=n)
        return arr.reshape(self.shape)


def _scan(f: _File) -> List[_SDS]:
    out = []
    for (tag, ref) in sorted(f.dds):
        if tag == _NDG:
            out.append(_SDS(f, ref))
    # SD-API names + attributes come from "Var0.0" Vgroups
    by_ndg = {s.ndg_ref: s for s in out}
    for vg in f.vgroups():
        if vg["class"] != "Var0.0":
            continue
        sds = None
        for tag, ref in vg["members"]:
            if tag == _NDG and ref in by_ndg:
                sds = by_ndg[ref]
        if sds is None:
            continue
        if vg["name"]:
            sds.name = vg["name"]
        for tag, ref in vg["members"]:
            if tag != _VH:
                continue
            try:
                aname, acls = f.vdata_meta(ref)
            except ValueError:
                continue
            if acls.startswith("Attr") and aname == "_FillValue":
                recs = f._read_vdata(_VH, ref)
                if recs:
                    val = next(iter(recs[0].values()))
                    sds.nodata = float(np.asarray(val).ravel()[0])
    return out


def _pick(sdss: List[_SDS], variable: Optional[str]) -> _SDS:
    if variable is not None:
        for s in sdss:
            if s.name == variable:
                return s
        raise ValueError(
            f"HDF4 SDS {variable!r} not found; file has: "
            f"{sorted(s.name for s in sdss)}")
    best = None
    for s in sdss:
        if len(s.shape) < 2:
            continue
        if best is None or s.pixels > best.pixels:
            best = s
    if best is None:
        raise ValueError("no 2-D+ scientific data set in HDF4 file")
    return best


def hdf4_variables(data: bytes) -> Dict[str, Tuple[int, ...]]:
    """name -> shape for every SDS (inspection helper)."""
    f = _File(data)
    return {s.name: tuple(s.shape) for s in _scan(f)}


def decode_hdf4(data: bytes, variable: Optional[str] = None) -> GeoTIFF:
    """HDF4 bytes -> bands-last raster. Same selection/layout rules
    as decode_hdf5: default variable = the SDS with the most pixels,
    dims (..., y, x) with leading dims flattened into bands."""
    f = _File(data)
    sds = _pick(_scan(f), variable)
    arr = sds.read()
    h, w = arr.shape[-2], arr.shape[-1]
    arr = arr.reshape(-1, h, w).transpose(1, 2, 0)
    if arr.dtype.byteorder not in ("=", "|"):
        arr = arr.astype(arr.dtype.newbyteorder("="))
    info = RasterInfo(width=w, height=h, count=arr.shape[2],
                      dtype=arr.dtype.name, nodata=sds.nodata)
    return GeoTIFF(np.ascontiguousarray(arr), info)


def sniff_hdf4_info(data: bytes, variable: Optional[str] = None
                    ) -> RasterInfo:
    """Shape/dtype from the DD chain + SDD records only (payload
    untouched)."""
    f = _File(data)
    sds = _pick(_scan(f), variable)
    h, w = sds.shape[-2], sds.shape[-1]
    count = 1
    for s in sds.shape[:-2]:
        count *= int(s)
    return RasterInfo(width=w, height=h, count=count,
                      dtype=np.dtype(sds.dtype).newbyteorder("=").name,
                      nodata=sds.nodata)


# ---------------------------------------------------------------------------
# fixture encoder
# ---------------------------------------------------------------------------

class _Writer:
    def __init__(self):
        self.dds: List[Tuple[int, int, bytes]] = []
        self._ref = 1

    def ref(self) -> int:
        r = self._ref
        self._ref += 1
        return r

    def add(self, tag: int, ref: int, payload: bytes) -> int:
        self.dds.append((tag, ref, payload))
        return ref

    def tobytes(self) -> bytes:
        ndd = len(self.dds)
        header = 4 + 6 + 12 * ndd
        out = bytearray(_MAGIC)
        out += struct.pack(">hi", ndd, 0)
        pos = header
        blobs = []
        for tag, ref, payload in self.dds:
            out += struct.pack(">HHii", tag, ref, pos, len(payload))
            blobs.append(payload)
            pos += len(payload)
        for b in blobs:
            out += b
        return bytes(out)


def _vh(name: str, cls: str, fields: List[Tuple[str, int, int]],
        nrec: int) -> bytes:
    """fields: (fieldname, DFNT type, order)."""
    sizes = [np.dtype(_DFNT[t]).itemsize * order
             for _, t, order in fields]
    out = struct.pack(">hiHh", 0, nrec, sum(sizes), len(fields))
    for _, t, _o in fields:
        out += struct.pack(">h", t)
    for s in sizes:
        out += struct.pack(">h", s)
    off = 0
    for s in sizes:
        out += struct.pack(">H", off)
        off += s
    for _, _t, order in fields:
        out += struct.pack(">h", order)
    for fname, _t, _o in fields:
        out += struct.pack(">h", len(fname)) + fname.encode()
    out += struct.pack(">h", len(name)) + name.encode()
    out += struct.pack(">h", len(cls)) + cls.encode()
    out += struct.pack(">HHhh", 0, 0, 3, 0)
    return out


def _vg(name: str, cls: str, members: List[Tuple[int, int]]) -> bytes:
    out = struct.pack(">H", len(members))
    for tag, _ in members:
        out += struct.pack(">H", tag)
    for _, ref in members:
        out += struct.pack(">H", ref)
    out += struct.pack(">H", len(name)) + name.encode()
    out += struct.pack(">H", len(cls)) + cls.encode()
    out += struct.pack(">HHHH", 0, 0, 3, 0)
    return out


def encode_hdf4(variables: Dict[str, np.ndarray],
                storage: str = "plain",
                chunk: Optional[Tuple[int, ...]] = None,
                fill_value: Optional[float] = None) -> bytes:
    """Valid HDF4 bytes holding each array as a named SDS.

    storage: "plain" (contiguous), "deflate" (SPECIAL_COMP element),
    or "chunked" (SPECIAL_CHUNKED with deflate chunks; ``chunk``
    defaults to halves of the first variable's shape). For test
    fixtures and round-trip validation."""
    w = _Writer()
    w.add(_VERSION, w.ref(), struct.pack(">III", 4, 2, 15) + b"fixt\0")
    for name, arr in variables.items():
        arr = np.ascontiguousarray(arr)
        code = _DFNT_REV.get(arr.dtype.name)
        if code is None:
            raise ValueError(f"HDF4 cannot hold dtype {arr.dtype}")
        be = arr.astype(arr.dtype.newbyteorder(">"))
        nt_ref = w.add(_NT, w.ref(), bytes(
            [1, code, arr.dtype.itemsize * 8, 0]))
        rank = arr.ndim
        sdd = struct.pack(">H", rank)
        sdd += struct.pack(f">{rank}i", *arr.shape)
        sdd += struct.pack(">HH", _NT, nt_ref)
        for _ in range(rank):
            sdd += struct.pack(">HH", _NT, nt_ref)
        sdd_ref = w.add(_SDD, w.ref(), sdd)
        sd_ref = w.ref()
        if storage == "plain":
            w.add(_SD, sd_ref, be.tobytes())
        elif storage == "deflate":
            _add_comp(w, _SD, sd_ref, be.tobytes())
        elif storage == "chunked":
            _add_chunked(w, sd_ref, be, chunk)
        else:
            raise ValueError(f"unknown storage {storage!r}")
        ndg_ref = w.add(_NDG, w.ref(),
                        struct.pack(">HHHH", _SDD, sdd_ref, _SD,
                                    sd_ref))
        members = [(_NDG, ndg_ref)]
        if fill_value is not None:
            # attach only where the value is representable in the
            # variable's own dtype (the attr shares the SDS type)
            with np.errstate(over="ignore", invalid="ignore"):
                rep = np.clip(
                    np.array([fill_value], np.float64),
                    *((np.iinfo(be.dtype).min, np.iinfo(be.dtype).max)
                      if np.issubdtype(be.dtype, np.integer)
                      else (-np.inf, np.inf))).astype(be.dtype)
            if float(rep[0]) == float(fill_value):
                aref = w.ref()
                w.add(_VH, aref, _vh("_FillValue", "Attr0.0",
                                     [("VALUES", code, 1)], 1))
                w.add(_VS, aref, rep.tobytes())
                members.append((_VH, aref))
        w.add(_VG, w.ref(), _vg(name, "Var0.0", members))
    return w.tobytes()


def _add_comp(w: _Writer, tag: int, ref: int, raw: bytes) -> None:
    cref = w.ref()
    w.add(_COMPRESSED, cref, zlib.compress(raw, 6))
    hdr = struct.pack(">hHiHHH", _SPECIAL_COMP, 0, len(raw), cref, 0,
                      _COMP_DEFLATE)
    w.add(tag | _EXT, ref, hdr)


def _add_chunked(w: _Writer, sd_ref: int, be: np.ndarray,
                 chunk: Optional[Tuple[int, ...]]) -> None:
    dims = list(be.shape)
    if chunk is None:
        chunk = tuple(max(1, d // 2) for d in dims)
    chunk = list(chunk)
    nchunk = [-(-d // c) for d, c in zip(dims, chunk)]
    itemsize = be.dtype.itemsize
    # chunk table VData: origin (int32 x ndims) + chk_tag + chk_ref
    recs = []
    for idx in np.ndindex(*nchunk):
        sl = tuple(slice(i * c, (i + 1) * c)
                   for i, c in zip(idx, chunk))
        block = np.zeros(chunk, be.dtype)
        piece = be[sl]
        block[tuple(slice(0, s) for s in piece.shape)] = piece
        cref = w.ref()
        _add_comp(w, _CHUNK, cref, block.tobytes())
        recs.append((idx, _CHUNK, cref))
    tref = w.ref()
    w.add(_VH, tref, _vh("_HDF_CHK_TBL_0", "_HDF_CHK_TBL_",
                         [("origin", 24, len(dims)),
                          ("chk_tag", 23, 1), ("chk_ref", 23, 1)],
                         len(recs)))
    body = b""
    for idx, ctag, cref in recs:
        body += struct.pack(f">{len(dims)}i", *idx)
        body += struct.pack(">HH", ctag, cref)
    w.add(_VS, tref, body)
    hdr = struct.pack(">hBiiiiHH", _SPECIAL_CHUNKED, 0, 0,
                      int(be.size) * itemsize,
                      int(np.prod(chunk)) * itemsize, itemsize,
                      _VH, tref)
    hdr += struct.pack(">HH", 0, 0)
    hdr += struct.pack(">i", len(dims))
    for d, c in zip(dims, chunk):
        hdr += struct.pack(">iii", 0, d, c)
    w.add(_SD | _EXT, sd_ref, hdr)
