"""NetCDF classic (CDF-1 / CDF-2 / CDF-5) decoder.

A copy of the JAX package's ``raster/netcdf.py``: the classic format
from the spec (magic ``CDF\\x01|\\x02|\\x05``): header (dims, global
attrs, variables with attrs), fixed-size and record variables, all
twelve external types, 64-bit offsets (CDF-2) and 64-bit sizes (CDF-5).
NetCDF-4 files are HDF5 containers, which ``raster/hdf5.py`` decodes.

Decode-only; ``scipy.io.netcdf_file`` writes the fixtures. Georeferencing
follows CF: 1-D coordinate variables along the x/y dims -> geotransform
(pixel-centre to corner shift), ``grid_mapping`` variable -> EPSG/WKT
(``raster/cf.py``).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import cf
from .geotiff import GeoTIFF, RasterInfo

__all__ = ["is_netcdf_classic", "decode_netcdf", "sniff_netcdf_info",
           "netcdf_variables"]

_NC_DIMENSION = 0x0A
_NC_VARIABLE = 0x0B
_NC_ATTRIBUTE = 0x0C

# nc_type -> (numpy big-endian dtype, external size)
_TYPES = {
    1: (">i1", 1), 2: ("S1", 1), 3: (">i2", 2), 4: (">i4", 4),
    5: (">f4", 4), 6: (">f8", 8),
    # CDF-5 additions
    7: (">u1", 1), 8: (">u2", 2), 9: (">u4", 4), 10: (">i8", 8),
    11: (">u8", 8),
}


def is_netcdf_classic(data: bytes) -> bool:
    return data[:3] == b"CDF" and data[3:4] in (b"\x01", b"\x02", b"\x05")


class _Reader:
    """Cursor over the classic header. CDF-5 widens every NON_NEG
    size field to 8 bytes (dimension lengths, element counts, vsize);
    CDF-2 widens only the variable ``begin`` offsets."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 4
        self.version = data[3]
        self.wide = self.version == 5  # CDF-5: 64-bit sizes

    def u4(self) -> int:
        (v,) = struct.unpack_from(">I", self.data, self.pos)
        self.pos += 4
        return v

    def u8(self) -> int:
        (v,) = struct.unpack_from(">Q", self.data, self.pos)
        self.pos += 8
        return v

    def size(self) -> int:
        return self.u8() if self.wide else self.u4()

    def offset(self) -> int:
        return self.u8() if self.version >= 2 else self.u4()

    def name(self) -> str:
        n = self.size()
        s = self.data[self.pos:self.pos + n].decode("utf-8")
        self.pos += (n + 3) & ~3  # names pad to 4-byte boundaries
        return s

    def values(self, nc_type: int, n: int):
        dt, sz = _TYPES[nc_type]
        raw = self.data[self.pos:self.pos + n * sz]
        self.pos += (n * sz + 3) & ~3  # values pad to 4
        if nc_type == 2:
            return raw  # NC_CHAR attr -> bytes
        return np.frombuffer(raw, dtype=dt, count=n)

    def att_list(self) -> Dict[str, object]:
        tag = self.u4()
        n = self.size()
        if tag == 0:  # ABSENT
            return {}
        if tag != _NC_ATTRIBUTE:
            raise ValueError(f"corrupt netCDF header: bad att tag {tag}")
        out: Dict[str, object] = {}
        for _ in range(n):
            name = self.name()
            nc_type = self.u4()
            count = self.size()
            out[name] = self.values(nc_type, count)
        return out


class _Var:
    def __init__(self, name, dimids, attrs, nc_type, vsize, begin):
        self.name = name
        self.dimids = dimids
        self.attrs = attrs
        self.nc_type = nc_type
        self.vsize = vsize
        self.begin = begin


class _File:
    """Parsed classic-format file: header + lazy variable reads."""

    def __init__(self, data: bytes):
        if not is_netcdf_classic(data):
            raise ValueError("not a classic netCDF file")
        r = _Reader(data)
        self.data = data
        streaming = (1 << (64 if r.wide else 32)) - 1
        self.numrecs = r.size()
        if self.numrecs == streaming:
            self.numrecs = None  # STREAMING: infer from file size
        # dim_list
        tag = r.u4()
        n = r.size()
        self.dim_names: List[str] = []
        self.dim_sizes: List[int] = []
        if tag == _NC_DIMENSION:
            for _ in range(n):
                self.dim_names.append(r.name())
                self.dim_sizes.append(r.size())
        elif tag != 0:
            raise ValueError(f"corrupt netCDF header: bad dim tag {tag}")
        self.rec_dim = (self.dim_sizes.index(0)
                        if 0 in self.dim_sizes else -1)
        self.attrs = r.att_list()
        # var_list
        tag = r.u4()
        n = r.size()
        self.vars: Dict[str, _Var] = {}
        if tag == _NC_VARIABLE:
            for _ in range(n):
                name = r.name()
                ndims = r.size()
                dimids = [r.u4() for _ in range(ndims)]
                attrs = r.att_list()
                nc_type = r.u4()
                vsize = r.size()
                begin = r.offset()
                self.vars[name] = _Var(name, dimids, attrs, nc_type,
                                       vsize, begin)
        elif tag != 0:
            raise ValueError(f"corrupt netCDF header: bad var tag {tag}")
        self._infer_numrecs()

    def _record_vars(self) -> List[_Var]:
        return [v for v in self.vars.values()
                if v.dimids and v.dimids[0] == self.rec_dim]

    def _rec_stride(self) -> int:
        rec = self._record_vars()
        if len(rec) == 1:
            # single record variable packs contiguously, no per-record
            # padding (classic-format spec "note on vsize")
            v = rec[0]
            dt, sz = _TYPES[v.nc_type]
            per = sz
            for d in v.dimids[1:]:
                per *= self.dim_sizes[d]
            return per
        return sum(v.vsize for v in rec)

    def _infer_numrecs(self):
        if self.numrecs is not None or self.rec_dim < 0:
            self.numrecs = self.numrecs or 0
            return
        rec = self._record_vars()
        if not rec:
            self.numrecs = 0
            return
        start = min(v.begin for v in rec)
        self.numrecs = (len(self.data) - start) // self._rec_stride()

    def shape(self, v: _Var) -> Tuple[int, ...]:
        return tuple(self.numrecs if d == self.rec_dim
                     else self.dim_sizes[d] for d in v.dimids)

    def read(self, name: str) -> np.ndarray:
        v = self.vars[name]
        dt, sz = _TYPES[v.nc_type]
        shape = self.shape(v)
        if v.dimids and v.dimids[0] == self.rec_dim:
            stride = self._rec_stride()
            per = int(np.prod(shape[1:], dtype=np.int64)) * sz
            out = np.empty(shape, dtype=dt)
            flat = out.reshape(shape[0], -1)
            for r in range(shape[0]):
                off = v.begin + r * stride
                flat[r] = np.frombuffer(
                    self.data[off:off + per], dtype=dt)
            arr = out
        else:
            count = int(np.prod(shape, dtype=np.int64)) if shape else 1
            arr = np.frombuffer(
                self.data[v.begin:v.begin + count * sz],
                dtype=dt, count=count).reshape(shape)
        if arr.dtype.kind != "S":
            arr = arr.astype(arr.dtype.newbyteorder("="))
        return arr


def netcdf_variables(data: bytes) -> Dict[str, Tuple[int, ...]]:
    """name -> shape for every variable (inspection helper)."""
    f = _File(data)
    return {name: f.shape(v) for name, v in f.vars.items()}


def _is_coord_var(f: _File, v: _Var) -> bool:
    """A CF coordinate variable: 1-D, named after its own dimension,
    or carrying axis-identifying attrs."""
    if len(v.dimids) != 1:
        return False
    if v.name == f.dim_names[v.dimids[0]]:
        return True
    return (cf.is_x_coordinate(v.name, v.attrs)
            or cf.is_y_coordinate(v.name, v.attrs))


def _pick_variable(f: _File, variable: Optional[str]) -> _Var:
    if variable is not None:
        if variable not in f.vars:
            raise ValueError(
                f"netCDF variable {variable!r} not found; file has: "
                f"{sorted(f.vars)}")
        return f.vars[variable]
    best = None
    best_px = -1
    for v in f.vars.values():
        if v.nc_type == 2 or _is_coord_var(f, v):
            continue
        shape = f.shape(v)
        if len(shape) < 2:
            continue
        px = shape[-1] * shape[-2]
        if px > best_px:
            best, best_px = v, px
    if best is None:
        raise ValueError(
            "no 2-D+ raster variable in netCDF file; variables: "
            + str({n: f.shape(v) for n, v in f.vars.items()}))
    return best


def _coord_for_dim(f: _File, dimid: int, want_x: bool
                   ) -> Optional[np.ndarray]:
    dim_name = f.dim_names[dimid]
    match = None
    for v in f.vars.values():
        if len(v.dimids) != 1 or v.dimids[0] != dimid or v.nc_type == 2:
            continue
        ok = (cf.is_x_coordinate(v.name, v.attrs) if want_x
              else cf.is_y_coordinate(v.name, v.attrs))
        if ok:
            return f.read(v.name)
        if v.name == dim_name:
            match = v
    return f.read(match.name) if match is not None else None


def _georeference(f: _File, v: _Var, info: RasterInfo) -> None:
    if len(v.dimids) < 2:
        return
    ydim, xdim = v.dimids[-2], v.dimids[-1]
    x = _coord_for_dim(f, xdim, want_x=True)
    y = _coord_for_dim(f, ydim, want_x=False)
    info.geotransform = cf.geotransform_from_coords(x, y)
    gm_name = v.attrs.get("grid_mapping")
    gm_attrs = None
    if gm_name is not None:
        gm = f.vars.get(cf._text(gm_name))
        if gm is not None:
            gm_attrs = gm.attrs
    if gm_attrs is None:
        # no grid_mapping: bare lon/lat coordinate axes imply WGS84
        # (GDAL's netCDF driver default)
        for cand in f.vars.values():
            if (len(cand.dimids) == 1 and cand.dimids[0] == xdim
                    and cf._text(cand.attrs.get("units", b"")).lower()
                    .startswith("degrees")):
                info.epsg = 4326
                return
        return
    info.epsg, info.wkt = cf.epsg_from_grid_mapping(gm_attrs)


def _nodata(v: _Var) -> Optional[float]:
    for key in ("_FillValue", "missing_value"):
        val = v.attrs.get(key)
        if val is not None and not isinstance(val, bytes):
            return float(np.asarray(val).ravel()[0])
    return None


def decode_netcdf(data: bytes, variable: Optional[str] = None) -> GeoTIFF:
    """Classic netCDF bytes -> bands-last GeoTIFF container.

    ``variable`` picks the raster variable; default = the non-coordinate
    variable with the most pixels (GDAL exposes each as a subdataset;
    a single default keeps the universal ``decode_image_bytes``
    signature). Dim order per CF is (..., y, x); leading dims (time,
    band, level) flatten into bands, bands-last like every other codec.
    Values are raw (scale_factor/add_offset stay metadata, matching
    rasterio's default read)."""
    f = _File(data)
    v = _pick_variable(f, variable)
    arr = f.read(v.name)
    if arr.ndim < 2:
        raise ValueError(f"netCDF variable {v.name!r} is not a raster "
                         f"(shape {arr.shape})")
    h, w = arr.shape[-2], arr.shape[-1]
    arr = arr.reshape(-1, h, w).transpose(1, 2, 0)
    info = RasterInfo(width=w, height=h, count=arr.shape[2],
                      dtype=arr.dtype.name, nodata=_nodata(v))
    _georeference(f, v, info)
    return GeoTIFF(np.ascontiguousarray(arr), info)


def sniff_netcdf_info(data: bytes, variable: Optional[str] = None
                      ) -> RasterInfo:
    """Header-only shape/geo sniff (the classic header IS cheap to
    parse; pixel data is never touched — coordinate reads for the
    geotransform are 1-D)."""
    f = _File(data)
    v = _pick_variable(f, variable)
    shape = f.shape(v)
    h, w = shape[-2], shape[-1]
    count = 1
    for s in shape[:-2]:
        count *= s
    dt, _ = _TYPES[v.nc_type]
    info = RasterInfo(width=w, height=h, count=count,
                      dtype=np.dtype(dt).newbyteorder("=").name,
                      nodata=_nodata(v))
    _georeference(f, v, info)
    return info
