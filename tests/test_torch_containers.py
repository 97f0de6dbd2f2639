"""The port's scientific raster containers (NetCDF classic, GRIB 1 and 2,
VRT, ENVI, HDF4, NITF, GeoPackage rasters, HDF5 / NetCDF-4) against the
JAX package, on the CPU.

* Every decode and sniff that the JAX package's own container tests
  (``tests/test_scientific_formats.py``, ``test_nitf.py``,
  ``test_gpkg_raster.py``) make is replayed through the port on the same
  bytes and arguments: arrays, dtypes and georeferencing bitwise equal,
  or the same error with the same message (for HDF5, a corrupt-file
  error up to its ``;``: the port's reader is not libhdf5).
* Fixtures written by each package's encoders decode bitwise equal in
  both packages; the encoders' bytes are equal wherever no PNG or JPEG
  2000 codestream is embedded (ENVI, HDF4, NITF NC, GRIB simple, complex
  and spatial-differencing packing), and where one is (GRIB png/jp2,
  NITF C8, GeoPackage tiles) each package decodes the other's file to
  the same array.
* The three faults of the JAX package that the port does not carry.
* ``base_dir`` and ``origin`` through the MP engine and ``convert``,
  LocalCatalog scenes of per-band container files, and request bodies.
"""

import dataclasses
import importlib
import inspect
import io
import itertools
import json
import math
import os
import sqlite3
import threading
import tracemalloc
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from dl_image_segmentation_tpu.catalog.local import (
    LocalCatalog as JLocalCatalog)
from dl_image_segmentation_tpu.geo import Tile as JTile
from dl_image_segmentation_tpu.pipeline.convert import (
    convert_chip_folder as j_convert)
from dl_image_segmentation_tpu.raster import envi as jenvi
from dl_image_segmentation_tpu.raster import gpkg_raster as jgpkg
from dl_image_segmentation_tpu.raster import grib as jgrib
from dl_image_segmentation_tpu.raster import hdf4 as jhdf4
from dl_image_segmentation_tpu.raster import image as jimage
from dl_image_segmentation_tpu.raster import nitf as jnitf
from dl_image_segmentation_tpu.records.writers import (
    process_dataset_mp as j_mp)
from dl_image_segmentation_tpu_torch.catalog import LocalCatalog
from dl_image_segmentation_tpu_torch.geo import Tile as TTile
from dl_image_segmentation_tpu_torch.pipeline.convert import (
    convert_chip_folder as t_convert)
from dl_image_segmentation_tpu_torch.raster import envi as tenvi
from dl_image_segmentation_tpu_torch.raster import gpkg_raster as tgpkg
from dl_image_segmentation_tpu_torch.raster import grib as tgrib
from dl_image_segmentation_tpu_torch.raster import hdf4 as thdf4
from dl_image_segmentation_tpu_torch.raster import hdf5 as thdf5
from dl_image_segmentation_tpu_torch.raster import image as timage
from dl_image_segmentation_tpu_torch.raster import nitf as tnitf
from dl_image_segmentation_tpu_torch.raster.geotiff import encode_geotiff
from dl_image_segmentation_tpu_torch.records.writers import (
    process_dataset_mp as t_mp)

# one intra-op thread: the test workers share the host's cores
torch.set_num_threads(1)

GT = (300000.0, 10.0, 0.0, 2110000.0, 0.0, -10.0)  # zone 43, integer m


def info_key(info):
    """A RasterInfo's fields, NaN nodata made comparable."""
    d = dataclasses.asdict(info)
    if isinstance(d["nodata"], float) and math.isnan(d["nodata"]):
        d["nodata"] = "nan"
    return d


def same_raster(got, want):
    assert got.array.dtype == want.array.dtype
    assert got.array.shape == want.array.shape
    assert got.array.tobytes() == want.array.tobytes()
    assert info_key(got.info) == info_key(want.info)


def scipy_nc(build, version=1):
    buf = io.BytesIO()
    f = netcdf_file(buf, "w", version=version)
    build(f)
    f.flush()
    return buf.getvalue()


# ---------------------------------------------------------------------------
# the JAX package's own container tests, replayed through the port
# ---------------------------------------------------------------------------

J_MODULES = ("image", "netcdf", "grib", "hdf4", "hdf5", "envi", "vrt",
             "nitf", "gpkg_raster")
_REPLAY = threading.local()


def _same_error(got, want):
    """The same error: for HDF5's corrupt-file errors, up to the ``;``
    (what follows is libhdf5's text in the JAX package)."""
    g, w = (type(got).__name__, str(got)), (type(want).__name__, str(want))
    if w[1].startswith("corrupt or unreadable HDF5 container;"):
        return g[0] == w[0] and g[1].split(";")[0] == w[1].split(";")[0]
    return g == w


def _same_result(got, want):
    if hasattr(want, "array"):
        same_raster(got, want)
    elif dataclasses.is_dataclass(want):
        assert info_key(got) == info_key(want)
    else:
        assert got == want


def _port_twin(fn):
    mod = importlib.import_module(fn.__module__.replace(
        "dl_image_segmentation_tpu.", "dl_image_segmentation_tpu_torch.", 1))
    return getattr(mod, fn.__name__)


def _recorder(fn, log):
    twin = _port_twin(fn)

    def call(*args, **kwargs):
        if getattr(_REPLAY, "depth", 0):  # a call inside a recorded call
            return fn(*args, **kwargs)
        _REPLAY.depth = 1
        try:
            want, err = fn(*args, **kwargs), None
        except Exception as e:  # noqa: BLE001 (compared below)
            want, err = None, e
        finally:
            _REPLAY.depth = 0
        try:
            got = twin(*args, **kwargs)
        except Exception as e:  # noqa: BLE001
            if err is None or not _same_error(e, err):
                log.append((fn.__name__, "port raised", repr(e), repr(err)))
        else:
            if err is not None:
                log.append((fn.__name__, "port decoded", repr(err)))
            else:
                try:
                    _same_result(got, want)
                except AssertionError as e:
                    log.append((fn.__name__, "differs", str(e)[:200]))
        log.append(fn.__name__)
        if err is not None:
            raise err
        return want
    return call


def _param_sets(method):
    marks = [m for m in getattr(method, "pytestmark", [])
             if m.name == "parametrize"]
    names, values = [], []
    for m in marks:
        argnames = m.args[0]
        argnames = ([a.strip() for a in argnames.split(",")]
                    if isinstance(argnames, str) else list(argnames))
        vals = [v if len(argnames) > 1 else (v,) for v in m.args[1]]
        names.append(argnames)
        values.append(vals)
    for combo in itertools.product(*values):
        yield {k: v for ns, vs in zip(names, combo) for k, v in zip(ns, vs)}


REPLAYED = [("tests.test_scientific_formats", c) for c in (
    "TestNetCDFClassic", "TestGRIB2", "TestGRIB1", "TestHDF4", "TestHDF5",
    "TestENVI", "TestVRT", "TestDispatchAndPipeline")] + [
    ("tests.test_nitf", c) for c in ("TestRoundTrip", "TestGeoref",
                                     "TestUniversal")] + [
    ("tests.test_gpkg_raster", c) for c in ("TestRoundTrip", "TestGeo",
                                            "TestUniversal")]


@pytest.mark.parametrize("module,cls", REPLAYED)
def test_jax_fixtures_replayed(module, cls, tmp_path_factory, monkeypatch):
    """Each decode_* / sniff_* / *_variables call of the JAX package's
    container tests (shard writers aside, which call the decode through
    the JAX writer's own import) gives the same result or the same error
    in the port, HDF5 bytes included (the port's own reader)."""
    log = []
    tests = importlib.import_module(module)
    patched = {}
    for name in J_MODULES:
        mod = importlib.import_module(f"dl_image_segmentation_tpu.raster."
                                      f"{name}")
        for attr, fn in list(vars(mod).items()):
            if (callable(fn) and getattr(fn, "__module__", "") == mod.__name__
                    and (attr.startswith(("decode_", "sniff_"))
                         or attr.endswith("_variables"))):
                rec = patched.setdefault(id(fn), _recorder(fn, log))
                monkeypatch.setattr(mod, attr, rec)
    for attr, fn in list(vars(tests).items()):
        if id(fn) in patched:
            monkeypatch.setattr(tests, attr, patched[id(fn)])
    klass = getattr(tests, cls)
    ran = 0
    for name, method in inspect.getmembers(klass, inspect.isfunction):
        if not name.startswith("test_") or "tfrecords" in name \
                or "writer" in name:
            continue
        for params in _param_sets(method):
            kwargs = dict(params)
            if "tmp_path" in inspect.signature(method).parameters:
                kwargs["tmp_path"] = tmp_path_factory.mktemp(name[:20])
            method(klass(), **kwargs)
            ran += 1
    calls = [x for x in log if isinstance(x, str)]
    faults = [x for x in log if not isinstance(x, str)]
    assert ran and calls, (ran, len(calls))
    assert not faults, faults[:5]


# ---------------------------------------------------------------------------
# fixtures from each package's encoders
# ---------------------------------------------------------------------------

class Pkg:
    def __init__(self, grib, hdf4, nitf, gpkg, envi):
        self.grib, self.hdf4, self.nitf, self.gpkg, self.envi = (
            grib, hdf4, nitf, gpkg, envi)


JPKG = Pkg(jgrib, jhdf4, jnitf, jgpkg, jenvi)
TPKG = Pkg(tgrib, thdf4, tnitf, tgpkg, tenvi)


def _field(seed, h=23, w=19, hi=4000):
    return np.random.RandomState(seed).randint(0, hi, (h, w)).astype(
        np.float64)


def _mask(seed, shape):
    return np.random.RandomState(seed).rand(*shape) > 0.25


def _ints(seed, shape, dtype):
    rng = np.random.RandomState(seed)
    if np.dtype(dtype).kind == "f":
        return (rng.randn(*shape) * 100).astype(dtype)
    info = np.iinfo(dtype)
    return rng.randint(max(info.min, -30000), min(info.max, 60000) + 1,
                       shape).astype(dtype)


def _grib2(packing, masked=False, dec=0):
    def build(p):
        f = _field(1) / 10.0 ** dec
        m = _mask(2, f.shape) if masked else None
        return p.grib.encode_grib2(f, 19.25, 72.5, 0.05, 0.04, nbits=12,
                                   dec_scale=dec, packing=packing, mask=m)
    return build


def _grib1(masked=False, dec=0):
    def build(p):
        f = _field(3) / 10.0 ** dec
        m = _mask(4, f.shape) if masked else None
        return p.grib.encode_grib1(f, -33.5, 150.25, 0.125, 0.25, nbits=12,
                                   dec_scale=dec, mask=m)
    return build


def _grib_multi(p):
    return (p.grib.encode_grib2(_field(5), 10.0, 20.0, 0.5, 0.5,
                                packing="simple")
            + p.grib.encode_grib2(_field(6), 10.0, 20.0, 0.5, 0.5,
                                  packing="complex-sd2"))


def _hdf4(storage, dtype, fill=None):
    def build(p):
        a = _ints(7, (3, 21, 17), dtype)
        return p.hdf4.encode_hdf4({"small": a[0, :4, :5], "cube": a},
                                  storage=storage, fill_value=fill)
    return build


def _envi(interleave, order, dtype, epsg):
    def build(p):
        hdr, data = p.envi.encode_envi(
            _ints(8, (19, 23, 3), dtype), interleave=interleave,
            geotransform=GT if epsg == 32643 else (
                (72.0, 0.01, 0.0, 19.5, 0.0, -0.01) if epsg else None),
            epsg=epsg, nodata=0.0 if dtype != "uint8" else None,
            byte_order=order)
        return hdr + b"\x00SPLIT\x00" + data
    return build


def _nitf(imode, bs, dtype, geo, compression="NC", bands=3):
    def build(p):
        a = _ints(9, (37, 29, bands), dtype)
        return p.nitf.encode_nitf(
            a, imode=imode, block_size=bs, compression=compression,
            geotransform=GT if geo else None, epsg=32643 if geo else None)
    return build


def _gpkg(bands, dtype, tile):
    def build(p):
        a = _ints(10, (45, 70, bands), dtype)
        return p.gpkg.encode_gpkg(a, tile_size=tile, geotransform=GT,
                                  epsg=32643)
    return build


def _netcdf_utm(p=None):
    def build(f):
        f.createDimension("y", 21)
        f.createDimension("x", 17)
        y = f.createVariable("y", "d", ("y",))
        y[:] = GT[3] - 5.0 - 10.0 * np.arange(21)
        y.standard_name = b"projection_y_coordinate"
        x = f.createVariable("x", "d", ("x",))
        x[:] = GT[0] + 5.0 + 10.0 * np.arange(17)
        x.standard_name = b"projection_x_coordinate"
        crs = f.createVariable("crs", "i", ())
        crs.grid_mapping_name = b"transverse_mercator"
        # float64 arrays: scipy stores a bare float as float32
        crs.scale_factor_at_central_meridian = np.array([0.9996])
        crs.longitude_of_central_meridian = np.array([75.0])
        crs.false_easting = np.array([500000.0])
        crs.false_northing = np.array([0.0])
        v = f.createVariable("band", "h", ("y", "x"))
        v[:] = _ints(11, (21, 17), "int16")
        v.grid_mapping = b"crs"
        v._FillValue = np.int16(-9999)
    return scipy_nc(build)


def _netcdf_bands(p=None):
    def build(f):
        f.createDimension("time", None)
        f.createDimension("lat", 12)
        f.createDimension("lon", 15)
        lat = f.createVariable("lat", "f", ("lat",))
        lat[:] = 50.0 - 0.25 * np.arange(12)
        lat.units = b"degrees_north"
        lon = f.createVariable("lon", "f", ("lon",))
        lon[:] = 8.0 + 0.25 * np.arange(15)
        lon.units = b"degrees_east"
        v = f.createVariable("t2m", "f", ("time", "lat", "lon"))
        v[:] = _ints(12, (4, 12, 15), "float32")
        v.missing_value = np.float32(-1.0e30)
        q = f.createVariable("q", "b", ("time", "lat", "lon"))
        q[:] = _ints(13, (4, 12, 15), "int8")
    return scipy_nc(build, version=2)


CASES = {
    **{f"grib2-{k}": _grib2(k) for k in (
        "simple", "complex", "complex-sd1", "complex-sd2", "png", "jp2")},
    **{f"grib2-{k}-bitmap": _grib2(k, masked=True, dec=1) for k in (
        "simple", "complex", "png")},
    "grib2-multi": _grib_multi,
    "grib1": _grib1(), "grib1-bitmap": _grib1(masked=True, dec=1),
    **{f"hdf4-{s}-{d}": _hdf4(s, d, f) for s, d, f in (
        ("plain", "uint16", 0.0), ("deflate", "int16", -1.0),
        ("chunked", "float32", None), ("chunked", "uint8", 255.0))},
    **{f"envi-{i}-{o}-{d}-{e}": _envi(i, o, d, e) for i, o, d, e in (
        ("bsq", 0, "uint16", 32643), ("bil", 1, "int16", 4326),
        ("bip", 0, "float32", None), ("bsq", 1, "uint8", 32643))},
    **{f"nitf-{m}-{b}-{d}-{g}": _nitf(m, b, d, g) for m, b, d, g in (
        ("B", None, "uint16", True), ("P", 16, "uint8", False),
        ("S", 16, "int16", True), ("B", 8, "float32", False))},
    "nitf-C8-uint8": _nitf("B", None, "uint8", True, "C8"),
    "nitf-C8-uint16": _nitf("B", None, "uint16", False, "C8", bands=1),
    **{f"gpkg-{b}-{d}-{t}": _gpkg(b, d, t) for b, d, t in (
        (1, "uint8", 32), (3, "uint8", 64), (1, "uint16", 32))},
    "netcdf-utm": _netcdf_utm, "netcdf-bands": _netcdf_bands,
}
# the bytes of these embed a PNG or JPEG 2000 codestream, which the
# port's own codecs write (the JAX package's come from PIL)
EMBEDS = {"grib2-png", "grib2-jp2", "grib2-png-bitmap", "nitf-C8-uint8",
          "nitf-C8-uint16"} | {k for k in CASES if k.startswith("gpkg")}


def _decode_both(data):
    """(port decode, JAX decode) of fixture bytes; an ENVI fixture is
    its header and data file joined by a marker."""
    if b"\x00SPLIT\x00" in data:
        hdr, body = data.split(b"\x00SPLIT\x00")
        return (tenvi.decode_envi(hdr, data=body),
                jenvi.decode_envi(hdr, data=body))
    return timage.decode_image_bytes(data), jimage.decode_image_bytes(data)


def _sniff_both(data):
    data = data.split(b"\x00SPLIT\x00")[0]
    return timage.sniff_image_info(data), jimage.sniff_image_info(data)


def test_netcdf_utm_grid_mapping():
    g = timage.decode_image_bytes(_netcdf_utm())
    assert (g.info.epsg, g.info.geotransform, g.info.nodata) == (
        32643, GT, -9999.0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_and_sniff_equal(case):
    """Decode and sniff of the JAX encoder's and the port encoder's
    fixture: bitwise equal in the two packages, and the port's sniff
    agrees with its decode."""
    for pkg in (JPKG, TPKG):
        data = CASES[case](pkg)
        got, want = _decode_both(data)
        same_raster(got, want)
        ts, js = _sniff_both(data)
        assert info_key(ts) == info_key(js)
        a = got.array
        assert (ts.height, ts.width, ts.count, ts.dtype) == (
            a.shape[0], a.shape[1], a.shape[2], a.dtype.name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_encoder_bytes(case):
    """Byte-equal encoders where no PNG or JPEG 2000 codestream is
    embedded; else each package decodes the other's file to the same
    array."""
    jb, tb = CASES[case](JPKG), CASES[case](TPKG)
    if case not in EMBEDS:
        assert tb == jb
        return
    assert tb != jb
    for data in (jb, tb):
        got, want = _decode_both(data)
        same_raster(got, want)
    same_raster(_decode_both(tb)[0], _decode_both(jb)[1])


# ---------------------------------------------------------------------------
# the dispatch: HDF5, unknown containers, multi-file containers
# ---------------------------------------------------------------------------

def test_hdf5_names_item_13_and_unknown_matches_the_jax_message():
    """Named for the item-13 raise it pinned until HDF5 was ported: bytes
    that are only an HDF5 signature, at 0 or after a userblock, fail in
    both packages as a corrupt HDF5 container (compared up to the ``;``,
    after which the JAX package gives libhdf5's text); unknown bytes
    fail with the JAX package's message."""
    hdf5 = b"\x89HDF\r\n\x1a\n" + bytes(64)
    userblock = bytes(512) + hdf5
    for data in (hdf5, userblock):
        assert thdf5.is_hdf5(data)
        for name in ("decode_image_bytes", "sniff_image_info"):
            errs = []
            for mod in (timage, jimage):
                with pytest.raises(mod.CorruptRasterError) as e:
                    getattr(mod, name)(data)
                errs.append(str(e.value).split(";")[0])
            assert errs[0] == errs[1] == (
                "corrupt or unreadable HDF5 container")
    for data in (b"not an image", b"\x00\x01\x02\x03" * 8):
        errs = []
        for mod in (timage, jimage):
            with pytest.raises(mod.UnsupportedFormatError) as e:
                mod.decode_image_bytes(data)
            errs.append(str(e.value))
        assert errs[0] == errs[1]


def _vrt_xml(source, relative):
    return f"""<VRTDataset rasterXSize="17" rasterYSize="21">
  <SRS>EPSG:32643</SRS>
  <GeoTransform>{", ".join(map(repr, GT))}</GeoTransform>
  <VRTRasterBand dataType="UInt16" band="1">
    <NoDataValue>0</NoDataValue>
    <ComplexSource>
      <SourceFilename relativeToVRT="{int(relative)}">{source}</SourceFilename>
      <SourceBand>2</SourceBand>
      <SrcRect xOff="1" yOff="2" xSize="15" ySize="18"/>
      <DstRect xOff="0" yOff="0" xSize="17" ySize="21"/>
      <ScaleRatio>2</ScaleRatio>
      <NODATA>7</NODATA>
    </ComplexSource>
  </VRTRasterBand>
</VRTDataset>""".encode()


def _write_multi_file(folder, kind, name, arr):
    """A chip of ``kind`` (envi or vrt) named ``name`` under ``folder``;
    returns the path of the file that names the chip."""
    if kind == "envi":
        hdr, data = tenvi.encode_envi(arr, geotransform=GT, epsg=32643)
        with open(os.path.join(folder, name + ".img"), "wb") as f:
            f.write(data)
        path = os.path.join(folder, name + ".hdr")
        with open(path, "wb") as f:
            f.write(hdr)
        return path
    src = os.path.join(folder, name + "-src.tif")
    with open(src, "wb") as f:
        f.write(encode_geotiff(np.concatenate([arr, arr + 1], axis=2),
                               geotransform=GT, epsg=32643))
    path = os.path.join(folder, name + ".vrt")
    with open(path, "wb") as f:
        f.write(_vrt_xml(name + "-src.tif", True))
    return path


@pytest.mark.parametrize("kind", ["envi", "vrt"])
def test_base_dir_and_origin(kind, tmp_path):
    """ENVI headers and relativeToVRT VRTs decode from a path through
    ``decode_image_bytes(base_dir=, origin=)``, the MP engine (shards
    byte for byte the JAX engine's) and ``convert``; from bare bytes
    they fail in both packages with the same message."""
    chips = tmp_path / "chips"
    for sub in ("images", "labels"):
        (chips / sub).mkdir(parents=True)
    ext = "hdr" if kind == "envi" else "vrt"
    rng = np.random.RandomState(14)
    for i in range(3):
        img = rng.randint(1, 200, (21, 17, 1)).astype(np.uint16)
        path = _write_multi_file(str(chips / "images"), kind, f"c{i}", img)
        _write_multi_file(str(chips / "labels"), kind, f"c{i}",
                          (img % 3).astype(np.uint16))
    data = open(path, "rb").read()
    got = timage.decode_image_bytes(data, base_dir=os.path.dirname(path),
                                    origin=os.path.basename(path))
    want = jimage.decode_image_bytes(data, base_dir=os.path.dirname(path),
                                     origin=os.path.basename(path))
    same_raster(got, want)
    errs = []
    for mod in (timage, jimage):
        with pytest.raises(mod.CorruptRasterError) as e:
            mod.decode_image_bytes(data)
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    shards = {}
    for name, fn in (("port", t_mp), ("jax", j_mp)):
        out = tmp_path / f"recs-{name}"
        assert fn("c", str(chips), str(out), 1, 1, dltile_from_filename=False,
                  file_ext=ext, store_as_array=True) == 3
        shards[name] = (out / "c-00000-of-00001").read_bytes()
    assert shards["port"] == shards["jax"]
    outs = {}
    for name, fn in (("port", t_convert), ("jax", j_convert)):
        dest = tmp_path / f"conv-{name}"
        fn(str(chips), str(dest), file_ext=ext, to="png", rescale=(0, 255))
        outs[name] = {f: timage.decode_png((dest / "images" / f).read_bytes())
                      for f in sorted(os.listdir(dest / "images"))}
    assert sorted(outs["port"]) == sorted(outs["jax"]) and outs["port"]
    for f in outs["port"]:
        np.testing.assert_array_equal(outs["port"][f], outs["jax"][f])


# ---------------------------------------------------------------------------
# the JAX package's faults, fixed in the port
# ---------------------------------------------------------------------------

def test_nitf_allocation_is_capped():
    """A NITF whose header claims 99,999,999 rows is refused before the
    output is allocated (the JAX package allocates what the header
    says)."""
    data = bytearray(tnitf.encode_nitf(np.zeros((4, 4), np.uint8)))
    hl = int(data[354:360])
    off = hl + tnitf._NROWS_OFF
    data[off:off + 8] = b"99999999"
    with pytest.raises(ValueError, match="NITF image too large"):
        tnitf.decode_nitf(bytes(data))
    with pytest.raises(timage.CorruptRasterError, match="too large"):
        timage.decode_image_bytes(bytes(data))


@pytest.mark.parametrize("imode", ["B", "P", "S"])
def test_nitf_blocks_above_9999_pixels(imode):
    """A block wider than 9,999 pixels is written as NPPBH/NPPBV 0000,
    one block the size of the image, and decodes to its input; the JAX
    package writes 9999 over blocks of the true size, which decode to
    other pixels."""
    a = np.zeros((3, 10001, 2), np.uint8)
    a[1, 5000:5003] = [[7, 8], [9, 10], [11, 12]]
    a[2, -1] = [5, 6]
    data = tnitf.encode_nitf(a, imode=imode)
    assert data.count(b"00000000") >= 1
    np.testing.assert_array_equal(tnitf.decode_nitf(data).array, a)
    np.testing.assert_array_equal(jnitf.decode_nitf(data).array, a)
    small = np.random.RandomState(15).randint(0, 255, (30, 40, 2)).astype(
        np.uint8)
    assert tnitf.encode_nitf(small, imode=imode, block_size=16) == \
        jnitf.encode_nitf(small, imode=imode, block_size=16)
    jdata = jnitf.encode_nitf(a, imode=imode)
    assert not np.array_equal(jnitf.decode_nitf(jdata).array, a)
    with pytest.raises(ValueError, match="whole image"):
        tnitf.encode_nitf(np.zeros((20000, 20000), np.uint8),
                          block_size=10000)


def test_gpkg_table_name_is_quoted():
    """A tiles table whose name holds a double quote: the port quotes
    it as an SQL identifier and decodes the file; the JAX package pastes
    the name into its SQL and fails."""
    a = np.random.RandomState(16).randint(0, 255, (20, 30)).astype(np.uint8)
    data = tgpkg.encode_gpkg(a, table='my "tiles"', tile_size=16,
                             geotransform=GT, epsg=32643)
    g = timage.decode_image_bytes(data)
    np.testing.assert_array_equal(g.array[:20, :30, 0], a)
    assert timage.sniff_image_info(data).width == 32
    with pytest.raises(Exception):
        jgpkg.decode_gpkg(data)


def _sniff_case(case, monkeypatch):
    """Bytes on which the JAX package's sniff disagrees with its decode."""
    a = np.random.RandomState(19).randint(0, 255, (24, 20, 3)).astype(
        np.uint8)
    if case == "nitf-c8-geojp2":  # georeferencing only in the codestream
        real = tnitf.encode_jp2
        monkeypatch.setattr(tnitf, "encode_jp2", lambda x: real(
            x, geotransform=GT, epsg=32643))
        data = tnitf.encode_nitf(a, compression="C8")
        monkeypatch.undo()
        return data
    if case == "gpkg-too-large":
        conn = sqlite3.connect(":memory:")
        conn.deserialize(tgpkg.encode_gpkg(a, tile_size=16))
        conn.execute("UPDATE gpkg_tile_matrix SET matrix_width = 5000")
        conn.commit()
        data = bytes(conn.serialize())
        conn.close()
        return data
    data = bytearray(tnitf.encode_nitf(a))
    sub = int(data[354:360]) + tnitf._NROWS_OFF
    if case == "nitf-too-large":
        data[sub:sub + 8] = b"99999999"
    else:  # "nitf-masked": IC=NM, which the decoder does not read
        ic = data.index(b"0NC", sub) + 1
        data[ic:ic + 2] = b"NM"
    return bytes(data)


@pytest.mark.parametrize("case", ["nitf-c8-geojp2", "nitf-too-large",
                                  "nitf-masked", "gpkg-too-large"])
def test_sniff_reports_what_decode_returns(case, monkeypatch):
    """Where the JAX package's sniff disagrees with its own decode (a C8
    image georeferenced only inside its codestream; a header that the
    decode refuses), the port's sniff reports what its decode returns, or
    raises what it raises."""
    data = _sniff_case(case, monkeypatch)

    def outcome(mod, fn):
        try:
            got = getattr(mod, fn)(data)
        except Exception as e:  # noqa: BLE001 (compared below)
            return str(e)
        return info_key(got if fn == "sniff_image_info" else got.info)

    td, ts = (outcome(timage, f) for f in ("decode_image_bytes",
                                            "sniff_image_info"))
    if isinstance(td, dict):
        assert ts == td
    else:
        assert isinstance(ts, str) and ts.split(";")[-1] == \
            td.split(";")[-1]
    js = outcome(jimage, "sniff_image_info")
    if case == "nitf-too-large":
        # the JAX decode allocates the header's 99,999,999 rows: not run
        assert js["height"] == 99999999 and "too large" in ts
        return
    jd = outcome(jimage, "decode_image_bytes")
    assert js != jd and td == jd


# ---------------------------------------------------------------------------
# LocalCatalog scenes of per-band container files
# ---------------------------------------------------------------------------

TILE = (60, 2, 10.0, 43, -380, 3491)


def _band_file(folder, kind, name, arr, gt, epsg):
    """One band of a scene as a ``kind`` file; returns its path."""
    path = os.path.join(folder, name)
    band = arr[:, :, 0]
    if kind == "geotiff":
        data = encode_geotiff(arr, geotransform=gt, epsg=epsg, nodata=0)
    elif kind in ("vrt-absolute", "vrt-relative"):
        src = path + "-src.tif"
        with open(src, "wb") as f:
            f.write(encode_geotiff(arr, geotransform=gt, epsg=epsg))
        h, w = band.shape
        data = f"""<VRTDataset rasterXSize="{w}" rasterYSize="{h}">
  <SRS>EPSG:{epsg}</SRS>
  <GeoTransform>{", ".join(map(repr, gt))}</GeoTransform>
  <VRTRasterBand dataType="UInt16" band="1">
    <NoDataValue>0</NoDataValue>
    <SimpleSource><SourceFilename relativeToVRT="{int(kind[4] == 'r')}">{
        os.path.basename(src) if kind[4] == 'r' else src}</SourceFilename>
    </SimpleSource>
  </VRTRasterBand>
</VRTDataset>""".encode()
    elif kind == "envi":
        hdr, body = tenvi.encode_envi(arr, geotransform=gt, epsg=epsg,
                                      nodata=0.0)
        with open(path + ".img", "wb") as f:
            f.write(body)
        data = hdr
    elif kind == "netcdf":
        h, w = band.shape

        def build(f):
            f.createDimension("y", h)
            f.createDimension("x", w)
            y = f.createVariable("y", "d", ("y",))
            y[:] = gt[3] + gt[5] * (np.arange(h) + 0.5)
            y.standard_name = b"projection_y_coordinate"
            x = f.createVariable("x", "d", ("x",))
            x[:] = gt[0] + gt[1] * (np.arange(w) + 0.5)
            x.standard_name = b"projection_x_coordinate"
            crs = f.createVariable("crs", "i", ())
            crs.epsg_code = f"EPSG:{epsg}".encode()
            v = f.createVariable("band", "h", ("y", "x"))
            v[:] = band.astype(np.int16)
            v.grid_mapping = b"crs"
            v._FillValue = np.int16(0)
        data = scipy_nc(build)
    elif kind == "gpkg":
        data = tgpkg.encode_gpkg(band, tile_size=64, geotransform=gt,
                                 epsg=epsg)
    elif kind == "nitf":
        data = tnitf.encode_nitf(band, geotransform=gt, epsg=epsg)
    elif kind == "hdf4":
        data = thdf4.encode_hdf4({"band": band})
    elif kind == "grib":
        data = tgrib.encode_grib2(band.astype(np.float64), 19.3, 72.9,
                                  1e-4, 1e-4, nbits=16)
    with open(path, "wb") as f:
        f.write(data)
    return path


# the containers whose georeferencing a UTM scene can carry from bare
# bytes (LocalCatalog passes no base_dir, as the JAX package's does)
CARRY = ("geotiff", "vrt-absolute", "netcdf", "gpkg", "nitf")
CANNOT = ("vrt-relative", "envi", "hdf4", "grib")


@pytest.mark.parametrize("kind", CARRY + CANNOT)
def test_catalog_scene_of_container_bands(kind, tmp_path):
    """A per-band scene (two band files of ``kind``) loads in the port as
    in the JAX package: the same stack and valid mask bitwise, or the
    same error. VRT (absolute sources), NetCDF, GeoPackage and NITF
    carry a UTM scene; a relativeToVRT VRT and ENVI need their file's
    directory, HDF4 has no georeferencing, and GRIB's grids are
    EPSG:4326 (their pixels never land on a UTM tile)."""
    root = str(tmp_path / "cat")
    LocalCatalog.create(root)
    jt, tt = JTile(*TILE), TTile(*TILE)
    x0, y0, x1, y1 = jt.bounds
    gt = (float(np.floor(x0)) - 40.0, 10.0, 0.0, float(np.ceil(y1)) + 30.0,
          0.0, -10.0)
    h = int((gt[3] - y0) / 10.0) + 8
    w = int((x1 - gt[0]) / 10.0) + 8
    rng = np.random.RandomState(17)
    paths = {}
    for band in ("B02", "B03"):
        arr = rng.randint(1, 30000, (h, w, 1)).astype(np.uint16)
        arr[rng.rand(h, w) < 0.05] = 0
        paths[band] = _band_file(str(tmp_path), kind, band, arr, gt, 32643)
    idx = {"products": {"s2": {"bands": ["B02", "B03"], "scenes": [
        {"id": "g", "date": "2020-05-01", "band_paths": paths,
         "bounds": list(jt.bounds), "epsg": 32643, "nodata": 0}]}}}
    with open(os.path.join(root, "index.json"), "w") as f:
        json.dump(idx, f)
    results = []
    for cat, tile in ((LocalCatalog(root), tt), (JLocalCatalog(root), jt)):
        try:
            results.append(cat.load(cat.search(tile, "s2"), tile,
                                     ["B03", "B02"], "near"))
        except Exception as e:  # noqa: BLE001 (compared below)
            results.append((type(e).__name__, str(e)))
    got, want = results
    if kind in CARRY:
        stack, valid = got
        assert valid.any() and stack.shape[-1] == 2
    else:
        assert isinstance(got[0], str) or not got[1].any(), got
    if isinstance(want[0], str):
        assert got == want
    else:
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# request bodies
# ---------------------------------------------------------------------------

SIZE = 32


def _h5_body(rgb, libver, **kw):
    import h5py
    buf = io.BytesIO()
    with h5py.File(buf, "w", libver=libver, track_order=True) as f:
        f.create_dataset("rgb", data=rgb.transpose(2, 0, 1), **kw)
    return buf.getvalue()


def _bodies():
    rng = np.random.RandomState(18)
    rgb = rng.randint(0, 255, (SIZE, SIZE, 3)).astype(np.uint8)

    def nc(f):
        f.createDimension("band", 3)
        f.createDimension("y", SIZE)
        f.createDimension("x", SIZE)
        v = f.createVariable("rgb", "h", ("band", "y", "x"))
        v[:] = rgb.transpose(2, 0, 1)
    return {
        "netcdf": scipy_nc(nc),
        "grib": b"".join(tgrib.encode_grib2(rgb[:, :, b].astype(float),
                                            19.0, 72.0, 0.01, 0.01,
                                            nbits=8, packing="complex-sd1")
                         for b in range(3)),
        "hdf4": thdf4.encode_hdf4({"rgb": rgb.transpose(2, 0, 1).astype(
            np.uint16) * 200}, storage="chunked"),
        "nitf": tnitf.encode_nitf(rgb, imode="P", block_size=16),
        "gpkg": tgpkg.encode_gpkg(rgb, tile_size=16, geotransform=GT,
                                  epsg=32643),
        "hdf5": _h5_body(rgb, "earliest", chunks=(1, 16, 16),
                         compression="gzip", shuffle=True),
        "netcdf4": _h5_body(rgb.astype(np.int16), "latest",
                            chunks=(3, 8, 32), maxshape=(None, SIZE, SIZE),
                            compression="lzf"),
    }


@pytest.fixture(scope="module")
def live_server():
    from dl_image_segmentation_tpu_torch import serve
    from dl_image_segmentation_tpu_torch.train import TrainConfig, Trainer
    torch.manual_seed(0)
    trainer = Trainer(TrainConfig(num_classes=3, base_features=8, levels=2,
                                  image_size=SIZE, batch_size=4),
                      device="cpu")
    ps = serve.PredictServer(trainer, max_wait_ms=50.0)
    httpd = serve.make_http_server("127.0.0.1", 0, ps, scale="auto")
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield trainer, f"http://127.0.0.1:{httpd.server_address[1]}/predict"
    httpd.shutdown()
    ps.close()
    t.join(timeout=30)


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.mark.parametrize("kind", ["netcdf", "grib", "hdf4", "nitf", "gpkg",
                                  "hdf5", "netcdf4"])
def test_container_bodies_are_served(kind, live_server):
    """A container request body decodes as in the JAX package and is
    served as ``predict`` of its decode, scaled by dtype."""
    from dl_image_segmentation_tpu_torch.serve import scale_image
    trainer, url = live_server
    body = _bodies()[kind]
    got, want = timage.decode_image_bytes(body), \
        jimage.decode_image_bytes(body)
    same_raster(got, want)
    code, out = _post(url, body)
    assert code == 200
    scaled = scale_image(got.array, "auto")
    np.testing.assert_array_equal(
        np.load(io.BytesIO(out)), trainer.predict(np.stack(
            [scaled] * trainer.config.batch_size))[0])


@pytest.mark.parametrize("case", ["external-storage", "truncated",
                                  "chunk-dim-fixed", "chunk-dim-unlimited",
                                  "lzf-size-parameter", "szip-scanline"])
def test_hdf5_bodies_refused_or_corrupt_answer_400(case, live_server,
                                                   tmp_path):
    """An HDF5 body whose dataset names external raw storage is refused
    before the file it names is read (the JAX package's h5py reads it);
    a truncated body is a corrupt container; a body that declares a huge
    chunk, LZF size or szip scanline is refused before anything is
    allocated for it (the traced peak of the whole process, server
    thread included, stays below 16 MiB). All answer 400."""
    import h5py

    from tests.test_torch_hdf5 import HOSTILE
    _, url = live_server
    raw = tmp_path / "secret.raw"
    raw.write_bytes(np.arange(SIZE * SIZE, dtype=np.uint16).tobytes())
    if case == "external-storage":
        buf = io.BytesIO()
        with h5py.File(buf, "w") as f:
            f.create_dataset("a", shape=(SIZE, SIZE), dtype="u2",
                             external=[(str(raw), 0, 2 * SIZE * SIZE)])
        body, want = buf.getvalue(), "refused"
    elif case == "truncated":
        body, want = _bodies()["hdf5"][:700], "corrupt or unreadable HDF5"
    else:
        build, want = HOSTILE[case]
        body = build()
    tracemalloc.start()
    try:
        code, out = _post(url, body)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    err = json.loads(out)["error"]
    assert code == 400 and want in err and str(raw) not in err
    assert peak < 16 << 20, peak


def test_relative_vrt_bare_bytes_fail_as_in_jax():
    """A relativeToVRT VRT decoded from bare bytes (a catalog band read
    without its directory) fails with the JAX package's message."""
    body = _vrt_xml("part.tif", True)
    errs = []
    for mod in (timage, jimage):
        with pytest.raises(mod.CorruptRasterError) as e:
            mod.decode_image_bytes(body)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("where", ["relative", "absolute", "url"])
def test_vrt_body_is_refused(where, live_server, tmp_path, monkeypatch):
    """A VRT request body names files or URLs for the server to read
    (the JAX package reads them): the port answers 400 before it reads
    any, with a message that does not echo the source."""
    from dl_image_segmentation_tpu_torch import storage
    _, url = live_server
    arr = np.arange(20 * 17, dtype=np.uint16).reshape(20, 17, 1)
    src = _write_multi_file(str(tmp_path), "vrt", "body", arr)[:-4] + \
        "-src.tif"
    source = {"relative": "body-src.tif", "absolute": src,
              "url": "http://127.0.0.1:9/body-src.tif"}[where]
    body = _vrt_xml(source, where == "relative")
    read = []
    real = storage.read_bytes
    monkeypatch.setattr(storage, "read_bytes",
                        lambda p, *a, **k: read.append(p) or real(p, *a, **k))
    with pytest.raises(timage.UnsupportedFormatError, match="VRT refused"):
        timage.decode_image_bytes(body, allow_sources=False)
    code, out = _post(url, body)
    assert code == 400
    err = json.loads(out)["error"]
    assert "VRT refused" in err and source not in err
    assert read == []


def test_gpkg_vrt_tile_is_refused(tmp_path, monkeypatch):
    """A GeoPackage whose tile blob is VRT XML does not read the VRT's
    source: a tile is an image."""
    from dl_image_segmentation_tpu_torch import storage
    arr = np.arange(20 * 17, dtype=np.uint16).reshape(20, 17, 1)
    src = _write_multi_file(str(tmp_path), "vrt", "tile", arr)[:-4] + \
        "-src.tif"
    path = tmp_path / "t.gpkg"
    path.write_bytes(tgpkg.encode_gpkg(arr[:16, :16], tile_size=16))
    conn = sqlite3.connect(str(path))
    conn.execute('UPDATE "imagery" SET tile_data = ?',
                 (_vrt_xml(src, False),))
    conn.commit()
    conn.close()
    read = []
    monkeypatch.setattr(storage, "read_bytes",
                        lambda p, *a, **k: read.append(p) or b"")
    with pytest.raises(timage.UnsupportedFormatError, match="VRT refused"):
        timage.decode_image_bytes(path.read_bytes())
    assert read == []
