"""The port's own HDF5 / NetCDF-4 reader (``raster/hdf5.py``) against the
JAX package's h5py decoder, on the CPU.

* Every fixture is written here with h5py, and each is decoded and
  sniffed by both packages: arrays, dtypes, ``RasterInfo`` and the
  ``ValueError`` texts bitwise equal; other failures compared through
  the dispatch, up to the ``;`` of "corrupt or unreadable HDF5
  container; ...". The cases cover every ``libver`` bound with each
  storage layout, each chunk index, each filter, each datatype, fill
  values, userblocks, dense links and attributes, creation order,
  NetCDF-4 dimension scales, CF sibling coordinates, grid mappings,
  nodata, h5py's visit order and its links, and ``variable=``.
* Parts the port refuses unread (external storage, virtual datasets,
  external links, SOHM) raise naming ROADMAP item 14, in every context.
* A seeded fuzz of truncations and bit flips raises only clean
  exceptions within a deadline, and a file that declares a huge size in
  one field is refused before anything is allocated for it.
* The committed fixtures (``tests/data/hdf5``, written by
  :func:`write_fixtures`: ``python -m tests.test_torch_hdf5``) decode in
  both packages to their ``.npz``.
* HDF5 chip pairs through both MP engines (equal shards), ``convert``
  and a LocalCatalog scene of HDF5 band files.

Nothing here compiles XLA: both decoders are numpy (and h5py).
"""

import ctypes
import glob
import io
import json
import os
import signal
import struct
import tracemalloc

import h5py
import numpy as np
import pytest
import torch

from dl_image_segmentation_tpu.raster import hdf5 as jh5
from dl_image_segmentation_tpu.raster import image as jimage
from dl_image_segmentation_tpu_torch.raster import hdf5 as th5
from dl_image_segmentation_tpu_torch.raster import image as timage

# one intra-op thread: the test workers share the host's cores
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "data", "hdf5")
GT = (399980.0, 10.0, 0.0, 600010.0, 0.0, -10.0)


def h5(build, **kw):
    buf = io.BytesIO()
    with h5py.File(buf, "w", **kw) as f:
        build(f)
    return buf.getvalue()


def outcome(fn, *args, **kwargs):
    """A decode's or sniff's result, or its error, comparably."""
    try:
        got = fn(*args, **kwargs)
    except Exception as e:  # noqa: BLE001 (compared by the caller)
        msg = str(e)
        if isinstance(e, jimage.CorruptRasterError) or isinstance(
                e, timage.CorruptRasterError):
            msg = msg.split(";")[0]       # libhdf5's tail is not carried
        return ("error", type(e).__name__, msg)
    if hasattr(got, "array"):
        a = got.array
        return ("raster", a.dtype.str, a.shape, a.tobytes(), info(got.info))
    if hasattr(got, "width"):
        return ("info", info(got))
    return ("value", got)


def info(i):
    d = dict(vars(i))
    if isinstance(d["nodata"], float) and np.isnan(d["nodata"]):
        d["nodata"] = "nan"
    return d


def both(data, variable=None, dispatch=False):
    """(JAX, port) outcomes of decode and sniff."""
    if dispatch:
        calls = [(jimage.decode_image_bytes, timage.decode_image_bytes),
                 (jimage.sniff_image_info, timage.sniff_image_info)]
        return [(outcome(j, data), outcome(t, data)) for j, t in calls]
    kw = {} if variable is None else {"variable": variable}
    return [(outcome(jh5.decode_hdf5, data, **kw),
             outcome(th5.decode_hdf5, data, **kw)),
            (outcome(jh5.sniff_hdf5_info, data, **kw),
             outcome(th5.sniff_hdf5_info, data, **kw))]


def assert_same(data, variable=None):
    for want, got in both(data, variable):
        if want[0] == "error" and want[1] != "ValueError":
            # libhdf5's own failures: compare through the dispatch
            continue
        assert got == want
    for want, got in both(data, dispatch=True) if variable is None else []:
        assert got == want
    if variable is None:
        assert list(th5.hdf5_variables(data).items()) == \
            list(jh5.hdf5_variables(data).items())


RNG = np.random.RandomState(13)
U2 = RNG.randint(0, 60000, (37, 29)).astype(np.uint16)


def low_level(f, name, arr, *, chunks=None, layout=None, alloc_early=False,
              fill=None, fill_never=False, ftype=None, nbit=False,
              write=True):
    """A dataset through h5py's low-level API (layouts and properties the
    high-level API does not set)."""
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    if chunks:
        dcpl.set_chunk(chunks)
    if layout == "compact":
        dcpl.set_layout(h5py.h5d.COMPACT)
    if alloc_early:
        dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
    if fill is not None:
        dcpl.set_fill_value(np.array(fill, arr.dtype))
    if fill_never:
        dcpl.set_fill_time(h5py.h5d.FILL_TIME_NEVER)
    if nbit:
        dcpl.set_filter(h5py.h5z.FILTER_NBIT, 0, ())
    tid = ftype if ftype is not None else h5py.h5t.py_create(arr.dtype)
    sid = h5py.h5s.create_simple(arr.shape)
    d = h5py.h5d.create(f.id, name.encode(), tid, sid, dcpl=dcpl)
    if write:
        d.write(h5py.h5s.ALL, h5py.h5s.ALL, np.ascontiguousarray(arr))
    return d


# ---------------------------------------------------------------------------
# layouts, chunk indexes, filters, datatypes
# ---------------------------------------------------------------------------

LAYOUTS = {
    "contiguous": lambda f: f.create_dataset("a", data=U2),
    "compact": lambda f: low_level(f, "a", U2[:9, :11], layout="compact"),
    "chunked": lambda f: f.create_dataset("a", data=U2, chunks=(8, 7)),
    "deflate": lambda f: f.create_dataset("a", data=U2, chunks=(8, 7),
                                          compression="gzip"),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("libver", ["earliest", "v108", "v110", "latest"])
def test_libver_and_layout(libver, layout):
    assert_same(h5(LAYOUTS[layout], libver=libver))


def _big(f, **kw):
    f.create_dataset("a", data=np.arange(300 * 4, dtype=np.int32).reshape(
        300, 4), chunks=(1, 4), **kw)


INDEXES = {
    # libver earliest: version 3 layouts and the v1 B-tree (two levels)
    "btree1": ("earliest", lambda f: f.create_dataset(
        "a", data=np.arange(100 * 100, dtype="u2").reshape(100, 100),
        chunks=(8, 8))),
    "single": ("latest", lambda f: f.create_dataset("a", data=U2,
                                                    chunks=U2.shape)),
    "single-filtered": ("latest", lambda f: f.create_dataset(
        "a", data=U2, chunks=U2.shape, compression="gzip")),
    "implicit": ("latest", lambda f: low_level(f, "a", U2, chunks=(8, 7),
                                               alloc_early=True)),
    "fixed-array": ("latest", lambda f: f.create_dataset(
        "a", data=U2, chunks=(8, 7))),
    "fixed-array-filtered": ("latest", lambda f: f.create_dataset(
        "a", data=U2, chunks=(8, 7), compression="gzip", shuffle=True)),
    "fixed-array-paged": ("latest", lambda f: f.create_dataset(
        "a", data=np.arange(40 * 1040, dtype="u1").reshape(40, 1040) % 251,
        chunks=(1, 40))),
    "extensible-array": ("latest", lambda f: f.create_dataset(
        "a", data=U2, chunks=(8, 7), maxshape=(None, 29))),
    "extensible-array-second-dim": ("latest", lambda f: f.create_dataset(
        "a", data=U2, chunks=(8, 7), maxshape=(37, None))),
    "extensible-array-blocks": ("latest", lambda f: _big(
        f, maxshape=(None, 4))),
    "extensible-array-filtered": ("latest", lambda f: _big(
        f, maxshape=(None, 4), compression="gzip")),
    "btree2": ("latest", lambda f: f.create_dataset(
        "a", data=U2, chunks=(8, 7), maxshape=(None, None))),
    "btree2-filtered": ("latest", lambda f: f.create_dataset(
        "a", data=U2, chunks=(8, 7), maxshape=(None, None),
        compression="gzip", fletcher32=True)),
    "btree2-many": ("latest", lambda f: _big(f, maxshape=(None, None))),
}


@pytest.mark.parametrize("index", sorted(INDEXES))
def test_chunk_index(index):
    libver, build = INDEXES[index]
    assert_same(h5(build, libver=libver))


def _nbit(f):
    t = h5py.h5t.STD_U16LE.copy()
    t.set_precision(12)
    t.set_offset(2)
    low_level(f, "a", U2 % 4096, chunks=(8, 7), ftype=t, nbit=True)


def _nbit_signed(f):
    t = h5py.h5t.STD_I32BE.copy()
    t.set_precision(20)
    t.set_offset(5)
    a = (U2.astype(np.int32) - 30000) * 7
    low_level(f, "a", a, chunks=(8, 7), ftype=t, nbit=True)


FILTERS = {
    "deflate": dict(compression="gzip", compression_opts=9),
    "shuffle": dict(shuffle=True),
    "fletcher32": dict(fletcher32=True),
    "lzf": dict(compression="lzf"),
    "lzf-shuffle": dict(compression="lzf", shuffle=True),
    "shuffle+deflate+fletcher32": dict(compression="gzip", shuffle=True,
                                       fletcher32=True),
    "scaleoffset-int": dict(scaleoffset=0, dtype="i4"),
    "scaleoffset-uint-fill": dict(scaleoffset=0, fillvalue=65535,
                                  dtype="u4"),
    "nbit": _nbit,
    "nbit-signed-big-endian": _nbit_signed,
}


@pytest.mark.parametrize("name", sorted(FILTERS))
@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_filter(name, libver):
    opts = FILTERS[name]
    if callable(opts):
        build = opts
    else:
        def build(f):
            f.create_dataset("a", data=U2, chunks=(8, 7), **opts)
    assert_same(h5(build, libver=libver))


@pytest.mark.parametrize("dtype", ["u1", "<u2", ">i2"])
def test_scaleoffset_small_integers_decode_where_h5py_fails(dtype):
    """HDF5 1.14.6's scale-offset filter fails to read back 1- and 2-byte
    integers that it wrote ("filter returned failure during read"); the
    port reads the values written (ROADMAP queue 3, intended)."""
    a = (U2.astype(np.int64) - (30000 if "i" in dtype else 0)).astype(dtype)
    data = h5(lambda f: f.create_dataset("a", data=a, chunks=(8, 7),
                                         scaleoffset=0))
    with pytest.raises(OSError, match="filter returned failure"):
        jh5.decode_hdf5(data)
    got = th5.decode_hdf5(data).array[:, :, 0]
    assert got.dtype == a.dtype.newbyteorder("=") and np.array_equal(got, a)


@pytest.mark.parametrize("dtype", ["<f4", ">f4", "<f8", ">f8"])
def test_scaleoffset_float(dtype):
    a = (RNG.rand(23, 17) * 1000 - 300).astype(dtype)
    assert_same(h5(lambda f: f.create_dataset("a", data=a, chunks=(8, 8),
                                              scaleoffset=3)))


SZIP = [(dt, opts, chunks)
        for dt in ("u1", ">u2", "<i2", "<u4", ">f4", "<f8", ">i8")
        for opts in (("nn", 8), ("ec", 32))
        for chunks in ((8, 8), (8, 29))] + [
    ("<u2", ("nn", 16), (37, 29)), ("<f4", ("ec", 8), (1, 29))]


@pytest.mark.parametrize("dtype,opts,chunks", SZIP)
def test_szip(dtype, opts, chunks):
    """The szip filter (CCSDS 121.0, ``csrc/host/h5filters.cc``): NN or
    EC coding, block sizes, scanlines that are not whole blocks (padded),
    and the byte interleave of 32- and 64-bit words."""
    a = (RNG.rand(37, 29) * 900 - (300 if dtype[-2] in "if" else 0))
    a[5:9] = 0                                   # zero blocks
    data = h5(lambda f: f.create_dataset(
        "a", data=a.astype(dtype), chunks=chunks, compression="szip",
        compression_opts=opts))
    assert_same(data)


def _enum(f, base, bool_like):
    names = {"FALSE": 0, "TRUE": 1} if bool_like else {"A": 1, "B": 5,
                                                       "C": 9}
    dt = h5py.enum_dtype(names, basetype=base)
    vals = np.array(list(names.values()), base)
    f.create_dataset("a", data=vals[RNG.randint(0, len(vals), (6, 5))],
                     dtype=dt)


def _committed(f):
    f["t"] = np.dtype(">u2")                     # a named datatype
    d = f.create_dataset("a", data=U2[:6, :5].astype(">u2"), dtype=f["t"])
    d.attrs.create("_FillValue", np.uint16(3), dtype=f["t"])


def _bitfield(f):
    d = low_level(f, "a", U2[:6, :5], ftype=h5py.h5t.STD_B16BE, write=False)
    d.write(h5py.h5s.ALL, h5py.h5s.ALL, np.ascontiguousarray(U2[:6, :5]),
            mtype=h5py.h5t.STD_B16LE)


DTYPES = ["u1", "i1", "<u2", ">i2", "<u4", ">i4", "<u8", ">i8", "<f2",
          ">f2", "<f4", ">f4", "<f8", ">f8", "bool"]


@pytest.mark.parametrize("dtype", DTYPES + ["enum", "enum-bool-u2",
                                            "bitfield", "committed"])
@pytest.mark.parametrize("chunked", [False, True])
def test_datatype(dtype, chunked):
    kw = {"chunks": (4, 4)} if chunked else {}
    if dtype == "enum":
        build = lambda f: _enum(f, np.int16, False)
    elif dtype == "enum-bool-u2":
        build = lambda f: _enum(f, np.uint16, True)
    elif dtype == "bitfield":
        build = _bitfield
    elif dtype == "committed":
        build = _committed
    else:
        a = (RNG.rand(6, 5) * 200 - 50).astype(dtype)

        def build(f):
            f.create_dataset("a", data=a, **kw)
    assert_same(h5(build))


def _non_numeric(f):
    f.create_dataset("s", data=np.array([[b"ab", b"c"]] * 3))
    f.create_dataset("vs", data=np.array([["x", "yz"]] * 3, dtype=object),
                     dtype=h5py.string_dtype())
    f.create_dataset("cmp", data=np.zeros((3, 2), [("p", "<i4"),
                                                   ("q", "<f8")]))
    f.create_dataset("arr", shape=(3, 2), dtype=np.dtype(("<i2", (2,))))
    f.create_dataset("opq", data=np.zeros((3, 2), "V3"))
    f.create_dataset("vl", shape=(3, 2), dtype=h5py.vlen_dtype(np.int32))
    f.create_dataset("ref", shape=(3, 2), dtype=h5py.ref_dtype)
    f.create_dataset("scalar", data=np.float32(3))
    f.create_dataset("small", data=np.ones((2, 3), "u1"))


def test_non_numeric_types_are_listed_and_skipped():
    data = h5(_non_numeric)
    assert_same(data)
    assert th5.decode_hdf5(data).array.shape == (2, 3, 1)
    for name in ("s", "scalar"):
        assert_same(data, variable=name)


def test_null_dataspace_is_listed_as_h5py_lists_it():
    """A null dataspace has shape None in h5py, so listing the datasets
    fails; both packages fail alike when no raster is found."""
    data = h5(lambda f: (f.create_dataset("null", data=h5py.Empty("f4")),
                         f.create_dataset("x", data=np.arange(3.0))))
    for want, got in both(data, dispatch=True):
        assert got == want


# ---------------------------------------------------------------------------
# fill values, userblocks, dense storage, creation order
# ---------------------------------------------------------------------------

def _partial(fill, never=False, alloc=None):
    def build(f):
        a = U2[:20, :20]
        d = low_level(f, "a", a, chunks=(8, 8), fill=fill, fill_never=never,
                      write=False)
        ds = f["a"]
        ds[0:8, 0:8] = a[0:8, 0:8]
        ds[16:20, 8:16] = a[16:20, 8:16]
        del d
    return build


FILLS = {
    "partial-default": _partial(None),
    "partial-fill-7": _partial(7),
    "partial-fill-never": _partial(7, never=True),
    "unallocated-contiguous": lambda f: f.create_dataset(
        "a", shape=(9, 8), dtype="u2", fillvalue=11),
    "unallocated-chunked": lambda f: f.create_dataset(
        "a", shape=(9, 8), dtype="u2", chunks=(4, 4), fillvalue=11),
    "unallocated-float": lambda f: f.create_dataset(
        "a", shape=(9, 8), dtype=">f4", fillvalue=-1.5),
}


@pytest.mark.parametrize("case", sorted(FILLS))
@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_fill_value(case, libver):
    assert_same(h5(FILLS[case], libver=libver))


def test_superblock_extension():
    """``libver='latest'`` files with a superblock extension (persistent
    free-space tracking); paged, the bytes end before the stored end of
    file, and both packages refuse the file as truncated."""
    kw = dict(libver="latest", fs_persist=True)
    assert_same(h5(LAYOUTS["deflate"], fs_strategy="fsm", **kw))
    paged = h5(LAYOUTS["deflate"], fs_strategy="page", **kw)
    for want, got in both(paged, dispatch=True):
        assert want[0] == "error" and got == want


@pytest.mark.parametrize("size", [512, 1024, 4096])
@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_userblock(size, libver):
    data = h5(LAYOUTS["deflate"], libver=libver, userblock_size=size)
    assert data[:8] != b"\x89HDF\r\n\x1a\n"
    assert_same(data)


def _dense(n_links, n_attrs):
    def build(f):
        g = f.create_group("grp")
        for i in range(n_links):
            g.create_dataset(f"band_{i:03d}_{'x' * (i % 7)}",
                             data=np.full((3, 4 + i % 3), i, "u2"))
        d = g.create_dataset("main", data=U2)
        for i in range(n_attrs):
            d.attrs[f"attr_{i:02d}"] = np.float32(i)
        d.attrs["_FillValue"] = np.uint16(9)
        d.attrs["units"] = "metres"
    return build


@pytest.mark.parametrize("n_links,n_attrs", [(4, 4), (12, 12), (60, 60)])
@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_dense_links_and_attributes(n_links, n_attrs, libver):
    assert_same(h5(_dense(n_links, n_attrs), libver=libver))


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_dense_attributes_are_read_as_h5py_reads_them(libver):
    data = h5(_dense(2, 60), libver=libver)
    with h5py.File(io.BytesIO(data), "r") as f:
        want = {k: v for k, v in f["grp/main"].attrs.items()}
    f = th5._File(data)
    got = f.root["grp/main"].attrs
    assert sorted(got.keys()) == sorted(want)
    for k, v in want.items():
        assert type(got[k]) is type(v) and np.array_equal(got[k], v), k


def _ordered(f):
    g = f.create_group("g", track_order=True)
    for n in ["Q", "_x", "aa", "alpha", "b10", "b2", "z", "m", "k", "c"]:
        f.create_dataset(n, data=np.zeros((2, 2)))
        g.create_dataset(n, data=np.zeros((2, 2)))


@pytest.mark.parametrize("libver", ["earliest", "v110", "latest"])
def test_visit_order_is_by_name_even_in_creation_ordered_groups(libver):
    data = h5(_ordered, libver=libver)
    names = list(th5.hdf5_variables(data))
    assert names == list(jh5.hdf5_variables(data))
    assert names[:8] == ["/Q", "/_x", "/aa", "/alpha", "/b10", "/b2",
                         "/c", "/g/Q"]
    f = th5._File(data)
    assert [k for k, _ in f.root["g"].items()] == [
        "Q", "_x", "aa", "alpha", "b10", "b2", "z", "m", "k", "c"]
    assert_same(data)


@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_track_order_file(track, libver):
    def build(f):
        for n in ["zeta", "alpha", "mid"]:
            f.create_dataset(n, data=np.full((4, 5), len(n), "i2"))
        # two x candidates of the right length: items() order decides
        lon = f.create_dataset("lon", data=np.arange(5.0) + 10)
        f.create_dataset("x", data=np.arange(5.0) * 2)
        lon.attrs["units"] = "degrees_east"
        f.create_dataset("y", data=np.arange(4.0) * -3)
    assert_same(h5(build, libver=libver, track_order=track))


# ---------------------------------------------------------------------------
# NetCDF-4 conventions and CF georeferencing
# ---------------------------------------------------------------------------

def _nc4(f, dtype="u2", scale_units=None, nodata_attr="_FillValue",
         gm="tm", gm_in_root=False, with_gm=True):
    f.attrs["_NCProperties"] = np.bytes_(
        b"version=2,netcdf=4.9.2,hdf5=1.14.6")
    grp = f.create_group("data", track_order=True) if not gm_in_root \
        else f
    y = grp.create_dataset("y", data=600005.0 - 10.0 * np.arange(6))
    x = grp.create_dataset("x", data=399985.0 + 10.0 * np.arange(7))
    for v, axis, i in ((y, "y", 0), (x, "x", 1)):
        v.attrs["standard_name"] = f"projection_{axis}_coordinate"
        v.attrs["_Netcdf4Dimid"] = np.int32(i)
        if scale_units:
            v.attrs["units"] = scale_units
        v.make_scale(axis)
    d = grp.create_dataset("refl", data=np.arange(42, dtype=dtype).reshape(
        6, 7), chunks=(3, 4), compression="gzip", shuffle=True)
    d.dims[0].attach_scale(y)
    d.dims[1].attach_scale(x)
    if with_gm:
        tm = f.create_dataset(gm, data=np.array(0, "i1"))
        tm.attrs["grid_mapping_name"] = "transverse_mercator"
        tm.attrs["scale_factor_at_central_meridian"] = 0.9996
        tm.attrs["false_easting"] = 500000.0
        tm.attrs["false_northing"] = 0.0
        tm.attrs["longitude_of_central_meridian"] = 15.0
        d.attrs["grid_mapping"] = gm if gm_in_root else "/" + gm
    if nodata_attr:
        d.attrs[nodata_attr] = np.array([np.iinfo(dtype).max], dtype)


NC4 = {
    "utm": dict(),
    "utm-int16": dict(dtype="i2"),
    "missing-value": dict(nodata_attr="missing_value"),
    "no-nodata": dict(nodata_attr=None),
    "grid-mapping-beside": dict(gm_in_root=True),
    "degrees-no-grid-mapping": dict(scale_units="degrees_east",
                                    with_gm=False),
    "metres-no-grid-mapping": dict(scale_units="m", with_gm=False),
}


@pytest.mark.parametrize("case", sorted(NC4))
@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_netcdf4_dimension_scales(case, libver):
    data = h5(lambda f: _nc4(f, **NC4[case]), libver=libver,
              track_order=True)
    assert_same(data)
    got = th5.decode_hdf5(data)
    assert got.info.geotransform is not None


def test_jax_nc4_fixture():
    """The JAX package's own NetCDF-4 fixture."""
    from tests.test_scientific_formats import TestHDF5
    data = TestHDF5()._nc4_utm()
    assert_same(data)
    assert th5.decode_hdf5(data).info.epsg == 32633
    assert_same(data, variable="refl")
    assert_same(data, variable="nothere")


def _siblings(units_x, units_y, gm=None, std=False, name_x="lon",
              name_y="lat", spacing=0.1, where="product"):
    def build(f):
        grp = f.create_group(where) if where != "/" else f
        lat = grp.create_dataset(name_y, data=50.25 - spacing * np.arange(4))
        lon = grp.create_dataset(name_x, data=8.05 + spacing * np.arange(6))
        if units_x:
            lon.attrs["units"] = units_x
        if units_y:
            lat.attrs["units"] = units_y
        if std:
            lon.attrs["standard_name"] = "projection_x_coordinate"
            lat.attrs["axis"] = "Y"
        d = grp.create_dataset("t2m", data=RNG.rand(3, 4, 6).astype("f4"))
        if gm:
            crs = f.create_dataset("crs", data=np.int32(0))
            crs.attrs.update(gm)
            d.attrs["grid_mapping"] = np.bytes_(b"crs")
    return build


SIBLINGS = {
    "degrees": _siblings("degrees_east", "degrees_north"),
    "no-units-names": _siblings(None, None, name_x="x", name_y="y"),
    "standard-names": _siblings(None, None, std=True, name_x="e",
                                name_y="n"),
    "irregular": _siblings("degrees_east", "degrees_north", spacing=0.0),
    "latlon-grid-mapping": _siblings(
        None, None, gm={"grid_mapping_name": "latitude_longitude"}),
    "epsg-code": _siblings(None, None, gm={"epsg_code": "EPSG:32643"}),
    "crs-wkt": _siblings(None, None, gm={
        "crs_wkt": 'GEOGCS["WGS 84",AUTHORITY["EPSG","4326"]]'}),
    "in-root": _siblings("degrees_east", "degrees_north", where="/"),
}


@pytest.mark.parametrize("case", sorted(SIBLINGS))
def test_cf_sibling_coordinates(case):
    assert_same(h5(SIBLINGS[case]))


@pytest.mark.parametrize("value", ["f4-array", "f8-scalar", "i2", "string",
                                   "vlen-string", "empty", "bool"])
def test_nodata_attribute_types(value):
    v = {"f4-array": np.array([-9999.0], "f4"), "f8-scalar": np.float64(-1),
         "i2": np.int16(-5), "string": np.bytes_(b"-1"), "vlen-string": "x",
         "empty": np.zeros(0, "f4"), "bool": np.bool_(True)}[value]

    def build(f):
        d = f.create_dataset("a", data=U2[:5, :6])
        d.attrs["_FillValue"] = v
        d.attrs["missing_value"] = np.float32(3)
    data = h5(build)
    assert_same(data)
    for want, got in both(data, dispatch=True):
        assert got == want


# ---------------------------------------------------------------------------
# selection: ties, links, variable=
# ---------------------------------------------------------------------------

def _ties(f):
    f.create_dataset("b/a", data=np.full((4, 6), 1, "u1"))
    f.create_dataset("a", data=np.full((6, 4), 2, "u1"))
    f.create_dataset("c", data=np.full((2, 3, 8), 3, "u1"))
    f.create_dataset("B", data=np.full((3, 8), 4, "u1"))


def _hardlinks(f):
    d = f.create_dataset("z/data", data=np.full((5, 5), 1, "i4"))
    f["a_first"] = d                       # the same object, first by name
    f.create_dataset("m", data=np.full((5, 5), 2, "i4"))
    f["soft"] = h5py.SoftLink("/m")
    f["dangling"] = h5py.SoftLink("/nowhere")


def _dense_ties(f):
    for i in range(20):
        f.create_dataset(f"g/n{19 - i:02d}", data=np.full((4, 4), i, "u1"))


SELECT = {
    "ties": (_ties, {}),
    "hard-links": (_hardlinks, {}),
    "dense-ties": (_dense_ties, {"libver": "latest"}),
    "dense-ties-ordered": (_dense_ties, {"libver": "latest",
                                         "track_order": True}),
}


@pytest.mark.parametrize("case", sorted(SELECT))
def test_selection_order(case):
    build, kw = SELECT[case]
    data = h5(build, **kw)
    assert_same(data)


@pytest.mark.parametrize("variable", [
    "a", "/b/a", "b//a", "./a", "b", "nothere", "soft", "dangling", "z",
    "a_first", "z/data", "c"])
@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_variable(variable, libver):
    """Paths through symbol-table groups (earliest) and link messages
    (latest): hard and soft links, dangling ones, groups."""
    data = h5(lambda f: (_ties(f), _hardlinks(f)), libver=libver)
    res = both(data, variable=variable)
    for want, got in res:
        if want[0] == "error" and want[1] not in ("ValueError",):
            assert got[0] == "error", (variable, got)
        else:
            assert got == want, variable


def test_group_variable_fails_as_in_jax():
    data = h5(_ties)
    for (jfn, tfn) in ((jh5.decode_hdf5, th5.decode_hdf5),
                       (jh5.sniff_hdf5_info, th5.sniff_hdf5_info)):
        assert outcome(tfn, data, variable="b") == outcome(jfn, data,
                                                           variable="b")


@pytest.mark.parametrize("case", ["no-raster", "one-d", "empty-file"])
def test_no_raster(case):
    def build(f):
        if case != "empty-file":
            f.create_dataset("v", data=np.arange(9.0))
            f.create_dataset("g/s", data=np.float32(1))
    data = h5(build)
    assert_same(data)
    if case == "one-d":
        assert_same(data, variable="v")


def test_sniff_reads_no_raster_payload():
    """Corrupt data chunks: both packages sniff the file (metadata and the
    1-D coordinates only) and both fail to decode it."""
    def build(f):
        _nc4(f)
        f.create_dataset("big", data=U2, chunks=(8, 8), compression="gzip")
    data = bytearray(h5(build))
    with h5py.File(io.BytesIO(bytes(data)), "r") as f:
        dsid = f["big"].id
        spans = [(c.byte_offset, c.size) for c in (
            dsid.get_chunk_info(i) for i in range(dsid.get_num_chunks()))]
    for off, size in spans:
        data[off:off + size] = b"\xa5" * size
    data = bytes(data)
    (jd, td), (js, ts) = both(data)
    assert js[0] == "info" and ts == js
    assert jd[0] == td[0] == "error"
    (jd, td), (js, ts) = both(data, dispatch=True)
    assert td == jd == ("error", "CorruptRasterError",
                        "corrupt or unreadable HDF5 container")
    assert ts == js


def test_hdf5_variables():
    data = h5(lambda f: (_ties(f), _hardlinks(f), _non_numeric(f)))
    assert list(th5.hdf5_variables(data).items()) == list(
        jh5.hdf5_variables(data).items())


# ---------------------------------------------------------------------------
# refused unread
# ---------------------------------------------------------------------------

def _external_storage(f, path="no-such-external.raw"):
    f.create_dataset("a", shape=(4, 5), dtype="u2",
                     external=[(path, 0, 40)])


def _vds(f):
    f.create_dataset("src", data=U2[:4, :5])
    layout = h5py.VirtualLayout(shape=(4, 5), dtype="u2")
    layout[:] = h5py.VirtualSource(".", "src", shape=(4, 5))
    f.create_virtual_dataset("virtual", layout, fillvalue=0)


def _external_link(f):
    f.create_dataset("small", data=np.zeros((2, 2), "u1"))
    f["ext"] = h5py.ExternalLink("no-such-file.h5", "/data")


REFUSED = {
    "external-storage": (_external_storage, None, "external raw data"),
    "virtual-dataset": (_vds, "virtual", "virtual dataset"),
    "external-link": (_external_link, "ext", "external link"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_unread(case, monkeypatch):
    """One refusal, naming item 14, for a request body and a local file
    alike."""
    build, variable, what = REFUSED[case]
    data = h5(build)
    kw = {} if variable is None else {"variable": variable}
    want = f"HDF5 {what}.* refused: .*item 14"
    with pytest.raises(th5.HDF5Unsupported, match=want):
        th5.decode_hdf5(data, **kw)
    if variable is None:
        for allow in (False, True):
            with pytest.raises(timage.UnsupportedFormatError, match=want):
                timage.decode_image_bytes(data, allow_sources=allow)


def test_sohm_names_item_14():
    """A shared-message table in the superblock extension (h5py cannot
    ask for one: the file-space message of a ``libver='latest'`` file's
    extension is retyped as the SOHM table, checksum recomputed)."""
    data = bytearray(h5(lambda f: f.create_dataset("a", data=U2),
                        libver="latest", fs_strategy="fsm",
                        fs_persist=True))
    ext = int.from_bytes(data[20:28], "little")
    assert data[ext:ext + 4] == b"OHDR" and data[ext + 5] == 0x20
    (mtype, _, pos, _), = th5._File(bytes(data)).header(ext).messages
    assert mtype == 0x17
    data[pos - 4] = 0x0F
    end = ext + 23 + data[ext + 22]
    data[end:end + 4] = th5.lookup3(bytes(data[ext:end])).to_bytes(
        4, "little")
    with pytest.raises(th5.HDF5Unsupported, match="SOHM.*item 14"):
        th5.decode_hdf5(bytes(data))
    with pytest.raises(timage.UnsupportedFormatError, match="SOHM"):
        timage.sniff_image_info(bytes(data))


# ---------------------------------------------------------------------------
# hostile bytes
# ---------------------------------------------------------------------------

# no MemoryError: every size read from the file is bounded before it is
# allocated
CLEAN = (timage.CorruptRasterError, timage.UnsupportedFormatError,
         ValueError, KeyError, IndexError, EOFError, OSError,
         NotImplementedError, __import__("struct").error, TypeError,
         OverflowError, ZeroDivisionError, ArithmeticError, StopIteration,
         UnicodeDecodeError, AttributeError)
DEADLINE_S = 20


class _Watchdog:
    def __enter__(self):
        def fire(signum, frame):
            raise AssertionError("decoder exceeded the watchdog")
        self._old = signal.signal(signal.SIGALRM, fire)
        signal.alarm(DEADLINE_S)

    def __exit__(self, *exc):
        signal.alarm(0)
        signal.signal(signal.SIGALRM, self._old)
        return False


def _fuzz_fixture(kind):
    if kind == "plain":   # the JAX package's fuzz fixture
        return h5(lambda f: f.create_dataset("band", data=U2[:16, :24]))
    return h5(lambda f: (_nc4(f), _dense(10, 10)(f), f.create_dataset(
        "sz", data=np.tile(U2, (1, 2)), chunks=(8, 29),
        compression="szip")),
        libver="latest", track_order=True)


@pytest.mark.parametrize("kind", ["plain", "rich"])
def test_fuzz_fails_cleanly(kind):
    data = _fuzz_fixture(kind)
    rng = np.random.RandomState(1234 + len(kind))
    cuts = sorted(set(int(c) for c in rng.randint(0, len(data), 40)))
    mutants = [data[:c] for c in cuts]
    buf = bytearray(data)
    for _ in range(80):
        pos, bit = int(rng.randint(0, len(buf))), 1 << int(rng.randint(0, 8))
        buf[pos] ^= bit
        mutants.append(bytes(buf))
        buf[pos] ^= bit
    for i, m in enumerate(mutants):
        with _Watchdog():
            try:
                g = timage.decode_image_bytes(m)
                assert g.array.size >= 0
            except CLEAN:
                pass
            except Exception as e:  # noqa: BLE001
                raise AssertionError(f"mutant {i} raised unclean "
                                     f"{type(e).__name__}: {e}") from e


def _patch(data, name, mtype, old, new):
    """``data`` with the fields ``old`` (little-endian u32s) of dataset
    ``name``'s first message of ``mtype`` set to ``new``; the port's own
    parser finds the message."""
    pos, size = th5._File(data).root[name].header.message(mtype)
    at = data.find(struct.pack(f"<{len(old)}I", *old), pos, pos + size)
    assert at >= 0, (old, mtype)
    return (data[:at] + struct.pack(f"<{len(new)}I", *new)
            + data[at + 4 * len(new):])


def _chunk_dim(maxshape):
    """An LZF-compressed dataset of one chunk column whose chunk declares
    2**31 columns (its B-tree's offsets stay on the grid): the filter
    would be handed a buffer of the chunk's size."""
    z = np.arange(16 * 8, dtype="u2").reshape(16, 8) // 7
    data = h5(lambda f: f.create_dataset("a", data=z, chunks=(8, 8),
                                         maxshape=maxshape,
                                         compression="lzf"))
    return _patch(data, "a", 0x0008, (8, 8, 2), (8, 1 << 31, 2))


def _filter_vals(compression, opts, last):
    """A chunked dataset whose filter's last cd_value is ``last``; its
    data compresses, so that the optional filters are applied."""
    z = np.arange(16 * 16, dtype="u2").reshape(16, 16) // 7
    data = h5(lambda f: f.create_dataset(
        "a", data=z, chunks=(8, 16), compression=compression,
        compression_opts=opts))
    f = th5._File(data)
    vals = th5._pipeline(f, f.root["a"].header)[-1][2]
    return _patch(data, "a", 0x000B, vals, vals[:-1] + (last,))


# each declares billions of bytes in one field of a body of a few KB:
# (a function that writes the body, the port's message)
HOSTILE = {
    "lzf-size-parameter": (lambda: _filter_vals("lzf", None, 0xFFFFFFFF),
                           "LZF size parameter"),
    "chunk-dim-fixed": (lambda: _chunk_dim(None),
                        "more than the file can hold"),
    "chunk-dim-unlimited": (lambda: _chunk_dim((None, None)),
                            "more than the file can hold"),
    "szip-scanline": (lambda: _filter_vals("szip", ("nn", 8), 0xFFFFFFFF),
                      "szip parameters"),
}


@pytest.mark.parametrize("case", sorted(HOSTILE))
def test_hostile_sizes_are_refused_before_allocation(case):
    """A huge size in one field of a small file is refused before any
    allocation for it: the traced peak stays below 8 MiB."""
    build, msg = HOSTILE[case]
    body = build()
    assert len(body) < 8192
    tracemalloc.start()
    try:
        with pytest.raises(ValueError, match=msg):
            th5.decode_hdf5(body)
        with pytest.raises(timage.CorruptRasterError, match=msg):
            timage.decode_image_bytes(body, allow_sources=False)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 8 << 20, peak


def test_native_filters_refuse_huge_parameters():
    """The native filters alone, past the reader's own checks: a
    scanline of more than 4,096 blocks or of less than one returns -1
    before any allocation, as does an LZF reference before the start."""
    lib = th5._filters_lib()
    buf = ctypes.create_string_buffer(64)
    src = bytes(range(64))
    for scanline in [0xFFFFFFFF, 4097 * 8, 4]:
        assert lib.h5_szip_decompress(src, len(src), buf, 64, 32, 8, 16,
                                      scanline) == -1
    assert lib.h5_lzf_decompress(b"\xe0\xff\x00", 3, buf, 64) == -1


def test_declared_sizes_are_refused_before_allocation():
    """A 1 KB file that declares a 100,000-wide raster of fill values:
    h5py allocates it; the port refuses (MAX_SIDE)."""
    data = h5(lambda f: f.create_dataset("a", shape=(2, 100_000),
                                         dtype="u1", fillvalue=1))
    assert len(data) < 4096
    with pytest.raises(ValueError, match="65536"):
        th5.decode_hdf5(data)
    assert th5.sniff_hdf5_info(data).width == 100_000


# ---------------------------------------------------------------------------
# the committed fixtures
# ---------------------------------------------------------------------------

def _fixture_builders():
    z = np.arange(24 * 20, dtype="u2").reshape(24, 20) * 37 % 4093
    f32 = (np.arange(24 * 20, dtype="f4").reshape(24, 20) - 200) / 8
    return {
        "latest-single.h5": ("latest", lambda f: f.create_dataset(
            "a", data=z, chunks=z.shape, compression="gzip")),
        "latest-implicit.h5": ("latest", lambda f: low_level(
            f, "a", z, chunks=(8, 8), alloc_early=True)),
        "latest-fixed-array.h5": ("latest", lambda f: f.create_dataset(
            "a", data=z, chunks=(8, 8), compression="gzip", shuffle=True,
            fletcher32=True)),
        "latest-extensible-array.h5": ("latest", lambda f: f.create_dataset(
            "a", data=z, chunks=(5, 8), maxshape=(None, 20))),
        "latest-btree2.h5": ("latest", lambda f: f.create_dataset(
            "a", data=z, chunks=(8, 8), maxshape=(None, None),
            compression="gzip")),
        "dense.h5": ("latest", _dense(12, 12)),
        "netcdf4.h5": ("earliest", lambda f: _nc4(f)),
        "lzf.h5": ("earliest", lambda f: f.create_dataset(
            "a", data=z, chunks=(8, 8), compression="lzf", shuffle=True)),
        "nbit.h5": ("earliest", _nbit_fixture(z)),
        "szip.h5": ("earliest", lambda f: f.create_dataset(
            "a", data=z, chunks=(8, 20), compression="szip",
            compression_opts=("nn", 8))),
        "scaleoffset.h5": ("latest", lambda f: (
            f.create_dataset("i", data=z.astype("i4"), chunks=(8, 8),
                             scaleoffset=0),
            f.create_dataset("f", data=f32, chunks=(8, 8), scaleoffset=2,
                             dtype="f4"))),
        "external.h5": ("earliest", _external_storage),
    }


def _nbit_fixture(z):
    def build(f):
        t = h5py.h5t.STD_U16LE.copy()
        t.set_precision(12)
        low_level(f, "a", z, chunks=(8, 8), ftype=t, nbit=True)
    return build


def write_fixtures(folder=FIXTURES):
    """Write the committed fixtures and the JAX package's decode of each
    (``.npz``: the array and the RasterInfo as JSON)."""
    os.makedirs(folder, exist_ok=True)
    for name, (libver, build) in _fixture_builders().items():
        data = h5(build, libver=libver)
        with open(os.path.join(folder, name), "wb") as f:
            f.write(data)
        if name == "external.h5":
            continue
        g = jh5.decode_hdf5(data)
        np.savez(os.path.join(folder, name[:-3] + ".npz"), array=g.array,
                 info=np.array(json.dumps(vars(g.info))))


def fixture_paths():
    return sorted(glob.glob(os.path.join(FIXTURES, "*.h5")))


def test_committed_fixtures_decode_to_their_npz():
    paths = fixture_paths()
    assert {os.path.basename(p) for p in paths} == set(_fixture_builders())
    for path in paths:
        data = open(path, "rb").read()
        assert len(data) < 16384, path
        if path.endswith("external.h5"):
            with pytest.raises(timage.UnsupportedFormatError,
                               match="refused"):
                timage.decode_image_bytes(data, allow_sources=False)
            continue
        want = np.load(path[:-3] + ".npz")
        wi = json.loads(str(want["info"]))
        for mod in (jh5, th5):
            g = mod.decode_hdf5(data)
            assert g.array.dtype == want["array"].dtype, path
            assert g.array.tobytes() == want["array"].tobytes(), path
            got = json.loads(json.dumps(vars(g.info)))
            assert got == wi, (path, mod.__name__)


@pytest.mark.parametrize("layout", ["chunked", "contiguous"])
@pytest.mark.parametrize("shape,dtype", [((37, 29), "<u2"),
                                         ((3, 40, 33), "u1"),
                                         ((2, 9, 300), "<f4")])
def test_chip_smoke_writer(layout, shape, dtype):
    """``chip_smoke.py``'s HDF5 writer (the card's host has no h5py):
    h5py reads its files to the arrays written, with the dimension scales
    attached in the contiguous layout, and both packages decode them
    equally, georeferenced."""
    from chip_smoke import hdf5_utm
    a = (RNG.rand(*shape) * 250).astype(dtype)
    data = hdf5_utm(a, GT, 33, layout, nodata=7)
    with h5py.File(io.BytesIO(data), "r") as f:
        d = f["band"]
        assert d.dtype == a.dtype and np.array_equal(d[()], a)
        assert [len(d.dims[i]) for i in range(a.ndim)] == (
            [0] * (a.ndim - 2) + [1, 1] if layout == "contiguous"
            else [0] * a.ndim)
        assert d.attrs["_FillValue"] == 7
    assert_same(data)
    info = th5.decode_hdf5(data).info
    assert (info.geotransform, info.epsg, info.nodata) == (GT, 32633, 7.0)


# ---------------------------------------------------------------------------
# the MP engine, convert and the catalog
# ---------------------------------------------------------------------------

def band_h5(band, gt, epsg, layout="chunked"):
    """One (H, W) band as an HDF5 file with CF x/y coordinates of pixel
    centres, a grid mapping naming the EPSG code and _FillValue 0."""
    h, w = band.shape

    def build(f):
        y = f.create_dataset("y", data=gt[3] + gt[5] * (np.arange(h) + 0.5))
        x = f.create_dataset("x", data=gt[0] + gt[1] * (np.arange(w) + 0.5))
        y.attrs["standard_name"] = "projection_y_coordinate"
        x.attrs["standard_name"] = "projection_x_coordinate"
        crs = f.create_dataset("crs", data=np.int32(0))
        crs.attrs["epsg_code"] = f"EPSG:{epsg}"
        kw = ({"chunks": (min(h, 16), min(w, 16)), "compression": "gzip",
               "shuffle": True} if layout == "chunked" else {})
        d = f.create_dataset("band", data=band, **kw)
        d.attrs["grid_mapping"] = "crs"
        d.attrs["_FillValue"] = np.array(0, band.dtype)
    return h5(build)


@pytest.mark.parametrize("ext,store_as_array", [("h5", False), ("nc", True)])
def test_mp_engine_and_convert(ext, store_as_array, tmp_path):
    """HDF5 chip pairs: the port's MP engine writes the JAX engine's
    shards byte for byte, and ``convert`` the JAX package's PNGs."""
    from dl_image_segmentation_tpu.pipeline.convert import (
        convert_chip_folder as j_convert)
    from dl_image_segmentation_tpu.records.writers import (
        process_dataset_mp as j_mp)
    from dl_image_segmentation_tpu_torch.pipeline.convert import (
        convert_chip_folder as t_convert)
    from dl_image_segmentation_tpu_torch.records.writers import (
        process_dataset_mp as t_mp)
    chips = tmp_path / "chips"
    rng = np.random.RandomState(21)
    for sub in ("images", "labels"):
        (chips / sub).mkdir(parents=True)
    for i in range(3):
        img = rng.randint(1, 3000, (20, 18)).astype(np.uint16)
        name = f"43:2:10.0:{i}:{i}#c{i}.{ext}"
        (chips / "images" / name).write_bytes(band_h5(img, GT, 32643))
        (chips / "labels" / name).write_bytes(band_h5(
            (img % 5).astype(np.uint8), GT, 32643, layout="contiguous"))
    shards = {}
    for name, fn in (("port", t_mp), ("jax", j_mp)):
        out = tmp_path / f"recs-{name}"
        assert fn("c", str(chips), str(out), 1, 1, file_ext=ext,
                  store_as_array=store_as_array) == 3
        shards[name] = (out / "c-00000-of-00001").read_bytes()
    assert shards["port"] == shards["jax"]
    outs = {}
    for name, fn in (("port", t_convert), ("jax", j_convert)):
        dest = tmp_path / f"conv-{name}"
        fn(str(chips), str(dest), file_ext=ext, to="png",
           rescale=(0, 3000))
        outs[name] = {f: (dest / "images" / f).read_bytes()
                      for f in sorted(os.listdir(dest / "images"))}
    assert len(outs["port"]) == 3 and outs["port"].keys() == \
        outs["jax"].keys()
    for f in outs["port"]:
        np.testing.assert_array_equal(timage.decode_png(outs["port"][f]),
                                      jimage.decode_png(outs["jax"][f]))


def test_catalog_scene_of_hdf5_bands(tmp_path):
    """A per-band scene of HDF5 band files (chunked and contiguous)
    loads in the port as the JAX ``LocalCatalog`` loads it, bitwise."""
    from dl_image_segmentation_tpu.catalog.local import (
        LocalCatalog as JLocalCatalog)
    from dl_image_segmentation_tpu.geo import Tile as JTile
    from dl_image_segmentation_tpu_torch.catalog import LocalCatalog
    from dl_image_segmentation_tpu_torch.geo import Tile as TTile
    tile = (60, 2, 10.0, 43, -380, 3491)
    jt, tt = JTile(*tile), TTile(*tile)
    x0, y0, x1, y1 = jt.bounds
    gt = (float(np.floor(x0)) - 40.0, 10.0, 0.0, float(np.ceil(y1)) + 30.0,
          0.0, -10.0)
    h = int((gt[3] - y0) / 10.0) + 8
    w = int((x1 - gt[0]) / 10.0) + 8
    rng = np.random.RandomState(17)
    paths = {}
    for band, layout in (("B02", "chunked"), ("B03", "contiguous")):
        arr = rng.randint(1, 30000, (h, w)).astype(np.uint16)
        arr[rng.rand(h, w) < 0.05] = 0
        paths[band] = str(tmp_path / f"{band}.h5")
        with open(paths[band], "wb") as f:
            f.write(band_h5(arr, gt, 32643, layout))
    root = str(tmp_path / "cat")
    LocalCatalog.create(root)
    idx = {"products": {"s2": {"bands": ["B02", "B03"], "scenes": [
        {"id": "g", "date": "2020-05-01", "band_paths": paths,
         "bounds": list(jt.bounds), "epsg": 32643, "nodata": 0}]}}}
    with open(os.path.join(root, "index.json"), "w") as f:
        json.dump(idx, f)
    got, want = [cat.load(cat.search(t, "s2"), t, ["B03", "B02"], "near")
                 for cat, t in ((LocalCatalog(root), tt),
                                (JLocalCatalog(root), jt))]
    assert got[1].any() and got[0].shape[-1] == 2
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


if __name__ == "__main__":
    write_fixtures()
