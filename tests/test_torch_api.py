"""The port's public library API against the JAX package, on the CPU:
the facade's 22 names, ``Example`` and ``convert_to_example``, the feature
templates and the graph-mode ``*_tf`` parsers (the one class here that
imports TensorFlow), the GeoJSON, Shapefile and GeoPackage writers, the
tile-grid helpers, profiling and the plots."""

import json
import os
import sqlite3
import subprocess
import sys

import numpy as np
import pytest
import torch

import dl_image_segmentation_tpu as J
import dl_image_segmentation_tpu_torch as T
from dl_image_segmentation_tpu.geo import gpkg as jgpkg
from dl_image_segmentation_tpu.geo import tilegrid as jtilegrid
from dl_image_segmentation_tpu.geo import vector as jvector
from dl_image_segmentation_tpu.records import example as jexample
from dl_image_segmentation_tpu.utils import webmap as jwebmap
from dl_image_segmentation_tpu_torch.geo import gpkg as tgpkg
from dl_image_segmentation_tpu_torch.geo import tilegrid as ttilegrid
from dl_image_segmentation_tpu_torch.geo import vector as tvector
from dl_image_segmentation_tpu_torch.geo.geometry import Geometry
from dl_image_segmentation_tpu_torch.raster.geotiff import encode_geotiff
from dl_image_segmentation_tpu_torch.raster.image import (decode_image,
                                                          encode_png)
from dl_image_segmentation_tpu_torch.records import example as texample
from dl_image_segmentation_tpu_torch.records import parsers as tparsers
from dl_image_segmentation_tpu_torch.utils import profiling, viz
from dl_image_segmentation_tpu_torch.utils import webmap as twebmap

# one intra-op thread: the test workers share the host's cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEMPLATES = ("featuretemplate_bytestring_imagechip",
             "featuretemplate_ndarray_imagechip")
KEYS = ["256:2:10.0:43:-10:1400", "256:2:10.0:43:-9:1400",
        "64:0:1.0:37:12:-3"]


def run_blocked(code, blocked=()):
    """``code`` in a fresh interpreter where ``blocked`` do not import;
    returns its standard output."""
    pre = f"""
import sys, importlib.abc
BLOCKED = {list(blocked)!r}
class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Blocker())
"""
    out = subprocess.run([sys.executable, "-c", pre + code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout


# ---------------------------------------------------------------------------
# the facade
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(n for n in J.__all__
                                        if n not in TEMPLATES))
def test_facade_name_resolves(name):
    """Each of the JAX facade's names is exported by the port's and
    resolves to the port's own object of that name."""
    assert len(J.__all__) == 22
    assert name in T.__all__
    value = getattr(T, name)
    assert callable(value)
    assert value.__module__.startswith("dl_image_segmentation_tpu_torch.")
    assert value.__name__ in (name, {
        "images_to_tfrecords_mp": "process_dataset_mp",
        "images_to_tfrecords_mt": "process_dataset_multithreaded"}.get(name))


def test_import_loads_neither_tensorflow_nor_matplotlib():
    out = run_blocked("""
import dl_image_segmentation_tpu_torch as T
T.convert_to_example, T.parse_encoded_gdal_proto_wrapped
from dl_image_segmentation_tpu_torch.records import parsers_tf
from dl_image_segmentation_tpu_torch.utils import viz, profiling
print(len(T.__all__), "tensorflow" in sys.modules, "matplotlib" in sys.modules)
""")
    n, tf, mpl = out.split()
    assert int(n) >= 22 and (tf, mpl) == ("False", "False")


def test_templates_without_tensorflow():
    """With TensorFlow missing, both packages' templates are the same
    spec dicts."""
    out = run_blocked("""
import json
from dl_image_segmentation_tpu.records import parsers as j
from dl_image_segmentation_tpu_torch.records import parsers as t
names = ("featuretemplate_bytestring_imagechip",
         "featuretemplate_ndarray_imagechip")
print(json.dumps([[getattr(m, n) for n in names] for m in (j, t)]))
""", blocked=["tensorflow"])
    jt, tt = json.loads(out)
    assert jt == tt and len(tt[0]) == 8
    assert tt[1]["image/image_data"] == ["var", "float32"]


# ---------------------------------------------------------------------------
# Example / convert_to_example
# ---------------------------------------------------------------------------

def _pair(kind):
    rng = np.random.RandomState(1)
    img = rng.randint(0, 255, (6, 5, 3)).astype(np.uint8)
    lbl = rng.randint(0, 4, (6, 5)).astype(np.uint8)
    if kind == "uint8":
        return img, lbl
    if kind == "float":
        return img.astype(np.float32) / 7.0, lbl
    if kind == "uint16":
        return img.astype(np.uint16) * 250, lbl.astype(np.float32)
    return encode_png(img), encode_png(lbl)  # raw file bytes


@pytest.mark.parametrize("kind", ["uint8", "float", "uint16", "bytes"])
@pytest.mark.parametrize("tensors", [False, True])
def test_convert_to_example_bytes(kind, tensors):
    """``convert_to_example``'s bytes equal the JAX package's (numpy
    arrays there; here numpy arrays or torch tensors of them)."""
    img, lbl = _pair(kind)
    want = jexample.convert_to_example(img, lbl, 6, 5, 3, 6, 5, "k:1")
    if tensors and kind != "bytes":
        img, lbl = torch.from_numpy(img), torch.from_numpy(lbl)
    got = T.convert_to_example(img, lbl, 6, 5, 3, 6, 5, "k:1")
    assert isinstance(got, texample.Example)
    assert got.SerializeToString() == want.SerializeToString()
    assert bytes(got) == bytes(want) and len(got) == len(want)


# ---------------------------------------------------------------------------
# the graph-mode parsers (the one class that imports TensorFlow)
# ---------------------------------------------------------------------------

class TestTensorFlow:
    @pytest.fixture(scope="class")
    def tf(self):
        return pytest.importorskip("tensorflow")

    def test_templates_equal(self, tf):
        for name in TEMPLATES:
            got, want = getattr(T, name), getattr(J, name)
            assert got == want
            assert isinstance(got["image/height"], tf.io.FixedLenFeature)

    @pytest.mark.parametrize("mode", ["rgbraw", "rgbarr", "tifarr",
                                      "tifraw"])
    def test_tf_parsers_equal_numpy(self, tf, mode):
        rng = np.random.RandomState(2)
        img = rng.randint(0, 255, (9, 7, 3)).astype(np.uint8)
        lbl = rng.randint(0, 4, (9, 7)).astype(np.uint8)
        if mode == "rgbraw":
            pair = (encode_png(img), encode_png(lbl))
            fns = ("parse_encoded_rgb_img_proto_tf",
                   "parse_encoded_rgb_img_proto")
        elif mode == "rgbarr":
            pair = (img, lbl)
            fns = ("parse_8bit_array_proto_tf", "parse_8bit_array_proto")
        elif mode == "tifarr":
            pair = (img.astype(np.float32) * 3.5, lbl.astype(np.float32))
            fns = ("parse_higher_dtype_array_proto_tf",
                   "parse_higher_dtype_array_proto")
        else:
            pair = (encode_geotiff(img.astype(np.uint16) * 100, epsg=32643),
                    encode_geotiff(lbl, epsg=32643))
            fns = ("parse_encoded_gdal_proto_wrapped_tf",
                   "parse_encoded_gdal_proto_wrapped")
        rec = T.convert_to_example(*pair, 9, 7, 3, 9, 7,
                                   "id").SerializeToString()
        want = getattr(tparsers, fns[1])(rec)
        eager = getattr(T, fns[0])(tf.constant(rec))
        mapped, = tf.data.Dataset.from_tensor_slices([rec]).map(
            getattr(T, fns[0]))
        for got in (eager, mapped):
            for g, w in zip(got[:2], want[:2]):
                g = g.numpy()
                assert g.dtype == w.dtype and g.shape == w.shape
                np.testing.assert_array_equal(g, w)
            assert got[2].numpy() == want[2]


# ---------------------------------------------------------------------------
# the geo writers
# ---------------------------------------------------------------------------

def _layer(mod, epsg):
    ring = np.array([[0, 0], [40, 0], [40, 30], [0, 30]], float)
    hole = np.array([[10, 10], [10, 20], [20, 20], [20, 10], [10, 10]],
                    float)
    off = (300000.0, 2100000.0) if epsg != 4326 else (72.8, 19.0)
    sc = 1.0 if epsg != 4326 else 1e-3
    feats = [
        mod.Feature(Geometry([[ring * sc + off, hole * sc + off]]),
                    {"cls": 1, "area_frac": 0.25, "name": "field",
                     "a_long_property": 7}),
        mod.Feature(Geometry([[ring[::-1] * sc + off + 100 * sc],
                              [ring * sc + off + 300 * sc]]),
                    {"cls": 2, "area_frac": 1.5, "name": "town",
                     "a_long_property": 9}),
    ]
    return mod.VectorLayer("labels", feats, epsg)


def _features(path, open_vector):
    layer = open_vector(path).layers()[0]
    return [([[r.tolist() for r in p] for p in f.geometry.polygons()],
             f.properties) for f in layer.features]


def _timestamp_free(path):
    """GeoPackage bytes with gpkg_contents.last_change (the writer's
    clock) blanked out."""
    con = sqlite3.connect(path)
    stamps = [r[0] for r in con.execute(
        "SELECT last_change FROM gpkg_contents")]
    con.close()
    data = open(path, "rb").read()
    for s in stamps:
        data = data.replace(s.encode(), b"x" * len(s))
    return data


@pytest.mark.parametrize("epsg", [4326, 32643, 32743])
@pytest.mark.parametrize("fmt", ["geojson", "shp", "gpkg"])
def test_vector_writers_equal(fmt, epsg, tmp_path):
    """``write_geojson``, ``write_shapefile`` (.shp, .shx, .dbf, .prj)
    and ``write_gpkg`` write the JAX package's bytes, and each package
    reads the other's file to the same features."""
    writers = {"geojson": (tvector.write_geojson, jvector.write_geojson),
               "shp": (tvector.write_shapefile, jvector.write_shapefile),
               "gpkg": (tgpkg.write_gpkg, jgpkg.write_gpkg)}[fmt]
    paths = []
    for side, (write, mod) in enumerate(zip(writers, (tvector, jvector))):
        (tmp_path / str(side)).mkdir()
        path = str(tmp_path / str(side) / f"labels.{fmt}")
        write(path, _layer(mod, epsg))
        paths.append(path)
    if fmt == "shp":
        for ext in (".shp", ".shx", ".dbf", ".prj"):
            a, b = (open(p[:-4] + ext, "rb").read() for p in paths)
            assert a == b, ext
    elif fmt == "gpkg":
        assert _timestamp_free(paths[0]) == _timestamp_free(paths[1])
    else:
        assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    port_on_jax = _features(paths[1], tvector.open_vector)
    jax_on_port = _features(paths[0], jvector.open_vector)
    assert port_on_jax == jax_on_port == _features(paths[0],
                                                   tvector.open_vector)


def test_tile_helpers_equal():
    """``tile_from_key``, ``tiles_to_layer`` and the web map's GeoJSON
    (now built on ``tiles_to_layer``) equal the JAX package's."""
    tt = [ttilegrid.tile_from_key(k) for k in KEYS]
    jt = [jtilegrid.tile_from_key(k) for k in KEYS]
    assert [t.key for t in tt] == [t.key for t in jt] == KEYS
    assert [t.bounds for t in tt] == [t.bounds for t in jt]
    got, want = ttilegrid.tiles_to_layer(tt), jtilegrid.tiles_to_layer(jt)
    assert (got.name, got.crs_epsg) == (want.name, want.crs_epsg)
    for a, b in zip(got.features, want.features):
        assert a.properties == b.properties
        for pa, pb in zip(a.geometry.polygons(), b.geometry.polygons()):
            for ra, rb in zip(pa, pb):
                assert ra.tobytes() == rb.tobytes()
    assert twebmap._tiles_to_geojson(tt) == jwebmap._tiles_to_geojson(jt)


# ---------------------------------------------------------------------------
# profiling and plots
# ---------------------------------------------------------------------------

def test_stage_timer_report():
    st = profiling.StageTimer()
    for _ in range(3):
        with st.stage("decode", items=4, nbytes=1000):
            sum(range(1000))
    with st.stage("write"):
        pass
    assert st.items["decode"] == 12 and st.bytes["decode"] == 3000
    lines = st.report().splitlines()
    assert [ln.split()[0] for ln in lines] == ["decode", "write"]
    assert "items/s" in lines[0] and "MB/s" in lines[0]


def test_duty_cycle_and_trace_on_the_cpu(tmp_path):
    """``duty_cycle`` times the fed and the resident window of a torch
    step on the CPU; ``trace`` writes a Chrome trace. Without a card,
    both raise unless asked for the CPU."""
    w = torch.randn(32, 32)
    seen = []

    def step(x, y):
        seen.append(type(x))
        return (torch.as_tensor(x) @ w).sum() + torch.as_tensor(y).sum()

    batches = iter([(np.ones((8, 32), np.float32), np.zeros(8))] * 20)
    stats = profiling.duty_cycle(step, batches, 5, device="cpu")
    assert set(stats) == {"e2e_seconds", "device_seconds", "steps_per_sec",
                          "duty_cycle"}
    assert 0.0 < stats["duty_cycle"] <= 1.0 and stats["steps_per_sec"] > 0
    assert seen[-5:] == [torch.Tensor] * 5 and len(seen) == 11
    assert profiling.duty(3.0, 4.0) == 0.75 and profiling.duty(1.0, 0) == 0
    with profiling.trace(str(tmp_path / "tr"), device="cpu"):
        step(torch.ones(4, 32), torch.zeros(1))
    with open(tmp_path / "tr" / "trace.json") as f:
        assert "traceEvents" in json.load(f)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            profiling.duty_cycle(step, batches, 1)


def test_viz_writes_pngs(tmp_path):
    pytest.importorskip("matplotlib")
    tiles = [ttilegrid.tile_from_key(k) for k in KEYS[:2]]
    rng = np.random.RandomState(3)
    figs = [viz.plot_tiles(tiles, ttilegrid.tiles_to_layer(tiles)),
            viz.plot_chip_pair(rng.rand(16, 16, 4).astype(np.float32),
                               rng.randint(0, 3, (16, 16)),
                               prediction=rng.randint(0, 3, (16, 16)))]
    for k, fig in enumerate(figs):
        path = str(tmp_path / f"{k}.png")
        viz.save_fig(fig, path)
        arr = decode_image(open(path, "rb").read())
        assert arr.ndim == 3 and arr.shape[0] > 100 and arr.shape[1] > 100
