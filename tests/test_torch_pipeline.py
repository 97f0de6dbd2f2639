"""The PyTorch port's chip creation against the JAX package, on the CPU:
catalog scenes, LZW and GeoTIFF bytes, end-to-end chip exports, import
hygiene and device resolution."""

import ast
import datetime as dt
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dl_image_segmentation_tpu import _native
from dl_image_segmentation_tpu.catalog import SyntheticCatalog as JCatalog
from dl_image_segmentation_tpu.geo import Tile as JTile, crs
from dl_image_segmentation_tpu.pipeline import chips as jchips
from dl_image_segmentation_tpu.pipeline.export import run_export as j_export
from dl_image_segmentation_tpu.raster import lzw as jlzw
from dl_image_segmentation_tpu.raster.geotiff import (
    encode_geotiff as j_encode)
from dl_image_segmentation_tpu_torch.catalog import (
    LocalCatalog, SyntheticCatalog as TCatalog, get_default_catalog,
    set_default_catalog)
from dl_image_segmentation_tpu_torch.device import resolve_device
from dl_image_segmentation_tpu_torch.geo import Tile as TTile
from dl_image_segmentation_tpu_torch.pipeline import chips as tchips
from dl_image_segmentation_tpu_torch.pipeline.batch import (
    create_chips_for_tiles_batched)
from dl_image_segmentation_tpu_torch.pipeline.export import (
    run_export as t_export)
from dl_image_segmentation_tpu_torch.raster import lzw as tlzw
from dl_image_segmentation_tpu_torch.raster.geotiff import (
    encode_geotiff as t_encode, write_geotiff as t_write)

from tests.test_pipeline import ZONE, write_labels_geojson

# one intra-op thread: the test workers share the host's cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "dl_image_segmentation_tpu_torch")
BLOCKED = ("jax", "flax", "optax", "orbax", "tensorstore", "zstandard",
           "h5py")


def read_all(folder):
    out = {}
    for sub in ("images", "labels"):
        d = os.path.join(folder, sub)
        for f in sorted(os.listdir(d)):
            with open(os.path.join(d, f), "rb") as fh:
                out[f"{sub}/{f}"] = fh.read()
    return out


class TestHostCopies:
    @pytest.mark.parametrize("product,bands", [
        ("sentinel-2:L1C", ["red", "nir", "swir2"]),
        ("sentinel-2:L1C:dlcloud:v1", ["valid_cloudfree"]),
        ("airbus:oneatlas:phr:v2", ["red", "green", "blue"]),
    ])
    def test_synthetic_scenes_equal(self, product, bands):
        key = "60:2:10.0:43:-380:3491"
        jc, tc = JCatalog(scenes_per_tile=4), TCatalog(scenes_per_tile=4)
        jt, tt = JTile.from_key(key), TTile.from_key(key)
        js = jc.search(jt, product, max_cloud_fraction=0.9)
        ts = tc.search(tt, product, max_cloud_fraction=0.9)
        assert [(m.scene_id, m.date, m.cloud_fraction) for m in js] == \
            [(m.scene_id, m.date, m.cloud_fraction) for m in ts]
        a, b = jc.load(js, jt, bands), tc.load(ts, tt, bands)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)

    def test_lzw_native_equals_python_and_jax(self):
        rng = np.random.RandomState(0)
        for data in (b"", b"a", bytes(rng.randint(0, 4, 20000, np.uint8)),
                     bytes(rng.randint(0, 256, 9000, np.uint8))):
            native = tlzw.lzw_encode_native(data)
            assert native == tlzw.lzw_encode(data) == jlzw.lzw_encode(data)
            assert jlzw.lzw_decode(native) == data
        big = bytes(rng.randint(0, 16, 1 << 20, np.uint8))
        assert tlzw.lzw_encode_native(big) == _native.lzw_encode(big)

    @pytest.mark.parametrize("dtype,shape,kw", [
        (np.uint8, (70, 90), {"nodata": 255, "epsg": 32643}),
        (np.float32, (64, 64, 13), {"epsg": 32743}),
        (np.uint16, (300, 260, 3), {"compress": "deflate"}),
        (np.uint8, (20, 30, 3), {"tiled": False, "nodata": 0.5}),
    ])
    def test_geotiff_bytes_equal(self, dtype, shape, kw, tmp_path):
        rng = np.random.RandomState(1)
        arr = (rng.rand(*shape) * 250).astype(dtype)
        gt = (499980.0, 10.0, 0.0, 34920020.0, 0.0, -10.0)
        data = t_encode(arr, geotransform=gt, **kw)
        assert data == j_encode(arr, geotransform=gt, **kw)
        path = str(tmp_path / "a.tif")
        t_write(path, arr, geotransform=gt, **kw)
        with open(path, "rb") as f:
            assert f.read() == data


@pytest.mark.parametrize("ext", [".geojson", ".shp", ".gpkg"])
def test_vector_readers_equal_jax(ext, tmp_path):
    """The port's GeoJSON, Shapefile and GeoPackage readers give the JAX
    package's layers for files that package's writers made."""
    from dl_image_segmentation_tpu.geo import gpkg as jgpkg, vector as jvec
    from dl_image_segmentation_tpu_torch.geo import vector as tvec
    src = write_multi_tile_labels(str(tmp_path / "src.geojson"),
                                  JTile(60, 2, 10.0, ZONE, -380, 3491))
    layer = jvec.open_vector(src).get_layer(0)
    path = str(tmp_path / f"labels{ext}")
    {".geojson": jvec.write_geojson, ".shp": jvec.write_shapefile,
     ".gpkg": jgpkg.write_gpkg}[ext](path, layer)
    ref, got = jvec.open_vector(path), tvec.open_vector(path)
    assert got.layer_names() == ref.layer_names()
    for a, b in zip(ref.layers(), got.layers()):
        assert (a.name, a.crs_epsg) == (b.name, b.crs_epsg)
        assert len(a.features) == len(b.features) == 9
        for fa, fb in zip(a.features, b.features):
            assert fa.properties == fb.properties
            pa, pb = fa.geometry.polygons(), fb.geometry.polygons()
            assert len(pa) == len(pb)
            for ra, rb in zip(pa, pb):
                assert len(ra) == len(rb)
                for x, y in zip(ra, rb):
                    np.testing.assert_array_equal(x, y)


def write_multi_tile_labels(path, tile, n=9, seed=0):
    """Seeded star polygons, some with holes, scattered over a 3 x 2
    block of tiles and crossing tile edges."""
    rng = np.random.RandomState(seed)
    x0, y0, x1, y1 = tile.bounds_unpadded
    span = x1 - x0
    feats = []
    for i in range(n):
        c = np.array([x0 + rng.rand() * 3 * span, y0 + rng.rand() * 2 * span])
        k = rng.randint(3, 30)
        ang = np.sort(rng.rand(k) * 2 * np.pi)
        rad = (rng.rand(k) * 0.5 + 0.5) * span * (0.1 + 0.4 * rng.rand())
        ext = np.stack([c[0] + rad * np.cos(ang), c[1] + rad * np.sin(ang)],
                       axis=1)
        rings = [ext] + ([c + (ext - c) * 0.3] if i % 3 == 0 else [])
        coords = []
        for ring in rings:
            ring = np.concatenate([ring, ring[:1]])
            lon, lat = crs.utm_to_lonlat(ring[:, 0], ring[:, 1], ZONE)
            coords.append(np.stack([lon, lat], axis=1).tolist())
        feats.append({"type": "Feature",
                      "geometry": {"type": "Polygon", "coordinates": coords},
                      "properties": {"cls": int(rng.randint(1, 5))}})
    with open(path, "w") as f:
        json.dump({"type": "FeatureCollection", "features": feats}, f)
    return path


def _configs(pkg_chips, catalog, labels, root, product, mcf, bands):
    desc = pkg_chips.OGRLabelDataDesc(labels, 0, "cls")
    cfg = pkg_chips.DLSampleCreationConfig(
        64, 2, 10.0, product, bands, root, "t", desc,
        max_cloud_fraction=mcf, catalog=catalog)
    return cfg.create_tile_job_configs("Loc", 2020, dt.date(2020, 11, 1))


class TestEndToEnd:
    """DLSampleCreationConfig -> create_tile_job_configs -> run_export:
    the port's per-tile and batched exports on the CPU write the same
    GeoTIFF bytes as the JAX package's, in median and nearest modes."""

    @pytest.mark.parametrize("product,mcf,bands", [
        ("sentinel-2:L1C", 0, "red green blue nir"),
        ("airbus:oneatlas:phr:v2", None, "red green blue"),
    ])
    def test_exports_byte_identical(self, product, mcf, bands, tmp_path):
        labels = write_multi_tile_labels(
            str(tmp_path / "l.geojson"), JTile(60, 2, 10.0, ZONE, -380, 3491))
        for batch_tiles in (0, 2):
            j_jobs = _configs(jchips, JCatalog(scenes_per_tile=5), labels,
                              str(tmp_path / f"jax{batch_tiles}"), product,
                              mcf, bands)
            assert len(j_jobs) > 1
            j_report = j_export(j_jobs, n_workers=2, progress=None,
                                batch_tiles=batch_tiles)
            ref = read_all(j_jobs[0].OUTFOLDER)
            assert j_report.ok and len(ref) == 2 * len(j_jobs)
            t_jobs = _configs(tchips, TCatalog(scenes_per_tile=5), labels,
                              str(tmp_path / f"torch{batch_tiles}"),
                              product, mcf, bands)
            assert [j.DLTILE.key for j in t_jobs] == \
                [j.DLTILE.key for j in j_jobs]
            report = t_export(t_jobs, n_workers=2, progress=None,
                              batch_tiles=batch_tiles, device="cpu")
            assert report.ok and report.attempts == 1
            assert read_all(t_jobs[0].OUTFOLDER) == ref

    def test_failed_gather_retries_and_device_errors_propagate(
            self, tmp_path):
        """A tile with no scenes keeps the (job, None, None) retry
        protocol; an error in the device stage is not swallowed."""
        tiles = [TTile(60, 2, 10.0, ZONE, -380 + i, 3491) for i in range(3)]
        labels = write_labels_geojson(str(tmp_path / "l.geojson"),
                                      tile=JTile(60, 2, 10.0, ZONE, -379,
                                                 3491))

        class Dropping(TCatalog):
            def search(self, tile, product, **kw):
                if tile.ti == tiles[1].ti:
                    return []
                return super().search(tile, product, **kw)

        def jobs(name, cat):
            return [tchips.DLTileJobConfig(
                dltile=t, out_folder_base=str(tmp_path / name),
                dl_product="sentinel-2:L1C", bands="red green",
                ref_date=dt.date(2020, 11, 1), max_cloud_fraction=None,
                labels_data=labels, label_attr="cls", catalog=cat)
                for t in tiles]

        results = create_chips_for_tiles_batched(
            jobs("b", Dropping(scenes_per_tile=3)), batch_tiles=3,
            device="cpu")
        assert [r[1] is None for r in results] == [False, True, False]
        report = t_export(jobs("p", Dropping(scenes_per_tile=3)),
                          n_workers=2, max_attempts=2, progress=None,
                          device="cpu")
        assert report.failed == [tiles[1].key] and report.attempts == 2

        class Broken(TCatalog):
            def load(self, scenes, tile, bands, resampler="near"):
                stack, valid = super().load(scenes, tile, bands, resampler)
                return stack, valid[:, :-1]  # wrong shape: device stage

        for batch_tiles in (0, 3):
            with pytest.raises(RuntimeError):
                t_export(jobs(f"x{batch_tiles}", Broken(scenes_per_tile=3)),
                         n_workers=2, progress=None,
                         batch_tiles=batch_tiles, device="cpu")


class TestDevice:
    def test_default_device_raises_without_cuda(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present")
        from dl_image_segmentation_tpu_torch.ops import (
            masked_median_composite, rasterize)
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device()
        with pytest.raises(RuntimeError, match="CUDA"):
            rasterize([], (4, 4))
        with pytest.raises(RuntimeError, match="CUDA"):
            masked_median_composite(np.zeros((1, 2, 2, 1), np.uint16),
                                    np.ones((1, 2, 2), bool))
        job = tchips.DLTileJobConfig(
            dltile="60:2:10.0:43:-380:3491",
            out_folder_base=str(tmp_path), dl_product="sentinel-2:L1C",
            ref_date=dt.date(2020, 11, 1), labels_data="none.geojson",
            catalog=TCatalog())
        with pytest.raises(RuntimeError, match="CUDA"):
            t_export([job], progress=None)
        assert resolve_device("cpu").type == "cpu"

    def test_default_catalog_names_missing_local_catalog(self, monkeypatch,
                                                         tmp_path):
        """$DLSEG_CATALOG names a LocalCatalog root, which the default
        catalog resolves to, as in the JAX package."""
        root = str(tmp_path / "cat")
        LocalCatalog.create(root)
        monkeypatch.setenv("DLSEG_CATALOG", root)
        set_default_catalog(None)
        try:
            cat = get_default_catalog()
            assert isinstance(cat, LocalCatalog) and cat.root == root
            assert get_default_catalog() is cat
        finally:
            set_default_catalog(None)


def _imported_names(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _blocked(name):
    top = name.split(".")[0]
    return top in BLOCKED or top == "dl_image_segmentation_tpu"


class TestImportHygiene:
    def test_no_module_names_jax_or_the_jax_package(self):
        files = glob.glob(os.path.join(PORT, "**", "*.py"), recursive=True)
        files += [os.path.join(ROOT, f) for f in ("chip_smoke.py",
                                                  "median_ab.py")]
        for path in files:
            bad = [n for n in _imported_names(path) if _blocked(n)]
            assert not bad, (path, bad)

    def test_codecs_work_with_pil_blocked(self):
        """PNG, JPEG and JPEG 2000 decode and encode (and GIF, BMP
        decode) with PIL, torchvision and the JAX package unimportable:
        the GPU machine has none of them."""
        files = glob.glob(os.path.join(PORT, "**", "*.py"), recursive=True)
        for path in files + [os.path.join(ROOT, "chip_smoke.py")]:
            bad = [n for n in _imported_names(path) if n.split(".")[0] in (
                "PIL", "torchvision", "cv2", "imageio")]
            assert not bad, (path, bad)
        code = f"""
import sys, importlib.abc
BLOCKED = list({BLOCKED!r}) + ["PIL", "torchvision", "cv2", "imageio"]
class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in BLOCKED or top == "dl_image_segmentation_tpu":
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Blocker())
import numpy as np
from dl_image_segmentation_tpu_torch.raster import image
a = (np.arange(24 * 20 * 3) % 251).astype(np.uint8).reshape(24, 20, 3)
assert (image.decode_png(image.encode_png(a)) == a).all()
j = image.encode_jpeg(a, 95)
assert image.decode_jpeg(j).shape == a.shape
assert image.sniff_image_info(j).count == 3
from dl_image_segmentation_tpu_torch.raster import jp2
u16 = (np.arange(37 * 29) * 613 % 65536).astype(np.uint16).reshape(37, 29)
for x in (u16, a):
    got = jp2.decode_jp2(jp2.encode_jp2(x)).array
    assert got.dtype == x.dtype and (got.reshape(x.shape) == x).all()
print("ok", "PIL" in sys.modules)
"""
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.split() == ["ok", "False"]

    def test_every_module_imports_with_jax_blocked(self):
        mods = []
        for path in glob.glob(os.path.join(PORT, "**", "*.py"),
                              recursive=True):
            rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
            mods.append(rel[:-len(".__init__")]
                        if rel.endswith(".__init__") else rel)
        # the training path's modules, the CLI's and the model families'
        # are among them
        training = {f"dl_image_segmentation_tpu_torch.{m}" for m in (
            "records", "records.crc32c", "records.proto", "records.tfrecord",
            "records.example", "records.parsers", "records.writers",
            "pipeline.input", "ops.augment", "train.optim", "train.pool",
            "train.trainer", "models.convert", "cli", "catalog.local",
            "raster.cog", "geo.georef", "utils.webmap", "models.layers",
            "models.deeplab", "models.segformer", "models.quant",
            "storage", "storage.gcs", "storage.s3", "storage.httpread",
            "storage.fake_gcs", "storage.fake_s3", "catalog.http",
            "catalog.httpserver", "catalog.stac", "catalog.stacserver",
            "records.sink", "raster.png", "raster.jpeg", "raster.gif",
            "raster.bmp", "raster.image", "pipeline.convert",
            "utils.preview", "raster.jp2", "storage.zstd", "train.orbax",
            "records.parsers_tf", "utils.profiling", "utils.viz",
            "raster.cf", "raster.netcdf", "raster.vrt", "raster.envi",
            "raster.hdf4", "raster.grib", "raster.nitf",
            "raster.gpkg_raster", "raster.hdf5")}
        assert training <= set(mods), sorted(training - set(mods))
        code = f"""
import sys, importlib, importlib.abc
BLOCKED = {BLOCKED!r}
class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in BLOCKED or top == "dl_image_segmentation_tpu":
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Blocker())
for m in {sorted(mods)!r} + ["chip_smoke", "median_ab"]:
    importlib.import_module(m)
# the facade, the TF parsers and the plots import neither TF nor matplotlib
assert not {{"tensorflow", "matplotlib"}} & set(sys.modules), "TF/mpl"
# the orbax reader runs where orbax, tensorstore and zstandard are missing
orbax = importlib.import_module("dl_image_segmentation_tpu_torch.train.orbax")
tree = orbax.read_checkpoint("tests/data/orbax_unet/ckpt")
assert int(tree["step"]) == 2, tree["step"]
# the HDF5 reader runs where h5py is missing
hdf5 = importlib.import_module("dl_image_segmentation_tpu_torch.raster.hdf5")
g = hdf5.decode_hdf5(open("tests/data/hdf5/netcdf4.h5", "rb").read())
assert g.info.epsg == 32633 and g.array.shape == (6, 7, 1), g.info
print("ok", len(sys.modules))
"""
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.startswith("ok")
