"""The port's LocalCatalog, COG windowed reads and resamplers against
the JAX package's, on the CPU: resampled stacks, windowed reads, search
results, the bytes ``add_scene`` writes, and chips exported from a
LocalCatalog root, all bitwise equal."""

import dataclasses
import datetime as dt
import json
import os

import numpy as np
import pytest
import torch

from dl_image_segmentation_tpu.catalog import base as jbase
from dl_image_segmentation_tpu.catalog.local import (
    LocalCatalog as JLocalCatalog)
from dl_image_segmentation_tpu.geo import Tile as JTile
from dl_image_segmentation_tpu.pipeline import chips as jchips
from dl_image_segmentation_tpu.pipeline.export import run_export as j_export
from dl_image_segmentation_tpu.raster.cog import CogReader as JCogReader
from dl_image_segmentation_tpu_torch.catalog import LocalCatalog
from dl_image_segmentation_tpu_torch.catalog import base as tbase
from dl_image_segmentation_tpu_torch.geo import Tile as TTile
from dl_image_segmentation_tpu_torch.pipeline import chips as tchips
from dl_image_segmentation_tpu_torch.pipeline.export import (
    run_export as t_export)
from dl_image_segmentation_tpu_torch.raster.cog import CogReader
from dl_image_segmentation_tpu_torch.raster.geotiff import encode_geotiff
from dl_image_segmentation_tpu_torch.raster.image import (
    UnsupportedFormatError)

from tests.test_torch_pipeline import read_all, write_multi_tile_labels

# one intra-op thread: the test workers share the host's cores
torch.set_num_threads(1)

ZONE = 43
NORTH = (60, 2, 10.0, ZONE, -380, 3491)   # a tile key near Mumbai
SOUTH = (60, 2, 10.0, ZONE, -380, -1700)  # the same column, 10 S
S2_BANDS = ["red", "green", "blue", "nir"]


def scene_over(bounds, tile_zone, src_zone, res, nb, dtype, nodata, seed,
               crop=0.0, south=False):
    """A seeded (h, w, nb) raster in ``src_zone`` covering ``bounds``
    (equator-referenced, in ``tile_zone``) with a 3-pixel margin, its grid
    offset from the tile's by a fraction of a pixel; ``crop`` cuts that
    share of its east side away so tile pixels fall outside it. uint16
    sources get blotches of ``nodata`` in every band. Returns (array,
    geotransform, epsg), the geotransform with the false northing of
    EPSG:327xx when ``south``."""
    x0, y0, x1, y1 = jbase.reproject_bounds(bounds, tile_zone, src_zone,
                                            margin=3 * res)
    x1 -= crop * (x1 - x0)
    gx0, gy1 = x0 + 0.37 * res, y1 - 0.61 * res
    w = int(np.ceil((x1 - gx0) / res))
    h = int(np.ceil((gy1 - y0) / res))
    rng = np.random.RandomState(seed)
    if np.dtype(dtype) == np.uint16:
        arr = rng.randint(1, 60000, (h, w, nb)).astype(np.uint16)
        blot = np.kron(rng.rand(h // 8 + 1, w // 8 + 1) < 0.15,
                       np.ones((8, 8), bool))[:h, :w]
        arr[blot] = nodata
    else:
        arr = (rng.randn(h, w, nb) * 50.0).astype(np.float32)
    gt = (gx0, res, 0.0, gy1 + (1e7 if south else 0.0), 0.0, -res)
    return arr, gt, (32700 if south else 32600) + src_zone


# (tile key, source zone, southern EPSG:327xx) of each placement
CASES = {"same-zone": (NORTH, ZONE, False),
         "zone42-to-43": (NORTH, ZONE - 1, False),
         "south-327xx": (SOUTH, ZONE, True)}


@pytest.mark.parametrize("dtype", ["uint16-nodata", "float32"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("method", list(tbase.RESAMPLERS))
def test_resample_to_tile_bitwise_equal(method, case, dtype):
    """Every resampler, same-zone, cross-zone and southern: the port's
    output and validity are bitwise the JAX package's (tolerance 0)."""
    key, src_zone, south = CASES[case]
    jt, tt = JTile(*key), TTile(*key)
    nodata = 0 if dtype == "uint16-nodata" else None
    arr, gt, epsg = scene_over(jt.bounds, ZONE, src_zone, 7.3, 3,
                               dtype.split("-")[0], nodata, seed=len(case),
                               crop=0.3, south=south)
    want = jbase.resample_to_tile(arr, gt, jt, nodata=nodata,
                                  src_epsg=epsg, method=method)
    got = tbase.resample_to_tile(arr, gt, tt, nodata=nodata, src_epsg=epsg,
                                 method=method)
    assert got[0].dtype == want[0].dtype == arr.dtype
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # the scene's crop leaves tile pixels outside it, and some inside
    assert 0 < want[1].sum() < want[1].size


def _window_root(root, key, src_zone, south):
    """One catalog scene of 2.5 m pixels over ``key``'s tile: ~270 px a
    side, so its 256-px internal tiles are 2 x 2 and a window reads a
    subset of them."""
    jt = JTile(*key)
    arr, gt, epsg = scene_over(jt.bounds, ZONE, src_zone, 2.5, 4,
                               np.uint16, 0, seed=src_zone, south=south)
    cat = LocalCatalog.create(root)
    cat.add_scene("p", S2_BANDS, "big", dt.date(2020, 5, 1), arr, gt, epsg,
         nodata=0)
    return arr


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("method", list(tbase.RESAMPLERS))
def test_load_scene_window_equals_jax_and_whole_decode(tmp_path, method,
                                                       case):
    """load() of a scene read windowed through the port's CogReader
    (window_bytes=0) equals the JAX package's windowed load and the
    port's whole-decode load (the default window_bytes), bitwise."""
    key, src_zone, south = CASES[case]
    root = str(tmp_path / "cat")
    arr = _window_root(root, key, src_zone, south)
    assert max(arr.shape[:2]) > 256
    jt, tt = JTile(*key), TTile(*key)
    windowed, whole = LocalCatalog(root, window_bytes=0), LocalCatalog(root)
    jcat = JLocalCatalog(root, window_bytes=0)
    scenes = windowed.search(tt, "p")
    assert [m.scene_id for m in scenes] == ["big"]
    bands = ["nir", "red"]
    got = windowed.load(scenes, tt, bands, method)
    want = jcat.load(jcat.search(jt, "p"), jt, bands, method)
    ref = whole.load(whole.search(tt, "p"), tt, bands, method)
    for a, b, c in zip(got, want, ref):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert list(windowed._readers) == ["scenes/big.tif"]
    assert not windowed._cache and list(whole._cache) == ["scenes/big.tif"]
    assert got[1].any()


def test_cog_reader_windows_equal_jax(tmp_path):
    """read_window of the port's CogReader over pread equals the JAX
    package's at windows inside, across and outside the image, for a
    tiled LZW scene and an uncompressed one in one strip; the header is
    fetched from a 64-byte first read that has to grow."""
    rng = np.random.RandomState(5)
    arr = rng.randint(0, 65535, (300, 530, 3)).astype(np.uint16)
    for name, blob in (("tiled", encode_geotiff(arr)),
                       ("strip", encode_geotiff(arr, compress="none",
                                                tiled=False))):
        path = tmp_path / f"{name}.tif"
        path.write_bytes(blob)
        with open(path, "rb") as f:
            def fetch(start, length, _f=f):
                return os.pread(_f.fileno(), length, start)
            t, j = CogReader(fetch, initial_header=64), JCogReader(fetch)
            assert dataclasses.asdict(t.info) == dataclasses.asdict(j.info)
            np.testing.assert_array_equal(t.read_full(), arr)
            for win in ((0, 0, 10, 10), (250, 250, 290, 520),
                        (-5, -7, 40, 600), (400, 0, 410, 5)):
                (a, oa), (b, ob) = t.read_window(*win), j.read_window(*win)
                assert oa == ob
                np.testing.assert_array_equal(a, b)


def _search_root(root, cls):
    """Scenes in zones 42 and 43, north and south, over and away from the
    test tiles, with and without cloud fractions."""
    cat = cls.create(root)
    for k, (zone, south, date, cf, far) in enumerate([
            (ZONE, False, dt.date(2020, 3, 5), 0.1, False),
            (ZONE - 1, False, dt.date(2020, 1, 9), None, False),
            (ZONE, False, dt.date(2020, 7, 1), 0.6, False),
            (ZONE, False, dt.date(2020, 2, 2), 0.0, True),
            (ZONE - 1, False, dt.date(2019, 12, 30), 0.3, False),
            (ZONE, True, dt.date(2020, 4, 4), 0.2, False)]):
        key = SOUTH if south else NORTH
        b = JTile(*key).bounds
        if far:
            b = [v + 5000.0 for v in b]
        arr, gt, epsg = scene_over(b, ZONE, zone, 20.0, 2, np.uint16, 0,
                                   seed=k, south=south)
        cat.add_scene("p", ["a", "b"], f"s{k}", date, arr, gt, epsg,
             cloud_fraction=cf, nodata=0)
    return cat


@pytest.mark.parametrize("indexed_bounds", [True, False])
def test_search_equals_jax(tmp_path, indexed_bounds):
    """The same ids in the same order as the JAX package's search, for
    tiles north, south and away from every scene, with date and cloud
    filters; with bounds in index.json and, without them, from each
    scene's header."""
    root = str(tmp_path / "cat")
    _search_root(root, LocalCatalog)
    if not indexed_bounds:
        idx = json.load(open(os.path.join(root, "index.json")))
        for s in idx["products"]["p"]["scenes"]:
            del s["bounds"], s["epsg"]
        json.dump(idx, open(os.path.join(root, "index.json"), "w"))
    t, j = LocalCatalog(root), JLocalCatalog(root)
    queries = [{}, {"start": dt.date(2020, 1, 1)},
               {"end": dt.date(2020, 3, 5), "max_cloud_fraction": 0.2},
               {"max_cloud_fraction": 0.0}]
    seen = set()
    for key in (NORTH, SOUTH, (60, 2, 10.0, ZONE, -300, 3491)):
        for q in queries:
            got = [(m.scene_id, m.date, m.cloud_fraction, m.extra)
                   for m in t.search(TTile(*key), "p", **q)]
            want = [(m.scene_id, m.date, m.cloud_fraction, m.extra)
                    for m in j.search(JTile(*key), "p", **q)]
            assert got == want
            seen |= {g[0] for g in got}
    assert seen == {"s0", "s1", "s2", "s4", "s5"}
    assert t.products() == j.products() and t.bands("p") == j.bands("p")


def test_add_scene_writes_the_jax_bytes(tmp_path):
    """index.json and every scene file that add_scene writes are byte
    for byte the JAX package's (uint16 with nodata, float32, southern)."""
    roots = {}
    for name, cls in (("jax", JLocalCatalog), ("port", LocalCatalog)):
        root = roots[name] = str(tmp_path / name)
        _search_root(root, cls)
        cat = cls(root)
        arr = np.random.RandomState(1).randn(40, 30, 2).astype(np.float32)
        cat.add_scene("q", ["x", "y"], "f32", dt.date(2021, 1, 1), arr,
                      (300000.0, 5.0, 0.0, 2100000.0, 0.0, -5.0), 32643)
    for rel in ["index.json"] + [f"scenes/{n}" for n in sorted(
            os.listdir(os.path.join(roots["jax"], "scenes")))]:
        with open(os.path.join(roots["jax"], rel), "rb") as a, \
                open(os.path.join(roots["port"], rel), "rb") as b:
            assert a.read() == b.read(), rel
    assert len(os.listdir(os.path.join(roots["port"], "scenes"))) == 7


def export_root(root, cls, nearest_product="airbus:oneatlas:phr:v2"):
    """A LocalCatalog root over the 3 x 2 tiles of
    ``write_multi_tile_labels``: four Sentinel-2 scenes (uint16, nodata
    0; one in zone 42, one at 20 m, one covering half the block) and two
    scenes of another product for the nearest-date mosaic."""
    cat = cls.create(root)
    jt = JTile(*NORTH)
    x0, y0, x1, y1 = jt.bounds
    span = x1 - x0
    block = [x0, y0 - span, x1 + 2 * span, y1]
    for k, (zone, res, crop, date) in enumerate([
            (ZONE, 10.0, 0.0, dt.date(2020, 10, 3)),
            (ZONE - 1, 10.0, 0.0, dt.date(2020, 10, 20)),
            (ZONE, 20.0, 0.0, dt.date(2020, 11, 9)),
            (ZONE, 10.0, 0.5, dt.date(2020, 12, 1))]):
        arr, gt, epsg = scene_over(block, ZONE, zone, res, 4, np.uint16, 0,
                                   seed=10 + k, crop=crop)
        cat.add_scene("sentinel-2:L1C", S2_BANDS, f"s2-{k}", date, arr, gt,
             epsg, cloud_fraction=0.05 * k, nodata=0)
    for k, zone in enumerate((ZONE, ZONE - 1)):
        arr, gt, epsg = scene_over(block, ZONE, zone, 10.0, 3, np.uint16, 0,
                                   seed=20 + k, crop=0.4 * (1 - k))
        cat.add_scene(nearest_product, ["red", "green", "blue"], f"rgb-{k}",
             dt.date(2020, 10 + k, 15), arr, gt, epsg, nodata=0)
    return root


@pytest.mark.parametrize("product,mcf,bands", [
    ("sentinel-2:L1C", 0, "red green blue nir"),
    ("airbus:oneatlas:phr:v2", None, "red green blue"),
])
def test_local_catalog_export_byte_identical(tmp_path, product, mcf, bands):
    """DLSampleCreationConfig over a LocalCatalog root -> run_export on
    the CPU, per tile and batched: the port's chips are the JAX
    package's bytes (median over scenes of two zones, and the
    nearest-date mosaic)."""
    root = export_root(str(tmp_path / "cat"), LocalCatalog)
    labels = write_multi_tile_labels(str(tmp_path / "l.geojson"),
                                     JTile(*NORTH))
    for batch_tiles in (0, 2):
        def jobs(pkg, cat, name):
            desc = pkg.OGRLabelDataDesc(labels, 0, "cls")
            cfg = pkg.DLSampleCreationConfig(
                60, 2, 10.0, product, bands, str(tmp_path / name), "t",
                desc, max_cloud_fraction=mcf, catalog=cat)
            return cfg.create_tile_job_configs("Loc", 2020,
                                               dt.date(2020, 11, 1))
        j_jobs = jobs(jchips, JLocalCatalog(root), f"jax{batch_tiles}")
        assert len(j_jobs) > 1
        assert j_export(j_jobs, n_workers=2, progress=None,
                        batch_tiles=batch_tiles).ok
        ref = read_all(j_jobs[0].OUTFOLDER)
        t_jobs = jobs(tchips, LocalCatalog(root), f"port{batch_tiles}")
        report = t_export(t_jobs, n_workers=2, progress=None,
                          batch_tiles=batch_tiles, device="cpu")
        assert report.ok and report.attempts == 1
        assert len(ref) == 2 * len(t_jobs)
        assert read_all(t_jobs[0].OUTFOLDER) == ref


class TestNotPorted:
    @pytest.mark.parametrize("root", ["gs://bucket/cat", "s3://bucket/cat",
                                      "https://example.invalid/cat"])
    def test_remote_roots_raise_item_3(self, root):
        with pytest.raises(NotImplementedError, match="item 3"):
            LocalCatalog(root)
        with pytest.raises(NotImplementedError, match="item 3"):
            LocalCatalog.create(root)

    def test_ingest_safe_raises_item_6(self, tmp_path):
        cat = LocalCatalog.create(str(tmp_path / "cat"))
        with pytest.raises(NotImplementedError, match="item 6"):
            cat.ingest_safe(str(tmp_path / "S2A.SAFE"))

    def test_per_band_scenes(self, tmp_path):
        """A scene of per-band files (as ingest_safe writes them): GeoTIFF
        band files load as the JAX package loads them; a JP2 or PNG band
        raises naming item 6, an HDF5 band item 10."""
        root = str(tmp_path / "cat")
        LocalCatalog.create(root)
        jt, tt = JTile(*NORTH), TTile(*NORTH)
        paths = {}
        for k, (band, res) in enumerate((("B02", 10.0), ("B05", 20.0))):
            arr, gt, epsg = scene_over(jt.bounds, ZONE, ZONE, res, 1,
                                       np.uint16, 0, seed=30 + k)
            paths[band] = str(tmp_path / f"{band}.tif")
            with open(paths[band], "wb") as f:
                f.write(encode_geotiff(arr, geotransform=gt, epsg=epsg,
                                       nodata=0))
        idx = {"products": {"s2": {"bands": ["B02", "B05"], "scenes": [
            {"id": "g", "date": "2020-05-01", "band_paths": paths,
             "bounds": list(jt.bounds), "epsg": 32643}]}}}
        with open(os.path.join(root, "index.json"), "w") as f:
            json.dump(idx, f)
        t, j = LocalCatalog(root), JLocalCatalog(root)
        for method in ("near", "cubic"):
            got = t.load(t.search(tt, "s2"), tt, ["B05", "B02"], method)
            want = j.load(j.search(jt, "s2"), jt, ["B05", "B02"], method)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        for magic, item in ((b"\x00\x00\x00\x0cjP  \r\n\x87\n", 6),
                            (b"\x89PNG\r\n\x1a\n", 6),
                            (b"\x89HDF\r\n\x1a\n", 10)):
            with open(paths["B02"], "wb") as f:
                f.write(magic + bytes(64))
            cat = LocalCatalog(root)
            with pytest.raises(UnsupportedFormatError,
                               match=f"item {item}"):
                cat.load(cat.search(tt, "s2"), tt, ["B02"])

