"""The port's remote scene catalogs and records sinks against the JAX
package's, on the CPU: HTTPCatalog and STACCatalog (static and API)
over the same loopback servers give the same scenes, stacks and valid
masks bitwise; processing levels, paging, bearer tokens, retries and
persistent failure; create-chips against each catalog equals the
LocalCatalog export of the same root; LocalDirSink, SignedURLSink and
``push``. Every server is an in-process loopback fixture."""

import contextlib
import datetime as dt
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from dl_image_segmentation_tpu.catalog import http as jhttp
from dl_image_segmentation_tpu.catalog import stac as jstac
from dl_image_segmentation_tpu.catalog.httpserver import (
    SceneServer as JSceneServer)
from dl_image_segmentation_tpu.catalog.stacserver import (
    StacBuilder as JStacBuilder, StacServer as JStacServer)
from dl_image_segmentation_tpu.geo import Tile as JTile
from dl_image_segmentation_tpu.records import sink as jsink
from dl_image_segmentation_tpu_torch import cli as tcli
from dl_image_segmentation_tpu_torch.catalog import (HTTPCatalog,
                                                    LocalCatalog,
                                                    STACCatalog)
from dl_image_segmentation_tpu_torch.catalog.httpserver import SceneServer
from dl_image_segmentation_tpu_torch.catalog.stacserver import (StacBuilder,
                                                               StacServer)
from dl_image_segmentation_tpu_torch.geo import Tile as TTile
from dl_image_segmentation_tpu_torch.records import sink as tsink
from dl_image_segmentation_tpu_torch.records.tfrecord import TFRecordWriter
from dl_image_segmentation_tpu_torch.storage import gcs as tgcs
from dl_image_segmentation_tpu_torch.storage.fake_gcs import FakeGCS
from dl_image_segmentation_tpu_torch.storage.fake_s3 import FakeS3

from tests.test_torch_cli import FOLDER, chips_argv, run, write_labels, \
    write_root
from tests.test_torch_pipeline import read_all

from chip_smoke import put_server, stac_tree_from_root

# one intra-op thread: the test workers share the host's cores
torch.set_num_threads(1)

ZONE = 43
KEY = (60, 2, 10.0, ZONE, -380, 3491)
JT, TT = JTile(*KEY), TTile(*KEY)
EPSG = 32600 + ZONE
SERVERS = {"port": (SceneServer, StacServer),
           "jax": (JSceneServer, JStacServer)}


@pytest.fixture()
def no_backoff(monkeypatch):
    monkeypatch.setattr(tgcs, "_BACKOFF_BASE", 0.0)


def assert_loads_equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# HTTPCatalog
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def catalog_root(tmp_path_factory):
    """A LocalCatalog root: one 2,048² scene (64 internal tiles; the
    chip window sits inside), a small later scene on the tile grid, and
    a two-level product (surface and toa assets, one scene without a
    surface asset)."""
    root = str(tmp_path_factory.mktemp("httpcat") / "cat")
    cat = LocalCatalog.create(root)
    x0, y0, x1, y1 = TT.bounds
    rng = np.random.RandomState(7)
    big = rng.randint(0, 3000, (2048, 2048, 3)).astype(np.uint16)
    big[:1000:7] = 0
    cat.add_scene("sentinel-2:L1C", ["red", "green", "blue"], "big",
                  dt.date(2020, 10, 20), big,
                  (x0 - 9600.0, 10.0, 0.0, y1 + 9600.0, 0.0, -10.0),
                  EPSG, cloud_fraction=0.05, nodata=0)
    small = rng.randint(0, 3000, (64, 64, 3)).astype(np.uint16)
    cat.add_scene("sentinel-2:L1C", ["red", "green", "blue"], "small",
                  dt.date(2020, 11, 5), small, TT.geotrans, EPSG,
                  cloud_fraction=0.01)
    from dl_image_segmentation_tpu_torch.raster.geotiff import write_geotiff
    for name, v in (("lv_sr", 100), ("lv_toa", 200)):
        write_geotiff(os.path.join(root, "scenes", f"{name}.tif"),
                      np.full((64, 64, 1), v, np.uint16),
                      geotransform=TT.geotrans, epsg=EPSG)
    with open(os.path.join(root, "index.json")) as f:
        idx = json.load(f)
    bounds = [x0, y0, x1, y1]
    idx["products"]["levels:demo"] = {"bands": ["b"], "scenes": [
        {"id": "lv", "date": "2020-06-01", "bounds": bounds,
         "assets": {"surface": "scenes/lv_sr.tif",
                    "toa": "scenes/lv_toa.tif"}},
        {"id": "lv-missing", "date": "2020-06-02", "bounds": bounds,
         "assets": {"toa": "scenes/lv_toa.tif"}}]}
    with open(os.path.join(root, "index.json"), "w") as f:
        json.dump(idx, f)
    return root


@pytest.mark.parametrize("resampler", ["near", "bilinear", "cubic"])
@pytest.mark.parametrize("server", ["port", "jax"])
def test_http_catalog_loads_equal_jax_and_local(catalog_root, server,
                                                resampler):
    """Scene ids, stacks and valid masks of the port's HTTPCatalog equal
    the JAX package's over the same server, and the port's LocalCatalog
    of the root, bitwise."""
    local = LocalCatalog(catalog_root)
    with SERVERS[server][0](catalog_root) as srv:
        t, j = HTTPCatalog(srv.url), jhttp.HTTPCatalog(srv.url)
        kw = dict(start=dt.date(2020, 1, 1), end=dt.date(2020, 12, 31),
                  max_cloud_fraction=0.2)
        ts = t.search(TT, "sentinel-2:L1C", **kw)
        js = j.search(JT, "sentinel-2:L1C", **kw)
        ls = local.search(TT, "sentinel-2:L1C", **kw)
        assert [m.scene_id for m in ts] == [m.scene_id for m in js] == \
            [m.scene_id for m in ls] == ["big", "small"]
        got = t.load(ts, TT, ["blue", "red"], resampler=resampler)
        assert_loads_equal(got, j.load(js, JT, ["blue", "red"],
                                       resampler=resampler))
        assert_loads_equal(got, local.load(ls, TT, ["blue", "red"],
                                           resampler=resampler))
        assert not got[1].all() and got[1].any()
        assert sorted(t._readers) == ["scenes/big.tif", "scenes/small.tif"]


def test_http_catalog_windowed_reads_stay_small(catalog_root):
    size = os.path.getsize(os.path.join(catalog_root, "scenes", "big.tif"))
    with SceneServer(catalog_root) as srv:
        t = HTTPCatalog(srv.url)
        t.load([m for m in t.search(TT, "sentinel-2:L1C")
                if m.scene_id == "big"], TT, ["red"])
        assert srv.range_requests > 0
        assert srv.bytes_served < size * 0.12, (srv.bytes_served, size)


def test_http_catalog_processing_level_equals_jax(catalog_root, capsys):
    with SceneServer(catalog_root) as srv:
        for level in ("surface", "toa", None):
            t = HTTPCatalog(srv.url, processing_level=level)
            j = jhttp.HTTPCatalog(srv.url, processing_level=level)
            ts, js = t.search(TT, "levels:demo"), j.search(JT, "levels:demo")
            assert [m.scene_id for m in ts] == [m.scene_id for m in js]
            assert t.skipped_levels == j.skipped_levels == (level ==
                                                            "surface")
            assert_loads_equal(t.load(ts, TT, ["b"]), j.load(js, JT, ["b"]))
        t = HTTPCatalog(srv.url)
        assert [m.scene_id for m in t.search(TT, "levels:demo")] == ["lv"]
        assert (t.load(t.search(TT, "levels:demo"), TT, ["b"])[0]
                == 100).all()
        over = t.search(TT, "levels:demo", processing_level="toa")
        assert [m.scene_id for m in over] == ["lv", "lv-missing"]
    assert "has no 'surface' asset" in capsys.readouterr().err


def test_http_catalog_retries_and_persistent_failure(catalog_root,
                                                     no_backoff):
    with SceneServer(catalog_root) as srv:
        t = HTTPCatalog(srv.url)
        scenes = t.search(TT, "sentinel-2:L1C")
        srv.fail_next(2, status=503)
        stack, _ = t.load(scenes[:1], TT, ["red"])
        assert stack.shape[0] == 1
        srv.fail_next(1000, status=503)
        with pytest.raises(tgcs.GCSError) as ei:
            HTTPCatalog(srv.url, max_attempts=2)
        assert ei.value.status == 503
    with SceneServer(os.path.dirname(catalog_root)) as srv:
        with pytest.raises(FileNotFoundError):
            HTTPCatalog(srv.url)


# ---------------------------------------------------------------------------
# STACCatalog
# ---------------------------------------------------------------------------

def _build_stac(builder_cls, root):
    """One collection with a 3-band asset, a band-per-asset item (green
    at 20 m), filter fodder (cloudy, late, far), mixed asset dtypes, and
    a processing-level collection."""
    b = builder_cls(root)
    b.add_collection("s2", bands=["red", "green", "blue"])
    rng = np.random.RandomState(11)
    x0, y0, x1, y1 = TT.bounds
    n = TT.raster_size
    multi = rng.randint(0, 3000, (n, n, 3)).astype(np.uint16)
    multi[::5, ::3] = 0

    def item(cid, iid, date, assets, **kw):
        b.add_item(cid, iid, date, {
            k: {"geotransform": TT.geotrans, "epsg": EPSG, **v}
            for k, v in assets.items()}, **kw)

    three = {"data": {"array": multi, "nodata": 0,
                      "eo_bands": ["red", "green", "blue"]}}
    item("s2", "multi", dt.date(2020, 10, 20), three, cloud_cover=5.0)
    item("s2", "perband", dt.date(2020, 11, 5), {
        "red": {"array": rng.randint(0, 3000, (n, n, 1)).astype(np.uint16)},
        "green": {"array": rng.randint(0, 3000, (n // 2, n // 2, 1))
                  .astype(np.uint16),
                  "geotransform": (TT.geotrans[0], 20.0, 0.0,
                                   TT.geotrans[3], 0.0, -20.0)},
        "blue": {"array": rng.randint(0, 3000, (n, n, 1))
                 .astype(np.uint16)}}, cloud_cover=1.0)
    item("s2", "cloudy", dt.date(2020, 11, 6), three, cloud_cover=80.0)
    item("s2", "late", dt.date(2021, 3, 1), three, cloud_cover=0.0)
    item("s2", "far", dt.date(2020, 10, 21), {"data": {
        "array": multi[:32, :32], "eo_bands": ["red", "green", "blue"],
        "geotransform": (x0, 10.0, 0.0, y1 + 500_000.0, 0.0, -10.0)}},
        cloud_cover=0.0)
    item("s2", "mixed", dt.date(2020, 10, 25), {
        "scl": {"array": np.full((n, n, 1), 4, np.uint8),
                "eo_bands": ["scl"]},
        "data": {"array": multi[:, :, :1], "eo_bands": ["red"]}},
        cloud_cover=2.0)
    for iid, v, lvl in (("lv-sr", 100, "L2A"), ("lv-toa", 200, "L1C")):
        item("levels", iid, dt.date(2020, 6, 1), {
            "b": {"array": np.full((n, n, 1), v, np.uint16)}},
            properties={"processing:level": lvl})
    return root


@pytest.fixture(scope="module")
def stac_root(tmp_path_factory):
    return _build_stac(StacBuilder,
                       str(tmp_path_factory.mktemp("stac") / "tree"))


def test_stac_builder_writes_the_jax_tree(tmp_path, stac_root):
    """The port's StacBuilder writes the JAX package's documents and
    assets, byte for byte."""
    ref = _build_stac(JStacBuilder, str(tmp_path / "jax"))
    files = {}
    for base in (stac_root, ref):
        files[base] = {os.path.relpath(os.path.join(d, f), base):
                       open(os.path.join(d, f), "rb").read()
                       for d, _, fs in os.walk(base) for f in fs}
    assert files[stac_root] == files[ref] and len(files[ref]) > 15


@pytest.mark.parametrize("bands", [["red", "green", "blue"],
                                   ["blue", "red"], ["scl", "red"]])
@pytest.mark.parametrize("api", [False, True])
@pytest.mark.parametrize("server", ["port", "jax"])
def test_stac_catalog_loads_equal_jax(stac_root, server, api, bands):
    """Static and API mode, over either package's server: products,
    bands, search results, stacks (band per asset, 20 m green, promoted
    dtypes) and valid masks equal the JAX STACCatalog's bitwise."""
    with SERVERS[server][1](stac_root, api=api) as srv:
        t, j = STACCatalog(srv.url), jstac.STACCatalog(srv.url)
        assert (t._search_url is None) == (not api)
        assert t.products() == j.products() == ["levels", "s2"]
        assert t.bands("s2") == j.bands("s2") == ["red", "green", "blue"]
        kw = dict(start=dt.date(2020, 1, 1), end=dt.date(2020, 12, 31),
                  max_cloud_fraction=0.5)
        ts, js = t.search(TT, "s2", **kw), j.search(JT, "s2", **kw)
        ids = [m.scene_id for m in ts]
        assert ids == [m.scene_id for m in js]
        assert ids == ["multi", "mixed", "perband"]
        assert [m.cloud_fraction for m in ts] == \
            [m.cloud_fraction for m in js]
        # "mixed" carries red and scl, the others red, green and blue
        keep = [("scl" in bands) == (i == "mixed") for i in ids]
        ts = [m for m, k in zip(ts, keep) if k]
        js = [m for m, k in zip(js, keep) if k]
        got = t.load(ts, TT, bands)
        assert_loads_equal(got, j.load(js, JT, bands))
        if "scl" in bands:
            assert got[0].dtype == np.uint16 and (got[0][..., 0] == 4).all()
        else:
            assert got[1][0].sum() < got[1][0].size


def test_stac_paging_level_filter_and_missing_band(stac_root):
    with StacServer(stac_root, api=True) as srv:
        search = srv._search
        srv._search = lambda q: search({**q, "limit": 1})
        t, j = STACCatalog(srv.url), jstac.STACCatalog(srv.url)
        before = srv.search_requests
        ts = t.search(TT, "s2")
        # five items of s2 cross the tile's bbox: one a page
        assert srv.search_requests - before == 5
        assert [m.scene_id for m in ts] == \
            [m.scene_id for m in j.search(JT, "s2")]
        lv = STACCatalog(srv.url, processing_level="L2A")
        assert [m.scene_id for m in lv.search(TT, "levels")] == ["lv-sr"]
        assert [m.scene_id for m in lv.search(
            TT, "levels", processing_level="L1C")] == ["lv-toa"]
        with pytest.raises(ValueError, match="no asset carrying"):
            t.load(ts[:1], TT, ["swir16"])


def test_stac_bearer_token(stac_root, monkeypatch, no_backoff):
    monkeypatch.delenv("STAC_AUTH_TOKEN", raising=False)
    with StacServer(stac_root, api=True, require_token="sekrit") as srv:
        with pytest.raises(tgcs.GCSError) as ei:
            STACCatalog(srv.url)
        assert ei.value.status == 401
        t = STACCatalog(srv.url, token="sekrit")
        j = jstac.STACCatalog(srv.url, token="sekrit")
        ts = t.search(TT, "s2", end=dt.date(2020, 10, 31))
        assert_loads_equal(t.load(ts, TT, ["red"]),
                           j.load(j.search(JT, "s2",
                                           end=dt.date(2020, 10, 31)),
                                  JT, ["red"]))
        monkeypatch.setenv("STAC_AUTH_TOKEN", "sekrit")
        assert STACCatalog(srv.url).products() == ["levels", "s2"]


def test_stac_retries_and_persistent_failure(stac_root, no_backoff):
    with StacServer(stac_root) as srv:
        t = STACCatalog(srv.url)
        srv.fail_next(2, status=503)
        ts = t.search(TT, "s2", end=dt.date(2020, 10, 31))
        assert t.load(ts, TT, ["red"])[0].shape[0] == 2
        srv.fail_next(1000, status=503)
        with pytest.raises(tgcs.GCSError) as ei:
            STACCatalog(srv.url, max_attempts=2)
        assert ei.value.status == 503


# ---------------------------------------------------------------------------
# create-chips against each catalog
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_root(tmp_path_factory):
    """The CLI tests' AOI and four-scene root (one in zone 42), the
    port's LocalCatalog export of it, per tile and batched, and a STAC
    tree of the same scenes."""
    work = tmp_path_factory.mktemp("remote_cli")
    cwd = os.getcwd()
    os.chdir(work)
    try:
        aoi = write_labels("labels.geojson")
        write_root("cat", aoi)
        stac_tree_from_root("cat", "stac")
        ref = {}
        for batch in ("0", "16"):
            assert run(tcli, chips_argv(f"local-{batch}", "cat", [
                "--batch-tiles", batch, "--device", "cpu"]))[0] == 0
            ref[batch] = read_all(f"local-{batch}/{FOLDER}")
    finally:
        os.chdir(cwd)
    return str(work), ref


@pytest.mark.parametrize("batch", ["0", "16"])
@pytest.mark.parametrize("kind", ["http", "stac", "stac-api"])
def test_create_chips_from_remote_catalogs_equal_local(cli_root, tmp_path,
                                                       monkeypatch, kind,
                                                       batch):
    """create-chips --catalog http:// (the root served) and
    stac+http:// (a STAC tree of the same scenes, static and API) on the
    CPU: the chips equal the LocalCatalog export's bytes, with the
    first requests failing (retried)."""
    work, ref = cli_root
    monkeypatch.chdir(work)
    with contextlib.ExitStack() as stack:
        if kind == "http":
            srv = stack.enter_context(SceneServer("cat"))
            url = srv.url
        else:
            srv = stack.enter_context(StacServer("stac",
                                                 api=kind == "stac-api"))
            url = "stac+" + srv.url
        srv.fail_next(3)
        out = str(tmp_path / "out")
        rc, lines = run(tcli, chips_argv(out, url, [
            "--batch-tiles", batch, "--device", "cpu"]))
    assert rc == 0, lines
    got = read_all(os.path.join(out, FOLDER))
    assert got == ref[batch] and len(got) > 2


# ---------------------------------------------------------------------------
# sinks and push
# ---------------------------------------------------------------------------

def make_shards(d, n=3):
    os.makedirs(d, exist_ok=True)
    paths = []
    for i in range(n):
        p = os.path.join(d, "t-%.5d-of-%.5d" % (i, n))
        with TFRecordWriter(p) as w:
            w.write(b"payload-%d" % i * (i + 1))
        paths.append(p)
    return paths


def test_local_dir_sink_manifest_resume_equal_jax(tmp_path, capsys):
    src = str(tmp_path / "src")
    make_shards(src)
    got, want = str(tmp_path / "port"), str(tmp_path / "jax")
    assert len(tsink.push_shards(os.path.join(src, "t-*"),
                                 tsink.LocalDirSink(got))) == 3
    jsink.push_shards(os.path.join(src, "t-*"), jsink.LocalDirSink(want))
    man = json.load(open(os.path.join(got, "manifest.json")))
    assert man == json.load(open(os.path.join(want, "manifest.json")))
    for name, meta in man.items():
        assert os.path.getsize(os.path.join(got, name)) == meta["bytes"]
    capsys.readouterr()
    assert tsink.push_shards(os.path.join(src, "t-*"),
                             tsink.LocalDirSink(got)) == []
    assert "3 already present" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError):
        tsink.push_shards(str(tmp_path / "none-*"), tsink.LocalDirSink(got))


def test_manifest_keeps_every_entry_under_concurrent_sinks(tmp_path):
    """Four sinks on one root, two threads each, 32 shards pushed at
    once with a short switch interval: the manifest ends with all 32
    entries and no temporary file."""
    src = str(tmp_path / "src")
    paths = make_shards(src, n=32)
    root = str(tmp_path / "sink")
    sinks = [tsink.LocalDirSink(root) for _ in range(4)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda k=k: [
            sinks[k % 4].put_shard(p) for p in paths[k::8]])
            for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    man = json.load(open(os.path.join(root, "manifest.json")))
    assert sorted(man) == sorted(os.path.basename(p) for p in paths)
    assert not [f for f in os.listdir(root) if f.endswith(".tmp")]


def test_push_from_s3_to_a_dir_and_signed_urls(tmp_path, monkeypatch):
    """push through cli.main: shards on s3:// (the port's FakeS3) to a
    LocalDirSink (manifest equal to the JAX sink's of the same shards)
    and to presigned PUT URLs on a loopback server."""
    paths = make_shards(str(tmp_path / "src"), n=2)
    with FakeS3() as fake, put_server() as (base, received):
        monkeypatch.setenv("AWS_ENDPOINT_URL_S3", fake.endpoint)
        for p in paths:
            with open(p, "rb") as f:
                fake.objects[("b", "recs/" + os.path.basename(p))] = f.read()
        dest = str(tmp_path / "store")
        assert tcli.main(["push", "--records", "s3://b/recs/t-*",
                          "--dest", dest]) == 0
        jsink.push_shards(paths, jsink.LocalDirSink(str(tmp_path / "j")))
        assert json.load(open(os.path.join(dest, "manifest.json"))) == \
            json.load(open(str(tmp_path / "j" / "manifest.json")))
        urls = {os.path.basename(p): f"{base}/up/{os.path.basename(p)}"
                for p in paths}
        (tmp_path / "urls.json").write_text(json.dumps(urls))
        assert tcli.main(["push", "--records", "s3://b/recs/t-*",
                          "--dest", str(tmp_path / "urls.json")]) == 0
        assert received == {f"/up/{os.path.basename(p)}":
                            open(p, "rb").read() for p in paths}
    assert isinstance(tsink.sink_from_dest(str(tmp_path / "urls.json")),
                      tsink.SignedURLSink)
    with pytest.raises(KeyError, match="no signed URL"):
        tsink.SignedURLSink({}).put_shard(paths[0])


@pytest.mark.parametrize("scheme", ["gs", "s3"])
def test_push_to_a_remote_dest(tmp_path, monkeypatch, capsys, scheme):
    """push --dest gs:// or s3:// through cli.main: every shard's bytes
    and a manifest equal to the JAX sink's of a local root land in the
    port's fake, resume skips them, and no local ``gs:``/``s3:`` tree
    is made."""
    paths = make_shards(str(tmp_path / "src"), n=3)
    pattern = str(tmp_path / "src" / "t-*")
    monkeypatch.chdir(tmp_path)
    fake_cls, env = {"gs": (FakeGCS, "STORAGE_EMULATOR_HOST"),
                     "s3": (FakeS3, "AWS_ENDPOINT_URL_S3")}[scheme]
    with fake_cls() as fake:
        monkeypatch.setenv(env, fake.host if scheme == "gs"
                           else fake.endpoint)
        dest = f"{scheme}://b/store"
        assert tcli.main(["push", "--records", pattern, "--dest",
                          dest]) == 0
        objects = {k[1]: v for k, v in fake.objects.items() if k[0] == "b"}
        jsink.push_shards(paths, jsink.LocalDirSink(str(tmp_path / "j")))
        assert json.loads(objects.pop("store/manifest.json")) == \
            json.load(open(str(tmp_path / "j" / "manifest.json")))
        assert objects == {"store/" + os.path.basename(p):
                           open(p, "rb").read() for p in paths}
        capsys.readouterr()
        assert tcli.main(["push", "--records", pattern, "--dest",
                          dest]) == 0
        assert "0 shard(s), 3 already present" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path)) == ["j", "src"]
