"""The port's CLI against the JAX package's, on the CPU (``--device
cpu``): the verify sequence at tiny sizes -- chips from the synthetic
catalog and from a LocalCatalog root, shards, inspect and stitch give
the same bytes and lines -- the TrainConfig each command builds from
the same argv, the train command's loss log against a direct loop,
predict, eval and serve of a trained checkpoint, the PNG/JPEG path
(convert, to-tfrecords --engine mt, the default train --mode rgbraw,
inspect --preview), train --remat, orbax checkpoint directories through
train --restore, --save-every resume, eval and predict, and the flags
that reach unported parts."""

import contextlib
import dataclasses
import datetime as dt
import glob
import io
import json
import os
import re
import signal
import shutil
import subprocess
import sys
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from dl_image_segmentation_tpu import cli as jcli
from dl_image_segmentation_tpu.train import trainer as jtrainer
from dl_image_segmentation_tpu_torch import cli as tcli
from dl_image_segmentation_tpu_torch import storage as tst
from dl_image_segmentation_tpu_torch.catalog import LocalCatalog
from dl_image_segmentation_tpu_torch.geo import crs
from dl_image_segmentation_tpu_torch.pipeline.input import (PARSE_FNS,
                                                           TFRecordFeed)
from dl_image_segmentation_tpu_torch.raster.geotiff import read_geotiff
from dl_image_segmentation_tpu_torch.raster.image import decode_image
from dl_image_segmentation_tpu_torch.records.tfrecord import read_records
from dl_image_segmentation_tpu_torch.serve import scale_image
from dl_image_segmentation_tpu_torch.train import orbax as torbax
from dl_image_segmentation_tpu_torch.train import trainer as ttrainer

from tests.test_torch_catalog import scene_over
from tests.test_torch_pipeline import read_all

# one intra-op thread: the test workers share the host's cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOLDER = "s2-cf0p0_10.0m_2pad_64_Mumbai_2020"
MODEL = ["--classes", "3", "--channels", "3", "--features", "8",
         "--levels", "2", "--image-size", "64", "--batch-size", "4"]


def write_labels(path):
    """The verify skill's AOI: two 900 x 700 m polygons near Mumbai,
    classes 1 and 2. Returns their zone-43 bounds."""
    feats, xs, ys = [], [], []
    for i, v in enumerate([1, 2]):
        e0, n0 = crs.lonlat_to_utm(72.85 + 0.01 * i, 19.05, 43)
        ring = [[e0, n0], [e0 + 900, n0], [e0 + 900, n0 + 700],
                [e0, n0 + 700], [e0, n0]]
        xs += [e0, e0 + 900]
        ys += [n0, n0 + 700]
        lonlat = [list(map(float, crs.utm_to_lonlat(x, y, 43)))
                  for x, y in ring]
        feats.append({"type": "Feature", "properties": {"cls": v},
                      "geometry": {"type": "Polygon",
                                   "coordinates": [lonlat]}})
    with open(path, "w") as f:
        json.dump({"type": "FeatureCollection", "features": feats}, f)
    return [min(xs), min(ys), max(xs), max(ys)]


def write_root(root, aoi):
    """A LocalCatalog root of four Sentinel-2 scenes (uint16, nodata 0)
    over the AOI with a 1 km margin, one of them in zone 42."""
    cat = LocalCatalog.create(root)
    block = [aoi[0] - 1000, aoi[1] - 1000, aoi[2] + 1000, aoi[3] + 1000]
    for k, zone in enumerate((43, 42, 43, 43)):
        arr, gt, epsg = scene_over(block, 43, zone, 10.0 + 5 * (k == 2), 3,
                                   np.uint16, 0, seed=40 + k,
                                   crop=0.3 * (k == 3))
        cat.add_scene("sentinel-2:L1C", ["red", "green", "blue"], f"s{k}",
                      dt.date(2020, 9 + k, 10), arr, gt, epsg, nodata=0)
    return root


def run(cli, argv):
    """(exit code, stdout lines) of one in-process CLI call."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue().splitlines()


def chips_argv(out, catalog, extra=()):
    return ["create-chips", "--labels", "labels.geojson", "--attribute",
            "cls", "--product", "sentinel-2:L1C", "--tile-size", "64",
            "--pad", "2", "--resolution", "10.0", "--out", out, "--tag",
            "s2", "--loc", "Mumbai", "--year", "2020", "--ref-date",
            "2020-11-01", "--max-cloud-fraction", "0", "--catalog", catalog,
            "--workers", "2", *extra]


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    """The verify sequence through both CLIs, once: chips (synthetic per
    tile, LocalCatalog root batched), shards, inspect, stitch. Returns
    the working directory and the captured outputs."""
    work = tmp_path_factory.mktemp("cli")
    cwd = os.getcwd()
    os.chdir(work)
    out = {}
    try:
        aoi = write_labels("labels.geojson")
        write_root("cat", aoi)
        for name, cli, extra in (("jax", jcli, []),
                                 ("port", tcli, ["--device", "cpu"])):
            for cat, batch in (("synthetic", "0"), ("cat", "16")):
                rc, lines = run(cli, chips_argv(
                    f"{name}-{cat}", cat, ["--batch-tiles", batch, *extra]))
                out[(name, "chips", cat)] = (rc, lines[0])
            d = f"{name}-cat/{FOLDER}"
            rc, _ = run(cli, ["to-tfrecords", "--name", "mumbai",
                              "--directory", d, "--out", f"{name}-recs",
                              "--shards", "3", "--workers", "3",
                              "--engine", "mp", "--store-as-array"])
            out[(name, "shards")] = rc
            out[(name, "inspect")] = run(
                cli, ["inspect", "--records", f"{name}-recs/mumbai-*",
                      "--verify-crc", "--class-stats"])
            out[(name, "stitch")] = run(
                cli, ["stitch", "--chips", f"{d}/images", "--out",
                      f"{name}-mosaic.tif"])
            out[(name, "map")] = run(
                cli, ["map", "--chips", f"{d}/images", "--labels",
                      "labels.geojson", "--out", f"{name}-map.html"])
    finally:
        os.chdir(cwd)
    return str(work), out


class TestVerifySequence:
    def test_chips_are_byte_identical(self, seq):
        work, out = seq
        for cat in ("synthetic", "cat"):
            (jrc, jline), (trc, tline) = (out[("jax", "chips", cat)],
                                          out[("port", "chips", cat)])
            assert jrc == trc == 0
            assert jline.replace("jax-", "") == tline.replace("port-", "")
            ref = read_all(os.path.join(work, f"jax-{cat}", FOLDER))
            assert len(ref) == 30
            assert read_all(os.path.join(work, f"port-{cat}", FOLDER)) == ref

    def test_shards_inspect_stitch_and_map_are_equal(self, seq):
        work, out = seq
        assert out[("jax", "shards")] == out[("port", "shards")] == 0
        jfiles = sorted(glob.glob(os.path.join(work, "jax-recs", "*")))
        assert len(jfiles) == 3
        for f in jfiles:
            with open(f, "rb") as a, open(f.replace("jax-recs", "port-recs"),
                                          "rb") as b:
                assert a.read() == b.read()
        for step in ("inspect", "stitch"):
            (jrc, jl), (trc, tl) = out[("jax", step)], out[("port", step)]
            assert jrc == trc == 0
            assert [ln.replace("jax-", "") for ln in jl] == \
                [ln.replace("port-", "") for ln in tl]
        assert "suggested --class-weights" in out[("port", "inspect")][1][-1]
        with open(os.path.join(work, "jax-mosaic.tif"), "rb") as a, \
                open(os.path.join(work, "port-mosaic.tif"), "rb") as b:
            assert a.read() == b.read()
        with open(os.path.join(work, "jax-map.html")) as a, \
                open(os.path.join(work, "port-map.html")) as b:
            assert a.read() == b.read()


class _Built(Exception):
    """Raised by the stand-in Trainer once it has its config."""


def _capture_configs(monkeypatch):
    got = {}
    for name, mod in (("jax", jtrainer), ("port", ttrainer)):
        def fake(cfg, *a, _name=name, **kw):
            got[_name] = cfg
            raise _Built
        monkeypatch.setattr(mod, "Trainer", fake)
    return got


ARGV = {
    "train": ["--records", "x", "--mode", "tifarr", "--classes", "5",
              "--channels", "4", "--features", "16", "--levels", "3",
              "--image-size", "128", "--batch-size", "6", "--lr", "0.002",
              "--weight-decay", "0.01", "--schedule", "cosine",
              "--warmup-steps", "7", "--grad-clip-norm", "1.5",
              "--class-weights", "1,2,3,4,5", "--seed", "3", "--steps",
              "42", "--nodata", "0", "--s2d", "2", "--precision", "fp32",
              "--augment", "--augment-invert", "0.1",
              "--augment-brightness", "0.2", "--augment-contrast", "0.3"],
    "eval": ["--records", "x", "--checkpoint", "c", "--classes", "4",
             "--channels", "5", "--features", "12", "--levels", "3",
             "--image-size", "96", "--batch-size", "3", "--nodata", "7",
             "--s2d", "1", "--precision", "fp32"],
    "predict": ["--checkpoint", "c", "--out", "o", "--images", "i",
                "--classes", "6", "--features", "24", "--image-size", "128",
                "--batch-size", "2", "--s2d", "2", "--precision", "fp32"],
    "serve": ["--checkpoint", "c", "--port", "0", "--classes", "7",
              "--channels", "13", "--levels", "5", "--batch-size", "16",
              "--precision", "fp32"],
}
# the other model families and int8 inference
FAMILY = {
    "train": ["--records", "x", "--model", "segformer", "--features", "16"],
    "eval": ["--records", "x", "--checkpoint", "c", "--model", "deeplab"],
    "predict": ["--checkpoint", "c", "--out", "o", "--quantize",
                "int8-static", "--calibrate-records", "r",
                "--calibrate-batches", "2"],
    "serve": ["--checkpoint", "c", "--quantize", "int8"],
}
REQUIRED = {"train": ["--records", "x"],
            "eval": ["--records", "x", "--checkpoint", "c"],
            "predict": ["--checkpoint", "c", "--out", "o"],
            "serve": ["--checkpoint", "c"]}


@pytest.mark.parametrize("flags", ["defaults", "set", "family"])
@pytest.mark.parametrize("cmd", sorted(ARGV))
def test_commands_build_equal_train_configs(monkeypatch, cmd, flags):
    """The same argv through both parsers builds TrainConfigs equal
    field by field (each CLI's Trainer replaced by a recorder)."""
    got = _capture_configs(monkeypatch)
    argv = [cmd] + {"defaults": REQUIRED, "set": ARGV,
                    "family": FAMILY}[flags][cmd]
    for name, cli, extra in (("jax", jcli, []),
                             ("port", tcli, ["--device", "cpu"])):
        with pytest.raises(_Built):
            cli.main(argv + extra)
    assert dataclasses.asdict(got["port"]) == dataclasses.asdict(got["jax"])
    assert type(got["port"]) is ttrainer.TrainConfig


def test_train_log_equals_a_direct_step_loop(seq, tmp_path):
    """train --metrics-log at --log-every 1 on one parse worker: the
    logged losses are the rounded losses of a direct TFRecordFeed ->
    Trainer.train_step loop on the same config and seed, and the saved
    parameters are bitwise the loop's."""
    work, _ = seq
    pattern = os.path.join(work, "port-recs", "mumbai-*")
    log = str(tmp_path / "m.jsonl")
    ckpt = str(tmp_path / "ckpt.pt")
    rc, lines = run(tcli, ["train", "--records", pattern, "--mode", "tifarr",
                           *MODEL, "--steps", "4", "--log-every", "1",
                           "--workers", "1", "--metrics-log", log,
                           "--checkpoint", ckpt, "--device", "cpu"])
    assert rc == 0 and lines[-1] == f"checkpoint saved to {ckpt}"
    logged = [json.loads(ln) for ln in open(log)]
    assert [r["step"] for r in logged] == [0, 1, 2, 3]
    cfg = ttrainer.TrainConfig(num_classes=3, base_features=8, levels=2,
                               image_size=64, batch_size=4, total_steps=4)
    t = ttrainer.Trainer(cfg, device="cpu")
    feed = TFRecordFeed(pattern, "tifarr", batch_size=4, image_size=64,
                        num_workers=1, scale="raw")
    # per_host, as the JAX package's feed takes it: one process owns all
    assert TFRecordFeed(pattern, "tifarr", 4, per_host=False).files == \
        feed.files
    batches = feed.batches()
    losses = [t.train_step(*next(batches))["loss"] for _ in range(4)]
    batches.close()
    assert [r["loss"] for r in logged] == [round(v, 6) for v in losses]
    saved = torch.load(ckpt, weights_only=True)
    assert saved["step"] == 4
    for n, p in t.state.params.items():
        assert torch.equal(saved["params"][n], p.detach()), n


def _train_checkpoint(work, tmp_path, *extra):
    ckpt = str(tmp_path / "model.pt")
    rc, _ = run(tcli, ["train", "--records",
                       os.path.join(work, "port-recs", "mumbai-*"),
                       "--mode", "tifarr", *MODEL, "--steps", "2",
                       "--checkpoint", ckpt, "--device", "cpu", *extra])
    assert rc == 0
    return ckpt


class _FakeJaxTrainer:
    """Stands in for the JAX Trainer in the JAX CLI's predict: zeros."""

    def __init__(self, cfg, *a, **kw):
        self.config = cfg

    def restore_checkpoint(self, path):
        pass

    def predict(self, imgs):
        return np.zeros(imgs.shape[:3], np.int32)


def test_predict_records_names_and_geotags_equal_jax(seq, tmp_path,
                                                     monkeypatch):
    """predict --records over shards that hold every identifier twice:
    the port writes the JAX CLI's file names (duplicates suffixed _2)
    with its geotransforms and EPSG codes; the class maps are the port
    trainer's predict."""
    work, _ = seq
    recs = tmp_path / "recs"
    recs.mkdir()
    for f in glob.glob(os.path.join(work, "port-recs", "*")):
        os.symlink(f, str(recs / os.path.basename(f)))
    rc, _ = run(tcli, ["to-tfrecords", "--name", "again", "--directory",
                       os.path.join(work, "port-cat", FOLDER), "--out",
                       str(recs), "--shards", "1", "--store-as-array"])
    pattern = str(recs / "*")
    ckpt = _train_checkpoint(work, tmp_path)
    monkeypatch.setattr(jtrainer, "Trainer", _FakeJaxTrainer)
    outs = {}
    for name, cli, extra in (("jax", jcli, []),
                             ("port", tcli, ["--device", "cpu"])):
        out = str(tmp_path / f"pred-{name}")
        rc, lines = run(cli, ["predict", "--records", pattern, "--checkpoint",
                              ckpt, "--out", out, "--scale", "none", *MODEL,
                              *extra])
        assert rc == 0 and lines == [f"wrote 30 prediction chips to {out}"]
        outs[name] = {n: read_geotiff(os.path.join(out, n))
                      for n in sorted(os.listdir(out))}
    assert list(outs["port"]) == list(outs["jax"])
    assert sum(n.endswith("_2.tif") for n in outs["port"]) == 15
    for n, g in outs["port"].items():
        j = outs["jax"][n]
        assert (g.info.geotransform, g.info.epsg) == \
            (j.info.geotransform, j.info.epsg) != (None, None)
        assert g.array.dtype == np.uint8 and g.array.shape == (64, 64, 1)
    # the first batch of 4 records: the port trainer's class maps
    t = ttrainer.Trainer(ttrainer.TrainConfig(
        num_classes=3, base_features=8, levels=2, image_size=64,
        batch_size=4), device="cpu")
    t.restore_checkpoint(ckpt)
    first = sorted(glob.glob(pattern))[0]
    parsed = [PARSE_FNS["tifarr"](r) for r in read_records(first)][:4]
    want = t.predict(np.stack([img for img, _, _ in parsed]))
    for (_, _, ident), w in zip(parsed, want):
        name = ident.decode().replace(":", "#") + ".tif"
        np.testing.assert_array_equal(outs["port"][name].array[:, :, 0],
                                      w.astype(np.uint8))


def test_eval_predict_geotiff_and_serve(seq, tmp_path):
    """eval --json, predict of a chip folder and of the stitched raster
    (--geotiff, sliding windows), and serve in a subprocess: /healthz,
    and /predict of a chip equal to predict's class map."""
    work, _ = seq
    ckpt = _train_checkpoint(work, tmp_path, "--scan-steps", "2",
                             "--pool-size", "8")
    rc, lines = run(tcli, ["eval", "--records",
                           os.path.join(work, "port-recs", "mumbai-*"),
                           "--checkpoint", ckpt, *MODEL, "--json",
                           "--device", "cpu"])
    ev = json.loads(lines[-1])
    assert rc == 0 and ev["batches"] == 3 and np.isfinite(ev["loss"])
    images = os.path.join(work, "port-cat", FOLDER, "images")
    rc, lines = run(tcli, ["predict", "--images", images, "--checkpoint",
                           ckpt, "--out", str(tmp_path / "p"), *MODEL,
                           "--device", "cpu"])
    assert rc == 0 and lines == [f"wrote 15 prediction chips to "
                                 f"{tmp_path / 'p'}"]
    rc, lines = run(tcli, ["predict", "--geotiff",
                           os.path.join(work, "port-mosaic.tif"),
                           "--checkpoint", ckpt, "--out",
                           str(tmp_path / "big.tif"), "--stride", "32",
                           *MODEL, "--device", "cpu"])
    big = read_geotiff(str(tmp_path / "big.tif"))
    mosaic = read_geotiff(os.path.join(work, "port-mosaic.tif"))
    assert rc == 0 and big.array.shape[:2] == mosaic.array.shape[:2]
    assert big.info.geotransform == mosaic.info.geotransform
    t = ttrainer.Trainer(ttrainer.TrainConfig(
        num_classes=3, base_features=8, levels=2, image_size=64,
        batch_size=4), device="cpu")
    t.restore_checkpoint(ckpt)
    chip = np.random.RandomState(0).rand(64, 64, 3).astype(np.float32)
    # the server pads its batch of one with zeros
    want = t.predict(np.stack([chip] + [np.zeros_like(chip)] * 3))[0]
    proc = subprocess.Popen(
        [sys.executable, "-m", "dl_image_segmentation_tpu_torch.cli",
         "serve", "--checkpoint", ckpt, "--port", "0", *MODEL, "--device",
         "cpu"], cwd=ROOT, stdout=subprocess.PIPE, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    try:
        line = proc.stdout.readline()
        base = re.search(r"(http://\S+)", line).group(1)
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            assert r.status == 200
        buf = io.BytesIO()
        np.save(buf, chip)
        req = urllib.request.Request(base + "/predict", data=buf.getvalue(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            got = np.load(io.BytesIO(r.read()))
        np.testing.assert_array_equal(got, want)
    finally:
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0


NOT_PORTED = [
    # ported (parallel/): in one process a model axis of 2 names the
    # world it needs
    (["train", "--records", "x", "--mode", "tifarr", "--n-model", "2"],
     ValueError, "needs a world of 2 processes"),
    # ported (JPEG 2000): a path without GRANULE/ is refused as the JAX
    # package refuses it
    (["ingest-safe", "--catalog", "c", "--safe", "s"], FileNotFoundError,
     "not a .SAFE product tree"),
]


@pytest.mark.parametrize("argv,exc,match", NOT_PORTED,
                         ids=[" ".join(a[0:1] + a[-2:]) for a, _, _ in
                              NOT_PORTED])
def test_unported_flags_raise_their_item(argv, exc, match, tmp_path,
                                        monkeypatch):
    # ingest-safe creates its catalog before it reads the SAFE path
    monkeypatch.chdir(tmp_path)
    dev = ["--device", "cpu"] if argv[0] in (
        "train", "predict", "serve", "eval") else []
    with pytest.raises(exc, match=match):
        tcli.main(argv + dev)


@pytest.fixture(scope="module")
def png_seq(seq):
    """The PNG/JPEG path through both CLIs, once, on the LocalCatalog
    chips: convert --to png (rescaled) and --to jpg, then to-tfrecords
    --engine mt of the PNG folders (rgbraw, --store-as-array,
    --png-to-jpg). Returns the working directory."""
    work, _ = seq
    cwd = os.getcwd()
    os.chdir(work)
    try:
        chips = f"port-cat/{FOLDER}"
        for name, cli in (("jax", jcli), ("port", tcli)):
            for to in ("png", "jpg"):
                rc, lines = run(cli, [
                    "convert", "--directory", chips, "--out",
                    f"{name}-{to}", "--to", to, "--rescale", "0", "3000",
                    "--workers", "2", "--quality", "90"])
                assert rc == 0 and lines[-1].startswith("Converted 30 of 30")
            for kind, extra in (("raw", []), ("arr", ["--store-as-array"]),
                                ("jpg", ["--png-to-jpg"])):
                rc, lines = run(cli, [
                    "to-tfrecords", "--name", "rgb", "--directory",
                    f"{name}-png", "--out", f"{name}-mt-{kind}", "--shards",
                    "2", "--workers", "2", "--engine", "mt", *extra])
                assert rc == 0 and lines[-1] == "wrote 15 examples"
    finally:
        os.chdir(cwd)
    return work


def test_convert_equals_jax(png_seq):
    """Replaces the NOT_PORTED convert case: PNG chips decode to the JAX
    package's pixels, JPG chips are its bytes; a second run skips every
    file."""
    work = png_seq
    for sub in ("images", "labels"):
        names = sorted(os.listdir(os.path.join(work, "jax-png", sub)))
        assert len(names) == 15
        assert sorted(os.listdir(os.path.join(work, "port-png", sub))) == \
            names
        for n in names:
            got, want = (decode_image(open(os.path.join(
                work, f"{who}-png", sub, n), "rb").read())
                for who in ("port", "jax"))
            assert got.dtype == want.dtype == np.uint8
            np.testing.assert_array_equal(got, want)
    assert read_all(os.path.join(work, "port-jpg")) == \
        read_all(os.path.join(work, "jax-jpg"))
    rc, lines = run(tcli, ["convert", "--directory",
                           os.path.join(work, "port-cat", FOLDER), "--out",
                           os.path.join(work, "port-png"), "--rescale", "0",
                           "3000"])
    assert rc == 0 and lines[-1].startswith("Converted 0 of 30")


@pytest.mark.parametrize("kind", ["raw", "arr", "jpg"])
def test_to_tfrecords_engine_mt_equals_jax(png_seq, kind):
    """Replaces the NOT_PORTED --engine mt case: from the same PNG chip
    folder (the JAX package's, so that the inputs are equal bytes too),
    the port's MT shards are the JAX CLI's byte for byte."""
    work = png_seq
    out = os.path.join(work, f"port-mt-{kind}-from-jax")
    extra = {"raw": [], "arr": ["--store-as-array"],
             "jpg": ["--png-to-jpg"]}[kind]
    rc, _ = run(tcli, ["to-tfrecords", "--name", "rgb", "--directory",
                       os.path.join(work, "jax-png"), "--out", out,
                       "--shards", "2", "--workers", "2", "--engine", "mt",
                       *extra])
    assert rc == 0
    shards = [{n: open(os.path.join(d, n), "rb").read()
               for n in sorted(os.listdir(d))}
              for d in (out, os.path.join(work, f"jax-mt-{kind}"))]
    assert sorted(shards[0]) == ["rgb-00000-of-00002", "rgb-00001-of-00002"]
    assert shards[0] == shards[1]


def test_train_default_rgbraw_equals_rgbarr(png_seq, tmp_path):
    """Replaces test_unported_inputs_raise_their_item's rgbraw assert:
    train without --mode reads the rgbraw shards; its losses equal the
    same run's from the --store-as-array (rgbarr) shards, which hold the
    same arrays."""
    work = png_seq
    logs = {}
    for kind, mode in (("raw", []), ("arr", ["--mode", "rgbarr"])):
        rc, lines = run(tcli, [
            "train", "--records", os.path.join(work, f"port-mt-{kind}",
                                               "rgb-*"), *mode, *MODEL,
            "--steps", "3", "--log-every", "1", "--workers", "1",
            "--device", "cpu"])
        assert rc == 0
        logs[kind] = [re.search(r"step \d+: loss=\S+ acc=\S+", ln).group(0)
                      for ln in lines if ln.startswith("step ")]
    assert len(logs["raw"]) == 3 and logs["raw"] == logs["arr"]
    # --png-to-jpg transcodes the labels too, and JPEG's rounding moves
    # label values at class edges: every uint8 value is a class here
    wide = [v if MODEL[i - 1] != "--classes" else "256"
            for i, v in enumerate(MODEL)]
    rc, lines = run(tcli, [
        "train", "--records", os.path.join(work, "port-mt-jpg", "rgb-*"),
        *wide, "--steps", "2", "--log-every", "1", "--device", "cpu"])
    assert rc == 0 and sum(ln.startswith("step ") for ln in lines) == 2


def test_inspect_preview_equals_jax(png_seq, tmp_path):
    """Replaces test_unported_inputs_raise_their_item's --preview assert:
    the sheet decodes to the JAX CLI's sheet of the same records."""
    work = png_seq
    recs = os.path.join(work, "jax-mt-raw", "rgb-*")
    sheets = {}
    for name, cli in (("jax", jcli), ("port", tcli)):
        path = str(tmp_path / f"{name}.png")
        rc, lines = run(cli, ["inspect", "--records", recs, "--mode",
                              "rgbraw", "--preview", path,
                              "--preview-count", "3"])
        assert rc == 0
        sheets[name] = (decode_image(open(path, "rb").read()), lines[-1])
    np.testing.assert_array_equal(sheets["port"][0], sheets["jax"][0])
    assert sheets["port"][1] == sheets["jax"][1].replace(
        str(tmp_path / "jax.png"), str(tmp_path / "port.png"))
    assert sheets["port"][0].shape == (3 * 64 + 4 * 4, 2 * 64 + 3 * 4, 3)


def test_model_families_and_int8_through_the_cli(seq, tmp_path):
    """train and eval --model segformer; predict --quantize int8-static
    calibrated on --calibrate-records (the maps of a Trainer calibrated
    on the same batch); eval --quantize int8 on the float checkpoint."""
    work, _ = seq
    recs = os.path.join(work, "port-recs", "mumbai-*")
    seg = str(tmp_path / "seg.pt")
    rc, _ = run(tcli, ["train", "--records", recs, "--mode", "tifarr",
                       *MODEL, "--model", "segformer", "--steps", "2",
                       "--checkpoint", seg, "--device", "cpu"])
    assert rc == 0 and torch.load(seg, weights_only=True)["model"] == \
        "segformer"
    rc, lines = run(tcli, ["eval", "--records", recs, "--checkpoint", seg,
                           *MODEL, "--model", "segformer", "--json",
                           "--device", "cpu"])
    ev = json.loads(lines[-1])
    assert rc == 0 and ev["batches"] == 3 and np.isfinite(ev["loss"])
    ckpt = _train_checkpoint(work, tmp_path)
    images = os.path.join(work, "port-cat", FOLDER, "images")
    out = tmp_path / "q"
    rc, lines = run(tcli, ["predict", "--images", images, "--checkpoint",
                           ckpt, "--out", str(out), *MODEL, "--quantize",
                           "int8-static", "--calibrate-records", recs,
                           "--calibrate-batches", "1", "--device", "cpu"])
    assert rc == 0 and lines == [
        f"int8-static: calibrated activation scales over 1 batch(es) from "
        f"{recs}", f"wrote 15 prediction chips to {out}"]
    t = ttrainer.Trainer(ttrainer.TrainConfig(
        num_classes=3, base_features=8, levels=2, image_size=64,
        batch_size=4, quantize="int8-static"), device="cpu")
    t.restore_checkpoint(ckpt)
    feed = TFRecordFeed(recs, "tifarr", batch_size=4, image_size=64,
                        num_workers=2, repeat=False, scale="raw")
    assert t.calibrate(feed.batches(), max_batches=1) == 1
    names = sorted(os.listdir(images))[:4]  # predict's first batch
    chips = np.stack([read_geotiff(os.path.join(images, n)).array
                      for n in names])
    want = t.predict(scale_image(chips, "auto"))
    got = np.stack([read_geotiff(os.path.join(out, n)).array[:, :, 0]
                    for n in names])
    np.testing.assert_array_equal(got, want.astype(got.dtype))
    rc, lines = run(tcli, ["eval", "--records", recs, "--checkpoint", ckpt,
                           *MODEL, "--quantize", "int8", "--json",
                           "--device", "cpu"])
    ev = json.loads(lines[-1])
    assert rc == 0 and ev["batches"] == 3 and np.isfinite(ev["loss"])


UNSUPPORTED = [
    ["train", "--records", "x", "--mode", "tifarr", "--model", "deeplab",
     "--s2d", "2"],
    ["predict", "--checkpoint", "c", "--out", "o", "--model", "segformer",
     "--quantize", "int8"],
    ["serve", "--checkpoint", "c", "--model", "deeplab", "--quantize",
     "int8-static"],
    ["eval", "--records", "x", "--checkpoint", "c", "--model", "segformer",
     "--s2d", "2"],
]


@pytest.mark.parametrize("argv", UNSUPPORTED,
                         ids=[" ".join(a[0:1] + a[-4:]) for a in UNSUPPORTED])
def test_unet_only_options_raise_for_other_models(argv):
    """--s2d > 1 and --quantize are the U-Net's: the JAX package's
    ValueError, before any file is read."""
    with pytest.raises(ValueError, match="model='unet' only"):
        tcli.main(argv + ["--device", "cpu"])


def test_train_remat_equals_train(seq, tmp_path):
    """train --remat: the loss log and the saved parameters of the run
    without it, bitwise (replaces the NOT_PORTED --remat case)."""
    work, _ = seq
    out = {}
    for name, extra in (("plain", []), ("remat", ["--remat"])):
        ckpt = str(tmp_path / f"{name}.pt")
        rc, lines = run(tcli, ["train", "--records",
                               os.path.join(work, "port-recs", "mumbai-*"),
                               "--mode", "tifarr", *MODEL, "--steps", "2",
                               "--log-every", "1", "--workers", "1",
                               "--checkpoint", ckpt, "--device", "cpu",
                               *extra])
        assert rc == 0
        out[name] = ([re.search(r"loss=\S+ acc=\S+", ln).group(0)
                      for ln in lines if ln.startswith("step")],
                     torch.load(ckpt, weights_only=True))
    assert out["remat"][0] == out["plain"][0] and out["plain"][0]
    for n, p in out["plain"][1]["params"].items():
        assert torch.equal(out["remat"][1]["params"][n], p), n


@pytest.mark.parametrize("flag", ["--spatial", "--fsdp"])
def test_spatial_and_fsdp_train_like_plain_in_one_process(seq, tmp_path,
                                                         flag):
    """train --spatial and train --fsdp in one process (a mesh of one
    rank: nothing to shard) log the losses of a plain train and save its
    parameters, bitwise (replace the NOT_PORTED --spatial and --fsdp
    cases)."""
    work, _ = seq
    out = {}
    for name, extra in (("plain", []), ("flag", [flag])):
        ckpt = str(tmp_path / f"{name}.pt")
        rc, lines = run(tcli, ["train", "--records",
                               os.path.join(work, "port-recs", "mumbai-*"),
                               "--mode", "tifarr", *MODEL, "--steps", "2",
                               "--log-every", "1", "--workers", "1",
                               "--checkpoint", ckpt, "--device", "cpu",
                               *extra])
        assert rc == 0
        out[name] = ([re.search(r"loss=\S+ acc=\S+", ln).group(0)
                      for ln in lines if ln.startswith("step")],
                     torch.load(ckpt, weights_only=True))
    assert out["flag"][0] == out["plain"][0] and len(out["plain"][0]) == 2
    for n, p in out["plain"][1]["params"].items():
        assert torch.equal(out["flag"][1]["params"][n], p), n


def test_orbax_checkpoints_through_the_cli(seq, tmp_path, monkeypatch):
    """The JAX package's orbax checkpoints (written by orbax from the jax
    arrays of a trained .pt's state) take every path the .pt takes:
    eval --checkpoint and predict --checkpoint give the .pt's output,
    train --restore fine-tunes to the .pt fine-tune's parameters, and
    train --checkpoint DIR --save-every resumes a managed orbax
    directory from its newest step, keeping its steps (replaces the
    item-1 raise of test_unported_inputs_raise_their_item)."""
    work, _ = seq
    recs = os.path.join(work, "port-recs", "mumbai-*")
    monkeypatch.chdir(work)
    pt = _train_checkpoint(work, tmp_path)
    t = ttrainer.Trainer(ttrainer.TrainConfig(
        num_classes=3, base_features=8, levels=2, image_size=64,
        batch_size=4), device="cpu")
    t.restore_checkpoint(pt)
    tree = jax.tree_util.tree_map(jnp.asarray, t.orbax_tree())
    single = str(tmp_path / "orbax")
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(single, tree)
    ckptr.wait_until_finished()
    run_dir = str(tmp_path / "run")
    mgr = ocp.CheckpointManager(run_dir)
    mgr.save(2, args=ocp.args.StandardSave(tree))
    mgr.wait_until_finished()
    mgr.close()

    def cli(*argv):
        rc, lines = run(tcli, [*argv, *MODEL, "--device", "cpu"])
        assert rc == 0
        return lines
    assert cli("eval", "--records", recs, "--checkpoint", single,
               "--json") == cli("eval", "--records", recs, "--checkpoint",
                                pt, "--json")
    images = os.path.join(work, "port-cat", FOLDER, "images")
    for src, out in ((pt, "p-pt"), (single, "p-orbax")):
        cli("predict", "--images", images, "--checkpoint", src, "--out",
            str(tmp_path / out))
    outputs = [{f: open(os.path.join(tmp_path, d, f), "rb").read()
                for f in os.listdir(tmp_path / d)}
               for d in ("p-pt", "p-orbax")]
    assert outputs[0] == outputs[1] and len(outputs[0]) == 15
    tuned = {}
    for src in (pt, single):
        out = str(tmp_path / f"tuned-{len(tuned)}.pt")
        cli("train", "--records", recs, "--mode", "tifarr", "--steps", "1",
            "--workers", "1", "--restore", src, "--checkpoint", out)
        tuned[src] = torch.load(out, weights_only=True)
    assert tuned[pt]["step"] == tuned[single]["step"] == 3
    for n, p in tuned[pt]["params"].items():
        assert torch.equal(tuned[single]["params"][n], p), n
    lines = cli("train", "--records", recs, "--mode", "tifarr", "--steps",
                "3", "--workers", "1", "--checkpoint", run_dir,
                "--save-every", "1", "--keep", "1")
    assert "resumed from managed checkpoint step 2" in lines
    # the new step is an orbax step, and --keep 1 prunes step 2 as the
    # JAX CLI's CheckpointManager(max_to_keep=1) does
    assert sorted(os.listdir(run_dir)) == ["3"]
    resumed = ttrainer.Trainer(t.config, device="cpu")
    resumed.restore_checkpoint(os.path.join(run_dir, "3", "default"))
    assert resumed.state.step == 3
    for n, p in tuned[pt]["params"].items():
        assert torch.equal(resumed.state.params[n], p), n


def _in_bucket(fake, prefix):
    """{relative name: bytes} of the fake's objects under ``prefix``."""
    return {k[len(prefix):]: v for (_, k), v in fake.objects.items()
            if k.startswith(prefix)}


@contextlib.contextmanager
def _where(where, monkeypatch, tmp_path):
    """A checkpoint location: a local directory, or a bucket of the port's
    loopback gs:// / s3:// fake (the staging mirrors under ``tmp_path``).
    Yields (its path, the fake or None)."""
    if where == "local":
        yield str(tmp_path / "ck"), None
        return
    from tests.test_torch_storage import serving
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with serving(monkeypatch, where) as fake:
        yield f"{where}://bucket/run/ck", fake


def test_train_checkpoint_is_the_orbax_directory_the_jax_cli_writes(
        seq, tmp_path, monkeypatch):
    """train --checkpoint PATH without .pt writes the orbax directory that
    the JAX CLI's train writes, locally and on gs:// / s3://:
    ocp.StandardCheckpointer, the port's reader and the JAX Trainer
    restore it bitwise as Trainer.orbax_tree() of the same run saved as
    .pt (which stays a torch.save file)."""
    from tests.test_torch_orbax import assert_same, host, jax_trainer
    from tests.test_torch_orbax import state_dict
    work, _ = seq
    recs = os.path.join(work, "port-recs", "mumbai-*")
    argv = ["train", "--records", recs, "--mode", "tifarr", *MODEL,
            "--steps", "2", "--workers", "1", "--device", "cpu"]
    pt = str(tmp_path / "run.pt")
    assert run(tcli, argv + ["--checkpoint", pt])[0] == 0
    t = ttrainer.Trainer(ttrainer.TrainConfig(
        num_classes=3, base_features=8, levels=2, image_size=64,
        batch_size=4), device="cpu")
    t.restore_checkpoint(pt)
    assert torch.load(pt, weights_only=True)["step"] == 2
    tree = t.orbax_tree()
    for where in ("local", "gs", "s3"):
        with _where(where, monkeypatch, tmp_path) as (path, fake):
            rc, lines = run(tcli, argv + ["--checkpoint", path])
            assert rc == 0 and lines[-1] == f"checkpoint saved to {path}"
            assert_same(torbax.read_checkpoint(path), tree)
            local = path
            if fake is not None:
                local = str(tmp_path / f"{where}-copy")
                assert tst.download_dir(path, local) > 3
                assert sorted(_in_bucket(fake, "run/ck/")) == sorted(
                    os.path.relpath(os.path.join(r, f), local)
                    for r, _, fs in os.walk(local) for f in fs)
        assert_same(host(ocp.StandardCheckpointer().restore(local)), tree)
        jt = jax_trainer("constant", host(tree["params"]), seed=1, step=0,
                         image_size=64, batch_size=4)
        jt.restore_checkpoint(local)
        assert_same(host(state_dict(jt.state)), tree)


# (where, --keep): the managed runs checked against orbax's own rotation
MANAGED = [("local", 1), ("local", 2), ("gs", 2), ("s3", 1)]


@pytest.mark.parametrize("where,keep", MANAGED)
def test_save_every_keeps_the_steps_orbax_keeps(seq, tmp_path, monkeypatch,
                                                where, keep):
    """train --save-every 1 --keep K leaves the step directories that
    ocp.CheckpointManager(max_to_keep=K) leaves for the same saves (on
    small numpy trees): saves at 1 and 2, a run that resumes from a
    newer <step>.pt of an earlier port run (left as it is: orbax counts
    only step directories), then saves at 4 and 5; the steps that stay
    before a resume count towards K, and so does an unfinished step
    directory (an integer name without _CHECKPOINT_METADATA), which
    orbax prunes first. Each step holds what orbax writes in a step,
    and nothing is written beside the steps."""
    work, _ = seq
    recs = os.path.join(work, "port-recs", "mumbai-*")
    argv = ["train", "--records", recs, "--mode", "tifarr", *MODEL,
            "--workers", "1", "--device", "cpu"]
    want_dir = str(tmp_path / "orbax")
    unfinished = str(tmp_path / "partial")
    with open(unfinished, "w") as f:
        f.write("an interrupted save")
    for steps in ((1, 2), (4, 5)):
        if steps[0] == 4:
            os.makedirs(os.path.join(want_dir, "0", "default"))
            shutil.copy(unfinished, os.path.join(want_dir, "0", "default"))
        mgr = ocp.CheckpointManager(want_dir, options=(
            ocp.CheckpointManagerOptions(max_to_keep=keep, create=True)))
        for step in steps:
            mgr.save(step, args=ocp.args.StandardSave(
                {"w": np.full(3, step, np.float32),
                 "step": np.asarray(step, np.int32)}))
            mgr.wait_until_finished()
        mgr.close()
    want = sorted(os.listdir(want_dir) + ["3.pt"])
    layout = sorted(os.listdir(os.path.join(want_dir, "5")))
    with _where(where, monkeypatch, tmp_path) as (d, fake):
        managed = ["--checkpoint", d, "--save-every", "1", "--keep",
                   str(keep)]
        assert run(tcli, argv + ["--steps", "2", *managed])[0] == 0
        # a newer .pt step, as an earlier port run left it
        assert run(tcli, argv + ["--steps", "1", "--restore",
                                 f"{d}/2/default", "--checkpoint",
                                 f"{d}/3.pt"])[0] == 0
        if fake is None:
            os.makedirs(os.path.join(d, "0", "default"))
            shutil.copy(unfinished, os.path.join(d, "0", "default"))
        else:
            tst.upload_file(unfinished, f"{d}/0/default/partial")
        rc, lines = run(tcli, argv + ["--steps", "5", *managed])
        assert rc == 0 and "resumed from managed checkpoint step 3" in lines
        if fake is None:
            got = sorted(os.listdir(d))
            step5 = sorted(os.listdir(os.path.join(d, "5")))
        else:
            names = _in_bucket(fake, "run/ck/")
            got = sorted({n.split("/")[0] for n in names})
            step5 = sorted({n.split("/")[1] for n in names
                            if n.startswith("5/")})
        assert got == want and step5 == layout
        assert int(torbax.read_checkpoint(f"{d}/5/default")["step"]) == 5


def test_device_commands_raise_without_a_card(seq, tmp_path, monkeypatch):
    """Without --device cpu the device commands ask for the card, and
    raise where there is none; doctor reports the card's checks as
    failed, the host builds and codecs as passed, and exits 1."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    work, _ = seq
    recs = os.path.join(work, "port-recs", "mumbai-*")
    monkeypatch.chdir(work)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(chips_argv(str(tmp_path / "c"), "synthetic"))
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["train", "--records", recs, "--mode", "tifarr", *MODEL])
    proc = subprocess.run([sys.executable, "-m",
                           "dl_image_segmentation_tpu_torch.cli", "doctor"],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 1
    status = {m.group(2): m.group(1) for m in (
        re.match(r"(OK|FAIL) +(\S+(?: \S+)*)", ln)
        for ln in proc.stdout.splitlines())}
    assert status == {"cuda device": "FAIL", "nvcc": "FAIL",
                      "kernel build": "FAIL", "device kernels": "FAIL",
                      "host builds": "OK", "raster codecs": "OK",
                      "record codec": "OK"}
