"""The PyTorch port's inference surfaces against the JAX package, on the
CPU: window origins, sliding-window prediction, the micro-batching
server and its HTTP endpoints, the GeoTIFF reader and stitch.

Tolerances: predict_windowed at fp32 on the same weights holds the
blended probabilities to 1e-4 absolute + 1e-4 relative of the JAX
package's (measured at most 3.9e-7), and the class maps equal wherever
the JAX blend's top two probabilities differ by more than 1e-3. The
server is held to the port's own offline paths bitwise.
"""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from dl_image_segmentation_tpu.geo import Tile as JTile
from dl_image_segmentation_tpu.pipeline import stitch as jstitch
from dl_image_segmentation_tpu.pipeline import window as jwindow
from dl_image_segmentation_tpu.raster import geotiff as jgeotiff
from dl_image_segmentation_tpu.train import trainer as jtrainer
from dl_image_segmentation_tpu_torch import serve as tserve
from dl_image_segmentation_tpu_torch.geo import Tile as TTile
from dl_image_segmentation_tpu_torch.pipeline import stitch as tstitch
from dl_image_segmentation_tpu_torch.pipeline import window as twindow
from dl_image_segmentation_tpu_torch.raster import geotiff as tgeotiff
from dl_image_segmentation_tpu_torch.raster import image as timage
from dl_image_segmentation_tpu_torch.raster.jp2 import encode_jp2
from dl_image_segmentation_tpu_torch.train import trainer as ttrainer

from tests.test_torch_models import flax_params, jax_trainer, top2_gap

# one intra-op thread: the test workers share the host's cores
torch.set_num_threads(1)

SIZE = 32
CFG = dict(num_classes=3, in_channels=3, base_features=8, levels=2,
           image_size=SIZE, batch_size=4)


def port_trainer(**kw):
    _, params = flax_params()
    t = ttrainer.Trainer(ttrainer.TrainConfig(**{**CFG, **kw}), device="cpu")
    return t.load_flax_params(params)


@pytest.fixture(scope="module")
def live_server():
    trainer = port_trainer()
    ps = tserve.PredictServer(trainer, max_wait_ms=100.0)
    httpd = tserve.make_http_server("127.0.0.1", 0, ps, scale="auto")
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield trainer, ps, f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    ps.close()
    t.join(timeout=30)


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _npy(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _load(body):
    return np.load(io.BytesIO(body))


def batch_of(trainer, img):
    """``img`` in a batch of the server's size, as the server runs it."""
    out = np.zeros((trainer.config.batch_size,) + img.shape, np.float32)
    out[0] = img
    return out


def test_window_origins_equal_jax():
    for size in (4, 8, 16):
        for n in range(1, 40):
            for stride in range(-1, size + 3):
                try:
                    ref = jwindow.window_origins(n, size, stride)
                except ValueError:
                    with pytest.raises(ValueError):
                        twindow.window_origins(n, size, stride)
                    continue
                assert twindow.window_origins(n, size, stride) == ref


@pytest.mark.parametrize("dtype,stride", [(np.float32, 16),
                                          (np.uint8, None)])
def test_predict_windowed_equals_jax(dtype, stride, monkeypatch):
    cfg = {**CFG, "precision": "fp32"}
    _, params = flax_params()
    jt = jax_trainer(jtrainer.TrainConfig(**cfg), monkeypatch, params)
    tt = port_trainer(precision="fp32")
    rng = np.random.RandomState(5)
    img = (rng.rand(70, 45, 3) * (255 if dtype == np.uint8 else 1)).astype(
        dtype)
    ref = jwindow.predict_windowed(jt, img, stride=stride, probs=True)
    got = twindow.predict_windowed(tt, img, stride=stride, probs=True)
    assert got.dtype == np.float32 and got.shape == (70, 45, 3)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    cls = twindow.predict_windowed(tt, img, stride=stride)
    assert cls.dtype == np.int32
    sure = top2_gap(ref) > 1e-3
    np.testing.assert_array_equal(cls[sure], ref.argmax(-1)[sure])
    np.testing.assert_array_equal(cls, got.argmax(-1))


class TestPredictServer:
    def test_served_equals_predict_and_packs_one_batch(self):
        trainer = port_trainer()
        ps = tserve.PredictServer(trainer, max_wait_ms=500.0)
        try:
            imgs = np.random.RandomState(3).rand(4, SIZE, SIZE, 3).astype(
                np.float32)
            # all four are queued well inside the first one's window
            pend = [ps.enqueue(img, probs=False) for img in imgs]
            outs = [ps.wait(p, timeout=60) for p in pend]
            assert all(p.error is None for p in outs), [p.error for p in outs]
            assert ps.batches == 1 and ps.served == 4
            offline = trainer.predict(imgs)
            for p, ref in zip(outs, offline):
                assert p.result.dtype == np.int32
                np.testing.assert_array_equal(p.result, ref)
            p = ps.submit(imgs[1], probs=True, timeout=60)
            np.testing.assert_array_equal(
                p.result, trainer.predict_probs(batch_of(trainer,
                                                         imgs[1]))[0])
        finally:
            ps.close()

    def test_predict_runs_padded_batch_size_chunks(self, monkeypatch):
        """predict, predict_probs and predict_both forward batch_size
        chunks, the last padded with zeros as the server pads a
        dispatch, so each image gets the server's class map whatever N
        the caller passes; the padding never reaches the output."""
        trainer = port_trainer()
        seen = []
        real = trainer.logits

        def logits(x):
            seen.append(x.clone())
            return real(x)
        monkeypatch.setattr(trainer, "logits", logits)
        imgs = np.random.RandomState(4).rand(6, SIZE, SIZE, 3).astype(
            np.float32)
        maps = trainer.predict(imgs)
        assert maps.shape == (6, SIZE, SIZE)
        assert [tuple(x.shape) for x in seen] == [(4, SIZE, SIZE, 3)] * 2
        assert not seen[1][2:].any()
        np.testing.assert_array_equal(seen[1][:2].numpy(), imgs[4:])
        padded = np.zeros_like(imgs[:4])
        padded[:2] = imgs[4:]
        np.testing.assert_array_equal(maps[4:], trainer.predict(padded)[:2])
        assert trainer.predict_probs(imgs[:1]).shape == (1, SIZE, SIZE, 3)
        classes, probs = trainer.predict_both(imgs)
        np.testing.assert_array_equal(classes, maps)
        assert probs.shape == (6, SIZE, SIZE, 3) and len(seen) == 6

    def test_overload_rejected_503_and_close_fails_pending(self):
        trainer = port_trainer(batch_size=2)
        ps = tserve.PredictServer(trainer, max_wait_ms=5.0, max_queue=3)
        gate = threading.Event()
        real = trainer.predict_both
        trainer.predict_both = lambda imgs: (gate.wait(30), real(imgs))[1]
        pendings, threads = [], []
        try:
            img = np.zeros((SIZE, SIZE, 3), np.float32)

            def call():
                pendings.append(ps.submit(img, probs=False, timeout=30))

            for _ in range(ps.max_queue + 2 + 1):
                t = threading.Thread(target=call)
                t.start()
                threads.append(t)
                if ps.rejected:
                    break
                time.sleep(0.05)
            assert ps.rejected >= 1
            rejected = [p for p in pendings if p.error and p.status == 503]
            assert rejected and "overloaded" in rejected[0].error
            ps._stop = True  # stop the loop, then release the jam
            gate.set()
            ps.close()
            for t in threads:
                t.join(timeout=30)
                assert not t.is_alive()
            assert len(pendings) == len(threads)
            assert all(p.result is not None or p.error is not None
                       for p in pendings)
            assert any(p.error == "server shutting down" for p in pendings)
        finally:
            gate.set()
            ps.close()

    def test_worker_failure_surfaces_to_every_caller(self):
        trainer = port_trainer()
        ps = tserve.PredictServer(trainer, max_wait_ms=200.0)
        httpd = tserve.make_http_server("127.0.0.1", 0, ps)
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        real = trainer.predict_both

        def explode(imgs):
            raise RuntimeError("device exploded")
        try:
            trainer.predict_both = explode
            img = np.zeros((SIZE, SIZE, 3), np.float32)
            pend = [ps.enqueue(img, probs=False) for _ in range(3)]
            for p in pend:
                ps.wait(p, timeout=30)
                assert p.error == "RuntimeError: device exploded"
            code, _, body = _post(base + "/predict", _npy(img))
            assert code == 500 and "exploded" in json.loads(body)["error"]
            with pytest.raises(tserve.WindowedError) as e:
                tserve.predict_windowed_batched(
                    ps, np.zeros((40, 40, 3), np.float32))
            assert e.value.status == 500
            assert ps.errors >= 2
            trainer.predict_both = real
            code, _, _ = _post(base + "/predict", _npy(img))
            assert code == 200
        finally:
            trainer.predict_both = real
            httpd.shutdown()
            ps.close()
            t.join(timeout=30)


class TestHTTP:
    def test_healthz(self, live_server):
        _, ps, base = live_server
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            h = json.loads(r.read())
        assert h["ok"] and h["model"] == "unet" and h["step"] == 0
        assert (h["num_classes"], h["batch_size"], h["image_size"]) == \
            (3, 4, SIZE)

    def test_metrics_prometheus_exposition(self, live_server):
        _, ps, base = live_server
        img = np.random.RandomState(0).rand(SIZE, SIZE, 3).astype(
            np.float32)
        for _ in range(2):
            assert _post(base + "/predict", _npy(img))[0] == 200
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            assert r.headers["Content-Type"].startswith("text/plain")
            text = r.read().decode()
        vals = {}
        for line in text.splitlines():
            if line and not line.startswith("#"):
                key, _, v = line.rpartition(" ")
                vals[key] = float(v)
        for name in ("dlseg_requests_served_total", "dlseg_batches_total",
                     "dlseg_requests_rejected_total",
                     "dlseg_batch_errors_total", "dlseg_queue_depth",
                     "dlseg_batch_size"):
            assert f"# TYPE {name} " in text
        assert vals["dlseg_requests_served_total"] >= 2
        assert vals["dlseg_batch_size"] == 4
        for h in ("dlseg_request_latency_seconds",
                  "dlseg_dispatch_latency_seconds"):
            buckets = [vals[k] for k in vals if k.startswith(h + "_bucket")]
            assert buckets == sorted(buckets)
            assert vals[f'{h}_bucket{{le="+Inf"}}'] == vals[f"{h}_count"]

    def test_npy_body_and_probs(self, live_server):
        trainer, _, base = live_server
        img = np.random.RandomState(1).rand(SIZE, SIZE, 3).astype(np.float32)
        code, ctype, body = _post(base + "/predict", _npy(img))
        assert code == 200 and ctype == "application/x-npy"
        cls = _load(body)
        assert cls.dtype == np.int32 and cls.shape == (SIZE, SIZE)
        np.testing.assert_array_equal(
            cls, trainer.predict(batch_of(trainer, img))[0])
        code, _, body = _post(base + "/predict?probs=1", _npy(img))
        probs = _load(body)
        assert code == 200 and probs.shape == (SIZE, SIZE, 3)
        np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)
        np.testing.assert_array_equal(
            probs, trainer.predict_probs(batch_of(trainer, img))[0])

    @pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
    def test_geotiff_body_uses_auto_scaling(self, live_server, dtype):
        trainer, _, base = live_server
        img = (np.random.RandomState(2).rand(SIZE, SIZE, 3)
               * np.iinfo(dtype).max).astype(dtype)
        code, _, body = _post(base + "/predict",
                              tgeotiff.encode_geotiff(img, epsg=32643))
        assert code == 200
        scaled = tserve.scale_image(img, "auto")
        np.testing.assert_array_equal(
            _load(body), trainer.predict(batch_of(trainer, scaled))[0])

    @pytest.mark.parametrize("fmt", ["png", "jpeg", "gif", "bmp", "jp2"])
    def test_image_bodies_use_auto_scaling(self, live_server, fmt):
        """PNG, JPEG, GIF, BMP and JPEG 2000 bodies (the JAX server
        decodes them with PIL) decode through the port's codecs, are
        scaled by dtype and served as ``predict`` of the decoded chip."""
        from PIL import Image
        trainer, _, base = live_server
        img = (np.random.RandomState(3).rand(SIZE, SIZE, 3)
               * 255).astype(np.uint8)
        if fmt == "png":
            data = timage.encode_png(img)
        elif fmt == "jpeg":
            data = timage.encode_jpeg(img, 90)
        elif fmt == "jp2":
            data = encode_jp2(img)
        else:
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format=fmt.upper())
            data = buf.getvalue()
        decoded = timage.decode_image_bytes(data).array
        assert decoded.shape == (SIZE, SIZE, 3) and decoded.dtype == np.uint8
        code, _, body = _post(base + "/predict", data)
        assert code == 200
        np.testing.assert_array_equal(_load(body), trainer.predict(
            batch_of(trainer, tserve.scale_image(decoded, "auto")))[0])

    def test_windowed_body_equals_offline(self, live_server):
        trainer, _, base = live_server
        big = np.random.RandomState(11).rand(70, 45, 3).astype(np.float32)
        code, _, body = _post(base + "/predict?probs=1&stride=16",
                              _npy(big))
        assert code == 200
        probs = _load(body)
        np.testing.assert_array_equal(probs, twindow.predict_windowed(
            trainer, big, stride=16, scale="none", probs=True))
        code, _, body = _post(base + "/predict?stride=16", _npy(big))
        assert code == 200
        np.testing.assert_array_equal(_load(body), probs.argmax(-1))
        code, _, body = _post(base + "/predict",
                              _npy(np.zeros((5, 9, 3), np.float32)))
        assert code == 200 and _load(body).shape == (5, 9)

    @pytest.mark.parametrize("body,code,match", [
        (_npy(np.zeros((SIZE, SIZE, 2), np.float32)), 400, "expected"),
        (_npy(np.zeros((2, SIZE, SIZE, 3), np.float32)), 400, "expected"),
        (b"not an image", 400, "unsupported raster format"),
        (b"\x89PNG\r\n\x1a\n" + bytes(32), 400, "PNG"),
        (timage.encode_png(np.zeros((SIZE, SIZE, 3), np.uint8))[:-30], 400,
         "corrupt or unreadable PNG"),
        (timage.encode_jpeg(np.zeros((SIZE, SIZE, 3), np.uint8))[:200], 400,
         "truncated"),
        (b"II*\x00" + bytes(12), 400, "GeoTIFF"),
        (encode_jp2(np.zeros((SIZE, SIZE, 3), np.uint8))[:-20], 400,
         "corrupt or unreadable JPEG 2000"),
    ])
    def test_bad_bodies_are_400(self, live_server, body, code, match):
        _, _, base = live_server
        got, _, out = _post(base + "/predict", body)
        assert got == code and match in json.loads(out)["error"]

    @pytest.mark.parametrize("q", ["stride=0", "stride=99", "stride=x"])
    def test_bad_stride_is_400(self, live_server, q):
        _, _, base = live_server
        code, _, body = _post(f"{base}/predict?{q}",
                              _npy(np.zeros((40, 40, 3), np.float32)))
        assert code == 400 and "stride" in json.loads(body)["error"]

    def test_unknown_path_is_404(self, live_server):
        _, _, base = live_server
        assert _post(base + "/nope", b"")[0] == 404
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/nope", timeout=30)
        assert e.value.code == 404

    def test_oversized_raster_is_413(self):
        ps = tserve.PredictServer(port_trainer(), max_wait_ms=5.0)
        httpd = tserve.make_http_server("127.0.0.1", 0, ps, max_pixels=500)
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        try:
            base = f"http://127.0.0.1:{httpd.server_address[1]}"
            code, _, body = _post(base + "/predict",
                                  _npy(np.zeros((40, 20, 3), np.float32)))
            assert code == 413 and "max_pixels" in json.loads(body)["error"]
        finally:
            httpd.shutdown()
            ps.close()
            t.join(timeout=30)


GT = (499980.0, 10.0, 0.0, 2100020.0, 0.0, -10.0)


@pytest.mark.parametrize("compress", ["lzw", "none", "deflate"])
@pytest.mark.parametrize("tiled", [True, False])
@pytest.mark.parametrize("dtype,shape", [(np.uint8, (70, 90)),
                                         (np.uint16, (300, 260, 3)),
                                         (np.float32, (40, 33, 13))])
def test_decode_geotiff_equals_jax(dtype, shape, tiled, compress):
    rng = np.random.RandomState(4)
    arr = (rng.rand(*shape) * 250).astype(dtype)
    data = tgeotiff.encode_geotiff(arr, geotransform=GT, epsg=32643,
                                   nodata=0, tiled=tiled, compress=compress)
    ref, got = jgeotiff.decode_geotiff(data), tgeotiff.decode_geotiff(data)
    assert got.array.dtype == ref.array.dtype
    np.testing.assert_array_equal(got.array, ref.array)
    assert vars(got.info) == vars(ref.info)
    assert vars(tgeotiff.decode_geotiff_info(data)) == \
        vars(jgeotiff.decode_geotiff_info(data))


def _strip_tiff(arr, planar=1, predictor=1, compression=1, photometric=1,
                payload=None):
    """A little-endian classic TIFF of ``arr`` (H, W, B), one strip a
    plane: chunky (planar 1) or one band a strip (planar 2). ``payload``
    maps a strip's raw bytes to what is stored (a predictor's forward
    step, a compressor)."""
    import struct
    h, w, spp = arr.shape
    strips = ([arr.tobytes()] if planar == 1 else
              [np.ascontiguousarray(arr[..., b]).tobytes()
               for b in range(spp)])
    strips = [payload(s) if payload else s for s in strips]
    sfmt = {"u": 1, "i": 2, "f": 3}[arr.dtype.kind]
    shorts = [(256, w), (257, h), (258, arr.dtype.itemsize * 8),
              (259, compression), (262, photometric), (277, spp),
              (278, h), (284, planar), (317, predictor), (339, sfmt)]
    n = len(shorts) + 2
    arrays = 8 + 2 + 12 * n + 4  # offsets and counts, when out of line
    offs = [arrays + (8 * len(strips) if len(strips) > 1 else 0)]
    for s in strips[:-1]:
        offs.append(offs[-1] + len(s))
    counts = [len(s) for s in strips]
    entries = [(t, 3, 1, struct.pack("<H", v).ljust(4, b"\0"))
               for t, v in shorts]
    for tid, vals, at in ((273, offs, arrays),
                          (279, counts, arrays + 4 * len(strips))):
        entries.append((tid, 4, len(vals),
                        struct.pack("<I", vals[0] if len(vals) == 1
                                    else at)))
    out = b"II*\x00" + struct.pack("<IH", 8, n)
    for tid, ttype, cnt, raw in sorted(entries):
        out += struct.pack("<HHI", tid, ttype, cnt) + raw
    out += struct.pack("<I", 0)
    if len(strips) > 1:
        out += struct.pack(f"<{len(strips)}I", *offs)
        out += struct.pack(f"<{len(strips)}I", *counts)
    return out + b"".join(strips)


def _packbits(raw: bytes) -> bytes:
    out, i = bytearray(b"\x80"), 0  # 128 is a no-op header
    while i < len(raw):
        run = 1
        while i + run < len(raw) and run < 128 and raw[i + run] == raw[i]:
            run += 1
        if run > 2:
            out += bytes([257 - run, raw[i]])
        else:
            out += bytes([run - 1]) + raw[i:i + run]
        i += run
    return bytes(out)


def _hdiff(dtype, w, spp):
    """The horizontal predictor's forward step (2) on one chunky strip."""
    def f(raw):
        a = np.frombuffer(raw, dtype).reshape(-1, w, spp).astype(np.int64)
        return np.diff(a, axis=1, prepend=0).astype(dtype).tobytes()
    return f


_RNG = np.random.RandomState(8)
_U16 = (_RNG.rand(5, 7, 3) * 65535).astype(np.uint16)
_F32 = (_RNG.rand(6, 9, 1) * 1000 - 500).astype(np.float32)
_U8 = np.repeat(_RNG.randint(0, 4, (6, 8, 1)), 5, axis=1).astype(np.uint8)
_U8_3 = (_RNG.rand(6, 5, 3) * 255).astype(np.uint8)


def _lzw_hdiff(raw):
    from dl_image_segmentation_tpu_torch.raster.lzw import lzw_encode_native
    return lzw_encode_native(_hdiff(np.uint16, 7, 3)(raw))


def _fpred(raw):
    from tests.test_raster import TestFloatPredictor
    return TestFloatPredictor._forward_fpredictor(
        np.frombuffer(raw, np.float32).reshape(6, 9, 1))


@pytest.mark.parametrize("tif,src", [
    (_strip_tiff(_U16, predictor=2, payload=_hdiff(np.uint16, 7, 3)), _U16),
    (_strip_tiff(_U16, predictor=2, compression=5, payload=_lzw_hdiff),
     _U16),
    (_strip_tiff(_F32, predictor=3, payload=_fpred), _F32),
    (_strip_tiff(_U8, compression=32773, payload=_packbits), _U8),
    (_strip_tiff(_U8_3, planar=2), _U8_3),
], ids=["predictor2", "predictor2-lzw", "predictor3", "packbits",
        "planar2"])
def test_decode_crafted_tiffs_equal_jax(tif, src):
    """Layouts and codecs that the port's writer does not produce, as
    request bodies may carry them: held to the JAX reader and to the
    array they were made from."""
    ref, got = jgeotiff.decode_geotiff(tif), tgeotiff.decode_geotiff(tif)
    assert got.array.dtype == ref.array.dtype
    np.testing.assert_array_equal(got.array, ref.array)
    np.testing.assert_array_equal(got.array, src)
    assert vars(got.info) == vars(ref.info)


@pytest.mark.parametrize("arr,kw,match", [
    (_U8, {"predictor": 7}, "predictor 7"),
    (_U8, {"predictor": 3}, "non-float"),
    (_F32, {"predictor": 2}, "float samples"),
    (_U8, {"photometric": 3}, "palette"),
])
def test_refused_tiffs_raise_as_jax(arr, kw, match):
    tif = _strip_tiff(arr, **kw)
    for decode in (jgeotiff.decode_geotiff, tgeotiff.decode_geotiff):
        with pytest.raises(ValueError, match=match):
            decode(tif)


def test_lzw_decoders_equal_jax():
    from dl_image_segmentation_tpu.raster import lzw as jlzw
    from dl_image_segmentation_tpu_torch.raster import lzw as tlzw
    rng = np.random.RandomState(0)
    for data in (b"", b"a", b"a" * 5000, bytes(rng.randint(0, 4, 20000,
                                                          np.uint8)),
                 bytes(rng.randint(0, 256, 9000, np.uint8))):
        enc = tlzw.lzw_encode_native(data)
        assert tlzw.lzw_decode_native(enc) == tlzw.lzw_decode(enc) == data
        for cap in (0, 1, 7, 1000, len(data) + 3):
            ref = jlzw.lzw_decode(enc, cap)
            assert tlzw.lzw_decode_native(enc, cap) == ref
            assert tlzw.lzw_decode(enc, cap) == ref
    with pytest.raises(ValueError, match="corrupt"):
        tlzw.lzw_decode_native(b"\x80\x7f\xff\xff\xff")


def test_reader_refuses_remote_paths_and_unknown_compression(tmp_path):
    arr = np.arange(64, dtype=np.uint8).reshape(8, 8)
    path = str(tmp_path / "a.tif")
    tgeotiff.write_geotiff(path, arr, compress="none", tiled=False)
    np.testing.assert_array_equal(tgeotiff.read_geotiff(path).array[..., 0],
                                  arr)
    data = bytearray(tgeotiff.encode_geotiff(arr, compress="none",
                                             tiled=False))
    # compression tag (259, SHORT, 1) -> 7 (JPEG)
    i = bytes(data).index(b"\x03\x01\x03\x00\x01\x00\x00\x00\x01\x00")
    data[i + 8] = 7
    with pytest.raises(NotImplementedError, match="compression 7"):
        tgeotiff.decode_geotiff(bytes(data))
    with pytest.raises(timage.CorruptRasterError, match="compression 7"):
        timage.decode_image_bytes(bytes(data))


def _chips(n, seed=0):
    rng = np.random.RandomState(seed)
    keys = [(-380 + i % 3, 3491 + i // 3) for i in range(n)]
    return keys, [rng.randint(0, 9, (68, 68)).astype(np.uint8)
                  for _ in keys]


def test_stitch_tiles_equals_jax():
    keys, arrs = _chips(5)
    ref = jstitch.stitch_tiles(
        {JTile(64, 2, 10.0, 43, i, j): a for (i, j), a in zip(keys, arrs)},
        fill_value=255)
    got = tstitch.stitch_tiles(
        {TTile(64, 2, 10.0, 43, i, j): a for (i, j), a in zip(keys, arrs)},
        fill_value=255)
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[0].dtype == ref[0].dtype and got[1:] == ref[1:]
    with pytest.raises(ValueError, match="same grid"):
        tstitch.stitch_tiles({TTile(64, 2, 10.0, 43, 0, 0): arrs[0],
                              TTile(64, 2, 20.0, 43, 1, 0): arrs[1]})


def test_stitch_folder_bytes_equal_jax(tmp_path):
    keys, arrs = _chips(5, seed=1)
    chips = tmp_path / "chips"
    chips.mkdir()
    for (i, j), a in zip(keys, arrs):
        t = TTile(64, 2, 10.0, 43, i, j)
        tgeotiff.write_geotiff(str(chips / (t.filename + ".tif")), a,
                               geotransform=t.geotrans, epsg=t.epsg,
                               nodata=255)
    tgeotiff.write_geotiff(str(chips / "mosaic.tif"), arrs[0])
    ref_out, got_out = str(tmp_path / "j.tif"), str(tmp_path / "t.tif")
    ref = jstitch.stitch_folder(str(chips), ref_out)
    got = tstitch.stitch_folder(str(chips), got_out)
    assert got == ref == (5, (128, 192))
    with open(ref_out, "rb") as a, open(got_out, "rb") as b:
        assert a.read() == b.read()
    with pytest.raises(FileNotFoundError):
        tstitch.stitch_folder(str(tmp_path), got_out)
