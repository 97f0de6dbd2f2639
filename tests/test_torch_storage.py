"""The port's storage layer against the JAX package's, on the CPU: path
helpers and glob semantics, the GCS and S3 clients against both
packages' in-process fakes (each client's writes read back through the
other), atomic writes, retries, SigV4, the read-only HTTP backend's
size handling, and gs:// / s3:// through the port's data plane (chips,
shards, the feed, GeoTIFFs, stitch, checkpoints and the CLI). No test
needs the network: every server is a loopback fake."""

import contextlib
import datetime as dt
import hashlib
import io
import os
import random
import tempfile
import threading
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

from dl_image_segmentation_tpu import storage as jst
from dl_image_segmentation_tpu.storage import fake_gcs as jfake_gcs
from dl_image_segmentation_tpu.storage import fake_s3 as jfake_s3
from dl_image_segmentation_tpu.storage import s3 as js3
from dl_image_segmentation_tpu_torch import storage as tst
from dl_image_segmentation_tpu_torch.catalog.httpserver import SceneServer
from dl_image_segmentation_tpu_torch.pipeline import stitch as tstitch
from dl_image_segmentation_tpu_torch.pipeline.input import TFRecordFeed
from dl_image_segmentation_tpu_torch.raster import geotiff as tgeotiff
from dl_image_segmentation_tpu_torch.records import tfrecord as ttfrecord
from dl_image_segmentation_tpu_torch.records import writers as twriters
from dl_image_segmentation_tpu_torch.storage import fake_gcs as tfake_gcs
from dl_image_segmentation_tpu_torch.storage import fake_s3 as tfake_s3
from dl_image_segmentation_tpu_torch.storage import gcs as tgcs
from dl_image_segmentation_tpu_torch.storage import httpread as thttpread
from dl_image_segmentation_tpu_torch.storage import s3 as ts3
from dl_image_segmentation_tpu_torch.train import trainer as ttrainer

from tests.test_torch_records import PAIRS, chip_folder

# one intra-op thread: the test workers share the host's cores
torch.set_num_threads(1)

STORES = {"jax": (jst, jfake_gcs.FakeGCS, jfake_s3.FakeS3),
          "port": (tst, tfake_gcs.FakeGCS, tfake_s3.FakeS3)}


@contextlib.contextmanager
def serving(monkeypatch, backend, pkg="port"):
    """A loopback fake of ``backend`` ('gs' or 's3') from package
    ``pkg``, with the environment pointing both packages' clients at it.
    Yields the fake."""
    cls = STORES[pkg][1 if backend == "gs" else 2]
    with cls() as fake:
        if backend == "gs":
            monkeypatch.setenv("STORAGE_EMULATOR_HOST", fake.host)
        else:
            monkeypatch.setenv("AWS_ENDPOINT_URL_S3", fake.endpoint)
            for var in ("AWS_ACCESS_KEY_ID", "AWS_SECRET_ACCESS_KEY",
                        "AWS_SESSION_TOKEN"):
                monkeypatch.delenv(var, raising=False)
        yield fake


@pytest.fixture()
def no_backoff(monkeypatch):
    monkeypatch.setattr(tgcs, "_BACKOFF_BASE", 0.0)


# ---------------------------------------------------------------------------
# pure path functions
# ---------------------------------------------------------------------------

PATHS = ["gs://b/a/c.tif", "gs://b/a/", "gs://b", "gs://b/", "s3://bkt/x/y/z",
         "s3://bkt/", "https://host:8080/p/q.tif", "http://127.0.0.1:9/a#b.tif",
         "http://h/dir/", "/tmp/x/y.tif", "rel/x", "x", "", "gs:/b/odd",
         "gs://", "s3://"]


def _same(fn_j, fn_t, *args):
    """Both results, or both exception types."""
    try:
        want = fn_j(*args)
    except Exception as e:  # noqa: BLE001 -- compared below
        with pytest.raises(type(e)):
            fn_t(*args)
        return
    assert fn_t(*args) == want


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("fn", ["split_url", "join", "basename", "dirname",
                                "is_remote"])
def test_path_helpers_equal_jax(fn, path):
    args = (path, "c", "/d.tif") if fn == "join" else (path,)
    _same(getattr(jst, fn), getattr(tst, fn), *args)


@pytest.mark.parametrize("seed", range(8))
def test_glob_regex_matches_equal_jax(seed):
    """Seeded glob patterns (``*``, ``?``, classes, ``[!``, unclosed
    ``[``) against seeded names with ``/``: the same matches."""
    rng = random.Random(seed)
    names = ["".join(rng.choice("ab-/.x") for _ in range(rng.randint(0, 8)))
             for _ in range(60)]
    for _ in range(40):
        pat = "".join(rng.choice(["a", "b", "-", "/", "*", "?", "[ab]",
                                  "[!a]", "[", "]", "x", "."])
                      for _ in range(rng.randint(0, 6)))
        jrx, trx = jst._glob_regex(pat), tst._glob_regex(pat)
        assert trx.pattern == jrx.pattern
        assert [bool(trx.fullmatch(n)) for n in names] == \
            [bool(jrx.fullmatch(n)) for n in names]
    assert not tst._glob_regex("recs/*").fullmatch("recs/sub/deep")


# ---------------------------------------------------------------------------
# clients against both packages' fakes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("backend", ["gs", "s3"])
@pytest.mark.parametrize("fake_pkg", ["port", "jax"])
def test_clients_and_fakes_interoperate(monkeypatch, fake_pkg, backend,
                                        writer):
    """One package's client writes into either package's fake; the
    other package's client reads every byte back: write, read, range,
    list, glob, exists, unlink, replace, streamed (GCS resumable, S3
    multipart) upload and ranged-GET download."""
    w = STORES[writer][0]
    r = STORES["jax" if writer == "port" else "port"][0]
    rng = np.random.RandomState(zlib.crc32(f"{fake_pkg}{backend}{writer}"
                                           .encode()))
    data = rng.bytes(3000)
    base = f"{backend}://bucket/d"
    with serving(monkeypatch, backend, fake_pkg):
        for name in ("a-00000-of-00002", "a-00001-of-00002", "b.txt",
                     "sub/deep.bin"):
            w.write_bytes(f"{base}/{name}", data + name.encode())
        for name in ("a-00000-of-00002", "sub/deep.bin"):
            assert r.read_bytes(f"{base}/{name}") == data + name.encode()
        assert r.read_range(f"{base}/b.txt", 10, 99) == data[10:100]
        assert r.read_range(f"{base}/b.txt", 2990) == data[2990:] + b"b.txt"
        assert r.listdir(base) == w.listdir(base) == [
            "a-00000-of-00002", "a-00001-of-00002", "b.txt", "sub"]
        assert r.glob(f"{base}/a-?????-of-*") == w.glob(
            f"{base}/a-?????-of-*") == [f"{base}/a-0000{i}-of-00002"
                                        for i in range(2)]
        assert r.glob(f"{base}/*") == w.glob(f"{base}/*")
        assert r.exists(f"{base}/b.txt") and not r.exists(f"{base}/nope")
        w.replace(f"{base}/b.txt", f"{base}/c.txt")
        assert not r.exists(f"{base}/b.txt")
        assert r.read_bytes(f"{base}/c.txt") == data + b"b.txt"
        r.unlink(f"{base}/c.txt")
        assert not w.exists(f"{base}/c.txt")
        with pytest.raises(FileNotFoundError):
            r.unlink(f"{base}/c.txt")
        # streams: more than one chunk / part each way
        big = rng.bytes(11 << 20) if backend == "s3" else rng.bytes(700_000)
        cli, bucket, key = w.client_for(f"{base}/big.bin")
        chunk = {"part_size": 5 << 20} if backend == "s3" \
            else {"chunk_size": 256 << 10}
        cli.upload_stream(bucket, key, io.BytesIO(big), size=len(big),
                          **chunk)
        rcli = r.client_for(f"{base}/big.bin")[0]
        out = io.BytesIO()
        assert rcli.download_stream(bucket, key, out,
                                    chunk_size=300_000) == len(big)
        assert out.getvalue() == big


@pytest.mark.parametrize("backend", ["gs", "s3"])
def test_upload_and_download_files_stream(monkeypatch, tmp_path, backend):
    src = tmp_path / "src.bin"
    src.write_bytes(np.random.RandomState(5).bytes(400_000))
    with serving(monkeypatch, backend):
        url = f"{backend}://bucket/f/src.bin"
        tst.upload_file(str(src), url)
        assert jst.read_bytes(url) == src.read_bytes()
        tst.download_file(url, str(tmp_path / "back.bin"))
        assert (tmp_path / "back.bin").read_bytes() == src.read_bytes()
        assert not (tmp_path / "back.bin.tmp").exists()


@pytest.mark.parametrize("backend", ["local", "gs", "s3", "http"])
def test_size_of_files_and_objects(monkeypatch, tmp_path, backend):
    """storage.size gives the byte count in every backend and raises
    FileNotFoundError for a missing path."""
    data = np.random.RandomState(9).bytes(70_001)
    (tmp_path / "f.bin").write_bytes(data)
    with contextlib.ExitStack() as stack:
        if backend == "local":
            base = str(tmp_path)
        elif backend == "http":
            base = stack.enter_context(SceneServer(str(tmp_path))).url
        else:
            stack.enter_context(serving(monkeypatch, backend))
            base = f"{backend}://bucket/d"
            tst.write_bytes(base + "/f.bin", data)
        assert tst.size(tst.join(base, "f.bin")) == len(data)
        with pytest.raises(FileNotFoundError):
            tst.size(tst.join(base, "missing.bin"))


# ---------------------------------------------------------------------------
# atomicity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["gs", "s3"])
def test_aborted_writers_leave_no_object(monkeypatch, backend):
    """A SpooledWriter or a remote TFRecordWriter is invisible until
    close(); abort() uploads nothing and removes its local spool."""
    with serving(monkeypatch, backend) as fake:
        url = f"{backend}://bucket/w/obj"
        w = tst.SpooledWriter(url)
        w.write(b"partial")
        w.flush()
        assert not tst.exists(url)
        spool = w._spool
        w.abort()
        assert not tst.exists(url) and not os.path.exists(spool)
        tw = ttfrecord.TFRecordWriter(url + "-00000-of-00001")
        tw.write(b"x")
        tw.abort()
        assert not fake.objects
        with ttfrecord.TFRecordWriter(url + "-00000-of-00001") as tw:
            tw.write(b"rec")
            assert not tst.exists(url + "-00000-of-00001")
        assert list(ttfrecord.read_records(url + "-00000-of-00001")) == \
            [b"rec"]
        with pytest.raises(RuntimeError):
            with ttfrecord.TFRecordWriter(url + "-b") as tw:
                tw.write(b"y")
                raise RuntimeError("boom")
        assert not tst.exists(url + "-b")


# ---------------------------------------------------------------------------
# retries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["gs", "s3"])
def test_transient_failures_are_retried(monkeypatch, no_backoff, backend):
    with serving(monkeypatch, backend) as fake:
        url = f"{backend}://bucket/r.bin"
        tst.write_bytes(url, b"payload")
        fake.fail_next(2, status=503)
        assert tst.read_bytes(url) == b"payload"
        fake.fail_next(2, status=429)
        assert tst.exists(url)


@pytest.mark.parametrize("backend", ["gs", "s3"])
def test_persistent_503_raises_gcs_error(monkeypatch, no_backoff, backend):
    with serving(monkeypatch, backend) as fake:
        fake.fail_next(1000, status=503)
        with pytest.raises(tgcs.GCSError) as ei:
            tst.read_bytes(f"{backend}://bucket/r.bin")
        assert ei.value.status == 503


def test_backoff_doubles_from_the_ports_base(monkeypatch):
    """0.1 s doubling over 5 attempts by default; the sleep reads the
    port's own ``_BACKOFF_BASE``."""
    slept = []
    monkeypatch.setattr(tgcs.time, "sleep", slept.append)
    with tfake_gcs.FakeGCS() as fake:
        fake.fail_next(1000)
        with pytest.raises(tgcs.GCSError):
            tgcs.http_request("GET", f"http://{fake.host}/x")
    assert slept == [0.1 * 2 ** k for k in range(5)]


# ---------------------------------------------------------------------------
# SigV4
# ---------------------------------------------------------------------------

def test_sigv4_aws_documentation_vector():
    """The AWS SigV4 documentation's worked example (GET
    iam.amazonaws.com ListUsers, 2015-08-30T12:36:00Z, AKIDEXAMPLE)."""
    hdrs = ts3.sigv4_headers(
        "GET", "https://iam.amazonaws.com/?Action=ListUsers"
               "&Version=2010-05-08",
        "us-east-1", "iam", "AKIDEXAMPLE",
        "wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY",
        hashlib.sha256(b"").hexdigest(),
        now=dt.datetime(2015, 8, 30, 12, 36, 0, tzinfo=dt.timezone.utc),
        extra_signed={"content-type": "application/"
                      "x-www-form-urlencoded; charset=utf-8"},
        content_sha_header=False)
    assert hdrs["Authorization"] == (
        "AWS4-HMAC-SHA256 Credential=AKIDEXAMPLE/20150830/"
        "us-east-1/iam/aws4_request, "
        "SignedHeaders=content-type;host;x-amz-date, "
        "Signature=5d672d79c15b13162d9279b0855cfba6789a8edb4c82c4"
        "00e06b5924a6f2b5d7")


@pytest.mark.parametrize("seed", range(6))
def test_sigv4_headers_equal_jax(seed):
    """Seeded requests at a fixed timestamp: the port's headers equal
    the JAX signer's (keys with spaces, '#', unicode, query strings,
    session tokens and extra x-amz headers)."""
    rng = random.Random(seed)
    key = "".join(rng.choice("ab/#é ~+_.") for _ in range(rng.randint(1, 12)))
    query = "&".join(f"{rng.choice('xyz')}={rng.randint(0, 9)}"
                     for _ in range(rng.randint(0, 3)))
    url = ("http://127.0.0.1:9000/bucket/"
           + ts3.urllib.parse.quote(key, safe="/-._~")
           + (f"?{query}" if query else ""))
    kw = dict(
        session_token=rng.choice([None, "TOKEN/x+y"]),
        now=dt.datetime(2024, 1 + seed, 3, 4, 5, 6, tzinfo=dt.timezone.utc),
        extra_signed=rng.choice([None, {"x-amz-copy-source": "/b/k%23"}]))
    args = (rng.choice(["GET", "PUT", "HEAD", "DELETE", "POST"]), url,
            rng.choice(["us-east-1", "eu-west-3"]), "s3", "AK" + str(seed),
            "secret/" + str(seed),
            hashlib.sha256(rng.randbytes(rng.randint(0, 64))).hexdigest())
    assert ts3.sigv4_headers(*args, **kw) == js3.sigv4_headers(*args, **kw)


def test_signed_requests_reach_the_fake(monkeypatch):
    with serving(monkeypatch, "s3") as fake:
        monkeypatch.setenv("AWS_ACCESS_KEY_ID", "AKIDEXAMPLE")
        monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "secret")
        tst.write_bytes("s3://bucket/s/k#1.bin", b"signed")
        assert fake.objects[("bucket", "s/k#1.bin")] == b"signed"
        tst.replace("s3://bucket/s/k#1.bin", "s3://bucket/s/k2.bin")
        assert jst.read_bytes("s3://bucket/s/k2.bin") == b"signed"


# ---------------------------------------------------------------------------
# read-only http(s):// and the ADVICE.md httpread.py:131 fault
# ---------------------------------------------------------------------------

BODY = bytes(range(256)) * 37


class _Handler(BaseHTTPRequestHandler):
    """An HTTP/1.0 server that never sends Content-Length (the body ends
    when the connection closes). ``mode``: 'ranged' answers a Range with
    a 206 and its total; 'nototal' with a 206 whose total is '*';
    'norange' ignores Range (and refuses HEAD)."""
    mode = "ranged"

    def log_message(self, *a):
        pass

    def do_HEAD(self):
        if self.mode == "norange":
            self.send_response(405)
        else:
            self.send_response(200)
        self.end_headers()

    def do_GET(self):
        body, rng = BODY, self.headers.get("Range")
        if rng and self.mode != "norange":
            a, _, b = rng.split("=")[1].partition("-")
            a, b = int(a), int(b) if b else len(BODY) - 1
            body = BODY[a:b + 1]
            total = "*" if self.mode == "nototal" else str(len(BODY))
            self.send_response(206)
            self.send_header("Content-Range", f"bytes {a}-{b}/{total}")
        else:
            self.send_response(200)
        self.end_headers()
        self.wfile.write(body)


@contextlib.contextmanager
def no_length_server(mode):
    handler = type("H", (_Handler,), {"mode": mode})
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)


@pytest.mark.parametrize("mode", ["ranged", "nototal", "norange"])
def test_http_without_content_length_reads_whole_object(tmp_path, mode):
    """A server that sends no Content-Length: the port's stat reports
    the true size and download_file writes the whole object, where the
    JAX package (ADVICE.md, httpread.py:131) takes the size as 0 and
    writes an empty file: a pinned, intended difference."""
    with no_length_server(mode) as url:
        obj = f"{url}/data/obj.bin"
        meta = thttpread.HTTPReadClient("http://").stat(
            *tst.split_url(obj)[1:])
        assert meta == {"name": "data/obj.bin", "size": str(len(BODY))}
        tst.download_file(obj, str(tmp_path / "port.bin"))
        assert (tmp_path / "port.bin").read_bytes() == BODY
        assert tst.read_range(obj, 100, 199) == BODY[100:200]
        jst.download_file(obj, str(tmp_path / "jax.bin"))
        want_jax = b"" if mode in ("ranged", "nototal") else BODY
        assert (tmp_path / "jax.bin").read_bytes() == want_jax


def test_http_reads_list_and_refuse_writes(tmp_path):
    """http(s):// through SceneServer: reads, ranged reads, autoindex
    listing and globs of '#'-named chips equal the JAX backend's;
    writes raise PermissionError."""
    chip_folder(str(tmp_path / "chips"), np.uint16)
    with SceneServer(str(tmp_path)) as srv:
        base = f"{srv.url}/chips"
        names = tst.listdir(f"{base}/images")
        assert names == jst.listdir(f"{base}/images") == sorted(
            os.listdir(tmp_path / "chips" / "images"))
        assert tst.glob(f"{base}/labels/*.tif") == \
            jst.glob(f"{base}/labels/*.tif")
        one = f"{base}/images/{names[0]}"
        local = (tmp_path / "chips" / "images" / names[0]).read_bytes()
        assert tst.read_bytes(one) == local
        assert tst.read_range(one, 8, 40) == local[8:41]
        assert tst.exists(one) and not tst.exists(f"{base}/nope.tif")
        for call in (lambda: tst.write_bytes(f"{base}/x", b"x"),
                     lambda: tst.unlink(one)):
            with pytest.raises(PermissionError):
                call()


# ---------------------------------------------------------------------------
# the data plane on gs:// and s3://
# ---------------------------------------------------------------------------

def _objects_under(fake, prefix):
    return {k[1]: v for k, v in fake.objects.items()
            if k[1].startswith(prefix)}


@pytest.mark.parametrize("src,dst", [("gs", "s3"), ("s3", "gs"),
                                     ("http", "gs")])
def test_remote_chips_to_remote_shards_equal_local(monkeypatch, tmp_path,
                                                   src, dst):
    """to-tfrecords from a remote chip folder into remote shards: every
    shard is bitwise the shard written locally; resume skips complete
    remote shards and rewrites a missing one; the feed reads the remote
    shards as it reads the local ones."""
    chips = chip_folder(str(tmp_path / "chips"), np.uint16)
    local_out = str(tmp_path / "recs")
    assert twriters.process_dataset_mp("n", chips, local_out, 4,
                                       num_proc=2) == PAIRS
    with contextlib.ExitStack() as stack:
        fakes = {}
        for b in {src, dst} - {"http"}:
            fakes[b] = stack.enter_context(serving(monkeypatch, b))
        if src == "http":
            folder = f"{stack.enter_context(SceneServer(chips)).url}"
        else:
            folder = f"{src}://bucket/chips"
            tst.upload_dir(chips, folder)
        out = f"{dst}://bucket/recs"
        assert twriters.process_dataset_mp("n", folder, out, 4,
                                           num_proc=2) == PAIRS
        got = _objects_under(fakes[dst], "recs/")
        want = {f"recs/{n}": open(os.path.join(local_out, n), "rb").read()
                for n in os.listdir(local_out)}
        assert got == want
        shard = sorted(got)[1]
        tst.unlink(f"{dst}://bucket/{shard}")
        put = []
        monkeypatch.setattr(twriters, "TFRecordWriter",
                            lambda p: put.append(p) or
                            ttfrecord.TFRecordWriter(p))
        twriters.process_dataset_mp("n", folder, out, 4, num_proc=2,
                                    resume=True)
        assert put == [f"{dst}://bucket/{shard}"]
        assert _objects_under(fakes[dst], "recs/") == want
        assert ttfrecord.list_shards(out, "n") == [
            f"{dst}://bucket/{k}" for k in sorted(want)]
        feeds = [TFRecordFeed(p, "tifarr", 4, image_size=16, repeat=False,
                              num_workers=1, scale="raw", per_host=False)
                 for p in (f"{out}/n-*", os.path.join(local_out, "n-*"))]
        for (ai, al), (bi, bl) in zip(*(f.batches() for f in feeds)):
            np.testing.assert_array_equal(ai, bi)
            np.testing.assert_array_equal(al, bl)


@pytest.mark.parametrize("backend", ["gs", "s3"])
def test_geotiff_and_stitch_on_remote_paths(monkeypatch, tmp_path, backend):
    """write_geotiff to gs:// / s3:// uploads the encoder's bytes;
    read_geotiff reads them back; stitch from and to the bucket gives
    the local stitch's bytes."""
    from tests.test_torch_serve import _chips
    from dl_image_segmentation_tpu_torch.geo import Tile
    keys, arrs = _chips(5, seed=2)
    chips = tmp_path / "chips"
    chips.mkdir()
    with serving(monkeypatch, backend) as fake:
        for (i, j), a in zip(keys, arrs):
            t = Tile(64, 2, 10.0, 43, i, j)
            kw = dict(geotransform=t.geotrans, epsg=t.epsg, nodata=255)
            tgeotiff.write_geotiff(str(chips / (t.filename + ".tif")), a,
                                   **kw)
            url = f"{backend}://bucket/chips/{t.filename}.tif"
            tgeotiff.write_geotiff(url, a, **kw)
            assert fake.objects[("bucket", url.split("/", 3)[3])] == \
                tgeotiff.encode_geotiff(a, **kw)
            np.testing.assert_array_equal(
                tgeotiff.read_geotiff(url).array[..., 0], a)
        local = str(tmp_path / "mosaic.tif")
        assert tstitch.stitch_folder(str(chips), local) == \
            tstitch.stitch_folder(f"{backend}://bucket/chips",
                                  f"{backend}://bucket/out/mosaic.tif")
        assert fake.objects[("bucket", "out/mosaic.tif")] == \
            open(local, "rb").read()


CFG = dict(num_classes=3, base_features=8, levels=2, image_size=16,
           batch_size=2, precision="fp32")


def _trainer(seed=0):
    torch.manual_seed(seed)
    return ttrainer.Trainer(ttrainer.TrainConfig(**CFG), device="cpu")


@pytest.mark.parametrize("backend", ["gs", "s3"])
def test_checkpoint_save_restore_on_remote_paths(monkeypatch, tmp_path,
                                                 backend):
    """save_checkpoint to a bucket writes a local save's bytes;
    restore_checkpoint from the bucket (and from http://) gives the
    saved parameters."""
    a = _trainer(0)
    a.state.step = 7
    local = str(tmp_path / "c.pt")
    a.save_checkpoint(local)
    with serving(monkeypatch, backend) as fake:
        url = f"{backend}://bucket/ck/c.pt"
        a.save_checkpoint(url)
        assert fake.objects[("bucket", "ck/c.pt")] == open(local, "rb").read()
        for src in (url, None):
            b = _trainer(1)
            if src is None:
                with SceneServer(str(tmp_path)) as srv:
                    b.restore_checkpoint(f"{srv.url}/c.pt")
            else:
                b.restore_checkpoint(src)
            assert int(b.state.step) == 7
            x = np.random.RandomState(0).rand(2, 16, 16, 3).astype(
                np.float32)
            np.testing.assert_array_equal(b.predict_probs(x),
                                          a.predict_probs(x))


@pytest.mark.parametrize("backend", ["gs", "s3"])
def test_managed_checkpoints_mirror_prune_and_resume(monkeypatch, tmp_path,
                                                     backend):
    """A remote CheckpointManager uploads every step file, deletes the
    pruned ones remotely, resumes from the remote newest, and a stale
    staging directory fabricates no resume point."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    url = f"{backend}://bucket/run/ckpt"
    with serving(monkeypatch, backend) as fake:
        t = _trainer(0)
        mgr = t.checkpoint_manager(url, keep=2)
        assert mgr.latest_step() is None and mgr.directory.startswith(
            str(tmp_path))
        for step in (1, 2, 3):
            t.state.step = step
            assert t.save_managed(mgr) == step
        assert sorted(_objects_under(fake, "run/ckpt/")) == [
            "run/ckpt/2.pt", "run/ckpt/3.pt"]
        assert fake.objects[("bucket", "run/ckpt/3.pt")] == \
            open(mgr.path(3), "rb").read()
        # a stale step in the staging directory is not a resume point
        open(os.path.join(mgr.directory, "9.pt"), "wb").write(b"stale")
        again = _trainer(1)
        mgr2 = again.checkpoint_manager(url, keep=2)
        assert mgr2.directory == mgr.directory
        assert mgr2.all_steps() == [2, 3]
        assert again.restore_latest(mgr2) == 3
        # the remote emptied: the staging copy goes too
        for k in list(_objects_under(fake, "run/ckpt/")):
            tst.unlink(f"{backend}://bucket/{k}")
        assert _trainer(2).checkpoint_manager(url).latest_step() is None


@pytest.mark.parametrize("batch", ["0", "16"])
def test_create_chips_out_gs_leaves_no_local_directory(monkeypatch,
                                                       tmp_path, batch):
    """create-chips --out gs:// writes the chips a local --out writes,
    bitwise, per tile and batched, makes no local 'gs:' directory (the
    JAX package's batched export does: its pipeline/batch.py makes the
    chip folders with os.makedirs), and a rerun finds every chip done
    (is_done on gs://)."""
    from dl_image_segmentation_tpu_torch import cli as tcli
    from tests.test_torch_cli import chips_argv, run, write_labels
    monkeypatch.chdir(tmp_path)
    write_labels("labels.geojson")
    extra = ["--device", "cpu", "--batch-tiles", batch]
    assert run(tcli, chips_argv("local", "synthetic", extra))[0] == 0
    with serving(monkeypatch, "gs") as fake:
        assert run(tcli, chips_argv("gs://bucket/out", "synthetic",
                                    extra))[0] == 0
        got = {k[1][len("out/"):]: v for k, v in fake.objects.items()}
        rc, lines = run(tcli, chips_argv("gs://bucket/out", "synthetic",
                                         extra))
    want = {}
    for root, _, files in os.walk("local"):
        for f in files:
            p = os.path.join(root, f)
            want[os.path.relpath(p, "local")] = open(p, "rb").read()
    assert got == want and len(want) > 2
    assert sorted(os.listdir(tmp_path)) == ["labels.geojson", "local"]
    assert rc == 0 and any("already existed" in ln for ln in lines), lines
