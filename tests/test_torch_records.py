"""The PyTorch port's TFRecord path against the JAX package, on the CPU:
CRC32C (Python and the host C++), the Example codec, shards written by
process_dataset_mp from a small GeoTIFF chip folder and by the MT engine
from a PNG/JPEG chip folder (byte for byte the JAX package's, in every
storage mode), the parsers, TFRecordFeed's batches (rgbraw included) and
the DevicePrefetcher on the CPU. Everything here is exact.
"""

import os

import numpy as np
import pytest
import torch

from dl_image_segmentation_tpu.pipeline import input as jinput
from dl_image_segmentation_tpu.records import crc32c as jcrc
from dl_image_segmentation_tpu.records import example as jexample
from dl_image_segmentation_tpu.records import tfrecord as jtfrecord
from dl_image_segmentation_tpu.records import writers as jwriters
from dl_image_segmentation_tpu_torch.pipeline import input as tinput
from dl_image_segmentation_tpu_torch.raster import image as timage
from dl_image_segmentation_tpu_torch.raster import write_geotiff
from dl_image_segmentation_tpu_torch.records import crc32c as tcrc
from dl_image_segmentation_tpu_torch.records import example as texample
from dl_image_segmentation_tpu_torch.records import parsers as tparsers
from dl_image_segmentation_tpu_torch.records import tfrecord as ttfrecord
from dl_image_segmentation_tpu_torch.records import writers as twriters

# one intra-op thread: the test workers share the host's cores
torch.set_num_threads(1)

PAIRS, SIZE = 12, 16


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 63, 1000, 4099])
def test_crc32c_python_and_native_equal_jax(n):
    data = np.random.RandomState(n).bytes(n)
    want = jcrc.crc32c(data)
    assert tcrc.crc32c(data) == want
    assert tcrc.crc32c_native(data) == want
    assert tcrc.crc32c_native(memoryview(data)[1:]) == jcrc.crc32c(data[1:])
    assert tcrc.crc32c(data, 5) == tcrc.crc32c_native(data, 5) == \
        jcrc.crc32c(data, 5)
    assert tcrc.masked_crc32c(data) == tcrc.masked_crc32c_native(data) == \
        jcrc.masked_crc32c(data)


@pytest.mark.parametrize("img_dtype,lbl_dtype", [
    (np.uint8, np.uint8), (np.uint16, np.uint8), (np.float32, np.int32)])
def test_examples_and_frames_equal_jax(img_dtype, lbl_dtype, tmp_path):
    rng = np.random.RandomState(1)
    img = (rng.rand(5, 6, 3) * 200).astype(img_dtype)
    lbl = rng.randint(0, 9, (5, 6)).astype(lbl_dtype)
    args = (img, lbl, 5, 6, 3, 5, 6, "60:2:10.0:43:-374:3512")
    assert texample.encode_example_features(*args) == \
        jexample.encode_example_features(*args)
    assert texample.storage_payloads(img, lbl) == \
        jexample.storage_payloads(img, lbl)
    paths = [str(tmp_path / n) for n in ("port", "jax")]
    with ttfrecord.TFRecordWriter(paths[0]) as w:
        texample.write_example_framed(w.fileobj, *args)
        w.write(b"raw record")
    with jtfrecord.TFRecordWriter(paths[1]) as w:
        jexample.write_example_framed(w.fileobj, *args)
        w.write(b"raw record")
    port, ref = (open(p, "rb").read() for p in paths)
    assert port == ref
    assert list(ttfrecord.read_records(paths[0])) == \
        list(jtfrecord.read_records(paths[1]))


def test_corrupt_byte_fails_the_crc_and_abort_leaves_tmp(tmp_path):
    path = str(tmp_path / "d-00000-of-00001")
    with ttfrecord.TFRecordWriter(path) as w:
        w.write(b"x" * 100)
    data = bytearray(open(path, "rb").read())
    data[40] ^= 1
    open(path, "wb").write(bytes(data))
    with pytest.raises(IOError, match="corrupt record data CRC"):
        list(ttfrecord.read_records(path))
    assert len(list(ttfrecord.read_records(path, verify_crc=False))) == 1
    w = ttfrecord.TFRecordWriter(str(tmp_path / "d-00001-of-00002"))
    w.write(b"y")
    w.abort()
    assert sorted(os.listdir(tmp_path)) == ["d-00000-of-00001",
                                            "d-00001-of-00002.tmp"]
    assert ttfrecord.list_shards(str(tmp_path), "d") == [path]


def chip_folder(root, dtype):
    """PAIRS GeoTIFF chip pairs named like DLTile keys: images (SIZE,
    SIZE, 3) of ``dtype``, uint8 labels with nodata 255."""
    rng = np.random.RandomState(3)
    for sub in ("images", "labels"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    gt = (300000.0, 10.0, 0.0, 2100000.0, 0.0, -10.0)
    for i in range(PAIRS):
        name = f"{SIZE}#2#10.0#43#{i - 5}#3512.tif"
        img = (rng.rand(SIZE, SIZE, 3) * (250 if dtype == np.uint8
                                          else 4000)).astype(dtype)
        lbl = rng.randint(0, 4, (SIZE, SIZE)).astype(np.uint8)
        lbl[rng.rand(SIZE, SIZE) < 0.1] = 255
        write_geotiff(os.path.join(root, "images", name), img,
                      geotransform=gt, epsg=32643)
        write_geotiff(os.path.join(root, "labels", name), lbl,
                      geotransform=gt, epsg=32643)
    return root


def read_dir(d):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d))}


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """{(dtype, store_as_array): (port shard dir, JAX shard dir)}."""
    base = tmp_path_factory.mktemp("records")
    out = {}
    for dtype in (np.uint16, np.uint8):
        chips = chip_folder(str(base / f"chips-{np.dtype(dtype).name}"),
                            dtype)
        for arr in (True, False):
            dirs = tuple(str(base / f"{who}-{np.dtype(dtype).name}-{arr}")
                         for who in ("port", "jax"))
            assert twriters.process_dataset_mp(
                "smoke", chips, dirs[0], 4, num_proc=2,
                store_as_array=arr) == PAIRS
            assert jwriters.process_dataset_mp(
                "smoke", chips, dirs[1], 4, num_proc=2,
                store_as_array=arr) == PAIRS
            out[(dtype, arr)] = dirs
    return out


@pytest.mark.parametrize("dtype", [np.uint16, np.uint8])
@pytest.mark.parametrize("store_as_array", [True, False])
def test_process_dataset_mp_shards_equal_jax(shards, dtype, store_as_array):
    port, ref = shards[(dtype, store_as_array)]
    got = read_dir(port)
    assert sorted(got) == [f"smoke-0000{i}-of-00004" for i in range(4)]
    assert got == read_dir(ref)


def test_resume_skips_complete_shards(shards, tmp_path, capsys):
    port, _ = shards[(np.uint16, True)]
    chips = os.path.join(os.path.dirname(port), "chips-uint16")
    out = str(tmp_path / "resumed")
    os.makedirs(out)
    keep = "smoke-00001-of-00004"
    open(os.path.join(out, keep), "wb").write(b"complete")
    assert twriters.process_dataset_mp("smoke", chips, out, 4,
                                       resume=True) == PAIRS - 3
    assert "skipping (resume)" in capsys.readouterr().out
    got, want = read_dir(out), read_dir(port)
    assert got.pop(keep) == b"complete"
    assert got == {k: v for k, v in want.items() if k != keep}


@pytest.mark.parametrize("mode,dtype,arr", [
    ("tifarr", np.uint16, True), ("rgbarr", np.uint8, True),
    ("tifraw", np.uint16, False), ("tifraw_eager", np.uint16, False),
    ("tifraw_eager", np.uint8, False)])
def test_parsers_equal_jax(shards, mode, dtype, arr):
    port, _ = shards[(dtype, arr)]
    n = 0
    for path in ttfrecord.list_shards(port, "smoke"):
        for rec in ttfrecord.read_records(path):
            got = tinput.PARSE_FNS[mode](rec)
            ref = jinput.PARSE_FNS[mode](rec)
            for g, r in zip(got[:2], ref[:2]):
                assert g.dtype == r.dtype
                np.testing.assert_array_equal(g, r)
            assert got[2] == ref[2]
            n += 1
    assert n == PAIRS


def png_chip_folder(root):
    """PAIRS PNG/JPEG chip pairs named like DLTile keys, as ``convert``
    writes them: uint8 RGB images (every third a quality-90 JPEG) and
    uint8 labels with nodata 255."""
    rng = np.random.RandomState(4)
    for sub in ("images", "labels"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i in range(PAIRS):
        stem = f"{SIZE}#2#10.0#43#{i - 5}#3512"
        img = rng.randint(0, 256, (SIZE, SIZE, 3)).astype(np.uint8)
        lbl = rng.randint(0, 4, (SIZE, SIZE)).astype(np.uint8)
        lbl[rng.rand(SIZE, SIZE) < 0.1] = 255
        ext = "jpg" if i % 3 == 0 else "png"
        enc = ((lambda a: timage.encode_jpeg(a, 90)) if ext == "jpg"
               else timage.encode_png)
        for sub, arr in (("images", img), ("labels", lbl)):
            with open(os.path.join(root, sub, f"{stem}.{ext}"), "wb") as f:
                f.write(enc(arr))
    return root


@pytest.fixture(scope="module")
def mt_shards(tmp_path_factory):
    """{kind: (port shard dir, JAX shard dir)} of the MT engine over one
    PNG/JPEG chip folder, for rgbraw, rgbarr (--store-as-array) and
    --png-to-jpg."""
    base = tmp_path_factory.mktemp("mt")
    chips = png_chip_folder(str(base / "chips"))
    out = {"chips": chips}
    for kind, kw in (("rgbraw", {}), ("rgbarr", {"store_as_array": True}),
                     ("jpg", {"convert_png_to_jpg": True})):
        dirs = tuple(str(base / f"{who}-{kind}") for who in ("port", "jax"))
        assert twriters.process_dataset_multithreaded(
            "mt", chips, dirs[0], 4, num_threads=2, **kw) == PAIRS
        assert jwriters.process_dataset_multithreaded(
            "mt", chips, dirs[1], 4, num_threads=2, **kw) == PAIRS
        out[kind] = dirs
    return out


@pytest.mark.parametrize("kind", ["rgbraw", "rgbarr", "jpg"])
def test_mt_engine_shards_equal_jax(mt_shards, kind):
    """Replaces test_rgbraw_and_the_mt_engine_raise's MT case: the MT
    engine's shards are byte for byte the JAX engine's."""
    port, ref = mt_shards[kind]
    got = read_dir(port)
    assert sorted(got) == [f"mt-0000{i}-of-00004" for i in range(4)]
    assert got == read_dir(ref)


def test_mt_engine_resume_and_default_workers(mt_shards, tmp_path, capsys):
    port, _ = mt_shards["rgbraw"]
    out = str(tmp_path / "resumed")
    os.makedirs(out)
    keep = "mt-00002-of-00004"
    open(os.path.join(out, keep), "wb").write(b"complete")
    assert twriters.process_dataset_multithreaded(
        "mt", mt_shards["chips"], out, 4, resume=True) == PAIRS - 3
    assert "skipping (resume)" in capsys.readouterr().out
    got, want = read_dir(out), read_dir(port)
    assert got.pop(keep) == b"complete"
    assert got == {k: v for k, v in want.items() if k != keep}


def test_mt_engine_png_substring_quirk(tmp_path):
    """The JAX engine calls a file PNG when '.png' is anywhere in its
    path: JPEGs under a '.png' folder go to the PNG decoder, which takes
    any image container (PIL's open in the JAX package), and with
    --png-to-jpg they are transcoded again, in both packages."""
    chips = png_chip_folder(str(tmp_path / "x.png-chips"))
    for writer in (twriters, jwriters):
        for kw in ({"store_as_array": True}, {"convert_png_to_jpg": True}):
            out = str(tmp_path / f"out-{writer.__name__}-{len(kw)}-{kw}")
            assert writer.process_dataset_multithreaded(
                "q", chips, out, 2, **kw) == PAIRS
    for kw in ({"store_as_array": True}, {"convert_png_to_jpg": True}):
        assert read_dir(str(tmp_path / f"out-{twriters.__name__}-1-{kw}")) \
            == read_dir(str(tmp_path / f"out-{jwriters.__name__}-1-{kw}"))


@pytest.mark.parametrize("kind,mode", [("rgbraw", "rgbraw"),
                                       ("jpg", "rgbraw"),
                                       ("rgbarr", "rgbarr")])
def test_rgb_parsers_equal_jax(mt_shards, kind, mode):
    """Replaces test_rgbraw_and_the_mt_engine_raise's parser case."""
    port, _ = mt_shards[kind]
    n = 0
    for path in ttfrecord.list_shards(port, "mt"):
        for rec in ttfrecord.read_records(path):
            got = tinput.PARSE_FNS[mode](rec)
            ref = jinput.PARSE_FNS[mode](rec)
            for g, r in zip(got[:2], ref[:2]):
                assert g.dtype == r.dtype
                np.testing.assert_array_equal(g, r)
            assert got[2] == ref[2]
            n += 1
    assert n == PAIRS
    assert tparsers.parse_encoded_rgb_img_proto is \
        tinput.PARSE_FNS["rgbraw"]


@pytest.mark.parametrize("kind,mode,scale", [("rgbraw", "rgbraw", None),
                                             ("rgbraw", "rgbraw", "raw"),
                                             ("jpg", "rgbraw", 0.5)])
def test_rgbraw_feed_batches_equal_jax(mt_shards, kind, mode, scale):
    """Replaces test_rgbraw_and_the_mt_engine_raise's feed case: the
    rgbraw feed's batches equal the JAX feed's (one parse worker)."""
    port, _ = mt_shards[kind]
    kw = dict(batch_size=4, image_size=SIZE, shuffle_buffer=5, seed=3,
              num_workers=1, interleave=2, scale=scale, verify_crc=True)
    pattern = os.path.join(port, "mt-*")
    it_t = iter(tinput.TFRecordFeed(pattern, mode, **kw))
    it_j = iter(jinput.TFRecordFeed(pattern, mode, **kw))
    for _ in range(5):
        (gi, gl), (ri, rl) = next(it_t), next(it_j)
        assert gi.dtype == ri.dtype and gl.dtype == rl.dtype == np.int32
        np.testing.assert_array_equal(gi, ri)
        np.testing.assert_array_equal(gl, rl)


@pytest.mark.parametrize("mode,dtype,arr,scale", [
    ("tifarr", np.uint16, True, "raw"), ("rgbarr", np.uint8, True, None),
    ("tifraw_eager", np.uint16, False, None)])
def test_feed_batches_equal_jax(shards, mode, dtype, arr, scale):
    port, _ = shards[(dtype, arr)]
    kw = dict(batch_size=4, image_size=SIZE, shuffle_buffer=5, seed=7,
              num_workers=1, interleave=2, scale=scale, verify_crc=True)
    pattern = os.path.join(port, "smoke-*")
    it_t = iter(tinput.TFRecordFeed(pattern, mode, **kw))
    it_j = iter(jinput.TFRecordFeed(pattern, mode, **kw))
    for _ in range(7):  # past one epoch of 12 records
        (gi, gl), (ri, rl) = next(it_t), next(it_j)
        assert gi.dtype == ri.dtype and gl.dtype == rl.dtype == np.int32
        np.testing.assert_array_equal(gi, ri)
        np.testing.assert_array_equal(gl, rl)
    once = list(tinput.TFRecordFeed(pattern, mode, repeat=False,
                                    drop_remainder=False,
                                    **{**kw, "batch_size": 5}))
    assert [len(b[0]) for b in once] == [5, 5, 2]


def test_device_prefetcher_on_the_cpu():
    batches = [(np.full((2, 3), i, np.float32), np.full((2,), i, np.int32))
               for i in range(5)]

    def place(x, y):
        return torch.from_numpy(x), torch.from_numpy(y)
    with tinput.DevicePrefetcher(iter(batches), place, device="cpu") as pf:
        got = [int(x[0, 0]) for x, _ in pf]
    assert got == list(range(5))

    def broken():
        yield batches[0]
        raise IOError("truncated shard")
    pf = tinput.DevicePrefetcher(broken(), place, device="cpu")
    next(pf)
    with pytest.raises(IOError, match="truncated shard"):
        next(pf)
    with pytest.raises(StopIteration):
        next(pf)
    pf.close()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tinput.DevicePrefetcher(iter(batches), place)


def test_unreadable_pairs_are_skipped_with_their_reason(tmp_path, capsys):
    chips = chip_folder(str(tmp_path / "chips"), np.uint16)
    names = sorted(os.listdir(os.path.join(chips, "images")))
    with open(os.path.join(chips, "images", names[0]), "wb") as f:
        f.write(b"\x00\x00\x00\x0cjP  \r\n\x87\n" + bytes(32))
    with open(os.path.join(chips, "labels", names[1]), "wb") as f:
        f.write(b"II*\x00" + bytes(4))
    for arr in (True, False):
        out = str(tmp_path / f"out-{arr}")
        assert twriters.process_dataset_mp("s", chips, out, 2,
                                           store_as_array=arr) == PAIRS - 2
        text = capsys.readouterr().out
        assert "WARNING: 1 file(s) skipped: corrupt or unreadable JPEG " \
            "2000 container" in text
        assert "WARNING: 1 file(s) skipped: corrupt or unreadable GeoTIFF " \
            "container" in text
        assert sum(1 for p in ttfrecord.list_shards(out, "s")
                   for _ in ttfrecord.read_records(p)) == PAIRS - 2
