"""``decode_png`` / ``decode_jpeg`` of the port against the JAX package's
``decode_jpeg`` (PIL 12.1 over libtiff 4.7) on the TIFFs libtiff decodes
for PIL beyond LZW, Deflate, PackBits and JPEG, on the CPU: the array,
its dtype and byte order, bitwise, or the class and message prefix.

* Seeded bilevel images at widths 1-300 through every CCITT writer PIL
  has (Modified Huffman, its word-aligned form, Group 3 1-D, 2-D and with
  fill bits, Group 4), both fill orders and both photometrics, in strips
  of several rows; Group 3 and Modified Huffman strips that end early.
* zstd and LZMA over dtypes, predictors, strips, tiles and byte orders.
* Separate planes (PlanarConfiguration 2) over every compression the port
  decodes, RGB, RGBA, premultiplied RGBA, LA, CMYK, 16-bit RGB and a
  padding sample, in strips (libtiff's own, lifted from PIL-written
  planes) and tiles.
* YCbCr through libtiff's RGBA reader, in each subsampling.
* 12-bit grey, ThunderScan, and the compressions this libtiff refuses
  (WebP, SGILog for each photometric).
* Cuts through each new fixture of ``tests/data/pil``.
* The MT engine over chips of these codecs writes the JAX engine's
  records.

Nothing here compiles XLA.
"""

import glob
import importlib.util
import io
import lzma
import os
import re
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from dl_image_segmentation_tpu.raster import image as jimage
from dl_image_segmentation_tpu.records import writers as jwriters
from dl_image_segmentation_tpu_torch.raster import image as timage
from dl_image_segmentation_tpu_torch.raster.lzw import lzw_encode
from dl_image_segmentation_tpu_torch.records import writers as twriters
from dl_image_segmentation_tpu_torch.storage import zstd

# one intra-op thread: the test workers share the host's cores
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _generator():
    spec = importlib.util.spec_from_file_location(
        "make_codec_fixtures", os.path.join(DATA, "make_codec_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


gen = _generator()


def outcome(fn, data):
    """(array,) or (class name, message up to the first "(" or "<"); an
    AssertionError's message is not compared (the JAX package's assert
    has none)."""
    try:
        return (fn(data),)
    except Exception as e:  # noqa: BLE001 -- the outcome is compared
        name = type(e).__name__
        msg = re.split(r"[(<]", str(e))[0].strip()
        return name, "" if name == "AssertionError" else msg


def check(data, what=""):
    """Both port functions give the JAX package's ``decode_jpeg``
    outcome; returns it."""
    want = outcome(jimage.decode_jpeg, data)
    for fn in (timage.decode_jpeg, timage.decode_png):
        got = outcome(fn, data)
        if len(want) == 1:
            assert len(got) == 1, (what, fn.__name__, got)
            g, w = got[0], want[0]
            assert (g.dtype.str, g.shape) == (w.dtype.str, w.shape), what
            assert g.tobytes() == w.tobytes(), (what, fn.__name__)
        else:
            assert got == want, (what, fn.__name__)
    return want


def pil_tiff(im, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, "TIFF", **kw)
    return buf.getvalue()


def bilevel(rng, h, w):
    """Noise, or runs of random length (long white and black runs)."""
    if rng.rand() < 0.5:
        return rng.rand(h, w) < rng.choice([0.05, 0.5, 0.95])
    runs = rng.geometric(rng.choice([0.02, 0.2]), (h, w))
    return (np.cumsum(runs, axis=1) // 37 % 2).astype(bool)[:, :w]


def set_tag(data: bytes, tag: int, value: int) -> bytes:
    """``data`` with the inline value of ``tag`` in its first IFD."""
    e = "<" if data[:2] == b"II" else ">"
    ifd = int.from_bytes(data[4:8], "little" if e == "<" else "big")
    n = int.from_bytes(data[ifd:ifd + 2], "little" if e == "<" else "big")
    for i in range(n):
        p = ifd + 2 + 12 * i
        t, typ = np.frombuffer(data[p:p + 4], e + "u2")
        if t == tag:
            v = np.array([value], e + ("u2" if typ == 3 else "u4"))
            return data[:p + 8] + v.tobytes().ljust(4, b"\0") + \
                data[p + 12:]
    raise KeyError(tag)


# ------------------------------------------------------------------ CCITT

CCITT = [("group3", {}), ("group3", {292: 1}), ("group3", {292: 5}),
         ("group4", {}), ("tiff_ccitt", {}), ("tiff_raw_16", {})]
WIDTHS = (1, 2, 7, 8, 9, 15, 16, 17, 31, 33, 63, 64, 65, 100, 127, 255,
          256, 257, 299, 300)


@pytest.mark.parametrize("compression,info", CCITT,
                         ids=["g3-1d", "g3-2d", "g3-fill", "g4", "rle",
                              "rlew"])
def test_ccitt_writers_equal_jax(compression, info):
    """Each width, fill order and photometric, in strips of 1 row to the
    whole image."""
    rng = np.random.RandomState(sum(map(ord, compression)) + len(info))
    decoded = 0
    for w in WIDTHS:
        for fill in (1, 2):
            for photo in (0, 1):
                h = rng.randint(1, 24)
                tags = {**info, 266: fill, 262: photo,
                        278: int(rng.randint(1, h + 1))}
                data = pil_tiff(Image.fromarray(bilevel(rng, h, w)),
                                compression=compression, tiffinfo=tags)
                decoded += len(check(data, (w, fill, photo, tags))) == 1
    # libtiff reads back only part of what its word-aligned writer
    # (32771) writes: those failures are compared too
    assert decoded == len(WIDTHS) * 4 or compression == "tiff_raw_16" and \
        decoded


@pytest.mark.parametrize("compression,info", [c for c in CCITT
                                              if c[0] != "group4"],
                         ids=["g3-1d", "g3-2d", "g3-fill", "rle", "rlew"])
def test_ccitt_strip_ending_early_equals_jax(compression, info):
    """A strip whose byte count stops short: libtiff's outcome, which is
    an error, or for Group 3 a second pass over the strip as if it had no
    EOLs. (A Group 4 strip that ends early succeeds with its later rows
    unwritten, so PIL returns whatever memory its buffer held there.)"""
    rng = np.random.RandomState(7 + len(info))
    for w in (5, 37, 64, 250):
        h = rng.randint(2, 16)
        data = pil_tiff(Image.fromarray(bilevel(rng, h, w)),
                        compression=compression, tiffinfo=info)
        n = Image.open(io.BytesIO(data)).tag_v2[279][0]
        for cut in sorted(set(rng.randint(1, n, 6))):
            check(set_tag(data, 279, int(cut)), (w, h, cut))


# ------------------------------------------------------------ zstd, LZMA

def hdiff(block: np.ndarray) -> bytes:
    """Horizontal differencing (Predictor 2) of a block in its byte
    order."""
    v = block.astype(block.dtype.newbyteorder("="))
    d = v.copy()
    d[:, 1:] = v[:, 1:] - v[:, :-1]
    return d.astype(block.dtype).tobytes()


def fdiff(block: np.ndarray) -> bytes:
    """The floating-point predictor (3): each row's bytes as big-endian
    planes, then differenced."""
    out = b""
    for row in block.reshape(block.shape[0], -1):
        b = row.astype(">f4").view(np.uint8).reshape(-1, 4).T.reshape(-1)
        d = b.copy()
        d[1:] = b[1:] - b[:-1]
        out += d.tobytes()
    return out


CODERS = {
    5: lambda b: lzw_encode(b), 8: zlib.compress,
    32773: lambda b: bytes(x for i in range(0, len(b), 128)
                           for x in (min(128, len(b) - i) - 1,
                                     *b[i:i + 128])),
    34925: lambda b: lzma.compress(b, format=lzma.FORMAT_XZ),
    50000: zstd.compress_raw}


@pytest.mark.parametrize("compression", ["zstd", "lzma"])
def test_zstd_lzma_equal_jax(compression):
    """PIL-written strips (grey, RGB, RGBA, I;16 and float, with and
    without predictors), and hand-coded tiles in both byte orders."""
    code = {"zstd": 50000, "lzma": 34925}[compression]
    rng = np.random.RandomState(code % 97)
    decoded = 0
    for h, w in ((1, 1), (5, 9), (23, 37), (40, 17)):
        rgb = rng.randint(0, 256, (h, w, 4)).astype(np.uint8)
        rgb = np.cumsum(rgb, axis=1, dtype=np.uint8)
        for im, preds in ((Image.fromarray(rgb[:, :, 0]), (1, 2)),
                          (Image.fromarray(rgb[:, :, :3]), (1, 2)),
                          (Image.fromarray(rgb), (2,)),
                          (Image.fromarray(rgb[:, :, 0].astype(np.uint16)
                                           * 257), (1, 2)),
                          (Image.fromarray(rgb[:, :, 1].astype(np.float32)
                                           / 7), (1, 3))):
            for p in preds:
                data = pil_tiff(im, compression=compression,
                                tiffinfo={317: p, 278: int(rng.randint(
                                    1, h + 1))})
                decoded += len(check(data, (im.mode, p, h, w))) == 1
        for order in "<>":
            for a, photo, p, coder in (
                    (rgb[:, :, :3], 2, 1, lambda b: b.tobytes()),
                    (rgb[:, :, :1].astype(np.uint16) * 300, 1, 2, hdiff),
                    (rgb[:, :, :3].astype(np.uint16) * 257, 2, 2, hdiff),
                    (rgb[:, :, :1] / np.float32(3), 1, 3, fdiff)):
                data = gen.tiff_coded(
                    a, photo, code, lambda b: CODERS[code](coder(b)),
                    order=order, tile=(16, 16), tags=[(317, 3, [p])])
                decoded += len(check(data, (order, a.dtype, p, h, w))) == 1
    # all but RGBA, which decode_jpeg refuses for its fourth band
    assert decoded == 4 * (8 + 8)


# -------------------------------------------------------- separate planes

def jpeg_plane(block: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(block[:, :, 0])).save(
        buf, "JPEG", quality=85)
    return buf.getvalue()


LAYOUTS = [  # (bands, photometric, extra samples, dtype)
    (3, 2, None, np.uint8), (4, 2, (2,), np.uint8), (4, 2, (1,), np.uint8),
    (2, 1, (2,), np.uint8), (4, 5, None, np.uint8), (3, 2, None, np.uint16),
    (4, 2, (0,), np.uint8)]


@pytest.mark.parametrize("compression", [5, 8, 32946, 32773, 7, 34925, 50000])
def test_separate_planes_equal_jax(compression):
    """RGB, RGBA, premultiplied RGBA, LA, CMYK, 16-bit RGB and RGB with
    a padding sample, in strips and tiles: each plane unpacked into its
    byte of PIL's pixel, as PIL's libtiff decoder does."""
    rng = np.random.RandomState(compression % 89)
    pil_name = {5: "tiff_lzw", 8: "tiff_adobe_deflate", 32946: None,
                32773: "packbits", 7: None, 34925: "lzma",
                50000: "zstd"}[compression]
    coder = jpeg_plane if compression == 7 else (
        lambda b: CODERS[8 if compression == 32946 else compression](
            b.tobytes()))
    outcomes = set()
    for bands, photo, extra, dtype in LAYOUTS:
        if compression == 7 and dtype != np.uint8:
            continue
        h, w = rng.randint(1, 40), rng.randint(1, 40)
        a = np.cumsum(rng.randint(0, 9, (h, w, bands)), axis=1)
        a = (a * (257 if dtype == np.uint16 else 1) % np.iinfo(dtype).max
             ).astype(dtype)
        tags = [(338, 3, list(extra))] if extra else []
        cases = [gen.tiff_coded(a, photo, compression, coder, planar=2,
                                tile=(16, 16), tags=tags),
                 gen.tiff_coded(a, photo, compression, coder, planar=2,
                                rows=int(rng.randint(1, h + 1)), tags=tags)]
        if pil_name and dtype == np.uint8:
            cases.append(gen.pil_planes(a, photo, pil_name,
                                        int(rng.randint(1, h + 1)),
                                        extra=extra))
        for data in cases:
            got = check(data, (compression, bands, photo, extra, dtype))
            outcomes.add("array" if len(got) == 1 else got[0])
    assert {"array", "AssertionError"} <= outcomes


def test_separate_planes_of_one_band_equal_jax():
    """One sample with PlanarConfiguration 2 is read as if contiguous:
    CCITT, ThunderScan and 12-bit grey among them."""
    rng = np.random.RandomState(3)
    a = bilevel(rng, 19, 45)
    for comp in ("group4", "group3", "tiff_ccitt"):
        data = pil_tiff(Image.fromarray(a), compression=comp,
                        tiffinfo={284: 2})
        assert len(check(data, comp)) == 1
    v = rng.randint(0, 4096, (9, 13, 1)).astype(np.uint16)
    check(gen.tiff_coded(v, 1, 8, lambda b: zlib.compress(gen.pack12(b)),
                         planar=2, rows=4, bits=12), "i12")


# ------------------------------------------------------------------ YCbCr

SUBSAMPLINGS = [(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)]


@pytest.mark.parametrize("hs,vs", SUBSAMPLINGS,
                         ids=[f"{h}x{v}" for h, v in SUBSAMPLINGS])
def test_ycbcr_through_libtiffs_rgba_reader_equals_jax(hs, vs):
    """YCbCr that PIL hands to libtiff's TIFFRGBAImage (any compression
    but JPEG in one plane): subsampled blocks in strips and tiles of odd
    sizes (libtiff's short reads of 4 x 4 strips and its skip over tiles
    past the edge included), and cuts through them; at 1 x 1 also
    PIL-written files with predictors and orientations, and separate
    planes in Deflate and JPEG."""
    rng = np.random.RandomState(hs * 10 + vs)
    for h, w in ((1, 1), (3, 5), (17, 23), (33, 18)):
        a = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        for kw in (dict(rows=vs * int(rng.randint(1, 4))),
                   dict(tile=(16, 16))):
            for code in (8, 34925):
                data = gen.tiff_coded(
                    a, 6, code, lambda b: CODERS[code](gen.ycbcr_blocks(
                        b, hs, vs)), tags=[(530, 3, [hs, vs])], **kw)
                assert len(check(data, (h, w, kw, code))) == 1
                for k in rng.randint(8, len(data), 3):
                    check(data[:k], (h, w, kw, code, k))
        if (hs, vs) != (1, 1):
            continue
        for comp in ("tiff_lzw", "packbits", "zstd"):
            info = {317: int(rng.choice([1, 2])), 274: int(rng.randint(1, 9)),
                    278: int(rng.randint(1, h + 1))}
            data = pil_tiff(Image.fromarray(a).convert("YCbCr"),
                            compression=comp, tiffinfo=info)
            assert len(check(data, (comp, info))) == 1
        for code, coder in ((8, lambda b: zlib.compress(b.tobytes())),
                            (7, jpeg_plane)):
            for sub in ([(530, 3, [1, 1])], []):
                data = gen.tiff_coded(a, 6, code, coder, planar=2, rows=8,
                                      tags=sub)
                # libtiff converts separate planes only unsubsampled
                assert len(check(data, (code, sub))) == (2 if not sub else 1)


# ------------------------------------------ 12-bit, ThunderScan, refusals

@pytest.mark.parametrize("compression", [1, 5, 8, 32773, 34925, 50000])
def test_12_bit_grey_equals_jax(compression):
    """I;12 to PIL's I;16: strips and tiles, and libtiff's refusal of a
    predictor on 12-bit samples (the raw decoder ignores the tag)."""
    rng = np.random.RandomState(compression % 83)
    for h, w in ((1, 1), (3, 2), (17, 31), (33, 40)):
        v = rng.randint(0, 4096, (h, w, 1)).astype(np.uint16)
        for kw in (dict(rows=int(rng.randint(1, h + 1))),
                   dict(tile=(16, 16))):
            for p in (1, 2):
                data = gen.tiff_coded(
                    v, 1, compression,
                    lambda b: (CODERS.get(compression, bytes))(
                        gen.pack12(b)), bits=12, tags=[(317, 3, [p])], **kw)
                got = check(data, (h, w, kw, p))
                assert len(got) == (
                    1 if p == 1 or compression in (1, 32773) else 2)


def test_thunderscan_equals_jax():
    """Seeded 4-bit images, both photometrics, strips of a row to the
    whole image: runs, 2-bit and 3-bit deltas and raw values."""
    rng = np.random.RandomState(32809)
    for h, w in ((1, 1), (2, 3), (9, 23), (30, 64), (7, 101)):
        for photo in (0, 1):
            walk = np.cumsum(rng.randint(-2, 3, (h, w)), axis=1) % 16
            px = walk if rng.rand() < 0.7 else rng.randint(0, 16, (h, w))
            data = gen.tiff_coded(
                px.astype(np.uint8)[:, :, None], photo, 32809,
                lambda b: gen.thunderscan(b[:, :, 0], rng),
                rows=int(rng.randint(1, h + 1)), bits=4)
            assert len(check(data, (h, w, photo))) == 1


@pytest.mark.parametrize("compression,photometric,bits", [
    (50001, 2, 8), (50001, 1, 8), (34676, 1, 16), (34677, 2, 8),
    (34676, 32844, 16), (34677, 32845, 8)])
def test_refused_codecs_equal_jax(compression, photometric, bits):
    """WebP-in-TIFF (this libtiff has no WebP) and SGILog (libtiff takes
    LogLuv and LogL only; PIL has no mode for those): PIL's class and
    message, through strips and tiles."""
    a = np.arange(5 * 7).reshape(5, 7, 1) % 200
    a = np.repeat(a, 3 if photometric in (2, 32845) else 1, axis=2)
    for kw in (dict(rows=2), dict(tile=(16, 16))):
        data = gen.tiff_coded(a.astype(np.uint8 if bits == 8 else np.uint16),
                              photometric, compression, lambda b: b.tobytes(),
                              **kw)
        assert len(check(data, kw)) == 2


# ---------------------------------------------------------- truncations

NEW = sorted(name for name, _ in gen.tiff_codec_fixtures()) + [
    "chip128-tiff-zstd-planar.tif"]


@pytest.mark.parametrize("name", NEW)
def test_new_fixture_cuts_equal_jax(name):
    """The fixture itself, and cuts through its strips and its IFD."""
    with open(os.path.join(DATA, "pil", name), "rb") as f:
        data = f.read()
    check(data, name)
    for k in sorted(set(np.linspace(1, len(data) - 1, 24).astype(int))):
        check(data[:k], (name, k))


# ------------------------------------------------------------ MT engine

def _chip_folder(root):
    """24 px chip pairs named like DLTile keys, as .jpg and .png: zstd,
    LZMA, separate planes (Deflate strips, zstd tiles, JPEG), 12-bit,
    ThunderScan and Group 4 images, two of them cut short."""
    rng = np.random.RandomState(20)
    for sub in ("images", "labels"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    a = np.cumsum(rng.randint(0, 12, (24, 24, 3)), axis=1).astype(np.uint8)
    files = [
        pil_tiff(Image.fromarray(a), compression="zstd", tiffinfo={317: 2}),
        pil_tiff(Image.fromarray(a[:, :, 0]), compression="lzma"),
        gen.pil_planes(a, 2, "tiff_adobe_deflate", 8),
        gen.tiff_coded(a, 2, 50000, lambda b: zstd.compress_raw(
            b.tobytes()), planar=2, tile=(16, 16)),
        gen.tiff_coded(a, 2, 7, jpeg_plane, planar=2, rows=16),
        gen.tiff_coded(a[:, :, :1].astype(np.uint16) * 16, 1, 8,
                       lambda b: zlib.compress(gen.pack12(b)), rows=8,
                       bits=12),
        gen.tiff_coded(a[:, :, :1] // 16, 1, 32809,
                       lambda b: gen.thunderscan(b[:, :, 0], rng), rows=8,
                       bits=4),
        pil_tiff(Image.fromarray(a[:, :, 1] > 100), compression="group4"),
        pil_tiff(Image.fromarray(a), compression="zstd"),
        pil_tiff(Image.fromarray(a[:, :, 2] > 90), compression="group3")]
    for i, data in enumerate(files):
        if i >= 8:
            data = data[:len(data) // 2]
        ext = "png" if i % 2 else "jpg"
        stem = f"24#2#10.0#43#{i}#3512"
        with open(os.path.join(root, "images", f"{stem}.{ext}"), "wb") as f:
            f.write(data)
        with open(os.path.join(root, "labels", f"{stem}.{ext}"), "wb") as f:
            f.write(timage.encode_png(rng.randint(0, 4, (24, 24)).astype(
                np.uint8)))
    return root


@pytest.mark.parametrize("kw", [{"store_as_array": True},
                                {"convert_png_to_jpg": True}])
def test_mt_engine_writes_the_jax_records(tmp_path, capsys, kw):
    """Decode mode and the PNG-to-JPEG transcode of raw mode: the JAX
    engine's records shard by shard, and its skip lines."""
    from dl_image_segmentation_tpu_torch.records import tfrecord
    chips = _chip_folder(str(tmp_path / "chips"))
    outs, written, lines = [], [], []
    for writer in (twriters, jwriters):
        out = str(tmp_path / f"out-{writer.__name__}")
        written.append(writer.process_dataset_multithreaded(
            "t", chips, out, 2, num_threads=2, **kw))
        lines.append(sorted(line for line in capsys.readouterr().out
                            .splitlines() if line.startswith("WARNING")))
        outs.append(out)
    assert written[0] == written[1] > 0
    assert lines[0] == lines[1] and lines[0], lines
    shards = [sorted(glob.glob(os.path.join(o, "t-*"))) for o in outs]
    assert len(shards[0]) == len(shards[1]) == 2
    for a, b in zip(*shards):
        assert sorted(tfrecord.read_records(a, verify_crc=True)) == \
            sorted(tfrecord.read_records(b))
