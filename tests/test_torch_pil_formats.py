"""``decode_png`` / ``decode_jpeg`` / ``png_to_jpeg`` of the port against
the JAX package's (PIL 12.1: libwebp 1.6, libtiff 4.7, libjpeg-turbo 3),
on the CPU, over the formats PIL opens.

* Every fixture of ``tests/data/pil`` (written by
  ``tests/data/make_codec_fixtures.py pil``: WebP, TIFF, PPM, TGA, SGI,
  PCX, QOI, ICO/CUR, IM, XBM, DDS and refusals of each failure class)
  decodes through both functions to its ``.npz`` (the JAX package's
  ``decode_jpeg``: the array, its dtype and byte order, bitwise; or the
  class name and message prefix it raises), and ``png_to_jpeg`` gives
  the JAX package's bytes or exception.
* Seeded PIL-written files of each format (sizes, modes, qualities)
  against the JAX package live; the WebP alpha plane, which ``decode_*``
  refuse with the 4-band AssertionError, against PIL's RGBA.
* Truncations of every fixture: the same class and message prefix
  through both functions.
* A seeded fuzz of the fixtures' headers: the opener the port names is
  the one ``PIL.Image.open`` picks (in a fresh interpreter, where PIL
  walks ``Image.ID`` in its first-open order), or both raise the same
  class.
* The MT engine over a folder of WebP, TIFF, PPM, TGA and QOI chips
  named ``.jpg`` / ``.png`` (truncated ones among them) writes the JAX
  engine's records, with its skip lines.

Nothing here compiles XLA.
"""

import glob
import io
import json
import os
import pickle
import re
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from dl_image_segmentation_tpu.raster import image as jimage
from dl_image_segmentation_tpu.records import writers as jwriters
from dl_image_segmentation_tpu_torch.raster import image as timage
from dl_image_segmentation_tpu_torch.raster import pil_open
from dl_image_segmentation_tpu_torch.raster import webp as twebp
from dl_image_segmentation_tpu_torch.records import writers as twriters

# one intra-op thread: the test workers share the host's cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data", "pil")
FIXTURES = sorted(os.path.basename(p) for p in glob.glob(
    os.path.join(DATA, "*")) if not p.endswith(".npz"))


def prefix(msg: str) -> str:
    """A message up to the first "(" or "<": PIL's counts of unread
    bytes and object reprs are not compared."""
    return re.split(r"[(<]", msg)[0].strip()


def outcome(fn, data):
    """(array,) or (class name, message prefix); an AssertionError's
    message is not compared (the JAX package's assert has none)."""
    try:
        return (fn(data),)
    except Exception as e:  # noqa: BLE001 -- the outcome is compared
        name = type(e).__name__
        return name, "" if name == "AssertionError" else prefix(str(e))


def assert_same(got, want, what=""):
    if len(want) == 1:
        assert len(got) == 1, (what, got)
        g, w = got[0], want[0]
        if isinstance(w, bytes):
            assert g == w, what
            return
        assert g.dtype.str == w.dtype.str and g.shape == w.shape, \
            (what, g.dtype.str, g.shape, w.dtype.str, w.shape)
        assert g.tobytes() == w.tobytes(), what
        return
    assert got == want, what


def read(name: str) -> bytes:
    with open(os.path.join(DATA, name), "rb") as f:
        return f.read()


def npz_outcome(name: str):
    z = np.load(os.path.join(DATA, os.path.splitext(name)[0] + ".npz"))
    if "array" in z.files:
        return (z["array"],)
    cls = str(z["error_class"])
    return cls, "" if cls == "AssertionError" else prefix(str(
        z["error_prefix"]))


def test_fixtures_cover_the_formats():
    """Each format and failure class has fixtures, each beside its
    ``.npz``, and the folder stays under 1 MiB."""
    stems = {n.split("-")[0] for n in FIXTURES}
    assert {"webp", "tiff", "ppm", "tga", "sgi", "pcx", "qoi", "ico", "cur",
            "im", "xbm", "dds", "refuse"} <= stems
    for name in FIXTURES:
        assert os.path.exists(os.path.join(
            DATA, os.path.splitext(name)[0] + ".npz")), name
    classes = {o[0] for o in map(npz_outcome, FIXTURES) if len(o) == 2}
    assert {"OSError", "UnidentifiedImageError", "SyntaxError", "ValueError",
            "DecompressionBombError", "AssertionError"} <= classes
    total = sum(os.path.getsize(p) for p in glob.glob(os.path.join(DATA, "*")))
    assert total < 1 << 20


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_decodes_to_the_jax_outcome(name):
    data = read(name)
    want = npz_outcome(name)
    for fn in (timage.decode_jpeg, timage.decode_png):
        assert_same(outcome(fn, data), want, (name, fn.__name__))


def test_png_to_jpeg_equals_jax_on_every_fixture():
    """The JPEG bytes PIL writes from the decoded pixels (a bilevel image
    as grey 0/255), or PIL's "cannot write mode ... as JPEG"."""
    for name in FIXTURES:
        data = read(name)
        got = outcome(timage.png_to_jpeg, data)
        want = outcome(jimage.png_to_jpeg, data)
        assert_same(got, want, name)


def test_exception_classes_are_pils():
    """UnidentifiedImageError is an OSError, as PIL's is; the others are
    PIL's builtin classes."""
    assert issubclass(timage.UnidentifiedImageError, OSError)
    with pytest.raises(timage.UnidentifiedImageError):
        timage.decode_png(b"not an image at all")
    with pytest.raises(timage.DecompressionBombError):
        timage.decode_jpeg(read("refuse-bomb.ppm"))
    with pytest.raises(SyntaxError):
        timage.decode_png(read("refuse-png-bad-chunk.png"))
    with pytest.raises(OSError, match="image file is truncated"):
        timage.decode_jpeg(read("refuse-truncated-bmp.bmp"))
    # PIL's own refusals are copied: its EPS reader needs Ghostscript,
    # its GRIB stub has no loader
    eps = _save(Image.fromarray(np.zeros((6, 5, 3), np.uint8)), "EPS")
    for data in (eps, read("refuse-grib-stub.grb")):
        want = outcome(jimage.decode_jpeg, data)
        assert want[0] == "OSError"
        for fn in (timage.decode_jpeg, timage.decode_png):
            assert_same(outcome(fn, data), want)


NEW_FORMATS = ("webp", "tiff", "ppm", "tga", "sgi", "pcx", "qoi", "ico",
               "cur", "im", "xbm", "dds")


def _save(im, fmt, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def _dds_dx10(dxgi: int) -> bytes:
    head = bytearray(148)
    head[:4] = b"DDS "
    struct.pack_into("<7I", head, 4, 124, 0x1007, 8, 8, 0, 0, 0)
    struct.pack_into("<4I", head, 76, 32, 0x4, 0x30315844, 0)  # "DX10"
    struct.pack_into("<I", head, 128, dxgi)
    return bytes(head) + bytes(64)


def _pil_written(fmt, mode):
    a = (np.arange(8 * 6 * 3) % 251).astype(np.uint8).reshape(8, 6, 3)
    im = Image.fromarray(a).convert(mode)
    return _save(im, fmt)


def _old_style_jpeg_tiff():
    """A PIL-written RGB TIFF relabelled compression 6 (old-style JPEG),
    which PIL opens as YCbCr-coded RGB."""
    entry = struct.pack("<HHI", 259, 3, 1)
    data = _pil_written("TIFF", "RGB")
    return data.replace(entry + b"\1\0\0\0", entry + b"\6\0\0\0")


@pytest.mark.parametrize("what,data", [
    ("DDS BC7", _dds_dx10(98)), ("DDS BC6H", _dds_dx10(95)),
    ("TIFF old-style JPEG", _old_style_jpeg_tiff()),
    ("BLP", _pil_written("BLP", "P")), ("MSP", _pil_written("MSP", "1")),
    ("SPIDER", _pil_written("SPIDER", "F")),
    ("IM RGB3", b"Image type: RGB3 image\r\nImage size (x*y): 2*2\r\n"
     b"\x1a" + bytes(600))])
def test_what_this_slice_leaves_names_item_16(what, data):
    """What PIL opens and the port does not decode yet raises
    UnsupportedFormatError naming ROADMAP queue 1 item 16 through both
    functions (PIL opens each of these bytes)."""
    Image.open(io.BytesIO(data))
    for fn in (timage.decode_jpeg, timage.decode_png):
        with pytest.raises(timage.UnsupportedFormatError, match="item 16"):
            fn(data)


def test_decode_image_bytes_and_sniffer_keep_their_dispatch():
    """Request bodies and raw-mode sniffing are unchanged: the formats
    ``decode_png`` now takes stay refused by the magic-byte dispatch (or
    decode, TIFF), as in the JAX package, and PNG/JPEG/BMP failures keep
    their CorruptRasterError."""
    for name in FIXTURES:
        if name.split("-")[0] not in NEW_FORMATS:
            continue
        data = read(name)
        for fn in ("decode_image_bytes", "sniff_image_info"):
            got = outcome(getattr(timage, fn), data)
            want = outcome(getattr(jimage, fn), data)
            if len(want) == 1:
                assert len(got) == 1, (name, fn, got)
                continue
            assert got[0] == want[0], (name, fn, got, want)
    with pytest.raises(timage.CorruptRasterError):
        timage.decode_image_bytes(read("refuse-truncated-png.png"))


# ------------------------------------------------------- seeded PIL cases

def _image(rng, h, w, smooth):
    if smooth:
        y, x = np.mgrid[0:h, 0:w]
        a = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                      (x + y) * 5 % 256], -1)
        a = a + rng.randint(-8, 8, a.shape)
    else:
        a = rng.randint(0, 256, (h, w, 3))
    return np.clip(a, 0, 255).astype(np.uint8)


SEEDED = {
    "WEBP": [dict(lossless=True), dict(quality=90), dict(quality=30),
             dict(quality=75, method=0), dict(lossless=True, quality=0)],
    "TIFF": [dict(), dict(compression="tiff_lzw"), dict(compression="jpeg"),
             dict(compression="packbits"), dict(compression="tiff_deflate")],
    "PPM": [dict()], "TGA": [dict(), dict(compression="tga_rle")],
    "SGI": [dict(), dict(bpc=2)], "PCX": [dict()], "QOI": [dict()],
    "IM": [dict()], "DDS": [dict(), dict(pixel_format="BC5")],
}


@pytest.mark.parametrize("fmt", sorted(SEEDED))
def test_seeded_files_equal_jax(fmt):
    rng = np.random.RandomState(len(fmt) * 7 + ord(fmt[0]))
    for (h, w) in ((1, 1), (5, 9), (16, 16), (23, 37)):
        for smooth in (0, 1):
            a = _image(rng, h, w, smooth)
            for mode in ("RGB", "L"):
                if fmt in ("DDS", "QOI") and mode == "L":
                    continue  # PIL writes no grey QOI; grey DDS is a fixture
                for kw in SEEDED[fmt]:
                    if fmt == "TIFF" and kw.get("compression") == "jpeg" \
                            and h * w < 4:
                        continue
                    data = _save(Image.fromarray(a).convert(mode), fmt, **kw)
                    want = outcome(jimage.decode_jpeg, data)
                    for fn in (timage.decode_jpeg, timage.decode_png):
                        assert_same(outcome(fn, data), want,
                                    (fmt, kw, mode, h, w))


def test_webp_alpha_plane_equals_pils():
    """The RGBA that ``decode_*`` refuse (4 bands): raw and VP8L-coded
    ALPH with each filter, lossless alpha, and the first frame of an
    animation on its canvas, against ``np.asarray`` of PIL's image."""
    rng = np.random.RandomState(5)
    cases = []
    for (h, w) in ((1, 1), (7, 5), (33, 20)):
        a = np.dstack([_image(rng, h, w, 1), rng.randint(0, 256, (h, w))
                       .astype(np.uint8)])
        for kw in (dict(lossless=True), dict(quality=60),
                   dict(quality=60, alpha_quality=40),
                   dict(quality=80, method=6)):
            cases.append(_save(Image.fromarray(a), "WEBP", **kw))
    frames = [Image.fromarray(np.dstack([_image(rng, 20, 17, 0),
                                         rng.randint(0, 256, (20, 17))])
                              .astype(np.uint8)) for _ in range(2)]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:],
                   quality=50)
    cases.append(buf.getvalue())
    for data in cases:
        want = np.asarray(Image.open(io.BytesIO(data)))
        got = twebp.decode_webp_rgba(data)
        if want.shape[2] == 3:
            got = got[:, :, :3]
        assert got.shape == want.shape
        assert got.tobytes() == want.tobytes()


# -------------------------------------------------------------- truncations

@pytest.mark.parametrize("stem", sorted({n.split("-")[0] for n in FIXTURES}))
def test_truncations_raise_the_jax_class(stem):
    """Cuts through the header and the data of each fixture: the JAX
    package's class and message prefix (or array) through both
    functions."""
    for name in FIXTURES:
        if name.split("-")[0] != stem:
            continue
        data = read(name)
        cuts = sorted({*range(0, min(len(data), 24), 3),
                       *np.linspace(0, len(data) - 1, 14).astype(int)})
        for k in cuts:
            cut = data[:k]
            want = outcome(jimage.decode_jpeg, cut)
            for fn in (timage.decode_jpeg, timage.decode_png):
                assert_same(outcome(fn, cut), want, (name, k))


# ---------------------------------------------------- opener identification

_PIL_OPEN = """
import io, pickle, sys, warnings
warnings.simplefilter("ignore")
from PIL import Image
cases = pickle.load(open(sys.argv[1], "rb"))
out = []
for data in cases:
    try:
        out.append(Image.open(io.BytesIO(data)).format)
    except Exception as e:
        out.append("!" + type(e).__name__)
print(__import__("json").dumps([out, Image.ID]))
"""


def _pil_formats(cases, tmp_path):
    path = str(tmp_path / "cases.pkl")
    with open(path, "wb") as f:
        pickle.dump(cases, f)
    res = subprocess.run([sys.executable, "-c", _PIL_OPEN, path],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout)


def _port_format(data):
    try:
        return pil_open.identify(data).fmt
    except pil_open.UnsupportedFormat as e:
        return e.fmt
    except Exception as e:  # noqa: BLE001 -- the outcome is compared
        return "!" + type(e).__name__


def test_header_fuzz_names_pils_opener(tmp_path):
    """About 1300 seeded byte flips and replacements in the first bytes
    of the fixtures: the opener the port names is PIL's (the walk over
    ``Image.ID`` in its order, accept checks, permissive openers, the
    classes that send the bytes on), or both raise the same class. PIL's
    own order is checked too."""
    rng = np.random.RandomState(16)
    cases = []
    for name in FIXTURES:
        data = read(name)
        for _ in range(12):
            b = bytearray(data)
            for _ in range(rng.randint(1, 4)):
                pos = rng.randint(0, min(len(b), 40)) if b else 0
                if pos < len(b):
                    b[pos] = (rng.randint(256) if rng.rand() < .5
                              else b[pos] ^ (1 << rng.randint(8)))
            cases.append(bytes(b))
    pil, order = _pil_formats(cases, tmp_path)
    assert tuple(order) == pil_open.ORDER
    got = [_port_format(c) for c in cases]
    bad = [(i, g, w) for i, (g, w) in enumerate(zip(got, pil)) if g != w]
    assert not bad, bad[:10]


# ---------------------------------------------------------------- MT engine

def _chip_folder(root):
    """Chip pairs named like DLTile keys: WebP, TIFF, PPM, TGA and QOI
    images named .jpg and .png, PNG labels; two truncated images."""
    rng = np.random.RandomState(11)
    for sub in ("images", "labels"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    files = []
    for i, (fmt, kw) in enumerate([
            ("WEBP", dict(lossless=True)), ("WEBP", dict(quality=70)),
            ("TIFF", dict(compression="tiff_lzw")), ("TIFF", dict()),
            ("PPM", dict()), ("TGA", dict(compression="tga_rle")),
            ("QOI", dict()), ("WEBP", dict(quality=50)),
            ("TIFF", dict(compression="jpeg")), ("PPM", dict())]):
        a = _image(rng, 24, 24, i % 2)
        data = _save(Image.fromarray(a), fmt, **kw)
        if i >= 8:
            data = data[:len(data) // 2]
        files.append(data)
    for i, data in enumerate(files):
        ext = "png" if i % 2 else "jpg"
        stem = f"24#2#10.0#43#{i}#3512"
        with open(os.path.join(root, "images", f"{stem}.{ext}"), "wb") as f:
            f.write(data)
        with open(os.path.join(root, "labels", f"{stem}.{ext}"), "wb") as f:
            f.write(timage.encode_png(rng.randint(0, 4, (24, 24)).astype(
                np.uint8)))
    return root, len(files)


@pytest.mark.parametrize("kw", [{"store_as_array": True},
                                {"convert_png_to_jpg": True}])
def test_mt_engine_writes_the_jax_records(tmp_path, capsys, kw):
    """Decode mode (``store_as_array``) and the PNG-to-JPEG transcode of
    raw mode: the JAX engine's record sets shard by shard, and its skip
    lines."""
    from dl_image_segmentation_tpu_torch.records import tfrecord
    chips, n = _chip_folder(str(tmp_path / "chips"))
    outs, written, lines = [], [], []
    for writer in (twriters, jwriters):
        out = str(tmp_path / f"out-{writer.__name__}")
        written.append(writer.process_dataset_multithreaded(
            "p", chips, out, 2, num_threads=2, **kw))
        lines.append(sorted(line for line in capsys.readouterr().out
                            .splitlines() if line.startswith("WARNING")))
        outs.append(out)
    assert written[0] == written[1] > 0
    assert lines[0] == lines[1] and lines[0], lines
    shards = [sorted(glob.glob(os.path.join(o, "p-*"))) for o in outs]
    assert len(shards[0]) == len(shards[1]) == 2
    for a, b in zip(*shards):
        # the JAX package's native shard writer reorders the pairs it
        # leaves to Python: the same records, shard by shard
        assert sorted(tfrecord.read_records(a, verify_crc=True)) == \
            sorted(tfrecord.read_records(b))
