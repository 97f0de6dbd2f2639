"""The port's progressive, arithmetic-coded, lossless and CMYK/YCCK JPEG,
RLE BMP and subsampled / sYCC JPEG 2000 decoding against the JAX package
(PIL: libjpeg-turbo 3, PIL's own RLE decoder, OpenJPEG 2.5), on the CPU.

* Every committed fixture (``tests/data/{jpeg,bmp,jp2}``, written by
  ``tests/data/make_codec_fixtures.py``) decodes in the port to its
  ``.npz`` (the JAX package's decode), or raises the class and message
  prefix the JAX package raises; one progressive file that libjpeg-turbo
  block-smooths is refused, naming ROADMAP item 6.
* Seeded PIL-written progressive and CMYK JPEGs (qualities, subsampling,
  grey and RGB, optimized tables, odd sizes), seeded lossless JPEGs
  (predictors 1-7, point transforms, restarts, subsampling, markers),
  RLE8/RLE4 streams (runs, deltas, EOL, early EOF, odd widths) and
  subsampled / sYCC JPEG 2000 (tiles, odd extents, raw codestreams)
  decode bitwise as in the JAX package; truncations give its class and
  prefix; the sniffer reports what the decode returns.
* A seeded mutation sweep over the JPEG fixtures raises only the clean
  exceptions, in a child process, so that a crash of the C++ decoder
  fails the test instead of taking the worker down.
* 4-band JPEGs at the call sites (MT writer, rgbraw parser, ``convert``,
  the server) and a GeoPackage of progressive JPEG tiles give the JAX
  package's outcome.

Nothing here compiles XLA.
"""

import glob
import importlib.util
import io
import multiprocessing
import os
import queue
import sqlite3
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from dl_image_segmentation_tpu.raster import image as jimage
from dl_image_segmentation_tpu.records import writers as jwriters
from dl_image_segmentation_tpu_torch.raster import gpkg_raster as tgpkg
from dl_image_segmentation_tpu_torch.raster import image as timage
from dl_image_segmentation_tpu_torch.raster import jp2 as tjp2
from dl_image_segmentation_tpu_torch.records import writers as twriters

# one intra-op thread: the test workers share the host's cores
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
CLEAN = (timage.CorruptRasterError, timage.UnsupportedFormatError)


def _generator():
    spec = importlib.util.spec_from_file_location(
        "make_codec_fixtures", os.path.join(DATA, "make_codec_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


gen = _generator()


def outcome(mod, data):
    """(array) or (class name, message up to the ';')."""
    try:
        return mod.decode_image_bytes(data).array
    except Exception as e:  # noqa: BLE001 -- the outcome is compared
        return type(e).__name__, str(e).split(";")[0]


def assert_same_outcome(data, what=""):
    got, want = outcome(timage, data), outcome(jimage, data)
    if isinstance(want, tuple) or isinstance(got, tuple):
        assert got == want, what
        return got
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (what, got.dtype, got.shape, want.dtype, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)
    info = timage.sniff_image_info(data)
    assert (info.height, info.width, info.count, info.dtype) == \
        got.shape + (got.dtype.name,), what
    return got


# ------------------------------------------------------------ fixtures

FIXTURES = sorted(p for sub in ("jpeg", "bmp", "jp2")
                  for p in glob.glob(os.path.join(DATA, sub, "*"))
                  if not p.endswith((".npz", ".c")))
# libjpeg-turbo smooths its blocks; the port refuses it (ROADMAP item 6)
SMOOTHED = {"smoothing.jpg"}


@pytest.mark.parametrize("path", FIXTURES,
                         ids=[os.path.basename(p) for p in FIXTURES])
def test_committed_fixture_decodes_to_its_npz(path):
    with open(path, "rb") as f:
        data = f.read()
    ref = np.load(path.rsplit(".", 1)[0] + ".npz")
    got = outcome(timage, data)
    name = os.path.basename(path)
    if name in SMOOTHED:
        assert "array" in ref.files
        assert got[0] == "UnsupportedFormatError" and "item 6" in got[1]
        assert "block smoothing" in got[1]
        return
    if "array" in ref.files:
        want = ref["array"]
        assert not isinstance(got, tuple), got
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == (str(ref["error_class"]), str(ref["error_prefix"]))
    # the committed outcome is still the JAX package's
    live = outcome(jimage, data)
    if isinstance(live, tuple):
        assert live == (str(ref["error_class"]), str(ref["error_prefix"]))
    else:
        np.testing.assert_array_equal(live, ref["array"])


def test_every_variant_has_a_fixture():
    names = {os.path.basename(p).rsplit(".", 1)[0] for p in FIXTURES}
    assert {"progressive", "arith", "arith-progressive", "lossless", "cmyk",
            "ycck", "12bit", "lossless-16bit", "hierarchical", "2comp",
            "dnl", "rle8", "rle4-odd-width", "sycc-420",
            "codestream-422"} <= names
    total = sum(os.path.getsize(p) for sub in ("jpeg", "bmp", "jp2")
                for p in glob.glob(os.path.join(DATA, sub, "*")))
    assert total < 1 << 20


def test_remaining_refusals_are_the_jax_packages():
    """12-bit, 16-bit lossless, 6-bit lossless, hierarchical, arithmetic
    lossless, 2-component and DNL files: CorruptRasterError with the JAX
    package's prefix, from the decode and from the sniffer."""
    for name in ("12bit", "lossless-16bit", "lossless-6bit", "hierarchical",
                 "arith-lossless", "2comp", "dnl"):
        with open(os.path.join(DATA, "jpeg", f"{name}.jpg"), "rb") as f:
            data = f.read()
        got = outcome(timage, data)
        assert got == ("CorruptRasterError",
                       "corrupt or unreadable image container"), name
        assert got == outcome(jimage, data), name
        if name != "dnl":
            with pytest.raises(timage.CorruptRasterError):
                timage.sniff_image_info(data)


# ------------------------------------------------------ seeded JPEG cases

SIZES = [(1, 1), (7, 13), (33, 20), (257, 3)]


def pil_jpeg(a, **kw):
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, format="JPEG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("h,w", SIZES)
def test_progressive_pil_cases(h, w):
    rng = np.random.RandomState(h * 1000 + w)
    rgb = gen.chip(h * 7 + w, h, w)
    grey = rgb[:, :, 0].copy()
    for q in (50, 90, 100):
        for opt in (False, True):
            for sub in (0, 1, 2):
                assert_same_outcome(pil_jpeg(rgb, quality=q, progressive=True,
                                             optimize=opt, subsampling=sub),
                                    f"{q} {opt} {sub}")
            assert_same_outcome(pil_jpeg(grey, quality=q, progressive=True,
                                         optimize=opt), f"grey {q} {opt}")
    noise = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    assert_same_outcome(pil_jpeg(noise, quality=95, progressive=True))
    cmyk = io.BytesIO()
    Image.fromarray(rgb).convert("CMYK").save(cmyk, format="JPEG",
                                               quality=90)
    got = assert_same_outcome(cmyk.getvalue(), "CMYK")
    assert got.shape == (h, w, 4)


@pytest.mark.parametrize("samp", [((1, 1),) * 3, ((2, 2), (1, 1), (1, 1)),
                                  ((2, 1), (1, 1), (1, 1)),
                                  ((1, 2), (1, 1), (1, 1)),
                                  ((2, 2), (1, 2), (2, 1)), ((1, 1),)])
def test_lossless_seeded_cases(samp):
    rng = np.random.RandomState(len(samp) * 10 + samp[0][0])
    hmax = max(h for h, _ in samp)
    vmax = max(v for _, v in samp)
    for (H, W) in ((8, 8), (7, 13), (17, 6)):
        planes = [rng.randint(0, 256, (-(-H * v // vmax),
                                       -(-W * h // hmax))).astype(np.uint8)
                  for h, v in samp]
        for psv, pt, rows, marker, inter in (
                (1, 0, 0, "adobe0", True), (2, 0, 0, "none", True),
                (3, 1, 1, "adobe0", True), (4, 1, 2, "none", False),
                (5, 2, 1, "none", False), (6, 0, 3, "adobe0", True),
                (7, 3, 0, "none", True), (1, 0, 0, "jfif", True),
                (7, 0, 0, "adobe1", False)):
            if len(samp) == 1 and not inter:
                continue
            assert_same_outcome(gen.lossless_jpeg(
                planes, samp, W, H, psv, pt, rows, marker, inter),
                f"{H}x{W} psv {psv} pt {pt} rows {rows} {marker} {inter}")


def _with_com(data, n):
    """The file with an n-byte COM segment after its SOI."""
    return data[:2] + b"\xff\xfe" + struct.pack(">H", n + 2) + bytes(n) + \
        data[2:]


def test_arithmetic_scans_past_pils_64k_blocks():
    """PIL hands libjpeg 64 KiB at a time and the arithmetic decoder
    cannot suspend: a scan that reads past a block fails there, one that
    reaches a block's end only in marker segments does not. The committed
    arithmetic files shifted by COM segments of every size class."""
    n = 0
    for name in ("arith", "arith-progressive", "arith-restart-dac"):
        with open(os.path.join(DATA, "jpeg", f"{name}.jpg"), "rb") as f:
            data = f.read()
        for pad in (0, 40000, 60000, 64000, 65000, 65200, 65400, 65500,
                    65530):
            got = assert_same_outcome(_with_com(data, pad), f"{name} {pad}")
            n += isinstance(got, tuple)
    assert n > 0  # some of them PIL refuses


def test_missing_eoi_and_trailing_bytes():
    """Single-scan files decode without their EOI only where libjpeg's
    read-ahead (57 bits) stays inside the data: a cut just before the EOI
    fails in PIL and in the port, trailing bytes past the scan do not."""
    a = gen.chip(30, 24, 40)
    for data in (pil_jpeg(a, quality=85), pil_jpeg(a[:, :, 0]),
                 gen.lossless_jpeg([a[:, :, 0]], ((1, 1),), 40, 24)):
        for cut in (1, 2, 3, 5, 9):
            assert_same_outcome(data[:-cut], f"cut {cut}")
        for junk in (b"\x00", bytes(3), bytes(8), bytes(20), b"\xff"):
            assert_same_outcome(data[:-2] + junk, f"junk {junk!r}")


def _truncations(data, rng, k=12):
    cuts = {len(data) - 1, len(data) - 2, len(data) - 3, len(data) // 2}
    cuts.update(int(c) for c in rng.randint(1, len(data), k))
    return sorted(cuts)


@pytest.mark.parametrize("sub", ["jpeg", "bmp", "jp2"])
def test_truncations_give_the_jax_outcome(sub):
    for path in FIXTURES:
        if f"/{sub}/" not in path or os.path.basename(path) in SMOOTHED:
            continue
        with open(path, "rb") as f:
            data = f.read()
        rng = np.random.RandomState(zlib.crc32(path.encode()))
        for cut in _truncations(data, rng):
            assert_same_outcome(data[:cut], f"{path} cut at {cut}")


# ------------------------------------------------------------ RLE BMP

def rle_stream(rng, w, h, rle4, end):
    out = bytearray()
    for _ in range(h):
        x = 0
        while x < w:
            k = rng.randint(6)
            if k <= 2:
                n = (rng.randint(1, 2 * w + 2) if rng.rand() < .1
                     else rng.randint(1, 9))
                out += bytes([n, rng.randint(256)])
                x += n
            elif k == 3:
                n = rng.randint(3, 12)
                out += bytes([0, n]) + bytes(
                    rng.randint(0, 256, (n + 1) // 2 if rle4 else n)
                    .tolist())
                if len(out) % 2:
                    out += b"\0"
                x += n
            elif k == 4 and rng.rand() < .3:
                out += bytes([0, 2] + rng.randint(0, 4, 4).tolist())
                x += 3
            else:
                break
        out += b"\0\0"
    if end == "eof":
        out += b"\0\1"
    elif end == "cut":
        out = out[:rng.randint(len(out))]
    return bytes(out)


@pytest.mark.parametrize("seed", range(4))
def test_rle_bmp_seeded_streams(seed):
    """Seeded RLE8/RLE4 streams (odd widths, runs past the row, absolute
    runs, deltas, EOL, early EOF), grey-ramp, grey and colour palettes,
    bottom-up and top-down, RLE on 1- and 24-bit files: the JAX
    package's array, or its class and prefix."""
    rng = np.random.RandomState(seed)
    decoded = 0
    for trial in range(60):
        w, h = rng.randint(1, 23), rng.randint(1, 9)
        bits = [8, 4, 8, 4, 1, 24][trial % 6]
        comp = 2 if (bits == 4) ^ (trial % 17 == 0) else 1
        n = 1 << min(bits, 8)
        kind = rng.randint(3)
        if kind == 0:
            pal = rng.randint(0, 256, (n, 3))
        elif kind == 1:
            ramp = np.arange(n) if n > 2 else np.array([0, 255])
            pal = np.repeat(ramp[:, None], 3, 1)
        else:
            pal = np.repeat(rng.randint(0, 256, n)[:, None], 3, 1)
        stream = rle_stream(rng, w, h, comp == 2,
                            ["eof", "eof", "none", "cut"][rng.randint(4)])
        data = gen.rle_bmp(np.zeros((h, w), np.uint8), pal.astype(np.uint8),
                           comp == 2, stream)
        hdr = bytearray(data)
        hdr[28:30] = struct.pack("<H", bits)
        if rng.rand() < .2:  # top-down
            hdr[22:26] = struct.pack("<I", 2 ** 32 - h)
        got = assert_same_outcome(bytes(hdr), f"trial {trial}")
        decoded += not isinstance(got, tuple)
    assert decoded >= 10


# ------------------------------------------------------------ JPEG 2000

@pytest.fixture(scope="module")
def opj(tmp_path_factory):
    return gen.OpenJpeg(str(tmp_path_factory.mktemp("opj")))


@pytest.mark.parametrize("subs", [((1, 1), (2, 2), (2, 2)),
                                  ((1, 1), (2, 1), (2, 1)),
                                  ((1, 1), (1, 2), (1, 2)),
                                  ((1, 1), (3, 3), (3, 3)),
                                  ((2, 2), (1, 1), (1, 1)),
                                  ((1, 1), (1, 1), (2, 2)),
                                  ((1, 1), (2, 2), (2, 2), (1, 1)),
                                  ((1, 1), (1, 1), (1, 1), (2, 2)),
                                  ((1, 1),) * 3, ((2, 1),),
                                  ((1, 1), (2, 2))])
def test_jp2_subsampled_and_sycc(opj, subs):
    """Each layout as a raw codestream (PIL calls it sYCC when its first
    subsampled component is the second or third) and in JP2 files
    tagged sRGB, grey or sYCC, single-tiled at odd sizes and tiled
    (tile edges off the subsampling grid, where PIL reads zeros past a
    tile's data)."""
    rng = np.random.RandomState(len(subs) * 100 + subs[0][0] * 10
                                + subs[-1][1])
    nc = len(subs)
    for H, W, tile in ((16, 16, None), (15, 17, None), (1, 1, None),
                       (33, 20, None), (15, 17, (6, 10)),
                       (29, 31, (7, 9))):
        planes = [rng.randint(0, 256, (-(-H // dy), -(-W // dx))).astype(
            np.uint8) for dx, dy in subs]
        for jp2, space in ((False, 0), (True, 1), (True, 2), (True, 3)):
            if (space == 2) != (nc <= 2) and space:
                continue
            if tile and max(max(s) for s in subs) > 2 and \
                    min(tile) % 3:
                continue  # OpenJPEG's encoder fails on these
            data = opj(planes, subs, H, W, space, jp2=jp2, tile=tile)
            assert_same_outcome(data, f"{H}x{W} {tile} {jp2} {space}")


def test_ycbcr_tables_are_pils():
    """PIL's ImagingConvertYCbCr2RGB (through convert('RGB') of a YCbCr
    image) over a lattice of every fifth Y, Cb and Cr."""
    v = np.arange(0, 256, 5, dtype=np.uint8)
    y, cb, cr = np.meshgrid(v, v, v, indexing="ij")
    ycc = np.stack([y, cb, cr], -1).reshape(len(v), -1, 3)
    want = np.asarray(Image.fromarray(ycc, "YCbCr").convert("RGB"))
    np.testing.assert_array_equal(tjp2._ycbcr_to_rgb(ycc), want)


# ------------------------------------------------------------ mutations

MUTATED = ("progressive", "arith", "arith-progressive", "lossless",
           "progressive-restart", "arith-restart-dac",
           "lossless-420-psv7-restart", "lossless-psv5-scans", "cmyk",
           "ycck", "custom-script", "progressive-optimized-7x13")


def _mutate_and_decode(queue):
    from dl_image_segmentation_tpu_torch.raster import image as img
    from dl_image_segmentation_tpu_torch.raster.jpeg import JPEGError
    clean = (img.CorruptRasterError, img.UnsupportedFormatError, JPEGError)
    n = 0
    try:
        for name in MUTATED:
            with open(os.path.join(DATA, "jpeg", f"{name}.jpg"), "rb") as f:
                data = f.read()
            rng = np.random.RandomState(zlib.crc32(name.encode()))
            sample = data if len(data) < 20000 else data[:20000]
            muts = [sample[:int(k)] for k in rng.randint(2, len(sample), 40)]
            for _ in range(200):
                b = bytearray(sample)
                for pos in rng.randint(2, len(b), rng.randint(1, 4)):
                    b[pos] = (b[pos] ^ (1 << rng.randint(8))
                              if rng.rand() < .7 else rng.randint(256))
                muts.append(bytes(b))
            for m in muts:
                try:
                    img.decode_image_bytes(m)
                    img.sniff_image_info(m)
                except clean:
                    pass
                n += 1
    except Exception as e:  # noqa: BLE001 -- reported to the parent
        queue.put(f"{type(e).__name__}: {e}")
        return
    queue.put(n)


def test_mutations_raise_only_clean_exceptions():
    """About 3000 seeded byte flips, replacements and truncations of the
    new JPEG fixtures: each decodes or raises JPEGError /
    CorruptRasterError / UnsupportedFormatError. The sweep runs in a
    child process: a crash of the decoder fails this test (exit code)
    instead of taking the test worker down."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    p = ctx.Process(target=_mutate_and_decode, args=(results,))
    p.start()
    try:
        result = results.get(timeout=180)
    except queue.Empty:
        result = None
    p.join(timeout=30)
    if p.is_alive():
        p.kill()
        p.join(timeout=30)
    assert p.exitcode == 0, f"the decoder crashed (exit code {p.exitcode})"
    assert result == len(MUTATED) * 240, result


# ------------------------------------------------------------ call sites

def _fixture(sub, name):
    with open(os.path.join(DATA, sub, name), "rb") as f:
        return f.read()


def _variant_folder(root):
    """Chip pairs of every decodable RGB variant (and a CMYK JPEG) with
    PNG labels, named like DLTile keys."""
    files = [("jpeg", "progressive.jpg"), ("jpeg", "arith.jpg"),
             ("jpeg", "arith-progressive.jpg"), ("jpeg", "lossless.jpg"),
             ("bmp", "rle8.bmp"), ("jp2", "sycc-420.jp2"),
             ("jpeg", "cmyk.jpg")]
    for sub in ("images", "labels"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    rng = np.random.RandomState(3)
    for i, (sub, name) in enumerate(files):
        data = _fixture(sub, name)
        h, w = timage.sniff_image_info(data).height, \
            timage.sniff_image_info(data).width
        stem = f"{h}#2#10.0#43#{i}#3512"
        with open(os.path.join(root, "images", f"{stem}.jpg"), "wb") as f:
            f.write(data)
        with open(os.path.join(root, "labels", f"{stem}.jpg"), "wb") as f:
            f.write(timage.encode_png(rng.randint(0, 4, (h, w)).astype(
                np.uint8)))
    return root, len(files)


@pytest.mark.parametrize("kw", [{}, {"store_as_array": True}])
def test_mt_writer_and_rgbraw_parser(tmp_path, capsys, kw):
    """The MT engine over the variants: the JAX engine's shards, and the
    CMYK JPEG skipped for the JAX package's reason (AssertionError); the
    rgbraw parser's arrays equal the JAX parser's."""
    from dl_image_segmentation_tpu.pipeline import input as jinput
    from dl_image_segmentation_tpu_torch.pipeline import input as tinput
    from dl_image_segmentation_tpu_torch.records import tfrecord
    chips, n = _variant_folder(str(tmp_path / "chips"))
    outs = []
    for writer in (twriters, jwriters):
        out = str(tmp_path / f"out-{writer.__name__}")
        assert writer.process_dataset_multithreaded(
            "v", chips, out, 2, num_threads=2, **kw) == n - 1
        assert "WARNING: 1 file(s) skipped: AssertionError" in \
            capsys.readouterr().out
        outs.append(out)
    shards = [sorted(glob.glob(os.path.join(o, "v-*"))) for o in outs]
    assert len(shards[0]) == len(shards[1]) == 2
    for a, b in zip(*shards):
        if kw:
            assert open(a, "rb").read() == open(b, "rb").read()
        else:
            # the JAX package's native shard writer puts the pairs that
            # it leaves to Python (BMP, JPEG 2000, ...) at the end of the
            # shard: the same records, in another order
            assert sorted(tfrecord.read_records(a)) == \
                sorted(tfrecord.read_records(b))
    if kw:
        return
    for path in shards[0]:
        for rec in tfrecord.read_records(path, verify_crc=True):
            got = tinput.PARSE_FNS["rgbraw"](rec)
            want = jinput.PARSE_FNS["rgbraw"](rec)
            for g, r in zip(got[:2], want[:2]):
                assert g.dtype == r.dtype
                np.testing.assert_array_equal(g, r)
    # a record holding the CMYK file parses to 4 bands in both
    from dl_image_segmentation_tpu_torch.records import proto
    cmyk = _fixture("jpeg", "cmyk.jpg")
    b, i = proto.encode_bytes_list_feature, proto.encode_int64_list_feature
    rec = proto.encode_example({
        "image/image_data": b([cmyk]), "image/height": i([64]),
        "image/width": i([64]), "image/channels": i([4]),
        "target/target_data": b([timage.encode_png(np.zeros((64, 64),
                                                            np.uint8))]),
        "target/height": i([64]), "target/width": i([64]),
        "identifier": b([b"k"])})
    got = tinput.PARSE_FNS["rgbraw"](rec)[0]
    want = jinput.PARSE_FNS["rgbraw"](rec)[0]
    assert got.shape == (64, 64, 4)
    np.testing.assert_array_equal(got, want)


def test_convert_and_decode_jpeg(tmp_path):
    """``convert`` of a variant chip folder to PNG: the JAX package's
    files, the CMYK JPEG refused as an UnsupportedFormatError in both;
    ``decode_jpeg`` of a 4-band file fails with an AssertionError in
    both, as the JAX package's assert does."""
    from dl_image_segmentation_tpu.pipeline import convert as jconvert
    from dl_image_segmentation_tpu_torch.pipeline import convert as tconvert
    chips, n = _variant_folder(str(tmp_path / "chips"))
    outs = []
    for mod in (tconvert, jconvert):
        out = str(tmp_path / f"png-{mod.__name__}")
        with pytest.raises(Exception) as e:
            mod.convert_chip_folder(chips, out, file_ext="jpg", to="png",
                                    num_workers=1)
        assert type(e.value).__name__ == "UnsupportedFormatError"
        outs.append(out)
    cmyk = _fixture("jpeg", "cmyk.jpg")
    for fn in (timage.decode_jpeg, timage.decode_png):
        with pytest.raises(AssertionError):
            fn(cmyk)
    with pytest.raises(AssertionError):
        jimage.decode_jpeg(cmyk)
    progressive = _fixture("jpeg", "progressive.jpg")
    np.testing.assert_array_equal(timage.decode_jpeg(progressive),
                                  jimage.decode_jpeg(progressive))


def test_server_answers_variant_bodies():
    """Every decodable variant as a request body: the class map of
    ``predict`` of the JAX package's decode (a 3-band 128 px model); the
    CMYK JPEG gets the JAX server's 400."""
    from dl_image_segmentation_tpu_torch.serve import (
        PredictServer, make_http_server, scale_image)
    from dl_image_segmentation_tpu_torch.train import TrainConfig, Trainer
    import threading
    import urllib.error
    import urllib.request
    trainer = Trainer(TrainConfig(num_classes=3, batch_size=2,
                                  image_size=128, base_features=4, levels=2,
                                  precision="fp32"), device="cpu")
    ps = PredictServer(trainer)
    httpd = make_http_server("127.0.0.1", 0, ps)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}/predict"
    try:
        for sub, name in (("jpeg", "progressive.jpg"), ("jpeg", "arith.jpg"),
                          ("jpeg", "arith-progressive.jpg"),
                          ("jpeg", "lossless.jpg"), ("bmp", "rle8.bmp"),
                          ("jp2", "sycc-420.jp2")):
            body = _fixture(sub, name)
            req = urllib.request.Request(base, data=body, method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                got = np.load(io.BytesIO(r.read()))
            pix = jimage.decode_image_bytes(body).array
            want = trainer.predict(scale_image(pix, "auto")[None])[0]
            np.testing.assert_array_equal(got, want, err_msg=name)
        req = urllib.request.Request(base, data=_fixture("jpeg", "cmyk.jpg"),
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=60)
        assert e.value.code == 400
        assert b"expected 3-band raster" in e.value.read()
    finally:
        httpd.shutdown()
        thread.join(timeout=30)
        ps.close()


def test_gpkg_with_progressive_jpeg_tiles():
    """A GeoPackage whose tiles are progressive and arithmetic JPEGs:
    decoded and sniffed as the JAX package does."""
    a = gen.chip(40, 32, 48)
    data = tgpkg.encode_gpkg(a, tile_size=16,
                             geotransform=(0.0, 1.0, 0.0, 0.0, 0.0, -1.0),
                             epsg=32643)
    conn = sqlite3.connect(":memory:")
    conn.deserialize(data)
    rows = conn.execute("SELECT id, tile_column, tile_row FROM imagery"
                        ).fetchall()
    for tid, col, row in rows:
        tile = np.ascontiguousarray(a[row * 16:row * 16 + 16,
                                      col * 16:col * 16 + 16])
        conn.execute("UPDATE imagery SET tile_data = ? WHERE id = ?",
                     (pil_jpeg(tile, quality=90, progressive=True), tid))
    conn.commit()
    data = conn.serialize()
    got = assert_same_outcome(bytes(data), "gpkg")
    assert got.shape == (32, 48, 3)
    t, j = timage.sniff_image_info(bytes(data)), \
        jimage.sniff_image_info(bytes(data))
    assert (t.width, t.height, t.count, t.epsg) == \
        (j.width, j.height, j.count, j.epsg)


def test_sniff_refuses_what_the_decode_refuses():
    """Where PIL refuses a JPEG at open (precision, components,
    hierarchical and arithmetic lossless frames, an empty frame), the
    JAX sniffer still reports the SOF's shape; the port's sniffer reads
    the decoder's headers and raises with the decode (ROADMAP queue 3).
    Files that fail only in their data (the 64 KiB arithmetic limit,
    block smoothing, colour conversion of a lossless frame) sniff in
    both."""
    for name in ("12bit", "lossless-16bit", "lossless-6bit", "hierarchical",
                 "arith-lossless", "2comp", "dnl"):
        data = _fixture("jpeg", f"{name}.jpg")
        ref = jimage.sniff_image_info(data)
        assert ref.count >= 1, name
        with pytest.raises(timage.CorruptRasterError):
            timage.sniff_image_info(data)
    for name in ("arith-past-64k", "smoothing", "lossless-jfif"):
        data = _fixture("jpeg", f"{name}.jpg")
        t, j = timage.sniff_image_info(data), jimage.sniff_image_info(data)
        assert (t.height, t.width, t.count) == (j.height, j.width, j.count)
        with pytest.raises(CLEAN):
            timage.decode_image_bytes(data)


def test_htj2k_names_item_6():
    """A codestream whose code-block style sets the HT bit (0x40) is
    refused naming ROADMAP item 6 (no HT encoder here writes a real
    one)."""
    data = bytearray(tjp2.encode_jp2(gen.chip(41, 16, 16)))
    cod = data.index(b"\xff\x52")
    data[cod + 12] |= 0x40
    with pytest.raises(timage.UnsupportedFormatError, match="item 6") as e:
        timage.decode_image_bytes(bytes(data))
    assert "HTJ2K" in str(e.value)
