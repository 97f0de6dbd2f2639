"""The PyTorch port's image codecs against the JAX package, on the CPU.

The JAX package decodes PNG, JPEG, GIF and BMP through PIL (libjpeg-turbo
for JPEG) and encodes PNG and JPEG through PIL; the port carries its own
codecs (``raster/png.py``, ``jpeg.py``, ``gif.py``, ``bmp.py``). The same
seeded bytes go through ``decode_image_bytes`` of both packages:

* PNG: every colour type and bit depth PIL reads, both interlace modes,
  all five filters, IDAT split at any byte; arrays equal, PIL's mode
  mapping included;
* JPEG: bitwise equal decodes (1 and 3 components, 4:4:4 / 4:2:2 /
  4:2:0 and PIL's "4:1:1", odd sizes, restart intervals, qualities
  1-100), and the encoder byte for byte PIL's ``save(quality=q)``;
* GIF and BMP: arrays equal; each sniffer against the JAX sniffer, with
  the JAX sniffer's faults pinned as intended differences;
* seeded truncations and bit flips (PNG, JPEG, GIF, BMP and JPEG 2000)
  either decode to the header's shape or raise a clean exception within
  a deadline.
"""

import io
import os
import signal
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from dl_image_segmentation_tpu.raster import image as jimage
from dl_image_segmentation_tpu_torch.raster import image as timage
from dl_image_segmentation_tpu_torch.raster.jp2 import _enc as _jp2_encoder
from dl_image_segmentation_tpu_torch.raster.jp2 import encode_jp2
from dl_image_segmentation_tpu_torch.raster.jpeg import JPEGUnsupported
from dl_image_segmentation_tpu_torch.raster.png import MAX_PIXELS

# one intra-op thread: the test workers share the host's cores
torch.set_num_threads(1)

_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def _pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, c) sample values -> (h, stride) bytes of PNG rows."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1).astype(np.uint32)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    per = 8 // depth
    pad = (-flat.shape[1]) % per
    flat = np.pad(flat, ((0, 0), (0, pad))).reshape(h, -1, per)
    shifts = np.array([8 - depth * (k + 1) for k in range(per)])
    return (flat << shifts).sum(axis=2).astype(np.uint8)


def _filter_rows(rows: np.ndarray, bpp: int, rng) -> bytes:
    """Each row filtered with a random one of the five filter types."""
    x = rows.astype(np.int32)
    out = []
    prev = np.zeros(x.shape[1], np.int32)
    for r in x:
        a = np.concatenate([np.zeros(bpp, np.int32), r[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        p = a + prev - c
        pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, prev, c))
        ft = rng.randint(5)
        pred = [0, a, prev, (a + prev) >> 1, paeth][ft]
        out.append(bytes([ft]) + ((r - pred) & 0xFF).astype(np.uint8)
                   .tobytes())
        prev = r
    return b"".join(out)


def make_png(samples, depth, ct, rng, palette=None, interlace=0,
             split=None, trns=None) -> bytes:
    """A PNG of raw sample values, written here so that every colour
    type, depth, filter and interlace PIL reads is covered; ``split``
    cuts the zlib stream into IDATs of that many bytes."""
    h, w, c = samples.shape
    bits = depth * c
    bpp = max(1, bits // 8)
    if interlace:
        raw = b"".join(_filter_rows(_pack_rows(samples[y0::dy, x0::dx],
                                               depth), bpp, rng)
                       for x0, y0, dx, dy in _ADAM7
                       if samples[y0::dy, x0::dx].size)
    else:
        raw = _filter_rows(_pack_rows(samples, depth), bpp, rng)
    z = zlib.compress(raw, 9)
    step = split or len(z)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ct, 0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", palette)
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    out += b"".join(_chunk(b"IDAT", z[i:i + step])
                    for i in range(0, len(z), step))
    return out + _chunk(b"IEND", b"")


def assert_same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (got.dtype, got.shape, want.dtype, want.shape)
    np.testing.assert_array_equal(got, want)


def both_decode(data: bytes):
    return (timage.decode_image_bytes(data).array,
            jimage.decode_image_bytes(data).array)


# ---------------------------------------------------------------- PNG

PNG_KINDS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16),
             (3, 1), (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("ct,depth", PNG_KINDS,
                         ids=[f"ct{c}-{d}bit" for c, d in PNG_KINDS])
def test_png_decode_equals_jax(ct, depth, interlace):
    rng = np.random.RandomState(ct * 100 + depth * 2 + interlace)
    for shape in ((1, 1), (3, 10), (13, 9), (33, 17)):
        s = rng.randint(0, 1 << depth, shape + (_CHANNELS[ct],))
        pal = None
        if ct == 3:  # a palette shorter than the index range, now and then
            n = (1 << depth) - rng.randint(0, 2)
            pal = rng.randint(0, 256, 3 * n).astype(np.uint8).tobytes()
        data = make_png(s, depth, ct, rng, pal, interlace,
                        split=rng.choice([None, 1, 7, 100]))
        got, want = both_decode(data)
        assert_same(got, want)
        # the port's sniff reports what its decode returns
        info = timage.sniff_image_info(data)
        assert (info.height, info.width, info.count, info.dtype) == \
            got.shape + (got.dtype.name,)


def test_png_trns_and_ancillary_chunks_do_not_change_pixels():
    rng = np.random.RandomState(3)
    cases = [(0, 8, b"\x00\x05"), (2, 8, b"\x00\x05" * 3), (0, 1, b"\x00\x01"),
             (3, 4, b"\x00\x80\xff")]
    for ct, depth, trns in cases:
        s = rng.randint(0, 1 << depth, (6, 5, _CHANNELS[ct]))
        pal = (rng.randint(0, 256, 3 << depth).astype(np.uint8).tobytes()
               if ct == 3 else None)
        data = make_png(s, depth, ct, rng, pal, trns=trns)
        # an ancillary chunk after the image data is skipped unchecked
        data = data[:-12] + _chunk(b"tEXt", b"k\x00v") + data[-12:]
        assert_same(*both_decode(data))


@pytest.mark.parametrize("shape,dtype", [
    ((37, 41, 3), np.uint8), ((5, 6), np.uint8), ((9, 8, 1), np.uint16),
    ((7, 7, 2), np.uint8), ((1, 300, 3), np.uint8), ((64, 64, 1), np.uint8)])
def test_png_encode_decodes_to_input_in_pil(shape, dtype):
    rng = np.random.RandomState(len(shape) + shape[0])
    hi = 65536 if dtype == np.uint16 else 256
    a = rng.randint(0, hi, shape).astype(dtype)
    a[: shape[0] // 2] //= 7  # smooth rows, so that every filter is chosen
    data = timage.encode_png(a)
    back = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(back.reshape(a.shape), a)
    assert back.dtype == a.dtype
    assert_same(timage.decode_png(data), jimage.decode_png(data))


def test_png_encode_rejects_what_it_cannot_hold():
    for a in (np.zeros((4, 4, 4), np.uint8), np.zeros((4, 4, 3), np.uint16),
              np.zeros((4, 4), np.float32)):
        with pytest.raises(ValueError):
            timage.encode_png(a)


def test_png_bomb_cap_and_corruption_raise():
    rng = np.random.RandomState(5)
    good = make_png(rng.randint(0, 256, (4, 4, 3)), 8, 2, rng)
    big = bytearray(good)
    big[16:24] = struct.pack(">II", 20000, 20000)  # 4e8 pixels
    big[29:33] = struct.pack(">I", zlib.crc32(bytes(big[12:29])))
    assert 20000 * 20000 > MAX_PIXELS
    with pytest.raises(timage.CorruptRasterError, match="decompression bomb"):
        timage.decode_image_bytes(bytes(big))
    bad_crc = bytearray(good)
    bad_crc[30] ^= 1
    with pytest.raises(timage.CorruptRasterError, match="checksum"):
        timage.decode_image_bytes(bytes(bad_crc))
    # a cut into the pixel data is truncated; one into the zlib stream's
    # Adler-32 after the last row still decodes, as PIL (the JAX
    # package's fallback) reads it
    with pytest.raises(timage.CorruptRasterError, match="truncated"):
        timage.decode_image_bytes(good[:-24])
    with pytest.raises(Exception, match="truncated"):
        jimage.decode_image_bytes(good[:-24])
    np.testing.assert_array_equal(
        timage.decode_image_bytes(good[:-20]).array,
        jimage.decode_image_bytes(good[:-20]).array)


# ---------------------------------------------------------------- JPEG

def pil_jpeg(a: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(a[:, :, 0] if a.shape[2] == 1 else a).save(
        buf, format="JPEG", **kw)
    return buf.getvalue()


def _image(rng, shape, c):
    """Seeded noise over a smooth gradient: both high and low
    frequencies reach the quantiser."""
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    base = (yy * 5 + xx * 3)[:, :, None] + np.arange(c) * 40
    return ((base + rng.randint(0, 60, shape + (c,))) % 256).astype(np.uint8)


JPEG_SHAPES = [(1, 1), (7, 5), (8, 8), (16, 16), (17, 23), (33, 9),
               (65, 47), (3, 100)]
QUALITIES = (1, 5, 10, 25, 50, 75, 85, 90, 95, 99, 100)


@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:2", "4:2:0", "4:1:1"])
@pytest.mark.parametrize("shape", JPEG_SHAPES, ids=str)
def test_jpeg_decode_bitwise_equals_jax_rgb(shape, subsampling):
    rng = np.random.RandomState(shape[0] * 7 + shape[1])
    a = _image(rng, shape, 3)
    for q in QUALITIES:
        data = pil_jpeg(a, quality=q, subsampling=subsampling)
        assert_same(*both_decode(data))


@pytest.mark.parametrize("shape", JPEG_SHAPES, ids=str)
def test_jpeg_decode_bitwise_equals_jax_grey(shape):
    rng = np.random.RandomState(shape[0] * 3 + shape[1])
    a = _image(rng, shape, 1)
    for q in QUALITIES:
        assert_same(*both_decode(pil_jpeg(a, quality=q)))


@pytest.mark.parametrize("restart", [
    dict(restart_marker_blocks=1), dict(restart_marker_blocks=5),
    dict(restart_marker_rows=1), dict(restart_marker_rows=2)], ids=str)
@pytest.mark.parametrize("c", [1, 3])
def test_jpeg_restart_intervals_decode_equal_jax(restart, c):
    rng = np.random.RandomState(11 + c)
    for shape in ((40, 50), (17, 33)):
        data = pil_jpeg(_image(rng, shape, c), quality=80, **restart)
        assert b"\xff\xdd" in data
        assert_same(*both_decode(data))


@pytest.mark.parametrize("factor", [0x411111, 0x121111, 0x221111, 0x211111])
def test_jpeg_other_sampling_factors_decode_equal_jax(factor):
    """True 4:1:1 (h4v1), 4:4:0 (h1v2) and the rest, written by
    OpenCV's libjpeg with restart markers and fill bytes as it likes."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(factor % 1000)
    for shape in ((1, 1), (2, 3), (17, 23), (65, 47), (3, 100)):
        a = _image(rng, shape, 3)
        for q, rst in ((30, 0), (95, 3)):
            ok, enc = cv2.imencode(".jpg", a, [
                cv2.IMWRITE_JPEG_QUALITY, q,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor,
                cv2.IMWRITE_JPEG_RST_INTERVAL, rst])
            assert ok
            assert_same(*both_decode(enc.tobytes()))


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("shape", JPEG_SHAPES + [(256, 256)], ids=str)
def test_jpeg_encode_bytes_equal_jax(shape, c):
    rng = np.random.RandomState(shape[0] + 17 * shape[1] + c)
    a = _image(rng, shape, c)
    qualities = (100, 90, 75) if shape == (256, 256) else QUALITIES
    for q in qualities:
        assert timage.encode_jpeg(a, q) == jimage.encode_jpeg(a, q)
        if c == 1:  # a 2-D array is the same grey image
            assert timage.encode_jpeg(a[:, :, 0], q) == \
                jimage.encode_jpeg(a[:, :, 0], q)


def test_jpeg_markers_in_pils_order():
    data = timage.encode_jpeg(np.zeros((16, 16, 3), np.uint8), 100)
    markers, i = [], 2
    while data[i + 1] != 0xDA:
        markers.append(data[i + 1])
        i += 2 + struct.unpack(">H", data[i + 2:i + 4])[0]
    assert markers == [0xE0, 0xDB, 0xDB, 0xC0, 0xC4, 0xC4, 0xC4, 0xC4]
    assert data[6:20] == b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
    # quality 100: every quantiser is 1; SOF0 says 4:2:0
    assert data[25:25 + 64] == b"\x01" * 64
    sof = data.index(b"\xff\xc0")
    assert data[sof + 10:sof + 19] == bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11,
                                             1])


def test_png_to_jpeg_equals_jax():
    rng = np.random.RandomState(9)
    png = timage.encode_png(_image(rng, (20, 30), 3))
    assert timage.png_to_jpeg(png) == jimage.png_to_jpeg(png)
    assert timage.png_to_jpeg(png, 60) == jimage.png_to_jpeg(png, 60)


def test_jpeg_variants_raise_item_6():
    """Named for the item-6 raise it pinned until the JPEG variants were
    ported: the frames PIL refuses (12-bit, 16-bit lossless, hierarchical,
    2 components) now raise the JAX package's CorruptRasterError with its
    prefix, and the progressive and CMYK files it refused decode as PIL
    does. ``test_torch_codec_variants.py`` holds the rest."""
    a = _image(np.random.RandomState(2), (24, 24), 3)
    progressive = pil_jpeg(a, quality=80, progressive=True)
    cmyk = io.BytesIO()
    Image.fromarray(a).convert("CMYK").save(cmyk, format="JPEG")
    for data in (progressive, cmyk.getvalue()):
        assert_same(*both_decode(data))
    data_dir = os.path.join(os.path.dirname(__file__), "data", "jpeg")
    for name in ("12bit", "lossless-16bit", "hierarchical", "2comp"):
        with open(os.path.join(data_dir, f"{name}.jpg"), "rb") as f:
            data = f.read()
        with pytest.raises(timage.CorruptRasterError) as got:
            timage.decode_image_bytes(data)
        with pytest.raises(jimage.CorruptRasterError) as want:
            jimage.decode_image_bytes(data)
        assert str(got.value).split(";")[0] == \
            str(want.value).split(";")[0] == \
            "corrupt or unreadable image container"
        assert "item 6" not in str(got.value)
    data = pil_jpeg(a, quality=80)
    with pytest.raises(timage.CorruptRasterError, match="truncated"):
        timage.decode_image_bytes(data[:len(data) // 2])


# ---------------------------------------------------------------- GIF, BMP

def pil_bytes(im: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, format=fmt, **kw)
    return buf.getvalue()


@pytest.mark.parametrize("ncolors", [2, 16, 200, 256])
@pytest.mark.parametrize("interlace", [0, 1])
def test_gif_decode_equals_jax(ncolors, interlace):
    rng = np.random.RandomState(ncolors + interlace)
    for shape in ((1, 1), (5, 7), (33, 20), (64, 64)):
        a = rng.randint(0, ncolors, shape).astype(np.uint8)
        im = Image.fromarray(a, "P")
        im.putpalette(list(rng.randint(0, 256, 3 * ncolors)))
        datas = [pil_bytes(im, "GIF", interlace=interlace),
                 pil_bytes(im, "GIF", interlace=interlace, transparency=1),
                 pil_bytes(Image.fromarray(a, "L"), "GIF")]  # grey ramp
        # a logical screen larger than the frame: the rest is the
        # transparent index, else 0
        for d in datas[:2]:
            big = bytearray(d)
            big[6:10] = struct.pack("<HH", shape[1] + 3, shape[0] + 2)
            datas.append(bytes(big))
        for d in datas:
            got, want = both_decode(d)
            assert_same(got, want)
            info = timage.sniff_image_info(d)
            assert (info.height, info.width, info.count) == got.shape
            ref = jimage.sniff_image_info(d)
            assert (ref.height, ref.width, ref.count) == got.shape


def make_bmp(idx_or_px, bits, palette=None, hsize=40, top_down=False,
             compression=0, masks=None) -> bytes:
    """A BMP from (h, w) indices (bits <= 8) or (h, w * bytes) pixel
    bytes; ``palette`` as (n, 3) RGB."""
    a = np.asarray(idx_or_px)
    h = a.shape[0]
    w = a.shape[1] if bits <= 8 else a.shape[1] * 8 // bits
    rows = (_pack_rows(a[:, :, None], bits) if bits < 8
            else a.astype(np.uint8))
    if not top_down:
        rows = rows[::-1]
    stride = ((w * bits + 31) >> 3) & ~3
    body = b"".join(r.tobytes() + bytes(stride - len(r)) for r in rows)
    pad = 3 if hsize == 12 else 4
    pal = b"" if palette is None else b"".join(
        bytes(list(c[::-1]) + [0] * (pad - 3)) for c in palette)
    if hsize == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IIIHHIIiiII", hsize, w,
                           2 ** 32 - h if top_down else h, 1, bits,
                           compression, len(body), 0, 0, 0, 0)
        if hsize > 40:
            info += struct.pack("<4I", *(masks or (0, 0, 0, 0)))
            info += bytes(hsize - 56)
    extra = (struct.pack("<3I", *masks[:3])
             if masks is not None and hsize == 40 else b"")
    off = 14 + len(info) + len(extra) + len(pal)
    return (b"BM" + struct.pack("<IHHI", off + len(body), 0, 0, off) + info
            + extra + pal + body)


def _bmp_cases(rng, w, h):
    for bits in (1, 4, 8):
        idx = rng.randint(0, 1 << bits, (h, w))
        n = 1 << bits
        ramp = np.arange(n) if n > 2 else np.array([0, 255])
        for name, pal in (
                ("rand", rng.randint(0, 256, (n, 3))),
                ("ramp", np.repeat(ramp[:, None], 3, 1)),
                ("grey", np.repeat(rng.randint(0, 256, n)[:, None], 3, 1))):
            for hsize in (12, 40, 124):
                for td in ((False, True) if hsize != 12 else (False,)):
                    yield (f"{bits}bit-{name}-{hsize}-{td}",
                           make_bmp(idx, bits, pal, hsize, td))
    for bits in (16, 24, 32):
        px = rng.randint(0, 256, (h, w * bits // 8))
        yield f"{bits}bit", make_bmp(px, bits)
        yield f"{bits}bit-td", make_bmp(px, bits, top_down=True)
        masks = {16: [(0xF800, 0x7E0, 0x1F, 0), (0x7C00, 0x3E0, 0x1F, 0)],
                 24: [(0xFF0000, 0xFF00, 0xFF, 0)],
                 32: [(0xFF0000, 0xFF00, 0xFF, 0xFF000000),
                      (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
                      (0xFF000000, 0xFF0000, 0xFF00, 0), (0, 0, 0, 0)]}
        for m in masks[bits]:
            yield (f"{bits}bit-bitfields-{m}",
                   make_bmp(px, bits, hsize=108, compression=3, masks=m))
        yield (f"{bits}bit-bitfields40", make_bmp(
            px, bits, compression=3, masks=masks[bits][0]))
    for mode in ("1", "L", "P", "RGB", "RGBA"):
        a = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        yield f"PIL-{mode}", pil_bytes(Image.fromarray(a).convert(mode),
                                       "BMP")


@pytest.mark.parametrize("w,h", [(1, 1), (5, 3), (17, 9), (32, 4)])
def test_bmp_decode_equals_jax(w, h):
    rng = np.random.RandomState(w * 10 + h)
    for name, data in _bmp_cases(rng, w, h):
        try:
            want = jimage.decode_image_bytes(data).array
        except jimage.CorruptRasterError:
            # what PIL refuses (a 4-bit grey ramp wider than its row
            # padding) the port refuses too
            with pytest.raises(timage.CorruptRasterError):
                timage.decode_image_bytes(data)
            continue
        got = timage.decode_image_bytes(data).array
        assert_same(got, want)
        info = timage.sniff_image_info(data)
        assert (info.height, info.width, info.count, info.dtype) == \
            got.shape + (got.dtype.name,), name


def test_bmp_rle_raises_item_6():
    """Named for the item-6 raise it pinned until RLE BMPs were ported:
    RLE8 and RLE4 bitmaps (runs, an absolute run, EOL and EOF) decode to
    the JAX package's arrays (PIL's BmpRleDecoder)."""
    rng = np.random.RandomState(6)
    for bits, comp, body in (
            (8, 1, bytes([3, 7, 0, 3, 1, 2, 250, 0]) + b"\0\0" +
             bytes([6, 9]) + b"\0\1"),
            (4, 2, bytes([5, 0x12, 0, 3, 0x34, 0]) + b"\0\0" +
             bytes([9, 0xAB]) + b"\0\1")):
        pal = rng.randint(0, 256, (1 << bits, 3))
        data = bytearray(make_bmp(np.zeros((2, 6), int), bits, pal,
                                  compression=comp))
        off = struct.unpack("<I", data[10:14])[0]
        data = bytes(data[:off]) + body
        data = data[:2] + struct.pack("<I", len(data)) + data[6:]
        got, want = both_decode(data)
        assert_same(got, want)
        assert got.shape == (2, 6, 3)


# ------------------------------------------ the JAX sniffer's faults

def test_png_sniff_faults_of_the_jax_package_are_not_carried():
    """16-bit RGB(A) PNGs decode to uint8 in both packages; the JAX
    sniffer says uint16. 16-bit grey+alpha decodes to 4 bands; the JAX
    sniffer says 2. 1-bit grey decodes to bool; the JAX sniffer says
    uint8. The port's sniffer reports what the decode returns."""
    rng = np.random.RandomState(4)
    for ct, depth, jax_says, port_says in (
            (2, 16, (3, "uint16"), (3, "uint8")),
            (6, 16, (4, "uint16"), (4, "uint8")),
            (4, 16, (2, "uint16"), (4, "uint8")),
            (0, 1, (1, "uint8"), (1, "bool"))):
        data = make_png(rng.randint(0, 1 << depth, (3, 4, _CHANNELS[ct])),
                        depth, ct, rng)
        got, want = both_decode(data)
        assert_same(got, want)
        j, t = jimage.sniff_image_info(data), timage.sniff_image_info(data)
        assert (j.count, j.dtype) == jax_says
        assert (t.count, t.dtype) == port_says == (got.shape[2],
                                                   got.dtype.name)


def test_bmp_sniff_faults_of_the_jax_package_are_not_carried():
    """32-bit BI_RGB BMPs decode to 3 bands (BGRX); the JAX sniffer
    says 4. A grey palette that is not the identity ramp decodes to RGB;
    the JAX sniffer says 1 band. A black/white 1-bit BMP decodes to
    bool; the JAX sniffer says uint8."""
    rng = np.random.RandomState(6)
    grey = np.repeat(rng.randint(0, 256, 256)[:, None], 3, 1)
    for data, jax_says, port_says in (
            (make_bmp(rng.randint(0, 256, (3, 16)), 32), (4, "uint8"),
             (3, "uint8")),
            (make_bmp(rng.randint(0, 256, (3, 4)), 8, grey), (1, "uint8"),
             (3, "uint8")),
            (make_bmp(rng.randint(0, 2, (3, 4)), 1, [[0] * 3, [255] * 3]),
             (1, "uint8"), (1, "bool"))):
        got, want = both_decode(data)
        assert_same(got, want)
        j, t = jimage.sniff_image_info(data), timage.sniff_image_info(data)
        assert (j.count, j.dtype) == jax_says
        assert (t.count, t.dtype) == port_says == (got.shape[2],
                                                   got.dtype.name)


@pytest.mark.parametrize("fmt", ["png", "jpeg"])
def test_sniff_equals_jax_for_chip_codecs(fmt):
    rng = np.random.RandomState(8)
    for shape in ((1, 1, 1), (9, 7, 3), (20, 31, 1)):
        a = _image(rng, shape[:2], shape[2])
        data = (timage.encode_png(a) if fmt == "png"
                else timage.encode_jpeg(a, 90))
        j, t = jimage.sniff_image_info(data), timage.sniff_image_info(data)
        assert (t.height, t.width, t.count, t.dtype) == \
            (j.height, j.width, j.count, j.dtype)


# ---------------------------------------------------------------- fuzz

CLEAN = (timage.CorruptRasterError, timage.UnsupportedFormatError)
DEADLINE_S = 20


class _Watchdog:
    def __enter__(self):
        def fire(signum, frame):
            raise AssertionError(f"decoder exceeded the {DEADLINE_S}s "
                                 "watchdog (hang on corrupt input)")
        self._old = signal.signal(signal.SIGALRM, fire)
        signal.alarm(DEADLINE_S)

    def __exit__(self, *exc):
        signal.alarm(0)
        signal.signal(signal.SIGALRM, self._old)
        return False


def _fuzz_fixtures():
    rng = np.random.RandomState(0)
    rgb = _image(rng, (24, 32), 3)
    yield "png", timage.encode_png(rgb)
    yield "png-interlaced-palette", make_png(
        rng.randint(0, 16, (13, 11, 1)), 4, 3, rng,
        rng.randint(0, 256, 48).astype(np.uint8).tobytes(), interlace=1,
        split=50)
    yield "png-16bit", make_png(rng.randint(0, 65536, (9, 7, 2)), 16, 4, rng)
    yield "jpeg-420", timage.encode_jpeg(rgb, 90)
    yield "jpeg-grey-restart", pil_jpeg(rgb[:, :, :1], quality=70,
                                        restart_marker_blocks=2)
    yield "jpeg-444", pil_jpeg(rgb, quality=50, subsampling=0)
    yield "gif", pil_bytes(Image.fromarray(rgb).convert("P"), "GIF",
                           interlace=1)
    yield "bmp-8bit", make_bmp(rng.randint(0, 256, (10, 9)), 8,
                               rng.randint(0, 256, (256, 3)))
    yield "bmp-24bit", make_bmp(rng.randint(0, 256, (7, 15)), 24)
    yield "jp2-rgb", encode_jp2(rgb)
    yield "jp2-uint16-geo", encode_jp2(
        rng.randint(0, 4096, (17, 23)).astype(np.uint16),
        geotransform=(300000.0, 10.0, 0.0, 2100000.0, 0.0, -10.0),
        epsg=32643, nodata=0)
    yield "j2k-9/7-rpcl-precincts", pil_bytes(
        Image.fromarray(rgb[:, :, 0]), "JPEG2000", no_jp2=True,
        irreversible=True, progression="RPCL", precinct_size=(16, 16),
        num_resolutions=3, quality_layers=[30, 10], codeblock_size=(16, 16))
    # BYPASS + TERMALL + SEGSYM, SOP, EPH, PPT headers, a POC, RGN 2
    arr = np.ascontiguousarray(rgb)
    out = np.empty(1 << 20, np.uint8)
    n = _jp2_encoder().fc_j2k_encode(arr.ctypes.data, 24, 32, 3, 8,
                                     37 | 768 | 1024 | 4096 | (2 << 16),
                                     out.ctypes.data, out.size)
    yield "j2k-styles-sop-eph-ppt-poc-rgn", out[:n].tobytes()
    yield "j2k-tiles-plt", pil_bytes(
        Image.fromarray(rgb), "JPEG2000", no_jp2=True, tile_size=(16, 16),
        plt=True)


@pytest.mark.parametrize("name,data", list(_fuzz_fixtures()),
                         ids=[n for n, _ in _fuzz_fixtures()])
def test_fuzz_truncation_and_bit_flips(name, data):
    """Seeded truncations and bit flips: each mutation decodes to the
    shape its header gives, or raises one of the clean exceptions,
    within the deadline; never a crash of the worker."""
    rng = np.random.RandomState(zlib.crc32(name.encode()))
    mutations = [data[:k] for k in rng.randint(0, len(data), 30)]
    for _ in range(60):
        b = bytearray(data)
        for pos in rng.randint(0, len(b), rng.randint(1, 4)):
            b[pos] ^= 1 << rng.randint(8)
        mutations.append(bytes(b))
    for m in mutations:
        with _Watchdog():
            try:
                arr = timage.decode_image_bytes(m).array
            except CLEAN:
                continue
            info = timage.sniff_image_info(m)
            assert arr.shape == (info.height, info.width, info.count)
            assert arr.dtype.name == info.dtype or name.startswith("jpeg")


def test_decoders_agree_across_threads():
    """The feed decodes on several parse threads, with the GIL released in
    the C++ decoders: 8 threads decoding at once give the single-thread
    arrays."""
    import sys
    import threading
    rng = np.random.RandomState(12)
    datas = [timage.encode_jpeg(_image(rng, (40, 56), 3), q)
             for q in (50, 95)]
    datas += [timage.encode_png(_image(rng, (33, 20), 3)),
              pil_bytes(Image.fromarray(_image(rng, (30, 30), 3))
                        .convert("P"), "GIF", interlace=1),
              encode_jp2(_image(rng, (37, 29), 3)),
              pil_bytes(Image.fromarray(_image(rng, (31, 23), 1)[:, :, 0]),
                        "JPEG2000", irreversible=True)]
    want = [timage.decode_image_bytes(d).array for d in datas]
    errors = []

    def work():
        try:
            for _ in range(20):
                for d, w in zip(datas, want):
                    np.testing.assert_array_equal(
                        timage.decode_image_bytes(d).array, w)
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
