"""Writes the committed image-codec fixtures of ``tests/data/jpeg``,
``tests/data/bmp`` and ``tests/data/jp2``, each beside an ``.npz`` of the
JAX package's decode (``decode_image_bytes``: the array, or the class and
message prefix it raises).

Run from the root of the repository, where PIL (with its bundled
libjpeg-turbo 3 and OpenJPEG 2.5), gcc and the JAX package are:

    python tests/data/make_codec_fixtures.py

The JPEG variants come from ``jpeg/jpeg_writer.c``, built here against
``/usr/include/jpeglib.h`` and linked to the libjpeg-turbo PIL bundles
(it writes arithmetic, progressive, lossless, CMYK/YCCK and 12- and
16-bit frames), from PIL itself, from a lossless encoder in this file
(subsampled and restart-interval frames, which libjpeg-turbo's encoder
does not write) and from byte edits (hierarchical, arithmetic lossless,
DNL). RLE BMPs are encoded here. Subsampled and sYCC JPEG 2000 files,
which PIL cannot write, go through ctypes into PIL's bundled OpenJPEG.
"""

from __future__ import annotations

import ctypes
import glob
import io
import os
import struct
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def chip(seed: int, h: int = 128, w: int = 128, c: int = 3,
         noise: float = 2.0) -> np.ndarray:
    """A seeded smooth field plus noise, uint8."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    bands = []
    for _ in range(c):
        f = np.zeros((h, w))
        for _ in range(4):
            fy, fx = rng.uniform(0.5, 3.0, 2) * 2 * np.pi
            f += rng.uniform(20, 50) * np.sin(fy * yy / h + fx * xx / w
                                              + rng.uniform(0, 6.3))
        bands.append(128 + f + rng.normal(0, noise, (h, w)))
    return np.clip(np.rint(np.stack(bands, 2)), 0, 255).astype(np.uint8)


# ------------------------------------------------------------- JPEG


def pillow_lib(pattern: str) -> str:
    import PIL
    libs = os.path.join(os.path.dirname(PIL.__file__), "..", "pillow.libs")
    return os.path.realpath(glob.glob(os.path.join(libs, pattern))[0])


class JpegWriter:
    """``jpeg_writer.c`` built against PIL's libjpeg-turbo."""

    def __init__(self, tmp: str):
        self.tmp = tmp
        self.exe = os.path.join(tmp, "jpeg_writer")
        lib = pillow_lib("libjpeg-*.so*")
        subprocess.run(["gcc", "-O1", "-o", self.exe,
                        os.path.join(HERE, "jpeg", "jpeg_writer.c"), lib,
                        f"-Wl,-rpath,{os.path.dirname(lib)}"], check=True)

    def __call__(self, a: np.ndarray, *opts: str) -> bytes:
        a = np.ascontiguousarray(a)
        h, w = a.shape[:2]
        c = 1 if a.ndim == 2 else a.shape[2]
        src = os.path.join(self.tmp, "in.raw")
        dst = os.path.join(self.tmp, "out.jpg")
        a.tofile(src)
        subprocess.run([self.exe, dst, src, str(h), str(w), str(c), *opts],
                       check=True)
        with open(dst, "rb") as f:
            return f.read()


def lossless_jpeg(planes, samp, width, height, psv=1, pt=0,
                  restart_rows=0, marker="adobe0", interleave=True) -> bytes:
    """A lossless (SOF3) JPEG of 8-bit component planes, each at its own
    extent ceil(W h / hmax) x ceil(H v / vmax): predictor ``psv``, point
    transform ``pt``, a restart every ``restart_rows`` MCU rows, one scan
    or one per component; ``marker`` is "adobe0", "adobe1", "jfif" or
    "none". Every difference is coded with a 5-bit code of its category."""
    nc = len(planes)
    hmax = max(h for h, _ in samp)
    vmax = max(v for _, v in samp)
    out = bytearray(b"\xff\xd8")
    if marker == "jfif":
        out += (b"\xff\xe0" + struct.pack(">H", 16) +
                b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    elif marker.startswith("adobe"):
        out += (b"\xff\xee" + struct.pack(">H", 14) + b"Adobe" +
                bytes([0, 100, 0, 0, 0, 0, int(marker[5:])]))
    out += b"\xff\xc3" + struct.pack(">HBHHB", 8 + 3 * nc, 8, height, width,
                                     nc)
    for i in range(nc):
        out += bytes([i + 1, samp[i][0] << 4 | samp[i][1], 0])
    out += (b"\xff\xc4" + struct.pack(">H", 36) + b"\x00" +
            bytes([0] * 4 + [17] + [0] * 11) + bytes(range(17)))
    scans = [list(range(nc))] if interleave else [[i] for i in range(nc)]
    for sc in scans:
        ns = len(sc)
        if ns == 1:
            c = sc[0]
            cols = -(-width * samp[c][0] // hmax)
            rows = -(-height * samp[c][1] // vmax)
        else:
            cols, rows = -(-width // hmax), -(-height // vmax)
        if restart_rows:
            out += b"\xff\xdd" + struct.pack(">HH", 4, restart_rows * cols)
        out += b"\xff\xda" + struct.pack(">HB", 6 + 2 * ns, ns)
        for c in sc:
            out += bytes([c + 1, 0])
        out += bytes([psv, 0, pt])
        diffs = {}
        for c in sc:
            p = planes[c].astype(np.int64) >> pt
            per = restart_rows * (samp[c][1] if ns > 1 else 1)
            for y in range(p.shape[0]):
                first = y == 0 or (restart_rows and y % per == 0)
                for x in range(p.shape[1]):
                    if first:
                        pred = (1 << (7 - pt)) if x == 0 else p[y, x - 1]
                    elif x == 0:
                        pred = p[y - 1, 0]
                    else:
                        ra, rb, rc = p[y, x - 1], p[y - 1, x], p[y - 1, x - 1]
                        pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc,
                                5: ra + ((rb - rc) >> 1),
                                6: rb + ((ra - rc) >> 1),
                                7: (ra + rb) >> 1}[psv]
                    d = (int(p[y, x]) - int(pred)) & 0xFFFF
                    diffs[c, y, x] = d - 65536 if d > 32768 else d
        bits = []

        def put(v, n):
            bits.extend((v >> (n - 1 - i)) & 1 for i in range(n))

        def flush():
            bits.extend([1] * (-len(bits) % 8))
            for i in range(0, len(bits), 8):
                b = int("".join(map(str, bits[i:i + 8])), 2)
                out.append(b)
                if b == 0xFF:
                    out.append(0)
            bits.clear()

        rst = 0
        for my in range(rows):
            if restart_rows and my and my % restart_rows == 0:
                flush()
                out.extend(bytes([0xFF, 0xD0 + rst]))
                rst = (rst + 1) & 7
            for mx in range(cols):
                for c in sc:
                    h, v = (1, 1) if ns == 1 else samp[c]
                    for yy in range(v):
                        for xx in range(h):
                            y = my * v + yy if ns > 1 else my
                            x = mx * h + xx if ns > 1 else mx
                            d = diffs.get((c, y, x), 0)
                            s = 16 if d == 32768 else abs(d).bit_length()
                            put(s, 5)
                            if 0 < s < 16:
                                put(d if d > 0 else d + (1 << s) - 1, s)
        flush()
    out += b"\xff\xd9"
    return bytes(out)


def sof_patched(data: bytes, marker: int) -> bytes:
    """The file with its SOF marker code replaced."""
    i = next(i for i in range(2, len(data) - 1) if data[i] == 0xFF and
             0xC0 <= data[i + 1] <= 0xCF and data[i + 1] not in (0xC4, 0xC8,
                                                                0xCC))
    return data[:i + 1] + bytes([marker]) + data[i + 2:]


def with_dnl(data: bytes) -> bytes:
    """Height 0 in the SOF and a DNL segment after the scan."""
    i = data.index(b"\xff\xc0")
    h = data[i + 5:i + 7]
    data = data[:i + 5] + b"\0\0" + data[i + 7:]
    return data[:-2] + b"\xff\xdc\x00\x04" + h + b"\xff\xd9"


def jpeg_fixtures(tmp: str):
    from PIL import Image
    jw = JpegWriter(tmp)

    def pil(a, **kw):
        buf = io.BytesIO()
        Image.fromarray(a).save(buf, format="JPEG", **kw)
        return buf.getvalue()

    rng = np.random.RandomState(15)
    small = chip(20, 33, 20)
    planes420 = [chip(21, 33, 20, 1)[:, :, 0], chip(22, 17, 10, 1)[:, :, 0],
                 chip(23, 17, 10, 1)[:, :, 0]]
    yield "progressive", pil(chip(1), quality=90, progressive=True)
    yield "arith", jw(chip(2), "arith=1", "q=90")
    yield "arith-progressive", jw(chip(3), "arith=1", "prog=1", "q=90")
    yield "lossless", jw(chip(4), "lossless=1,0", "space=rgb")
    yield "cmyk", _cmyk(Image, chip(5, 64, 64))
    yield "ycck", jw(chip(6, 48, 40, 4), "space=ycck", "q=85")
    yield "progressive-1x1-grey", pil(chip(7, 1, 1, 1)[:, :, 0],
                                      progressive=True)
    yield "progressive-optimized-7x13", pil(chip(8, 7, 13), quality=50,
                                            progressive=True, optimize=True,
                                            subsampling=1)
    yield "progressive-restart", jw(small, "prog=1", "restart=2", "q=75")
    yield "arith-restart-dac", jw(small, "arith=1", "restart=3",
                                  "dac=2,5,10", "q=60")
    yield "arith-progressive-grey", jw(chip(9, 40, 24, 1)[:, :, 0],
                                       "arith=1", "prog=1")
    yield "lossless-420-psv7-restart", lossless_jpeg(
        planes420, ((2, 2), (1, 1), (1, 1)), 20, 33, psv=7, pt=1,
        restart_rows=4, marker="none")
    yield "lossless-psv5-scans", lossless_jpeg(
        [small[:, :, 0], small[::2, :, 1].copy(), small[:, ::2, 2].copy()],
        ((2, 2), (2, 1), (1, 2)), 20, 33, psv=5, restart_rows=3,
        interleave=False)
    yield "lossless-cmyk", jw(chip(10, 16, 24, 4), "lossless=3,0")
    yield "custom-script", jw(small, "scans=0.1.2/0/0/0/1;0/1/5/0/2;"
                              "2/1/63/0/1;1/1/63/0/1;0/6/63/0/2;"
                              "0/1/63/2/1;0.1.2/0/0/1/0;2/1/63/1/0;"
                              "1/1/63/1/0;0/1/63/1/0")
    # refusals: the JAX package's CorruptRasterError, and item 6's
    yield "smoothing", jw(small, "scans=0.1.2/0/0/0/0;0/1/63/0/1;"
                          "1/1/63/0/0;2/1/63/0/0")
    yield "lossless-jfif", lossless_jpeg(
        [small[:, :, k] for k in range(3)], ((1, 1),) * 3, 20, 33,
        marker="jfif")
    yield "12bit", jw(rng.randint(0, 4096, (9, 9, 3)).astype(np.uint16),
                      "prec=12")
    yield "lossless-16bit", jw(rng.randint(0, 65536, (9, 9)).astype(
        np.uint16), "lossless=1,0", "prec=16")
    yield "lossless-6bit", jw(small[:, :, 0] // 4, "lossless=1,0", "prec=6")
    yield "hierarchical", sof_patched(pil(small), 0xC5)
    yield "arith-lossless", sof_patched(jw(small, "lossless=1,0",
                                           "space=rgb"), 0xCB)
    yield "2comp", jw(small[:, :, :2], "q=80")
    yield "dnl", with_dnl(pil(small, quality=80))
    arith = jw(chip(11, 96, 96), "arith=1", "q=90")
    pad = b"\xff\xfe" + struct.pack(">H", 65000) + bytes(64998)
    yield "arith-past-64k", arith[:2] + pad + arith[2:]


def _cmyk(Image, a: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(a).convert("CMYK").save(buf, format="JPEG", quality=90)
    return buf.getvalue()


# ------------------------------------------------------------- BMP


def rle_bmp(idx: np.ndarray, palette: np.ndarray, rle4: bool,
            stream: bytes = None) -> bytes:
    """An RLE8 (or RLE4) BMP of (h, w) palette indices, bottom-up: runs
    of equal indices, absolute runs elsewhere, an EOL per row; or the
    given ``stream`` as its pixel data."""
    h, w = idx.shape
    if stream is None:
        out = bytearray()
        for row in idx[::-1]:
            x = 0
            while x < w:
                n = 1
                while x + n < w and n < 255 and row[x + n] == row[x]:
                    n += 1
                if n >= 3 or w - x < 3:
                    v = row[x]
                    out += bytes([n, (v << 4 | v) if rle4 else v])
                    x += n
                else:
                    n = min(w - x, 255)
                    m = 3
                    while m < n and not (m + 2 < n and row[x + m] ==
                                         row[x + m + 1] == row[x + m + 2]):
                        m += 1
                    vals = row[x:x + m]
                    if rle4:
                        packed = [(int(vals[i]) << 4) | (int(vals[i + 1])
                                                         if i + 1 < m else 0)
                                  for i in range(0, m, 2)]
                        out += bytes([0, m]) + bytes(packed)
                    else:
                        out += bytes([0, m]) + bytes(vals.tolist())
                    if len(out) % 2:
                        out += b"\0"
                    x += m
            out += b"\0\0"
        out += b"\0\1"
        stream = bytes(out)
    n = len(palette)
    pal = b"".join(bytes([c[2], c[1], c[0], 0]) for c in palette)
    info = struct.pack("<IIIHHIIiiII", 40, w, h, 1, 4 if rle4 else 8,
                       2 if rle4 else 1, len(stream), 2835, 2835, n, 0)
    off = 14 + 40 + len(pal)
    # the pixel data starts on an even offset: absolute runs pad to a
    # 16-bit word of the file
    return (b"BM" + struct.pack("<IHHI", off + len(stream), 0, 0, off) +
            info + pal + stream)


def bmp_fixtures():
    a = chip(12)
    levels = (a // 32).astype(np.int64)  # 8 x 8 x 4 colours
    idx = (levels[:, :, 0] * 32 + levels[:, :, 1] * 4 +
           levels[:, :, 2] // 2).astype(np.uint8)
    pal = np.array([[r * 32 + 16, g * 32 + 16, b * 64 + 32]
                    for r in range(8) for g in range(8) for b in range(4)],
                   np.uint8)
    yield "rle8", rle_bmp(idx, pal, False)
    idx4 = (chip(13, 48, 37, 1)[:, :, 0] // 16).astype(np.uint8)
    pal4 = np.random.RandomState(13).randint(0, 256, (16, 3)).astype(np.uint8)
    yield "rle4-odd-width", rle_bmp(idx4, pal4, True)
    grey = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    yield "rle8-grey", rle_bmp(chip(14, 20, 31, 1)[:, :, 0] // 8 * 8, grey,
                               False)
    # escapes: runs past the row's end, EOL, a delta (PIL moves by the
    # second pair of its bytes), an odd absolute run, early EOF
    esc = (bytes([3, 7, 40, 9]) + b"\0\0" + bytes([0, 2, 0, 0, 2, 1]) +
           bytes([2, 5, 0, 3, 1, 2, 3, 0]) + b"\0\0" + bytes([6, 4]) +
           b"\0\1")
    yield "rle8-escapes", rle_bmp(np.zeros((5, 6), np.uint8), pal[:64],
                                  False, esc)
    esc4 = (bytes([5, 0x12, 0, 3, 0x34, 0x50]) + b"\0\0" + bytes([9, 0xAB])
            + b"\0\0" + bytes([7, 0xCD]) + b"\0\1")
    yield "rle4-escapes", rle_bmp(np.zeros((3, 7), np.uint8), pal4, True,
                                  esc4)
    yield "rle8-short", rle_bmp(np.zeros((4, 5), np.uint8), pal[:16], False,
                                bytes([5, 1]) + b"\0\0" + bytes([5, 2]))


# ------------------------------------------------------------- JPEG 2000


class OpenJpeg:
    """Subsampled / sYCC JPEG 2000 writes through PIL's OpenJPEG."""

    class CmptParm(ctypes.Structure):
        _fields_ = [(k, ctypes.c_uint32) for k in (
            "dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd")]

    class Comp(ctypes.Structure):
        _fields_ = [(k, ctypes.c_uint32) for k in (
            "dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd",
            "resno_decoded", "factor")] + [
            ("data", ctypes.POINTER(ctypes.c_int32)),
            ("alpha", ctypes.c_uint16)]

    class Image(ctypes.Structure):
        pass

    Image._fields_ = [(k, ctypes.c_uint32) for k in (
        "x0", "y0", "x1", "y1", "numcomps")] + [
        ("color_space", ctypes.c_int), ("comps", ctypes.POINTER(Comp)),
        ("icc_profile_buf", ctypes.c_void_p),
        ("icc_profile_len", ctypes.c_uint32)]

    def __init__(self, tmp: str):
        self.tmp = tmp
        o = self.opj = ctypes.CDLL(pillow_lib("libopenjp2-*.so*"))
        o.opj_image_create.restype = ctypes.POINTER(self.Image)
        o.opj_image_create.argtypes = [ctypes.c_uint32,
                                       ctypes.POINTER(self.CmptParm),
                                       ctypes.c_int]
        for f in ("opj_create_compress",
                  "opj_stream_create_default_file_stream"):
            getattr(o, f).restype = ctypes.c_void_p
        o.opj_stream_create_default_file_stream.argtypes = [ctypes.c_char_p,
                                                            ctypes.c_int]
        for f in ("opj_setup_encoder", "opj_start_compress"):
            getattr(o, f).argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_void_p]
        for f in ("opj_encode", "opj_end_compress"):
            getattr(o, f).argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        for f in ("opj_stream_destroy", "opj_destroy_codec",
                  "opj_image_destroy"):
            getattr(o, f).argtypes = [ctypes.c_void_p]
        # offsets in opj_cparameters_t, found from its defaults: 6
        # resolutions, then 64 x 64 code-blocks, follow tcp_numlayers,
        # tcp_rates[100] and tcp_distoratio[100]
        params = ctypes.create_string_buffer(1 << 16)
        o.opj_set_default_encoder_parameters(params)
        ints = np.frombuffer(params.raw, np.int32)
        k = next(i for i in range(len(ints) - 2)
                 if tuple(ints[i:i + 3]) == (6, 64, 64))
        self.numres_at, self.numlayers_at = 4 * k, 4 * k - 804

    def __call__(self, planes, subs, height, width, space, jp2=True,
                 tile=None) -> bytes:
        """planes at each component's extent; space: 0 unspecified,
        1 sRGB, 2 grey, 3 sYCC."""
        o, nc = self.opj, len(planes)
        cp = (self.CmptParm * nc)()
        for i, (p, (dx, dy)) in enumerate(zip(planes, subs)):
            assert p.shape == (-(-height // dy), -(-width // dx))
            cp[i].dx, cp[i].dy, cp[i].w, cp[i].h = dx, dy, p.shape[1], \
                p.shape[0]
            cp[i].prec = cp[i].bpp = 8
        img = o.opj_image_create(nc, cp, space)
        im = img.contents
        im.x0, im.y0, im.x1, im.y1 = 0, 0, width, height
        for i, p in enumerate(planes):
            c = im.comps[i]
            np.ctypeslib.as_array(c.data, (c.h * c.w,))[:] = p.astype(
                np.int32).ravel()
        params = ctypes.create_string_buffer(1 << 16)
        o.opj_set_default_encoder_parameters(params)
        side = min(min(p.shape) for p in planes)
        if tile:
            side = min(side, min(tile) // max(max(s) for s in subs))
        sets = [(20, 1), (self.numlayers_at, 1),  # cp_disto_alloc, layers
                (self.numres_at, max(1, min(6, side.bit_length())))]
        if tile:
            sets += [(0, 1), (12, tile[1]), (16, tile[0])]
        for off, val in sets:
            ctypes.memmove(ctypes.addressof(params) + off,
                           ctypes.byref(ctypes.c_int(val)), 4)
        path = os.path.join(self.tmp, "out.jp2")
        codec = o.opj_create_compress(2 if jp2 else 0)
        st = None
        try:
            assert o.opj_setup_encoder(codec, params, img)
            st = o.opj_stream_create_default_file_stream(path.encode(), 0)
            assert o.opj_start_compress(codec, img, st)
            assert o.opj_encode(codec, st) and o.opj_end_compress(codec, st)
        finally:
            if st:
                o.opj_stream_destroy(st)
            o.opj_destroy_codec(codec)
            o.opj_image_destroy(img)
        with open(path, "rb") as f:
            return f.read()


def jp2_fixtures(tmp: str):
    enc = OpenJpeg(tmp)

    def planes(a, subs):
        # each component subsampled by taking every dx-th sample
        return [np.ascontiguousarray(a[::dy, ::dx, k])
                for k, (dx, dy) in enumerate(subs)]

    s420 = ((1, 1), (2, 2), (2, 2))
    a = chip(16)
    yield "sycc-420", enc(planes(a, s420), s420, 128, 128, 3)
    odd = chip(17, 33, 20)
    yield "sycc-444", enc(planes(odd, ((1, 1),) * 3), ((1, 1),) * 3, 33, 20,
                          3)
    s422 = ((1, 1), (2, 1), (2, 1))
    yield "codestream-422", enc(planes(odd, s422), s422, 33, 20, 0,
                                jp2=False)
    yield "srgb-420-odd", enc(planes(odd, s420), s420, 33, 20, 1)
    alpha = chip(18, 29, 31, 4)
    s4 = ((1, 1), (2, 2), (2, 2), (1, 1))
    yield "sycc-alpha", enc(planes(alpha, s4), s4, 29, 31, 3)
    s33 = ((1, 1), (3, 3), (3, 3))
    yield "sycc-tiles", enc(planes(chip(19, 15, 17), s33), s33, 15, 17, 3,
                            tile=(6, 10))
    grey = chip(19, 16, 16, 1)
    yield "grey-subsampled", enc([grey[::1, ::2, 0]], ((2, 1),), 16, 16, 2)


# ------------------------------------------------------------- all


def jax_outcome(data: bytes) -> dict:
    from dl_image_segmentation_tpu.raster import image as jimage
    try:
        arr = jimage.decode_image_bytes(data).array
    except Exception as e:  # noqa: BLE001 -- the outcome is the fixture
        return {"error_class": np.array(type(e).__name__),
                "error_prefix": np.array(str(e).split(";")[0])}
    return {"array": arr}


def main():
    sys.path.insert(0, ROOT)
    with tempfile.TemporaryDirectory() as tmp:
        for sub, ext, gen in (("jpeg", "jpg", jpeg_fixtures(tmp)),
                              ("bmp", "bmp", bmp_fixtures()),
                              ("jp2", None, jp2_fixtures(tmp))):
            for name, data in gen:
                e = ext or ("j2k" if data[:2] == b"\xff\x4f" else "jp2")
                path = os.path.join(HERE, sub, f"{name}.{e}")
                with open(path, "wb") as f:
                    f.write(data)
                np.savez_compressed(os.path.join(HERE, sub, f"{name}.npz"),
                                    **jax_outcome(data))
                print(path, len(data))


if __name__ == "__main__":
    main()
