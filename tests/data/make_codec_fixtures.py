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

``python tests/data/make_codec_fixtures.py pil-corrupt`` writes
``tests/data/tiff_corrupt_outcomes.json``: the JAX package's
``decode_jpeg`` outcome of each file of the seeded corrupt TIFF corpus
(``corrupt_tiffs``) that the port is held to (``corrupt_scope``): the
dtype, shape and SHA-256 of the array, or the class and message prefix.
The card's host, which has no PIL, checks the port against it.
``... pil-corrupt-probe`` prints how many files of that corpus the
port's ``decode_jpeg`` decodes otherwise than the JAX package's, by part.

``python tests/data/make_codec_fixtures.py pil`` writes ``tests/data/pil``
instead: a small file of each format and mode PIL opens that the port's
``decode_png`` / ``decode_jpeg`` decode (WebP, TIFF, PPM, TGA, SGI, PCX,
QOI, ICO/CUR, IM, XBM, DDS), mostly PIL-written, a few written here
(plain PNM, SGI RLE, baseline TIFFs PIL does not write, BC4 DDS, CUR),
and refusals of each failure class, each beside an ``.npz`` of the JAX
package's ``decode_jpeg`` outcome (the array, or the class name and
message).
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


# --------------------------------------------------- PIL's other formats


def _pil(Image, im, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def sgi_rle(planes: np.ndarray, bpc: int = 1) -> bytes:
    """An RLE SGI file (PIL writes only raw ones): rows bottom-up, one
    offset/length table entry a row and band."""
    h, w, z = planes.shape
    head = bytearray(512)
    struct.pack_into(">HBBHHHH", head, 0, 474, 1, bpc, 3 if z > 1 else 2,
                     w, h, z)
    rows = []
    for band in range(z):
        for y in range(h):
            row = planes[h - 1 - y, :, band]
            out = bytearray()
            x = 0
            while x < w:
                run = 1
                while x + run < w and run < 126 and row[x + run] == row[x]:
                    run += 1
                if run > 2:
                    out += _sgi_word(run, bpc) + _sgi_word(int(row[x]), bpc)
                    x += run
                    continue
                lit = 1
                while x + lit < w and lit < 126 and not (
                        x + lit + 2 < w and row[x + lit] == row[x + lit + 1]
                        == row[x + lit + 2]):
                    lit += 1
                out += _sgi_word(0x80 | lit, bpc)
                for v in row[x:x + lit]:
                    out += _sgi_word(int(v), bpc)
                x += lit
            out += _sgi_word(0, bpc)
            rows.append(bytes(out))
    n = len(rows)
    offs, pos = [], 512 + 8 * n
    for r in rows:
        offs.append(pos)
        pos += len(r)
    table = struct.pack(f">{n}I", *offs) + struct.pack(
        f">{n}I", *[len(r) for r in rows])
    return bytes(head) + table + b"".join(rows)


def _sgi_word(v: int, bpc: int) -> bytes:
    return struct.pack(">H" if bpc == 2 else ">B", v)


def plain_pnm(magic: bytes, a: np.ndarray, maxval: int = 255) -> bytes:
    h, w = a.shape[:2]
    head = magic + b"\n# a comment\n" + f"{w} {h}\n".encode()
    if magic != b"P1":
        head += f"{maxval}\n".encode()
    body = " ".join(str(int(v)) for v in a.reshape(-1))
    return head + body.encode() + b"\n"


def tiff(a: np.ndarray, photometric: int, order: str = "<",
         extra=None, tile=None, orientation=None) -> bytes:
    """A baseline uncompressed TIFF of ``a`` (H, W, B), one strip or
    tiles, with the tags PIL reads to pick its mode."""
    tags = [] if extra is None else [(338, 3, list(extra))]
    if orientation:
        tags.append((274, 3, [orientation]))
    return tiff_coded(a, photometric, 1, lambda b: b.tobytes(), order,
                      tile=tile, tags=tags)


def dds_bc4(h: int, w: int, rng) -> bytes:
    """A DDS of BC4 blocks (FourCC ATI1; PIL writes no BC4)."""
    head = bytearray(128)
    head[:4] = b"DDS "
    struct.pack_into("<7I", head, 4, 124, 0x1007, h, w, 0, 0, 0)
    struct.pack_into("<4I", head, 76, 32, 0x4, struct.unpack(
        "<I", b"ATI1")[0], 0)
    blocks = ((h + 3) // 4) * ((w + 3) // 4)
    return bytes(head) + rng.randint(0, 256, blocks * 8).astype(
        np.uint8).tobytes()


def tiff_file(blocks, entries, order: str = "<") -> bytes:
    """A TIFF of the coded ``blocks`` (strips or tiles, in file order) and
    the IFD ``entries`` (tag, type, values), which name the blocks'
    offsets and byte counts by the placeholders ``"offsets"`` and
    ``"counts"``. Type 3 is SHORT, 4 LONG; longer values go after the
    IFD."""
    pos, offsets, body = 8, [], b""
    for blk in blocks:
        offsets.append(pos + len(body))
        body += blk
    fill = {"offsets": offsets, "counts": [len(b) for b in blocks]}
    entries = sorted((t, typ, fill.get(v, v) if isinstance(v, str) else v)
                     for t, typ, v in entries)
    ifd_at = 8 + len(body)
    extra_at = ifd_at + 2 + 12 * len(entries) + 4
    ifd, tail = struct.pack(order + "H", len(entries)), b""
    for tag, typ, vals in entries:
        raw = struct.pack(order + ("H" if typ == 3 else "I") * len(vals),
                          *vals)
        if len(raw) <= 4:
            ifd += struct.pack(order + "HHI", tag, typ, len(vals)) + \
                raw.ljust(4, b"\0")
        else:
            ifd += struct.pack(order + "HHII", tag, typ, len(vals),
                               extra_at + len(tail))
            tail += raw
    ifd += b"\0\0\0\0"
    head = b"II*\0" if order == "<" else b"MM\0*"
    return head + struct.pack(order + "I", ifd_at) + body + ifd + tail


def tiff_coded(a: np.ndarray, photometric: int, compression: int, code,
               order: str = "<", planar: int = 1, rows=None, tile=None,
               bits=None, tags=()) -> bytes:
    """A TIFF of ``a`` (H, W, B) whose strips of ``rows`` rows (or tiles,
    padded to (height, width) ``tile``), of every plane in turn when
    ``planar`` is 2, are ``code(block)``: ``block`` is that part of the
    array in the file's byte order. ``bits`` overrides the samples' size
    (for codes that pack them); ``tags`` adds IFD entries."""
    a = np.ascontiguousarray(a)
    h, w, spp = a.shape
    a = a.astype(a.dtype.newbyteorder(order))
    parts = [a[:, :, k:k + 1] for k in range(spp)] if planar == 2 else [a]
    blocks = []
    for p in parts:
        if tile:
            th, tw = tile
            for y in range(0, h, th):
                for x in range(0, w, tw):
                    blk = np.zeros((th, tw, p.shape[2]), p.dtype)
                    part = p[y:y + th, x:x + tw]
                    blk[:part.shape[0], :part.shape[1]] = part
                    blocks.append(code(blk))
        else:
            for y in range(0, h, rows or h):
                blocks.append(code(p[y:y + (rows or h)]))
    bits = bits or a.dtype.itemsize * 8
    fmt = 3 if a.dtype.kind == "f" else 2 if a.dtype.kind == "i" else 1
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * spp),
               (259, 3, [compression]), (262, 3, [photometric]),
               (277, 3, [spp]), (284, 3, [planar]), (339, 3, [fmt] * spp)]
    if tile:
        entries += [(322, 4, [tile[1]]), (323, 4, [tile[0]]),
                    (324, 4, "offsets"), (325, 4, "counts")]
    else:
        entries += [(273, 4, "offsets"), (278, 4, [rows or h]),
                    (279, 4, "counts")]
    return tiff_file(blocks, entries + list(tags), order)


def pil_planes(a: np.ndarray, photometric: int, compression: str,
               rows: int, predictor: int = 1, extra=None) -> bytes:
    """A separate-planes TIFF of ``a`` (H, W, B; uint8 or uint16) whose
    strips are libtiff's own: each band is written by PIL as a grey TIFF
    with ``compression``, ``rows`` rows a strip and ``predictor``, and
    its strips are lifted into one file."""
    from PIL import Image
    from PIL.TiffImagePlugin import COMPRESSION_INFO
    blocks = []
    for k in range(a.shape[2]):
        buf = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(a[:, :, k])).save(
            buf, "TIFF", compression=compression,
            tiffinfo={278: rows, 317: predictor})
        im = Image.open(io.BytesIO(buf.getvalue()))
        data = buf.getvalue()
        for off, n in zip(im.tag_v2[273], im.tag_v2[279]):
            blocks.append(data[off:off + n])
    code = {v: k for k, v in COMPRESSION_INFO.items()}[compression]
    h, w, spp = a.shape
    entries = [(256, 4, [w]), (257, 4, [h]),
               (258, 3, [a.dtype.itemsize * 8] * spp), (259, 3, [code]),
               (262, 3, [photometric]), (273, 4, "offsets"),
               (277, 3, [spp]), (278, 4, [rows]), (279, 4, "counts"),
               (284, 3, [2])]
    if predictor != 1:
        entries.append((317, 3, [predictor]))
    if extra:
        entries.append((338, 3, list(extra)))
    return tiff_file(blocks, entries)


def pack12(block: np.ndarray) -> bytes:
    """12-bit samples, most significant bits first, each row padded to a
    byte (TIFF BitsPerSample 12)."""
    out = b""
    for row in block.reshape(block.shape[0], -1).astype(np.uint16):
        bits = np.unpackbits(row.astype(">u2").view(np.uint8).reshape(
            -1, 2), axis=1)[:, 4:].reshape(-1)
        out += np.packbits(bits).tobytes()
    return out


def ycbcr_blocks(block: np.ndarray, hs: int, vs: int) -> bytes:
    """Contiguous YCbCr subsampled hs across by vs down: blocks of hs x vs
    luma samples, then the Cb and Cr of the block's first pixel (the
    block's edge padded with zeros)."""
    r, c = block.shape[:2]
    bx, by = -(-c // hs), -(-r // vs)
    p = np.zeros((by * vs, bx * hs, 3), np.uint8)
    p[:r, :c] = block
    t = p.reshape(by, vs, bx, hs, 3).transpose(0, 2, 1, 3, 4)
    y = t[..., 0].reshape(by, bx, hs * vs)
    return np.concatenate([y, t[:, :, 0, 0, 1:]], -1).tobytes()


def thunderscan(px: np.ndarray, rng) -> bytes:
    """ThunderScan codes (TIFF compression 32809) of (rows, width) 4-bit
    pixels, each row from a last pixel of 0: at each step one of the
    codes that fits, picked at random (a raw value, a run of the last
    pixel, three 2-bit or two 3-bit deltas, some skipped). No run ends a
    row: libtiff's decoder writes nothing for a run that fills the row."""
    two = {0: 0, 1: 1, -1: 3}
    three = {0: 0, 1: 1, 2: 2, 3: 3, -3: 5, -2: 6, -1: 7}

    def delta(last, t):
        d = (int(t) - last) % 16
        return d - 16 if d > 7 else d
    out = bytearray()
    for row in px:
        last, i, n = 0, 0, len(row)
        while i < n:
            run = 0
            while i + run < n and row[i + run] == last and run < 63:
                run += 1
            kinds = ["raw"] + (["run"] if 1 <= run and i + run < n else []) \
                + (["two"] if delta(last, row[i]) in two else []) \
                + (["three"] if delta(last, row[i]) in three else [])
            kind = kinds[rng.randint(len(kinds))]
            if kind == "raw":
                out.append(0xC0 | int(row[i]))
                last, i = int(row[i]), i + 1
            elif kind == "run":
                m = rng.randint(1, run + 1)
                out.append(m)
                i += m
            else:
                table, width, skip = (two, 3, 2) if kind == "two" else \
                    (three, 2, 4)
                codes = []
                while len(codes) < width and i < n and \
                        delta(last, row[i]) in table:
                    codes.append(table[delta(last, row[i])])
                    last, i = int(row[i]), i + 1
                    if rng.rand() < 0.3:
                        break
                codes += [skip] * (width - len(codes))
                out.append(0x40 | codes[0] << 4 | codes[1] << 2 | codes[2]
                           if kind == "two" else
                           0x80 | codes[0] << 3 | codes[1])
    return bytes(out)


def tiff_codec_fixtures():
    """TIFFs of the codecs libtiff decodes for PIL beyond LZW, Deflate,
    PackBits and JPEG (CCITT, zstd, LZMA, ThunderScan), separate planes,
    12-bit grey, YCbCr through libtiff's RGBA reader, and the
    compressions this libtiff refuses."""
    import lzma
    import zlib
    from PIL import Image
    rng = np.random.RandomState(20)
    field = chip(40, 48, 61, 1)[:, :, 0]
    bilevel = Image.fromarray(field > 128)
    rgb = chip(41, 23, 19)
    rgba = np.dstack([rgb, chip(42, 23, 19, 1)])
    grey = Image.fromarray(rgb[:, :, 1])
    for name, kw in (
            ("g3-1d", dict(compression="group3")),
            ("g3-2d", dict(compression="group3", tiffinfo={292: 1, 278: 16})),
            ("g3-fillbits", dict(compression="group3",
                                 tiffinfo={292: 5, 278: 20})),
            ("g4", dict(compression="group4", tiffinfo={278: 20})),
            ("g4-fillorder2-miniswhite", dict(
                compression="group4", tiffinfo={266: 2, 262: 0})),
            ("ccitt-rle", dict(compression="tiff_ccitt")),
            ("ccitt-rlew", dict(compression="tiff_raw_16"))):
        yield f"tiff-{name}.tif", _pil(Image, bilevel, "TIFF", **kw)
    yield "tiff-zstd-pred2-rgb.tif", _pil(Image, Image.fromarray(rgb), "TIFF",
                                          compression="zstd",
                                          tiffinfo={317: 2})
    yield "tiff-zstd-i16.tif", _pil(Image, Image.fromarray(
        rgb[:, :, 0].astype(np.uint16) * 251 + 7), "TIFF", compression="zstd")
    yield "tiff-zstd-float-pred3.tif", _pil(Image, Image.fromarray(
        rgb[:, :, 2].astype(np.float32) / 3 - 20), "TIFF",
        compression="zstd", tiffinfo={317: 3})
    yield "tiff-lzma-grey.tif", _pil(Image, grey, "TIFF", compression="lzma")
    yield "tiff-lzma-tiled-rgb-bigendian.tif", tiff_coded(
        rgb.astype(np.uint16) * 257, 2, 34925,
        lambda b: lzma.compress(b.tobytes(), format=lzma.FORMAT_XZ),
        order=">", tile=(16, 16))
    yield "tiff-planar-deflate-rgb.tif", pil_planes(rgb, 2,
                                                    "tiff_adobe_deflate", 8)
    yield "tiff-planar-lzw-rgba.tif", pil_planes(rgba, 2, "tiff_lzw", 10, 2,
                                                 extra=(2,))
    yield "tiff-planar-zstd-rgb.tif", pil_planes(rgb, 2, "zstd", 23, 2)
    yield "tiff-planar-deflate-tiled-rgb16.tif", tiff_coded(
        rgb.astype(np.uint16) * 257 + 3, 2, 8,
        lambda b: zlib.compress(b.tobytes()), planar=2, tile=(16, 16))
    i12 = (rgb[:, :, :1].astype(np.uint16) * 16 + rgb[:, :, 1:2] % 16)
    yield "tiff-i12-raw.tif", tiff_coded(i12, 1, 1, pack12, rows=8, bits=12)
    yield "tiff-i12-deflate.tif", tiff_coded(
        i12, 1, 8, lambda b: zlib.compress(pack12(b)), rows=8, bits=12)
    yield "tiff-thunderscan.tif", tiff_coded(
        rgb[:, :, :1] // 16, 1, 32809, lambda b: thunderscan(b[:, :, 0], rng),
        rows=8, bits=4)
    yield "tiff-ycbcr-lzw.tif", _pil(Image, Image.fromarray(rgb).convert(
        "YCbCr"), "TIFF", compression="tiff_lzw")
    yield "tiff-ycbcr-sub42-tiled.tif", tiff_coded(
        rgb, 6, 8, lambda b: zlib.compress(ycbcr_blocks(b, 4, 2)),
        tile=(16, 16), tags=[(530, 3, [4, 2])])
    yield "refuse-tiff-webp.tif", tiff_coded(
        rgb, 2, 50001, lambda b: b"RIFF" + bytes(12) + b.tobytes()[:40])
    yield "refuse-tiff-sgilog-grey.tif", tiff_coded(
        rgb[:, :, :1].astype(np.uint16), 1, 34676, lambda b: b.tobytes())
    yield "refuse-tiff-sgilog-logluv.tif", tiff_coded(
        rgb, 32845, 34677, lambda b: b.tobytes())


def pil_fixtures():
    """One small PIL-made (or, where PIL writes none, hand-made) file of
    each format and mode ``decode_png`` / ``decode_jpeg`` reach, odd
    sizes and 1x1 among them, and refusals of each failure class."""
    from PIL import Image
    rng = np.random.RandomState(16)
    rgb = chip(16, 21, 17)
    grey = chip(17, 21, 17, 1)[:, :, 0]
    rgba = np.dstack([rgb, chip(18, 21, 17, 1)])
    sq = chip(20, 32, 32)
    one = chip(21, 1, 1)
    im, g = Image.fromarray(rgb), Image.fromarray(grey)
    pal = im.convert("P", palette=Image.ADAPTIVE, colors=37)
    i16 = Image.fromarray((grey.astype(np.uint16) * 257 + 3))
    # WebP
    yield "webp-lossless-rgb.webp", _pil(Image, im, "WEBP", lossless=True)
    yield "webp-lossy-rgb.webp", _pil(Image, im, "WEBP", quality=80)
    yield "webp-lossy-q10-32.webp", _pil(Image, Image.fromarray(sq), "WEBP",
                                         quality=10)
    yield "webp-lossy-1x1.webp", _pil(Image, Image.fromarray(one), "WEBP",
                                      quality=90)
    yield "webp-lossless-1x1.webp", _pil(Image, Image.fromarray(one), "WEBP",
                                         lossless=True)
    yield "webp-lossless-rgba.webp", _pil(Image, Image.fromarray(rgba),
                                          "WEBP", lossless=True)
    yield "webp-lossy-rgba.webp", _pil(Image, Image.fromarray(rgba), "WEBP",
                                       quality=70)
    yield "webp-icc.webp", _pil(Image, im, "WEBP", quality=60,
                                icc_profile=b"\0" * 64)
    frames = [Image.fromarray(chip(30 + k, 21, 17)) for k in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:],
                   duration=50, quality=50)
    yield "webp-animated.webp", buf.getvalue()
    # TIFF
    yield "tiff-raw-rgb.tif", _pil(Image, im, "TIFF")
    yield "tiff-lzw-rgb.tif", _pil(Image, im, "TIFF", compression="tiff_lzw")
    yield "tiff-deflate-grey.tif", _pil(Image, g, "TIFF",
                                        compression="tiff_deflate")
    yield "tiff-packbits-grey.tif", _pil(Image, g, "TIFF",
                                         compression="packbits")
    yield "tiff-jpeg-rgb.tif", _pil(Image, im, "TIFF", compression="jpeg",
                                    quality=75)
    yield "tiff-jpeg-ycbcr.tif", _pil(Image, im.convert("YCbCr"), "TIFF",
                                      compression="jpeg", quality=75)
    yield "tiff-jpeg-grey.tif", _pil(Image, g, "TIFF", compression="jpeg")
    yield "tiff-bilevel.tif", _pil(Image, g.point(lambda v: 255 * (v > 128))
                                   .convert("1"), "TIFF")
    yield "tiff-miniswhite.tif", tiff(grey[:, :, None], 0)
    yield "tiff-palette.tif", _pil(Image, pal, "TIFF")
    yield "tiff-i16.tif", _pil(Image, i16, "TIFF")
    yield "tiff-i16-bigendian.tif", tiff(np.asarray(i16)[:, :, None], 1, ">")
    yield "tiff-int32.tif", _pil(Image, Image.fromarray(
        grey.astype(np.int32) * 70000 - 5), "TIFF")
    yield "tiff-int16.tif", tiff((grey.astype(np.int16) * 100 - 9000)
                                 [:, :, None], 1)
    yield "tiff-float32.tif", _pil(Image, Image.fromarray(
        grey.astype(np.float32) / 7), "TIFF")
    yield "tiff-la.tif", _pil(Image, Image.fromarray(rgba[:, :, ::2]), "TIFF")
    yield "tiff-cmyk.tif", _pil(Image, im.convert("CMYK"), "TIFF")
    yield "tiff-rgb16.tif", tiff(rgb.astype(np.uint16) * 257, 2)
    yield "tiff-tiled-rgb.tif", tiff(rgb, 2, tile=(16, 16))
    yield "tiff-orientation-6.tif", tiff(rgb, 2, orientation=6)
    yield "tiff-1x1.tif", _pil(Image, Image.fromarray(one), "TIFF")
    from dl_image_segmentation_tpu.raster.geotiff import encode_geotiff
    yield "tiff-chip-lzw-tiled-grey.tif", encode_geotiff(grey, tile_size=16)
    yield "refuse-tiff-3band-uint16.tif", tiff(rgb.astype(np.uint16), 1)
    yield "refuse-tiff-4band-no-extrasamples.tif", tiff(rgba, 1)
    yield "refuse-tiff-13band.tif", encode_geotiff(
        (chip(22, 8, 8, 13).astype(np.uint16) * 9), tile_size=16)
    # TIFF as libtiff decodes it: CCITT, zstd, LZMA, ThunderScan, separate
    # planes, 12-bit grey, and the codecs this libtiff refuses
    yield from tiff_codec_fixtures()
    # PPM family
    yield "ppm-rgb.ppm", _pil(Image, im, "PPM")
    yield "ppm-grey.pgm", _pil(Image, g, "PPM")
    yield "ppm-bilevel.pbm", _pil(Image, g.convert("1"), "PPM")
    yield "ppm-16bit.pgm", _pil(Image, i16, "PPM")
    yield "ppm-maxval-1000.pgm", b"P5 17 21 1000\n" + (
        grey.astype(">u2") * 3).tobytes()
    yield "ppm-maxval-15.ppm", b"P6\n17 21\n15\n" + (rgb // 17).tobytes()
    yield "ppm-float.pfm", _pil(Image, Image.fromarray(
        grey.astype(np.float32) / 3), "PPM")
    yield "ppm-plain-p1.pbm", plain_pnm(b"P1", (grey > 128).astype(int))
    yield "ppm-plain-p2.pgm", plain_pnm(b"P2", grey)
    yield "ppm-plain-p3.ppm", plain_pnm(b"P3", rgb // 5, 51)
    yield "ppm-1x1.ppm", _pil(Image, Image.fromarray(one), "PPM")
    # TGA
    yield "tga-rgb.tga", _pil(Image, im, "TGA")
    yield "tga-rle-rgb.tga", _pil(Image, im, "TGA", compression="tga_rle")
    yield "tga-palette.tga", _pil(Image, pal, "TGA")
    yield "tga-grey.tga", _pil(Image, g, "TGA")
    yield "tga-rle-grey.tga", _pil(Image, g, "TGA", compression="tga_rle")
    yield "tga-la.tga", _pil(Image, Image.fromarray(rgba[:, :, ::2]), "TGA")
    yield "tga-topleft.tga", _pil(Image, im, "TGA", orientation=1)
    yield "tga-rgba.tga", _pil(Image, Image.fromarray(rgba), "TGA")
    # SGI
    yield "sgi-rgb.sgi", _pil(Image, im, "SGI")
    yield "sgi-grey.bw", _pil(Image, g, "SGI")
    yield "sgi-rgb-16bit.sgi", _pil(Image, im, "SGI", bpc=2)
    yield "sgi-rle-rgb.sgi", sgi_rle(rgb)
    yield "sgi-rle-grey-16bit.sgi", sgi_rle(
        grey[:, :, None].astype(np.uint16) * 257, 2)
    yield "sgi-rgba.sgi", _pil(Image, Image.fromarray(rgba), "SGI")
    # PCX
    yield "pcx-rgb.pcx", _pil(Image, im, "PCX")
    yield "pcx-grey.pcx", _pil(Image, g, "PCX")
    yield "pcx-palette.pcx", _pil(Image, pal, "PCX")
    yield "pcx-bilevel.pcx", _pil(Image, g.convert("1"), "PCX")
    # QOI
    yield "qoi-rgb.qoi", _pil(Image, im, "QOI")
    yield "qoi-rgba.qoi", _pil(Image, Image.fromarray(rgba), "QOI")
    yield "qoi-1x1.qoi", _pil(Image, Image.fromarray(one), "QOI")
    # ICO / CUR
    sq_im = Image.fromarray(sq)
    yield "ico-png.ico", _pil(Image, sq_im, "ICO", sizes=[(32, 32)])
    yield "ico-sizes.ico", _pil(Image, sq_im, "ICO",
                                sizes=[(16, 16), (24, 24), (32, 32)])
    ico_bmp = _pil(Image, sq_im, "ICO", sizes=[(32, 32)],
                   bitmap_format="bmp")
    yield "ico-bmp.ico", ico_bmp
    yield "ico-bmp-palette.ico", _pil(Image, sq_im.convert(
        "P", palette=Image.ADAPTIVE, colors=16), "ICO", sizes=[(32, 32)],
        bitmap_format="bmp")
    yield "cur-bmp.cur", ico_bmp[:2] + b"\2" + ico_bmp[3:]
    # IM
    for mode, name in (("RGB", "rgb"), ("L", "grey"), ("P", "palette"),
                       ("F", "float"), ("I", "int32"), ("LA", "la"),
                       ("1", "bilevel")):
        src = {"P": pal, "F": Image.fromarray(grey.astype(np.float32) / 3),
               "I": Image.fromarray(grey.astype(np.int32) * 9),
               "LA": Image.fromarray(rgba[:, :, ::2])}.get(mode)
        yield f"im-{name}.im", _pil(Image, src or im.convert(mode), "IM")
    yield "im-i16.im", _pil(Image, i16, "IM")
    # XBM
    yield "xbm-bilevel.xbm", _pil(Image, g.convert("1"), "XBM")
    yield "xbm-hotspot.xbm", _pil(Image, g.convert("1"), "XBM",
                                  hotspot=(3, 4))
    # DDS
    yield "dds-rgb.dds", _pil(Image, im, "DDS")
    yield "dds-rgba.dds", _pil(Image, Image.fromarray(rgba), "DDS")
    yield "dds-grey.dds", _pil(Image, g, "DDS")
    yield "dds-la.dds", _pil(Image, Image.fromarray(rgba[:, :, ::2]), "DDS")
    for fmt in ("DXT1", "DXT3", "DXT5", "BC2", "BC3"):
        yield f"dds-{fmt.lower()}.dds", _pil(Image, Image.fromarray(rgba),
                                            "DDS", pixel_format=fmt)
    yield "dds-bc5.dds", _pil(Image, im, "DDS", pixel_format="BC5")
    yield "dds-bc4.dds", dds_bc4(21, 17, rng)
    # the other containers and codecs, and the failure classes
    yield "png-rgb.png", _pil(Image, im, "PNG")
    yield "jpeg-rgb.jpg", _pil(Image, im, "JPEG", quality=80)
    yield "gif-rgb.gif", _pil(Image, im, "GIF")
    yield "bmp-rgb.bmp", _pil(Image, im, "BMP")
    png = _pil(Image, im, "PNG")
    yield "refuse-truncated-png.png", png[:len(png) // 2]
    jpg = _pil(Image, im, "JPEG", quality=80)
    yield "refuse-truncated-jpeg.jpg", jpg[:len(jpg) // 2]
    yield "refuse-jpeg-header-only.jpg", jpg[:20]
    bmp = _pil(Image, im, "BMP")
    yield "refuse-truncated-bmp.bmp", bmp[:len(bmp) // 2]
    webp = _pil(Image, im, "WEBP", quality=80)
    yield "refuse-truncated-webp.webp", webp[:len(webp) // 2]
    yield "refuse-unidentified-random.bin", rng.randint(
        0, 256, 300).astype(np.uint8).tobytes()
    yield "refuse-unidentified-zeros.bin", bytes(64)
    yield "refuse-unidentified-text.txt", b"hello, world\n" * 8
    yield "refuse-bomb.ppm", b"P6 20000 20000 255\n" + bytes(16)
    yield "refuse-maxval.pgm", b"P5 4 4 70000\n" + bytes(32)
    yield "refuse-sgi-mode.sgi", bytes(bytearray(b"\x01\xda\x00\x01\x00\x05"
                                                 ) + bytes(506))
    yield "refuse-grib-stub.grb", b"GRIB\0\0\0\x01" + bytes(40)
    two = _two_idat(png)
    yield "refuse-png-bad-chunk.png", two[:two.index(b"IDAT", 60)] + \
        b"I\x01AT" + two[two.index(b"IDAT", 60) + 4:]
    # 128 px RGB chips of one field, a format each: the chip path's
    # records, training and decode rates on the card's host
    c128 = chip(160, noise=0.0)
    big = Image.fromarray(c128)
    yield "chip128-webp-lossless.webp", _pil(Image, big, "WEBP",
                                             lossless=True)
    yield "chip128-webp-lossy.webp", _pil(Image, big, "WEBP", quality=80)
    yield "chip128-tiff-lzw.tif", _pil(Image, big, "TIFF",
                                       compression="tiff_lzw")
    yield "chip128-tiff-jpeg.tif", _pil(Image, big, "TIFF",
                                        compression="jpeg", quality=90)
    yield "chip128-tiff-zstd-planar.tif", pil_planes(c128, 2, "zstd", 32, 2)
    yield "chip128-ppm.ppm", _pil(Image, big, "PPM")
    yield "chip128-tga-rle.tga", _pil(Image, big, "TGA",
                                      compression="tga_rle")
    yield "chip128-pcx.pcx", _pil(Image, big, "PCX")
    yield "chip128-qoi.qoi", _pil(Image, big, "QOI")


def _two_idat(png: bytes) -> bytes:
    """The PNG with its image data split over two IDAT chunks."""
    import zlib
    i = png.index(b"IDAT") - 4
    (n,) = struct.unpack(">I", png[i:i + 4])
    body = png[i + 8:i + 8 + n]

    def chunk(t, b):
        return struct.pack(">I", len(b)) + t + b + struct.pack(
            ">I", zlib.crc32(t + b))
    return (png[:i] + chunk(b"IDAT", body[:n // 2])
            + chunk(b"IDAT", body[n // 2:]) + png[i + 12 + n:])


def jax_pil_outcome(data: bytes) -> dict:
    """The JAX package's ``decode_jpeg`` (PIL's decode): the array, or
    the class name and message of what it raises."""
    from dl_image_segmentation_tpu.raster import image as jimage
    try:
        arr = jimage.decode_jpeg(data)
    except Exception as e:  # noqa: BLE001 -- the outcome is the fixture
        return {"error_class": np.array(type(e).__name__),
                "error_prefix": np.array(str(e))}
    return {"array": arr}


# ------------------------------------------------------------- corrupt TIFF

CORRUPT_SEED = 7
CORRUPT_FILES = 60
CORRUPT_TABLE = os.path.join(HERE, "tiff_corrupt_outcomes.json")
# compressions and the photometric whose strip data the corpus leaves out
# (CCITT, JPEG and YCbCr): in those files only flips outside the strip or
# tile bytes and the JPEGTables value count
_STRIP_DATA_LEFT = {2, 3, 4, 32771, 6, 7}


def corrupt_fixtures(pil_dir: str = os.path.join(HERE, "pil")) -> list:
    """The committed TIFF fixtures the corpus flips, in name order."""
    return sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(pil_dir, "*.tif"))
        if not os.path.basename(p).startswith("refuse-"))


def corrupt_tiffs(pil_dir: str = os.path.join(HERE, "pil")):
    """The seeded corrupt TIFF corpus: one numpy ``default_rng(7)`` over
    the fixtures in name order, ``CORRUPT_FILES`` files each, every file
    with 1 to 3 bits flipped past byte 8. Yields (fixture, index, bytes,
    flipped byte offsets)."""
    rng = np.random.default_rng(CORRUPT_SEED)
    for name in corrupt_fixtures(pil_dir):
        with open(os.path.join(pil_dir, name), "rb") as f:
            clean = f.read()
        for i in range(CORRUPT_FILES):
            b = bytearray(clean)
            at = []
            for _ in range(int(rng.integers(1, 4))):
                pos = int(rng.integers(8, len(b)))
                b[pos] ^= 1 << int(rng.integers(8))
                at.append(pos)
            yield name, i, bytes(b), at


def corrupt_scope(clean: bytes):
    """Of a clean fixture: None when every flip counts, else the byte
    spans a counted flip must miss (its strips or tiles and its
    JPEGTables value, for CCITT, JPEG and YCbCr files)."""
    e = "<" if clean[:2] == b"II" else ">"
    (ifd,) = struct.unpack(e + "L", clean[4:8])
    (n,) = struct.unpack(e + "H", clean[ifd:ifd + 2])
    size = {1: 1, 2: 1, 3: 2, 4: 4, 7: 1}
    vals, where = {}, {}
    for k in range(n):
        p = ifd + 2 + 12 * k
        tag, typ, cnt = struct.unpack(e + "HHL", clean[p:p + 8])
        nbytes = size.get(typ, 1) * cnt
        at = p + 8 if nbytes <= 4 else struct.unpack(
            e + "L", clean[p + 8:p + 12])[0]
        where[tag] = (at, at + nbytes)
        if typ in (3, 4):
            vals[tag] = struct.unpack(e + "HL"[typ == 4] * cnt,
                                      clean[at:at + nbytes])
    if vals.get(259, (1,))[0] not in _STRIP_DATA_LEFT and \
            vals.get(262, (0,))[0] != 6:
        return None
    spans = [where[347]] if 347 in where else []
    for offs, cnts in ((273, 279), (324, 325)):
        spans += [(o, o + c) for o, c in zip(vals.get(offs, ()),
                                             vals.get(cnts, ()))]
    return spans


def corrupt_counted(clean_scope, at) -> bool:
    """Whether a file of flips ``at`` is held to the JAX outcome."""
    return clean_scope is None or not any(
        lo <= p < hi for p in at for lo, hi in clean_scope)


def libtiff_leaves_unwritten(data: bytes, tmp: str) -> bool:
    """Whether PIL's libtiff, reading the file's strips or tiles, leaves
    bits of a block it reports read, that PIL unpacks, unwritten: a CCITT
    strip that ends early decodes its first rows only, and PIL's strip
    buffer is not cleared, so PIL's image holds whatever that memory held
    before. Each block is read twice, over buffers of 0x00 and of 0xFF,
    and the bits of each row's pixels compared."""
    from PIL import Image
    Image.core  # noqa: B018 -- loads PIL's libtiff
    lib = ctypes.CDLL(pillow_lib("libtiff-*.so*"))
    lib.TIFFOpen.restype = ctypes.c_void_p
    lib.TIFFOpen.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.TIFFClose.argtypes = [ctypes.c_void_p]
    quiet = ctypes.CFUNCTYPE(None, ctypes.c_char_p, ctypes.c_char_p,
                             ctypes.c_void_p)(lambda *a: None)
    for fn in (lib.TIFFSetErrorHandler, lib.TIFFSetWarningHandler):
        fn.restype = ctypes.c_void_p
        fn.argtypes = [ctypes.c_void_p]
    old = (lib.TIFFSetErrorHandler(ctypes.cast(quiet, ctypes.c_void_p)),
           lib.TIFFSetWarningHandler(ctypes.cast(quiet, ctypes.c_void_p)))
    path = os.path.join(tmp, "unwritten.tif")
    with open(path, "wb") as f:
        f.write(data)
    tif = lib.TIFFOpen(path.encode(), b"rC")
    try:
        if not tif:
            return False
        tiled = lib.TIFFIsTiled(ctypes.c_void_p(tif))
        count, size, read = (
            (lib.TIFFNumberOfTiles, lib.TIFFTileSize, lib.TIFFReadEncodedTile)
            if tiled else (lib.TIFFNumberOfStrips, lib.TIFFStripSize,
                           lib.TIFFReadEncodedStrip))
        for fn in (count, size):
            fn.argtypes = [ctypes.c_void_p]
        count.restype, size.restype = ctypes.c_uint32, ctypes.c_ssize_t
        read.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p,
                         ctypes.c_ssize_t]
        read.restype = ctypes.c_ssize_t
        field = lib.TIFFGetFieldDefaulted
        field.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p]
        v16 = {t: ctypes.c_uint16(0) for t in (258, 277, 284)}
        width = ctypes.c_uint32(0)
        for t, v in v16.items():
            field(tif, t, ctypes.byref(v))
        field(tif, 322 if tiled else 256, ctypes.byref(width))
        bits = width.value * v16[258].value * (
            v16[277].value if v16[284].value == 1 else 1)
        n = size(tif)
        for k in range(min(count(tif), 4096)):
            got = []
            for fill in (b"\x00", b"\xff"):
                buf = ctypes.create_string_buffer(fill * n, n)
                m = read(tif, k, buf, -1)
                got.append(np.unpackbits(np.frombuffer(buf.raw[:max(m, 0)],
                                                       np.uint8)))
            row = 8 * ((bits + 7) // 8)
            rows = len(got[0]) // row if row else 0
            a, b = (g[:rows * row].reshape(rows, row) for g in got)
            if (a[:, :bits] != b[:, :bits]).any():
                return True
        return False
    finally:
        if tif:
            lib.TIFFClose(tif)
        lib.TIFFSetErrorHandler(old[0])
        lib.TIFFSetWarningHandler(old[1])


def corrupt_outcome(data: bytes, tmp: str):
    """The JAX package's ``decode_jpeg`` outcome as the table holds it:
    ["array", dtype, shape, sha256], ["shape", dtype, shape] where PIL's
    array holds memory libtiff never wrote, or ["error", class, message
    prefix]."""
    import hashlib
    import re
    from dl_image_segmentation_tpu.raster import image as jimage
    try:
        arr = jimage.decode_jpeg(data)
    except Exception as e:  # noqa: BLE001 -- the outcome is the table
        name = type(e).__name__
        return ["error", name, "" if name == "AssertionError"
                else re.split(r"[(<]", str(e))[0].strip()]
    if libtiff_leaves_unwritten(data, tmp):
        return ["shape", arr.dtype.str, list(arr.shape)]
    return ["array", arr.dtype.str, list(arr.shape),
            hashlib.sha256(arr.tobytes()).hexdigest()]


def write_corrupt_table():
    """``tiff_corrupt_outcomes.json``: each counted file's outcome, None
    for the files not counted."""
    import json
    import warnings
    warnings.simplefilter("ignore")
    table, scopes = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, i, data, at in corrupt_tiffs():
            if name not in scopes:
                with open(os.path.join(HERE, "pil", name), "rb") as f:
                    scopes[name] = corrupt_scope(f.read())
            table.setdefault(name, []).append(
                corrupt_outcome(data, tmp)
                if corrupt_counted(scopes[name], at) else None)
    with open(CORRUPT_TABLE, "w") as f:
        json.dump({"seed": CORRUPT_SEED, "files": CORRUPT_FILES,
                   "outcomes": table}, f, separators=(",", ":"))
        f.write("\n")
    print(CORRUPT_TABLE, sum(v is not None for o in table.values()
                             for v in o), "outcomes")


def corrupt_part(clean: bytes) -> str:
    """The part of the port a fixture's strip data exercises: "CCITT",
    "JPEG", "YCbCr" (libtiff's RGBA reader) or "other"."""
    e = "<" if clean[:2] == b"II" else ">"
    (ifd,) = struct.unpack(e + "L", clean[4:8])
    (n,) = struct.unpack(e + "H", clean[ifd:ifd + 2])
    tags = {}
    for k in range(n):
        p = ifd + 2 + 12 * k
        tag, typ = struct.unpack(e + "HH", clean[p:p + 4])
        if tag in (259, 262) and typ == 3:
            tags[tag] = struct.unpack(e + "H", clean[p + 8:p + 10])[0]
    comp, photo = tags.get(259, 1), tags.get(262, 0)
    if comp in (2, 3, 4, 32771):
        return "CCITT"
    if comp in (6, 7):
        return "JPEG"
    return "YCbCr" if photo == 6 else "other"


def corrupt_probe():
    """Prints how many files of the corpus the port's ``decode_jpeg``
    decodes otherwise than the JAX package's (bits, dtype and shape, or
    class and message prefix): in the fixtures whose every flip counts,
    in the others' counted files, and in their strip data by part."""
    import collections
    import re
    import warnings
    warnings.simplefilter("ignore")
    from dl_image_segmentation_tpu.raster import image as jimage
    from dl_image_segmentation_tpu_torch.raster import image as timage

    def outcome(fn, data):
        try:
            a = fn(data)
            return a.dtype.str, a.shape, a.tobytes()
        except Exception as e:  # noqa: BLE001 -- the outcome is compared
            name = type(e).__name__
            return name, "" if name == "AssertionError" else re.split(
                r"[(<]", str(e))[0].strip()

    count, parts, unwritten = collections.Counter(), collections.Counter(), 0
    total = 0
    with tempfile.TemporaryDirectory() as tmp:
        for name, _i, data, at in corrupt_tiffs():
            with open(os.path.join(HERE, "pil", name), "rb") as f:
                clean = f.read()
            scope = corrupt_scope(clean)
            total += 1
            if outcome(jimage.decode_jpeg, data) == outcome(
                    timage.decode_jpeg, data):
                continue
            if scope is None:
                count["every flip counts"] += 1
            elif corrupt_counted(scope, at):
                count["counted, outside strip data"] += 1
                unwritten += libtiff_leaves_unwritten(data, tmp)
            else:
                parts[corrupt_part(clean)] += 1
    print(f"{sum(count.values()) + sum(parts.values())} of {total} differ:",
          dict(count), f"({unwritten} where libtiff leaves pixels "
          "unwritten);", "strip data:", dict(parts))


# ------------------------------------------------------------- all


def jax_outcome(data: bytes) -> dict:
    from dl_image_segmentation_tpu.raster import image as jimage
    try:
        arr = jimage.decode_image_bytes(data).array
    except Exception as e:  # noqa: BLE001 -- the outcome is the fixture
        return {"error_class": np.array(type(e).__name__),
                "error_prefix": np.array(str(e).split(";")[0])}
    return {"array": arr}


def write_pil_fixtures():
    """``tests/data/pil``: each file beside the JAX package's
    ``decode_jpeg`` outcome."""
    out = os.path.join(HERE, "pil")
    os.makedirs(out, exist_ok=True)
    for name, data in pil_fixtures():
        path = os.path.join(out, name)
        with open(path, "wb") as f:
            f.write(data)
        np.savez_compressed(os.path.splitext(path)[0] + ".npz",
                            **jax_pil_outcome(data))
        print(path, len(data))


def main():
    sys.path.insert(0, ROOT)
    if sys.argv[1:] == ["pil"]:
        write_pil_fixtures()
        return
    if sys.argv[1:] == ["pil-corrupt"]:
        write_corrupt_table()
        return
    if sys.argv[1:] == ["pil-corrupt-probe"]:
        corrupt_probe()
        return
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
