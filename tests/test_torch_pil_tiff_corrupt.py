"""Corrupt TIFFs through the port's ``decode_jpeg`` against the JAX
package's (PIL 12.1 over libtiff 4.7), on the CPU: the array, its dtype
and byte order, bitwise, or the class and message prefix.

* The seeded corpus of ``tests/data/make_codec_fixtures.py``
  (``corrupt_tiffs``: numpy ``default_rng(7)``, 60 files a fixture, each
  with 1 to 3 bits flipped past byte 8, over every committed TIFF that is
  not a ``refuse-*``), one case a fixture. Every file counts, except in
  the CCITT, JPEG and YCbCr fixtures, where a file counts only if its
  flips miss the strip or tile bytes and the JPEGTables value
  (``corrupt_scope``): the directory as PIL and libtiff read it, which
  every codec shares. Where libtiff leaves pixels of a block it reports
  read unwritten (a CCITT strip that ends early), PIL's array holds
  memory it never cleared; there the port's array has PIL's dtype and
  shape. The committed ``tests/data/tiff_corrupt_outcomes.json``, which
  the card's host checks the port against, is held to the JAX outcome.
* zstd strips: ``storage/zstd.py`` against libzstd 1.5.7 (PIL's bundled
  ``libzstd``, through ctypes in this file only), one-shot and as
  libtiff streams a strip, on seeded flips and cuts of the zstd
  fixtures' strips and of frames whose literals take libzstd's
  double-symbol Huffman tables.
* LZMA strips: the port's reading against libtiff's ``LZMADecode`` over
  PIL's bundled ``liblzma``, on seeded flips of the LZMA fixtures' strips.
* The MT engine over a chip folder of corrupt TIFF chips writes the JAX
  engine's records and skip lines.

Nothing here compiles XLA.
"""

import ctypes
import functools
import glob
import hashlib
import importlib.util
import json
import lzma
import os
import re
import struct

import numpy as np
import pytest
import torch

from dl_image_segmentation_tpu.raster import image as jimage
from dl_image_segmentation_tpu.records import writers as jwriters
from dl_image_segmentation_tpu_torch.raster import image as timage
from dl_image_segmentation_tpu_torch.raster import libtiff_dir, pil_tiff
from dl_image_segmentation_tpu_torch.records import writers as twriters
from dl_image_segmentation_tpu_torch.storage import zstd

# one intra-op thread: the test workers share the host's cores
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
PIL_DATA = os.path.join(DATA, "pil")


def _generator():
    spec = importlib.util.spec_from_file_location(
        "make_codec_fixtures", os.path.join(DATA, "make_codec_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


gen = _generator()
FIXTURES = gen.corrupt_fixtures()


@functools.lru_cache(maxsize=None)
def corpus():
    """{fixture: [(bytes, counted)]} of the seeded corpus."""
    out, scopes = {}, {}
    for name, _i, data, at in gen.corrupt_tiffs():
        if name not in scopes:
            scopes[name] = gen.corrupt_scope(read(name))
        out.setdefault(name, []).append(
            (data, gen.corrupt_counted(scopes[name], at)))
    return out


def read(name: str) -> bytes:
    with open(os.path.join(PIL_DATA, name), "rb") as f:
        return f.read()


def outcome(fn, data):
    """(array,) or (class name, message up to the first "(" or "<"); an
    AssertionError's message is not compared (the JAX package's assert
    has none)."""
    try:
        return (fn(data),)
    except Exception as e:  # noqa: BLE001 -- the outcome is compared
        name = type(e).__name__
        return name, "" if name == "AssertionError" else \
            re.split(r"[(<]", str(e))[0].strip()


def test_corpus_is_the_seeded_probe():
    """46 fixtures, 60 files each, 2,102 of them counted; the table
    covers the counted ones."""
    assert len(FIXTURES) == 46
    files = corpus()
    assert all(len(v) == 60 for v in files.values())
    assert sum(c for v in files.values() for _d, c in v) == 2102
    with open(gen.CORRUPT_TABLE) as f:
        table = json.load(f)
    assert (table["seed"], table["files"]) == (7, 60)
    for name in FIXTURES:
        assert [o is not None for o in table["outcomes"][name]] == \
            [c for _d, c in files[name]], name


@pytest.mark.parametrize("name", FIXTURES)
def test_corrupt_tiff_gets_the_jax_outcome(name, tmp_path):
    with open(gen.CORRUPT_TABLE) as f:
        table = json.load(f)["outcomes"][name]
    for i, (data, count) in enumerate(corpus()[name]):
        if not count:
            continue
        want = outcome(jimage.decode_jpeg, data)
        got = outcome(timage.decode_jpeg, data)
        what = (name, i)
        if len(want) == 2:
            assert got == want, what
            assert table[i] == ["error", *want], what
            continue
        w = want[0]
        assert len(got) == 1, (what, got)
        g = got[0]
        assert (g.dtype.str, g.shape) == (w.dtype.str, w.shape), what
        if table[i][0] == "shape":
            # PIL's array holds memory libtiff never wrote
            assert gen.libtiff_leaves_unwritten(data, str(tmp_path)), what
            continue
        assert g.tobytes() == w.tobytes(), what
        assert table[i] == ["array", w.dtype.str, list(w.shape),
                            hashlib.sha256(w.tobytes()).hexdigest()], what


# ------------------------------------------------------------ zstd / LZMA


def _strips(names):
    """The strips (or tiles) of clean fixtures, as libtiff reads them."""
    out = []
    for name in names:
        data = read(name)
        e = "<" if data[:2] == b"II" else ">"
        (first,) = struct.unpack(e + "L", data[4:8])
        d = libtiff_dir.read_directory(data, first, e, False)
        out += [data[o:o + c] for o, c in zip(d.offsets, d.counts)]
    return out


def _mutants(raw: bytes, rng, n: int):
    for k in range(n):
        b = bytearray(raw)
        for _ in range(int(rng.integers(1, 4))):
            b[int(rng.integers(0, len(b)))] ^= 1 << int(rng.integers(8))
        if k % 5 == 4:
            b = b[:int(rng.integers(1, len(b) + 1))]
        yield bytes(b)


class _Buf(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


def _libzstd():
    lib = ctypes.CDLL(gen.pillow_lib("libzstd-*.so*"))
    lib.ZSTD_decompress.restype = ctypes.c_size_t
    lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                    ctypes.c_char_p, ctypes.c_size_t]
    lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
    lib.ZSTD_createDStream.restype = ctypes.c_void_p
    lib.ZSTD_initDStream.argtypes = [ctypes.c_void_p]
    lib.ZSTD_freeDStream.argtypes = [ctypes.c_void_p]
    lib.ZSTD_decompressStream.restype = ctypes.c_size_t
    lib.ZSTD_decompressStream.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_void_p]
    return lib


def _zstd_oneshot(lib, raw: bytes, cap: int):
    out = ctypes.create_string_buffer(max(cap, 1))
    r = lib.ZSTD_decompress(out, cap, raw, len(raw))
    return None if lib.ZSTD_isError(r) else out.raw[:r]


def _zstd_libtiff(lib, raw: bytes, occ: int):
    """tif_zstd.c's ZSTDDecode: the strip, or None where it fails."""
    ds = lib.ZSTD_createDStream()
    lib.ZSTD_initDStream(ds)
    src = ctypes.create_string_buffer(raw, len(raw))
    out = ctypes.create_string_buffer(max(occ, 1))
    inb = _Buf(ctypes.addressof(src), len(raw), 0)
    outb = _Buf(ctypes.addressof(out), occ, 0)
    try:
        while True:
            r = lib.ZSTD_decompressStream(ds, ctypes.byref(outb),
                                          ctypes.byref(inb))
            if lib.ZSTD_isError(r):
                return None
            if not (r and inb.pos < inb.size and outb.pos < outb.size):
                break
        return out.raw[:occ] if outb.pos == occ else None
    finally:
        lib.ZSTD_freeDStream(ds)


def _skewed_frames(rng):
    """zstd frames of skewed bytes, whose 4-stream literals libzstd
    decodes with its double-symbol tables; one of three blocks, the later
    reusing the first's table."""
    import zstandard
    out = []
    for n, level in ((3000, 1), (20000, 19), (300000, 3)):
        p = rng.dirichlet(np.full(24, 0.3))
        data = rng.choice(24, n, p=p).astype(np.uint8).tobytes()
        out.append(zstandard.ZstdCompressor(level=level).compress(data))
    return out


def test_zstd_strips_read_as_libzstd():
    """``decompress`` against ``ZSTD_decompress`` into a buffer of the
    strip's size, and ``decompress_stream`` against libtiff's loop over
    ``ZSTD_decompressStream``: the same bytes, or both refuse. The
    fixtures' strips, and frames whose literals libzstd decodes with its
    double-symbol tables."""
    lib = _libzstd()
    rng = np.random.default_rng(21)
    decoded = refused = 0
    for raw in _strips([n for n in FIXTURES if "zstd" in n]) + \
            _skewed_frames(rng):
        size = len(_zstd_oneshot(lib, raw, 1 << 20))
        for bad in _mutants(raw, rng, 40):
            want = _zstd_oneshot(lib, bad, size)
            try:
                got = zstd.decompress(bad, size)
            except zstd.ZstdError:
                got = None
            assert got == want
            want = _zstd_libtiff(lib, bad, size)
            try:
                got = zstd.decompress_stream(bad, size)
            except zstd.ZstdError:
                got = None
            assert (got if got is not None and len(got) == size
                    else None) == want
            decoded += want is not None
            refused += want is None
    assert decoded > 100 and refused > 100, (decoded, refused)


class _Lzma(ctypes.Structure):
    _fields_ = ([("next_in", ctypes.c_void_p),
                 ("avail_in", ctypes.c_size_t),
                 ("total_in", ctypes.c_uint64),
                 ("next_out", ctypes.c_void_p),
                 ("avail_out", ctypes.c_size_t),
                 ("total_out", ctypes.c_uint64),
                 ("allocator", ctypes.c_void_p),
                 ("internal", ctypes.c_void_p)]
                + [(f"r{i}", ctypes.c_void_p) for i in range(4)]
                + [(f"u{i}", ctypes.c_uint64) for i in range(4)]
                + [(f"s{i}", ctypes.c_size_t) for i in range(2)]
                + [(f"e{i}", ctypes.c_int) for i in range(2)])


def _lzma_libtiff(lib, raw: bytes, occ: int):
    """tif_lzma.c's LZMADecode: liblzma's run into the strip, which
    stops at the stream's end or an error; the strip, or None where it is
    not full."""
    s = _Lzma()
    assert lib.lzma_stream_decoder(ctypes.byref(s), ctypes.c_uint64(
        2 ** 64 - 1), ctypes.c_uint32(0)) == 0
    src = ctypes.create_string_buffer(raw, len(raw))
    out = ctypes.create_string_buffer(occ)
    s.next_in, s.avail_in = ctypes.addressof(src), len(raw)
    s.next_out, s.avail_out = ctypes.addressof(out), occ
    try:
        while lib.lzma_code(ctypes.byref(s), 0) == 0 and s.avail_out:
            pass
        return out.raw if s.avail_out == 0 else None
    finally:
        lib.lzma_end(ctypes.byref(s))


def test_lzma_strips_read_as_libtiff():
    """The port's LZMA strip against libtiff's run of PIL's liblzma: the
    same bytes where the strip fills, a failure where it does not."""
    lib = ctypes.CDLL(gen.pillow_lib("liblzma-*.so*"))
    rng = np.random.default_rng(22)
    strips = _strips([n for n in FIXTURES if "lzma" in n]) + [
        lzma.compress(rng.integers(0, k, 3000, np.uint8).tobytes(),
                      check=check, filters=filters)
        for k, check, filters in (
            (4, lzma.CHECK_CRC32, None), (256, lzma.CHECK_CRC64, None),
            (16, lzma.CHECK_CRC64, [{"id": lzma.FILTER_DELTA, "dist": 3},
                                    {"id": lzma.FILTER_LZMA2}]))]
    full = cut = 0
    for raw in strips:
        size = len(lzma.decompress(raw))
        for bad in _mutants(raw, rng, 60):
            want = _lzma_libtiff(lib, bad, size)
            got = pil_tiff._xz(bad, size)
            assert (got if len(got) == size else None) == want
            full += want is not None
            cut += want is None
    assert full > 40 and cut > 100, (full, cut)


# ------------------------------------------------------------- MT engine


def _chip_folder(root):
    """Chip pairs named like DLTile keys: flipped 128 px LZW, zstd and
    JPEG chips of the corpus that the JAX package decodes and that it
    refuses, named .jpg and .png, PNG labels."""
    rng = np.random.RandomState(12)
    for sub in ("images", "labels"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    files = []
    for name in ("chip128-tiff-lzw.tif", "chip128-tiff-zstd-planar.tif",
                 "chip128-tiff-jpeg.tif"):
        kinds = {}
        for data, count in corpus()[name]:
            if not count:
                continue
            ok = len(outcome(jimage.decode_jpeg, data)) == 1
            if kinds.get(ok, 0) < (2 if ok else 1):
                kinds[ok] = kinds.get(ok, 0) + 1
                files.append(data)
    for i, data in enumerate(files):
        ext = "png" if i % 2 else "jpg"
        stem = f"128#2#10.0#43#{i}#3512"
        with open(os.path.join(root, "images", f"{stem}.{ext}"), "wb") as f:
            f.write(data)
        with open(os.path.join(root, "labels", f"{stem}.{ext}"), "wb") as f:
            f.write(timage.encode_png(rng.randint(0, 4, (128, 128)).astype(
                np.uint8)))
    return root, len(files)


def test_mt_engine_writes_the_jax_records_of_corrupt_chips(tmp_path,
                                                           capsys):
    """Decode mode (``store_as_array``) over corrupt TIFF chips: the JAX
    engine's record sets shard by shard, and its skip lines."""
    from dl_image_segmentation_tpu_torch.records import tfrecord
    chips, n = _chip_folder(str(tmp_path / "chips"))
    assert n >= 6
    outs, written, lines = [], [], []
    for writer in (twriters, jwriters):
        out = str(tmp_path / f"out-{writer.__name__}")
        written.append(writer.process_dataset_multithreaded(
            "p", chips, out, 2, num_threads=2, store_as_array=True))
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
