"""The port's JPEG 2000 codec and Sentinel-2 ``.SAFE`` ingestion against
the JAX package, on the CPU.

The JAX package decodes JP2/J2K through PIL's bundled OpenJPEG and
encodes through it; the port carries its own codec
(``csrc/host/j2k_decode.cc``, ``j2k_encode.cc``). Every comparison is
bitwise:

* decode and sniff of files PIL writes: grey, RGB with and without the
  colour transform, RGBA, LA, uint16, raw J2K, the five progression
  orders, precincts, code-block sizes, 1-6 resolutions, quality layers,
  rate-truncated 5/3, 9/7 at two rates, tiles that do not divide the
  image, image offsets, PLT and comment markers, 1xN and 7x13 images.
  Pillow 12.1's encoder writes wrong pixels into tiled 16-bit images, so
  the port is held to PIL's decode of the same bytes (what the JAX
  package returns), never to the array handed to PIL's encoder;
* PIL's unpacker rules for precisions other than 8 and 16 bits, pinned
  on files the port's encoder writes at those precisions;
* signed files: the JAX package raises (numpy 2 refuses its clip), the
  port returns the codestream's samples -- an intended difference;
* the port's encoder: PIL decodes its bytes to the input, its COD/QCD
  parameters are PIL's, and its GeoJP2/GMLJP2 boxes read back through
  the JAX package's sniffer;
* what PIL's encoder cannot write (every code-block style flag, SOP/EPH,
  PPT/PPM packed headers, POC, RGN): the port's encoder writes it, PIL
  decodes it to the source and the port's decoder equals PIL;
* ``ingest_safe`` and the ``ingest-safe`` CLI write the JAX package's
  index, and SAFE scenes load to the JAX package's arrays;
* the MP engine's ``--file-ext jp2`` shards (tifarr and raw), the tifraw
  parse and ``convert --file-ext jp2`` equal the JAX package's.
"""

import io
import json
import os
import struct

import numpy as np
import pytest
import torch
from PIL import Image

from dl_image_segmentation_tpu import cli as jcli
from dl_image_segmentation_tpu.catalog.local import (
    LocalCatalog as JLocalCatalog)
from dl_image_segmentation_tpu.geo import Tile as JTile
from dl_image_segmentation_tpu.pipeline.convert import (
    convert_chip_folder as j_convert)
from dl_image_segmentation_tpu.raster import image as jimage
from dl_image_segmentation_tpu.raster import jp2 as jjp2
from dl_image_segmentation_tpu.records import parsers as jparsers
from dl_image_segmentation_tpu.records import writers as jwriters
from dl_image_segmentation_tpu_torch import cli as tcli
from dl_image_segmentation_tpu_torch import storage
from dl_image_segmentation_tpu_torch.catalog import LocalCatalog
from dl_image_segmentation_tpu_torch.geo import Tile as TTile
from dl_image_segmentation_tpu_torch.pipeline.convert import (
    convert_chip_folder as t_convert)
from dl_image_segmentation_tpu_torch.raster import image as timage
from dl_image_segmentation_tpu_torch.raster import jp2 as tjp2
from dl_image_segmentation_tpu_torch.records import parsers as tparsers
from dl_image_segmentation_tpu_torch.records import tfrecord as ttfrecord
from dl_image_segmentation_tpu_torch.records import writers as twriters
from dl_image_segmentation_tpu_torch.storage.fake_gcs import FakeGCS

# one intra-op thread: the test workers share the host's cores
torch.set_num_threads(1)

ZONE = 43
TILE = (60, 2, 10.0, ZONE, -380, 3491)  # a tile key near Mumbai


def pil_jp2(arr: np.ndarray, **kw) -> bytes:
    """PIL's JPEG 2000 bytes of ``arr`` (uint16 as ``I;16``)."""
    if arr.dtype == np.uint16:
        img = Image.frombuffer("I;16", (arr.shape[1], arr.shape[0]),
                               np.ascontiguousarray(arr).tobytes(), "raw",
                               "I;16", 0, 1)
    else:
        img = Image.fromarray(arr)
    buf = io.BytesIO()
    img.save(buf, format="JPEG2000", **kw)
    return buf.getvalue()


def smooth(shape, dtype=np.uint8, seed=0):
    """A seeded image with structure at every scale: waves plus noise."""
    h, w = shape[:2]
    hi = np.iinfo(dtype).max
    y, x = np.mgrid[0:h, 0:w]
    base = (np.sin(x / 7.0) + np.cos(y / 5.0)) * 0.25 + 0.5
    if len(shape) == 3:
        base = np.stack([base * (0.5 + 0.5 * k / shape[2])
                         for k in range(shape[2])], -1)
    noise = np.random.RandomState(seed).randint(0, hi // 16 + 2, base.shape)
    return np.clip(base * hi * 0.9 + noise, 0, hi).astype(dtype)


GREY = smooth((70, 90))
RGB = smooth((64, 80, 3), seed=1)
LAYERS = dict(precinct_size=(32, 32), num_resolutions=4,
              quality_layers=[40, 10, 0])

FIXTURES = {
    "grey": lambda: pil_jp2(GREY),
    "rgb": lambda: pil_jp2(RGB),
    "rgb-mct": lambda: pil_jp2(RGB, mct=1),
    "rgba": lambda: pil_jp2(smooth((50, 40, 4), seed=2)),
    "la": lambda: pil_jp2(smooth((33, 47, 2), seed=3)),
    "uint16": lambda: pil_jp2(smooth((100, 120), np.uint16, seed=4)),
    "raw-j2k": lambda: pil_jp2(GREY, no_jp2=True),
    **{f"progression-{p}": (lambda p=p: pil_jp2(RGB, progression=p,
                                                **LAYERS))
       for p in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")},
    "precincts": lambda: pil_jp2(GREY, precinct_size=(64, 32),
                                 num_resolutions=5),
    "codeblock-64x64": lambda: pil_jp2(GREY, codeblock_size=(64, 64)),
    "codeblock-32x32": lambda: pil_jp2(GREY, codeblock_size=(32, 32)),
    "codeblock-64x16": lambda: pil_jp2(GREY, codeblock_size=(64, 16)),
    **{f"resolutions-{r}": (lambda r=r: pil_jp2(smooth((130, 150), seed=5),
                                                num_resolutions=r))
       for r in range(1, 7)},
    "three-layers": lambda: pil_jp2(GREY, quality_layers=[50, 20, 0]),
    "truncated-5/3": lambda: pil_jp2(GREY, quality_layers=[20]),
    "9/7-rate-10": lambda: pil_jp2(GREY, irreversible=True,
                                   quality_layers=[10]),
    "9/7-rate-40": lambda: pil_jp2(GREY, irreversible=True,
                                   quality_layers=[40]),
    "9/7-rgb": lambda: pil_jp2(RGB, irreversible=True, quality_layers=[15],
                               mct=1),
    "9/7-rgb-full-rate": lambda: pil_jp2(RGB, irreversible=True),
    "tiles-uint8": lambda: pil_jp2(smooth((300, 260), seed=6),
                                   tile_size=(128, 128)),
    # Pillow's encoder misplaces tile (0, 1) here: held to PIL's decode
    "tiles-uint16": lambda: pil_jp2(smooth((300, 260), np.uint16, seed=7),
                                    tile_size=(128, 128)),
    "offset": lambda: pil_jp2(smooth((60, 50), seed=8), offset=(3, 5),
                              tile_size=(256, 256)),
    "offset-tiles": lambda: pil_jp2(smooth((90, 77), seed=9),
                                    tile_size=(32, 32), offset=(5, 3),
                                    tile_offset=(2, 1), num_resolutions=3),
    "plt-and-comment": lambda: pil_jp2(GREY, plt=True, comment="dlseg"),
    "1xN": lambda: pil_jp2(smooth((1, 37), seed=10)),
    "Nx1": lambda: pil_jp2(smooth((29, 1), seed=11)),
    "7x13": lambda: pil_jp2(smooth((7, 13), seed=12)),
    "7x13-9/7": lambda: pil_jp2(smooth((7, 13), seed=12),
                                irreversible=True, quality_layers=[5]),
}


def info_tuple(i):
    return (i.width, i.height, i.count, i.dtype, i.geotransform, i.epsg,
            i.wkt, i.nodata)


@pytest.mark.parametrize("name", list(FIXTURES))
def test_decode_and_sniff_equal_jax(name):
    data = FIXTURES[name]()
    want, got = jjp2.decode_jp2(data), tjp2.decode_jp2(data)
    assert got.array.dtype == want.array.dtype
    np.testing.assert_array_equal(got.array, want.array)
    assert info_tuple(got.info) == info_tuple(want.info)
    assert info_tuple(tjp2.sniff_jp2_info(data)) == \
        info_tuple(jjp2.sniff_jp2_info(data))
    # through the dispatch, as chips, bodies and band files reach it
    np.testing.assert_array_equal(timage.decode_image_bytes(data).array,
                                  jimage.decode_image_bytes(data).array)
    assert info_tuple(timage.sniff_image_info(data)) == \
        info_tuple(jimage.sniff_image_info(data))


def test_chip_smoke_97_fixture_is_openjpegs():
    """chip_smoke.py checks the card host's build of the decoder's float
    path on a committed 9/7 codestream: its recorded digest is that of
    PIL's decode, and the port's decode here gives it too."""
    import base64
    import hashlib

    import chip_smoke
    data = base64.b64decode(chip_smoke.J2K_97_B64)
    for pkg in (jjp2, tjp2):
        arr = pkg.decode_jp2(data).array
        assert hashlib.sha256(arr.tobytes()).hexdigest() == \
            chip_smoke.J2K_97_SHA256


def port_codestream(arr: np.ndarray, prec: int, options: int = 0) -> bytes:
    """A JP2 file of ``arr`` at ``prec`` bits from the port's encoder,
    with the codestream features of ``options`` (PIL writes 8 and 16
    bits only, and none of those features)."""
    arr = np.ascontiguousarray(arr if arr.ndim == 3 else arr[:, :, None])
    h, w, nc = arr.shape
    out = np.empty(1 << 22, np.uint8)
    n = tjp2._enc().fc_j2k_encode(arr.ctypes.data, h, w, nc, prec, options,
                                  out.ctypes.data, out.size)
    assert n > 0
    return tjp2._boxed(out[:n].tobytes(), h, w, nc, prec)


# the encoder's options (csrc/host/j2k_encode.cc): code-block styles
# BYPASS 1, RESET 2, TERMALL 4, VSC 8, PTERM 16, SEGSYM 32; SOP 256,
# EPH 512, PPT 1024, PPM 2048, POC 4096, RCT 8192, RGN shift << 16
OPTIONS = {"bypass": 1, "reset": 2, "termall": 4, "vsc": 8, "pterm": 16,
           "segsym": 32, "bypass-termall": 5, "every-style": 63,
           "sop-eph": 768, "ppt": 1024, "ppm": 2048,
           "ppt-sop-eph": 1024 | 768, "ppm-eph": 2048 | 512, "poc": 4096,
           "rct": 8192, "rgn-3": 3 << 16, "rgn-5-bypass": (5 << 16) | 1,
           "everything": 63 | 768 | 1024 | 4096 | 8192 | (2 << 16)}


@pytest.mark.parametrize("name", list(OPTIONS))
def test_codestream_features_pil_cannot_write(name):
    """Code-block styles, SOP/EPH, PPT/PPM, POC, RCT and RGN: files the
    port's encoder writes with them decode, through PIL's OpenJPEG, to
    the source array, and the port's decoder gives the same array."""
    rng = np.random.RandomState(len(name))
    y, x = np.mgrid[0:150, 0:170]
    for src in (rng.randint(0, 256, (70, 90, 3)).astype(np.uint8),
                (120 + 60 * np.sin(x / 9.0) + 40 * np.cos(y / 7.0)
                 ).astype(np.uint8),
                rng.randint(0, 65536, (33, 47)).astype(np.uint16),
                rng.randint(0, 256, (5, 3)).astype(np.uint8)):
        data = port_codestream(src, 8 * src.itemsize, OPTIONS[name])
        pil = np.asarray(Image.open(io.BytesIO(data))).astype(src.dtype)
        np.testing.assert_array_equal(pil.reshape(src.shape), src)
        got = tjp2.decode_jp2(data).array
        np.testing.assert_array_equal(got, jjp2.decode_jp2(data).array)


PRECISIONS = [("grey", 1, 1), ("grey", 4, 1), ("grey", 7, 1),
              ("grey", 10, 1), ("grey", 12, 1), ("grey", 15, 1),
              ("la", 4, 2), ("rgba", 5, 4), ("rgb", 12, 3), ("rgb", 16, 3)]


@pytest.mark.parametrize("kind,prec,nc", PRECISIONS,
                         ids=[f"{k}-{p}bit" for k, p, _ in PRECISIONS])
def test_pil_unpacker_rules(kind, prec, nc):
    """PIL shifts samples to its mode's 8 or 16 bits (one band above 8
    bits is I;16, more bands are 8-bit modes), rounding when it shifts
    down; the JAX package keeps that where PIL's dtype is the SIZ dtype
    (the port equals it) and raises OverflowError in its clip where it
    is not (the port returns the codestream's samples)."""
    dtype = np.uint16 if prec > 8 else np.uint8
    shape = (19, 23, nc) if nc > 1 else (19, 23)
    src = np.random.RandomState(prec).randint(0, 1 << prec, shape)
    data = port_codestream(src.astype(dtype), prec)
    got = tjp2.decode_jp2(data).array
    assert got.dtype == dtype
    if kind in ("grey", "la", "rgba"):
        np.testing.assert_array_equal(got, jjp2.decode_jp2(data).array)
        shift = (16 if got.dtype == np.uint16 else 8) - prec
        if shift:
            assert not np.array_equal(got.reshape(shape), src)
    else:
        with pytest.raises(OverflowError):
            jjp2.decode_jp2(data)
        np.testing.assert_array_equal(got, src)


@pytest.mark.parametrize("dtype", ["int16", "int8"])
def test_signed_jp2_is_an_intended_difference(dtype):
    """A signed file: PIL's I;16/L array holds x + 2^(prec-1) and the JAX
    package's np.clip to the signed range raises OverflowError (wrapped
    as CorruptRasterError by its image.py); the port returns the signed
    samples (ROADMAP queue 3)."""
    src = np.random.RandomState(5).randint(
        np.iinfo(dtype).min, np.iinfo(dtype).max + 1, (20, 30))
    bits = src.astype(np.int64) & (0xFFFF if dtype == "int16" else 0xFF)
    arr = bits.astype(np.uint16 if dtype == "int16" else np.uint8)
    data = pil_jp2(arr, signed=True)
    with pytest.raises(OverflowError):
        jjp2.decode_jp2(data)
    with pytest.raises(jimage.CorruptRasterError, match="OverflowError"):
        jimage.decode_image_bytes(data)
    got = timage.decode_image_bytes(data).array
    assert got.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got[:, :, 0], src)
    assert timage.sniff_image_info(data).dtype == dtype


ENCODE_CASES = [((1, 1), "uint8", 1), ((1, 37), "uint8", 1),
                ((29, 1), "uint16", 1), ((7, 13), "uint8", 3),
                ((16, 16), "uint8", 2), ((31, 40), "uint8", 4),
                ((65, 130), "uint16", 1), ((200, 257), "uint8", 3)]


@pytest.mark.parametrize("shape,dtype,bands", ENCODE_CASES,
                         ids=[f"{s[0]}x{s[1]}-{d}-{b}"
                              for s, d, b in ENCODE_CASES])
def test_encode_roundtrips_through_pil(shape, dtype, bands):
    rng = np.random.RandomState(shape[0] * 131 + shape[1])
    full = shape + ((bands,) if bands > 1 else ())
    src = rng.randint(0, np.iinfo(dtype).max + 1, full).astype(dtype)
    data = tjp2.encode_jp2(src)
    pil = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(pil.astype(dtype).reshape(full), src)
    np.testing.assert_array_equal(tjp2.decode_jp2(data).array.reshape(full),
                                  src)
    np.testing.assert_array_equal(jjp2.decode_jp2(data).array,
                                  tjp2.decode_jp2(data).array)
    assert info_tuple(jjp2.sniff_jp2_info(data)) == \
        info_tuple(tjp2.sniff_jp2_info(data))


def _segments(data: bytes) -> dict:
    """{marker: payload} of a codestream's main header."""
    cs = data[data.index(b"\xff\x4f\xff\x51"):]
    out, i = {}, 2
    while True:
        (m,) = struct.unpack(">H", cs[i:i + 2])
        if m == 0xFF90:
            return out
        (ln,) = struct.unpack(">H", cs[i + 2:i + 4])
        out[m] = cs[i + 4:i + 2 + ln]
        i += 2 + ln


@pytest.mark.parametrize("shape,dtype", [
    ((1, 37), "uint8"), ((2, 2), "uint8"), ((8, 100), "uint8"),
    ((16, 16), "uint8"), ((31, 40), "uint8"), ((32, 32), "uint8"),
    ((300, 300), "uint8"), ((300, 300, 3), "uint8"),
    ((100, 120), "uint16")])
def test_encoder_parameters_are_pils(shape, dtype):
    """The SIZ, COD and QCD segments equal those of PIL's lossless file:
    the resolution count PIL lowers for small images, no colour
    transform, 64x64 code-blocks, LRCP, one layer, two guard bits."""
    arr = np.zeros(shape, dtype)
    ours, pils = _segments(tjp2.encode_jp2(arr)), _segments(pil_jp2(arr))
    for marker in (0xFF51, 0xFF52, 0xFF5C):
        assert ours[marker] == pils[marker], hex(marker)


GT = (272000.0, 10.0, 0.0, 2115000.0, 0.0, -10.0)


def test_geojp2_box_reads_through_jax_sniff():
    src = smooth((40, 50), np.uint16, seed=13)
    data = tjp2.encode_jp2(src, geotransform=GT, epsg=32643, nodata=0)
    want = jjp2.sniff_jp2_info(data)
    assert (want.geotransform, want.epsg, want.nodata) == (GT, 32643, 0.0)
    assert info_tuple(tjp2.sniff_jp2_info(data)) == info_tuple(want)
    got = tjp2.decode_jp2(data)
    np.testing.assert_array_equal(got.array[:, :, 0], src)
    assert info_tuple(got.info) == info_tuple(jjp2.decode_jp2(data).info)


def gml_box(gt, epsg, w, h) -> bytes:
    """A GMLJP2 ``xml `` box as Sentinel-2 writes it."""
    xml = (f'<gml:FeatureCollection><gml:RectifiedGrid dimension="2">'
           f'<gml:limits><gml:GridEnvelope><gml:low>0 0</gml:low>'
           f'<gml:high>{w - 1} {h - 1}</gml:high></gml:GridEnvelope>'
           f'</gml:limits><gml:origin><gml:Point gml:id="p" '
           f'srsName="urn:ogc:def:crs:EPSG::{epsg}"><gml:pos>{gt[0]} '
           f'{gt[3]}</gml:pos></gml:Point></gml:origin>'
           f'<gml:offsetVector srsName="urn:ogc:def:crs:EPSG::{epsg}">'
           f'{gt[1]} {gt[2]}</gml:offsetVector><gml:offsetVector '
           f'srsName="urn:ogc:def:crs:EPSG::{epsg}">{gt[4]} {gt[5]}'
           f'</gml:offsetVector></gml:RectifiedGrid>'
           f'</gml:FeatureCollection>').encode()
    return struct.pack(">I", 8 + len(xml)) + b"xml " + xml


def with_gml(plain: bytes, gt, epsg, w, h) -> bytes:
    off, _ = tjp2._find_codestream(plain)
    return plain[:off - 8] + gml_box(gt, epsg, w, h) + plain[off - 8:]


def test_gmljp2_box_reads_through_jax_sniff():
    src = smooth((30, 20), np.uint16, seed=14)
    data = with_gml(tjp2.encode_jp2(src), GT, 32643, 20, 30)
    want = jjp2.sniff_jp2_info(data)
    assert want.geotransform == GT and want.epsg == 32643
    assert info_tuple(tjp2.sniff_jp2_info(data)) == info_tuple(want)
    assert info_tuple(tjp2.decode_jp2(data).info) == \
        info_tuple(jjp2.decode_jp2(data).info)


def test_encode_refuses_what_the_jax_package_refuses():
    for pkg in (jjp2, tjp2):
        with pytest.raises(ValueError, match="single-band"):
            pkg.encode_jp2(np.zeros((4, 4, 3), np.uint16))


# ------------------------------------------------------------------ SAFE

SAFE_NAME = ("S2A_MSIL1C_20201101T053939_N0209_R005_"
             "T43QBB_20201101T070000.SAFE")
RES = {"B02": 10.0, "B03": 10.0, "B04": 10.0, "B08": 10.0, "B05": 20.0,
       "B11": 20.0, "B01": 60.0}


def build_safe(root, granules=(("A", "geojp2"), ("B", "gml")),
               bands=tuple(RES), dated=True, name=SAFE_NAME):
    """A reduced .SAFE product over TILE: seeded 12-bit bands at mixed
    10/20/60 m resolutions (nodata 0 in blotches), one granule
    georeferenced by GeoJP2 and one by GMLJP2, and a TCI preview that
    ingestion must skip. Returns the SAFE directory."""
    x0, y0, x1, y1 = JTile(*TILE).bounds
    ox, oy = x0 - 250.0, y1 + 250.0
    for k, (gid, geo) in enumerate(granules):
        stem = f"T43QBB_2020110{k + 1}T053939" if dated else "T43QBB"
        img = os.path.join(root, name, "GRANULE", f"L1C_T43QBB_{gid}",
                           "IMG_DATA")
        os.makedirs(img)
        rng = np.random.RandomState(20 + k)
        for band in bands:
            res = RES[band]
            w = int(np.ceil((x1 - x0 + 500) / res))
            h = int(np.ceil((y1 - y0 + 500) / res))
            arr = rng.randint(1, 4096, (h, w)).astype(np.uint16)
            arr[rng.rand(h, w) < 0.05] = 0
            gt = (ox + 3.0 * k, res, 0.0, oy - 2.0 * k, 0.0, -res)
            if geo == "geojp2":
                data = tjp2.encode_jp2(arr, geotransform=gt, epsg=32643,
                                       nodata=0)
            else:
                data = with_gml(tjp2.encode_jp2(arr), gt, 32643, w, h)
            with open(os.path.join(img, f"{stem}_{band}.jp2"), "wb") as f:
                f.write(data)
        with open(os.path.join(img, f"{stem}_TCI.jp2"), "wb") as f:
            f.write(tjp2.encode_jp2(np.zeros((8, 8, 3), np.uint8)))
    return os.path.join(root, name)


@pytest.fixture(scope="module")
def safe(tmp_path_factory):
    base = tmp_path_factory.mktemp("safe")
    return str(base), build_safe(str(base))


def ingest_both(base, safe_dir, tag, **kw):
    cats = []
    for who, cls in (("port", LocalCatalog), ("jax", JLocalCatalog)):
        root = os.path.join(base, f"{who}-{tag}")
        cat = cls.create(root)
        cats.append((cat, cat.ingest_safe(safe_dir, **kw), root))
    return cats


def index(root):
    with open(os.path.join(root, "index.json")) as f:
        return json.load(f)


def test_ingest_safe_index_equals_jax(safe):
    base, safe_dir = safe
    (_, n_t, root_t), (_, n_j, root_j) = ingest_both(
        base, safe_dir, "idx", cloud_fraction=0.0)
    assert n_t == n_j == 2
    got = index(root_t)
    assert got == index(root_j)
    scenes = got["products"]["sentinel-2:L1C"]["scenes"]
    assert [s["date"] for s in scenes] == ["2020-11-01", "2020-11-02"]
    assert not any("TCI" in p for s in scenes for p in s["band_paths"].values())


def test_safe_scene_loads_equal_jax(safe):
    base, safe_dir = safe
    (tcat, _, _), (jcat, _, _) = ingest_both(base, safe_dir, "load")
    tt, jt = TTile(*TILE), JTile(*TILE)
    bands = ["B04", "B11", "B01", "B02"]
    for method in ("near", "bilinear"):
        got = tcat.load(tcat.search(tt, "sentinel-2:L1C"), tt, bands, method)
        want = jcat.load(jcat.search(jt, "sentinel-2:L1C"), jt, bands,
                         method)
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_ingest_safe_refusals_equal_jax(tmp_path):
    base = str(tmp_path)
    errors = []
    for cls in (LocalCatalog, JLocalCatalog):
        cat = cls.create(os.path.join(base, f"c-{cls.__module__}"))
        with pytest.raises(FileNotFoundError) as e:
            cat.ingest_safe(os.path.join(base, "nothing.SAFE"))
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "not a .SAFE" in errors[0]
    # a second product whose band list lacks one of the granule's bands
    first = build_safe(os.path.join(base, "a"), granules=(("A", "geojp2"),),
                       bands=("B02", "B03"))
    second = build_safe(os.path.join(base, "b"), granules=(("B", "gml"),),
                        bands=("B02", "B03", "B04"))
    errors = []
    for cls in (LocalCatalog, JLocalCatalog):
        cat = cls.create(os.path.join(base, f"m-{cls.__module__}"))
        assert cat.ingest_safe(first) == 1
        with pytest.raises(ValueError) as e:
            cat.ingest_safe(second)
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "B04" in errors[0]


@pytest.mark.parametrize("name,date", [
    (SAFE_NAME, "2020-11-01"), ("plain.SAFE", "1970-01-01")])
def test_ingest_safe_date_fallback(tmp_path, name, date):
    safe_dir = build_safe(str(tmp_path), granules=(("A", "geojp2"),),
                          bands=("B02",), dated=False, name=name)
    (_, _, root_t), (_, _, root_j) = ingest_both(str(tmp_path), safe_dir,
                                                 "date")
    got = index(root_t)
    assert got == index(root_j)
    assert got["products"]["sentinel-2:L1C"]["scenes"][0]["date"] == date


def test_ingest_safe_cli_equals_jax(safe, tmp_path, capsys):
    _, safe_dir = safe
    outs = []
    for who, cli in (("port", tcli), ("jax", jcli)):
        root = str(tmp_path / who)
        assert cli.main(["ingest-safe", "--catalog", root, "--safe",
                         safe_dir, "--cloud-fraction", "0.1"]) == 0
        outs.append((capsys.readouterr().out.replace(root, "ROOT"),
                     index(root)))
        empty = str(tmp_path / f"{who}-empty.SAFE")
        os.makedirs(os.path.join(empty, "GRANULE"))
        assert cli.main(["ingest-safe", "--catalog", root, "--safe",
                         empty]) == 1
        capsys.readouterr()
    assert outs[0] == outs[1]
    assert "registered 2 scene(s)" in outs[0][0]


def test_ingest_safe_from_a_bucket(safe, tmp_path, monkeypatch):
    """A .SAFE tree under gs:// (the port's FakeGCS) ingests through the
    storage layer into the index a local tree gives, bucket URLs for
    paths, and its scenes load to the local scenes' arrays."""
    base, safe_dir = safe
    with FakeGCS() as fake:
        monkeypatch.setenv("STORAGE_EMULATOR_HOST", fake.host)
        url = "gs://bucket/S2.SAFE"
        assert storage.upload_dir(safe_dir, url) > 0
        remote = LocalCatalog.create(str(tmp_path / "remote"))
        assert remote.ingest_safe(url) == 2
        local = LocalCatalog.create(str(tmp_path / "local"))
        assert local.ingest_safe(safe_dir) == 2
        got = index(str(tmp_path / "remote"))
        want = json.loads(json.dumps(index(str(tmp_path / "local"))).replace(
            safe_dir, url))
        assert got == want
        tt = TTile(*TILE)
        for a, b in zip(remote.load(remote.search(tt, "sentinel-2:L1C"), tt,
                                    ["B02", "B05"]),
                        local.load(local.search(tt, "sentinel-2:L1C"), tt,
                                   ["B02", "B05"])):
            np.testing.assert_array_equal(a, b)


# -------------------------------------------------------------- pipeline

def jp2_chips(root, n=6, size=24, rgb=False):
    """A chip folder of JP2 pairs named like DLTile keys: 12-bit uint16
    single-band images (or 8-bit RGB) and uint8 labels with nodata 255,
    written by the port's encoder."""
    rng = np.random.RandomState(3)
    for sub in ("images", "labels"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i in range(n):
        name = f"{size}#2#10.0#43#{i - 5}#8410.jp2"
        gt = (272000.0 + i * 240, 10.0, 0.0, 2115000.0, 0.0, -10.0)
        img = (rng.randint(0, 256, (size, size, 3)).astype(np.uint8) if rgb
               else rng.randint(0, 4096, (size, size)).astype(np.uint16))
        lbl = rng.randint(0, 3, (size, size)).astype(np.uint8)
        for sub, arr, nd in (("images", img, None), ("labels", lbl, 255)):
            with open(os.path.join(root, sub, name), "wb") as f:
                f.write(tjp2.encode_jp2(arr, geotransform=gt, epsg=32643,
                                        nodata=nd))
    return root


def read_dir(d):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d))}


@pytest.mark.parametrize("store_as_array", [True, False],
                         ids=["tifarr", "raw"])
def test_mp_engine_jp2_shards_equal_jax(tmp_path, store_as_array):
    chips = jp2_chips(str(tmp_path / "chips"))
    outs = []
    for who, mod in (("port", twriters), ("jax", jwriters)):
        out = str(tmp_path / who)
        assert mod.process_dataset_mp("s2", chips, out, 2, num_proc=1,
                                      file_ext="jp2",
                                      store_as_array=store_as_array) == 6
        outs.append(read_dir(out))
    assert outs[0] == outs[1]
    if store_as_array:
        return
    # the tifraw parsers decode the stored JP2 payloads
    for rec in (r for p in sorted(outs[0]) for r in ttfrecord.read_records(
            str(tmp_path / "port" / p))):
        for fn in ("parse_encoded_gdal_proto_eager",
                   "parse_encoded_gdal_proto_wrapped"):
            got = getattr(tparsers, fn)(rec)
            want = getattr(jparsers, fn)(rec)
            for a, b in zip(got[:2], want[:2]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            assert got[2] == want[2]


def test_inspect_preview_of_jp2_records_equals_jax(tmp_path, capsys):
    """``inspect --preview`` of tifraw records holding JP2 payloads: the
    sheet decodes to the JAX CLI's sheet of the same records."""
    chips = jp2_chips(str(tmp_path / "chips"), n=4, size=32, rgb=True)
    assert twriters.process_dataset_mp("s2", chips, str(tmp_path / "recs"),
                                       1, num_proc=1, file_ext="jp2",
                                       store_as_array=False) == 4
    sheets = []
    for who, cli in (("port", tcli), ("jax", jcli)):
        path = str(tmp_path / f"{who}.png")
        assert cli.main(["inspect", "--records",
                         str(tmp_path / "recs" / "s2-*"), "--mode", "tifraw",
                         "--preview", path, "--preview-count", "3"]) == 0
        capsys.readouterr()
        sheets.append(jimage.decode_image_bytes(open(path, "rb").read())
                      .array)
    np.testing.assert_array_equal(sheets[0], sheets[1])


def test_convert_jp2_to_png_equals_jax(tmp_path):
    chips = jp2_chips(str(tmp_path / "chips"), n=3, rgb=True)
    outs = []
    for who, fn in (("port", t_convert), ("jax", j_convert)):
        out = str(tmp_path / who)
        assert fn(chips, out, file_ext="jp2", to="png", num_workers=1) == 6
        outs.append({(sub, n): jimage.decode_image_bytes(open(
            os.path.join(out, sub, n), "rb").read()).array
            for sub in ("images", "labels")
            for n in sorted(os.listdir(os.path.join(out, sub)))})
    assert sorted(outs[0]) == sorted(outs[1])
    for k in outs[0]:
        np.testing.assert_array_equal(outs[0][k], outs[1][k])


def palette_jp2(seed, entries, npc, alpha=False, cmap=False):
    """A seeded palette JP2: the port's lossless JP2 of random indices
    (and an alpha band), with an sRGB colr box and a pclr box of
    ``entries`` (and a cmap box) in its jp2h."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, 256, (12, 10, 2 if alpha else 1)).astype(np.uint8)
    data = tjp2.encode_jp2(idx)
    c = data.find(b"colr")
    data = data[:c + 7] + struct.pack(">I", 16) + data[c + 11:]
    pclr = struct.pack(">HB", len(entries), npc) + bytes([7] * npc) + \
        b"".join(bytes(e) for e in entries)
    boxes = struct.pack(">I", 8 + len(pclr)) + b"pclr" + pclr
    if cmap:
        body = b"".join(struct.pack(">HBB", 0, 1, k) for k in range(npc))
        boxes += struct.pack(">I", 8 + len(body)) + b"cmap" + body
    h = data.find(b"jp2h") - 4
    n = struct.unpack(">I", data[h:h + 4])[0]
    return (data[:h] + struct.pack(">I", n + len(boxes)) + data[h + 4:h + n]
            + boxes + data[h + n:])


def _entries(seed, n, npc, repeats=0):
    rng = np.random.RandomState(seed)
    out = [tuple(int(v) for v in rng.randint(0, 256, npc)) for _ in range(n)]
    for i in range(repeats):  # entries equal to an earlier one
        out[5 + 7 * i] = out[i]
    return out


@pytest.mark.parametrize("case", [
    dict(entries=_entries(1, 256, 3)),
    dict(entries=_entries(2, 40, 3, repeats=3)),  # PIL drops repeats
    dict(entries=_entries(3, 200, 4)),            # an RGBA palette
    dict(entries=_entries(4, 30, 3), cmap=True),
    dict(entries=_entries(5, 60, 3), alpha=True),  # PA: not converted
], ids=["rgb-256", "repeats", "rgba", "cmap", "pa"])
def test_palette_jp2_decodes_to_the_reference_rgb(case):
    """ROADMAP queue 3: decode_png and decode_jpeg of a palette JP2 (PIL
    mode P) give the palette's RGB, as the JAX package's _pil_decode
    does; mode PA stays indices and alpha, as there; decode_jp2 keeps
    the indices."""
    npc = len(case["entries"][0])
    data = palette_jp2(7, case["entries"], npc, case.get("alpha", False),
                       case.get("cmap", False))
    assert Image.open(io.BytesIO(data)).mode == ("PA" if case.get("alpha")
                                                 else "P")
    for name in ("decode_png", "decode_jpeg"):
        want = getattr(jimage, name)(data)
        got = getattr(timage, name)(data)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert want.shape[2] == (2 if case.get("alpha") else 3)
    np.testing.assert_array_equal(tjp2.decode_jp2(data).array,
                                  jjp2.decode_jp2(data).array)
