"""The first TIFF directory as libtiff 4.7 reads it (``TIFFReadDirectory``),
for the files that PIL hands to libtiff: tag by tag, what libtiff takes,
what it ignores, trims or pads, where it estimates StripByteCounts, and
where it refuses the file (:class:`Refused`, which PIL reports as
``OSError`` "decoder error -2").

libtiff reads the directory in three steps. SamplesPerPixel and
Compression come first. Then ImageWidth, ImageLength, ImageDepth, the
tile sizes, PlanarConfiguration, RowsPerStrip and ExtraSamples must read
and set, or the file is refused; codec tags of another codec are dropped.
Then BitsPerSample, SampleFormat, DataType and the sample bounds must read
(one value, or one a sample all equal) and set, the strip or tile arrays
are read (padded with zeros when short, the first ``nstrips`` values when
long), and every other tag that fails to read or set is ignored. Of
duplicated tags the first counts. The strip count, the scanline, strip
and tile sizes must not be zero.

Values are read as ``TIFFReadDirEntry*`` reads them: a value of 4 bytes or
less (8 in BigTIFF) lies in the entry itself, any other at the offset
the entry holds; an 8-byte scalar always at its offset in a classic TIFF;
integer types convert with range checks, others are refused.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

__all__ = ["Directory", "Refused", "read_directory", "scanline_size",
           "strip_rows", "strip_size", "tile_row_size", "tile_size"]


class Refused(ValueError):
    """libtiff's TIFFReadDirectory fails: TIFFClientOpen returns NULL."""


class _EntryError(Exception):
    """A TIFFReadDirEntry* error (count, type, range, io, psdif)."""


# TIFFDataWidth
_WIDTH = {0: 1, 1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
          11: 4, 12: 8, 13: 4, 16: 8, 17: 8, 18: 8}
# the integer types TIFFReadDirEntryShort / Long / *Array convert
_INT = {1: "B", 6: "b", 3: "H", 8: "h", 4: "L", 9: "l", 16: "Q", 17: "q"}
_FLOAT = {11: "f", 12: "d"}
_U16, _U32 = 0xFFFF, 0xFFFFFFFF

# tags of one codec or another (_TIFFCheckFieldIsValidForCodec), with the
# compressions that keep them
_PREDICTOR_CODECS = {5, 8, 32946, 32909, 34925, 50000, 50001, 34887, 50002}
_CODEC_TAGS = {
    317: _PREDICTOR_CODECS,                       # Predictor
    347: {7},                                     # JPEGTables
    512: {6}, 513: {6}, 514: {6}, 515: {6}, 519: {6}, 520: {6}, 521: {6},
    326: {2, 3, 4, 32771}, 327: {2, 3, 4, 32771}, 328: {2, 3, 4, 32771},
    292: {3},                                     # Group3Options
    293: {4},                                     # Group4Options
    50674: {34887},                               # LercParameters
}
# the tags the first pass fetches and must set
_FIRST_PASS = (256, 257, 32997, 323, 322, 32998, 284, 278, 338)


@dataclass
class Directory:
    """What PIL's decoder asks libtiff for (``TIFFGetField``): a field
    that was not set is None."""
    width: int = 0
    length: int = 0
    depth: int = 1
    bps: int = 1
    spp: int = 1
    compression: int = 1
    photometric: int | None = None
    fillorder: int = 1
    planar: int = 1
    rowsperstrip: int = _U32       # td_rowsperstrip
    rowsperstrip_set: bool = False
    tiled: bool = False
    tilewidth: int = 0
    tilelength: int = 0
    tiledepth: int = 1
    sampleformat: int = 1
    extrasamples: tuple = ()
    predictor: int = 1
    jpegtables: bytes | None = None
    subsampling: tuple = (2, 2)
    coefficients: tuple | None = None
    refbw: tuple | None = None
    g3opts: int = 0
    g4opts: int = 0
    nstrips: int = 0
    stripsperimage: int = 0
    offsets: list = field(default_factory=list)
    counts: list = field(default_factory=list)


class _Reader:
    """TIFFReadDirEntry* over one file."""

    def __init__(self, data: bytes, e: str, big: bool):
        self.data, self.e, self.big = data, e, big
        self.inline = 8 if big else 4

    def raw(self, ent, count, width):
        """TIFFReadDirEntryArrayWithLimit's bytes: ``count`` values of
        ``width`` bytes, inline when the entry's own count fits."""
        _tag, _typ, n, fld = ent
        size = count * width
        if min(n, 10) * width <= self.inline and size <= self.inline:
            return fld[:size]
        (off,) = struct.unpack(self.e + ("Q" if self.big else "L"), fld)
        if size > len(self.data) or off + size > len(self.data):
            raise _EntryError("io")
        return self.data[off:off + size]

    def ints(self, ent, limit=None, lo=0, hi=_U16):
        """An integer array (Short/Long/Long8 array), each value range
        checked against [lo, hi]; ``limit`` caps the values read."""
        _tag, typ, n, _fld = ent
        if typ not in _INT:
            raise _EntryError("type")
        count = n if limit is None else min(n, limit)
        if count == 0:
            return ()
        if count * _WIDTH[typ] > 0x7FFFFFFF:
            raise _EntryError("sizesan")
        vals = struct.unpack(self.e + _INT[typ] * count,
                             self.raw(ent, count, _WIDTH[typ]))
        if any(v < lo or v > hi for v in vals):
            raise _EntryError("range")
        return vals

    def scalar(self, ent, hi):
        """TIFFReadDirEntryShort / Long: one integer value."""
        if ent[2] != 1:
            raise _EntryError("count")
        return self.ints(ent, hi=hi)[0]

    def persample(self, ent, spp):
        """TIFFReadDirEntryShort, else TIFFReadDirEntryPersampleShort."""
        if ent[2] == 1:
            return self.scalar(ent, _U16)
        if ent[2] < spp:
            raise _EntryError("count")
        vals = self.ints(ent)
        if any(v != vals[0] for v in vals[1:spp]):
            raise _EntryError("psdif")
        return vals[0]

    def floats(self, ent):
        """TIFFReadDirEntryFloatArray / DoubleArray."""
        _tag, typ, n, _fld = ent
        if n == 0:
            return ()
        if typ in _INT:
            return tuple(float(v) for v in self.ints(ent, lo=-2 ** 63,
                                                     hi=2 ** 64))
        if typ in _FLOAT:
            return struct.unpack(self.e + _FLOAT[typ] * n,
                                 self.raw(ent, n, _WIDTH[typ]))
        if typ in (5, 10):
            v = struct.unpack(self.e + ("L" if typ == 5 else "l") * 2 * n,
                              self.raw(ent, n, 8))
            return tuple(v[2 * i] / v[2 * i + 1] if v[2 * i + 1] else 0.0
                         for i in range(n))
        raise _EntryError("type")

    def bytes_(self, ent):
        """TIFFReadDirEntryByteArray (JPEGTables)."""
        _tag, typ, n, _fld = ent
        if typ in (2, 7):
            return self.raw(ent, n, 1) if n else b""
        return bytes(self.ints(ent, hi=255))


def _entries(data: bytes, offset: int, e: str, big: bool):
    """TIFFFetchDirectory on a mapped file: the entries, or Refused."""
    head, size, cnt = ("HHQ8s", 20, "Q") if big else ("HHL4s", 12, "H")
    csize = struct.calcsize(cnt)
    if offset + csize > len(data):
        raise Refused("Can not read TIFF directory count")
    (n,) = struct.unpack(e + cnt, data[offset:offset + csize])
    if n > 4096:
        raise Refused("Sanity check on directory count failed")
    if n == 0:
        raise Refused("zero tag directories not supported")
    p = offset + csize
    if p + n * size > len(data):
        raise Refused("Can not read TIFF directory")
    return [struct.unpack(e + head, data[p + i * size:p + (i + 1) * size])
            for i in range(n)]


def read_directory(data: bytes, offset: int, e: str, big: bool
                   ) -> Directory:
    """TIFFReadDirectory of the directory at ``offset``."""
    entries = _entries(data, offset, e, big)
    rd = _Reader(data, e, big)
    d = Directory()
    seen, live = set(), []
    for ent in entries:  # a duplicate of a tag is ignored
        if ent[0] not in seen:
            seen.add(ent[0])
            live.append(ent)
    bytag = {ent[0]: ent for ent in live}

    def fail(what, err=None):
        raise Refused(f"{what}: {err}" if err else what)

    # SamplesPerPixel, then Compression, before anything else
    if 277 in bytag:
        try:
            d.spp = rd.scalar(bytag[277], _U16)
        except _EntryError as err:
            fail("SamplesPerPixel", err)
        if not d.spp:
            fail("Bad value 0 for SamplesPerPixel")
    if 259 in bytag:
        try:
            d.compression = rd.persample(bytag[259], d.spp)
        except _EntryError as err:
            fail("Compression", err)
    # the first pass
    tile_dims = False
    skip = set()
    for ent in live:
        tag = ent[0]
        if tag in _CODEC_TAGS and d.compression not in _CODEC_TAGS[tag]:
            skip.add(tag)
        if tag not in _FIRST_PASS:
            continue
        if tag == 338:
            try:
                vals = rd.ints(ent) if ent[2] <= _U16 else fail("count")
            except _EntryError as err:
                fail("ExtraSamples", err)
            if len(vals) > d.spp or any(v > 2 and v != 999 for v in vals):
                fail("ExtraSamples value")
            d.extrasamples = tuple(2 if v == 999 else v for v in vals)
            continue
        try:
            v = rd.scalar(ent, _U16 if tag == 284 else _U32)
        except _EntryError as err:
            fail(f"tag {tag}", err)
        if tag == 256:
            d.width = v
        elif tag == 257:
            d.length = v
        elif tag == 32997:
            d.depth = v
        elif tag == 322:
            d.tilewidth, tile_dims = v, True
        elif tag == 323:
            d.tilelength, tile_dims = v, True
        elif tag == 32998:
            if v == 0:
                fail("TileDepth 0")
            d.tiledepth = v
        elif tag == 284:
            if v not in (1, 2):
                fail(f"Bad value {v} for PlanarConfiguration")
            d.planar = v
        elif tag == 278:
            if v == 0:
                fail("Bad value 0 for RowsPerStrip")
            d.rowsperstrip, d.rowsperstrip_set = v, True
            if not tile_dims:
                d.tilelength, d.tilewidth = v, d.width
    if 256 not in bytag and 257 not in bytag:
        fail("missing required ImageLength")
    if tile_dims:
        d.tiled = True
        dims = (d.tilewidth, d.tilelength, d.tiledepth)
        n = 0 if 0 in dims else (-(-d.width // d.tilewidth)) * (
            -(-d.length // d.tilelength)) * (-(-d.depth // d.tiledepth))
        if n > _U32:
            n = 0
    else:
        d.tilewidth, d.tilelength, d.tiledepth = (d.width, d.rowsperstrip,
                                                  d.depth)
        n = 1 if d.rowsperstrip == _U32 else -(-d.length // d.rowsperstrip)
    if d.planar == 2:
        n *= d.spp
        if n > _U32:
            n = 0
    if not n:
        fail("Cannot handle zero number of strips or tiles")
    d.nstrips = n
    d.stripsperimage = n // d.spp if d.planar == 2 else n
    if not any(t in bytag for t in (273, 324)):
        fail("missing required StripOffsets")
    # the second pass
    off_ent = cnt_ent = None
    bps_read = False
    colormap = False
    for ent in live:
        tag = ent[0]
        if tag in skip or tag in _FIRST_PASS or tag in (277, 259):
            continue
        try:
            if tag in (258, 339, 32996, 280, 281):
                try:
                    v = rd.persample(ent, d.spp)
                except _EntryError as err:
                    fail(f"tag {tag}", err)
                if tag == 258:
                    d.bps, bps_read = v, True
                elif tag == 339:
                    if not 1 <= v <= 6:
                        fail(f"Bad value {v} for SampleFormat")
                    d.sampleformat = v
                elif tag == 32996:
                    if v > 3:
                        fail(f"Bad value {v} for DataType")
                    d.sampleformat = (4, 2, 1, 3)[v]
            elif tag in (340, 341):
                if ent[2] != d.spp:
                    fail(f"tag {tag} count")
                try:
                    rd.floats(ent)
                except _EntryError as err:
                    fail(f"tag {tag}", err)
            elif tag in (273, 324):
                off_ent = ent
            elif tag in (279, 325):
                cnt_ent = ent
            elif tag == 320:
                if bps_read and d.bps <= 24 and ent[2] == 3 << d.bps:
                    rd.ints(ent)
                    colormap = True
            elif tag == 262:
                d.photometric = rd.scalar(ent, _U16)
            elif tag == 266:
                v = rd.scalar(ent, _U16)
                if v in (1, 2):
                    d.fillorder = v
            elif tag == 317:
                d.predictor = rd.scalar(ent, _U16)
            elif tag == 347:
                v = rd.bytes_(ent)
                if v:
                    d.jpegtables = v
            elif tag == 530:
                if ent[2] == 2:
                    d.subsampling = rd.ints(ent)[:2]
            elif tag == 529:
                if ent[2] == 3:
                    d.coefficients = rd.floats(ent)
            elif tag == 532:
                if ent[2] == 6:
                    d.refbw = rd.floats(ent)
            elif tag == 292:
                d.g3opts = rd.scalar(ent, _U32)
            elif tag == 293:
                d.g4opts = rd.scalar(ent, _U32)
        except _EntryError:
            pass  # TIFFFetchNormalTag(recover): the tag is ignored
    colours = {0: 1, 1: 1, 3: 1, 4: 1, 2: 3, 8: 3, 9: 3, 10: 3, 32844: 1,
               32845: 3, 6: 3, 5: 4}.get(d.photometric or 0, 0)
    if colours and d.spp - len(d.extrasamples) > colours:
        d.extrasamples = (d.extrasamples + (0,) * d.spp)[:d.spp - colours]
    if d.photometric == 3 and not colormap:
        if d.bps >= 8:
            d.photometric = 2 if d.spp == 3 else 1
        else:
            fail("missing required Colormap")
    d.offsets = _strile_array(rd, off_ent, n)
    counts_set = cnt_ent is not None
    if counts_set:
        d.counts = _strile_array(rd, cnt_ent, n)
    if not counts_set:
        if (d.planar == 1 and n > 1) or (d.planar == 2 and n != d.spp):
            fail("missing required StripByteCounts")
        _estimate(d, entries, len(data), big)
    elif n == 1 and not d.tiled and d.offsets[0] and not d.counts[0]:
        _estimate(d, entries, len(data), big)
    if not scanline_size(d):
        fail("Cannot handle zero scanline size")
    if d.tiled and not tile_size(d):
        fail("Cannot handle zero tile size")
    if not d.tiled and not strip_size(d, _strip_rows_max(d)):
        fail("Cannot handle zero strip size")
    return d


def _strile_array(rd: _Reader, ent, n: int) -> list:
    """TIFFFetchStripThing: the first ``n`` values, zeros past a short
    array; Refused where the array does not read."""
    try:
        vals = list(rd.ints(ent, limit=n, hi=2 ** 64))
    except _EntryError as err:
        raise Refused(f"StripOffsets/ByteCounts: {err}") from err
    if ent[2] < n:
        if n > 1000000:
            raise Refused("too many strips to pad")
        vals += [0] * (n - len(vals))
    return vals


def _estimate(d: Directory, entries, filesize: int, big: bool) -> None:
    """EstimateStripByteCounts for a compressed image: the file less its
    header, directory and tag data, split over the planes; the last strip
    cut at the file's end."""
    space = (16 + 8 + len(entries) * 20 + 8) if big else \
        (8 + 2 + len(entries) * 12 + 4)
    for _tag, typ, n, _fld in entries:
        w = _WIDTH.get(typ, 0)
        if not w:
            raise Refused(f"Cannot determine size of unknown tag type {typ}")
        size = w * n
        space += 0 if size <= (8 if big else 4) else size
    space = filesize if filesize < space else filesize - space
    if d.planar == 2:
        space //= d.spp
    d.counts = [space] * d.nstrips
    last = d.offsets[-1]
    if last + space > filesize:
        d.counts[-1] = 0 if last >= filesize else filesize - last
    if not d.rowsperstrip_set:
        d.rowsperstrip = d.length


def _ycbcr_packed(d: Directory, upsampled: bool) -> bool:
    return d.planar == 1 and d.photometric == 6 and not upsampled


def _sampling(d: Directory):
    h, v = d.subsampling
    if h not in (1, 2, 4) or v not in (1, 2, 4):
        return None
    return h, v


def _cap(v: int) -> int:
    """_TIFFMultiply64 / _TIFFCastUInt64ToSSize: 0 past their range."""
    return v if v < 2 ** 63 else 0


def scanline_size(d: Directory, upsampled: bool = False) -> int:
    """TIFFScanlineSize."""
    if _ycbcr_packed(d, upsampled) and d.spp == 3:
        s = _sampling(d)
        if s is None:
            return 0
        h, v = s
        row = (-(-d.width // h) * (h * v + 2) * d.bps + 7) // 8
        return _cap(row // v)
    if d.planar == 1:
        return _cap((d.width * d.spp * d.bps + 7) // 8)
    return _cap((d.width * d.bps + 7) // 8)


def _strip_rows_max(d: Directory) -> int:
    return min(d.rowsperstrip, d.length)


def strip_size(d: Directory, rows: int, upsampled: bool = False) -> int:
    """TIFFVStripSize(rows)."""
    if _ycbcr_packed(d, upsampled):
        s = _sampling(d) if d.spp == 3 else None
        if s is None:
            return 0
        h, v = s
        row = (-(-d.width // h) * (h * v + 2) * d.bps + 7) // 8
        return _cap(row * -(-rows // v))
    return _cap(rows * scanline_size(d, upsampled))


def strip_rows(d: Directory, strip: int) -> int:
    """The rows of strip ``strip`` (TIFFReadEncodedStripGetStripSize)."""
    rps = _strip_rows_max(d)
    per_plane = -(-d.length // rps)
    rows = d.length - (strip % per_plane) * rps
    return min(rows, rps)


def tile_row_size(d: Directory) -> int:
    """TIFFTileRowSize."""
    if not d.tilelength or not d.tilewidth:
        return 0
    bits = d.bps * d.tilewidth * (d.spp if d.planar == 1 else 1)
    return _cap((bits + 7) // 8)


def tile_size(d: Directory, upsampled: bool = False) -> int:
    """TIFFTileSize."""
    if not d.tilelength or not d.tilewidth or not d.tiledepth:
        return 0
    if _ycbcr_packed(d, upsampled) and d.spp == 3:
        s = _sampling(d)
        if s is None:
            return 0
        h, v = s
        row = (-(-d.tilewidth // h) * (h * v + 2) * d.bps + 7) // 8
        return _cap(row * -(-d.tilelength // v))
    return _cap(d.tilelength * tile_row_size(d))
