"""GRIB1 and GRIB2 decoder and encoders.

A copy of the JAX package's ``raster/grib.py``:

* GRIB2 sections 0-8 framing, multi-message files (one band per
  message, GDAL's convention);
* grid definition template 3.0 (regular latitude/longitude) with the
  standard scanning modes, mapped to a pixel-corner geotransform in
  EPSG:4326 as GDAL's GRIB driver does;
* data representation templates 5.0 (simple packing), 5.2 (complex
  packing), 5.3 (complex + spatial differencing, orders 1/2), 5.41 (PNG)
  and 5.40 (JPEG 2000), the PNG and JPEG 2000 codestreams decoded and
  written by the port's own codecs (``raster/png.py``, ``raster/jp2.py``),
  where the JAX package uses PIL; the section-6 bitmap and the 5.2
  primary missing-value substitution (missing points -> NaN + nodata);
* values unpacked per spec: Y = (R + X * 2^E) / 10^D, float32.

GRIB edition 1: simple grid-point packing on regular lat/lon grids (IBM
reference floats, section-3 bitmaps, millidegree increments incl. the
"increments not given" convention). Other layouts raise ValueError
naming what was found.

``encode_grib2`` and ``encode_grib1`` write one message each; their
bytes equal the JAX encoders' except inside a PNG or JPEG 2000
codestream.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

from .geotiff import GeoTIFF, RasterInfo
from .jp2 import decode_jp2, encode_jp2
from .png import decode_png_array, encode_png_array

__all__ = ["is_grib", "decode_grib", "sniff_grib_info", "encode_grib2",
           "encode_grib1"]


def is_grib(data: bytes) -> bool:
    return data[:4] == b"GRIB"


def _s_int(raw: bytes) -> int:
    """GRIB sign-bit integer: MSB set means negative of the rest."""
    v = int.from_bytes(raw, "big")
    sign_bit = 1 << (8 * len(raw) - 1)
    if v & sign_bit:
        return -(v & (sign_bit - 1))
    return v


class _Message:
    def __init__(self):
        self.discipline = 0
        self.ni = self.nj = 0
        self.la1 = self.lo1 = 0.0
        self.di = self.dj = 0.0
        self.scan = 0
        self.drs_template = 0
        self.ref = 0.0
        self.bin_scale = 0
        self.dec_scale = 0
        self.nbits = 0
        self.ndata = 0
        self.bitmap: Optional[np.ndarray] = None
        self.payload = b""
        # complex packing (5.2 / 5.3)
        self.mvm = 0
        self.ngroups = 0
        self.width_ref = 0
        self.width_bits = 0
        self.len_ref = 0
        self.len_inc = 1
        self.last_len = 0
        self.len_bits = 0
        self.sd_order = 0
        self.sd_octets = 0


def _parse_messages(data: bytes) -> List[_Message]:
    msgs = []
    pos = 0
    n = len(data)
    while pos + 16 <= n:
        if data[pos:pos + 4] != b"GRIB":
            raise ValueError(
                f"corrupt GRIB: expected message at byte {pos}")
        edition = data[pos + 7]
        if edition == 1:
            m, pos = _parse_grib1_message(data, pos)
            msgs.append(m)
            continue
        if edition != 2:
            raise ValueError(
                f"GRIB edition {edition} is not supported (editions 1 "
                "and 2 only); convert with wgrib2/gdal_translate first")
        (total_len,) = struct.unpack_from(">Q", data, pos + 8)
        m = _Message()
        m.discipline = data[pos + 6]
        end = pos + total_len
        sp = pos + 16
        while sp < end - 4:
            (sec_len,) = struct.unpack_from(">I", data, sp)
            if sec_len < 5 or sp + sec_len > end - 4:
                # a zero/short length would spin forever; overlong
                # would swallow the 7777 terminator — both corrupt
                raise ValueError(
                    f"corrupt GRIB2: section at byte {sp} has length "
                    f"{sec_len}")
            sec_num = data[sp + 4]
            body = data[sp:sp + sec_len]
            if sec_num == 3:
                _parse_grid(body, m)
            elif sec_num == 5:
                _parse_drs(body, m)
            elif sec_num == 6:
                _parse_bitmap(body, m, msgs)
            elif sec_num == 7:
                m.payload = body[5:]
            sp += sec_len
        if data[end - 4:end] != b"7777":
            raise ValueError("corrupt GRIB: missing 7777 terminator")
        msgs.append(m)
        pos = end
    if not msgs:
        raise ValueError("no GRIB messages in buffer")
    return msgs


def _ibm_float(raw: bytes) -> float:
    """IBM System/370 32-bit hex float (GRIB1 reference values)."""
    v = int.from_bytes(raw, "big")
    sign = -1.0 if v & 0x80000000 else 1.0
    exponent = (v >> 24) & 0x7F
    mantissa = v & 0xFFFFFF
    return sign * mantissa * 16.0 ** (exponent - 64) / float(1 << 24)


def _parse_grib1_message(data: bytes, pos: int) -> Tuple[_Message, int]:
    """One GRIB edition-1 message (sections IS/PDS/GDS/BMS/BDS):
    simple grid-point packing on a regular lat/lon grid."""
    total = int.from_bytes(data[pos + 4:pos + 7], "big")
    if total < 24 or pos + total > len(data):
        # a short/zero length would re-parse the same bytes forever
        # (the terminator check can false-match the PREVIOUS message's
        # 7777 when end <= pos)
        raise ValueError(
            f"corrupt GRIB1: message at byte {pos} has length {total}")
    end = pos + total
    m = _Message()
    p = pos + 8  # PDS
    pds_len = int.from_bytes(data[p:p + 3], "big")
    flags = data[p + 7]
    m.dec_scale = _s_int(data[p + 26:p + 28]) if pds_len >= 28 else 0
    p += pds_len
    if not flags & 0x80:
        raise ValueError(
            "GRIB1 message without a grid description section "
            "(predefined/catalogued grids) is not supported")
    gds_len = int.from_bytes(data[p:p + 3], "big")
    gtype = data[p + 5]
    if gtype != 0:
        raise ValueError(
            f"GRIB1 grid type {gtype} is not supported "
            "(0 regular lat/lon only)")
    m.ni = int.from_bytes(data[p + 6:p + 8], "big")
    m.nj = int.from_bytes(data[p + 8:p + 10], "big")
    if 0xFFFF in (m.ni, m.nj):
        raise ValueError(
            "GRIB1 thinned (quasi-regular) grids are not supported")
    m.la1 = _s_int(data[p + 10:p + 13]) * 1e-3
    m.lo1 = _s_int(data[p + 13:p + 16]) * 1e-3
    la2 = _s_int(data[p + 17:p + 20]) * 1e-3
    lo2 = _s_int(data[p + 20:p + 23]) * 1e-3
    di = int.from_bytes(data[p + 23:p + 25], "big")
    dj = int.from_bytes(data[p + 25:p + 27], "big")
    m.scan = data[p + 27]
    # 0xFFFF = "direction increments not given": derive from corners
    m.di = di * 1e-3 if di != 0xFFFF else \
        abs(lo2 - m.lo1) / max(m.ni - 1, 1)
    m.dj = dj * 1e-3 if dj != 0xFFFF else \
        abs(la2 - m.la1) / max(m.nj - 1, 1)
    p += gds_len
    if flags & 0x40:  # BMS
        bms_len = int.from_bytes(data[p:p + 3], "big")
        unused = data[p + 3]
        bits = np.unpackbits(
            np.frombuffer(data[p + 6:p + bms_len], dtype=np.uint8))
        m.bitmap = bits[:(bms_len - 6) * 8 - unused].astype(bool)
        p += bms_len
    bds_len = int.from_bytes(data[p:p + 3], "big")
    b4 = data[p + 3]
    if b4 & 0x80:
        raise ValueError(
            "GRIB1 spherical-harmonic coefficients are not supported")
    if b4 & 0x40:
        raise ValueError(
            "GRIB1 complex/second-order packing is not supported; "
            "convert with wgrib2 first")
    m.bin_scale = _s_int(data[p + 4:p + 6])
    m.ref = _ibm_float(data[p + 6:p + 10])
    m.nbits = data[p + 10]
    m.payload = data[p + 11:p + bds_len]
    m.drs_template = 0  # GRIB1 simple packing ≡ template 5.0 unpack
    if data[end - 4:end] != b"7777":
        raise ValueError("corrupt GRIB: missing 7777 terminator")
    return m, end


def _parse_grid(body: bytes, m: _Message) -> None:
    (template,) = struct.unpack_from(">H", body, 12)
    if template != 0:
        raise ValueError(
            f"GRIB2 grid definition template 3.{template} is not "
            "supported (3.0 regular lat/lon only)")
    (m.ni,) = struct.unpack_from(">I", body, 30)
    (m.nj,) = struct.unpack_from(">I", body, 34)
    basic = int.from_bytes(body[38:42], "big")
    subdiv = int.from_bytes(body[42:46], "big")
    unit = 1e-6
    if basic not in (0, 0xFFFFFFFF) and subdiv not in (0, 0xFFFFFFFF):
        unit = basic / subdiv
    m.la1 = _s_int(body[46:50]) * unit
    m.lo1 = _s_int(body[50:54]) * unit
    m.di = _s_int(body[63:67]) * unit
    m.dj = _s_int(body[67:71]) * unit
    m.scan = body[71]


def _parse_drs(body: bytes, m: _Message) -> None:
    (m.ndata,) = struct.unpack_from(">I", body, 5)
    (m.drs_template,) = struct.unpack_from(">H", body, 9)
    if m.drs_template not in (0, 2, 3, 40, 41):
        raise ValueError(
            f"GRIB2 data representation template 5.{m.drs_template} is "
            "not supported (5.0 simple, 5.2/5.3 complex, 5.40 "
            "JPEG2000, 5.41 PNG)")
    (m.ref,) = struct.unpack_from(">f", body, 11)
    m.bin_scale = _s_int(body[15:17])
    m.dec_scale = _s_int(body[17:19])
    m.nbits = body[19]
    if m.drs_template in (2, 3):
        m.mvm = body[22]
        if m.mvm not in (0, 1):
            raise ValueError(
                f"GRIB2 missing-value management {m.mvm} is not "
                "supported (0 = none, 1 = primary)")
        (m.ngroups,) = struct.unpack_from(">I", body, 31)
        m.width_ref = body[35]
        m.width_bits = body[36]
        (m.len_ref,) = struct.unpack_from(">I", body, 37)
        m.len_inc = body[41]
        (m.last_len,) = struct.unpack_from(">I", body, 42)
        m.len_bits = body[46]
    if m.drs_template == 3:
        m.sd_order = body[47]
        m.sd_octets = body[48]
        if m.sd_order not in (1, 2):
            raise ValueError(
                f"GRIB2 spatial differencing order {m.sd_order} is "
                "not supported (1 or 2)")
        if m.mvm != 0:
            raise ValueError(
                "GRIB2 spatial differencing with missing-value "
                "management is not supported")


def _parse_bitmap(body: bytes, m: _Message, prior: List[_Message]) -> None:
    indicator = body[5]
    if indicator == 255:
        m.bitmap = None
    elif indicator == 0:
        bits = np.unpackbits(
            np.frombuffer(body[6:], dtype=np.uint8))
        m.bitmap = bits.astype(bool)
    elif indicator == 254 and prior and prior[-1].bitmap is not None:
        m.bitmap = prior[-1].bitmap
    else:
        raise ValueError(
            f"GRIB2 bitmap indicator {indicator} is not supported")


def _unpack_bits(payload: bytes, nbits: int, count: int) -> np.ndarray:
    """count big-endian nbits-wide unsigned ints from a bit stream."""
    if nbits == 0:
        return np.zeros(count, dtype=np.uint32)
    bits = np.unpackbits(np.frombuffer(payload, dtype=np.uint8),
                         count=count * nbits)
    bits = bits.reshape(count, nbits).astype(np.uint32)
    weights = (1 << np.arange(nbits - 1, -1, -1, dtype=np.uint32))
    return (bits * weights).sum(axis=1, dtype=np.uint32)


def _take_bits(bits: np.ndarray, pos: int, n: int, width: int
               ) -> Tuple[np.ndarray, int]:
    """n consecutive width-bit big-endian ints from an unpacked bit
    array; returns (values, new bit position)."""
    if width == 0:
        return np.zeros(n, dtype=np.int64), pos
    sl = bits[pos:pos + n * width].reshape(n, width).astype(np.int64)
    w = (1 << np.arange(width - 1, -1, -1)).astype(np.int64)
    return (sl * w).sum(axis=1), pos + n * width


def _unpack_complex(m: _Message, ndecoded: int
                    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Templates 5.2/5.3: grouped values (+ optional spatial
    differencing), mirroring NCEP g2lib's comunpack. Returns
    (integer field X, missing mask or None)."""
    off = 0
    ival: List[int] = []
    gmin = 0
    if m.drs_template == 3:
        o = m.sd_octets
        for _ in range(m.sd_order):
            ival.append(_s_int(m.payload[off:off + o]))
            off += o
        gmin = _s_int(m.payload[off:off + o])
        off += o
    bits = np.unpackbits(np.frombuffer(m.payload[off:], dtype=np.uint8))
    pos = 0
    ng = m.ngroups
    refs, pos = _take_bits(bits, pos, ng, m.nbits)
    pos = (pos + 7) & ~7  # each array pads to an octet boundary
    widths, pos = _take_bits(bits, pos, ng, m.width_bits)
    widths = widths + m.width_ref
    pos = (pos + 7) & ~7
    lens, pos = _take_bits(bits, pos, ng, m.len_bits)
    lens = lens * m.len_inc + m.len_ref
    pos = (pos + 7) & ~7
    if ng:
        lens[-1] = m.last_len
    total = int(lens.sum())
    if total < ndecoded:
        raise ValueError(
            f"GRIB2 complex packing: groups cover {total} points, "
            f"need {ndecoded}")
    x = np.empty(total, dtype=np.int64)
    miss = np.zeros(total, dtype=bool) if m.mvm else None
    idx = 0
    for g in range(ng):
        count, width = int(lens[g]), int(widths[g])
        vals, pos = _take_bits(bits, pos, count, width)
        if m.mvm == 1 and width == 0 and refs[g] == (1 << m.nbits) - 1:
            miss[idx:idx + count] = True
            x[idx:idx + count] = 0
        else:
            x[idx:idx + count] = refs[g] + vals
            if m.mvm == 1 and width:
                miss[idx:idx + count] = vals == (1 << width) - 1
        idx += count
    x = x[:ndecoded]
    if miss is not None:
        miss = miss[:ndecoded]
    if m.drs_template == 3 and ndecoded:
        # undo spatial differencing (g2lib comunpack recurrences)
        x[m.sd_order:] += gmin
        if m.sd_order == 1:
            x[0] = ival[0]
            x = np.cumsum(x)
        else:
            x0, x1 = ival
            d = x[2:]
            f = (x1 - x0) + np.cumsum(d)          # first differences
            x = np.concatenate(([x0, x1], x1 + np.cumsum(f)))
    return x, miss


def _field_values(m: _Message) -> np.ndarray:
    npts = m.ni * m.nj
    ndecoded = (int(m.bitmap.sum()) if m.bitmap is not None else npts)
    missing = None
    if m.drs_template == 0:
        x = _unpack_bits(m.payload, m.nbits, ndecoded).astype(np.float64)
    elif m.drs_template in (2, 3):
        xi, missing = _unpack_complex(m, ndecoded)
        x = xi.astype(np.float64)
    elif m.drs_template == 41:  # PNG-packed integers
        arr = decode_png_array(m.payload)
        x = arr.reshape(-1)[:ndecoded].astype(np.float64)
    else:  # 40: JPEG 2000 codestream
        arr = decode_jp2(m.payload).array
        x = arr.reshape(-1)[:ndecoded].astype(np.float64)
    y = (m.ref + x * (2.0 ** m.bin_scale)) / (10.0 ** m.dec_scale)
    if missing is not None:
        y[missing] = np.nan
    if m.bitmap is not None:
        full = np.full(npts, np.nan)
        full[m.bitmap[:npts]] = y
        y = full
    if m.scan & 0x30:  # j-consecutive / boustrophedon orderings
        raise ValueError(
            f"GRIB2 scanning mode {m.scan:#04x} is not supported")
    grid = y.reshape(m.nj, m.ni)
    if m.scan & 0x80:  # -i: east to west
        grid = grid[:, ::-1]
    if m.scan & 0x40:  # +j: south to north -> flip to image order
        grid = grid[::-1]
    return grid.astype(np.float32)


def _georef(m: _Message) -> Tuple[float, ...]:
    """Pixel-corner geotransform like GDAL's GRIB driver."""
    di = abs(m.di)
    dj = abs(m.dj)
    lo1 = m.lo1
    if m.scan & 0x80:
        lo1 = m.lo1 - di * (m.ni - 1)
    if lo1 > 180.0:
        lo1 -= 360.0
    lat_top = m.la1 if not (m.scan & 0x40) else m.la1 + dj * (m.nj - 1)
    return (lo1 - di / 2.0, di, 0.0, lat_top + dj / 2.0, 0.0, -dj)


def decode_grib(data: bytes) -> GeoTIFF:
    """GRIB2 bytes -> bands-last float32 raster (one band per
    message, GDAL's convention; all messages must share the grid)."""
    msgs = _parse_messages(data)
    first = msgs[0]
    bands = []
    for m in msgs:
        if (m.ni, m.nj) != (first.ni, first.nj):
            raise ValueError(
                "GRIB messages disagree on grid shape: "
                f"{(m.ni, m.nj)} vs {(first.ni, first.nj)}")
        bands.append(_field_values(m))
    arr = np.stack(bands, axis=-1)
    nodata = float("nan") if any(
        m.bitmap is not None for m in msgs) else None
    info = RasterInfo(width=first.ni, height=first.nj,
                      count=arr.shape[2], dtype="float32",
                      geotransform=_georef(first), epsg=4326,
                      nodata=nodata)
    return GeoTIFF(np.ascontiguousarray(arr), info)


def sniff_grib_info(data: bytes) -> RasterInfo:
    """Header sniff: parses section framing only (payload untouched
    beyond the byte-range walk)."""
    msgs = _parse_messages(data)
    first = msgs[0]
    nodata = float("nan") if any(
        m.bitmap is not None for m in msgs) else None
    return RasterInfo(width=first.ni, height=first.nj, count=len(msgs),
                      dtype="float32", geotransform=_georef(first),
                      epsg=4326, nodata=nodata)


# ---------------------------------------------------------------------------
# fixture encoder
# ---------------------------------------------------------------------------

def _pack_bits(x: np.ndarray, nbits: int) -> bytes:
    bits = ((x[:, None] >> np.arange(nbits - 1, -1, -1)) & 1)
    return np.packbits(bits.astype(np.uint8).reshape(-1)).tobytes()


def _enc_sbytes(v: int, n: int) -> bytes:
    """GRIB sign-bit integer over n octets (inverse of _s_int)."""
    raw = abs(v) | ((1 << (8 * n - 1)) if v < 0 else 0)
    return raw.to_bytes(n, "big")


def _encode_complex(x: np.ndarray, sd_order: int,
                    group: int = 20) -> Tuple[bytes, bytes, int]:
    """Templates 5.2/5.3 payload from non-negative scaled ints.

    Fixed-size grouping (valid, if not g2lib's optimal split); each
    packed array octet-aligned per spec. Returns (payload, DRS octets
    22..47[+48-49], nbits for the group references).
    """
    v = x.astype(np.int64)
    descriptors = b""
    if sd_order:
        ival = [int(v[i]) for i in range(sd_order)]
        d = np.diff(v, n=sd_order)
        gmin = int(d.min()) if d.size else 0
        v = np.concatenate([np.zeros(sd_order, np.int64), d - gmin])
        amax = max([abs(i) for i in ival] + [abs(gmin), 1])
        sd_octets = (int(amax).bit_length() + 1 + 7) // 8
        descriptors = b"".join(
            _enc_sbytes(i, sd_octets) for i in ival + [gmin])
    ng = max(1, -(-len(v) // group))
    refs = np.zeros(ng, np.int64)
    widths = np.zeros(ng, np.int64)
    lens = np.zeros(ng, np.int64)
    val_bits: List[np.ndarray] = []
    for g in range(ng):
        seg = v[g * group:(g + 1) * group]
        r = int(seg.min()) if seg.size else 0
        w = (int(seg.max()) - r).bit_length() if seg.size else 0
        refs[g], widths[g], lens[g] = r, w, len(seg)
        if w:
            rel = (seg - r).astype(np.int64)
            val_bits.append(
                ((rel[:, None] >> np.arange(w - 1, -1, -1)) & 1)
                .reshape(-1).astype(np.uint8))
    nbits = int(refs.max()).bit_length()
    width_bits = int(widths.max()).bit_length()
    len_bits = int(lens.max()).bit_length()
    payload = (descriptors
               + _pack_bits(refs, nbits)
               + _pack_bits(widths, width_bits)
               + _pack_bits(lens, len_bits)
               + (np.packbits(np.concatenate(val_bits)).tobytes()
                  if val_bits else b""))
    tail = (bytes([1, 0]) + bytes(8)          # general split, mvm 0
            + struct.pack(">I", ng)
            + bytes([0, width_bits])          # width ref/bits
            + struct.pack(">I", 0) + bytes([1])   # len ref, increment
            + struct.pack(">I", int(lens[-1]))    # true last length
            + bytes([len_bits]))
    if sd_order:
        tail += bytes([sd_order, sd_octets])
    return payload, tail, nbits


def encode_grib2(field: np.ndarray, la1: float, lo1: float,
                 di: float, dj: float, nbits: int = 12,
                 dec_scale: int = 0, packing: str = "simple",
                 mask: Optional[np.ndarray] = None) -> bytes:
    """One GRIB2 message: regular lat/lon grid (template 3.0); simple
    (5.0), complex (5.2, ``packing="complex"``), complex with spatial
    differencing (5.3, ``packing="complex-sd1"``/``"complex-sd2"``) or
    PNG (5.41) packing; scanning mode 0 (row 0 = northernmost,
    ``la1``/``lo1`` = its center). ``mask`` False marks missing points
    (section-6 bitmap). For test fixtures and round-trip validation."""
    field = np.asarray(field, dtype=np.float64)
    nj, ni = field.shape
    scaled = field * (10.0 ** dec_scale)
    valid = scaled[mask] if mask is not None else scaled.reshape(-1)
    ref = float(valid.min()) if valid.size else 0.0
    x = np.round(valid - ref).astype(np.uint64)
    if x.size and int(x.max()) >= (1 << nbits):
        raise ValueError(f"field range needs more than {nbits} bits")
    drs_tail = b""
    if packing == "simple":
        drs_template = 0
        payload = _pack_bits(x.astype(np.uint32), nbits)
    elif packing in ("complex", "complex-sd1", "complex-sd2"):
        sd_order = 0 if packing == "complex" else int(packing[-1])
        drs_template = 3 if sd_order else 2
        payload, drs_tail, nbits = _encode_complex(
            x.astype(np.int64), sd_order)
    elif packing == "png":
        drs_template = 41
        if nbits > 16:
            raise ValueError("png packing supports <=16 bits")
        dt = np.uint16 if nbits > 8 else np.uint8
        payload = encode_png_array(x.astype(dt).reshape(-1, 1, 1))
    elif packing == "jp2":
        drs_template = 40
        if nbits > 16:
            raise ValueError("jp2 packing supports <=16 bits")
        dt = np.uint16 if nbits > 8 else np.uint8
        payload = encode_jp2(x.astype(dt).reshape(-1, 1))
    else:
        raise ValueError(f"unknown packing {packing!r}")

    def sec(num: int, body: bytes) -> bytes:
        return struct.pack(">IB", 5 + len(body), num) + body

    s1 = sec(1, struct.pack(">HHBBBHBBBBBBB", 0, 0, 2, 1, 1,
                            2026, 1, 1, 0, 0, 0, 0, 1))
    g = bytearray(struct.pack(">BIBBH", 0, ni * nj, 0, 0, 0))
    g += bytes(1) + struct.pack(">BI", 0, 0) * 3  # earth shape fields
    g += struct.pack(">II", ni, nj)
    g += struct.pack(">II", 0xFFFFFFFF, 0xFFFFFFFF)  # basic angle missing

    def deg(v: float) -> bytes:
        i = int(round(abs(v) * 1e6))
        if v < 0:
            i |= 1 << 31
        return struct.pack(">I", i)

    g += deg(la1) + deg(lo1) + b"\x30"
    la2 = la1 - dj * (nj - 1)
    lo2 = lo1 + di * (ni - 1)
    g += deg(la2) + deg(lo2) + deg(di) + deg(dj) + b"\x00"
    s3 = sec(3, bytes(g))
    s4 = sec(4, struct.pack(">HH", 0, 0) + bytes(30))
    ndecoded = int(mask.sum()) if mask is not None else ni * nj
    s5 = sec(5, struct.pack(">IHfhhBB", ndecoded, drs_template, ref,
                            _enc_s16(0), _enc_s16(dec_scale), nbits, 0)
             + drs_tail)
    if mask is not None:
        s6 = sec(6, b"\x00" + np.packbits(
            mask.reshape(-1).astype(np.uint8)).tobytes())
    else:
        s6 = sec(6, b"\xff")
    s7 = sec(7, payload)
    body = s1 + s3 + s4 + s5 + s6 + s7
    total = 16 + len(body) + 4
    s0 = b"GRIB" + bytes(2) + bytes([0, 2]) + struct.pack(">Q", total)
    return s0 + body + b"7777"


def _enc_s16(v: int) -> int:
    """Encode a GRIB sign-bit int16 into a value struct '>h' writes
    with the right wire bytes."""
    if v >= 0:
        return v
    raw = 0x8000 | (-v)
    return raw - 0x10000  # two's-complement reinterpretation for '>h'


def _ibm_encode(x: float) -> bytes:
    """Nearest IBM System/370 32-bit hex float (inverse of
    _ibm_float, round-to-nearest on the 24-bit mantissa)."""
    import math
    if x == 0.0:
        return bytes(4)
    sign = 0x80000000 if x < 0 else 0
    x = abs(x)
    e = int(math.floor(math.log(x, 16.0))) + 1
    mant = int(round(x / 16.0 ** e * float(1 << 24)))
    if mant >= 1 << 24:  # rounding carried into the next hex digit
        e += 1
        mant = int(round(x / 16.0 ** e * float(1 << 24)))
    e += 64
    if not 0 <= e <= 127:
        raise ValueError(f"value {x} outside IBM float range")
    return struct.pack(">I", sign | (e << 24) | mant)


def encode_grib1(field: np.ndarray, la1: float, lo1: float,
                 di: float, dj: float, nbits: int = 12,
                 dec_scale: int = 0,
                 mask: Optional[np.ndarray] = None) -> bytes:
    """One GRIB edition-1 message: regular lat/lon grid, simple
    packing, IBM-float reference, scanning mode 0. ``mask`` False
    marks missing points (bitmap section). For test fixtures and
    round-trip validation."""
    field = np.asarray(field, dtype=np.float64)
    nj, ni = field.shape
    scaled = field * (10.0 ** dec_scale)
    valid = scaled[mask] if mask is not None else scaled.reshape(-1)
    # quantize the reference through the IBM grid FIRST so X absorbs
    # the quantization error instead of every decoded value
    ref = _ibm_float(_ibm_encode(float(valid.min()) if valid.size
                                 else 0.0))
    x = np.round(valid - ref).astype(np.int64)
    if x.size and (int(x.max()) >= (1 << nbits) or int(x.min()) < 0):
        raise ValueError(f"field range needs more than {nbits} bits")

    def mdeg(v: float) -> bytes:
        return _enc_sbytes(int(round(v * 1e3)), 3)

    pds = bytearray(28)
    pds[0:3] = (28).to_bytes(3, "big")
    pds[3] = 2                     # parameter table version
    pds[7] = 0x80 | (0x40 if mask is not None else 0)
    pds[12:17] = bytes([26, 1, 1, 0, 0])  # yy mm dd hh min
    pds[24] = 21                   # century
    pds[26:28] = _enc_sbytes(dec_scale, 2)
    gds = bytearray(32)
    gds[0:3] = (32).to_bytes(3, "big")
    gds[3], gds[4], gds[5] = 0, 255, 0   # NV, PV missing, lat/lon
    gds[6:8] = struct.pack(">H", ni)
    gds[8:10] = struct.pack(">H", nj)
    gds[10:13] = mdeg(la1)
    gds[13:16] = mdeg(lo1)
    gds[16] = 0x80                 # direction increments given
    gds[17:20] = mdeg(la1 - dj * (nj - 1))
    gds[20:23] = mdeg(lo1 + di * (ni - 1))
    gds[23:25] = struct.pack(">H", int(round(di * 1e3)))
    gds[25:27] = struct.pack(">H", int(round(dj * 1e3)))
    gds[27] = 0                    # scanning mode
    bms = b""
    if mask is not None:
        bm = np.packbits(mask.reshape(-1).astype(np.uint8)).tobytes()
        unused = len(bm) * 8 - mask.size
        bms = ((6 + len(bm)).to_bytes(3, "big") + bytes([unused])
               + bytes(2) + bm)
    payload = _pack_bits(x, nbits)
    data_bits = x.size * nbits
    bds_len = 11 + len(payload)
    if bds_len % 2:                # BDS length must be even
        payload += b"\x00"
        bds_len += 1
    unused_bits = (bds_len - 11) * 8 - data_bits
    bds = ((bds_len).to_bytes(3, "big") + bytes([unused_bits & 0x0F])
           + _enc_sbytes(0, 2) + _ibm_encode(ref)
           + bytes([nbits]) + payload)
    body = bytes(pds) + bytes(gds) + bms + bds
    total = 8 + len(body) + 4
    return (b"GRIB" + total.to_bytes(3, "big") + b"\x01"
            + body + b"7777")
