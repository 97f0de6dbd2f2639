"""GeoPackage raster (tiles) decoder and encoder.

A copy of the JAX package's ``raster/gpkg_raster.py``. A GeoPackage is a
SQLite database (OGC 12-128r14): tile pyramids live in a user table
registered in ``gpkg_contents`` (data_type 'tiles'), with the grid
geometry in ``gpkg_tile_matrix_set`` / ``gpkg_tile_matrix`` and each
tile a PNG/JPEG blob. Decoded with the stdlib ``sqlite3`` (bytes opened
with ``Connection.deserialize``) and the port's own PNG and JPEG codecs:

* the highest zoom level of the first (or named) tiles table;
* tile assembly onto the tile-matrix-set extent (missing tiles fill
  with zeros), geotransform from the set bounds + pixel sizes;
* EPSG from ``gpkg_spatial_ref_sys.organization_coordsys_id``;
* header-only sniffing (grid math + one tile header).

The tiles table's name is quoted as an SQL identifier (``"`` doubled),
where the JAX package pastes it in unescaped.
"""

from __future__ import annotations

import sqlite3
from typing import Optional, Tuple

import numpy as np

from .geotiff import GeoTIFF, RasterInfo
from .png import encode_png_array

__all__ = ["is_gpkg", "decode_gpkg", "sniff_gpkg_info", "encode_gpkg"]

_MAGIC = b"SQLite format 3\x00"
_GPKG_APP_IDS = (b"GPKG", b"GP10", b"GP11")


def is_gpkg(data: bytes) -> bool:
    return (len(data) > 72 and data[:16] == _MAGIC
            and data[68:72] in _GPKG_APP_IDS)


def _ident(name: str) -> str:
    """``name`` quoted as an SQL identifier, its ``"`` doubled: a table
    name read from ``gpkg_contents`` is untrusted."""
    return '"' + name.replace('"', '""') + '"'


def _open(data: bytes) -> sqlite3.Connection:
    conn = sqlite3.connect(":memory:")
    try:
        conn.deserialize(bytes(data))
    except Exception as e:
        conn.close()
        raise ValueError(f"unreadable GeoPackage database: {e}")
    return conn


def _tiles_table(conn: sqlite3.Connection,
                 table: Optional[str]) -> Tuple[str, int]:
    """(tiles table name, srs_id) from gpkg_contents."""
    q = ("SELECT table_name, srs_id FROM gpkg_contents "
         "WHERE data_type IN ('tiles', '2d-gridded-coverage')")
    rows = conn.execute(q).fetchall()
    if table is not None:
        rows = [r for r in rows if r[0] == table]
    if not rows:
        raise ValueError("GeoPackage has no tiles table"
                         + (f" named {table!r}" if table else ""))
    return rows[0][0], int(rows[0][1] or 0)


def _epsg(conn: sqlite3.Connection, srs_id: int) -> Optional[int]:
    try:
        row = conn.execute(
            "SELECT organization, organization_coordsys_id FROM "
            "gpkg_spatial_ref_sys WHERE srs_id = ?", (srs_id,)
        ).fetchone()
    except sqlite3.Error:
        return None
    if row and (row[0] or "").upper() == "EPSG":
        return int(row[1])
    return None


def _grid(conn: sqlite3.Connection, table: str):
    """(zoom, mw, mh, tw, th, px, py, min_x, max_y) for the deepest
    zoom level present in the tiles table."""
    zrow = conn.execute(
        f'SELECT MAX(zoom_level) FROM {_ident(table)}').fetchone()
    if zrow is None or zrow[0] is None:
        raise ValueError(f"GeoPackage tiles table {table!r} is empty")
    zoom = int(zrow[0])
    m = conn.execute(
        "SELECT matrix_width, matrix_height, tile_width, tile_height, "
        "pixel_x_size, pixel_y_size FROM gpkg_tile_matrix "
        "WHERE table_name = ? AND zoom_level = ?",
        (table, zoom)).fetchone()
    if m is None:
        raise ValueError(f"GeoPackage has no gpkg_tile_matrix row for "
                         f"{table!r} zoom {zoom}")
    s = conn.execute(
        "SELECT min_x, min_y, max_x, max_y FROM gpkg_tile_matrix_set "
        "WHERE table_name = ?", (table,)).fetchone()
    if s is None:
        raise ValueError(f"GeoPackage has no gpkg_tile_matrix_set row "
                         f"for {table!r}")
    mw, mh, tw, th = (int(v) for v in m[:4])
    px, py = float(m[4]), float(m[5])
    return zoom, mw, mh, tw, th, px, py, float(s[0]), float(s[3])


def _check_extent(w: int, h: int) -> None:
    if w > (1 << 16) or h > (1 << 16):
        raise ValueError(f"GeoPackage tile matrix too large ({w} x {h})")


def sniff_gpkg_info(data: bytes, table: Optional[str] = None
                    ) -> RasterInfo:
    """Shape/dtype/geo from the grid tables + ONE tile's header; a tile
    matrix that ``decode_gpkg`` refuses as too large is refused here too
    (the JAX package's sniff reports it)."""
    from .image import sniff_image_info
    conn = _open(data)
    try:
        name, srs = _tiles_table(conn, table)
        zoom, mw, mh, tw, th, px, py, minx, maxy = _grid(conn, name)
        _check_extent(mw * tw, mh * th)
        blob = conn.execute(
            f'SELECT tile_data FROM {_ident(name)} WHERE zoom_level = ? '
            "LIMIT 1", (zoom,)).fetchone()
        if blob is None:
            raise ValueError("GeoPackage tiles table has no tile at "
                             f"zoom {zoom}")
        tinfo = sniff_image_info(bytes(blob[0]))
        return RasterInfo(width=mw * tw, height=mh * th,
                          count=tinfo.count, dtype=tinfo.dtype,
                          geotransform=(minx, px, 0.0, maxy, 0.0, -py),
                          epsg=_epsg(conn, srs))
    finally:
        conn.close()


def decode_gpkg(data: bytes, table: Optional[str] = None) -> GeoTIFF:
    """Deepest zoom level of the (first or named) tiles table,
    assembled onto the tile-matrix-set extent; missing tiles are
    zero-filled."""
    from .image import decode_image_bytes
    conn = _open(data)
    try:
        name, srs = _tiles_table(conn, table)
        zoom, mw, mh, tw, th, px, py, minx, maxy = _grid(conn, name)
        _check_extent(mw * tw, mh * th)
        out = None
        for col, row, blob in conn.execute(
                f'SELECT tile_column, tile_row, tile_data FROM '
                f'{_ident(name)} WHERE zoom_level = ?', (zoom,)):
            # a tile is an image, never a VRT that reads other files
            tile = decode_image_bytes(bytes(blob),
                                      allow_sources=False).array
            if out is None:
                out = np.zeros((mh * th, mw * tw, tile.shape[2]),
                               tile.dtype)
            if not (0 <= col < mw and 0 <= row < mh):
                raise ValueError(
                    f"GeoPackage tile ({col}, {row}) outside its "
                    f"{mw}x{mh} matrix")
            if tile.shape[:2] != (th, tw):
                raise ValueError(
                    f"GeoPackage tile ({col}, {row}) is "
                    f"{tile.shape[1]}x{tile.shape[0]}, expected "
                    f"{tw}x{th}")
            out[row * th:(row + 1) * th,
                col * tw:(col + 1) * tw, :tile.shape[2]] = tile
        if out is None:
            raise ValueError(f"GeoPackage tiles table {name!r} has no "
                             f"tiles at zoom {zoom}")
        info = RasterInfo(width=out.shape[1], height=out.shape[0],
                          count=out.shape[2], dtype=out.dtype.name,
                          geotransform=(minx, px, 0.0, maxy, 0.0, -py),
                          epsg=_epsg(conn, srs))
        return GeoTIFF(out, info)
    finally:
        conn.close()


# ---------------------------------------------------------------------------
# fixture encoder
# ---------------------------------------------------------------------------

def encode_gpkg(array: np.ndarray, table: str = "imagery",
                tile_size: int = 256,
                geotransform: Optional[Tuple[float, ...]] = None,
                epsg: Optional[int] = None) -> bytes:
    """Minimal spec-shaped GeoPackage with one PNG tile pyramid level.
    array: (H, W) or (H, W, B) uint8/uint16 (PNG-expressible). The
    matrix extent covers the array exactly (H/W padded up to whole
    tiles; the pad rows/cols are zero, like GDAL's edge tiles)."""
    arr = np.asarray(array)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, nb = arr.shape
    gt = geotransform or (0.0, 1.0, 0.0, 0.0, 0.0, -1.0)
    if gt[2] or gt[4]:
        raise ValueError("GeoPackage grids are axis-aligned")
    mw = (w + tile_size - 1) // tile_size
    mh = (h + tile_size - 1) // tile_size
    conn = sqlite3.connect(":memory:")
    conn.executescript(f"""
        PRAGMA application_id = 1196444487;  -- 'GPKG'
        PRAGMA user_version = 10300;
        CREATE TABLE gpkg_spatial_ref_sys (
            srs_name TEXT NOT NULL, srs_id INTEGER PRIMARY KEY,
            organization TEXT NOT NULL,
            organization_coordsys_id INTEGER NOT NULL,
            definition TEXT NOT NULL, description TEXT);
        CREATE TABLE gpkg_contents (
            table_name TEXT PRIMARY KEY, data_type TEXT NOT NULL,
            identifier TEXT UNIQUE, description TEXT DEFAULT '',
            last_change DATETIME, min_x DOUBLE, min_y DOUBLE,
            max_x DOUBLE, max_y DOUBLE, srs_id INTEGER);
        CREATE TABLE gpkg_tile_matrix_set (
            table_name TEXT PRIMARY KEY, srs_id INTEGER NOT NULL,
            min_x DOUBLE NOT NULL, min_y DOUBLE NOT NULL,
            max_x DOUBLE NOT NULL, max_y DOUBLE NOT NULL);
        CREATE TABLE gpkg_tile_matrix (
            table_name TEXT NOT NULL, zoom_level INTEGER NOT NULL,
            matrix_width INTEGER NOT NULL,
            matrix_height INTEGER NOT NULL,
            tile_width INTEGER NOT NULL, tile_height INTEGER NOT NULL,
            pixel_x_size DOUBLE NOT NULL, pixel_y_size DOUBLE NOT NULL,
            PRIMARY KEY (table_name, zoom_level));
        CREATE TABLE {_ident(table)} (
            id INTEGER PRIMARY KEY AUTOINCREMENT,
            zoom_level INTEGER NOT NULL,
            tile_column INTEGER NOT NULL, tile_row INTEGER NOT NULL,
            tile_data BLOB NOT NULL,
            UNIQUE (zoom_level, tile_column, tile_row));
    """)
    srs_id = epsg if epsg is not None else 0
    conn.execute(
        "INSERT INTO gpkg_spatial_ref_sys VALUES (?, ?, ?, ?, ?, ?)",
        (f"srs {srs_id}", srs_id, "EPSG" if epsg else "NONE",
         epsg if epsg else -1, "undefined", None))
    minx, maxy = float(gt[0]), float(gt[3])
    maxx = minx + mw * tile_size * gt[1]
    miny = maxy + mh * tile_size * gt[5]
    conn.execute(
        "INSERT INTO gpkg_contents (table_name, data_type, identifier,"
        " min_x, min_y, max_x, max_y, srs_id) VALUES "
        "(?, 'tiles', ?, ?, ?, ?, ?, ?)",
        (table, table, minx, miny, maxx, maxy, srs_id))
    conn.execute(
        "INSERT INTO gpkg_tile_matrix_set VALUES (?, ?, ?, ?, ?, ?)",
        (table, srs_id, minx, miny, maxx, maxy))
    conn.execute(
        "INSERT INTO gpkg_tile_matrix VALUES (?, 0, ?, ?, ?, ?, ?, ?)",
        (table, mw, mh, tile_size, tile_size, float(gt[1]),
         float(-gt[5])))
    for row in range(mh):
        for col in range(mw):
            full = np.zeros((tile_size, tile_size, nb), arr.dtype)
            r0, c0 = row * tile_size, col * tile_size
            vr = min(tile_size, h - r0)
            vc = min(tile_size, w - c0)
            if vr <= 0 or vc <= 0:
                continue
            full[:vr, :vc] = arr[r0:r0 + vr, c0:c0 + vc]
            conn.execute(
                f'INSERT INTO {_ident(table)} (zoom_level, tile_column, '
                "tile_row, tile_data) VALUES (0, ?, ?, ?)",
                (col, row, encode_png_array(full)))
    conn.commit()
    data = conn.serialize()
    conn.close()
    return bytes(data)
