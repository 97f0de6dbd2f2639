"""Reconstruct georeferencing from a record's identifier.

The reference stores an 'identifier' feature so that "georeferencing
information of this tile" can be looked up later
(_tfrecord_image_translation.py:70-74) but never ships the lookup.
This module implements it for both identifier variants:

* a tile key 'size:pad:res:zone:ti:tj' (dltile_from_filename=True)
* '{filename}|{geotransform}|{crs}'   (dltile_from_filename=False,
  _img_to_tf_mp.py:63-67)
"""

from __future__ import annotations

import ast
from typing import Optional, Tuple

from .tilegrid import Tile


def georef_from_identifier(identifier) -> Tuple[Optional[Tuple[float, ...]],
                                                Optional[str]]:
    """Returns (geotransform, crs) for a record identifier, or
    (None, None) when the identifier carries no georeferencing (plain
    filename). Identifiers are caller data: undecodable bytes degrade
    to no-georeferencing rather than raising."""
    if isinstance(identifier, bytes):
        identifier = identifier.decode("utf-8", errors="replace")
    if "|" in identifier:
        parts = identifier.split("|")
        if len(parts) == 3:
            _name, gt_str, crs = parts
            try:
                gt = tuple(float(v) for v in ast.literal_eval(gt_str))
                return gt, crs
            except (ValueError, SyntaxError, TypeError):
                return None, None
        return None, None
    try:
        tile = Tile.from_key(identifier)
    except ValueError:
        return None, None
    return tile.geotrans, tile.crs


def tile_from_identifier(identifier) -> Optional[Tile]:
    """The Tile for a tile-key identifier, None for other variants."""
    if isinstance(identifier, bytes):
        identifier = identifier.decode("utf-8", errors="replace")
    try:
        return Tile.from_key(identifier)
    except ValueError:
        return None
