"""Contact-sheet previews of record pairs (``inspect --preview``).

A copy of the JAX package's ``utils/preview.py``: rows of (image |
label) panels on a white canvas; RGB band selection for multi-band
imagery ((3, 2, 1) of a 12-band S2 stack, (0, 1, 2) of an RGB chip, a
single band replicated), each displayed band normalised by its maximum
over the tile; labels coloured from a fixed palette, nodata black.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["render_pair_sheet", "display_rgb", "colorize_label"]

# distinct label colors (class index -> RGB); cycles past 8 classes
_PALETTE = np.array([
    [70, 70, 70],      # 0: background, dark grey
    [230, 80, 60],     # 1
    [60, 140, 230],    # 2
    [80, 200, 120],    # 3
    [240, 200, 70],    # 4
    [170, 100, 220],   # 5
    [240, 140, 60],    # 6
    [110, 220, 220],   # 7
], np.uint8)


def display_rgb(img: np.ndarray,
                rgb_bands: Optional[Sequence[int]] = None) -> np.ndarray:
    """(H, W, C) any-dtype image -> (H, W, 3) uint8 for display.
    rgb_bands: band indices to show as R, G, B. Default: stacks of more
    than 3 bands show (3, 2, 1); 3-band images show (0, 1, 2) (already
    RGB); a single band is replicated. Each displayed band is
    normalized by ITS max over the tile."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    c = img.shape[2]
    if rgb_bands is None:
        rgb_bands = (3, 2, 1) if c > 3 else \
            ((0, 1, 2) if c == 3 else (0, 0, 0))
    if max(rgb_bands) >= c:
        raise ValueError(f"rgb_bands {tuple(rgb_bands)} out of range "
                         f"for {c}-band image")
    rgb = img[:, :, list(rgb_bands)].astype(np.float64)
    peak = rgb.max(axis=(0, 1), keepdims=True)
    peak = np.where(peak > 0, peak, 1.0)
    return np.clip(rgb / peak * 255.0, 0, 255).astype(np.uint8)


def colorize_label(target: np.ndarray, nodata: int = 255) -> np.ndarray:
    """(H, W) class raster -> (H, W, 3) uint8: palette colors per
    class, nodata black."""
    t = np.asarray(target)
    if t.ndim == 3:
        t = t.squeeze(-1)
    t = t.astype(np.int64)
    out = _PALETTE[np.abs(t) % len(_PALETTE)].copy()
    out[t == nodata] = 0
    return out


def render_pair_sheet(pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
                      rgb_bands: Optional[Sequence[int]] = None,
                      nodata: int = 255, gap: int = 4) -> np.ndarray:
    """Rows of (image | label) panels -> one (H, W, 3) uint8 sheet.
    Pairs may have differing sizes; panels are top-left anchored on a
    white canvas."""
    if not pairs:
        raise ValueError("no pairs to render")
    panels = [(display_rgb(img, rgb_bands), colorize_label(tgt, nodata))
              for img, tgt in pairs]
    cell_h = max(max(a.shape[0], b.shape[0]) for a, b in panels)
    cell_w = max(max(a.shape[1], b.shape[1]) for a, b in panels)
    rows = len(panels)
    sheet = np.full((rows * cell_h + (rows + 1) * gap,
                     2 * cell_w + 3 * gap, 3), 255, np.uint8)
    for r, (a, b) in enumerate(panels):
        y = gap + r * (cell_h + gap)
        sheet[y:y + a.shape[0], gap:gap + a.shape[1]] = a
        x = 2 * gap + cell_w
        sheet[y:y + b.shape[0], x:x + b.shape[1]] = b
    return sheet
