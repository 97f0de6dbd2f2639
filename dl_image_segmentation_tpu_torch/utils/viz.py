"""Visualization helpers: tile footprints, chip/label overlays,
prediction panels.

A copy of the JAX package's ``utils/viz.py``: the reference's notebook
plots (create nb cells 30-41, 62; parse nb cells 14-37) as functions
that return the matplotlib Figure. matplotlib is imported on first call
(with the headless Agg backend unless ``MPLBACKEND`` or ``DISPLAY`` is
set), so the module imports without it.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["plot_chip_pair", "plot_tiles", "save_fig"]

import numpy as np


def _mpl():
    import os

    import matplotlib
    # only force the headless backend when no GUI/user choice exists:
    # an unconditional use("Agg") silently no-ops .show() in
    # interactive sessions (the module contract is "save or show")
    if not os.environ.get("MPLBACKEND") and not os.environ.get("DISPLAY"):
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_tiles(tiles, layer=None, ax=None):
    """Tile footprints (WGS84) with optional label-geometry overlay
    (the create-notebook's coverage map, cells 30-41)."""
    plt = _mpl()
    if ax is None:
        fig, ax = plt.subplots(figsize=(8, 8))
    else:
        fig = ax.figure
    for t in tiles:
        lon_min, lat_min, lon_max, lat_max = t.lonlat_bounds
        ax.plot([lon_min, lon_max, lon_max, lon_min, lon_min],
                [lat_min, lat_min, lat_max, lat_max, lat_min],
                color="tab:blue", linewidth=0.7)
    if layer is not None:
        for f in layer.features:
            for rings in f.geometry.polygons():
                for ring in rings:
                    ax.plot(ring[:, 0], ring[:, 1], color="tab:red",
                            linewidth=1.0)
    ax.set_xlabel("longitude")
    ax.set_ylabel("latitude")
    ax.set_title(f"{len(tiles)} tiles")
    ax.set_aspect("equal")
    return fig


def _to_display(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] > 3:
        img = img[:, :, :3]
    if img.ndim == 3 and img.shape[2] == 2:
        img = img[:, :, :1]
    img = img.astype(np.float32)
    lo, hi = np.percentile(img, [2, 98])
    if hi <= lo:
        hi = lo + 1
    return np.clip((img - lo) / (hi - lo), 0, 1).squeeze()


def plot_chip_pair(image: np.ndarray, label: np.ndarray,
                   prediction: Optional[np.ndarray] = None,
                   nodata: int = 255):
    """Side-by-side chip / label (/ prediction) panel (the parse
    notebook's verification plots, cells 14-37)."""
    plt = _mpl()
    ncols = 3 if prediction is not None else 2
    fig, axes = plt.subplots(1, ncols, figsize=(4 * ncols, 4))
    axes[0].imshow(_to_display(image))
    axes[0].set_title("image")
    lbl = np.ma.masked_equal(np.asarray(label).squeeze(), nodata)
    axes[1].imshow(lbl, cmap="tab10", interpolation="nearest")
    axes[1].set_title("label")
    if prediction is not None:
        axes[2].imshow(np.asarray(prediction).squeeze(), cmap="tab10",
                       interpolation="nearest")
        axes[2].set_title("prediction")
    for ax in axes:
        ax.set_xticks([])
        ax.set_yticks([])
    fig.tight_layout()
    return fig


def save_fig(fig, path: str) -> None:
    fig.savefig(path, dpi=120, bbox_inches="tight")
