"""Sliding-window inference over one large raster.

The chip flow (predict a folder of tiles, then ``stitch``) assumes the
raster was cut on the tile grid with pad-pixel overlap. A user holding
ONE large georeferenced image (the common deployment case: a scene or
an exported mosaic) shouldn't have to re-tile it to run the model:
``predict_windowed`` slides the (image_size)^2 window across the
raster, batches the windows onto the device at one fixed batch shape,
and blends overlapping windows by averaging their softmax
probabilities (uniform weights; the average is exact where windows
agree and smooths seams where they don't). The class map is the argmax
of the BLENDED probabilities, so seam pixels are decided by all
windows that saw them, not by whichever window came last.

The reference stops at per-tile prediction sketches in its notebooks
(parse_tfrecords_to_dataset.ipynb); this completes the deployment
story for whole-scene inference. Every dispatch has the one batch
shape (windows are padded to ``batch_size`` like the chip predict
path), and the blend stays on the host in float32 ((H, W, K) sums + a
per-pixel count), as in the JAX package, so that the same window
probabilities give the same blend.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

__all__ = ["window_origins", "predict_windowed"]


def window_origins(n: int, size: int, stride: int) -> List[int]:
    """1-D window start positions covering [0, n) completely.

    Windows step by ``stride``; the last window is clamped to
    ``n - size`` so coverage reaches the edge exactly (it overlaps its
    predecessor when ``n - size`` is not a stride multiple). Requires
    ``0 < stride <= size`` (a stride beyond the window would leave
    uncovered gaps) and ``n >= size`` (pad smaller rasters first)."""
    if stride <= 0 or stride > size:
        raise ValueError(f"stride must be in [1, size={size}], "
                         f"got {stride}")
    if n < size:
        raise ValueError(f"raster extent {n} is smaller than the "
                         f"window {size}; pad the raster first")
    last = n - size
    origins = list(range(0, last, stride))
    origins.append(last)  # exact edge coverage, clamped
    return origins


def predict_windowed(trainer, image: np.ndarray, *,
                     stride: Optional[int] = None,
                     scale: str = "auto",
                     probs: bool = False,
                     progress=None) -> np.ndarray:
    """Run ``trainer`` over every sliding window of ``image``.

    image: (H, W, C) or (H, W) array in its SOURCE dtype; ``scale``
    follows the predict CLI's deterministic rules ('auto' = by source
    dtype, 'none' = raw DNs for tifraw/tifarr-trained checkpoints, or
    a float multiplier). stride defaults to the full window (edge
    windows still overlap where the extent is not a multiple); pass
    ``image_size // 2`` to blend seams everywhere. Rasters smaller
    than the window in either axis are edge-padded up and cropped
    back, so any size >= 1 works.

    Returns (H, W) argmax class map (int32) or, with ``probs=True``,
    the blended (H, W, num_classes) float32 probability map (each
    pixel's distribution is the uniform average over every window
    that covered it, so it still sums to 1).
    """
    from ..serve import scale_image

    cfg = trainer.config
    size = int(cfg.image_size)
    stride = size if stride is None else int(stride)
    img = np.asarray(image)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim != 3:
        raise ValueError(f"expected (H, W[, C]) raster, got shape "
                         f"{image.shape}")
    if img.shape[2] != cfg.in_channels:
        raise ValueError(f"raster has {img.shape[2]} bands, model "
                         f"expects {cfg.in_channels}")
    h0, w0 = img.shape[:2]
    # undersized rasters: edge-pad (repeats border pixels -- kinder to
    # SAME-padded convs than a zero border) and crop the result back
    pad_h = max(0, size - h0)
    pad_w = max(0, size - w0)
    if pad_h or pad_w:
        img = np.pad(img, ((0, pad_h), (0, pad_w), (0, 0)), mode="edge")
    h, w = img.shape[:2]
    scaled = scale_image(img, scale)
    rows = window_origins(h, size, stride)
    cols = window_origins(w, size, stride)
    wins = [(r, c) for r in rows for c in cols]

    acc = np.zeros((h, w, cfg.num_classes), np.float32)
    cnt = np.zeros((h, w, 1), np.float32)
    bs = int(cfg.batch_size)
    for i in range(0, len(wins), bs):
        chunk = wins[i:i + bs]
        batch = np.stack([scaled[r:r + size, c:c + size] for r, c in chunk])
        if len(chunk) < bs:
            # keep the one batch shape
            batch = np.concatenate(
                [batch, np.zeros((bs - len(chunk),) + batch.shape[1:],
                                 batch.dtype)])
        p = trainer.predict_probs(batch)[:len(chunk)]
        for (r, c), pw in zip(chunk, p):
            acc[r:r + size, c:c + size] += pw
            cnt[r:r + size, c:c + size] += 1.0
        if progress is not None:
            progress(min(i + bs, len(wins)), len(wins))
    out = acc / cnt  # every pixel is covered by >= 1 window
    out = out[:h0, :w0]
    if probs:
        return out.astype(np.float32)
    return np.argmax(out, axis=-1).astype(np.int32)
