"""Batched chip creation: composite + burn MANY tiles per launch.

PyTorch counterpart of the JAX package's pipeline/batch.py. The per-tile
path (pipeline/chips.py:create_chips_for_tile) launches one compositing
kernel and one label-burn kernel per tile, and a single small tile does
not fill the card. Here K tiles are CONCATENATED ALONG THE ROW AXIS
into one (S_max, K*H, W, B) stack, composited in ONE kernel launch (the
masked median / nearest-date select are per-pixel reductions over the
scene axis, so row-concatenation is exact), and all K label rasters are
burned in ONE rasterize call by offsetting each tile's polygon rows by
its slot index. Image chips are byte-identical to the per-tile path.
Label chips equal the JAX package's batched burn; like it, they may
differ from the per-tile burn in a few boundary pixels, because the
row shift changes how the float32 predicate rounds.

Scene gathering stays host-side and thread-parallel (network/IO
bound); a failed gather keeps the reference's (job, None, None) retry
protocol (_descartes_img_chips.py:718-722). Errors of the device stage
propagate.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import storage
from ..device import resolve_device
from ..geo.vector import open_vector
from ..ops.compositing import (masked_median_composite,
                               nearest_valid_mosaic, pad_stack)
from ..ops.rasterize import rasterize
from ..raster.geotiff import write_geotiff
from .chips import (S2_PRODUCT, DLTileJobConfig, _debug_errors,
                    _gather_nearest, _gather_s2_masked, _label_features_px,
                    _resolve_catalog, create_chips_for_tile)


def _gather_one(job: DLTileJobConfig, cat):
    """Returns ("median"|"nearest", stack, valid[, dist]) or None."""
    tile = job.DLTILE
    band_list = (job.BANDS.split() if isinstance(job.BANDS, str)
                 else list(job.BANDS))
    try:
        if isinstance(job.PRODUCT, list):
            return None  # multi-product stacking stays per-tile
        if job.MAX_CLOUD_FRACTION == 0 and job.PRODUCT == S2_PRODUCT:
            g = _gather_s2_masked(tile, job.MIN_DATE, job.MAX_DATE,
                                  band_list, cat)
            if g is None:
                return None
            return ("median",) + g
        g = _gather_nearest(tile, job.PRODUCT, job.TARGETDATE,
                            job.MIN_DATE, job.MAX_DATE,
                            job.MAX_CLOUD_FRACTION, band_list, cat)
        if g is None:
            return None
        return ("nearest",) + g
    except Exception:
        if _debug_errors():
            raise
        return None


def _composite_group(entries, device) -> List[Optional[np.ndarray]]:
    """One device launch for a group of same-mode, same-shape tiles.

    entries: list of ("median", stack, valid) or
    ("nearest", stack, valid, dist) tuples, all (S_i, H, W, B) with
    identical H/W/B. Returns per-tile (H, W, B) arrays."""
    if not entries:
        return []
    mode = entries[0][0]
    s_max = max(e[1].shape[0] for e in entries)
    h = entries[0][1].shape[1]
    stacks, valids, dists = [], [], []
    for e in entries:
        stack, valid = pad_stack(e[1], e[2], s_max)
        stacks.append(stack)
        valids.append(valid)
        if mode == "nearest":
            dist = np.zeros(s_max, np.float32)
            dist[: len(e[3])] = e[3]
            # per-pixel distances: this tile's rows get its own dates
            dists.append(np.broadcast_to(
                dist[:, None, None], (s_max, h, stack.shape[2])))
    big_stack = np.concatenate(stacks, axis=1)   # (S, K*H, W, B)
    big_valid = np.concatenate(valids, axis=1)   # (S, K*H, W)
    if mode == "median":
        out, _ = masked_median_composite(big_stack, big_valid,
                                         device=device)
    else:
        big_dist = np.concatenate(dists, axis=1)
        out, _ = nearest_valid_mosaic(big_stack, big_valid, big_dist,
                                      device=device)
    out = out.cpu().numpy()
    results = []
    for k, e in enumerate(entries):
        tile_out = out[k * h:(k + 1) * h]
        if mode == "nearest":
            # parity with create_img_array_for_tile: back to the
            # source dtype; the median path stays float32 (np.ma
            # semantics, reference :567)
            tile_out = tile_out.astype(e[1].dtype)
        results.append(tile_out)
    return results


def _burn_group(jobs: Sequence[DLTileJobConfig],
                device) -> List[np.ndarray]:
    """All label rasters of a same-shape group in ONE rasterize call:
    tile k's polygons are offset by k*H rows in a (K*H, W) canvas,
    with a per-feature ROW WINDOW [k*H, (k+1)*H) so geometry extending
    beyond a tile never bleeds into its neighbours' row bands (emit
    order within a tile preserved; ALL_TOUCHED + background fill as in
    create_label_array_for_tile). Tile k's coordinates are shifted by
    k*H in float32, so a pixel on a polygon boundary can round to the
    other side than on the tile's own canvas, exactly as in the JAX
    package's batched burn."""
    size = jobs[0].DLTILE.raster_size
    background = jobs[0].LABEL_NODATA_VALUE
    layers = {}
    per_tile: List[list] = []
    for k, job in enumerate(jobs):
        key = (job.LABEL_DS, job.LABEL_LYR_NUM)
        if key not in layers:
            ds = open_vector(job.LABEL_DS)
            layers[key] = ds.get_layer(job.LABEL_LYR_NUM).to_wgs84()
        feats = _label_features_px(job.DLTILE, layers[key],
                                   job.LABEL_BURN_ATTR)
        window = (float(k * size), float((k + 1) * size))
        shifted_feats = []
        for rings_px, value in feats:
            shifted = [np.stack([r[:, 0], r[:, 1] + k * size], axis=1)
                       for r in rings_px]
            shifted_feats.append((shifted, value, window))
        per_tile.append(shifted_feats)

    # the packed edge tensor is edges[F_total, E_max, 4]: EVERY feature
    # pays the group-wide max edge count, so one complex polygon in any
    # tile inflates the whole group quadratically. When the group pack
    # would cost >4x the per-tile packs (and is big enough to matter),
    # burn per tile instead, by the JAX package's own rule, so the bytes
    # still match its batched export.
    def _pack_cost(feat_lists) -> int:
        counts = [sum(len(r) for r in rings)
                  for feats in feat_lists for rings, _, _ in feats]
        return len(counts) * max(counts, default=0)

    cost_group = _pack_cost(per_tile)
    cost_tiles = sum(_pack_cost([f]) for f in per_tile)
    if cost_group > 4 * max(1, cost_tiles) and cost_group > 1_000_000:
        out = []
        for k, feats in enumerate(per_tile):
            unshifted = [([np.stack([r[:, 0], r[:, 1] - k * size], axis=1)
                           for r in rings], value, (0.0, float(size)))
                         for rings, value, _ in feats]
            out.append(rasterize(unshifted, (size, size),
                                 background=background, all_touched=True,
                                 dtype=np.uint8, device=device))
        return out

    all_feats = [f for feats in per_tile for f in feats]
    big = rasterize(all_feats, (len(jobs) * size, size),
                    background=background, all_touched=True,
                    dtype=np.uint8, device=device)
    return [big[k * size:(k + 1) * size] for k in range(len(jobs))]


def create_chips_for_tiles_batched(
    jobs: Sequence[DLTileJobConfig],
    batch_tiles: int = 16,
    gather_workers: int = 8,
    device=None,
) -> List[Tuple[DLTileJobConfig, Optional[str], Optional[str]]]:
    """Batched equivalent of [create_chips_for_tile(j, device) for j in
    jobs]: same outputs, same (job, None, None) protocol for failed
    gathers, K tiles per compositing launch and per burn, on ``device``
    (None -> CUDA).

    All jobs must share a nodata value per burn group; tiles of
    different shapes/modes are grouped separately. Multi-product
    stacking jobs take the per-tile path."""
    device = resolve_device(device)
    results: List = [None] * len(jobs)
    # group by (mode-signature, raster shape, nodata)
    groups = {}
    for i, job in enumerate(jobs):
        if isinstance(job.PRODUCT, list):
            # multi-product stacks take the per-tile path, which reports
            # a failed gather as (job, None, None) itself
            results[i] = create_chips_for_tile(job, device=device)
            continue
        mode = ("median" if (job.MAX_CLOUD_FRACTION == 0
                             and job.PRODUCT == S2_PRODUCT)
                else "nearest")
        key = (mode, job.DLTILE.raster_size, str(job.BANDS),
               job.LABEL_NODATA_VALUE)
        groups.setdefault(key, []).append(i)

    # two-stage pipeline: a producer thread gathers chunk N+1 (host,
    # network/IO-bound, GIL-free codecs) while the main thread
    # composites/burns/writes chunk N
    chunks = []
    for key, idxs in groups.items():
        for c0 in range(0, len(idxs), batch_tiles):
            chunks.append(idxs[c0:c0 + batch_tiles])

    import queue as _queue
    import threading
    gathered_q: "_queue.Queue" = _queue.Queue(maxsize=2)
    stop = threading.Event()

    def put(item) -> bool:
        """Give-up put: the producer must not outlive a consumer that
        raised."""
        while not stop.is_set():
            try:
                gathered_q.put(item, timeout=0.5)
                return True
            except _queue.Full:
                continue
        return False

    def producer():
        try:
            for chunk in chunks:
                if stop.is_set():
                    return
                chunk_jobs = [jobs[i] for i in chunk]
                with ThreadPoolExecutor(max_workers=gather_workers) as ex:
                    gathered = list(ex.map(
                        lambda j: _gather_one(
                            j, _resolve_catalog(j.CATALOG)),
                        chunk_jobs))
                if not put((chunk, chunk_jobs, gathered)):
                    return
            put(None)
        except BaseException as e:  # surface in the consumer
            put(e)

    threading.Thread(target=producer, daemon=True).start()

    try:
        while True:
            item = gathered_q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            chunk, chunk_jobs, gathered = item
            ok = [(i, j, g) for i, j, g in
                  zip(chunk, chunk_jobs, gathered) if g is not None]
            for i, j, g in zip(chunk, chunk_jobs, gathered):
                if g is None:
                    results[i] = (j, None, None)
            if not ok:
                continue
            imgs = _composite_group([g for _, _, g in ok], device)
            lbls = _burn_group([j for _, j, _ in ok], device)
            for (i, job, _), img_arr, lbl_arr in zip(ok, imgs, lbls):
                tile = job.DLTILE
                fn = tile.key.replace(":", "#")
                img_dir = storage.join(job.OUTFOLDER, "images")
                lbl_dir = storage.join(job.OUTFOLDER, "labels")
                storage.makedirs(img_dir, exist_ok=True)
                storage.makedirs(lbl_dir, exist_ok=True)
                img_file = storage.join(img_dir, fn) + ".tif"
                lbl_file = storage.join(lbl_dir, fn) + ".tif"
                write_geotiff(img_file, np.asarray(img_arr),
                              geotransform=tile.geotrans, epsg=tile.epsg)
                write_geotiff(lbl_file, lbl_arr,
                              geotransform=tile.geotrans, epsg=tile.epsg,
                              nodata=job.LABEL_NODATA_VALUE)
                results[i] = (job, img_file, lbl_file)
    finally:
        stop.set()
    return results
