"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

1. device: the card's name, count, and nvidia-smi's name and power limit;
2. build: every CUDA kernel of the chip-creation path, one nvcc per
   source started together, with ptxas' registers, shared memory and
   spills;
3. kernel vs plain: each kernel on the card at the path's shapes,
   launched bare (its wrapper's launch helper, every input prepared
   once) and through its wrapper, each bitwise equal (torch.equal) to
   its plain PyTorch version on the same inputs. CUDA-event times: the
   kernel alone (``ms``, a CUDA graph of bare launches; the median's
   launches rotate over input copies that together exceed the 50 MB L2),
   the wrapper as the main path calls it (``wrapper_ms``), the plain
   version, and for the median the library's yardstick
   (``library_ms``: torch.nanquantile, midpoint, on NaN-masked samples,
   also bitwise equal; the port never calls it); and the least time the
   card could take (bytes over 3.35 TB/s or fp32 operations over
   67 TFLOP/s, whichever is larger);
4. end to end: DLSampleCreationConfig -> create_tile_job_configs ->
   run_export over a seeded 32-tile AOI with ~1,024 label polygons, per
   tile and batched (16 tiles per launch), each on the card and on the
   CPU with the plain versions; the card's GeoTIFF bytes must equal the
   CPU's on each path, and the image chips must be equal across all
   four runs. Once for the Sentinel-2 cloud-masked median (260 px, 13
   bands) and once for the nearest-date mosaic (RGB at 1.0 m). The
   launch counters are set to 0 just before the card's runs and read
   just after: every kernel must have been launched there;
5. serving: the U-Net at full width (TrainConfig defaults with batch 8:
   256 px RGB, 2 classes, base_features 32, 4 levels, s2d AUTO, which
   is s2d 2 at width 64; and the classic s2d 1 tree), seeded init, at
   bf16 and at fp32 (TF32 off). Each: predict_probs on 8 images on the
   card against a CPU copy of the same state dict on the first 2
   (fp32 logits within 1e-4 + 1e-4 relative; bf16 probabilities within
   5e-2; class maps equal where the top two are apart), the warm
   forward's CUDA-event time per batch of 8, images/s, the convs'
   FLOPs and their share of the card's peak (989 TFLOP/s bf16, 67
   TFLOP/s fp32), max memory allocated, and torch.profiler's top 5
   device ops and device-busy share over 5 forwards, and the forward's
   time with cuDNN's benchmark mode on and how far apart its logits are
   in two threads (the Trainer runs with it off: PyTorch keeps its
   algorithm choice per thread). Then a
   PredictServer on the card answers 24 concurrent chips (class maps
   == Trainer.predict), one 1000 x 1150 raster through
   predict_windowed_batched at stride 128 (== the offline
   predict_windowed), and one HTTP round trip each of /healthz,
   /predict (.npy and GeoTIFF) and /metrics; any errored request fails
   the run. The U-Net path has no hand-written kernel: its convs,
   GroupNorm and transposed convs are cuDNN/cuBLAS calls;
6. training, cmd_train's sequence at full width (TrainConfig defaults
   with num_classes=10: 256 px RGB, base_features 32, 4 levels, s2d
   AUTO = s2d 2 at width 64, batch 32, lr 1e-3, wd 1e-4, bf16): a
   32-tile RGB nearest-date export of 256 px chips on the card ->
   process_dataset_mp into 4 tifarr shards (every record read back with
   its CRCs checked) -> TFRecordFeed(scale="raw") -> DevicePrefetcher ->
   20 train_steps at the defaults and 20 with a cosine schedule, 5
   warmup steps and clipping at 1.0 (the mean loss of the last 5 steps
   must be below the first step's) -> DeviceDataPool.from_feed ->
   train_scanned (20 steps, 10 a dispatch, augmented, the pool
   refreshed from a live feed of 16-example batches while each dispatch
   runs; finite losses, and the pool must then hold the two refresh
   batches) ->
   evaluate on one pass over the shards -> save_checkpoint ->
   restore_checkpoint into a fresh Trainer, whose predict on 8 chips
   must equal the trained trainer's bitwise and whose PredictServer
   must answer the same class maps. Then 3 fp32 steps on 2 images from
   one state dict, twice on the card and once on the CPU (losses
   within 1e-4 relative; the largest parameter difference is printed;
   the two card runs must agree bitwise: the step takes cuDNN's
   deterministic algorithms), and at batch 32, bf16
   and fp32: the train step's CUDA-event time, images/s, share of the
   card's peak (3 x the forward's conv FLOPs), max memory allocated,
   and torch.profiler's top 5 device ops and device-busy share over 5
   steps; train_scanned's examples/s and duty cycles; the feed's
   records/s;
7. LocalCatalog + CLI, through ``cli.main`` in-process: a LocalCatalog
   root written with ``LocalCatalog.create`` + ``add_scene`` (10 seeded
   Sentinel-2 scenes of 13 uint16 bands with nodata over phase 4's
   AOI: one 10 m scene of >= 32 MiB, read windowed through the COG
   reader; two in zone 42 at 20 m, warped across zones; seven 10 m
   quarters, decoded whole into the scene LRU) -> ``create-chips
   --max-cloud-fraction 0`` at ``--batch-tiles`` 16 and 0, on the card
   and with ``--device cpu`` (card bytes == CPU bytes, 64 GeoTIFFs a
   run, K1-K3 launched, both read paths and a zone-42 scene taken,
   tiles/s of each) -> the verify sequence at full width on a
   nearest-date RGB export of 256 px chips from the same root:
   ``to-tfrecords --store-as-array``, ``inspect --verify-crc
   --class-stats``, ``train --mode tifarr`` at the TrainConfig defaults
   with 10 classes for 20 steps with ``--save-every 10`` (the loss must
   fall), again with ``--scan-steps 10``, ``eval --json``, ``stitch``,
   ``predict --geotiff`` and ``serve`` in a subprocess on port 0 (one
   /healthz, one /predict equal to ``predict``'s map, then SIGINT). Every
   command must exit 0; the seconds of each are printed.

The second-to-last line is one JSON object {"kernels": [...]}; the last
line is {"ok": true, "device": {...}}. Without a CUDA card the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import datetime as dt
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM data sheet (700 W): device-memory rate and fp32 rate outside
# the tensor cores
MEM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12  # dense, tensor cores
L2_BYTES = 50 * 2**20
# (S, H, W, B, wrapper reps) of the median cases: one 260 px tile of 13
# bands, the batched stack of 16 tiles, and a year of Sentinel-2 scenes
MEDIAN_CASES = [(10, 260, 260, 13, 20), (10, 4160, 260, 13, 5),
                (73, 260, 260, 13, 5)]
# fp32 operations a burn needs with ALL_TOUCHED, counted on what the
# inputs need rather than on what a kernel evaluates:
# * per (row, edge) pair whose y-span dilated 0.5 px meets the row
#   (inside the canvas and the feature's window): the y half of the box
#   test (2 compares), straddle (2 compares, 1 xor), cy - y0, the
#   division, the fused multiply-add (2), ny * (cy - y0), and the two
#   compares that place the crossing and the box in x -- 12;
# * per (pixel, edge) pair whose centre lies in the edge's bbox dilated
#   0.5 px: the x half of the box test (2 offsets, 2 compares), cx - x0,
#   the fused multiply-add (2), absolute value, compare with reach, and,
#   or into touch, and the parity compare, and, xor -- 14;
# * one per pixel: crossings of a row left of the box need no per-pixel
#   work beyond a running xor along the row.
BURN_ROW_EDGE_OPS = 12
BURN_PIXEL_EDGE_OPS = 14
# the full predicate on every (pixel, edge) pair of each feature's dilated
# bbox: parity 9 (2 compares, 3 subtractions, select, division, fused
# multiply-add as 2, compare) + touch 18 (4 min/max, 4 offsets, 4
# compares, 2 subtractions, multiply, fused multiply-add as 2, 3 absolute
# values, add, multiply, compare) -- rounded down to 27; kept as a second
# figure, comparable with earlier rows of PERF.md
BURN_OPS_PER_EDGE = 27
S2_BANDS = ["coastal-aerosol", "blue", "green", "red", "red-edge",
            "red-edge-2", "red-edge-3", "nir", "red-edge-4", "water-vapor",
            "cirrus", "swir1", "swir2"]


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn`` over ``reps`` runs, by CUDA events,
    after one warm-up run."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(launch, n=20, reps=10):
    """Mean milliseconds of one ``launch`` on the card alone: CUDA events
    around ``reps`` replays of a CUDA graph of ``n`` launches, so that no
    host work sits between them."""
    import torch
    launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            launch()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * n)


def spills(build_log):
    """(kernels compiled, lines of those that spill or keep a stack
    frame) from a build log of ``-Xptxas -v``."""
    lines = [ln.strip() for ln in build_log.splitlines()
             if "bytes stack frame" in ln]
    return len(lines), [ln for ln in lines
                        if re.search(r"\b[1-9]\d* bytes", ln)]


def bound(nbytes, nops):
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def median_case(S, H, W, B, seed):
    """Catalog-like scene stack: uint16 (S, H, W, B), blotchy (S, H, W)
    validity with some pixels invalid in every scene."""
    import torch
    rng = np.random.RandomState(seed)
    stack = rng.randint(0, 4096, size=(S, H, W, B)).astype(np.uint16)
    base = rng.rand(S, H // 16 + 1, W // 16 + 1)
    valid = np.kron(base, np.ones((1, 16, 16)))[:, :H, :W] > 0.3
    valid[:, :3, :3] = False
    return (torch.from_numpy(stack).cuda(), torch.from_numpy(valid).cuda())


def rotating_median_launches(stack, valid, launch):
    """(launch_next, outputs) for timing bare median launches: enough
    copies of (stack, valid), each with its own outputs, that together
    they exceed the L2, so that a replayed launch reads its inputs from
    device memory as the main path does; ``launch(stack, valid, med,
    any_valid)`` is called on the copies in turn."""
    import itertools
    import torch
    nbytes = stack.numel() * stack.element_size() + valid.numel()
    copies = L2_BYTES // nbytes + 1
    ins = [(stack, valid)] + [(stack.clone(), valid.clone())
                              for _ in range(copies - 1)]
    S, H, W, B = stack.shape
    outs = [(torch.full((H, W, B), float("nan"), device="cuda"),
             torch.ones((H, W, B), dtype=torch.bool, device="cuda"))
            for _ in range(copies)]
    turn = itertools.cycle(range(copies))

    def launch_next():
        i = next(turn)
        launch(*ins[i], *outs[i])
    return launch_next, outs


def median_compare(oc, S, H, W, B, reps):
    """One median case: the plain version, the bare kernel (on every
    input copy) and the wrapper, all bitwise equal, and the library's
    midpoint quantile on NaN-masked samples; times of each, and the
    bound."""
    import torch
    name = f"masked_median S={S} {H}x{W}x{B} uint16"
    stack, valid = median_case(S, H, W, B, seed=S + H)
    n = H * W * B
    nbytes = stack.numel() * 2 + valid.numel() + n * 4 + n
    nops = n * S * math.ceil(math.log2(max(S, 2)))  # comparison sort
    plain = lambda: oc.masked_median(stack, valid)  # noqa: E731
    ref = plain()
    bare, outs = rotating_median_launches(stack, valid,
                                          oc._launch_masked_median)
    for _ in outs:
        bare()
    torch.cuda.synchronize()
    if not all(torch.equal(m, ref[0]) and torch.equal(a, ref[1])
               for m, a in outs):
        raise AssertionError(f"{name}: bare kernel differs from the plain "
                             f"version")
    ms = graph_ms(bare, n=len(outs) * max(1, 20 // len(outs)))
    # the library's yardstick, nothing in the port calls it: invalid
    # samples as NaN, prepared outside the timed window
    x = torch.where(valid[..., None], stack.float(),
                    torch.tensor(float("nan"), device="cuda"))

    def library():
        q = torch.nanquantile(x, 0.5, dim=0, interpolation="midpoint")
        any_valid = ~torch.isnan(q)
        return torch.where(any_valid, q, 0.0), any_valid
    wrapper = lambda: oc.masked_median_kernel(stack, valid)  # noqa: E731
    err = 0.0
    for what, fn in (("torch.nanquantile", library), ("wrapper", wrapper)):
        got = fn()
        torch.cuda.synchronize()
        err = max(err, float((got[0] - ref[0]).abs().max()))
        if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
            raise AssertionError(f"{name}: {what} differs from the plain "
                                 f"version (max abs err {err})")
    wrapper_ms = cuda_ms(wrapper, reps)
    plain_ms = cuda_ms(plain, 2)
    library_ms = cuda_ms(library, 2)
    bound_ms, bound_by = bound(nbytes, nops)
    row = {"case": name, "equal": True, "max_abs_err": err, "ms": ms,
           "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "input_copies": len(outs)}
    log(f"  {name}: equal; kernel alone {ms:.4f} ms ({len(outs)} input "
        f"copies), wrapper {wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch.nanquantile {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}), {bound_ms / ms:.1%} of bound")
    return row


def star_features(rng, F, E, xlo, xhi, ylo, yhi, rmin, rmax):
    """F star polygons of E vertices (pixel coordinates)."""
    theta = np.linspace(0, 2 * np.pi, E, endpoint=False)
    cx = rng.uniform(xlo, xhi, F)
    cy = rng.uniform(ylo, yhi, F)
    rad = rng.uniform(rmin, rmax, (F, 1)) * (1 + 0.3 * rng.rand(F, E))
    px = cx[:, None] + rad * np.cos(theta)[None]
    py = cy[:, None] + rad * np.sin(theta)[None]
    values = rng.randint(1, 255, F)
    return [([np.stack([px[f], py[f]], 1)], float(values[f]))
            for f in range(F)]


def burn_work(edges, windows, height, width, bins=None):
    """(bytes, operations, operations over all pairs) of one burn with
    ALL_TOUCHED. Bytes: what these inputs need read once -- the real
    edges (16 bytes each), 32 bytes (bbox, window, edge count, value)
    for each feature the kernel culls (all F of the dense kernel, the
    binned ones of the binned kernel), and with ``bins`` = (count,
    table) the count array and the count[b] table entries of each
    block -- and the float32 canvas written once. Padding edges,
    padded features and unused table slots are not read and not
    counted. Operations: BURN_ROW_EDGE_OPS per (row, edge) pair and
    BURN_PIXEL_EDGE_OPS per (pixel, edge) pair that these inputs need,
    plus one per pixel. Operations over all pairs: pixels of each
    feature's 0.5 px dilated bbox inside its row window and the canvas,
    times its real edges, times BURN_OPS_PER_EDGE."""
    real = edges[:, :, 0] != -1.0e9
    x0, y0, x1, y1 = (edges[:, :, i].astype(np.float64) for i in range(4))
    w0, w1 = (windows[:, i:i + 1].astype(np.float64) for i in range(2))
    # rows r (centre r + 0.5) with r + 1 >= min y, r <= max y, inside
    # the window and the canvas; columns likewise against the x span
    r0 = np.maximum(np.maximum(np.ceil(np.minimum(y0, y1) - 1.0),
                               np.ceil(w0 - 0.5)), 0)
    r1 = np.minimum(np.minimum(np.floor(np.maximum(y0, y1)),
                               np.ceil(w1 - 0.5) - 1), height - 1)
    c0 = np.maximum(np.ceil(np.minimum(x0, x1) - 1.0), 0)
    c1 = np.minimum(np.floor(np.maximum(x0, x1)), width - 1)
    rows = np.where(real, np.clip(r1 - r0 + 1, 0, None), 0)
    cols = np.clip(c1 - c0 + 1, 0, None)
    ops = (BURN_ROW_EDGE_OPS * int(rows.sum())
           + BURN_PIXEL_EDGE_OPS * int((rows * cols).sum())
           + height * width)

    ne = real.sum(1)
    xs = np.where(real[..., None], edges[:, :, 0::2], np.nan)
    ys = np.where(real[..., None], edges[:, :, 1::2], np.nan)
    all_pairs = 0
    for f in np.nonzero(ne)[0]:
        x0 = max(0, math.ceil(np.nanmin(xs[f]) - 1.0))
        x1 = min(width, math.floor(np.nanmax(xs[f])) + 1)
        y0 = max(0, math.ceil(max(np.nanmin(ys[f]) - 1.0,
                                  windows[f, 0] - 0.5)))
        y1 = min(height, math.floor(min(np.nanmax(ys[f]),
                                        windows[f, 1] - 0.5)) + 1)
        all_pairs += max(0, x1 - x0) * max(0, y1 - y0) * int(ne[f])
    if bins is None:
        n_read, table_bytes = len(edges), 0
    else:
        count, table = bins
        used = np.arange(table.shape[2]) < count[..., None]
        n_read = len(np.unique(table[used]))
        table_bytes = 4 * (int(count.sum()) + count.size)
    nbytes = (16 * int(real.sum()) + 32 * n_read + table_bytes
              + height * width * 4)
    return nbytes, ops, all_pairs * BURN_OPS_PER_EDGE


def burn_compare(rz, kind, label, feats, H, W):
    """One burn case: the plain version, the bare kernel and the wrapper,
    all bitwise equal; times of each, and bounds."""
    import torch
    name = f"{kind} {label}"
    e, v, w = rz.pack_features(feats)
    if (kind == "burn_binned") != (len(e) > rz._BIN_THRESHOLD):
        raise AssertionError(f"{label}: dispatch would not take {kind}")
    ins = [torch.from_numpy(x).cuda()
           for x in (e, v, w, *rz.feature_bounds(e))]
    bins = (rz._bin_features(e, w, H, W, *rz.BURN_BLOCK)
            if kind == "burn_binned" else None)
    nbytes, nops, nops_all = burn_work(e, w, H, W, bins)
    tables = [torch.from_numpy(x).cuda() for x in bins or ()]
    burn, launch = ((rz.burn_dense, rz._launch_burn_dense)
                    if kind == "burn_dense"
                    else (rz.burn_binned, rz._launch_burn_binned))
    plain = lambda: rz._rasterize_torch(ins[0], ins[1], 255.0, H, W, True,  # noqa: E731
                                        ins[2])
    wrapper = lambda: burn(*ins, *tables, 255.0, H, W, True)  # noqa: E731
    ref = plain()
    out = torch.empty((H, W), dtype=torch.float32, device="cuda")
    # the kernel alone, every input prepared once
    bare = lambda: launch(*ins, *tables, 255.0, True, out)  # noqa: E731
    out.fill_(float("nan"))
    bare()
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise AssertionError(f"{name}: bare kernel differs from the plain "
                             f"version")
    ms = graph_ms(bare)
    got = wrapper()
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    if not torch.equal(got, ref):
        raise AssertionError(f"{name}: wrapper differs from the plain "
                             f"version (max abs err {err})")
    wrapper_ms = cuda_ms(wrapper, 10)
    plain_ms = cuda_ms(plain, 1)
    bound_ms, bound_by = bound(nbytes, nops)
    bound_all_ms, _ = bound(nbytes, nops_all)
    row = {"case": name, "equal": True, "max_abs_err": err, "ms": ms,
           "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_ms_all_pairs": bound_all_ms, "bytes": nbytes,
           "operations": nops, "operations_all_pairs": nops_all}
    log(f"  {name}: equal; kernel alone {ms:.4f} ms, "
        f"wrapper {wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}; {bound_all_ms:.4f} counting all "
        f"pairs), {bound_ms / ms:.1%} of bound")
    return row


def kernel_phase():
    from dl_image_segmentation_tpu_torch.ops import compositing as oc
    import importlib
    rz = importlib.import_module("dl_image_segmentation_tpu_torch.ops."
                                 "rasterize")
    rows = {"masked_median": [], "burn_dense": [], "burn_binned": []}

    log("phase 3: kernel vs plain on the card")
    for S, H, W, B, reps in MEDIAN_CASES:
        rows["masked_median"].append(median_compare(oc, S, H, W, B, reps))

    def burn_cases():
        rng = np.random.RandomState(3)
        # one 260 px tile: ~48 features of up to 256 edges (dense)
        feats = star_features(rng, 48, 256, 10, 250, 10, 250, 4, 26)
        for f, (rings, v) in enumerate(feats):
            k = rng.randint(3, 257)
            feats[f] = ([rings[0][:: max(1, 256 // k)]], v)
        yield "burn_dense", "tile 260x260, 48 features", feats, (260, 260)
        # the batched canvas: 16 tiles stacked by rows, row windows
        feats = []
        for k in range(16):
            for rings, v in star_features(rng, 40, 256, 10, 250, -20, 280,
                                          4, 26):
                shifted = [np.stack([r[:, 0], r[:, 1] + k * 260], 1)
                           for r in rings]
                feats.append((shifted, v, (k * 260.0, (k + 1) * 260.0)))
        yield ("burn_binned", "batched 4160x260, 640 features, row windows",
               feats, (4160, 260))
        # production scale: 1,024 features x 256 edges on 1,024^2
        yield ("burn_binned", "1024x1024, 1024 features x 256 edges",
               star_features(rng, 1024, 256, 40, 984, 40, 984, 8, 25.6),
               (1024, 1024))

    for kind, label, feats, (H, W) in burn_cases():
        rows[kind].append(burn_compare(rz, kind, label, feats, H, W))
    return rows


def write_labels(path, zone, res, nx, ny, n, seed):
    """Seeded GeoJSON: ``n`` star polygons of 3..256 vertices, integer
    attribute ``cls``, inside an nx x ny block of 256-px tiles at
    ``res`` metres (away from its outer edge, so that planning yields
    exactly those tiles)."""
    from dl_image_segmentation_tpu_torch.geo import Tile, crs
    rng = np.random.RandomState(seed)
    x0, y0, _, _ = Tile(256, 2, res, zone, -10, 1400).bounds_unpadded
    span = 256 * res
    margin = 0.12 * span
    feats = []
    for _ in range(n):
        k = rng.randint(3, 257)
        c = (rng.uniform(x0 + margin, x0 + nx * span - margin),
             rng.uniform(y0 + margin, y0 + ny * span - margin))
        ang = np.sort(rng.rand(k) * 2 * np.pi)
        rad = rng.uniform(0.02, 0.1) * span * (0.6 + 0.4 * rng.rand(k))
        ex = c[0] + rad * np.cos(ang)
        ey = c[1] + rad * np.sin(ang)
        lon, lat = crs.utm_to_lonlat(np.r_[ex, ex[:1]], np.r_[ey, ey[:1]],
                                     zone)
        feats.append({"type": "Feature",
                      "geometry": {"type": "Polygon", "coordinates": [
                          np.stack([lon, lat], 1).tolist()]},
                      "properties": {"cls": int(rng.randint(1, 10))}})
    with open(path, "w") as f:
        json.dump({"type": "FeatureCollection", "features": feats}, f)
    return path


def read_tree(folder):
    out = {}
    for sub in ("images", "labels"):
        d = os.path.join(folder, sub)
        for name in sorted(os.listdir(d)):
            with open(os.path.join(d, name), "rb") as f:
                out[f"{sub}/{name}"] = f.read()
    return out


def export_phase(tmp, card):
    import torch
    from dl_image_segmentation_tpu_torch import kernels
    from dl_image_segmentation_tpu_torch.catalog import SyntheticCatalog
    from dl_image_segmentation_tpu_torch.pipeline.chips import (
        DLSampleCreationConfig, OGRLabelDataDesc)
    from dl_image_segmentation_tpu_torch.pipeline.export import run_export

    log("phase 4: end to end")
    launches = {c.name: 0 for c in kernels.COUNTERS}
    runs = []
    modes = [("median", "sentinel-2:L1C", S2_BANDS, 10.0, 0),
             ("nearest", "airbus:oneatlas:phr:v2", "red green blue", 1.0,
              None)]
    for mode, product, bands, res, mcf in modes:
        labels = write_labels(os.path.join(tmp, f"{mode}.geojson"), 43, res,
                              8, 4, 1024, seed=11)
        trees = {}
        for device, batch in (("cuda", 0), ("cuda", 16), ("cpu", 0),
                              ("cpu", 16)):
            root = os.path.join(tmp, f"{mode}-{device}-{batch}")
            cfg = DLSampleCreationConfig(
                260, 2, res, product, bands, root, "smoke",
                OGRLabelDataDesc(labels, 0, "cls"), max_cloud_fraction=mcf,
                catalog=SyntheticCatalog())
            jobs = cfg.create_tile_job_configs("aoi", 2020,
                                               dt.date(2020, 11, 1))
            if len(jobs) != 32:
                raise AssertionError(f"{mode}: {len(jobs)} tiles, not 32")
            if device == "cuda":
                torch.cuda.synchronize()
                for c in kernels.COUNTERS:
                    c.reset()
            t0 = time.perf_counter()
            report = run_export(jobs, n_workers=8, progress=None,
                                batch_tiles=batch, device=device)
            if device == "cuda":
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = {c.name: c.count for c in kernels.COUNTERS}
            if device == "cuda":
                for k, v in counts.items():
                    launches[k] += v
            if not report.ok or report.attempts != 1:
                raise AssertionError(f"{mode} {device} batch={batch}: "
                                     f"failed {report.failed}, attempts "
                                     f"{report.attempts}")
            trees[(device, batch)] = read_tree(jobs[0].OUTFOLDER)
            run = {"mode": mode, "device": device, "batch_tiles": batch,
                   "tiles": len(jobs), "seconds": secs,
                   "tiles_per_s": len(jobs) / secs,
                   "launches": counts if device == "cuda" else None,
                   "key": jobs[0].DLTILE.key}
            runs.append(run)
            log(f"  {mode} {device} batch_tiles={batch}: {len(jobs)} tiles "
                f"in {secs:.3f} s = {run['tiles_per_s']:.3f} tiles/s on "
                f"{card if device == 'cuda' else 'the host CPU'}; launches "
                f"{counts if device == 'cuda' else '-'}")
        for batch in (0, 16):
            ref, got = trees[("cpu", batch)], trees[("cuda", batch)]
            if len(ref) != 64:
                raise AssertionError(f"{mode}: {len(ref)} files, not 64")
            if got != ref:
                bad = [k for k in ref if got.get(k) != ref[k]][:3]
                raise AssertionError(f"{mode} batch_tiles={batch}: card's "
                                     f"bytes differ from the CPU's, e.g. "
                                     f"{bad}")
        images = {k: v for k, v in ref.items() if k.startswith("images/")}
        for key, tree in trees.items():
            if any(tree[k] != v for k, v in images.items()):
                raise AssertionError(f"{mode} {key}: image chips differ "
                                     f"from the CPU's batched run")
        # The batched burn shifts tile k's geometry by k * 260 rows in
        # float32 and so rounds the predicate differently from the
        # per-tile burn (as the JAX package's batched burn does): a few
        # boundary pixels may differ between the two, never between the
        # card and the CPU on the same path.
        moved = sorted(k for k in ref if k.startswith("labels/")
                       and trees[("cpu", 0)][k] != ref[k])
        log(f"  {mode}: card == CPU bytes per tile and batched (64 "
            f"GeoTIFFs each); images equal across all four runs; "
            f"{len(moved)} of 32 label chips differ between per-tile and "
            f"batched burns {moved[:4]}")
        # the chips are valid rasters of the expected shape
        img = next(v for k, v in ref.items() if k.startswith("images/"))
        if img[:4] != b"II*\x00":
            raise AssertionError(f"{mode}: image chip is not a TIFF")
    for name in ("masked_median", "burn_dense", "burn_binned"):
        if launches[name] == 0:
            raise AssertionError(f"{name}: not launched on the main path")
    return launches, runs


def forward_ms(trainer, x, reps=20):
    """Warm CUDA-event milliseconds of one ``trainer.logits`` forward on
    the device batch ``x``."""
    return cuda_ms(lambda: trainer.logits(x), reps)


def benchmark_mode(trainer, x, reps=20):
    """The forward with cuDNN's benchmark mode on, which
    ``Trainer.logits`` turns off: (warm milliseconds, largest difference
    between the logits of two threads). PyTorch keeps the algorithms that
    benchmark mode picks per thread, so each forward runs in a new thread
    (which also keeps this thread's choices out of it), and a server's
    worker thread may not compute the bits that ``predict`` does. ``x``
    holds floats, so the model sees what ``logits`` would give it."""
    import threading
    import torch
    cudnn = torch.backends.cudnn
    saved = cudnn.benchmark, cudnn.allow_tf32
    cudnn.benchmark = True
    cudnn.allow_tf32 = trainer.compute_dtype != torch.float32
    xm = x.permute(0, 3, 1, 2)
    runs = []

    def forward():
        with torch.inference_mode():
            return trainer.model(xm)

    def run(timed):
        ms = cuda_ms(forward, reps) if timed else None
        runs.append((ms, forward()))
    try:
        for timed in (True, False):
            th = threading.Thread(target=run, args=(timed,))
            th.start()
            th.join(timeout=300)
    finally:
        cudnn.benchmark, cudnn.allow_tf32 = saved
    if len(runs) != 2:
        raise AssertionError("a benchmark-mode forward did not finish")
    return runs[0][0], float((runs[0][1] - runs[1][1]).abs().max())


def profile_steps(fn, n=5):
    """torch.profiler over ``n`` steady calls of ``fn`` (a forward or a
    train step): (top 5 (kernel, device ms per call) by device time,
    device-busy share: the kernels' time over the window's wall time);
    busy share None when the profiler reports no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0)) or 0
    # the kernels themselves (device events), not the aten ops that
    # launched them, so that no time is counted twice
    rows = sorted((e for e in prof.key_averages()
                   if getattr(e, "device_type", None) == DeviceType.CUDA),
                  key=dev_us, reverse=True)
    total_us = sum(dev_us(e) for e in rows)
    top = [(e.key, dev_us(e) / 1e3 / n) for e in rows[:5] if dev_us(e)]
    return top, (total_us / 1e6 / wall if total_us else None)


def top2_gap(x):
    s = np.sort(x, axis=-1)
    return s[..., -1] - s[..., -2]


def card_vs_cpu(card_t, cpu_t, images):
    """Card against CPU on the first 2 images: fp32 logits within 1e-4 +
    1e-4 relative and class maps equal where the CPU's top two logits
    differ by more than 1e-3; bf16 probabilities within 5e-2 and class
    maps equal where the CPU's top two probabilities differ by more than
    0.1. Returns the largest difference."""
    import torch
    x = images[:2]
    card = card_t.predict_probs(images)[:2]
    ref = cpu_t.predict_probs(x)
    cls = card_t.predict(images)[:2]
    if card_t.config.precision == "fp32":
        got = card_t.logits(torch.from_numpy(images).cuda())[:2].cpu().numpy()
        want = cpu_t.logits(torch.from_numpy(x)).numpy()
        err = float(np.abs(got - want).max())
        if not np.all(np.abs(got - want) <= 1e-4 + 1e-4 * np.abs(want)):
            raise AssertionError(f"fp32 logits: card differs from the CPU "
                                 f"by {err}")
        sure = top2_gap(want) > 1e-3
        want_cls = want.argmax(-1)
    else:
        err = float(np.abs(card - ref).max())
        if err > 5e-2:
            raise AssertionError(f"bf16 probabilities: card differs from "
                                 f"the CPU by {err}")
        sure = top2_gap(ref) > 0.1
        want_cls = ref.argmax(-1)
    if not np.array_equal(cls[sure], want_cls[sure]):
        raise AssertionError("class maps: card differs from the CPU where "
                             "the top two are apart")
    if not np.all(np.isfinite(card)) or card.shape != ref.shape:
        raise AssertionError("probabilities not finite or misshapen")
    return err, float(sure.mean())


def serve_requests(ps, images):
    """Submit every image at once from its own thread; returns (pendings,
    seconds from the first submit to the last result, latencies)."""
    import threading
    pend = [None] * len(images)
    done = [0.0] * len(images)

    def call(i):
        pend[i] = ps.submit(images[i], probs=False, timeout=120)
        done[i] = time.perf_counter()
    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(images))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    if any(t.is_alive() for t in threads):
        raise AssertionError("a served request hung")
    return pend, max(done) - t0, [d - p.t0 for d, p in zip(done, pend)]


def http_round_trip(ps, trainer, rng):
    """/healthz, /predict (.npy), /predict (GeoTIFF) and /metrics over
    127.0.0.1; the served class maps must equal ``predict``'s."""
    import io
    import threading
    import urllib.request
    from dl_image_segmentation_tpu_torch.raster import encode_geotiff
    from dl_image_segmentation_tpu_torch.serve import (make_http_server,
                                                       scale_image)
    httpd = make_http_server("127.0.0.1", 0, ps)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    size = trainer.config.image_size
    bs = trainer.config.batch_size

    def post(body):
        req = urllib.request.Request(base + "/predict", data=body,
                                     method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            return np.load(io.BytesIO(r.read()))

    def alone(img):
        batch = np.zeros((bs,) + img.shape, np.float32)
        batch[0] = img
        return trainer.predict(batch)[0]
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        if not health["ok"] or health["batch_size"] != bs:
            raise AssertionError(f"/healthz: {health}")
        img = rng.rand(size, size, 3).astype(np.float32)
        buf = io.BytesIO()
        np.save(buf, img)
        if not np.array_equal(post(buf.getvalue()), alone(img)):
            raise AssertionError("/predict (.npy) differs from predict")
        img8 = rng.randint(0, 256, (size, size, 3)).astype(np.uint8)
        got = post(encode_geotiff(img8, epsg=32643))
        if not np.array_equal(got, alone(scale_image(img8, "auto"))):
            raise AssertionError("/predict (GeoTIFF) differs from predict")
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            metrics = r.read().decode()
        served = [ln for ln in metrics.splitlines()
                  if ln.startswith("dlseg_requests_served_total ")]
        if not served:
            raise AssertionError("/metrics lacks dlseg_requests_served_total")
        return health, served[0]
    finally:
        httpd.shutdown()
        thread.join(timeout=30)


def serving_phase(smi):
    """U-Net serving at full width on the card: card against CPU, forward
    times, the micro-batching server, a windowed raster and HTTP."""
    import torch
    from dl_image_segmentation_tpu_torch.pipeline.window import (
        predict_windowed, window_origins)
    from dl_image_segmentation_tpu_torch.serve import (
        PredictServer, predict_windowed_batched)
    from dl_image_segmentation_tpu_torch.train import TrainConfig, Trainer

    log("phase 5: serving")
    rng = np.random.RandomState(5)
    out = {"forward": [], "serve": None}
    configs = [("TrainConfig defaults, batch 8, s2d AUTO", {}),
               ("classic tree (s2d 1)", {"s2d": 1})]
    serve_trainer = None
    for label, kw in configs:
        for precision in ("bf16", "fp32"):
            cfg = TrainConfig(batch_size=8, precision=precision, **kw)
            card_t = Trainer(cfg)
            cpu_t = Trainer(cfg, device="cpu")
            cpu_t.model.load_state_dict(card_t.model.state_dict())
            images = rng.rand(8, 256, 256, 3).astype(np.float32)
            err, sure = card_vs_cpu(card_t, cpu_t, images)
            del cpu_t
            x = torch.from_numpy(images).cuda()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = forward_ms(card_t, x)
            peak_mem = torch.cuda.max_memory_allocated()
            flops = card_t.model.conv_flops(256, 256)
            peak = BF16_OPS_PER_S if precision == "bf16" else FP32_OPS_PER_S
            share = flops * 8 / (ms / 1e3) / peak
            top, busy = profile_steps(lambda: card_t.logits(x))
            bench_ms, bench_diff = benchmark_mode(card_t, x)
            row = {"config": label, "precision": precision,
                   "s2d": card_t.s2d, "width": card_t.model_features,
                   "forward_ms": ms, "images_per_s": 8 / (ms / 1e3),
                   "cudnn_benchmark_mode_ms": bench_ms,
                   "cudnn_benchmark_mode_thread_diff": bench_diff,
                   "gflop_per_image": flops / 1e9, "peak_share": share,
                   "max_memory_allocated": peak_mem,
                   "card_vs_cpu_max_err": err, "decided_share": sure,
                   "device_busy_share": busy,
                   "top_device_ops": [[k, v] for k, v in top]}
            out["forward"].append(row)
            log(f"  {label}, {precision} (s2d {card_t.s2d}, width "
                f"{card_t.model_features}): card vs CPU max "
                f"{'logit' if precision == 'fp32' else 'probability'} "
                f"difference {err:.3g} ({sure:.1%} of pixels decided); "
                f"forward {ms:.4f} ms per batch of 8 = "
                f"{row['images_per_s']:.1f} images/s; "
                f"{flops / 1e9:.3f} GFLOP per image = {share:.2%} of "
                f"{peak / 1e12:.0f} TFLOP/s ({smi}); max memory allocated "
                f"{peak_mem / 2**20:.1f} MiB; with cuDNN benchmark mode "
                f"(not used) {bench_ms:.4f} ms, logits of two threads "
                f"apart by {bench_diff:.3g}")
            log("    device-busy share over 5 forwards: "
                + (f"{busy:.1%}" if busy is not None else "not measured")
                + "; top device ops (ms per forward): "
                + "; ".join(f"{k[:70]} {v:.4f}" for k, v in top))
            if label == configs[0][0] and precision == "bf16":
                serve_trainer = card_t
            else:
                del card_t
            del x
            torch.cuda.empty_cache()

    trainer = serve_trainer
    ps = PredictServer(trainer, max_wait_ms=5.0)
    try:
        chips = rng.rand(24, 256, 256, 3).astype(np.float32)
        serve_requests(ps, chips[:8])  # warm-up
        batches0 = ps.batches
        pend, secs, lat = serve_requests(ps, chips)
        errors = [p.error for p in pend if p.error is not None]
        if errors:
            raise AssertionError(f"served requests errored: {errors[:3]}")
        dispatches = ps.batches - batches0
        want = np.concatenate([trainer.predict(chips[i:i + 8])
                               for i in range(0, 24, 8)])
        if not all(np.array_equal(p.result, w) for p, w in zip(pend, want)):
            raise AssertionError("served class maps differ from predict's")
        # an odd, unpadded batch, as __graft_entry__.py:146 asserts
        seven = trainer.predict(chips[:7])
        if not all(np.array_equal(p.result, w) for p, w in zip(pend, seven)):
            raise AssertionError("served class maps differ from predict of "
                                 "7 images")
        raster = rng.rand(1000, 1150, 3).astype(np.float32)
        n_win = (len(window_origins(1000, 256, 128))
                 * len(window_origins(1150, 256, 128)))
        t0 = time.perf_counter()
        served_probs = predict_windowed_batched(ps, raster, stride=128,
                                                probs=True)
        win_secs = time.perf_counter() - t0
        served_cls = predict_windowed_batched(ps, raster, stride=128)
        offline = predict_windowed(trainer, raster, stride=128,
                                   scale="none", probs=True)
        if not np.array_equal(served_probs, offline):
            raise AssertionError("windowed probabilities differ from the "
                                 "offline predict_windowed's")
        if not np.array_equal(served_cls, offline.argmax(-1)):
            raise AssertionError("windowed class map differs from the "
                                 "offline predict_windowed's")
        health, served_line = http_round_trip(ps, trainer, rng)
        if ps.errors:
            raise AssertionError(f"{ps.errors} server batches failed")
    finally:
        ps.close()
    lat = sorted(lat)
    out["serve"] = {
        "requests": 24, "seconds": secs, "requests_per_s": 24 / secs,
        "p50_latency_s": lat[len(lat) // 2], "max_latency_s": lat[-1],
        "dispatches": dispatches, "windowed_windows": n_win,
        "windowed_seconds": win_secs, "served_total": served_line}
    log(f"  PredictServer on the card (bf16, s2d {trainer.s2d}): 24 "
        f"concurrent chips in {secs:.4f} s = {24 / secs:.1f} requests/s, "
        f"p50 latency {lat[len(lat) // 2] * 1e3:.2f} ms, {dispatches} "
        f"dispatches; served == predict")
    log(f"  windowed 1000 x 1150 at stride 128: {n_win} windows in "
        f"{win_secs:.3f} s, probabilities and class map == offline "
        f"predict_windowed; HTTP /healthz, /predict (.npy, GeoTIFF) == "
        f"predict, /metrics '{served_line}'")
    return out


def train_steps(trainer, feed, steps):
    """``steps`` train_steps fed by TFRecordFeed -> DevicePrefetcher
    (pinned batches copied on a side stream); the per-step losses."""
    from dl_image_segmentation_tpu_torch.pipeline.input import (
        DevicePrefetcher)
    losses = []
    with DevicePrefetcher(iter(feed), trainer.place_batch) as pf:
        for _ in range(steps):
            losses.append(trainer.train_step(*next(pf))["loss"])
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not np.mean(losses[-5:]) < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    return losses


def step_numbers(trainer, x, y, smi, reps=10):
    """Warm CUDA-event ms of one train step on the device batch (x, y),
    images/s, the convs' share of the card's peak (3 x forward FLOPs),
    max memory allocated, and the profiler's top device ops and
    device-busy share over 5 steps."""
    import torch
    n = x.shape[0]
    step = lambda: trainer.train_step_async(x, y)  # noqa: E731
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(step, reps)
    peak_mem = torch.cuda.max_memory_allocated()
    size = trainer.config.image_size
    flops = 3 * trainer.model.conv_flops(size, size) * n
    fp32 = trainer.compute_dtype == torch.float32
    peak = FP32_OPS_PER_S if fp32 else BF16_OPS_PER_S
    top, busy = profile_steps(step)
    row = {"precision": trainer.config.precision, "batch": n,
           "train_step_ms": ms, "images_per_s": n / (ms / 1e3),
           "gflop_per_step": flops / 1e9,
           "peak_share": flops / (ms / 1e3) / peak,
           "max_memory_allocated": peak_mem, "device_busy_share": busy,
           "top_device_ops": [[k, v] for k, v in top]}
    log(f"  train step at {row['precision']}, batch {n}: {ms:.4f} ms = "
        f"{row['images_per_s']:.1f} images/s; {flops / 1e9:.1f} GFLOP a "
        f"step = {row['peak_share']:.2%} of {peak / 1e12:.0f} TFLOP/s "
        f"({smi}); max memory allocated {peak_mem / 2**20:.1f} MiB; "
        "device-busy share over 5 steps "
        + (f"{busy:.1%}" if busy is not None else "not measured"))
    log("    top device ops (ms a step): "
        + "; ".join(f"{k[:70]} {v:.4f}" for k, v in top))
    return row


def card_vs_cpu_steps(cfg, x, y, steps=3):
    """``steps`` fp32 train steps on (x, y) from one state dict, twice on
    the card and once on the CPU: per-step loss differences (card against
    CPU, within 1e-4 relative), the largest parameter difference, and the
    two card runs, which must agree bitwise (the step takes cuDNN's
    deterministic algorithms)."""
    import torch
    from dl_image_segmentation_tpu_torch.train import Trainer
    first = Trainer(cfg)
    state = {k: v.detach().cpu().clone()
             for k, v in first.model.state_dict().items()}
    runs = []
    for device in ("cuda", "cuda", "cpu"):
        t = first if not runs else Trainer(cfg, device=device)
        t.model.load_state_dict(state)
        losses = [t.train_step(x, y)["loss"] for _ in range(steps)]
        runs.append((losses, {n: p.detach().cpu()
                              for n, p in t.state.params.items()}))
        del t
    (card, p_card), (card2, p_card2), (cpu, p_cpu) = runs
    rel = [abs(a - b) / abs(b) for a, b in zip(card, cpu)]
    if max(rel) > 1e-4:
        raise AssertionError(f"fp32 steps: card losses {card} differ from "
                             f"the CPU's {cpu}")
    param_diff = max(float((p_card[n] - p_cpu[n]).abs().max())
                     for n in p_cpu)
    bitwise = card == card2 and all(torch.equal(p_card[n], p_card2[n])
                                    for n in p_card)
    if not bitwise:
        raise AssertionError("two card runs of the same fp32 steps differ")
    return {"card_losses": card, "cpu_losses": cpu,
            "loss_rel_diff": rel, "max_param_diff": param_diff,
            "card_runs_bitwise_equal": bitwise}


def training_phase(smi):
    """U-Net training at full width on the card from exported chips to a
    served checkpoint (TrainConfig defaults with num_classes=10)."""
    import torch
    from dl_image_segmentation_tpu_torch.catalog import SyntheticCatalog
    from dl_image_segmentation_tpu_torch.pipeline.chips import (
        DLSampleCreationConfig, OGRLabelDataDesc)
    from dl_image_segmentation_tpu_torch.pipeline.export import run_export
    from dl_image_segmentation_tpu_torch.pipeline.input import TFRecordFeed
    from dl_image_segmentation_tpu_torch.records import (
        list_shards, process_dataset_mp, read_records)
    from dl_image_segmentation_tpu_torch.serve import PredictServer
    from dl_image_segmentation_tpu_torch.train import (
        DeviceDataPool, TrainConfig, Trainer)

    log(f"phase 6: training ({smi})")
    kw = {"num_classes": 10}
    cfg = TrainConfig(**kw)
    bs = cfg.batch_size
    out = {"config": {k: getattr(cfg, k) for k in (
        "num_classes", "base_features", "levels", "image_size",
        "batch_size", "learning_rate", "weight_decay", "precision")}}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        # 1. export: 32 RGB nearest-date tiles of 256 px chips
        labels = write_labels(os.path.join(tmp, "labels.geojson"), 43, 1.0,
                              8, 4, 1024, seed=11)
        dlcfg = DLSampleCreationConfig(
            256, 0, 1.0, "airbus:oneatlas:phr:v2", "red green blue",
            os.path.join(tmp, "chips"), "smoke",
            OGRLabelDataDesc(labels, 0, "cls"), catalog=SyntheticCatalog())
        jobs = dlcfg.create_tile_job_configs("aoi", 2020,
                                             dt.date(2020, 11, 1))
        if len(jobs) != 32:
            raise AssertionError(f"export: {len(jobs)} tiles, not 32")
        t0 = time.perf_counter()
        report = run_export(jobs, n_workers=8, progress=None)
        if not report.ok:
            raise AssertionError(f"export failed: {report.failed}")
        out["export_seconds"] = time.perf_counter() - t0
        # 2. shards: 4 tifarr shards, every record's CRCs checked
        shards = os.path.join(tmp, "shards")
        t0 = time.perf_counter()
        written = process_dataset_mp("smoke", jobs[0].OUTFOLDER, shards, 4,
                                     store_as_array=True)
        out["shard_seconds"] = time.perf_counter() - t0
        files = list_shards(shards, "smoke")
        n_rec = sum(1 for f in files for _ in read_records(f,
                                                           verify_crc=True))
        if written != 32 or len(files) != 4 or n_rec != 32:
            raise AssertionError(f"shards: {written} written, {len(files)} "
                                 f"files, {n_rec} records")
        log(f"  export: 32 tiles of 256 px in {out['export_seconds']:.3f}"
            f" s; 4 tifarr shards ({written} records, CRCs checked) in "
            f"{out['shard_seconds']:.3f} s")
        pattern = os.path.join(shards, "smoke-*")

        def feed(**over):
            return TFRecordFeed(pattern, "tifarr", **{
                "batch_size": bs, "image_size": cfg.image_size,
                "scale": "raw", **over})
        # feed alone: records/s through parse and batching (host only)
        f = iter(feed(seed=3))
        next(f)
        t0 = time.perf_counter()
        for _ in range(4):
            next(f)
        out["feed_records_per_s"] = 4 * bs / (time.perf_counter() - t0)
        del f
        # 3. steps: TFRecordFeed -> DevicePrefetcher -> train_step
        runs = {}
        for name, extra in (("defaults", {}),
                            ("cosine, warmup 5, clip 1.0",
                             {"schedule": "cosine", "warmup_steps": 5,
                              "grad_clip_norm": 1.0})):
            t = Trainer(TrainConfig(**kw, **extra))
            runs[name] = train_steps(t, feed(seed=1), 20)
            log(f"  20 steps ({name}): losses {runs[name][0]:.4f} -> "
                f"{np.mean(runs[name][-5:]):.4f} (mean of the last 5)")
            if name == "defaults":
                trainer = t
        out["losses"] = runs
        # 4. scanned: a pool of 32 on the device, 10 steps a dispatch; a
        # live feed of 16-example batches refreshes the pool after each
        # dispatch (offsets 0, then 16) while the dispatch runs
        pool = DeviceDataPool.from_feed(iter(feed(seed=2)), 32)
        given = []

        def refresh_batches():
            for b in feed(seed=6, batch_size=16):
                given.append(b)
                yield b
        step0 = trainer.state.step
        trainer.wall_start = None
        trainer.device_seconds = trainer.feed_seconds = 0.0
        trainer.examples_seen = 0
        refresh = refresh_batches()
        scan = trainer.train_scanned(pool, total_steps=20,
                                     steps_per_dispatch=10, augment=True,
                                     refresh_feed=refresh)
        refresh.close()  # stops the feed's parse threads
        if (trainer.state.step != step0 + 20
                or not np.all(np.isfinite(trainer.scan_losses[-20:]))):
            raise AssertionError(f"train_scanned: step {trainer.state.step}"
                                 f", losses {trainer.scan_losses[-20:]}")
        if len(given) != 2 or not (
                np.array_equal(pool.images.cpu().numpy(),
                               np.concatenate([b[0] for b in given]))
                and np.array_equal(pool.labels.cpu().numpy(),
                                   np.concatenate([b[1] for b in given]))):
            raise AssertionError(f"train_scanned: the pool does not hold the "
                                 f"{len(given)} refresh batches")
        out["scanned"] = scan
        log(f"  train_scanned 20 steps (10 a dispatch, augmented, pool "
            f"refreshed from the feed after each dispatch; pool == the 2 "
            f"refresh batches): {scan['examples_per_sec']:.1f} examples/s, "
            f"duty_cycle {scan['duty_cycle']:.3f}, duty_cycle_lower "
            f"{scan['duty_cycle_lower']:.3f}, refresh feed "
            f"{trainer.feed_seconds:.3f} s, last loss {scan['loss']:.4f}")
        # 5. evaluate on one pass over the shards
        ev = trainer.evaluate(iter(feed(repeat=False, drop_remainder=False)))
        if ev["batches"] < 1 or not np.isfinite(ev["loss"]):
            raise AssertionError(f"evaluate: {ev}")
        out["evaluate"] = ev
        log(f"  evaluate: loss {ev['loss']:.4f}, accuracy "
            f"{ev['accuracy']:.4f}, mIoU {ev['miou']:.4f}, per-class IoU "
            + ", ".join("-" if v is None else f"{v:.3f}"
                        for v in ev["per_class_iou"]))
        # 6. checkpoint -> fresh trainer -> predict and serve
        ckpt = os.path.join(tmp, "ckpt", "model.pt")
        trainer.save_checkpoint(ckpt)
        restored = Trainer(cfg)
        restored.restore_checkpoint(ckpt)
        chips = next(iter(feed(seed=4)))[0][:8]
        want = trainer.predict(chips)
        if not np.array_equal(restored.predict(chips), want):
            raise AssertionError("restored predict differs from the "
                                 "trained trainer's")
        padded = np.zeros((bs,) + chips.shape[1:], chips.dtype)
        padded[:len(chips)] = chips
        batch_maps = restored.predict(padded)[:len(chips)]
        ps = PredictServer(restored, max_wait_ms=50.0)
        try:
            pend, _, _ = serve_requests(ps, chips)
        finally:
            ps.close()
        if any(p.error for p in pend) or not all(
                np.array_equal(p.result, w) for p, w in zip(pend,
                                                            batch_maps)):
            raise AssertionError("served class maps differ from the "
                                 "restored trainer's predict")
        log(f"  checkpoint (step {restored.state.step}) restored: predict on "
            f"8 chips == the trained trainer's bitwise; PredictServer "
            f"answers == restored predict")
        del restored, ps, trainer, pool
        torch.cuda.empty_cache()
        # 7. card against CPU, 3 fp32 steps on 2 images
        x, y = next(iter(feed(seed=5)))
        cmp = card_vs_cpu_steps(TrainConfig(**{**kw, "batch_size": 2,
                                               "precision": "fp32"}),
                                x[:2], y[:2])
        out["card_vs_cpu"] = cmp
        log(f"  card vs CPU, 3 fp32 steps on 2 images: loss relative "
            f"differences {', '.join(f'{v:.3g}' for v in cmp['loss_rel_diff'])}"
            f"; largest parameter difference {cmp['max_param_diff']:.3g}; "
            f"two card runs bitwise equal: {cmp['card_runs_bitwise_equal']}")
        # 8. step numbers at batch 32, bf16 and fp32
        out["steps"] = []
        for precision in ("bf16", "fp32"):
            t = Trainer(TrainConfig(**{**kw, "precision": precision}))
            xd, yd = t.place_batch(x, y)
            out["steps"].append(step_numbers(t, xd, yd, smi))
            del t, xd, yd
            torch.cuda.empty_cache()
        log(f"  feed: {out['feed_records_per_s']:.1f} records/s "
            f"(tifarr, {cfg.image_size} px, parse and batch; {smi})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def write_catalog(root, x0, y0, span, nx, ny):
    """A LocalCatalog root written with LocalCatalog.create + add_scene:
    10 dated Sentinel-2 L1C scenes of 13 uint16 bands (DNs 1-4095, nodata
    0 in blotches) over the nx x ny tiles of ``span`` metres whose corner
    is (x0, y0), zone 43: one at 10 m over the whole block (a file of
    >= 32 MiB, read windowed), two in zone 42 at 20 m over the whole block
    (warped across zones) and seven at 10 m over 4 x 2-tile quarters, all
    smaller than 32 MiB (decoded whole into the scene LRU)."""
    from dl_image_segmentation_tpu_torch.catalog import LocalCatalog
    from dl_image_segmentation_tpu_torch.catalog.base import (
        reproject_bounds)
    cat = LocalCatalog.create(root)
    rng = np.random.RandomState(17)
    margin = 200.0
    block = (x0 - margin, y0 - margin, x0 + nx * span + margin,
             y0 + ny * span + margin)
    scenes = [("s2-big", 43, 10.0, block)]
    scenes += [(f"s2-z42-{k}", 42, 20.0, block) for k in "ab"]
    for k, (i, j) in enumerate([(0, 0), (4, 0), (0, 2), (4, 2), (2, 0),
                                (2, 2), (2, 1)]):
        scenes.append((f"s2-q{k}", 43, 10.0, (
            x0 + i * span - margin, y0 + j * span - margin,
            x0 + (i + 4) * span + margin, y0 + (j + 2) * span + margin)))
    for k, (sid, zone, res, bounds) in enumerate(scenes):
        bx0, by0, bx1, by1 = reproject_bounds(bounds, 43, zone, margin=res)
        w = int(np.ceil((bx1 - bx0) / res))
        h = int(np.ceil((by1 - by0) / res))
        arr = rng.randint(1, 4096, (h, w, len(S2_BANDS))).astype(np.uint16)
        blot = np.kron(rng.rand(h // 32 + 1, w // 32 + 1) < 0.1,
                       np.ones((32, 32), bool))[:h, :w]
        arr[blot] = 0
        gt = (np.floor(bx0) + 0.5, res, 0.0, np.ceil(by1) - 0.25, 0.0, -res)
        cat.add_scene("sentinel-2:L1C", S2_BANDS, sid,
                      dt.date(2020, 6, 1) + dt.timedelta(days=12 * k), arr,
                      gt, 32600 + zone, cloud_fraction=0.01 * k, nodata=0,
                      save_index=False)
    cat._save_index()
    sizes = {sid: os.path.getsize(os.path.join(root, "scenes", f"{sid}.tif"))
             for sid, _, _, _ in scenes}
    big = [sid for sid, n in sizes.items() if n >= 32 << 20]
    if big != ["s2-big"]:
        raise AssertionError(f"scene files of >= 32 MiB: {big} ({sizes})")
    return sizes


def cli_run(argv, secs, name):
    """One in-process call of the port's CLI; its exit code must be 0."""
    from dl_image_segmentation_tpu_torch import cli
    t0 = time.perf_counter()
    rc = cli.main(argv)
    secs[name] = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{name}: exit code {rc}")
    log(f"  {name}: {secs[name]:.3f} s")


def serve_round_trip(ckpt, chip, secs):
    """``serve`` in a subprocess on port 0: one /healthz and one /predict
    of ``chip`` (a .npy body), then SIGINT; returns the served class
    map."""
    import io
    import queue
    import signal
    import threading
    import urllib.request
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dl_image_segmentation_tpu_torch.cli", "serve",
         "--checkpoint", ckpt, "--classes", "10", "--port", "0", "--scale",
         "none"], cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, text=True)
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                     daemon=True).start()
    try:
        line = lines.get(timeout=300)
        m = re.search(r"(http://\S+)", line)
        if not m:
            raise AssertionError(f"serve printed {line!r}")
        base = m.group(1)
        secs["serve start"] = time.perf_counter() - t0
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        if not health["ok"]:
            raise AssertionError(f"/healthz: {health}")
        buf = io.BytesIO()
        np.save(buf, chip)
        req = urllib.request.Request(base + "/predict", data=buf.getvalue(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            served = np.load(io.BytesIO(r.read()))
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=60)
            raise
    if rc != 0:
        raise AssertionError(f"serve exited {rc} after SIGINT")
    secs["serve"] = time.perf_counter() - t0
    log(f"  serve: {secs['serve']:.3f} s (up in {secs['serve start']:.3f} s;"
        f" /healthz {health})")
    return served


def cli_phase(smi):
    """Phase 7: chip creation from a LocalCatalog root and the verify
    sequence, through the port's CLI in-process (``cli.main``)."""
    import glob
    import torch
    import dl_image_segmentation_tpu_torch.catalog as catalog_pkg
    from dl_image_segmentation_tpu_torch import kernels
    from dl_image_segmentation_tpu_torch.geo import Tile
    from dl_image_segmentation_tpu_torch.raster import read_geotiff
    from dl_image_segmentation_tpu_torch.train import TrainConfig, Trainer

    log(f"phase 7: LocalCatalog + CLI on the card ({smi})")
    out = {"seconds": {}, "exports": []}
    secs = out["seconds"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        labels = write_labels(os.path.join(tmp, "labels.geojson"), 43, 10.0,
                              8, 4, 1024, seed=11)
        x0, y0, _, _ = Tile(256, 2, 10.0, 43, -10, 1400).bounds_unpadded
        root = os.path.join(tmp, "catalog")
        t0 = time.perf_counter()
        sizes = write_catalog(root, x0, y0, 2560.0, 8, 4)
        secs["write catalog"] = time.perf_counter() - t0
        log(f"  LocalCatalog root: 10 scenes in {secs['write catalog']:.3f} "
            f"s; file sizes (MiB) "
            + ", ".join(f"{k} {v / 2**20:.1f}" for k, v in sizes.items()))
        base = ["create-chips", "--labels", labels, "--attribute", "cls",
                "--product", "sentinel-2:L1C", "--bands", " ".join(S2_BANDS),
                "--tile-size", "260", "--pad", "2", "--resolution", "10.0",
                "--tag", "smoke", "--loc", "aoi", "--year", "2020",
                "--ref-date", "2020-11-01", "--catalog", root,
                "--workers", "8"]
        made = []
        original = catalog_pkg.LocalCatalog

        class Recording(original):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made.append(self)

        launches = {c.name: 0 for c in kernels.COUNTERS}
        trees = {}
        for device, batch in (("cuda", 16), ("cuda", 0), ("cpu", 16),
                              ("cpu", 0)):
            dest = os.path.join(tmp, f"s2-{device}-{batch}")
            argv = base + ["--out", dest, "--max-cloud-fraction", "0",
                           "--batch-tiles", str(batch), "--device", device]
            name = f"create-chips {device} --batch-tiles {batch}"
            catalog_pkg.LocalCatalog = Recording
            try:
                if device == "cuda":
                    torch.cuda.synchronize()
                    for c in kernels.COUNTERS:
                        c.reset()
                cli_run(argv, secs, name)
                if device == "cuda":
                    torch.cuda.synchronize()
                    for c in kernels.COUNTERS:
                        launches[c.name] += c.count
            finally:
                catalog_pkg.LocalCatalog = original
            cat = made[-1]
            if not (cat._readers and cat._cache):
                raise AssertionError(f"{name}: windowed reads "
                                     f"{sorted(cat._readers)}, whole-decoded "
                                     f"scenes {sorted(cat._cache)}")
            if not any("z42" in k for k in cat._cache):
                raise AssertionError(f"{name}: no zone-42 scene was loaded")
            folder, = glob.glob(os.path.join(dest, "*"))
            trees[(device, batch)] = read_tree(folder)
            run = {"device": device, "batch_tiles": batch, "tiles": 32,
                   "seconds": secs[name], "tiles_per_s": 32 / secs[name],
                   "windowed": sorted(cat._readers),
                   "whole_decoded": len(cat._cache)}
            out["exports"].append(run)
            log(f"    {run['tiles_per_s']:.3f} tiles/s on "
                f"{smi if device == 'cuda' else 'the host CPU'}; windowed "
                f"{run['windowed']}, {run['whole_decoded']} scenes decoded "
                "whole (zone 42 among them)")
        for batch in (16, 0):
            ref, got = trees[("cpu", batch)], trees[("cuda", batch)]
            if len(ref) != 64 or got != ref:
                bad = [k for k in ref if got.get(k) != ref[k]][:3]
                raise AssertionError(f"LocalCatalog export batch_tiles="
                                     f"{batch}: {len(ref)} files; card's "
                                     f"bytes differ from the CPU's {bad}")
        for name in ("masked_median", "burn_dense", "burn_binned"):
            if launches[name] == 0:
                raise AssertionError(f"{name}: not launched by the "
                                     "LocalCatalog export")
        out["launches"] = launches
        log(f"  LocalCatalog export: card == CPU bytes per tile and batched "
            f"(64 GeoTIFFs each); launches on the card {launches}")

        # the verify sequence: a nearest-date RGB mosaic of 256 px chips
        # from the same root, shards, inspect, train, eval, stitch,
        # predict, serve
        rgb = os.path.join(tmp, "rgb")
        argv = base + ["--out", rgb, "--bands", "red green blue",
                       "--tile-size", "256", "--pad", "0"]
        cli_run(argv, secs, "create-chips rgb")
        folder, = glob.glob(os.path.join(rgb, "*"))
        shards = os.path.join(tmp, "shards")
        cli_run(["to-tfrecords", "--name", "smoke", "--directory", folder,
                 "--out", shards, "--shards", "4", "--workers", "4",
                 "--engine", "mp", "--store-as-array"], secs, "to-tfrecords")
        pattern = os.path.join(shards, "smoke-*")
        cli_run(["inspect", "--records", pattern, "--verify-crc",
                 "--class-stats"], secs, "inspect")
        ckdir = os.path.join(tmp, "managed")
        mlog = os.path.join(tmp, "metrics.jsonl")
        cli_run(["train", "--records", pattern, "--mode", "tifarr",
                 "--classes", "10", "--steps", "20", "--log-every", "1",
                 "--save-every", "10", "--checkpoint", ckdir,
                 "--metrics-log", mlog], secs, "train")
        losses = [json.loads(ln)["loss"] for ln in open(mlog)]
        if len(losses) != 20 or not np.mean(losses[-5:]) < losses[0]:
            raise AssertionError(f"train: losses {losses}")
        out["losses"] = losses
        ckpt = os.path.join(ckdir, "20.pt")
        if sorted(os.listdir(ckdir)) != ["10.pt", "20.pt"]:
            raise AssertionError(f"managed checkpoints {os.listdir(ckdir)}")
        cli_run(["train", "--records", pattern, "--mode", "tifarr",
                 "--classes", "10", "--steps", "20", "--scan-steps", "10",
                 "--pool-size", "32", "--checkpoint",
                 os.path.join(tmp, "scanned.pt")], secs, "train --scan-steps")
        cli_run(["eval", "--records", pattern, "--checkpoint", ckpt,
                 "--classes", "10", "--json"], secs, "eval")
        mosaic = os.path.join(tmp, "mosaic.tif")
        cli_run(["stitch", "--chips", os.path.join(folder, "images"),
                 "--out", mosaic], secs, "stitch")
        pred = os.path.join(tmp, "pred.tif")
        cli_run(["predict", "--geotiff", mosaic, "--checkpoint", ckpt,
                 "--classes", "10", "--scale", "none", "--out", pred], secs,
                "predict --geotiff")
        g, m = read_geotiff(pred), read_geotiff(mosaic)
        if g.array.shape[:2] != m.array.shape[:2] \
                or g.info.geotransform != m.info.geotransform:
            raise AssertionError(f"predict --geotiff: {g.array.shape} vs "
                                 f"{m.array.shape}")
        chip = read_geotiff(sorted(glob.glob(os.path.join(
            folder, "images", "*.tif")))[0]).array.astype(np.float32)
        served = serve_round_trip(ckpt, chip, secs)
        t = Trainer(TrainConfig(num_classes=10, batch_size=8))
        t.restore_checkpoint(ckpt)
        if not np.array_equal(served, t.predict(chip[None])[0]):
            raise AssertionError("served class map differs from predict's")
        del t
        torch.cuda.empty_cache()
        log(f"  loss {losses[0]:.4f} -> {np.mean(losses[-5:]):.4f} (mean of "
            f"the last 5 of 20); served /predict == predict; {smi}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from dl_image_segmentation_tpu_torch import kernels

    t_start = time.perf_counter()
    card = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"phase 1: device {card}, count {count}, nvidia-smi: {smi}")
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    log("phase 2: build")
    for name, (secs, text) in kernels.build_all().items():
        n, spilled = spills(text)
        log(f"  {name}: built in {secs:.1f} s (wall clock, parallel builds); "
            f"{n} kernels, {len(spilled)} with spills or a stack frame")
        for line in text.splitlines():
            if "Used" in line or "spill" in line or "Compiling" in line:
                log("   ", line.strip())

    rows = kernel_phase()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        launches, runs = export_phase(tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    serving = serving_phase(smi)
    training = training_phase(smi)
    cli = cli_phase(smi)

    out = []
    for c in kernels.COUNTERS:
        cases = rows[c.name]
        main_case = cases[1] if c.name == "masked_median" else cases[0]
        out.append({
            "name": c.name, "route": "cuda", "source": c.source,
            "replaces": c.replaces, "launches": launches[c.name],
            "equal": all(r["equal"] for r in cases),
            "max_abs_err": max(r["max_abs_err"] for r in cases),
            "ms": main_case["ms"], "wrapper_ms": main_case["wrapper_ms"],
            "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case.get("library_ms"),
            "case": main_case["case"], "cases": cases})
    log(json.dumps({"serving": serving}))
    log(json.dumps({"training": training}))
    log(json.dumps({"cli": cli}))
    log(f"seconds {time.perf_counter() - t_start:.1f}; runs "
        f"{json.dumps(runs)}")
    log(f"{smi}")
    log(json.dumps({"kernels": out}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
