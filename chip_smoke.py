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
   just after: every kernel must have been launched there.

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
    log(f"seconds {time.perf_counter() - t_start:.1f}; runs "
        f"{json.dumps(runs)}")
    log(f"{smi}")
    log(json.dumps({"kernels": out}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
