"""Vector -> raster label burning (ALL_TOUCHED semantics).

Counterpart of the JAX package's ops/rasterize.py, replacing
gdal.RasterizeLayer (dl_segmentation_utils/_descartes_img_chips.py:
682-685: ``ALL_TOUCHED=TRUE`` with per-feature ``ATTRIBUTE=`` values or
a constant burn of 1, over a background-prefilled uint8 canvas).

The burn is a dense per-pixel predicate:

* interior: even-odd parity of the crossings of every polygon edge with
  the horizontal ray through each pixel centre;
* ALL_TOUCHED boundary: a pixel is touched iff some edge segment meets
  its closed unit square (segment bbox overlaps the square AND the
  square straddles the segment's supporting line);
* last-writer-wins across features in emit order (the documented GDAL
  boundary-tie behaviour, reference :676-681), limited per feature to
  an optional row window.

Three implementations with identical output: the plain PyTorch version
(:func:`_rasterize_torch`, equal to the JAX package's
``_rasterize_jnp``), and two hand-written CUDA kernels (csrc/burn.cu):
a dense feature scan (:func:`burn_dense`, F <= 64) and a spatially
binned scan (:func:`burn_binned`) whose per-block feature lists are
built on the host (:func:`_bin_features`), as are each feature's bbox
and real-edge count (:func:`feature_bounds`), so that a wrapper launches
nothing on the card but its kernel. A wrapper given CPU tensors runs the
plain version.

Rounding: XLA:CPU contracts two expressions of the JAX predicate into
fused multiply-adds, ``xint = fma(q, x1 - x0, x0)`` and
``dist = |fma(nx, cx - x0, ny * (cy - y0))|``. They decide pixels on
polygon boundaries, so the kernels use FMA intrinsics there and the
plain version computes the same fused values exactly (:func:`_fma32`).

Edge layout: features are padded to a common edge count. Padding edges
are placed at _FAR (outside any raster) so they generate no crossings
and no touches.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import kernels
from ..device import resolve_device

_FAR = -1.0e9

# dense scan up to this many (padded) features, binned scan above: the
# dense kernel visits every feature in every block, the binned one only
# the features binned into the block
_BIN_THRESHOLD = 64

# (rows, cols) of the burn kernels' thread blocks; host binning uses the
# same shape so each block's list is exactly its own pixels' candidates
BURN_BLOCK = (8, 32)

# element budget of one (edges, rows, cols) chunk of the plain burn
_MASK_ELEMS = 1 << 21


# ---------------------------------------------------------------------------
# host-side preparation
# ---------------------------------------------------------------------------

def pack_features(
    features_px: Sequence[Tuple],
    max_edges: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack [(rings, value), ...] or [(rings, value, (row_lo, row_hi)),
    ...] (rings in PIXEL coordinates, (N,2) x=col, y=row, unclosed or
    closed) into dense arrays. The optional per-feature ROW WINDOW
    restricts the feature's burn to rows [row_lo, row_hi) -- used by
    the batched multi-tile compositor to keep each tile's features
    inside its own row band of a shared canvas.

    returns (edges[F, E, 4] f32, values[F] f32, windows[F, 2] f32)
    """
    feats = []
    for item in features_px:
        rings, value = item[0], item[1]
        win = item[2] if len(item) > 2 else (-1.0e9, 1.0e9)
        segs = []
        for ring in rings:
            r = np.asarray(ring, dtype=np.float32)
            if len(r) < 2:
                continue
            # EXACT closure test: with allclose, a nearly-closed dirty
            # ring at large pixel coords (rtol dominates) got no
            # closing segment, leaving a sub-pixel boundary gap that
            # flips even-odd parity for half a row. Appending a
            # zero-length closing segment to an already-closed ring is
            # harmless (no straddle, no new touch), so err that way.
            if not np.array_equal(r[0], r[-1]):
                r = np.concatenate([r, r[:1]], axis=0)
            a = r[:-1]
            b = r[1:]
            segs.append(np.concatenate([a, b], axis=1))  # (n,4) x0 y0 x1 y1
        if segs:
            feats.append((np.concatenate(segs, axis=0), float(value),
                          (float(win[0]), float(win[1]))))
    if not feats:
        return (np.full((1, 1, 4), _FAR, np.float32),
                np.zeros((1,), np.float32),
                np.array([[-1.0e9, 1.0e9]], np.float32))
    biggest = max(len(e) for e, _, _ in feats)
    if max_edges is not None and biggest > max_edges:
        # numpy slice clamping would silently drop edges, leaving the
        # polygon boundary open and inverting even-odd parity -- a
        # wrong mask with no diagnostic
        raise ValueError(
            f"feature has {biggest} edges, over max_edges={max_edges}")
    e_max = max_edges or biggest
    F = len(feats)
    if max_edges is None:
        # bucket BOTH padded axes to powers of two: every distinct
        # (F, E) pair is a fresh trace/compile of the jitted kernels,
        # and per-tile burns see different counts per tile. Padded
        # rows are _FAR sentinel edges with empty effect, so output is
        # identical; compile count becomes O(log^2) instead of O(tiles)
        e_max = 1 << max(0, e_max - 1).bit_length()
        F_pad = 1 << max(0, F - 1).bit_length()
    else:
        F_pad = F
    edges = np.full((F_pad, e_max, 4), _FAR, dtype=np.float32)
    values = np.zeros((F_pad,), dtype=np.float32)
    windows = np.zeros((F_pad, 2), dtype=np.float32)
    for i, (e, v, w) in enumerate(feats):
        edges[i, : len(e)] = e
        values[i] = v
        windows[i] = w
    return edges, values, windows


def _feature_bboxes(edges: np.ndarray):
    """Per-feature [minx, miny, maxx, maxy] over REAL edges only.
    Padding rows are _FAR sentinels (all four coords), so a plain min
    would stretch every bbox to -1e9 and defeat culling. A fully-padded
    feature gets an inverted (empty) bbox and is culled from every
    block."""
    real = edges[:, :, 0] != _FAR
    xs = np.stack([edges[:, :, 0], edges[:, :, 2]], axis=-1)
    ys = np.stack([edges[:, :, 1], edges[:, :, 3]], axis=-1)
    big = 2.0e9
    m = real[:, :, None]
    return (np.min(np.where(m, xs, big), axis=(1, 2)),
            np.min(np.where(m, ys, big), axis=(1, 2)),
            np.max(np.where(m, xs, -big), axis=(1, 2)),
            np.max(np.where(m, ys, -big), axis=(1, 2)))


def feature_bounds(edges: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(bbox (F, 4) float32 [minx, miny, maxx, maxy] over real edges,
    real edge count (F,) int32) of packed ``edges``, on the host: the
    per-feature inputs of the burn kernels besides edges, values and
    windows. Same values as :func:`_bboxes_nedges`."""
    bbox = np.stack(_feature_bboxes(edges), axis=-1).astype(np.float32)
    return bbox, (edges[:, :, 0] != _FAR).sum(axis=1).astype(np.int32)


def _bin_features(edges_np: np.ndarray, windows_np: np.ndarray,
                  height: int, width: int, bh: int, bw: int,
                  dilate: float = 1.0):
    """Host-side spatial binning: per-block feature lists (ascending
    emit order) from dilated bboxes intersected with row windows.
    Conservative (``dilate`` extra pixels each side; callers that will
    shift geometry after binning pass a wider margin) -- the kernel's
    predicates are exact, so over-inclusion only costs work. Returns
    (count (Gi, Gj) int32, table (Gi, Gj, S) int32) with S a power of
    two."""
    gi = -(-height // bh)
    gj = -(-width // bw)
    minx, miny, maxx, maxy = _feature_bboxes(edges_np)
    lists = [[[] for _ in range(gj)] for _ in range(gi)]
    F = len(edges_np)
    for f in range(F):
        if minx[f] > maxx[f]:
            continue  # fully-padded feature
        ylo = max(miny[f] - dilate, windows_np[f, 0] - 1.0)
        yhi = min(maxy[f] + dilate, windows_np[f, 1] + 1.0)
        if ylo > yhi:
            continue
        bi0 = max(0, int(ylo) // bh)
        bi1 = min(gi - 1, int(yhi) // bh)
        bj0 = max(0, int(max(minx[f] - dilate, 0.0)) // bw)
        bj1 = min(gj - 1, int(max(maxx[f] + dilate, 0.0)) // bw)
        if bi0 > bi1 or bj0 > bj1:
            continue
        for bi in range(bi0, bi1 + 1):
            for bj in range(bj0, bj1 + 1):
                lists[bi][bj].append(f)
    smax = max(1, max(len(c) for row in lists for c in row))
    S = 1 << max(0, smax - 1).bit_length()
    count = np.zeros((gi, gj), np.int32)
    table = np.zeros((gi, gj, S), np.int32)
    for bi in range(gi):
        for bj in range(gj):
            lst = lists[bi][bj]
            count[bi, bj] = len(lst)
            table[bi, bj, : len(lst)] = lst
    return count, table



# ---------------------------------------------------------------------------
# plain PyTorch burn
# ---------------------------------------------------------------------------

def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
           ) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add
    computes it (PyTorch has no elementwise FMA).

    The product of two float32 values is exact in float64, but the
    float64 sum is rounded, and rounding that again to float32 can
    differ from one rounding (double rounding). So the float64 sum is
    rounded to odd instead: TwoSum gives its exact error, and an inexact
    sum moves to the neighbour with an odd last bit. With 29 more bits
    than float32, the final rounding of a round-to-odd value is the
    correctly rounded result."""
    a, b, c = torch.broadcast_tensors(a, b, c)
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, math.inf, -math.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _bboxes_nedges(edges: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bbox (F, 4) float32 [minx, miny, maxx, maxy] over real edges,
    real edge count (F,) int32). Same values as :func:`_feature_bboxes`;
    real edges come first in every packed feature."""
    real = edges[:, :, 0] != _FAR
    m = real[:, :, None]
    xs = edges[:, :, 0::2]
    ys = edges[:, :, 1::2]
    big = 2.0e9
    bbox = torch.stack([
        torch.where(m, xs, big).amin(dim=(1, 2)),
        torch.where(m, ys, big).amin(dim=(1, 2)),
        torch.where(m, xs, -big).amax(dim=(1, 2)),
        torch.where(m, ys, -big).amax(dim=(1, 2))], dim=-1)
    return bbox.contiguous(), real.sum(dim=1).to(torch.int32)


def _feature_mask(e: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor,
                  all_touched: bool) -> torch.Tensor:
    """Burn mask of ONE feature's edges ``e`` (n, 4) over pixel centres
    cx (1, w) and cy (h, 1), with the edge axis chunked so that no
    (n, h, w) tensor is materialised whole."""
    h, w = cy.shape[0], cx.shape[1]
    parity = torch.zeros((h, w), dtype=torch.bool, device=e.device)
    touch = torch.zeros((h, w), dtype=torch.bool, device=e.device)
    cxe = cx[None]
    cye = cy[None]
    step = max(1, _MASK_ELEMS // (h * w))
    for k in range(0, e.shape[0], step):
        x0, y0, x1, y1 = (e[k:k + step, i][:, None, None] for i in range(4))
        straddle = (y0 > cye) != (y1 > cye)
        dy = y1 - y0
        q = (cye - y0) / torch.where(dy == 0, 1.0, dy)
        xint = _fma32(q, x1 - x0, x0)
        crossing = straddle & (cxe < xint)
        parity ^= (crossing.sum(dim=0) % 2).bool()
        if all_touched:
            box = ((cxe + 0.5 >= torch.minimum(x0, x1))
                   & (cxe - 0.5 <= torch.maximum(x0, x1))
                   & (cye + 0.5 >= torch.minimum(y0, y1))
                   & (cye - 0.5 <= torch.maximum(y0, y1)))
            nx = dy
            ny = x0 - x1
            dist = _fma32(nx, cxe - x0, ny * (cye - y0)).abs()
            reach = (nx.abs() + ny.abs()) * 0.5
            touch |= (box & (dist <= reach)).any(dim=0)
    return parity | touch if all_touched else parity


def _rasterize_torch(edges: torch.Tensor, values: torch.Tensor,
                     background: float, height: int, width: int,
                     all_touched: bool,
                     windows: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """The plain burn: float32 (height, width) canvas, equal to the JAX
    package's ``_rasterize_jnp``. Each feature is evaluated only on its
    bbox dilated past 0.5 px and clipped to its row window -- exact for
    the same reason as the kernels' cull: the touch test reaches 0.5 px
    beyond the edges' bbox, the interior lies inside it, and the row
    window bounds the burn."""
    dev = edges.device
    F = edges.shape[0]
    if windows is None:
        windows = torch.tensor([-1.0e9, 1.0e9], dtype=torch.float32,
                               device=dev).expand(F, 2)
    bbox, nedges = _bboxes_nedges(edges)
    canvas = torch.full((height, width), float(np.float32(background)),
                        dtype=torch.float32, device=dev)
    for f, ((minx, miny, maxx, maxy), (w0, w1), ne) in enumerate(zip(
            bbox.tolist(), windows.tolist(), nedges.tolist())):
        if ne == 0:
            continue
        r0 = max(0, math.floor(max(miny, w0)) - 2)
        r1 = min(height, math.ceil(min(maxy, w1)) + 2)
        c0 = max(0, math.floor(minx) - 2)
        c1 = min(width, math.ceil(maxx) + 2)
        if r0 >= r1 or c0 >= c1:
            continue
        cy = torch.arange(r0, r1, dtype=torch.float32, device=dev)[:, None]
        cx = torch.arange(c0, c1, dtype=torch.float32, device=dev)[None]
        cy = cy + 0.5
        cx = cx + 0.5
        mask = _feature_mask(edges[f, :ne], cx, cy, all_touched)
        mask = mask & (cy >= windows[f, 0]) & (cy < windows[f, 1])
        crop = canvas[r0:r1, c0:c1]
        canvas[r0:r1, c0:c1] = torch.where(mask, values[f], crop)
    return canvas


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

def _check_burn_inputs(name: str, edges, values, windows, bbox, nedges,
                       *tables) -> None:
    dev = edges.device
    if dev.type != "cuda" or any(t.device != dev for t in
                                 (values, windows, bbox, nedges, *tables)):
        raise ValueError(f"{name}: all inputs must be on one CUDA device")
    F = edges.shape[0]
    if (edges.dim() != 3 or edges.shape[2] != 4
            or tuple(values.shape) != (F,)
            or tuple(windows.shape) != (F, 2)
            or tuple(bbox.shape) != (F, 4)
            or tuple(nedges.shape) != (F,)):
        raise ValueError(f"{name}: edges (F, E, 4), values (F,), windows "
                         f"(F, 2), bbox (F, 4), nedges (F,); got "
                         f"{tuple(edges.shape)}, {tuple(values.shape)}, "
                         f"{tuple(windows.shape)}, {tuple(bbox.shape)}, "
                         f"{tuple(nedges.shape)}")
    if any(t.dtype != torch.float32 for t in (edges, values, windows, bbox)):
        raise TypeError(f"{name}: edges, values, windows and bbox must be "
                        "float32")
    if any(t.dtype != torch.int32 for t in (nedges, *tables)):
        raise TypeError(f"{name}: nedges, count and table must be int32")
    if not all(t.is_contiguous()
               for t in (edges, values, windows, bbox, nedges, *tables)):
        raise ValueError(f"{name}: inputs must be contiguous")
    if edges.data_ptr() % 16 or bbox.data_ptr() % 16 \
            or windows.data_ptr() % 8:
        raise ValueError(f"{name}: edges and bbox must be 16-byte aligned "
                         "and windows 8-byte aligned (read as float4 and "
                         "float2)")


def _launch_burn_dense(edges, values, windows, bbox, nedges, background,
                       all_touched, out) -> None:
    """Launch the dense kernel onto ``out`` (height, width) on the
    current stream; inputs as checked by :func:`_check_burn_inputs`.
    Counts nothing."""
    F, E, _ = edges.shape
    bh, bw = BURN_BLOCK
    rc = kernels.library("burn").burn_dense_launch(
        edges.data_ptr(), nedges.data_ptr(), values.data_ptr(),
        windows.data_ptr(), bbox.data_ptr(), F, E, out.shape[0],
        out.shape[1], float(background), int(bool(all_touched)), bh, bw,
        out.data_ptr(), kernels.stream_ptr(edges.device))
    kernels.check(rc, "burn_dense")


def _launch_burn_binned(edges, values, windows, bbox, nedges, count, table,
                        background, all_touched, out) -> None:
    """Launch the binned kernel onto ``out``, as
    :func:`_launch_burn_dense`."""
    F, E, _ = edges.shape
    bh, bw = BURN_BLOCK
    rc = kernels.library("burn").burn_binned_launch(
        edges.data_ptr(), nedges.data_ptr(), values.data_ptr(),
        windows.data_ptr(), bbox.data_ptr(), F, E, count.data_ptr(),
        table.data_ptr(), table.shape[2], out.shape[0], out.shape[1],
        float(background), int(bool(all_touched)), bh, bw, out.data_ptr(),
        kernels.stream_ptr(edges.device))
    kernels.check(rc, "burn_binned")


def burn_dense(edges: torch.Tensor, values: torch.Tensor,
               windows: torch.Tensor, bbox: torch.Tensor,
               nedges: torch.Tensor, background: float, height: int,
               width: int, all_touched: bool = True) -> torch.Tensor:
    """Dense burn through the CUDA kernel for CUDA inputs (every block
    scans all F features); the plain version for CPU inputs. ``bbox``
    and ``nedges`` must be :func:`feature_bounds` of ``edges``, made on
    the host, so that the kernel is the only work launched on the card:
    the kernel trusts them to cull (it reads at most E edges a feature,
    whatever ``nedges`` says). Returns the float32 (height, width)
    canvas."""
    if edges.device.type == "cpu":
        return _rasterize_torch(edges, values, background, height, width,
                                all_touched, windows)
    _check_burn_inputs("burn_dense", edges, values, windows, bbox, nedges)
    out = torch.empty((height, width), dtype=torch.float32,
                      device=edges.device)
    _launch_burn_dense(edges, values, windows, bbox, nedges, background,
                       all_touched, out)
    kernels.BURN_DENSE.add()
    return out


def burn_binned(edges: torch.Tensor, values: torch.Tensor,
                windows: torch.Tensor, bbox: torch.Tensor,
                nedges: torch.Tensor, count: torch.Tensor,
                table: torch.Tensor, background: float, height: int,
                width: int, all_touched: bool = True) -> torch.Tensor:
    """Binned burn through the CUDA kernel for CUDA inputs: block (i, j)
    of BURN_BLOCK scans only ``table[i, j, :count[i, j]]``, the
    ascending feature list from :func:`_bin_features`; ``bbox`` and
    ``nedges`` as for :func:`burn_dense`. The plain version for CPU
    inputs (binning is conservative and the predicate exact, so the
    lists change no pixel). Returns the float32 (height, width)
    canvas."""
    if edges.device.type == "cpu":
        return _rasterize_torch(edges, values, background, height, width,
                                all_touched, windows)
    _check_burn_inputs("burn_binned", edges, values, windows, bbox, nedges,
                       count, table)
    bh, bw = BURN_BLOCK
    grid = (-(-height // bh), -(-width // bw))
    if tuple(count.shape) != grid or tuple(table.shape[:2]) != grid \
            or table.dim() != 3:
        raise ValueError(f"burn_binned: count {tuple(count.shape)} and "
                         f"table {tuple(table.shape)} must cover the "
                         f"{grid} blocks of {BURN_BLOCK}")
    out = torch.empty((height, width), dtype=torch.float32,
                      device=edges.device)
    _launch_burn_binned(edges, values, windows, bbox, nedges, count, table,
                        background, all_touched, out)
    kernels.BURN_BINNED.add()
    return out


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def rasterize(
    features_px: Sequence[Tuple[Sequence[np.ndarray], float]],
    shape: Tuple[int, int],
    background: float = 255,
    all_touched: bool = True,
    dtype=np.uint8,
    device=None,
) -> np.ndarray:
    """Burn polygon features onto a raster, on ``device`` (None -> CUDA).

    features_px: [(rings, value), ...] or [(rings, value, (row_lo,
    row_hi)), ...] in pixel coordinates (x=col, y=row, origin at the
    top-left corner of pixel (0,0)); later features overwrite earlier
    ones where they overlap (GDAL emit-order semantics). The optional
    per-feature row window restricts the burn to rows [row_lo, row_hi)
    (used by the batched multi-tile compositor). Returns an (H, W) numpy
    array of ``dtype``.
    """
    dev = resolve_device(device)
    height, width = shape
    edges_np, values_np, windows_np = pack_features(features_px)
    inputs = [edges_np, values_np, windows_np, *feature_bounds(edges_np)]
    if len(edges_np) > _BIN_THRESHOLD:
        inputs += _bin_features(edges_np, windows_np, int(height),
                                int(width), *BURN_BLOCK)
        burn = burn_binned
    else:
        burn = burn_dense
    out = burn(*(torch.from_numpy(x).to(dev) for x in inputs), background,
               height, width, all_touched)
    return out.cpu().numpy().astype(dtype)
