"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Skipped where there is no CUDA device; run them on the GPU with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import importlib

import numpy as np
import pytest
import torch

from dl_image_segmentation_tpu_torch import kernels
from dl_image_segmentation_tpu_torch.ops import compositing as oc

rz = importlib.import_module("dl_image_segmentation_tpu_torch.ops.rasterize")

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


# scene counts on both sides of every network width the kernel compiles
# (exact 1..16 for uint16, then 20, 24, 32, 40, 48, 64, 80, 96, 128;
# 4, 8, 16, 32, 64, 128 for float32)
_U16_SCENES = list(range(1, 18)) + [19, 20, 21, 23, 24, 25, 31, 32, 33, 39,
                                    40, 41, 47, 48, 49, 63, 64, 65, 79, 80,
                                    81, 95, 96, 97, 100, 127, 128]
_F32_SCENES = [1, 3, 4, 5, 8, 9, 16, 17, 32, 33, 64, 65, 100, 128]


# (H, W): 17 x 19 pixels (323, not a multiple of 16: the direct kernel,
# and an odd element count, so no thread's vector is whole at the end)
# and 16 x 20 (320: the staged kernel, with a partial last tile at B = 13)
_SHAPES = [(17, 19), (16, 20)]


def _median_inputs(S, B, dtype, hw=(17, 19)):
    """(S, H, W, B) stack and (S, H, W) validity; pixel (0, 0) has no valid
    scene and pixels (0, 1) and (1, 1) every scene. uint16 samples run to
    65535 (a fifth of them, and all of pixel (0, 1)); float32 samples are
    signed, with infinities and NaN in valid samples (all of pixel
    (1, 1))."""
    rng = np.random.RandomState(S * 100 + B)
    shape = (S, *hw, B)
    if dtype == np.uint16:
        stack = rng.randint(0, 65536, size=shape).astype(np.uint16)
        stack[rng.rand(*shape) < 0.2] = 65535
        stack[:, 0, 1] = 65535
    else:
        stack = (rng.randn(*shape) * 1000).astype(np.float32)
        u = rng.rand(*shape)
        stack[u < 0.05] = np.nan
        stack[(u > 0.05) & (u < 0.07)] = np.inf
        stack[(u > 0.07) & (u < 0.09)] = -np.inf
        stack[:, 1, 1] = np.nan
    valid = rng.rand(S, *hw) > 0.4
    valid[:, 0, 0] = False
    valid[:, 0, 1] = True
    valid[:, 1, 1] = True
    return torch.from_numpy(stack), torch.from_numpy(valid)


def _assert_median_equal(got, ref):
    """Bitwise, but NaN equal to NaN whatever its payload."""
    torch.testing.assert_close(got[0].cpu(), ref[0], rtol=0, atol=0,
                               equal_nan=True)
    assert torch.equal(got[1].cpu(), ref[1])


@pytest.mark.parametrize("hw", _SHAPES)
@pytest.mark.parametrize("B", [1, 13])
@pytest.mark.parametrize("S", _U16_SCENES)
def test_masked_median_kernel_equals_plain(S, B, hw):
    _need_card()
    stack, valid = _median_inputs(S, B, np.uint16, hw)
    before = kernels.MASKED_MEDIAN.count
    got = oc.masked_median_kernel(stack.cuda(), valid.cuda())
    ref = oc.masked_median(stack, valid)
    assert kernels.MASKED_MEDIAN.count == before + 1
    assert torch.equal(got[0].cpu(), ref[0])
    assert torch.equal(got[1].cpu(), ref[1])
    assert (ref[0][0, 1] == 65535).all()
    with pytest.raises(ValueError):
        oc.masked_median_kernel(stack.cuda()[:, :, :, 0], valid.cuda())


@pytest.mark.parametrize("hw", _SHAPES)
@pytest.mark.parametrize("S", _F32_SCENES)
def test_masked_median_kernel_float32_nan_equals_plain(S, hw):
    _need_card()
    stack, valid = _median_inputs(S, 13, np.float32, hw)
    got = oc.masked_median_kernel(stack.cuda(), valid.cuda())
    ref = oc.masked_median(stack, valid)
    _assert_median_equal(got, ref)
    assert ref[0][1, 1].isnan().all()


@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
def test_masked_median_bare_launch_and_unaligned_stack(dtype):
    """The launch helper alone writes the wrapper's outputs and counts
    one launch (the staged kernel); a stack that starts off its vector
    alignment takes the direct kernel's element loads and gives the same
    result."""
    _need_card()
    stack, valid = _median_inputs(10, 13, dtype, (16, 20))
    ref = oc.masked_median(stack, valid)
    x, v = stack.cuda(), valid.cuda()
    med = torch.full(ref[0].shape, 7.0, device="cuda")
    any_valid = torch.ones(ref[1].shape, dtype=torch.bool, device="cuda")
    before = kernels.MASKED_MEDIAN.count
    oc._launch_masked_median(x, v, med, any_valid)
    torch.cuda.synchronize()
    assert kernels.MASKED_MEDIAN.count == before + 1
    _assert_median_equal((med, any_valid), ref)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")
    shifted = flat[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    _assert_median_equal(oc.masked_median_kernel(shifted, v), ref)


@pytest.mark.parametrize("n,all_touched", [(30, True), (30, False),
                                           (90, True)])
def test_burn_kernels_equal_plain(n, all_touched):
    _need_card()
    rng = np.random.RandomState(n)
    feats = []
    for v in range(1, n + 1):
        c = rng.rand(2) * 60 + 10
        k = rng.randint(3, 40)
        ang = np.sort(rng.rand(k) * 2 * np.pi)
        rad = (rng.rand(k) * 0.5 + 0.5) * (rng.rand() * 12 + 1)
        feats.append(([np.stack([c[0] + rad * np.cos(ang),
                                 c[1] + rad * np.sin(ang)], 1)], v,
                       (float(v % 7), 70.0)))
    e, v, w = rz.pack_features(feats)
    ref = rz._rasterize_torch(*(torch.from_numpy(x) for x in (e, v)), 255.0,
                              80, 90, all_touched, torch.from_numpy(w))
    dense, binned = _both_kernels(e, v, w, 80, 90, all_touched)
    assert torch.equal(dense.cpu(), ref) and torch.equal(binned.cpu(), ref)


def _both_kernels(e, v, w, H, W, all_touched, extra_edges=0):
    """Both burn kernels through their wrappers on the packed features,
    with ``extra_edges`` added to every real-edge count; each launch
    counter must move by one."""
    bbox, nedges = rz.feature_bounds(e)
    ins = [torch.from_numpy(x).cuda()
           for x in (e, v, w, bbox, nedges + np.int32(extra_edges))]
    tables = [torch.from_numpy(x).cuda()
              for x in rz._bin_features(e, w, H, W, *rz.BURN_BLOCK)]
    before = kernels.BURN_DENSE.count, kernels.BURN_BINNED.count
    dense = rz.burn_dense(*ins, 255.0, H, W, all_touched)
    binned = rz.burn_binned(*ins, *tables, 255.0, H, W, all_touched)
    torch.cuda.synchronize()
    assert (kernels.BURN_DENSE.count, kernels.BURN_BINNED.count) == (
        before[0] + 1, before[1] + 1)
    return dense, binned


def _stars(rng, F, E, xlo, xhi, ylo, yhi, rmin, rmax):
    """F star polygons of E vertices (pixel coordinates)."""
    theta = np.linspace(0, 2 * np.pi, E, endpoint=False)
    cx, cy = rng.uniform(xlo, xhi, F), rng.uniform(ylo, yhi, F)
    rad = rng.uniform(rmin, rmax, (F, 1)) * (1 + 0.3 * rng.rand(F, E))
    px = cx[:, None] + rad * np.cos(theta)[None]
    py = cy[:, None] + rad * np.sin(theta)[None]
    return [([np.stack([px[f], py[f]], 1)], float(rng.randint(1, 255)))
            for f in range(F)]


def _path_case(name):
    """(features, (H, W)) at the main path's shapes: one 260 px tile
    (48 features, dense), the 16-tile batched canvas (640 features, row
    windows, binned), and the tile with adversarial geometry added."""
    rng = np.random.RandomState(5)
    if name == "batched 4160x260":
        feats = []
        for k in range(16):
            for rings, v in _stars(rng, 40, 256, 10, 250, -20, 280, 4, 26):
                feats.append(([r + [0.0, k * 260.0] for r in rings], v,
                              (k * 260.0, (k + 1) * 260.0)))
        return feats, (4160, 260)
    feats = _stars(rng, 48, 256, 10, 250, 10, 250, 4, 26)
    for f, (rings, v) in enumerate(feats):
        feats[f] = ([rings[0][::max(1, 256 // rng.randint(3, 257))]], v)
    if name == "adversarial":
        # 300 edges: the staging loop runs twice; a feature over every
        # block; a 1-row window; vertices on pixel centres and corners
        feats[3] = _stars(rng, 1, 300, 120, 140, 120, 140, 20, 40)[0]
        feats[7] = _stars(rng, 1, 200, 128, 132, 128, 132, 150, 170)[0]
        sq = np.array([[20.5, 30.5], [90.0, 30.5], [90.0, 75.0],
                       [20.5, 75.0]])
        feats[11] = ([sq], 9.0, (40.0, 41.0))
        feats[12] = ([sq + [100.0, 60.0]], 10.0)
    return feats, (260, 260)


@pytest.mark.parametrize("all_touched", [True, False])
@pytest.mark.parametrize("name", ["tile 260x260", "batched 4160x260",
                                  "adversarial"])
def test_burn_kernels_equal_plain_at_path_shapes(name, all_touched):
    _need_card()
    feats, (H, W) = _path_case(name)
    e, v, w = rz.pack_features(feats)
    assert (len(e) > rz._BIN_THRESHOLD) == (name == "batched 4160x260")
    assert name != "adversarial" or e.shape[1] == 512
    ref = rz._rasterize_torch(*(torch.from_numpy(x).cuda() for x in (e, v)),
                              255.0, H, W, all_touched,
                              torch.from_numpy(w).cuda())
    dense, binned = _both_kernels(e, v, w, H, W, all_touched)
    assert torch.equal(dense, ref) and torch.equal(binned, ref)
    assert len(torch.unique(ref)) > 10


def test_burn_kernels_read_at_most_E_edges():
    """Edge counts above E are read as E: the kernels then walk only the
    feature's own padding (no crossings, no touches), never the next
    feature's edges or past the last one."""
    _need_card()
    feats, (H, W) = _path_case("tile 260x260")
    e, v, w = rz.pack_features(feats)
    ref = rz._rasterize_torch(*(torch.from_numpy(x).cuda() for x in (e, v)),
                              255.0, H, W, True, torch.from_numpy(w).cuda())
    dense, binned = _both_kernels(e, v, w, H, W, True,
                                  extra_edges=3 * e.shape[1])
    assert torch.equal(dense, ref) and torch.equal(binned, ref)
