"""The PyTorch port's device ops against the JAX package, on the CPU.

Same numpy inputs, made from a seed, go through the JAX function and
the port's counterpart with ``device="cpu"``, where every kernel wrapper
runs its plain PyTorch version. Tolerance is bitwise throughout: the
median and the mosaic are exact selections, and the burn predicate
rounds exactly as XLA:CPU does (two fused multiply-adds)."""

import importlib
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_image_segmentation_tpu.ops import compositing as jc
from dl_image_segmentation_tpu.ops.rasterize import (
    _bin_features as j_bin_features, _feature_bboxes as j_feature_bboxes,
    _rasterize_jnp,
    pack_features as j_pack_features, rasterize as j_rasterize)
from dl_image_segmentation_tpu_torch import kernels
from dl_image_segmentation_tpu_torch.ops import compositing as tc

# one intra-op thread: the test workers share the host's cores
torch.set_num_threads(1)

tr = importlib.import_module("dl_image_segmentation_tpu_torch.ops.rasterize")

N = 80  # canvas of the burn comparisons (one JAX compile per feature pad)


def _median_case(seed, S, H=5, W=6, B=3, dtype=np.uint16):
    rng = np.random.RandomState(seed)
    stack = (rng.rand(S, H, W, B) * 4000).astype(dtype)
    valid = rng.rand(S, H, W) > 0.35
    valid[:, 0, 0] = False  # an all-invalid pixel
    return stack, valid


def _jax_median(stack, valid):
    med, av = jc.masked_median(jnp.asarray(stack), jnp.asarray(valid))
    return np.asarray(med), np.asarray(av)


class TestMaskedMedian:
    @pytest.mark.parametrize("S", [1, 2, 7, 73])
    def test_equals_jax(self, S):
        stack, valid = _median_case(S, S)
        ref_med, ref_av = _jax_median(stack, valid)
        med, av = tc.masked_median_composite(stack, valid, device="cpu")
        np.testing.assert_array_equal(med.numpy(), ref_med)
        np.testing.assert_array_equal(av.numpy(), ref_av)
        assert not av[0, 0].any() and (med[0, 0] == 0).all()

    @pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.int16])
    def test_other_stack_dtypes_equal_jax(self, dtype):
        """Stacks the kernel does not read directly go through float32."""
        stack, valid = _median_case(5, 6, dtype=dtype)
        ref_med, ref_av = _jax_median(stack, valid)
        med, av = tc.masked_median_composite(stack, valid, device="cpu")
        assert med.dtype == torch.float32
        np.testing.assert_array_equal(med.numpy(), ref_med)
        np.testing.assert_array_equal(av.numpy(), ref_av)

    def test_equals_pallas_interpret(self):
        """One tiny call of the TPU kernel itself, in interpret mode."""
        stack, valid = _median_case(3, 5, H=8, W=8, B=2)
        med, av = jc.masked_median_pallas(jnp.asarray(stack.astype(
            np.float32)), jnp.asarray(valid), interpret=True)
        pmed, pav = tc.masked_median_kernel(torch.from_numpy(stack),
                                            torch.from_numpy(valid))
        np.testing.assert_array_equal(pmed.numpy(), np.asarray(med))
        np.testing.assert_array_equal(pav.numpy(), np.asarray(av))

    def test_chunked_rows_equal_one_chunk(self, monkeypatch):
        stack, valid = _median_case(4, 7, H=9)
        whole = tc.masked_median(torch.from_numpy(stack),
                                 torch.from_numpy(valid))
        monkeypatch.setattr(tc, "_CHUNK_ELEMS", 1)
        rows = tc.masked_median(torch.from_numpy(stack),
                                torch.from_numpy(valid))
        assert torch.equal(whole[0], rows[0])
        assert torch.equal(whole[1], rows[1])

    def test_cpu_wrapper_counts_no_launch(self):
        before = kernels.MASKED_MEDIAN.count
        stack, valid = _median_case(6, 3)
        tc.masked_median_kernel(torch.from_numpy(stack),
                                torch.from_numpy(valid))
        assert kernels.MASKED_MEDIAN.count == before

    def test_pad_stack_raises_never_truncates(self):
        stack, valid = _median_case(7, 3)
        s2, v2 = tc.pad_stack(stack, valid, 8)
        assert s2.shape[0] == 8 and not v2[3:].any()
        with pytest.raises(ValueError):
            tc.pad_stack(stack, valid, 2)


def _kernel_widths(launcher):
    """Network widths that csrc/masked_median.cu compiles for one dtype,
    read from its launcher (``launch_u16`` or ``launch_f32``)."""
    with open(os.path.join(os.path.dirname(tc.__file__), os.pardir, "csrc",
                           "masked_median.cu")) as f:
        src = f.read()
    body = src[src.index(f"cudaError_t {launcher}("):]
    body = body[:body.index("#undef MM_WIDTH")]
    return [int(n) for n in re.findall(r"MM_WIDTH\((\d+)\);", body)]


def _kernel_pairs_of_width(n):
    """The kernel's comparators for width n, in order: a copy of
    csrc/masked_median.cu:batcher_pairs."""
    pairs = []
    p = 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(min(k, n - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return pairs


def _kernel_median_u16(stack, valid):
    """masked_median.cu on a uint16 stack, in torch: the width the
    launcher picks for S, padded scenes and invalid samples at 0xFFFF,
    each element's validity read at its pixel e // B, the network as
    integer min/max, ranks selected among the first width / 2 + 1
    positions."""
    S, H, W, B = stack.shape
    N = next(w for w in _kernel_widths("launch_u16") if w >= S)
    n_elem = H * W * B
    pix = torch.arange(n_elem) // B
    flat_valid = torch.from_numpy(valid.reshape(S, H * W))
    x = torch.from_numpy(stack.reshape(S, n_elem).astype(np.int32))
    v, cnt = [], torch.zeros(n_elem, dtype=torch.int32)
    for s in range(N):
        if s < S:
            ok = flat_valid[s][pix]
            cnt += ok.int()
            v.append(torch.where(ok, x[s], 0xFFFF))
        else:
            v.append(torch.full((n_elem,), 0xFFFF, dtype=torch.int32))
    for a, b in _kernel_pairs_of_width(N):
        v[a], v[b] = torch.minimum(v[a], v[b]), torch.maximum(v[a], v[b])
    nz = cnt.clamp(min=1)
    lo = torch.zeros(n_elem, dtype=torch.int32)
    hi = torch.zeros(n_elem, dtype=torch.int32)
    for s in range(min(N // 2 + 1, N)):
        lo = torch.where((nz - 1) // 2 == s, v[s], lo)
        hi = torch.where(nz // 2 == s, v[s], hi)
    med = (lo.float() + hi.float()) * 0.5
    med = torch.where(cnt > 0, med, torch.zeros_like(med))
    return med.reshape(H, W, B), (cnt > 0).reshape(H, W, B)


def _f32_keys(x):
    """masked_median.cu's float32 keys (F32::key) as int32, in numpy."""
    u = x.view(np.uint32)
    nan = (u & 0x7FFFFFFF) > 0x7F800000
    flipped = u ^ ((u.view(np.int32) >> 31).view(np.uint32) >> 1)
    return np.where(nan, np.uint32(0x7FFFFFFF), flipped).view(np.int32)


class TestMedianNetwork:
    """csrc/masked_median.cu sorts with integer min/max over a Batcher
    network sized to S, with 0xFFFF for invalid uint16 samples. Its
    logic, written in torch, must equal the JAX package's median and the
    plain version bitwise: valid samples of 65535, pixels with every or
    no scene valid, one band and 13, element counts that are not a
    multiple of the vector width."""

    @pytest.mark.parametrize("S", [1, 2, 3, 9, 10, 16, 17, 33, 73, 128])
    def test_network_equals_jax_and_plain(self, S):
        N = next(w for w in _kernel_widths("launch_u16") if w >= S)
        pairs = _kernel_pairs_of_width(N)
        assert pairs == jc._batcher_pairs(N)
        # the network of the next power of two, pruned to the width
        p2 = 1 << max(0, N - 1).bit_length()
        assert pairs == [(a, b) for a, b in _kernel_pairs_of_width(p2)
                         if b < N]
        if S == 10:
            assert (N, len(pairs)) == (10, 32)
        if S == 73:
            assert (N, len(pairs)) == (80, 849)
        rng = np.random.RandomState(S)
        for B in (1, 13):
            H, W = 3, 5  # 15 and 195 elements: not multiples of 8
            stack = rng.randint(0, 65536, size=(S, H, W, B)).astype(np.uint16)
            stack[rng.rand(S, H, W, B) < 0.3] = 65535
            stack[:, 0, 1] = 65535
            valid = rng.rand(S, H, W) > 0.4
            valid[:, 0, 0] = False
            valid[:, 0, 1] = True
            med, av = _kernel_median_u16(stack, valid)
            assert (med[0, 1] == 65535).all() and not av[0, 0].any()
            ref_med, ref_av = _jax_median(stack, valid)
            np.testing.assert_array_equal(med.numpy(), ref_med)
            np.testing.assert_array_equal(av.numpy(), ref_av)
            plain = tc.masked_median(torch.from_numpy(stack),
                                     torch.from_numpy(valid))
            assert torch.equal(med, plain[0]) and torch.equal(av, plain[1])

    def test_float_keys_order_as_the_plain_sort(self):
        """float32 keys sort as torch.sort sorts (NaN of either sign
        last), and the invalid key is the key of 3.0e38."""
        rng = np.random.RandomState(0)
        x = np.concatenate([
            (rng.randn(300) * 10.0 ** rng.randint(-30, 30, 300)),
            [np.inf, -np.inf, 3.0e38, -3.0e38, 1e-45, -1e-45, 0.0]]
        ).astype(np.float32)
        x = np.concatenate([x, -np.abs(np.float32(np.nan)) * np.ones(3,
                            np.float32), np.full(3, np.nan, np.float32)])
        order = np.argsort(_f32_keys(x), kind="stable")
        ref = torch.sort(torch.from_numpy(x)).values.numpy()
        np.testing.assert_array_equal(x[order], ref)
        assert _f32_keys(np.array([3.0e38], np.float32))[0] == 0x7F61B1E6
        # the key is an involution outside NaN: keys map back to the floats
        k = _f32_keys(x[:-6]).view(np.uint32)
        back = k ^ ((k.view(np.int32) >> 31).view(np.uint32) >> 1)
        np.testing.assert_array_equal(back.view(np.float32), x[:-6])


class TestNearestMosaic:
    def test_random_equals_jax(self):
        rng = np.random.RandomState(3)
        S, H, W, B = 6, 8, 8, 2
        stack = (rng.rand(S, H, W, B) * 1000).astype(np.uint16)
        valid = rng.rand(S, H, W) > 0.4
        dist = np.array([5, 3, 0, 7, 3, 1], np.float32)
        ref = jc.nearest_valid_mosaic(jnp.asarray(stack),
                                      jnp.asarray(valid), jnp.asarray(dist))
        got = tc.nearest_valid_mosaic(stack, valid, dist, device="cpu")
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))

    def test_ties_break_to_later_scene(self):
        """The tie case of the JAX package's tests: equal distances pick
        the later scene at every magnitude, also when only scenes 0 and
        2 tie (torch.argmin must return the first minimal index)."""
        S, H, W, B = 3, 4, 4, 1
        stack = np.stack([np.full((H, W, B), v, np.float32)
                          for v in (1.0, 2.0, 3.0)])
        valid = np.ones((S, H, W), bool)
        for dist in (0.0, 3.0, 100.0, 365.0, 10000.0):
            d = np.full(S, dist, np.float32)
            got, _ = tc.nearest_valid_mosaic(stack, valid, d, device="cpu")
            ref, _ = jc.nearest_valid_mosaic(jnp.asarray(stack),
                                             jnp.asarray(valid),
                                             jnp.asarray(d))
            np.testing.assert_array_equal(got.numpy(), stack[-1])
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        valid[1] = False
        d = np.full(S, 200.0, np.float32)
        got, _ = tc.nearest_valid_mosaic(stack, valid, d, device="cpu")
        np.testing.assert_array_equal(got.numpy(), stack[2])

    def test_per_pixel_distances_equal_jax(self):
        rng = np.random.RandomState(4)
        S, H, W, B = 4, 6, 5, 3
        stack = (rng.rand(S, H, W, B) * 100).astype(np.float32)
        valid = rng.rand(S, H, W) > 0.3
        dist = rng.randint(0, 4, size=(S, H, W)).astype(np.float32)
        ref = jc.nearest_valid_mosaic(jnp.asarray(stack),
                                      jnp.asarray(valid), jnp.asarray(dist))
        got = tc.nearest_valid_mosaic(stack, valid, dist, device="cpu")
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))


def _random_features(seed, n, holes=True):
    """Star polygons (some with a hole) with overlapping extents."""
    rng = np.random.RandomState(seed)
    feats = []
    for v in range(1, n + 1):
        c = rng.rand(2) * (N - 20) + 10
        k = rng.randint(3, 24)
        ang = np.sort(rng.rand(k) * 2 * np.pi)
        rad = (rng.rand(k) * 0.5 + 0.5) * (rng.rand() * 12 + 2)
        ring = np.stack([c[0] + rad * np.cos(ang),
                         c[1] + rad * np.sin(ang)], axis=1)
        rings = [ring]
        if holes and v % 3 == 0:
            rings.append(c + (ring - c) * 0.3)
        feats.append((rings, (v % 250) + 1))
    # an overlapping pair: the later feature must win
    sq = np.array([[20, 20], [40, 20], [40, 40], [20, 40]], float)
    feats[n // 2] = ([sq], 77)
    feats[-1] = ([sq + 0.5], 99)
    return feats


def _jax_burn(feats, all_touched=True, backend="jnp"):
    return j_rasterize(feats, (N, N), 255, all_touched=all_touched,
                       backend=backend)


class TestRasterize:
    @pytest.mark.parametrize("n,all_touched", [
        (40, True), (40, False),     # dense kernel's path (F pad 64)
        (100, True), (100, False),   # binned kernel's path (F pad 128)
    ])
    def test_equals_jax(self, n, all_touched):
        feats = _random_features(n, n)
        ref = _jax_burn(feats, all_touched)
        got = tr.rasterize(feats, (N, N), 255, all_touched=all_touched,
                           device="cpu")
        np.testing.assert_array_equal(got, ref)
        assert 99 in got

    @pytest.mark.parametrize("n", [40, 100])
    def test_equals_pallas_interpret(self, n):
        """One tiny interpret-mode call of each TPU burn kernel (dense at
        F <= 64, binned above), on a smaller canvas."""
        feats = [(rings, v) for rings, v in _random_features(n + 1, n)]
        feats = [([r * 0.4 for r in rings], v) for rings, v in feats]
        ref = j_rasterize(feats, (32, 32), 255, backend="pallas")
        got = tr.rasterize(feats, (32, 32), 255, device="cpu")
        np.testing.assert_array_equal(got, ref)

    def test_row_windows_equal_jax(self):
        feats = _random_features(7, 30)
        wfeats = [(rings, v, (float(10 * (i % 5)), float(10 * (i % 5) + 37)))
                  for i, (rings, v) in enumerate(feats)]
        np.testing.assert_array_equal(
            tr.rasterize(wfeats, (N, N), 255, device="cpu"),
            _jax_burn(wfeats))

    def test_empty_and_degenerate(self):
        out = tr.rasterize([], (8, 8), background=255, device="cpu")
        assert out.shape == (8, 8) and (out == 255).all()
        line = ([np.array([[1.0, 1.0], [1.0, 1.0]])], 3)
        np.testing.assert_array_equal(
            tr.rasterize([line], (8, 8), 0, device="cpu"),
            j_rasterize([line], (8, 8), 0, backend="jnp"))

    def test_pack_and_bin_equal_jax(self):
        feats = _random_features(9, 70)
        wfeats = [(rings, v, (float(i % 7), float(i % 7 + 50)))
                  for i, (rings, v) in enumerate(feats)]
        got = tr.pack_features(wfeats)
        ref = j_pack_features(wfeats)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
        for bh, bw in (tr.BURN_BLOCK, (32, 256)):
            cg, tg = tr._bin_features(got[0], got[2], N, N, bh, bw)
            cj, tj = j_bin_features(ref[0], ref[2], N, N, bh, bw)
            np.testing.assert_array_equal(cg, cj)
            np.testing.assert_array_equal(tg, tj)

    def test_bboxes_equal_host_bboxes(self):
        """The plain burn's bbox and edge counts equal the host's, which
        the kernel wrappers take (feature_bounds), and the JAX package's;
        the 12 fully padded features get inverted bboxes and no edges."""
        edges, _, _ = tr.pack_features(_random_features(10, 20))
        bbox, nedges = tr._bboxes_nedges(torch.from_numpy(edges))
        np.testing.assert_array_equal(
            bbox.numpy(), np.stack(tr._feature_bboxes(edges), axis=-1))
        np.testing.assert_array_equal(
            nedges.numpy(), (edges[:, :, 0] != tr._FAR).sum(1))
        hbox, hn = tr.feature_bounds(edges)
        assert hbox.dtype == np.float32 and hn.dtype == np.int32
        np.testing.assert_array_equal(hbox, bbox.numpy())
        np.testing.assert_array_equal(hn, nedges.numpy())
        np.testing.assert_array_equal(
            hbox, np.stack(j_feature_bboxes(edges, np), axis=-1))
        assert len(edges) == 32 and (hn[20:] == 0).all()
        assert (hbox[20:, 0] > hbox[20:, 2]).all()

    def test_plain_burn_edge_chunks_and_wrappers(self, monkeypatch):
        """Chunking the edge axis changes nothing, and both wrappers run
        the plain version on CPU tensors without counting a launch."""
        feats = _random_features(11, 20)
        e, v, w = (torch.from_numpy(x) for x in tr.pack_features(feats))
        whole = tr._rasterize_torch(e, v, 255.0, N, N, True, w)
        monkeypatch.setattr(tr, "_MASK_ELEMS", 64)
        chunked = tr._rasterize_torch(e, v, 255.0, N, N, True, w)
        assert torch.equal(whole, chunked)
        before = [c.count for c in kernels.COUNTERS]
        b, ne = (torch.from_numpy(x) for x in tr.feature_bounds(e.numpy()))
        dense = tr.burn_dense(e, v, w, b, ne, 255.0, N, N, True)
        cnt, tab = tr._bin_features(e.numpy(), w.numpy(), N, N,
                                    *tr.BURN_BLOCK)
        binned = tr.burn_binned(e, v, w, b, ne, torch.from_numpy(cnt),
                                torch.from_numpy(tab), 255.0, N, N, True)
        assert torch.equal(dense, whole) and torch.equal(binned, whole)
        assert [c.count for c in kernels.COUNTERS] == before


def _f32(x):
    return np.float32(x)


def _fused(a, b, c):
    t = [torch.tensor([_f32(x)]) for x in (a, b, c)]
    return _f32(tr._fma32(*t).item())


def _parity_flip_edge():
    """First seeded edge through a pixel centre where fused and
    separately rounded ``cx < xint`` disagree."""
    rng = np.random.RandomState(1)
    for _ in range(5000):
        r, c = rng.randint(10, N - 10, size=2)
        cx, cy = _f32(c + 0.5), _f32(r + 0.5)
        ang = rng.uniform(0.2, np.pi - 0.2)
        l0, l1 = rng.uniform(3, 9, size=2)
        x0, y0 = _f32(cx - l0 * np.cos(ang)), _f32(cy - l0 * np.sin(ang))
        x1, y1 = _f32(cx + l1 * np.cos(ang)), _f32(cy + l1 * np.sin(ang))
        q = _f32(_f32(cy - y0) / _f32(y1 - y0))
        fused = cx < _fused(q, _f32(x1 - x0), x0)
        separate = cx < _f32(x0 + _f32(q * _f32(x1 - x0)))
        if fused != separate:
            return (r, c), (x0, y0, x1, y1)
    raise AssertionError("no flipping edge found")


def _touch_flip_edge():
    """First seeded edge through a pixel corner where fused and
    separately rounded ``dist <= reach`` disagree."""
    rng = np.random.RandomState(1)
    for _ in range(5000):
        r, c = rng.randint(10, N - 10, size=2)
        cx, cy = _f32(c + 0.5), _f32(r + 0.5)
        kx, ky = cx + 0.5, cy + 0.5
        ang = rng.uniform(0.2, np.pi / 2 - 0.2)
        l0, l1 = rng.uniform(3, 9, size=2)
        x0, y0 = _f32(kx - l0 * np.cos(ang)), _f32(ky + l0 * np.sin(ang))
        x1, y1 = _f32(kx + l1 * np.cos(ang)), _f32(ky - l1 * np.sin(ang))
        nx, ny = _f32(y1 - y0), _f32(x0 - x1)
        reach = _f32(_f32(abs(nx) + abs(ny)) * _f32(0.5))
        tail = _f32(ny * _f32(cy - y0))
        fused = abs(_fused(nx, _f32(cx - x0), tail)) <= reach
        separate = abs(_f32(_f32(nx * _f32(cx - x0)) + tail)) <= reach
        if fused != separate:
            return (r, c), (x0, y0, x1, y1)
    raise AssertionError("no flipping edge found")


class TestFusedRounding:
    """Pixels on a polygon boundary are decided by two expressions that
    XLA:CPU contracts into fused multiply-adds. A burn that rounds them
    separately flips these seeded pixels."""

    @pytest.mark.parametrize("case", ["parity", "touch"])
    def test_boundary_pixel_follows_jax(self, case, monkeypatch):
        if case == "parity":
            (r, c), (x0, y0, x1, y1) = _parity_flip_edge()
            apex = [max(x0, x1) + 20, (y0 + y1) / 2]
            all_touched = False
        else:
            (r, c), (x0, y0, x1, y1) = _touch_flip_edge()
            apex = [(x0 + x1) / 2 + 15, (y0 + y1) / 2 + 15]
            all_touched = True
        tri = [([np.array([[x0, y0], [x1, y1], apex], np.float64)], 7)]
        edges, values, windows = j_pack_features(tri)
        ref = np.asarray(_rasterize_jnp(
            jnp.asarray(edges), jnp.asarray(values), jnp.float32(0), N, N,
            all_touched, windows=jnp.asarray(windows))).astype(np.uint8)
        got = tr.rasterize(tri, (N, N), 0, all_touched=all_touched,
                           device="cpu")
        np.testing.assert_array_equal(got, ref)
        monkeypatch.setattr(tr, "_fma32", lambda a, b, c: a * b + c)
        separate = tr.rasterize(tri, (N, N), 0, all_touched=all_touched,
                                device="cpu")
        assert separate[r, c] != ref[r, c]

    def test_fma32_is_correctly_rounded(self):
        """Against exact rational arithmetic, on random float32 triples
        and on triples built to sit on float32 rounding midpoints."""
        from fractions import Fraction
        rng = np.random.RandomState(0)
        a = (rng.rand(400) * 200 - 100).astype(np.float32)
        b = (rng.rand(400) * 200 - 100).astype(np.float32)
        c = (rng.rand(400) * 200 - 100).astype(np.float32)
        # c = -(a*b rounded to f64) + tiny: exact value near a midpoint
        c[:100] = (-(a[:100].astype(np.float64) * b[:100])).astype(
            np.float32)
        got = tr._fma32(torch.from_numpy(a), torch.from_numpy(b),
                        torch.from_numpy(c)).numpy()
        for i in range(len(a)):
            exact = Fraction(float(a[i])) * Fraction(float(b[i])) \
                + Fraction(float(c[i]))
            lo = np.float32(float(exact))
            # correct rounding: no float32 is closer to the exact value
            best = min((np.nextafter(lo, np.float32(-np.inf)), lo,
                        np.nextafter(lo, np.float32(np.inf))),
                       key=lambda v: abs(Fraction(float(v)) - exact))
            assert got[i] == best or abs(
                Fraction(float(got[i])) - exact) == abs(
                Fraction(float(best)) - exact)


def _cull_features(case):
    """[(rings, value, window)] in pixel coordinates for one row-cull
    case on a canvas of 20 rows x 72 columns."""
    big = (-1.0e9, 1.0e9)
    if case == "stars":
        rng = np.random.RandomState(12)
        feats = []
        for v in range(1, 13):
            c = rng.rand(2) * [60, 12] + [6, 4]
            k = rng.randint(3, 40)
            ang = np.sort(rng.rand(k) * 2 * np.pi)
            rad = (rng.rand(k) * 0.5 + 0.5) * (rng.rand() * 9 + 1)
            feats.append(([np.stack([c[0] + rad * np.cos(ang),
                                     c[1] + rad * np.sin(ang)], 1)], v, big))
        return feats
    if case == "axis":  # horizontal and vertical edges, corners on the grid
        return [([np.array([[3, 2], [40, 2], [40, 9], [3, 9]], float)], 1,
                 big),
                ([np.array([[33, 7.5], [66.5, 7.5], [66.5, 17.5],
                            [33, 17.5]])], 2, big),
                ([np.array([[10, 12], [10, 19], [30, 19]], float)], 3, big)]
    if case == "centres":  # vertices on pixel centres and on corners
        return [([np.array([[4.5, 1.5], [31.5, 8.5], [12.5, 15.5]])], 1,
                 big),
                ([np.array([[32.0, 8.0], [63.0, 1.0], [70.0, 19.0],
                            [40.5, 12.0]])], 2, big),
                ([np.array([[5.0, 16.5], [25.5, 16.0], [15.0, 4.5]])], 3,
                 big)]
    if case == "closing":  # zero-length edges: repeated and closing vertices
        return [([np.array([[5.5, 2.5], [5.5, 2.5], [30.0, 6.0],
                            [12.0, 14.5], [5.5, 2.5]])], 1, big),
                ([np.array([[40.0, 9.5], [40.0, 9.5]])], 2, big),
                ([np.array([[50.0, 3.0], [69.0, 3.0], [60.0, 18.0],
                            [50.0, 3.0]])], 3, big)]
    if case == "windows":  # 1-row windows over features spanning blocks
        sq = np.array([[2.0, 0.5], [70.0, 1.5], [68.0, 19.0], [1.0, 18.5]])
        return [([sq], v, (float(r), float(r + 1)))
                for v, r in enumerate((0, 7, 8, 15, 19), start=1)]
    raise ValueError(case)


def _plain_pairs(e, cx, cy):
    """Per (edge, row, column): the plain burn's crossing and touch, with
    the expressions of _feature_mask, not reduced over edges."""
    x0, y0, x1, y1 = (e[:, i][:, None, None] for i in range(4))
    straddle = (y0 > cy) != (y1 > cy)
    dy = y1 - y0
    q = (cy - y0) / torch.where(dy == 0, 1.0, dy)
    crossing = straddle & (cx < tr._fma32(q, x1 - x0, x0))
    box = ((cx + 0.5 >= torch.minimum(x0, x1))
           & (cx - 0.5 <= torch.maximum(x0, x1))
           & (cy + 0.5 >= torch.minimum(y0, y1))
           & (cy - 0.5 <= torch.maximum(y0, y1)))
    ny = x0 - x1
    dist = tr._fma32(dy, cx - x0, ny * (cy - y0)).abs()
    touch = box & (dist <= (dy.abs() + ny.abs()) * 0.5)
    return crossing, touch


def _block_spans(cx, cy, bh):
    """Pixel-centre spans (bx0, bx1) and (by0, by1) of each pixel's
    block of bh rows x 32 columns, as burn.cu computes them."""
    f32 = torch.float32
    by0 = (torch.arange(cy.shape[1])[:, None] // bh * bh).to(f32) + 0.5
    bx0 = (torch.arange(cx.shape[2])[None] // 32 * 32).to(f32) + 0.5
    return bx0, bx0 + 31, by0, by0 + (bh - 1)


def _feature_cull(bbox, window, cx, cy, bh):
    """Per (row, column): burn.cu's block-level feature cull (bbox
    dilated 0.5 px, row window). It is exact at the mask level, not per
    pair: left of the bbox a closed ring's crossings come in pairs."""
    bx0, bx1, by0, by1 = _block_spans(cx, cy, bh)
    minx, miny, maxx, maxy = (float(v) for v in bbox)
    w0, w1 = window
    return ((minx - 0.5 <= bx1) & (maxx + 0.5 >= bx0) & (miny - 0.5 <= by1)
            & (maxy + 0.5 >= by0) & (w0 <= by1) & (w1 > by0))


def _kernel_pairs(e, window, cx, cy, bh, all_touched):
    """Per (edge, row, column), for a feature that passed the block's
    cull, with burn.cu's float32 expressions: (the crossings it records,
    the pairs on which it evaluates the per-pixel touch test). An edge
    is walked for a row past the warp's live test (row in the window),
    the block's staging test (y-span +- 0.5 meets the block's rows) and
    the row test (straddle, or the y half of box). A walked straddling
    edge is crossed by the first ceil(xint - bx0) pixels of the warp
    (none left of bx0, all right of bx1); touch is tested on the pixels
    from ceil(min x - col0) - 1 to floor(max x - col0), clamped to the
    warp, where the warp's columns can meet its x half of box."""
    bx0, bx1, by0, by1 = _block_spans(cx, cy, bh)
    j = torch.arange(cx.shape[2])[None] % 32
    col0 = bx0 - 0.5
    w0, w1 = window
    live = (cy >= w0) & (cy < w1)
    x0, y0, x1, y1 = (e[:, i][:, None, None] for i in range(4))
    xlo, xhi = torch.minimum(x0, x1), torch.maximum(x0, x1)
    ylo, yhi = torch.minimum(y0, y1), torch.maximum(y0, y1)
    staged = (by1 + 0.5 >= ylo) & (by0 - 0.5 <= yhi)
    strad = (y0 > cy) != (y1 > cy)
    ybox = (all_touched & (cy + 0.5 >= ylo) & (cy - 0.5 <= yhi))
    walked = live & staged & (strad | ybox)
    dy = y1 - y0
    xint = tr._fma32((cy - y0) / torch.where(dy == 0, 1.0, dy), x1 - x0, x0)
    n = torch.where(xint > bx1, 32.0,
                    torch.where(xint > bx0, torch.ceil(xint - bx0), 0.0))
    crossed = walked & strad & (j < n)
    near = ybox & (bx1 + 0.5 >= xlo) & (bx0 - 0.5 <= xhi)
    j0 = torch.ceil((xlo - col0).clamp(0.0, 32.0)) - 1
    j1 = torch.floor((xhi - col0).clamp(-1.0, 31.0))
    return crossed, walked & near & (j >= j0) & (j <= j1)


class TestRowCull:
    """burn.cu skips an edge for a row (and a warp of 32 columns) where
    its tests show the edge gives no crossing and no touch there, records
    a walked edge's crossings as a prefix of the warp's pixels, and tests
    touch only on a range of them. On rows inside the feature's window of
    blocks that keep the feature, the recorded crossings must be the
    plain predicate's exactly, and every touch must be tested, for two
    block heights the launcher takes."""

    @pytest.mark.parametrize("case", ["stars", "axis", "centres", "closing",
                                      "windows"])
    @pytest.mark.parametrize("bh", [8, 4])
    def test_kernel_records_every_crossing_and_touch(self, case, bh):
        H, W = 20, 72
        edges, _, windows = tr.pack_features(_cull_features(case))
        bbox, nedges = tr.feature_bounds(edges)
        cy = torch.arange(H, dtype=torch.float32)[None, :, None] + 0.5
        cx = torch.arange(W, dtype=torch.float32)[None, None, :] + 0.5
        crossings = touches = tested = 0
        for f in range(len(edges)):
            e = torch.from_numpy(edges[f, :nedges[f]])
            w0, w1 = (float(v) for v in windows[f])
            crossing, touch = _plain_pairs(e, cx, cy)
            kept = (cy >= w0) & (cy < w1) & _feature_cull(
                bbox[f], (w0, w1), cx, cy, bh)
            for at in (True, False):
                crossed, tests = _kernel_pairs(e, (w0, w1), cx, cy, bh, at)
                assert torch.equal(crossed & kept, crossing & kept), (
                    case, f, at)
                if at:
                    assert not (touch & kept & ~tests).any(), (case, f)
                    touches += int((touch & kept).sum())
                else:
                    assert not tests.any()
                crossings += int((crossing & kept).sum())
                tested += int(tests.sum())
        assert crossings > 0 and touches > 0
        # the culls do skip work: far fewer tests than pixels x edges
        assert 4 * tested < int(nedges.sum()) * H * W
