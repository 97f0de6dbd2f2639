"""The PyTorch port's device ops against the JAX package, on the CPU.

Same numpy inputs, made from a seed, go through the JAX function and
the port's counterpart with ``device="cpu"``, where every kernel wrapper
runs its plain PyTorch version. Tolerance is bitwise throughout: the
median and the mosaic are exact selections, and the burn predicate
rounds exactly as XLA:CPU does (two fused multiply-adds)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_image_segmentation_tpu.ops import compositing as jc
from dl_image_segmentation_tpu.ops.rasterize import (
    _bin_features as j_bin_features, _rasterize_jnp,
    pack_features as j_pack_features, rasterize as j_rasterize)
from dl_image_segmentation_tpu_torch import kernels
from dl_image_segmentation_tpu_torch.ops import compositing as tc

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
        edges, _, _ = tr.pack_features(_random_features(10, 20))
        bbox, nedges = tr._bboxes_nedges(torch.from_numpy(edges))
        np.testing.assert_array_equal(
            bbox.numpy(), np.stack(tr._feature_bboxes(edges), axis=-1))
        np.testing.assert_array_equal(
            nedges.numpy(), (edges[:, :, 0] != tr._FAR).sum(1))

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
        dense = tr.burn_dense(e, v, w, 255.0, N, N, True)
        cnt, tab = tr._bin_features(e.numpy(), w.numpy(), N, N,
                                    *tr.BURN_BLOCK)
        binned = tr.burn_binned(e, v, w, torch.from_numpy(cnt),
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
