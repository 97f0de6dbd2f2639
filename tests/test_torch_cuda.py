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


def test_train_step_card_equals_cpu():
    """Three fp32 steps from one state dict on the card and on the CPU:
    losses within 1e-4 relative; parameters within 2 * lr * steps (Adam's
    first steps move a parameter by about lr whatever its gradient's
    size, so a near-zero gradient of the other sign moves it the other
    way)."""
    _need_card()
    from dl_image_segmentation_tpu_torch.train import TrainConfig, Trainer
    cfg = TrainConfig(num_classes=3, base_features=8, levels=2, image_size=32,
                      batch_size=2, precision="fp32", grad_clip_norm=1.0)
    card, cpu = Trainer(cfg), Trainer(cfg, device="cpu")
    cpu.model.load_state_dict(card.model.state_dict())
    rng = np.random.RandomState(0)
    for _ in range(3):
        x = rng.randint(0, 256, (2, 32, 32, 3)).astype(np.uint8)
        y = rng.randint(0, 3, (2, 32, 32)).astype(np.int32)
        y[:, :4] = 255
        got, want = card.train_step(x, y), cpu.train_step(x, y)
        assert abs(got["loss"] - want["loss"]) <= 1e-4 * abs(want["loss"])
    assert card.state.step == cpu.state.step == 3
    diff = max(float((card.state.params[n].detach().cpu() - p.detach())
                     .abs().max())
               for n, p in cpu.state.params.items())
    assert diff <= 2 * cfg.learning_rate * 3


def test_device_prefetcher_stream_handoff():
    """Batches placed on the prefetcher's side stream reach a consumer
    whose stream is stalled (torch.cuda._sleep) intact: the consumer's
    stream waits for each copy, and record_stream keeps the allocator
    from handing a batch's memory to a later copy while the stalled
    stream still reads it."""
    _need_card()
    from dl_image_segmentation_tpu_torch.pipeline.input import \
        DevicePrefetcher
    from dl_image_segmentation_tpu_torch.train import TrainConfig, Trainer
    t = Trainer(TrainConfig(base_features=8, levels=1, image_size=32))
    batches = [(np.full((64, 128, 128, 3), i, np.float32),
                np.full((64, 128, 128), i, np.int32)) for i in range(12)]
    sums = []
    with DevicePrefetcher(iter(batches), t.place_batch, depth=2) as pf:
        for x, y in pf:
            assert x.is_cuda and y.is_cuda
            torch.cuda._sleep(20_000_000)
            sums.append(torch.stack([x.double().mean(), y.double().mean()]))
    got = torch.stack(sums).cpu().numpy()
    np.testing.assert_array_equal(got, np.repeat(np.arange(12.0)[:, None],
                                                 2, 1))


@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_forward_bits_do_not_depend_on_batch_slot(precision):
    """The full-width s2d 2 U-Net at batch 8: each image's logits are the
    same bits whatever its slot in the batch (cuDNN's engine for one bf16
    conv of this tree splits its reduction by output tile, so that conv
    runs without cuDNN in an inference forward), and the served == predict
    check does not depend on the order in which requests arrive."""
    _need_card()
    from dl_image_segmentation_tpu_torch.train import TrainConfig, Trainer
    t = Trainer(TrainConfig(batch_size=8, precision=precision))
    x = torch.from_numpy(np.random.RandomState(5).rand(
        8, 256, 256, 3).astype(np.float32)).cuda()
    perm = torch.tensor([3, 7, 0, 5, 1, 6, 2, 4]).cuda()
    base = t.logits(x)
    assert torch.equal(t.logits(x[perm].contiguous()), base[perm])


@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_served_maps_equal_unpadded_predict(precision):
    """The full-width s2d 2 U-Net at batch 8: PredictServer pads every
    dispatch to the batch size; its class maps equal Trainer.predict of
    bs - 1, 1 and 2 * bs images (as the JAX package asserts for bs - 1,
    __graft_entry__.py:146), whatever N the caller gives predict."""
    _need_card()
    from dl_image_segmentation_tpu_torch.serve import PredictServer
    from dl_image_segmentation_tpu_torch.train import TrainConfig, Trainer
    bs = 8
    t = Trainer(TrainConfig(batch_size=bs, precision=precision))
    assert t.s2d == 2
    images = np.random.RandomState(11).rand(2 * bs, 256, 256, 3).astype(
        np.float32)
    ps = PredictServer(t, max_wait_ms=1.0)
    try:
        served = []
        for img in images:  # one request a dispatch: padded with zeros
            p = ps.submit(img, probs=False)
            assert p.error is None, p.error
            served.append(p.result)
    finally:
        ps.close()
    for n in (bs - 1, 1, 2 * bs):
        got = t.predict(images[:n])
        assert got.shape == (n, 256, 256)
        for i in range(n):
            np.testing.assert_array_equal(got[i], served[i],
                                          err_msg=f"N={n}, image {i}")


@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_train_steps_are_deterministic(precision):
    """Two runs of 3 steps from one state dict on the card, at full width
    (TrainConfig defaults with 10 classes, batch 8): bitwise-equal losses
    and parameters (the step takes cuDNN's deterministic algorithms; at
    fp32 the default backward convs differ from run to run)."""
    _need_card()
    from dl_image_segmentation_tpu_torch.train import TrainConfig, Trainer
    cfg = TrainConfig(num_classes=10, batch_size=8, precision=precision)
    rng = np.random.RandomState(2)
    x = rng.randint(0, 256, (8, 256, 256, 3)).astype(np.float32)
    y = rng.randint(0, 10, (8, 256, 256)).astype(np.int32)
    y[:, :16] = 255
    first = Trainer(cfg)
    state = {k: v.detach().clone()
             for k, v in first.model.state_dict().items()}
    runs = []
    for _ in range(2):
        t = Trainer(cfg)
        t.model.load_state_dict(state)
        losses = [t.train_step(x, y)["loss"] for _ in range(3)]
        runs.append((losses, {n: p.detach().clone()
                              for n, p in t.state.params.items()}))
    (l1, p1), (l2, p2) = runs
    assert l1 == l2
    assert [n for n in p1 if not torch.equal(p1[n], p2[n])] == []


@pytest.mark.parametrize("kw", [
    {"model": "segformer"}, {"quantize": "int8"},
    {"quantize": "int8-static"}], ids=["segformer", "int8", "int8-static"])
def test_family_served_maps_equal_unpadded_predict(kw):
    """SegFormer-lite and the int8 U-Net (full width, bf16, batch 8):
    served class maps equal Trainer.predict of bs - 1, 1 and 2 * bs
    images (int8-static calibrated once, on the first images)."""
    _need_card()
    from dl_image_segmentation_tpu_torch.serve import PredictServer
    from dl_image_segmentation_tpu_torch.train import TrainConfig, Trainer
    bs = 8
    t = Trainer(TrainConfig(batch_size=bs, **kw))
    images = np.random.RandomState(12).rand(2 * bs, 256, 256, 3).astype(
        np.float32)
    assert t.calibrate([images[:bs]]) == (
        1 if kw.get("quantize") == "int8-static" else 0)
    ps = PredictServer(t, max_wait_ms=1.0)
    try:
        served = []
        for img in images:
            p = ps.submit(img, probs=False)
            assert p.error is None, p.error
            served.append(p.result)
    finally:
        ps.close()
    for n in (bs - 1, 1, 2 * bs):
        got = t.predict(images[:n])
        for i in range(n):
            np.testing.assert_array_equal(got[i], served[i],
                                          err_msg=f"N={n}, image {i}")


@pytest.mark.parametrize("precision", ["bf16", "fp32"])
@pytest.mark.parametrize("model", ["deeplab", "segformer"])
def test_family_train_steps_are_deterministic(model, precision):
    """DeepLab-lite and SegFormer-lite at full width (10 classes, batch
    8): two runs of 3 steps from one state dict, bitwise equal."""
    _need_card()
    from dl_image_segmentation_tpu_torch.train import TrainConfig, Trainer
    cfg = TrainConfig(num_classes=10, batch_size=8, precision=precision,
                      model=model)
    rng = np.random.RandomState(3)
    x = rng.randint(0, 256, (8, 256, 256, 3)).astype(np.float32)
    y = rng.randint(0, 10, (8, 256, 256)).astype(np.int32)
    y[:, :16] = 255
    state = {k: v.detach().clone()
             for k, v in Trainer(cfg).model.state_dict().items()}
    runs = []
    for _ in range(2):
        t = Trainer(cfg)
        t.model.load_state_dict(state)
        losses = [t.train_step(x, y)["loss"] for _ in range(3)]
        runs.append((losses, {n: p.detach().clone()
                              for n, p in t.state.params.items()}))
    (l1, p1), (l2, p2) = runs
    assert l1 == l2
    assert [n for n in p1 if not torch.equal(p1[n], p2[n])] == []


@pytest.mark.parametrize("n,c,hw,o,k,s", [
    (8, 12, 128, 64, 3, 1),     # the s2d 2 tree's first conv (K = 108)
    (8, 64, 128, 64, 2, 2),     # its first down conv
    (8, 512, 16, 1024, 3, 1),   # the bottom
    (1, 3, 4, 5, 3, 1)])        # M, K, O all below the GEMM's minimum
def test_int8_conv_card_equals_cpu(n, c, hw, o, k, s):
    """torch._int_mm's int32 sums on the card equal the CPU's bitwise."""
    _need_card()
    from dl_image_segmentation_tpu_torch.models.quant import int8_conv2d
    g = torch.Generator().manual_seed(n * c + o)
    qx = torch.randint(-127, 128, (n, c, hw, hw), generator=g,
                       dtype=torch.int8)
    qw = torch.randint(-127, 128, (o, c, k, k), generator=g,
                       dtype=torch.int8)
    want = int8_conv2d(qx, qw, s)
    got = int8_conv2d(qx.cuda(), qw.cuda(), s)
    assert torch.equal(got.cpu(), want)


def _local_root(root, tile):
    """A LocalCatalog root over the 3 x 2 tiles from ``tile``: Sentinel-2
    scenes of 4 uint16 bands with nodata 0, one at 2.5 m (a ~3.5 MB file,
    read windowed below), one in zone 42 at 10 m and one at 20 m; and a
    label GeoJSON of 80 seeded polygons over the block. Returns the label
    path."""
    import datetime as dt
    import json
    import os
    from dl_image_segmentation_tpu_torch.catalog import LocalCatalog
    from dl_image_segmentation_tpu_torch.catalog.base import reproject_bounds
    from dl_image_segmentation_tpu_torch.geo import crs
    cat = LocalCatalog.create(root)
    x0, y0, x1, y1 = tile.bounds
    span = x1 - x0
    block = (x0 - 50, y0 - span - 50, x1 + 2 * span + 50, y1 + 50)
    rng = np.random.RandomState(9)
    for k, (zone, res) in enumerate(((43, 2.5), (42, 10.0), (43, 20.0))):
        bx0, by0, bx1, by1 = reproject_bounds(block, 43, zone, margin=res)
        w = int(np.ceil((bx1 - bx0) / res))
        h = int(np.ceil((by1 - by0) / res))
        arr = rng.randint(1, 4096, (h, w, 4)).astype(np.uint16)
        arr[rng.rand(h, w) < 0.05] = 0
        cat.add_scene("sentinel-2:L1C", ["red", "green", "blue", "nir"],
                      f"s{k}", dt.date(2020, 9, 1 + k), arr,
                      (bx0 + 0.3, res, 0.0, by1 - 0.7, 0.0, -res),
                      32600 + zone, nodata=0)
    # 80 polygons: a tile burns fewer than 65 (the dense kernel), a
    # batch of tiles more (the binned one)
    feats = []
    for i in range(80):
        c = (x0 + (0.3 + 2.4 * rng.rand()) * span,
             y1 - (0.3 + 1.4 * rng.rand()) * span)
        ang = np.sort(rng.rand(9) * 2 * np.pi)
        rad = (0.2 + 0.8 * rng.rand(9)) * 0.12 * span
        ring = np.stack([c[0] + rad * np.cos(ang), c[1] + rad * np.sin(ang)],
                        1)
        ring = np.concatenate([ring, ring[:1]])
        lon, lat = crs.utm_to_lonlat(ring[:, 0], ring[:, 1], 43)
        feats.append({"type": "Feature", "properties": {"cls": i % 4 + 1},
                      "geometry": {"type": "Polygon", "coordinates": [
                          np.stack([lon, lat], 1).tolist()]}})
    path = os.path.join(root, "labels.geojson")
    with open(path, "w") as f:
        json.dump({"type": "FeatureCollection", "features": feats}, f)
    return path


@pytest.mark.parametrize("batch_tiles", [0, 16])
def test_local_catalog_export_card_equals_cpu(tmp_path, batch_tiles):
    """A median export from a LocalCatalog root (a windowed scene, a
    zone-42 scene, one decoded whole): the card's chip bytes equal the
    CPU's, and the path launched its kernels."""
    _need_card()
    import datetime as dt
    import os
    from dl_image_segmentation_tpu_torch.catalog import LocalCatalog
    from dl_image_segmentation_tpu_torch.geo import Tile
    from dl_image_segmentation_tpu_torch.pipeline.chips import (
        DLSampleCreationConfig, OGRLabelDataDesc)
    from dl_image_segmentation_tpu_torch.pipeline.export import run_export
    root = str(tmp_path / "cat")
    labels = _local_root(root, Tile(60, 2, 10.0, 43, -380, 3491))
    trees = {}
    for device in ("cuda", "cpu"):
        cat = LocalCatalog(root, window_bytes=2 << 20)
        cfg = DLSampleCreationConfig(
            64, 2, 10.0, "sentinel-2:L1C", "red green blue nir",
            str(tmp_path / device), "t", OGRLabelDataDesc(labels, 0, "cls"),
            max_cloud_fraction=0, catalog=cat)
        jobs = cfg.create_tile_job_configs("aoi", 2020, dt.date(2020, 11, 1))
        assert len(jobs) > 2
        before = {c.name: c.count for c in kernels.COUNTERS}
        report = run_export(jobs, n_workers=4, progress=None,
                            batch_tiles=batch_tiles, device=device)
        assert report.ok and report.attempts == 1
        if device == "cuda":
            burn = "burn_binned" if batch_tiles else "burn_dense"
            for name in ("masked_median", burn):
                assert kernels.COUNTERS[[c.name for c in kernels.COUNTERS]
                                        .index(name)].count > before[name]
        assert list(cat._readers) == ["scenes/s0.tif"]
        assert sorted(cat._cache) == ["scenes/s1.tif", "scenes/s2.tif"]
        folder = jobs[0].OUTFOLDER
        trees[device] = {
            (sub, n): open(os.path.join(folder, sub, n), "rb").read()
            for sub in ("images", "labels")
            for n in sorted(os.listdir(os.path.join(folder, sub)))}
    assert len(trees["cpu"]) == 2 * len(jobs)
    assert trees["cuda"] == trees["cpu"]
