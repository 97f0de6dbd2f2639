"""The port's ``parallel/`` against the JAX package's, on the CPU.

* The sharding rule: ``param_shardings`` picks the leaves and axes of the
  JAX rule, mapped through the converter's names (the JAX side from
  ``jax.eval_shape`` of the flax init: nothing compiles), for the U-Net
  (base 16, 32, 128; 2 levels), DeepLab-lite and SegFormer-lite on the
  meshes (4, 2), (2, 2) and (8, 1), ``tp_min_features`` 64 and 256, FSDP
  off and on.
* The data plane: ``host_shard_files`` by rank equals the JAX function
  by process; the writers' ``host_index`` / ``host_count`` shards,
  merged, equal the one-host run's and the JAX writer's bytes.
* One 4-rank gloo world (``dryrun_multichip``, once for the module,
  torch on one thread a rank) runs DP 4x1, TP 2x2 (base 128: a stage
  crosses tp_min_features 256, as the JAX package's sharded-checkpoint
  test), spatial 2x2, FSDP+TP 2x2, FSDP 4x1 and SegFormer-lite TP 2x2,
  each 3 fp32 steps with clipping at 1.0 on seeded batches whose first
  has one rank's rows all nodata, then evaluate, predict and a
  checkpoint. Each regime is held against the port's one-process
  trainer on the same batches from the same weights: the first step's
  synced and clipped gradients leaf by leaf (the difference's norm
  within 1e-2 of the leaf's plus 1e-6 of the whole gradient's) and its
  global norm before the clip (1e-5 relative), which Adam's scale-free
  update would not show; losses within 2e-5 relative (the JAX
  package's bound for a sharded step, tests/test_training.py:736),
  accuracy within one pixel's share, evaluate's loss within 1e-5
  relative and its mIoU within one pixel's share, class maps equal
  wherever the top two probabilities are more than 1e-3 apart. The
  parameters after three steps differ by at most 2 * steps * lr. A
  witness, one process through torch's other CPU convs (the same sums
  in other orders), stays inside the same bars: the GroupNorms' backward
  leaves small gradients against their rounding, and Adam moves a
  parameter by about lr a step whatever its gradient's size, so
  rounding on a near-zero gradient moves it by up to lr. Checkpoints
  restore bitwise in the world (each rank its shards), in one process,
  and re-sharded (the FSDP 4x1 regime restores the FSDP+TP one's). The spatial and FSDP+TP regimes start
  from a flax init and are held against the JAX ``Trainer`` on a 2x2
  mesh of the 8 virtual devices: per-step losses within 1e-4 relative
  (two conv implementations; Adam's first steps turn rounding into
  +-lr moves of near-zero gradients). The JAX steps compile in a thread
  while the world runs.
* ``cli train`` in a 2-rank gloo world (torchrun's variables, ``--device
  cpu``): data parallel per step and from a ``--scan-steps`` pool, and
  ``--n-model 2 --spatial --augment``, each logging the losses of a
  one-process ``train`` on the same records (every rank reads the same
  global batches).
"""

import dataclasses
import functools
import json
import os
import socket
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_image_segmentation_tpu.models import deeplab as jdeeplab
from dl_image_segmentation_tpu.models import segformer as jsegformer
from dl_image_segmentation_tpu.models import unet as junet
from dl_image_segmentation_tpu.parallel import sharding as jsharding
from dl_image_segmentation_tpu.pipeline import input as jinput
from dl_image_segmentation_tpu.records import writers as jwriters
from dl_image_segmentation_tpu.train import trainer as jtrainer
from dl_image_segmentation_tpu_torch.models import convert as tconvert
from dl_image_segmentation_tpu_torch.models.deeplab import DeepLabLite
from dl_image_segmentation_tpu_torch.models.segformer import SegFormerLite
from dl_image_segmentation_tpu_torch.models.unet import UNet
from dl_image_segmentation_tpu_torch.parallel import distributed as tdist
from dl_image_segmentation_tpu_torch.parallel import sharding as tsharding
from dl_image_segmentation_tpu_torch import cli as tcli
from dl_image_segmentation_tpu_torch.parallel.dryrun import (
    digests, dryrun_multichip, seeded_batches, write_shards)
from dl_image_segmentation_tpu_torch.pipeline import input as tinput
from dl_image_segmentation_tpu_torch.records import writers as twriters
from dl_image_segmentation_tpu_torch.serve import PredictServer
from dl_image_segmentation_tpu_torch.train.trainer import TrainConfig, Trainer

from tests.test_torch_models import seeded_tree
from tests.test_torch_records import chip_folder, png_chip_folder, read_dir

# one intra-op thread: the test workers share the host's cores
torch.set_num_threads(1)

# -- 1. the sharding rule ------------------------------------------------

MODELS = {
    "unet16": (lambda: UNet(3, 16, 2), lambda: junet.UNet(3, 16, 2), 32),
    "unet32": (lambda: UNet(3, 32, 2), lambda: junet.UNet(3, 32, 2), 32),
    "unet128": (lambda: UNet(3, 128, 2), lambda: junet.UNet(3, 128, 2), 32),
    "deeplab": (lambda: DeepLabLite(3, 32), lambda: jdeeplab.DeepLabLite(3),
                64),
    "segformer": (lambda: SegFormerLite(3, 32),
                  lambda: jsegformer.SegFormerLite(3), 64),
}
# the torch dim that holds the flax kernel's last (output) axis, by the
# converter's layout
TORCH_COUT = {tconvert._conv_kernel: 0, tconvert._conv_transpose_kernel: 1,
              tconvert._dense_kernel: 0}


@functools.lru_cache(maxsize=None)
def port_model(kind):
    return MODELS[kind][0]()


@functools.lru_cache(maxsize=None)
def jax_shapes(kind):
    _, make, size = MODELS[kind]
    return jax.eval_shape(make().init, jax.random.PRNGKey(0),
                          jnp.zeros((1, size, size, 3)))["params"]


def _entry(spec):
    return spec[-1] if len(spec) else None


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("tp_min", [64, 256])
@pytest.mark.parametrize("shape", [(4, 2), (2, 2), (8, 1)])
@pytest.mark.parametrize("kind", list(MODELS))
def test_param_shardings_equal_jax(kind, shape, tp_min, fsdp):
    nd, nm = shape
    jmesh = jsharding.make_mesh(n_data=nd, n_model=nm,
                                devices=jax.devices()[:nd * nm])
    jsh = jsharding.param_shardings(jmesh, jax_shapes(kind),
                                    tp_min_features=tp_min, fsdp=fsdp)
    flat, _ = jax.tree_util.tree_flatten_with_path(jsh)
    want = {"/".join(k.key for k in path): _entry(s.spec)
            for path, s in flat}
    model = port_model(kind)
    tsh = tsharding.param_shardings({"data": nd, "model": nm}, model,
                                    tp_min_features=tp_min, fsdp=fsdp)
    names = {id(p): n for n, p in model.named_parameters()}
    got = {}
    for leaf, param, layout in tconvert._plan(model):
        spec = tsh[names[id(param)]].spec
        sharded = [(i, e) for i, e in enumerate(spec) if e is not None]
        got[leaf] = None
        if sharded:
            (dim, entry), = sharded
            assert dim == TORCH_COUT[layout], (leaf, spec)
            got[leaf] = entry
    assert got == want
    if kind == "unet16" and shape == (4, 2) and tp_min == 64 and not fsdp:
        # the JAX package's TestMesh: a wide kernel is model sharded
        assert "model" in set(got.values())
    if kind == "unet32" and shape == (4, 2) and tp_min == 64 and fsdp:
        # test_fsdp_composes_with_channel_tp's ("model", "data") leaf
        assert ("model", "data") in set(got.values())


# -- 2. the data plane ---------------------------------------------------

@pytest.mark.parametrize("n,i", [(1, 0), (2, 0), (2, 1), (3, 0), (3, 2),
                                 (4, 1), (4, 3)])
def test_host_shard_files_and_feed_deal_by_rank_as_jax(monkeypatch, tmp_path,
                                                       n, i):
    files = [str(tmp_path / f"s-{k:05d}-of-00010") for k in
             (7, 3, 0, 9, 1, 8, 2, 6, 4, 5)]
    for f in files:
        open(f, "wb").close()
    monkeypatch.setattr(jax, "process_count", lambda: n)
    monkeypatch.setattr(jax, "process_index", lambda: i)
    monkeypatch.setattr(tdist, "world_size", lambda: n)
    monkeypatch.setattr(tdist, "rank", lambda: i)
    want = jinput.host_shard_files(files)
    assert tinput.host_shard_files(files) == want
    pattern = str(tmp_path / "s-*")
    assert tinput.TFRecordFeed(pattern, "tifarr", 2).files == \
        jinput.TFRecordFeed(pattern, "tifarr", 2).files == want
    assert tinput.TFRecordFeed(pattern, "tifarr", 2,
                               per_host=False).files == sorted(files)


@pytest.mark.parametrize("engine", ["mp", "mt"])
def test_writers_split_over_hosts_equal_one_host_and_jax(tmp_path, engine):
    if engine == "mp":
        chips = chip_folder(str(tmp_path / "chips"), np.uint8)
        port, ref = twriters.process_dataset_mp, jwriters.process_dataset_mp
    else:
        chips = png_chip_folder(str(tmp_path / "chips"))
        port = twriters.process_dataset_multithreaded
        ref = jwriters.process_dataset_multithreaded
    one = str(tmp_path / "one")
    assert port("h", chips, one, 4, store_as_array=True) == 12
    for who, fn in (("port", port), ("jax", ref)):
        total = sum(fn("h", chips, str(tmp_path / who), 4,
                       store_as_array=True, host_index=h, host_count=2)
                    for h in range(2))
        assert total == 12
    merged = read_dir(str(tmp_path / "port"))
    assert sorted(merged) == [f"h-0000{k}-of-00004" for k in range(4)]
    assert merged == read_dir(one) == read_dir(str(tmp_path / "jax"))


# -- 3. and 4. the world -------------------------------------------------

BASE = dict(num_classes=3, base_features=16, levels=2, image_size=32,
            batch_size=8, precision="fp32", grad_clip_norm=1.0)
CONFIGS = {
    "dp": dict(BASE),
    "tp": dict(BASE, base_features=128, n_model=2),
    "spatial": dict(BASE, n_model=2, spatial=True),
    "fsdp_tp": dict(BASE, base_features=64, n_model=2, fsdp=True),
    "fsdp": dict(BASE, base_features=64, fsdp=True),
    "segformer": dict(BASE, model="segformer", base_features=32,
                      image_size=64, n_model=2),
}
FROM_JAX = ("spatial", "fsdp_tp")
LOSS_RTOL, JAX_RTOL = 2e-5, 1e-4
# the first step's fp32 gradients, summed in another order: the global
# norm before the clip within NORM_RTOL relative; each leaf's difference
# within GRAD_RTOL of the leaf's norm plus GRAD_ATOL of the whole
# gradient's (for leaves that are zero but for rounding, as SegFormer's
# key biases under the softmax). One process through another conv
# implementation (the witness below) moves the leaves under the TP
# regime's GroupNorms by up to a few 1e-3 of their norm: the backward of
# a GroupNorm subtracts the group's mean, and what is left of a
# gradient is small against its rounding. A gradient counted twice is
# off by 1 of its norm, a shard counted twice in the clip's norm by
# tens of percent
NORM_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-2, 1e-6
# after three Adam steps the world's parameters and the one process's
# are apart by the first steps' +-lr moves of near-zero gradients
PROBS_ATOL = 1e-3


def jax_init(name):
    cfg = CONFIGS[name]
    model = junet.UNet(num_classes=cfg["num_classes"],
                       base_features=cfg["base_features"],
                       levels=cfg["levels"], dtype=jnp.float32)
    return seeded_tree(model, cfg["image_size"], seed=1)


def jax_world_losses(name, init, batches, out):
    """3 steps of the JAX Trainer on a 2x2 mesh of the virtual devices
    from ``init``, placed as its ``_init_state`` places them."""
    cfg = jtrainer.TrainConfig(**CONFIGS[name])
    mesh = jsharding.make_mesh(n_data=2, n_model=2,
                               devices=jax.devices()[:4])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer.Trainer, "_init_state", lambda self: None)
        t = jtrainer.Trainer(cfg, mesh=mesh)
    p_sh = jsharding.param_shardings(
        mesh, init, tp_min_features=(1 << 30) if cfg.spatial else 256,
        fsdp=cfg.fsdp)
    params = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(jnp.asarray(x), s), init, p_sh)
    rep = jsharding.replicated_sharding(mesh)
    t.state = jtrainer.TrainState(
        params, jax.device_put(t.tx.init(params), rep),
        jax.device_put(jnp.zeros((), jnp.int32), rep))
    out[name] = [t.train_step(x, y)["loss"] for x, y in batches]


def one_process(name, init=None):
    """The port's one-process trainer for a regime (no model axis)."""
    cfg = dataclasses.replace(TrainConfig(**CONFIGS[name]), n_model=1,
                              spatial=False)
    tr = Trainer(cfg, device="cpu")
    if init is not None:
        tr.load_flax_params(init)
    return tr


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world's results, the JAX losses, and each regime's batches and
    init."""
    work = str(tmp_path_factory.mktemp("world"))
    regimes, inits, batches = {}, {}, {}
    for name, cfg in CONFIGS.items():
        batches[name] = seeded_batches(cfg, 3, 0)
        inits[name] = jax_init(name) if name in FROM_JAX else None
        regimes[name] = {"n_model": cfg.get("n_model", 1), "config": cfg,
                         "batches": batches[name], "init": inits[name]}
    regimes["tp"]["data_plane"] = True
    regimes["spatial"]["scanned"] = True
    regimes["fsdp"]["restore"] = "fsdp_tp"
    jax_losses: dict = {}
    errors = []

    def run_jax():
        try:
            for name in FROM_JAX:
                jax_world_losses(name, inits[name], batches[name],
                                 jax_losses)
        except BaseException as e:  # reported by the tests that need it
            errors.append(e)
    thread = threading.Thread(target=run_jax)
    thread.start()
    try:
        res = dryrun_multichip(4, "cpu", regimes, workdir=work)
    finally:
        thread.join()
    return {"res": res, "jax": jax_losses, "jax_errors": errors,
            "inits": inits, "batches": batches}


@functools.lru_cache(maxsize=None)
def reference(name, mkldnn=True):
    """The one-process run of a regime, as the world ran it: 3 steps (the
    first step's gradients and every step's global norm kept),
    evaluate, predict, predict_probs, and for the spatial regime the
    scanned dispatches. ``mkldnn=False``: the steps only, through
    torch's other CPU convs (the same sums in other orders)."""
    tr = one_process(name, jax_init(name) if name in FROM_JAX else None)
    batches = seeded_batches(CONFIGS[name], 3, 0)
    out, norms = [], []
    with torch.backends.mkldnn.flags(enabled=mkldnn):
        for x, y in batches:
            out.append(tr.train_step(x, y))
            norms.append(float(tr.grad_norm))
            if len(out) == 1:
                grads = {n: p.grad.clone()
                         for n, p in tr.state.params.items()}
    ref = {"losses": [m["loss"] for m in out],
           "accuracies": [m["accuracy"] for m in out],
           "grads": grads, "grad_norms": norms, "trainer": tr}
    if not mkldnn:
        return ref
    ex, ey = batches[-1]
    ref.update({"eval": tr.evaluate([(ex, ey)]),
           "predict": tr.predict(ex[:-1]),
           "probs": tr.predict_probs(ex[:-1])})
    if name == "spatial":
        from dl_image_segmentation_tpu_torch.train.pool import DeviceDataPool
        rng = np.random.RandomState(1)
        px = rng.randint(0, 255, (16, 32, 32, 3), np.uint8)
        pool = DeviceDataPool(px, (px[..., 0] > 128).astype(np.uint8),
                              device="cpu")
        tr.train_scanned(pool, total_steps=4, steps_per_dispatch=2, seed=0,
                         augment=True)
        ref["scan_losses"] = tr.scan_losses[-4:]
    return ref


def pixel_share(name):
    cfg = CONFIGS[name]
    return 1.0 / (cfg["batch_size"] * cfg["image_size"] ** 2)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_world_steps_equal_one_process(world, name):
    got, ref = world["res"][name], reference(name)
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["accuracies"], ref["accuracies"],
                               atol=pixel_share(name))
    nd = 4 // CONFIGS[name].get("n_model", 1)
    assert got["mesh"] == {"data": nd, "model": 4 // nd}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_world_gradients_equal_one_process(world, name):
    """The first step's gradients after the sync and the clip, leaf by
    leaf, and its global norm before the clip: a gradient counted
    n_model times (a reduce-scatter in the TP gather's backward) or a
    shard counted twice in the norm shows here, though not in Adam's
    scale-free steps. (Later steps start from parameters that Adam's
    first step has already set apart by rounding.)"""
    got, ref = world["res"][name], reference(name)
    np.testing.assert_allclose(got["grad_norms"][0], ref["grad_norms"][0],
                               rtol=NORM_RTOL)
    assert_grads_close(got["grads"], ref["grads"])


def assert_grads_close(got, want):
    assert got.keys() == want.keys()
    whole = float(torch.sqrt(sum(w.square().sum() for w in want.values())))
    for n, w in want.items():
        assert got[n].shape == w.shape, n
        assert float((got[n] - w).norm()) <= (GRAD_RTOL * float(w.norm())
                                              + GRAD_ATOL * whole), n


@pytest.mark.parametrize("name", ["dp", "tp", "spatial"])
def test_world_within_the_gaps_of_another_conv_implementation(world, name):
    """The witness: one process through torch's other CPU convs, the same
    sums in other orders, is within the bars the world is held to (its
    losses, its first gradients and their norm), and after three steps
    both its parameters and the world's are within 2 * steps * lr of the
    one process's: Adam moves a parameter by about lr a step whatever
    the size of its gradient, so a near-zero gradient's rounding moves it
    by up to lr."""
    cfg = TrainConfig(**CONFIGS[name])
    bound = 2 * 3 * cfg.learning_rate
    ref = reference(name)["trainer"].state.params
    witness = reference(name, mkldnn=False)
    got = torch.load(world["res"][name]["checkpoint"],
                     weights_only=True)["params"]
    np.testing.assert_allclose(witness["losses"], reference(name)["losses"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(witness["grad_norms"][0],
                               reference(name)["grad_norms"][0],
                               rtol=NORM_RTOL)
    assert_grads_close(witness["grads"], reference(name)["grads"])
    for other in (got, witness["trainer"].state.params):
        gap = max(float((other[n] - p).detach().abs().max())
                  for n, p in ref.items())
        assert gap <= bound


def test_nodata_skewed_batch_counts_every_rank(world):
    """The first batch leaves data rank 0 of the DP world without one
    valid pixel: the loss is still the global masked mean."""
    x, y = world["batches"]["dp"][0]
    assert (y[:2] == 255).all() and (y[2:] != 255).any()
    np.testing.assert_allclose(world["res"]["dp"]["losses"][0],
                               reference("dp")["losses"][0], rtol=1e-6)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_world_evaluate_and_predict_equal_one_process(world, name):
    got, ref = world["res"][name], reference(name)
    np.testing.assert_allclose(got["eval"]["loss"], ref["eval"]["loss"],
                               rtol=1e-5)
    assert abs(got["eval"]["miou"] - ref["eval"]["miou"]) <= \
        pixel_share(name)
    assert got["eval"]["batches"] == 1
    assert got["predict"].shape == ref["predict"].shape
    np.testing.assert_allclose(got["probs"], ref["probs"], atol=PROBS_ATOL)
    s = np.sort(ref["probs"], axis=-1)
    apart = s[..., -1] - s[..., -2] > PROBS_ATOL
    assert apart.mean() > 0.9
    np.testing.assert_array_equal(got["predict"][apart],
                                  ref["predict"][apart])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_world_checkpoint_restores_bitwise_here_and_in_the_world(world,
                                                                 name):
    got = world["res"][name]
    assert all(r["checkpoint_equal"] for r in got["ranks"])
    tr = one_process(name)
    tr.restore_checkpoint(got["checkpoint"])
    assert tr.state.step == 3
    assert digests(tr.state.params) == got["param_digests"]


def test_checkpoint_reshards_onto_another_mesh(world):
    """The FSDP 4x1 trainer restores the FSDP+TP 2x2 world's checkpoint:
    other shards on every rank, the same full parameters."""
    src, dst = world["res"]["fsdp_tp"], world["res"]["fsdp"]
    assert dst["restored_from"] == src["checkpoint"]
    assert dst["restored_digests"] == src["param_digests"]
    assert src["ranks"][0]["sharded"] != dst["ranks"][0]["sharded"]


@pytest.mark.parametrize("name,kinds", [
    ("fsdp", {"data"}), ("fsdp_tp", {"data", "model+data"}),
    ("tp", {"model"})])
def test_sharded_storage_follows_the_rule(world, name, kinds):
    """Sharded leaves hold 1/n of the kernel on each rank (n: the ranks
    that share it), biases and norm scales stay whole, Adam's moments
    are stored like their parameter (the JAX package's TestFSDP)."""
    got = world["res"][name]
    mesh = got["mesh"]
    full = {k: v.shape for k, v in got["grads"].items()}
    for r in got["ranks"]:
        assert set(r["sharded"].values()) == kinds
        for k, shape in r["local_shapes"].items():
            size = int(np.prod(full[k]))
            if k in r["sharded"]:
                n = int(np.prod([mesh[a] for a in r["sharded"][k].split(
                    "+")]))
                assert len(shape) >= 2 and int(np.prod(shape)) * n == size
            else:
                assert tuple(shape) == tuple(full[k])
        assert not any(k.endswith("bias") for k in r["sharded"])
        assert r["moment_bytes"] == 2 * r["param_bytes"]
        whole = sum(4 * int(np.prod(s)) for s in full.values())
        assert r["param_bytes"] < whole


def test_spatial_scanned_from_a_sharded_pool_equals_one_process(world):
    """train_scanned with augmentation from a pool stored sharded over
    "data", bands over "model" (the JAX package's TestSpatialScanned)."""
    got = world["res"]["spatial"]
    assert [r["pool_rows"] for r in got["ranks"]] == [8, 8, 8, 8]
    np.testing.assert_allclose(got["scan_losses"],
                               reference("spatial")["scan_losses"],
                               rtol=LOSS_RTOL)


def test_data_plane_feeds_sharded_steps_and_a_sharded_pool(world):
    got = world["res"]["tp"]
    assert len(got["feed_losses"]) == 3
    assert np.isfinite(got["feed_losses"]).all()
    # every rank of the TP world reads every shard; the pool of 16 is
    # stored 8 a data rank
    assert all(len(r["feed_files"]) == 4 for r in got["ranks"])
    assert [r["feed_pool_rows"] for r in got["ranks"]] == [8, 8, 8, 8]


@pytest.mark.parametrize("name", FROM_JAX)
def test_world_against_the_jax_trainer(world, name):
    if world["jax_errors"]:
        raise world["jax_errors"][0]
    np.testing.assert_allclose(world["res"][name]["losses"],
                               world["jax"][name], rtol=JAX_RTOL)


# -- cli train in a world -----------------------------------------------

CLI_TRAIN = ["train", "--mode", "rgbarr", "--classes", "2", "--channels",
             "3", "--features", "8", "--levels", "2", "--image-size", "32",
             "--batch-size", "4", "--steps", "3", "--log-every", "1",
             "--precision", "fp32", "--workers", "2", "--device", "cpu"]
# name: (the world's extra arguments, the one process's)
CLI_RUNS = {
    "dp": ([], []),
    "dp --scan-steps": (["--scan-steps", "3", "--pool-size", "8"],) * 2,
    "spatial --augment": (["--n-model", "2", "--spatial", "--augment"],
                          ["--augment"]),
}
# each rank of the world runs every train of CLI_RUNS in turn, as
# torchrun would start it (the first joins the world, the rest are in it)
RANK_SCRIPT = """
import json, sys, torch
torch.set_num_threads(1)
from dl_image_segmentation_tpu_torch import cli
for argv in json.loads(sys.argv[1]):
    assert cli.main(argv) == 0
"""


def _cli_argv(shards, work, name, extra):
    tag = name.replace(" ", "_").replace("-", "")
    return CLI_TRAIN + ["--records", shards, "--metrics-log",
                        os.path.join(work, f"{tag}.jsonl"), "--checkpoint",
                        os.path.join(work, f"{tag}.pt")] + extra


def _losses(path):
    with open(path) as f:
        return [json.loads(line)["loss"] for line in f]


@pytest.fixture(scope="module")
def cli_world(tmp_path_factory):
    """CLI_RUNS in a 2-rank gloo world and in one process, on the same
    rgbarr shards: {name: (world metrics log, one-process metrics log,
    world checkpoint)}."""
    root = tmp_path_factory.mktemp("cli_world")
    shards = write_shards(str(root / "shards"), n_shards=3, per_shard=6)
    for who in ("world", "one"):
        (root / who).mkdir()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    argvs = [_cli_argv(shards, str(root / "world"), name, extra)
             for name, (extra, _) in CLI_RUNS.items()]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for rank in range(2):
        env = dict(os.environ, WORLD_SIZE="2", RANK=str(rank),
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_SCRIPT, json.dumps(argvs)],
            cwd=repo, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    for name, (_, extra) in CLI_RUNS.items():
        with pytest.MonkeyPatch.context() as mp:
            for v in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT",
                      "COORDINATOR_ADDRESS", "DLSEG_NUM_PROCESSES"):
                mp.delenv(v, raising=False)
            assert tcli.main(_cli_argv(shards, str(root / "one"), name,
                                       extra)) == 0
    out = {}
    for name in CLI_RUNS:
        tag = name.replace(" ", "_").replace("-", "")
        out[name] = (_losses(str(root / "world" / f"{tag}.jsonl")),
                     _losses(str(root / "one" / f"{tag}.jsonl")),
                     str(root / "world" / f"{tag}.pt"))
    return out


@pytest.mark.parametrize("name", list(CLI_RUNS))
def test_cli_train_in_a_world_equals_one_process(cli_world, name):
    """Every rank trains on its rows of the same global batches: the
    world's logged losses are the one-process run's, and its checkpoint
    (written once, by the primary) is three steps on."""
    world, one, ckpt = cli_world[name]
    assert len(one) >= 1 and len(world) == len(one)
    np.testing.assert_allclose(world, one, rtol=LOSS_RTOL)
    assert torch.load(ckpt, weights_only=True)["step"] == 3


def test_feed_order_does_not_depend_on_its_threads(tmp_path):
    """The ranks of a world read the same batches only if a feed's order
    is the records' whatever its parse threads do."""
    shards = write_shards(str(tmp_path), n_shards=3, per_shard=5, size=8)
    runs = []
    for workers in (1, 4, 4):
        feed = tinput.TFRecordFeed(shards, "rgbarr", 3, shuffle_buffer=4,
                                   num_workers=workers, repeat=False,
                                   drop_remainder=False, per_host=False)
        runs.append([b for b in feed.batches()])
    assert sum(len(x) for x, _ in runs[0]) == 15
    for other in runs[1:]:
        assert len(other) == len(runs[0])
        for (x, y), (x1, y1) in zip(runs[0], other):
            np.testing.assert_array_equal(x, x1)
            np.testing.assert_array_equal(y, y1)


# -- the rest: one process -----------------------------------------------

@pytest.mark.parametrize("fsdp", [False, True])
def test_world_of_one_is_bitwise_the_plain_trainer(tmp_path, fsdp):
    """A gloo world of one (``initialize`` from the environment, the mesh
    from ``Trainer(mesh=None)``) computes the plain trainer's bits."""
    import socket
    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cfg = TrainConfig(**dict(BASE, fsdp=fsdp))
    batches = seeded_batches(BASE, 2, 3)
    plain = Trainer(cfg, device="cpu")
    want = [plain.train_step(x, y)["loss"] for x, y in batches]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("COORDINATOR_ADDRESS", f"127.0.0.1:{port}")
        mp.setenv("DLSEG_NUM_PROCESSES", "1")
        mp.setenv("DLSEG_PROCESS_ID", "0")
        tdist.initialize(device="cpu")
    try:
        assert dist.is_initialized() and tdist.world_size() == 1
        tr = Trainer(cfg, device="cpu")
        assert tr.mesh.shape == {"data": 1, "model": 1}
        got = [tr.train_step(x, y)["loss"] for x, y in batches]
        tr.save_checkpoint(str(tmp_path / "w1.pt"))
    finally:
        dist.destroy_process_group()
    assert got == want
    for n, p in plain.state.params.items():
        assert torch.equal(tr.state.params[n], p), n


def test_initialize_is_a_no_op_for_one_process(monkeypatch):
    for v in ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS",
              "DLSEG_NUM_PROCESSES", "WORLD_SIZE", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(v, raising=False)
    tdist.initialize(device="cpu")
    assert not torch.distributed.is_initialized()
    assert tdist.rank() == 0 and tdist.world_size() == 1
    assert tdist.is_primary()
    monkeypatch.setenv("DLSEG_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="COORDINATOR_ADDRESS"):
        tdist.initialize(device="cpu")


def test_mesh_of_more_ranks_than_the_world_names_the_world():
    with pytest.raises(ValueError, match="needs a world of 4 processes"):
        tsharding.make_mesh(n_data=2, n_model=2, device="cpu")
    with pytest.raises(ValueError, match="needs a world of 2 processes"):
        Trainer(TrainConfig(**dict(BASE, n_model=2)), device="cpu")


@pytest.mark.parametrize("over", [
    dict(image_size=36, spatial=True),               # bands of 18 rows
    dict(model="deeplab", spatial=True),
    dict(base_features=128, quantize="int8"),        # int8 with TP
])
def test_what_this_slice_leaves_names_item_15(over):
    mesh = tsharding.Mesh(1, 2, "cpu")  # axis sizes only: no collective
    cfg = TrainConfig(**dict(BASE, n_model=2, **over))
    with pytest.raises(NotImplementedError, match="item 15"):
        Trainer(cfg, device="cpu", mesh=mesh)


def test_predict_server_refuses_a_world():
    class Fake:
        mesh = tsharding.Mesh(2, 1, "cpu")
        config = TrainConfig()
    with pytest.raises(NotImplementedError, match="item 15"):
        PredictServer(Fake())
