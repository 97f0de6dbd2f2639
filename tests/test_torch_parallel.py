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
  test), spatial 2x2, FSDP+TP 2x2, FSDP 4x1, SegFormer-lite TP 2x2 and
  the spatial regimes of every family on bands of any height
  (DeepLab-lite, whose ASPP reads rows far past a band; SegFormer-lite;
  the U-Net at 36 px, bands of 18, 9 and 5 / 4 rows), each 3 fp32
  steps with clipping at 1.0 on seeded batches whose first has one
  rank's rows all nodata, then evaluate, predict and a checkpoint. Each
  regime is held against the port's one-process trainer on the same
  batches from the same weights: the first step's synced and clipped
  gradients leaf by leaf (the difference's norm within 1e-2 of the
  leaf's plus 1e-6 of the whole gradient's) and its global norm before
  the clip (1e-5 relative), which Adam's scale-free update would not
  show; losses within 2e-5 relative (the JAX package's bound for a
  sharded step, tests/test_training.py:736), accuracy within one
  pixel's share, evaluate's loss within 1e-5 relative and its mIoU
  within one pixel's share, class maps equal wherever the top two
  probabilities are more than 1e-3 apart. The parameters after three
  steps differ by at most 2 * steps * lr. A witness, one process
  through torch's other CPU convs (the same sums in other orders), stays
  inside the same bars: the GroupNorms' backward leaves small gradients
  against their rounding, and Adam moves a parameter by about lr a step
  whatever its gradient's size, so rounding on a near-zero gradient
  moves it by up to lr. Checkpoints restore bitwise in the world (each
  rank its shards), in one process, and re-sharded (the FSDP 4x1 regime
  restores the FSDP+TP one's). The regimes of ``FROM_JAX`` start from a
  flax init and are held against the JAX ``Trainer``'s losses on a 2x2
  mesh of virtual devices, within 1e-4 relative (two conv
  implementations; Adam's first steps turn rounding into +-lr moves of
  near-zero gradients), as ``tests/data/make_world_losses.py`` wrote
  them (nothing compiles here; for spatial SegFormer-lite the JAX
  Trainer's one-device losses, which its spatial step does not
  reproduce). The one-process runs go in a thread while the world runs. The same world runs int8 inference: dynamic int8 under TP
  2x2 and FSDP 4x1, bitwise one process's logits, and calibrated
  int8-static on bands, within ``tests/test_torch_quant.py``'s bars.
  Its data plane deals global batches and decodes each rank's rows.
* The bands, in one process: convs of any kernel, stride and dilation,
  resizes, the upsample and space-to-depth, band by band from
  ``band_plan``'s rows, against the global ops.
* ``cli train`` in a 2-rank gloo world (torchrun's variables, ``--device
  cpu``): data parallel per step (each rank decoding its rows of the
  global batches), with ``--augment``, and from a ``--scan-steps``
  pool, and ``--n-model 2 --spatial --augment``, each logging the
  losses of a one-process ``train`` on the same records.
"""

import dataclasses
import functools
import json
import os
import re
import socket
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dl_image_segmentation_tpu.models import deeplab as jdeeplab
from dl_image_segmentation_tpu.models import segformer as jsegformer
from dl_image_segmentation_tpu.models import unet as junet
from dl_image_segmentation_tpu.parallel import sharding as jsharding
from dl_image_segmentation_tpu.pipeline import input as jinput
from dl_image_segmentation_tpu.records import writers as jwriters
from dl_image_segmentation_tpu_torch.models import convert as tconvert
from dl_image_segmentation_tpu_torch.models import layers as tlayers
from dl_image_segmentation_tpu_torch.models import unet as tunet
from dl_image_segmentation_tpu_torch.models.deeplab import DeepLabLite
from dl_image_segmentation_tpu_torch.models.segformer import SegFormerLite
from dl_image_segmentation_tpu_torch.models.unet import UNet
from dl_image_segmentation_tpu_torch.parallel import distributed as tdist
from dl_image_segmentation_tpu_torch.parallel import sharding as tsharding
from dl_image_segmentation_tpu_torch import cli as tcli
from dl_image_segmentation_tpu_torch.parallel.dryrun import (
    digests, dryrun_multichip, seeded_batches, write_shards)
from dl_image_segmentation_tpu_torch.parallel.spmd import Bands, band_split
from dl_image_segmentation_tpu_torch.pipeline import input as tinput
from dl_image_segmentation_tpu_torch.records import writers as twriters
from dl_image_segmentation_tpu_torch.serve import PredictServer
from dl_image_segmentation_tpu_torch.train import orbax as torbax
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
    # ASPP's rates of 6-18 read rows far past a band of 2 rows at 1/8
    "spatial_deeplab": dict(BASE, model="deeplab", n_model=2,
                            spatial=True),
    # bands of 12, 6, 3 and 2 rows: 6 / 6, 3 / 3, 2 / 1 and 1 / 1
    "spatial_segformer": dict(BASE, model="segformer", base_features=32,
                              image_size=48, n_model=2, spatial=True),
    # bands of 18 rows: 9 / 9, then 5 / 4 at the bottom
    "spatial_uneven": dict(BASE, image_size=36, n_model=2, spatial=True),
}
FROM_JAX = ("spatial", "fsdp_tp", "spatial_deeplab", "spatial_segformer",
            "spatial_uneven")
# inference only: int8 logits of the world against one process's
INT8 = {
    "int8_tp": dict(BASE, base_features=128, n_model=2, quantize="int8"),
    "int8_fsdp": dict(BASE, base_features=64, fsdp=True, quantize="int8"),
    "int8_spatial": dict(BASE, n_model=2, spatial=True,
                         quantize="int8-static"),
}
# the regimes whose world also serves: a PredictServer of the world over
# HTTP on the primary, the other ranks following it
SERVED = ("dp", "tp", "spatial", "int8_tp")
# the regimes whose world saves the orbax directory, not a .pt file
ORBAX = ("fsdp_tp", "segformer")
# the regimes whose one process is also run through torch's other CPU
# convs (the witness)
WITNESSED = ("dp", "tp", "spatial")
# tests/test_torch_quant.py's bars for int8 against another int8
QUANT_ATOL, QUANT_SAME = 5e-2, 0.995
LOSS_RTOL, JAX_RTOL = 2e-5, 1e-4
# the JAX Trainer's losses on a 2x2 mesh for FROM_JAX
# (tests/data/make_world_losses.py)
WORLD_LOSSES = os.path.join(os.path.dirname(__file__), "data",
                            "world_losses.npz")
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
    """The flax init of a regime's model, from a numpy seed."""
    cfg = CONFIGS[name]
    kw = dict(num_classes=cfg["num_classes"],
              base_features=cfg["base_features"], dtype=jnp.float32)
    family = cfg.get("model", "unet")
    if family == "deeplab":
        model = jdeeplab.DeepLabLite(**kw)
    elif family == "segformer":
        model = jsegformer.SegFormerLite(**kw)
    else:
        model = junet.UNet(levels=cfg["levels"], **kw)
    return seeded_tree(model, cfg["image_size"], seed=1)


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
    """The world's results, and each regime's batches and init."""
    work = str(tmp_path_factory.mktemp("world"))
    regimes, inits, batches = {}, {}, {}
    for name, cfg in CONFIGS.items():
        batches[name] = seeded_batches(cfg, 3, 0)
        inits[name] = jax_init(name) if name in FROM_JAX else None
        regimes[name] = {"n_model": cfg.get("n_model", 1), "config": cfg,
                         "batches": batches[name], "init": inits[name]}
    for name, cfg in INT8.items():
        regimes[name] = {"n_model": cfg.get("n_model", 1), "config": cfg,
                         "infer": True}
    regimes["tp"]["data_plane"] = True
    regimes["spatial"]["scanned"] = True
    regimes["fsdp"]["restore"] = "fsdp_tp"
    for name in SERVED:
        regimes[name]["serve"] = True
    # TP and FSDP+TP states written whole, as the orbax directory that one
    # process writes
    for name in ORBAX:
        regimes[name]["orbax"] = True

    def one_process_runs():
        # the references the tests hold the world to, here while the
        # spawned ranks run (a failure shows in the test that asks again)
        try:
            for name in CONFIGS:
                reference(name)
            for name in WITNESSED:
                reference(name, mkldnn=False)
            for name in INT8:
                int8_reference(name)
        except Exception:  # noqa: BLE001 -- recomputed by the test
            pass
    thread = threading.Thread(target=one_process_runs)
    thread.start()
    try:
        res = dryrun_multichip(4, "cpu", regimes, workdir=work)
    finally:
        thread.join()
    return {"res": res, "inits": inits, "batches": batches}


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


@pytest.mark.parametrize("name", WITNESSED)
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


@pytest.mark.parametrize("name", ORBAX)
def test_world_orbax_checkpoint_is_the_whole_state(world, name):
    """A TP (SegFormer-lite) or FSDP+TP world's orbax checkpoint, gathered on every rank
    and written by the primary, is bitwise the tree that one process
    writes of the same state (restored here from it), and orbax itself
    restores it bitwise."""
    import orbax.checkpoint as ocp
    path = world["res"][name]["checkpoint"]
    assert torbax.is_checkpoint(path)
    tr = one_process(name)
    tr.restore_checkpoint(path)
    want = flat_tree(tr.orbax_tree())
    for got in (torbax.read_checkpoint(path),
                ocp.StandardCheckpointer().restore(path)):
        got = flat_tree(jax.tree_util.tree_map(np.asarray, got))
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and got[k].tobytes() == \
                v.tobytes(), k


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


def test_data_plane_decodes_only_each_ranks_rows(world):
    """The TP 2x2 world's feed deals global batches of 8 and each rank
    decodes its data rank's 4 rows of them, prefetched batches too."""
    for r, k in enumerate(world["res"]["tp"]["ranks"]):
        d = r // 2
        assert tuple(k["feed_rows"]) == (4 * d, 4 * d + 4)
        assert k["feed_decoded"] >= 8 and k["feed_decoded"] % 4 == 0


@pytest.mark.parametrize("n", [2, 3])
def test_feed_rows_are_the_global_batches_rows(tmp_path, n):
    """A feed with ``rows`` deals the encoded records as the global feed
    batches its parsed ones (same shuffle, same order) and decodes only
    its rows: the ranks' batches, stacked, are the global batches, and
    each rank decodes its share of the records."""
    shards = write_shards(str(tmp_path), n_shards=3, per_shard=8, size=8)
    b = 6

    def batches(rows=None):
        feed = tinput.TFRecordFeed(shards, "rgbarr", b, shuffle_buffer=5,
                                   num_workers=2, repeat=False,
                                   per_host=False, rows=rows)
        return list(feed.batches()), feed.records_read
    whole, read = batches()
    assert len(whole) == 4 and read == 24
    parts = []
    for r in range(n):
        rows = (r * b // n, (r + 1) * b // n)
        got, read = batches(rows)
        assert read == 4 * (rows[1] - rows[0])
        parts.append(got)
    for i, (x, y) in enumerate(whole):
        np.testing.assert_array_equal(
            x, np.concatenate([p[i][0] for p in parts]))
        np.testing.assert_array_equal(
            y, np.concatenate([p[i][1] for p in parts]))


def test_feed_rows_refuse_a_record_they_cannot_skip(tmp_path):
    """A record of this rank's rows that does not parse raises where the
    whole-batch feed skips it: the other ranks cannot know to skip it."""
    from dl_image_segmentation_tpu_torch.records.tfrecord import \
        TFRecordWriter
    write_shards(str(tmp_path), n_shards=1, per_shard=6, size=8)
    w = TFRecordWriter(str(tmp_path / "dry-00001-of-00001"))
    w.write(b"not an example")
    w.close()
    kw = dict(shuffle_buffer=1, num_workers=1, repeat=False,
              per_host=False, drop_remainder=False)
    whole = tinput.TFRecordFeed(str(tmp_path / "dry-*"), "rgbarr", 7, **kw)
    assert [len(x) for x, _ in whole.batches()] == [6]
    rows = tinput.TFRecordFeed(str(tmp_path / "dry-*"), "rgbarr", 7,
                               rows=(0, 7), **kw)
    with pytest.raises(RuntimeError, match="cannot skip it"):
        list(rows.batches())


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
    """The world's losses against the JAX Trainer's on a 2x2 mesh of
    virtual devices, from the same init and batches, as
    ``tests/data/make_world_losses.py`` wrote them."""
    with np.load(WORLD_LOSSES) as f:
        assert json.loads(str(f[f"{name}.config"])) == CONFIGS[name]
        want = f[name]
    np.testing.assert_allclose(world["res"][name]["losses"], want,
                               rtol=JAX_RTOL)


@functools.lru_cache(maxsize=None)
def int8_reference(name):
    """One process's int8 logits of a regime's eval images (int8-static
    calibrated on its first batch, as the world calibrates)."""
    cfg = dataclasses.replace(TrainConfig(**INT8[name]), n_model=1,
                              spatial=False, fsdp=False)
    tr = Trainer(cfg, device="cpu")
    batches = seeded_batches(INT8[name], 3, 0)
    tr.calibrate([batches[0]], max_batches=1)
    logits = torch.cat(list(tr._chunked_logits(batches[-1][0])))
    return logits.numpy(), tr.quant_vars


@pytest.mark.parametrize("name", ["int8_tp", "int8_fsdp"])
def test_world_int8_logits_are_bitwise_one_process(world, name):
    """A column-parallel int8 conv quantizes its own output channels'
    kernels (a scale per output channel), and FSDP gathers the float
    kernel before it quantizes: every int8 sum and rescale is the one
    process's."""
    got = world["res"][name]
    want, _ = int8_reference(name)
    assert got["mesh"] == {"data": 4 // INT8[name].get("n_model", 1),
                           "model": INT8[name].get("n_model", 1)}
    np.testing.assert_array_equal(got["logits"], want)


def test_world_int8_static_on_bands_within_the_quant_bars(world):
    """Static int8 on bands: each conv's calibrated max-abs and each
    forward's activations are the maximum over the bands; the GroupNorms
    sum over the bands in another order, so the logits are held to
    tests/test_torch_quant.py's bars for two int8 runs."""
    got = world["res"]["int8_spatial"]
    want, quant = int8_reference("int8_spatial")
    scale = np.abs(want).max()
    assert np.abs(got["logits"] - want).max() <= QUANT_ATOL * scale
    assert (got["logits"].argmax(-1) == want.argmax(-1)).mean() >= \
        QUANT_SAME
    flat = jax.tree_util.tree_leaves(got["quant_vars"])
    ref = jax.tree_util.tree_leaves(quant)
    assert len(flat) == len(ref) > 0
    np.testing.assert_allclose(flat, ref, rtol=1e-5)


# -- cli train in a world -----------------------------------------------

CLI_TRAIN = ["train", "--mode", "rgbarr", "--classes", "2", "--channels",
             "3", "--features", "8", "--levels", "2", "--image-size", "32",
             "--batch-size", "4", "--steps", "3", "--log-every", "1",
             "--precision", "fp32", "--workers", "2", "--device", "cpu"]
# name: (the world's extra arguments, the one process's)
CLI_RUNS = {
    "dp": ([], []),
    # each rank decodes its rows and takes its rows of the global draws
    "dp --augment": (["--augment"], ["--augment"]),
    "dp --scan-steps": (["--scan-steps", "3", "--pool-size", "8"],) * 2,
    "spatial --augment": (["--n-model", "2", "--spatial", "--augment"],
                          ["--augment"]),
    # --checkpoint without .pt: the orbax directory the JAX CLI writes,
    # gathered from the world and written by the primary
    "dp orbax": ([], []),
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


def _ckpt_name(name):
    tag = name.replace(" ", "_").replace("-", "")
    return tag if name.endswith("orbax") else f"{tag}.pt"


def _cli_argv(shards, work, name, extra):
    tag = name.replace(" ", "_").replace("-", "")
    return CLI_TRAIN + ["--records", shards, "--metrics-log",
                        os.path.join(work, f"{tag}.jsonl"), "--checkpoint",
                        os.path.join(work, _ckpt_name(name))] + extra


def flat_tree(tree, prefix=""):
    """{"a/0/mu/...": array} of a tree of the orbax reader; None leaves
    are left out."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {} if tree is None else {prefix.rstrip("/"): np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(flat_tree(v, f"{prefix}{k}/"))
    return out


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
                     str(root / "world" / _ckpt_name(name)),
                     str(root / "one" / _ckpt_name(name)))
    return out


@pytest.mark.parametrize("name", list(CLI_RUNS))
def test_cli_train_in_a_world_equals_one_process(cli_world, name):
    """Every rank trains on its rows of the same global batches: the
    world's logged losses are the one-process run's, and its checkpoint
    (written once, by the primary) is three steps on."""
    world, one, ckpt, _ = cli_world[name]
    assert len(one) >= 1 and len(world) == len(one)
    np.testing.assert_allclose(world, one, rtol=LOSS_RTOL)
    if ckpt.endswith(".pt"):
        assert torch.load(ckpt, weights_only=True)["step"] == 3
    else:
        assert int(torbax.read_checkpoint(ckpt)["step"]) == 3


def test_cli_world_writes_the_orbax_checkpoint_one_process_writes(
        cli_world):
    """train --checkpoint DIR in a world: every rank gathers the state,
    the primary writes the orbax directory. It is the world's own state
    whole: restored, it is bitwise the state the same world saved as
    .pt (the "dp" run, the same steps). It holds the one-process run's
    tree (the same keys, dtypes and shapes, the step and count bitwise),
    its parameters and Adam moments within 1e-4 of each leaf's largest
    magnitude of the one process's: the world sums two half-batch
    gradients, which rounds otherwise (measured: at most 2.4e-5 of a
    leaf's largest magnitude, a bias's nu; three untrained steps would
    leave the weights some 3e-3 of theirs and the moments all of
    theirs)."""
    _, _, world, one = cli_world["dp orbax"]
    got, want = torbax.read_checkpoint(world), torbax.read_checkpoint(one)
    tr = Trainer(TrainConfig(num_classes=2, in_channels=3, base_features=8,
                             levels=2, image_size=32, batch_size=4,
                             precision="fp32"), device="cpu")
    tr.restore_checkpoint(world)
    mine = tr._payload()
    saved = torch.load(cli_world["dp"][2], weights_only=True)
    assert mine["step"] == saved["step"] == 3
    assert mine["opt_state"]["count"] == saved["opt_state"]["count"]
    for key, tree in (("params", mine["params"]),
                      ("mu", mine["opt_state"]["mu"]),
                      ("nu", mine["opt_state"]["nu"])):
        ref = saved[key] if key == "params" else saved["opt_state"][key]
        assert sorted(tree) == sorted(ref) and tree
        for n, v in tree.items():
            assert torch.equal(v, ref[n]), (key, n)
    fg, fw = flat_tree(got), flat_tree(want)
    assert sorted(fg) == sorted(fw) and len(fg) > 10
    for k in fw:
        assert fg[k].dtype == fw[k].dtype and fg[k].shape == fw[k].shape, k
    assert int(got["step"]) == int(want["step"]) == 3
    floats = 0
    for k in fw:
        if fw[k].dtype.kind == "f":
            floats += 1
            gap = float(np.abs(fg[k] - fw[k]).max())
            assert gap <= 1e-4 * float(np.abs(fw[k]).max()), (k, gap)
        else:
            np.testing.assert_array_equal(fg[k], fw[k], err_msg=k)
    # the parameters, mu and nu of every parameter
    assert floats >= 3 * len(mine["params"])


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

class SimulatedBands(Bands):
    """The bands of a whole tensor ``full`` over ``n`` ranks, seen from
    ``rank`` in one process: a fetch reads the rows from ``full`` (zeros
    beyond its top and bottom) where the world asks their owners."""

    def __init__(self, n, rank, full):
        self.n, self.rank, self.full, self.group = n, rank, full, None

    def rows(self, x):
        return self.full.shape[2]

    def _fetch(self, x, h, needs):
        lo, hi = needs[self.rank]
        t = self.full
        a, b = max(lo, 0), max(min(hi, h), 0)
        assert torch.equal(x, t[:, :, slice(*band_split(h, self.n,
                                                        self.rank))])
        zeros = [t.new_zeros(t.shape[:2] + (k, t.shape[3]))
                 for k in (max(0, -lo), max(0, hi - max(lo, h)))]
        return torch.cat([zeros[0], t[:, :, a:b], zeros[1]], 2)


def banded(full, n, op):
    """``op(bands, band)`` on every rank's band of ``full``, the outputs
    concatenated in rank order."""
    outs = []
    for r in range(n):
        rows = slice(*band_split(full.shape[2], n, r))
        outs.append(op(SimulatedBands(n, r, full),
                       full[:, :, rows].contiguous()))
    return torch.cat(outs, 2)


SWEEP_HEIGHTS = (1, 2, 5, 9, 16, 18, 33)


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("kernel", [1, 2, 3, 7])
def test_band_plan_convs_equal_the_global_conv(n, kernel):
    """A SAME conv of any stride and dilation, computed band by band from
    ``band_plan``'s rows (halos wider than a band, bands of no rows), is
    the global conv within 1e-6 of its largest magnitude at fp32."""
    g = torch.Generator().manual_seed(n * 10 + kernel)
    for h in SWEEP_HEIGHTS:
        for s in (1, 2, 4):
            for d in ((1,) if kernel == 1 else (1, 6, 18)):
                x = torch.randn(2, 3, h, 7, generator=g)
                w = torch.randn(4, 3, kernel, kernel, generator=g)
                want = F.conv2d(tlayers.pad_same(x, kernel, s, d), w,
                                stride=s, dilation=d)
                got = banded(x, n, lambda bands, xb: bands.conv(
                    xb, lambda xr: F.conv2d(
                        tlayers.pad_width(xr, kernel, s, d), w, stride=s,
                        dilation=d), kernel, s, d))
                assert got.shape == want.shape, (h, s, d)
                err = float((got - want).abs().max())
                assert err <= 1e-6 * float(want.abs().max()), (h, s, d)


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_band_resizes_equal_the_global_resize_bitwise(n, dtype):
    """``resize_bilinear`` of a banded tensor (each band's output rows
    from the rows their weights reach) is the global resize bit for
    bit, up and down."""
    g = torch.Generator().manual_seed(n)
    for h in (1, 2, 3, 5, 8, 9, 16, 33):
        for ho in (1, 2, 4, 7, 16, 18, 36, 66):
            x = torch.randn(2, 3, h, 5, generator=g).to(dtype)
            want = tlayers.resize_bilinear(x, ho, 9)
            got = banded(x, n, lambda bands, xb: tlayers.resize_bilinear(
                xb, ho, 9, bands))
            assert torch.equal(got, want), (h, ho)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_band_upsample_and_space_to_depth_equal_the_global(n):
    """The U-Net's upsample cropped to its skip's height, its
    space-to-depth stem and its sub-pixel head, band by band, are the
    global ops bit for bit."""
    g = torch.Generator().manual_seed(n)
    for h in (1, 2, 3, 5, 9, 18):
        x = torch.randn(2, 4, h, 3, generator=g)
        for rows in (2 * h - 1, 2 * h):
            want = tunet.depth_to_space(x, 2)[:, :, :rows]
            got = banded(x, n, lambda bands, xb: bands.up(
                xb, lambda t: tunet.depth_to_space(t, 2), 2, rows))
            assert torch.equal(got, want), (h, rows)
        x = torch.randn(2, 3, 2 * h, 4, generator=g)
        want = tunet.space_to_depth(x, 2)
        got = banded(x, n, lambda bands, xb: bands.space_to_depth(
            xb, 2, lambda t: tunet.space_to_depth(t, 2)))
        assert torch.equal(got, want), h



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
    """The configurations that item 15 once refused build on a mesh's
    axis sizes (no collective): a spatial model keeps every parameter
    whole and names the layers it runs on bands; the int8 twin of a TP
    model computes on the float model's shards through wrappers of its
    own."""
    mesh = tsharding.Mesh(1, 2, "cpu")  # axis sizes only: no collective
    cfg = TrainConfig(**dict(BASE, n_model=2, **over))
    tr = Trainer(cfg, device="cpu", mesh=mesh)
    sharded = {n for n, sh in tr.shardings.items()
               if not sh.is_fully_replicated}
    if cfg.spatial:
        assert tr._spatial and not sharded
        layers = list(tr.model.spatial_layers())
        kinds = {type(m).__name__ for m in layers}
        assert {"Conv2d", "GroupNorm"} <= kinds
        if cfg.model == "deeplab":
            # the image-level branch sees the mean of the whole image
            assert not any(m is tr.model.aspp.pooled.conv for m in layers)
        else:
            assert "ConvTranspose2d" in kinds
        return
    assert sharded
    params = dict(tr.model.named_parameters())
    twin = dict(tr.infer_model.named_modules())
    for name in sharded:
        mod_name = name.rpartition(".")[0]
        assert "spmd" in twin[mod_name].__dict__, name
        full = dict(tr._template.named_parameters())[name]
        assert params[name].shape[0] * 2 == full.shape[0] or \
            params[name].shape[1] * 2 == full.shape[1]
    for name, p in tr.infer_model.named_parameters():
        assert p is params[name]


class _Recorder:
    """A trainer on a mesh of (2, 1) axis sizes (no collective) whose
    ``predict_both`` records its batches; stands in for ``_broadcast``
    too, feeding a follower the headers in ``script``."""

    def __init__(self, script=()):
        self.mesh = tsharding.Mesh(2, 1, "cpu")
        self.config = TrainConfig(**dict(BASE, batch_size=2))
        self.device = torch.device("cpu")
        self.script = list(script)
        self.sent, self.batches = [], []

    def predict_both(self, images):
        self.batches.append(images)
        n = len(images)
        return (np.zeros((n, 32, 32), np.int32),
                np.zeros((n, 32, 32, 3), np.float32))

    def broadcast(self, tensor):
        self.sent.append(tensor.clone())
        if self.script:
            tensor.copy_(self.script.pop(0))


def test_world_server_binds_on_the_primary_only(monkeypatch):
    """A PredictServer of a world builds without a collective; the
    primary binds the HTTP front and its close() broadcasts the stop; a
    follower refuses to bind or take requests, and follow() enters each
    dispatch the primary announces (after heartbeats) until the stop
    (replaces test_predict_server_refuses_a_world: the server no longer
    refuses a mesh of more than one rank)."""
    from dl_image_segmentation_tpu_torch import serve as tserve
    from dl_image_segmentation_tpu_torch.serve import make_http_server
    tr = _Recorder()
    monkeypatch.setattr(tserve, "_broadcast", tr.broadcast)
    monkeypatch.setattr(tserve, "HEARTBEAT_S", 60.0)
    ps = PredictServer(tr)
    assert ps.world and ps.primary and tr.sent == []
    httpd = make_http_server("127.0.0.1", 0, ps)
    assert httpd.server_address[1] > 0
    httpd.server_close()
    bad = ps.submit(np.zeros((16, 16, 3), np.float32), probs=False)
    assert bad.status == 400 and tr.sent == []
    ps.close()
    assert [int(t[0]) for t in tr.sent] == [tserve._STOP]
    assert ps.wait_stopped(0) and ps.error is None

    # a uint8 batch travels as its bytes and reaches predict_both as uint8
    chip = np.random.RandomState(0).randint(0, 256, (2, 32, 32, 3)).astype(
        np.uint8)
    script = [torch.tensor([tserve._HEARTBEAT, 0]),
              torch.tensor([tserve._DISPATCH,
                            tserve._DTYPES.index(np.dtype(np.uint8))]),
              torch.from_numpy(chip.reshape(-1)),
              torch.tensor([tserve._STOP, 0])]
    tr = _Recorder(script)
    monkeypatch.setattr(tserve, "_broadcast", tr.broadcast)
    monkeypatch.setattr(tdist, "rank", lambda: 1)
    ps = PredictServer(tr)
    assert ps.world and not ps.primary and ps._worker is None
    with pytest.raises(RuntimeError, match="only the primary"):
        make_http_server("127.0.0.1", 0, ps)
    with pytest.raises(RuntimeError, match="follower"):
        ps.enqueue(chip[0], probs=False)
    ps.follow()
    assert len(tr.sent) == 4 and not tr.script
    assert len(tr.batches) == 1 and tr.batches[0].dtype == np.uint8
    np.testing.assert_array_equal(tr.batches[0], chip)
    ps.close()


@pytest.mark.parametrize("backend,want", [("gloo", "cpu"),
                                          ("nccl", "cuda:0")])
def test_broadcast_device_follows_the_backend(monkeypatch, backend, want):
    """gloo broadcasts CPU tensors, also for ranks that share a card;
    NCCL broadcasts the rank's CUDA tensors."""
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_backend",
                        lambda *a: backend)
    assert tdist.collective_device("cuda:0") == torch.device(want)


@pytest.mark.parametrize("name", SERVED)
def test_world_server_answers_as_the_worlds_predict(world, name):
    """The world's PredictServer behind make_http_server on the primary,
    the other ranks following: a full batch of requests at once, a
    partial batch, probability requests, and a uint8 and a uint16 chip
    (submitted through the library, which keeps their dtype) answer
    bitwise the world's own predict / predict_probs of the same images."""
    got = world["res"][name]["serve"]
    bs = (CONFIGS.get(name) or INT8[name])["batch_size"]
    assert got["maps"].shape == got["predict"].shape == (bs, 32, 32)
    np.testing.assert_array_equal(got["maps"], got["predict"])
    k = len(got["partial"])
    assert 0 < k < bs
    np.testing.assert_array_equal(got["partial"], got["predict"][:k])
    np.testing.assert_array_equal(got["probs"], got["predict_probs"][:2])
    # a uint8 and a uint16 chip, each its own dispatch in its own dtype
    assert len(got["typed"]) == len(got["predict_typed"]) == 2
    for served, want in zip(got["typed"], got["predict_typed"]):
        np.testing.assert_array_equal(served, want)
    assert got["dispatches"] >= 5


# -- the world's server: failures, calibration, cli serve ----------------

# a 2-rank gloo world with a group timeout of a few seconds, each rank
# started as torchrun would start it
GROUP_TIMEOUT_S = 3
WORLD_PREAMBLE = """
import datetime, json, os, sys, time
import numpy as np, torch
import torch.distributed as dist
torch.set_num_threads(1)
dist.init_process_group(
    "gloo", init_method="tcp://127.0.0.1:" + os.environ["MASTER_PORT"],
    world_size=2, rank=int(os.environ["RANK"]),
    timeout=datetime.timedelta(seconds=float(os.environ["GROUP_TIMEOUT"])))
rank = dist.get_rank()
"""
# int8-static calibrates on the first batch it serves, the same on every
# rank; then a dispatch that raises on the follower breaks the world
SERVER_SCRIPT = WORLD_PREAMBLE + """
from dl_image_segmentation_tpu_torch.serve import PredictServer
from dl_image_segmentation_tpu_torch.train import orbax as torbax
from dl_image_segmentation_tpu_torch.train.trainer import (TrainConfig,
                                                           Trainer)
out = {}
cfg = TrainConfig(**json.loads(sys.argv[1]))
chip = np.random.RandomState(0).rand(32, 32, 3).astype(np.float32)
tr = Trainer(TrainConfig(**dict(cfg.__dict__, quantize="int8-static")),
             device="cpu")
ps = PredictServer(tr)
if ps.primary:
    p = ps.submit(chip, probs=False)
    out["served"] = p.result.tolist()
    ps.close()
else:
    ps.follow()
out["act_amax"] = [float(m.act_amax) for m in tr.infer_model.modules()
                   if hasattr(m, "act_amax")]
tr = Trainer(cfg, device="cpu")
if rank == 1:
    def broken(images):
        raise RuntimeError("a dispatch failed on the follower")
    tr.predict_both = broken
ps = PredictServer(tr)
t0 = time.perf_counter()
if ps.primary:
    p = ps.submit(chip, probs=False, timeout=60)
    out["status"], out["error"] = p.status, p.error
    out["stopped"] = ps.wait_stopped(60)
    out["broken"] = repr(ps.error)
    late = ps.submit(chip, probs=False)
    out["late"] = [late.status, late.error]
else:
    try:
        ps.follow()
        out["raised"] = None
    except RuntimeError as e:
        out["raised"] = str(e)
out["seconds"] = time.perf_counter() - t0
with open(os.environ["OUT"], "w") as f:
    json.dump(out, f)
os._exit(0)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _two_ranks(argv, tmp, **env_extra):
    """Start the 2 ranks of ``argv`` (a script or a module's argv after
    the interpreter); returns the processes."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, WORLD_SIZE="2", RANK=str(rank),
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   GROUP_TIMEOUT=str(GROUP_TIMEOUT_S),
                   OUT=os.path.join(tmp, f"rank{rank}.json"), **env_extra)
        procs.append(subprocess.Popen(
            [sys.executable, *argv], cwd=repo, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def test_world_server_fails_every_rank_and_calibrates_alike(tmp_path):
    """int8-static calibrates on the first served batch, broadcast to
    every rank: the same activation scales on both ranks, and the map of
    one process calibrated on that padded batch. Then a dispatch that
    raises on the follower: its follow() raises, the primary fails the
    request (500) and every later one (503), and both ranks are done
    well within the group's timeout (no rank waits for another)."""
    cfg = dict(BASE, batch_size=2)
    procs = _two_ranks(["-c", SERVER_SCRIPT, json.dumps(cfg)],
                       str(tmp_path))
    try:
        logs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, logs):
        assert p.returncode == 0, err[-3000:]
    ranks = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(2)]
    one = Trainer(TrainConfig(**dict(cfg, quantize="int8-static")),
                  device="cpu")
    chip = np.random.RandomState(0).rand(32, 32, 3).astype(np.float32)
    want = one.predict(np.stack([chip, np.zeros_like(chip)]))[0]
    amax = [float(m.act_amax) for m in one.infer_model.modules()
            if hasattr(m, "act_amax")]
    assert len(amax) > 0
    assert ranks[0]["act_amax"] == ranks[1]["act_amax"] == amax
    np.testing.assert_array_equal(np.array(ranks[0]["served"]), want)
    primary, follower = ranks
    assert follower["raised"] == "a dispatch failed on the follower"
    assert primary["status"] == 500 and primary["error"]
    assert primary["stopped"] and primary["broken"] != "None"
    assert primary["late"][0] == 503
    assert max(primary["seconds"], follower["seconds"]) < \
        2 * GROUP_TIMEOUT_S + 10


CLI_SERVE = WORLD_PREAMBLE + """
from dl_image_segmentation_tpu_torch import cli
sys.exit(cli.main(sys.argv[1:]))
"""


def test_cli_serve_in_a_world_outlives_the_group_timeout(tmp_path):
    """cli serve in a 2-rank gloo world whose group times out after a few
    seconds: the primary alone binds the port and prints; idle for twice
    the timeout (heartbeats keep the follower's broadcast short), it
    answers chips and probabilities as one process's predict from the
    same (orbax) checkpoint; SIGINT to both ranks, as torchrun forwards
    it, ends both with exit code 0."""
    import signal
    import urllib.request
    from dl_image_segmentation_tpu_torch.parallel.dryrun import _concurrent
    cfg = dict(BASE, batch_size=4)
    one = Trainer(TrainConfig(**cfg), device="cpu")
    ckpt = str(tmp_path / "ckpt")
    one.save_checkpoint(ckpt)
    model = ["--classes", "3", "--features", "16", "--levels", "2",
             "--image-size", "32", "--batch-size", "4", "--precision",
             "fp32", "--device", "cpu"]
    procs = _two_ranks(["-c", CLI_SERVE, "serve", "--checkpoint", ckpt,
                        "--port", "0", "--max-wait-ms", "50", *model],
                       str(tmp_path))
    try:
        line = procs[0].stdout.readline()
        base = re.search(r"(http://\S+)", line).group(1)
        time.sleep(2 * GROUP_TIMEOUT_S)
        opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
        with opener.open(base + "/healthz", timeout=60) as r:
            assert json.loads(r.read())["ok"]
        chips = list(np.random.RandomState(3).rand(5, 32, 32, 3).astype(
            np.float32))
        maps, _, _ = _concurrent(base, chips, False)
        probs, _, _ = _concurrent(base, chips[:2], True)
    finally:
        for p in procs:
            p.send_signal(signal.SIGINT)
        outs = [p.communicate(timeout=60) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    assert outs[1][0] == ""  # the follower printed nothing, bound nothing
    np.testing.assert_array_equal(np.stack(maps), one.predict(np.stack(chips)))
    np.testing.assert_array_equal(np.stack(probs),
                                  one.predict_probs(np.stack(chips[:2])))
