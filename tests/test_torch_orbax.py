"""The JAX package's orbax checkpoints in the port, on the CPU:
``train/orbax.py`` (the reader and the writer, on the port's own zstd
decoder and CRC32C) against ``orbax.checkpoint`` and the JAX ``Trainer``.

* Reader: every leaf of a checkpoint that the JAX ``Trainer`` wrote
  equals orbax's own restore and the JAX state, bitwise; with and
  without ``grad_clip_norm``, with a constant, linear or cosine
  schedule; single checkpoints and a ``CheckpointManager`` directory
  after rotation; local, gs:// and s3:// (the port's loopback fakes);
  an array written sharded over a 4 x 2 CPU mesh (a chunk grid).
* Trainer: ``restore_checkpoint`` of such a checkpoint holds the params,
  Adam's moments, the count and the step bitwise; it predicts the maps
  of ``params_from_flax`` of the same tree, bitwise, and its next step
  equals that of a trainer given the same state through
  ``load_optax_state``, bitwise; ``restore_latest`` resumes a managed
  orbax directory; an s2d AUTO trainer migrates to an orbax tree of the
  classic U-Net.
* Writer: orbax restores ``write_checkpoint``'s output bitwise, single
  and managed, and the JAX ``Trainer.restore_checkpoint`` and
  ``restore_latest`` take it.
* The committed fixture (``tests/data/orbax_unet``, written by
  :func:`write_fixture` from a JAX ``Trainer``): orbax and the port
  restore it to its ``.npz`` bitwise, and the port predicts its maps
  where the top two logits are more than 1e-4 apart.

The JAX ``Trainer``s are built on a one-device mesh with their init and
step monkeypatched away, so nothing here compiles a step.
"""

import json
import os
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from dl_image_segmentation_tpu.parallel.sharding import (make_mesh,
                                                         replicated_sharding)
from dl_image_segmentation_tpu.train import trainer as jtrainer
from dl_image_segmentation_tpu_torch import storage as tst
from dl_image_segmentation_tpu_torch.models import convert as tconvert
from dl_image_segmentation_tpu_torch.train import orbax as torbax
from dl_image_segmentation_tpu_torch.train import trainer as ttrainer

from tests.test_torch_models import flax_params
from tests.test_torch_storage import serving

# one intra-op thread: the test workers share the host's cores
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "data", "orbax_unet")
CFG = dict(num_classes=3, base_features=8, levels=2, image_size=32,
           batch_size=2, precision="fp32")
VARIANTS = {
    "clip-cosine": dict(grad_clip_norm=0.5, schedule="cosine",
                        warmup_steps=2, total_steps=50),
    "constant": {},
    "clip-linear": dict(grad_clip_norm=1.0, warmup_steps=3),
}


def flat(tree, prefix=""):
    """{"a/0/mu/...": array} of a JAX state or of the reader's tree:
    NamedTuples by field, tuples by index; empty states are left out."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat(v, f"{prefix}{i}/"))
        return out
    if tree is None:
        return {}
    return {prefix.rstrip("/"): np.asarray(tree)}


def state_dict(state):
    return {"params": state.params, "opt_state": state.opt_state,
            "step": state.step}


def assert_same(a, b):
    fa, fb = flat(a), flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        assert fa[k].tobytes() == fb[k].tobytes(), k


def jax_trainer(variant, params, seed=0, step=7, monkeypatch=None, **cfg):
    """A JAX Trainer on one device holding ``params``, Adam moments
    drawn from ``seed``, counts of 5 and ``step``; no compile."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer.Trainer, "_init_state", lambda self: None)
        mp.setattr(jtrainer.Trainer, "_build_step", lambda self: None)
        t = jtrainer.Trainer(
            jtrainer.TrainConfig(**{**CFG, **VARIANTS[variant], **cfg}),
            mesh=make_mesh(devices=jax.devices()[:1]))
    rng = np.random.default_rng(seed)
    p = jax.tree_util.tree_map(jnp.asarray, params)

    def fill(x):
        if jnp.issubdtype(x.dtype, jnp.integer):
            return jnp.full_like(x, 5)
        return jnp.asarray(rng.random(x.shape, dtype=np.float32) * 1e-3)
    opt = jax.tree_util.tree_map(fill, t.tx.init(p))
    t.state = jax.device_put(
        jtrainer.TrainState(p, opt, jnp.asarray(step, jnp.int32)),
        replicated_sharding(t.mesh))
    return t


def port_trainer(variant, **cfg):
    return ttrainer.Trainer(
        ttrainer.TrainConfig(**{**CFG, **VARIANTS[variant], **cfg}),
        device="cpu")


def host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def images(n=2, size=32, seed=5):
    return np.random.RandomState(seed).randint(
        0, 256, (n, size, size, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def params():
    return flax_params()[1]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_reader_equals_orbax_and_the_jax_state(variant, params, tmp_path):
    jt = jax_trainer(variant, params)
    path = str(tmp_path / "ck")
    jt.save_checkpoint(path)
    assert os.path.isdir(os.path.join(path, "ocdbt.process_0"))
    mine = torbax.read_checkpoint(path)
    assert_same(mine, host(state_dict(jt.state)))
    assert_same(mine, host(ocp.StandardCheckpointer().restore(path)))
    # optax's empty states are None, its NamedTuples dicts
    opt = mine["opt_state"]
    if "clip" in variant:
        assert opt[0] is None
        opt = opt[1]
    assert set(opt[0]) == {"count", "mu", "nu"} and opt[1] is None
    assert (opt[2] is None) == (variant == "constant")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_trainer_restores_predicts_and_steps_as_the_jax_tree(
        variant, params, tmp_path):
    jt = jax_trainer(variant, params)
    path = str(tmp_path / "ck")
    jt.save_checkpoint(path)
    t = port_trainer(variant)
    t.restore_checkpoint(path)
    want = port_trainer(variant).load_flax_params(params)
    want.load_optax_state(host(jt.state.opt_state), step=7)
    assert t.state.step == 7 and t.state.opt_state.count == 5
    for name in ("params", "mu", "nu"):
        got = t.state.params if name == "params" else \
            getattr(t.state.opt_state, name)
        ref = want.state.params if name == "params" else \
            getattr(want.state.opt_state, name)
        for n in ref:
            assert torch.equal(got[n], ref[n]), (name, n)
    x = images()
    np.testing.assert_array_equal(t.predict(x), want.predict(x))
    y = np.random.RandomState(1).randint(0, 3, (2, 32, 32)).astype(np.int32)
    assert t.train_step(x, y) == want.train_step(x, y)
    for n, p in want.state.params.items():
        assert torch.equal(t.state.params[n], p), n


def test_directory_without_metadata_raises(tmp_path):
    t = port_trainer("constant")
    with pytest.raises(ValueError, match="without an orbax checkpoint"):
        t.restore_checkpoint(str(tmp_path))
    (tmp_path / "_METADATA").write_text("{}")
    with pytest.raises(torbax.OrbaxFormatError):
        t.restore_checkpoint(str(tmp_path))


def test_corrupt_store_raises(params, tmp_path):
    jt = jax_trainer("constant", params)
    path = str(tmp_path / "ck")
    jt.save_checkpoint(path)
    man = os.path.join(path, "manifest.ocdbt")
    raw = bytearray(open(man, "rb").read())
    raw[20] ^= 4
    open(man, "wb").write(bytes(raw))
    with pytest.raises(torbax.OrbaxFormatError, match="CRC32C"):
        torbax.read_checkpoint(path)


def _save_managed(jt, directory, steps, keep=2):
    mgr = jt.checkpoint_manager(directory, keep=keep)
    states = {}
    for s in steps:
        jt.state = jtrainer.TrainState(
            jax.tree_util.tree_map(lambda x: x + 1.0, jt.state.params),
            jt.state.opt_state, jnp.asarray(s, jnp.int32))
        jt.save_managed(mgr)
        states[s] = host(state_dict(jt.state))
    mgr.close()
    return states


def test_managed_directory_after_rotation(params, tmp_path):
    jt = jax_trainer("clip-cosine", params)
    d = str(tmp_path / "run")
    states = _save_managed(jt, d, (1, 2, 3))
    # orbax's temporary directory and a step cut short do not count
    os.makedirs(os.path.join(d, "4.orbax-checkpoint-tmp-17", "default"))
    os.makedirs(os.path.join(d, "5", "default"))
    assert torbax.all_steps(d) == [2, 3] and torbax.latest_step(d) == 3
    assert_same(torbax.read_checkpoint(torbax.step_path(d, 2)), states[2])
    t = port_trainer("clip-cosine")
    mgr = t.checkpoint_manager(d, keep=1)
    assert t.restore_latest(mgr) == 3 and t.state.step == 3
    want = tconvert.tensors_from_flax(states[3]["params"], t.model)
    for n, p in want.items():
        assert torch.equal(t.state.params[n], p), n
    # new saves are orbax steps, pruned as orbax 0.11 prunes: every step
    # directory counts, the unfinished one too; its temporary directory
    # stays
    t.state.step = 6
    t.save_managed(mgr)
    t.state.step = 7
    t.save_managed(mgr)
    assert sorted(os.listdir(d)) == ["4.orbax-checkpoint-tmp-17", "7"]
    assert mgr.all_steps() == [7]
    assert_same(torbax.read_checkpoint(torbax.step_path(d, 7)),
                t.orbax_tree())


@pytest.mark.parametrize("backend", ["gs", "s3"])
def test_remote_single_and_managed(backend, params, tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    jt = jax_trainer("clip-cosine", params)
    local = str(tmp_path / "ck")
    jt.save_checkpoint(local)
    states = _save_managed(jt, str(tmp_path / "run"), (1, 2))
    with serving(monkeypatch, backend) as fake:
        tst.upload_dir(local, f"{backend}://bucket/ck")
        tst.upload_dir(str(tmp_path / "run"), f"{backend}://bucket/run")
        assert torbax.is_checkpoint(f"{backend}://bucket/ck")
        assert_same(torbax.read_checkpoint(f"{backend}://bucket/ck"),
                    torbax.read_checkpoint(local))
        t = port_trainer("clip-cosine")
        t.restore_checkpoint(f"{backend}://bucket/ck")
        assert t.state.step == 7
        t = port_trainer("clip-cosine")
        mgr = t.checkpoint_manager(f"{backend}://bucket/run", keep=1)
        assert t.restore_latest(mgr) == 2
        for n, p in tconvert.tensors_from_flax(states[2]["params"],
                                               t.model).items():
            assert torch.equal(t.state.params[n], p), n
        t.state.step = 3
        t.save_managed(mgr)
        names = {k for b, k in fake.objects if k.startswith("run/")}
        # --keep 1: step 3 is written, step 2 pruned remotely too
        assert "run/3/default/_METADATA" in names
        assert not any(n.startswith("run/2/") for n in names)


def test_sharded_array_is_read_chunk_by_chunk(tmp_path):
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("a", "b"))
    x = np.arange(8 * 6, dtype=np.float32).reshape(8, 6) * 0.5 - 3
    y = np.random.default_rng(0).integers(0, 9, (12, 5)).astype(np.int32)
    tree = {"x": jax.device_put(x, NamedSharding(mesh, PartitionSpec("a",
                                                                     "b"))),
            "y": jax.device_put(y, NamedSharding(mesh, PartitionSpec("a"))),
            "z": jnp.asarray(2.5)}
    path = str(tmp_path / "ck")
    c = ocp.StandardCheckpointer()
    c.save(path, tree)
    c.wait_until_finished()
    store = torbax._Store(path)
    assert b"x/3.1" in store.entries and b"y/3.0" in store.entries
    got = torbax.read_tree(path)
    np.testing.assert_array_equal(got["x"], x)
    np.testing.assert_array_equal(got["y"], y)
    assert got["z"].dtype == np.float32 and float(got["z"]) == 2.5


def _port_state(variant, seed):
    """A port trainer whose params and Adam state are drawn from
    ``seed``, and its JAX twin's state tree (for the JAX restore)."""
    t = port_trainer(variant)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for d in (t.state.params, t.state.opt_state.mu,
                  t.state.opt_state.nu):
            for v in d.values():
                v.copy_(torch.rand(v.shape, generator=g))
    t.state.opt_state.count, t.state.step = 9, 11
    return t


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_writer_restores_in_orbax_and_the_jax_trainer(variant, params,
                                                      tmp_path):
    t = _port_state(variant, 3)
    tree = t.orbax_tree()
    path = torbax.write_checkpoint(str(tmp_path / "ck"), tree)
    assert_same(host(ocp.StandardCheckpointer().restore(path)), tree)
    assert_same(torbax.read_checkpoint(path), tree)
    jt = jax_trainer(variant, params, seed=1, step=0)
    jt.restore_checkpoint(path)
    assert_same(host(state_dict(jt.state)), tree)
    # and back: the port restores what it wrote
    back = port_trainer(variant)
    back.restore_checkpoint(path)
    for n, p in t.state.params.items():
        assert torch.equal(back.state.params[n], p), n
    # managed: orbax's CheckpointManager and the JAX Trainer resume it
    d = str(tmp_path / "run")
    out = torbax.write_checkpoint(d, tree, managed=True)
    assert out == torbax.step_path(d, 11) and torbax.latest_step(d) == 11
    mgr = ocp.CheckpointManager(d)
    assert mgr.latest_step() == 11
    assert_same(host(mgr.restore(11, args=ocp.args.StandardRestore())),
                tree)
    jt = jax_trainer(variant, params, seed=2, step=0)
    assert jt.restore_latest(jt.checkpoint_manager(d)) == 11
    assert_same(host(state_dict(jt.state)), tree)


def test_writer_to_a_bucket(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    tree = _port_state("constant", 4).orbax_tree()
    with serving(monkeypatch, "gs"):
        url = torbax.write_checkpoint("gs://bucket/run", tree, managed=True)
        assert url == "gs://bucket/run/11/default"
        assert_same(torbax.read_checkpoint(url), tree)


def test_s2d_auto_migrates_to_an_orbax_classic_tree(tmp_path):
    kw = dict(num_classes=3, base_features=8, levels=2, image_size=128,
              batch_size=1, precision="fp32")
    classic = ttrainer.Trainer(ttrainer.TrainConfig(s2d=1, **kw),
                               device="cpu")
    path = str(tmp_path / "ck")
    c = ocp.StandardCheckpointer()
    c.save(path, jax.tree_util.tree_map(jnp.asarray, classic.orbax_tree()))
    c.wait_until_finished()
    auto = ttrainer.Trainer(ttrainer.TrainConfig(**kw), device="cpu")
    assert (auto.s2d, auto.model_features) == (2, 16)
    auto.restore_checkpoint(path)
    assert (auto.s2d, auto.model_features) == (1, 8)
    x = images(1, 128)
    np.testing.assert_array_equal(auto.predict(x), classic.predict(x))


# -- the committed fixture ---------------------------------------------------
FIXTURE_CFG = dict(num_classes=3, in_channels=3, base_features=4, levels=2,
                   image_size=32, batch_size=2, precision="fp32",
                   grad_clip_norm=1.0, schedule="cosine", warmup_steps=1,
                   total_steps=10, learning_rate=1e-2)


def write_fixture(dest=FIXTURE):
    """Write ``dest/ckpt`` (the JAX Trainer's orbax checkpoint after two
    steps on seeded batches), ``dest/leaves.npz`` (every leaf by its
    flat key, the two images ``images`` and the JAX Trainer's class maps
    of them, ``maps``) and ``dest/config.json`` (the TrainConfig, for
    ``chip_smoke.py``). Run once: ``python -m tests.test_torch_orbax``."""
    jt = jtrainer.Trainer(jtrainer.TrainConfig(**FIXTURE_CFG),
                          mesh=make_mesh(devices=jax.devices()[:1]))
    rng = np.random.RandomState(0)
    for _ in range(2):
        x = rng.randint(0, 256, (2, 32, 32, 3)).astype(np.uint8)
        y = rng.randint(0, 3, (2, 32, 32)).astype(np.int32)
        jt.train_step(x, y)
    shutil.rmtree(dest, ignore_errors=True)
    os.makedirs(dest)
    jt.save_checkpoint(os.path.join(dest, "ckpt"))
    with open(os.path.join(dest, "config.json"), "w") as f:
        json.dump(FIXTURE_CFG, f, indent=1, sort_keys=True)
    x = images()
    np.savez_compressed(
        os.path.join(dest, "leaves.npz"), images=x,
        maps=np.asarray(jt.predict(x)),
        **{f"tree/{k}": v for k, v in flat(host(state_dict(jt.state))).items()})


def fixture_leaves():
    with np.load(os.path.join(FIXTURE, "leaves.npz")) as z:
        return ({k[5:]: z[k] for k in z.files if k.startswith("tree/")},
                z["images"], z["maps"])


def test_committed_fixture_restores_to_its_npz():
    leaves, x, maps = fixture_leaves()
    path = os.path.join(FIXTURE, "ckpt")
    for tree in (host(ocp.StandardCheckpointer().restore(path)),
                 torbax.read_checkpoint(path)):
        got = flat(tree)
        assert sorted(got) == sorted(leaves)
        for k, v in leaves.items():
            assert got[k].dtype == v.dtype and got[k].tobytes() == \
                v.tobytes(), k
    with open(os.path.join(FIXTURE, "config.json")) as f:
        assert json.load(f) == FIXTURE_CFG
    t = ttrainer.Trainer(ttrainer.TrainConfig(**FIXTURE_CFG), device="cpu")
    t.restore_checkpoint(path)
    logits = torch.cat(list(t._chunked_logits(x))).numpy()
    top = np.sort(logits, axis=-1)
    clear = top[..., -1] - top[..., -2] > 1e-4
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(t.predict(x)[clear], maps[clear])


if __name__ == "__main__":
    write_fixture()
