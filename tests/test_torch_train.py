"""The PyTorch port's training path against the JAX package, on the CPU:
loss and mIoU, the optimizer against optax, steps against the JAX
Trainer, scanned training with the JAX draws replayed, evaluation,
augmentation, the device pool and checkpoints.

Size: U-Net base_features 8, 2 levels, 32 px, batch 4, 3 classes, fp32
unless stated; inputs made from numpy seeds. Tolerances:

* loss and accuracy functions: rtol 1e-6 (all-nodata batches exact);
* loss against jax.value_and_grad: rtol 1e-6; gradients, mapped through
  the converter, within 1e-5 of their global norm;
* schedules: rtol 1e-6 against optax for counts 0 .. total + 5;
  clip_by_global_norm on identical gradients: rtol 1e-6; 3 AdamW(+clip)
  updates on identical gradient trees: each param, mu and nu tensor
  within 1e-6 of its largest entry (an entry whose terms nearly cancel
  keeps the rounding of the terms, not of its own size);
* 3 train_steps against the JAX Trainer from the same weights: losses
  rtol 1e-4, accuracy within one pixel's share; the parameters are held
  to PARAM_ATOL = 2 * lr * steps absolute, the most that Adam's +-lr
  first steps allow where a near-zero gradient takes the other sign in
  XLA:CPU and in torch (ConvBlock biases feed a GroupNorm, which removes
  their common part); the measured distance is printed;
* the step after an optax state carried over: loss and accuracy as
  above, and mu and nu each within 1e-4 of the tensor's largest entry
  (the step's gradients come from two conv implementations; measured
  2.5e-6; moments that were not carried would be off by about 0.9);
* one bf16 step: loss within 5e-2;
* evaluate: loss rtol 1e-5, confusion-derived metrics within one
  pixel's share;
* augmentation with the JAX draws: dihedral ops exact, contrast and
  brightness within 1e-6; rotation (``rotate_pairs``) exact, labels and
  images, against ``random_rotate_pairs`` on its own angles and against
  its ``_rotate_one`` at fixed angles (0, +-90 and 180 degrees, 45
  degrees on odd sizes, where coordinates fall within an ulp of a pixel);
* ``remat=True``: loss and every parameter after two steps bitwise equal
  to the step without it;
* an orbax checkpoint of the JAX run's state resumes bitwise as the
  same state given through ``load_optax_state``.
"""

import os

import jax
import orbax.checkpoint as ocp
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dl_image_segmentation_tpu.ops import augment as jaugment
from dl_image_segmentation_tpu.parallel.sharding import (make_mesh,
                                                         replicated_sharding)
from dl_image_segmentation_tpu.train import pool as jpool
from dl_image_segmentation_tpu.train import trainer as jtrainer
from dl_image_segmentation_tpu_torch.models import convert as tconvert
from dl_image_segmentation_tpu_torch.ops import augment as taugment
from dl_image_segmentation_tpu_torch.train import optim as toptim
from dl_image_segmentation_tpu_torch.train import pool as tpool
from dl_image_segmentation_tpu_torch.train import trainer as ttrainer

from tests.test_torch_models import flax_params

# one intra-op thread: the test workers share the host's cores
torch.set_num_threads(1)

N, SIZE, K = 4, 32, 3
PIXEL = 1.0 / (N * SIZE * SIZE)
CFG = dict(num_classes=K, base_features=8, levels=2, image_size=SIZE,
           batch_size=N, precision="fp32", learning_rate=1e-2,
           grad_clip_norm=0.5, class_weights=(1.0, 0.5, 2.0))
STEPS = 3
PARAM_ATOL = 2 * CFG["learning_rate"] * STEPS
MOMENT_RTOL = 1e-4


def batch(seed, nodata=0.1):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 256, (N, SIZE, SIZE, 3)).astype(np.uint8)
    y = rng.randint(0, K, (N, SIZE, SIZE)).astype(np.int32)
    y[rng.rand(N, SIZE, SIZE) < nodata] = 255
    return x, y


def jax_trainer(cfg, params):
    """The JAX package's Trainer on a one-device mesh holding ``params``
    and a fresh optax state, built without compiling its init."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer.Trainer, "_init_state", lambda self: None)
        mp.setattr(jtrainer.Trainer, "_build_step", lambda self: None)
        t = jtrainer.Trainer(cfg, mesh=make_mesh(devices=jax.devices()[:1]))
    p = jax.tree_util.tree_map(jnp.asarray, params)
    # placed on the mesh as the step's outputs are (as _init_state places
    # it), so that the step compiles once, not again for the second step
    t.state = jax.device_put(
        jtrainer.TrainState(p, t.tx.init(p), jnp.zeros((), jnp.int32)),
        replicated_sharding(t.mesh))
    t._step_fn = t._build_step()
    return t


def host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_trainer(params, **kw):
    t = ttrainer.Trainer(ttrainer.TrainConfig(**{**CFG, **kw}), device="cpu")
    return t.load_flax_params(params)


def max_param_diff(tt, flax_tree):
    want = tconvert.tensors_from_flax(host(flax_tree), tt.model)
    return max(float((tt.state.params[n].detach() - w).abs().max())
               for n, w in want.items())


@pytest.fixture(scope="module")
def jax_run():
    """STEPS + 1 JAX train_steps from the seeded weights, with the state
    after STEPS kept as numpy."""
    _, params = flax_params()
    jt = jax_trainer(jtrainer.TrainConfig(**CFG), params)
    out = {"params": params, "metrics": []}
    for s in range(STEPS + 1):
        if s == STEPS:
            out["state"] = (host(jt.state.params), host(jt.state.opt_state),
                            int(jt.state.step))
        out["metrics"].append(jt.train_step(*batch(s)))
    out["final"] = host(jt.state.params)
    out["final_opt"] = host(jt.state.opt_state)
    return out


class TestLoss:
    @pytest.mark.parametrize("weights,nodata", [
        (None, 0.1), ((1.0, 0.0, 3.0), 0.1), (None, 1.0), ((1.0, 0.0, 3.0),
                                                           1.0)])
    def test_masked_xent_loss_equals_jax(self, weights, nodata):
        rng = np.random.RandomState(1)
        logits = rng.randn(2, 8, 8, K).astype(np.float32)
        labels = batch(2, nodata)[1][:2, :8, :8]
        ref = jtrainer.masked_xent_loss(
            jnp.asarray(logits), jnp.asarray(labels), 255,
            None if weights is None else jnp.asarray(weights))
        cw = None if weights is None else torch.tensor(weights)
        got = ttrainer.masked_xent_loss(torch.from_numpy(logits),
                                        torch.from_numpy(labels), 255, cw)
        for g, r in zip(got, ref):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(float(g), float(r), rtol=1e-6)
        if nodata == 1.0:
            assert float(got[0]) == 0.0 and float(got[1]) == 0.0

    @pytest.mark.parametrize("nodata", [0.2, 1.0])
    def test_masked_miou_equals_jax(self, nodata):
        pred = np.random.RandomState(3).randint(0, K, (N, SIZE, SIZE))
        labels = batch(4, nodata)[1]
        ref = jtrainer.masked_miou(jnp.asarray(pred), jnp.asarray(labels), K,
                                   255)
        got = ttrainer.masked_miou(torch.from_numpy(pred),
                                   torch.from_numpy(labels), K, 255)
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)

    def test_loss_and_grads_equal_value_and_grad(self):
        jm, params = flax_params()
        x, y = batch(5)
        cw = jnp.asarray(CFG["class_weights"])

        def loss_fn(p):
            logits = jm.apply({"params": p},
                              jtrainer.normalize_images(jnp.asarray(x)))
            return jtrainer.masked_xent_loss(logits, jnp.asarray(y), 255,
                                             cw)[0]
        ref, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
        tt = port_trainer(params)
        logits = tt.model(ttrainer.normalize_images(
            torch.from_numpy(x)).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        loss, _ = ttrainer.masked_xent_loss(logits, torch.from_numpy(y), 255,
                                            torch.tensor(cw))
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-6)
        want = tconvert.tensors_from_flax(host(grads), tt.model)
        norm = float(torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in want.values()])))
        for n, p in tt.model.named_parameters():
            assert float((p.grad - want[n]).abs().max()) <= 1e-5 * norm, n


class TestOptimizer:
    @pytest.mark.parametrize("kw,total", [
        ({}, 12), ({"warmup_steps": 5}, 12),
        ({"schedule": "cosine", "warmup_steps": 5}, 20),
        ({"schedule": "cosine"}, 7)])
    def test_schedules_equal_optax(self, kw, total):
        cfg = dict(learning_rate=3e-3, total_steps=total, **kw)
        jt = jtrainer.TrainConfig(**cfg)
        if jt.schedule == "cosine":
            ref = optax.warmup_cosine_decay_schedule(
                0.0, jt.learning_rate, max(jt.warmup_steps, 1),
                max(jt.total_steps, 2))
        elif jt.warmup_steps:
            ref = optax.linear_schedule(0.0, jt.learning_rate,
                                        jt.warmup_steps)
        else:
            ref = lambda c: jnp.full(c.shape, jt.learning_rate)  # noqa
        counts = np.arange(total + 6)
        want = np.asarray(ref(jnp.asarray(counts, jnp.int32)), np.float32)
        sched = toptim.make_schedule(ttrainer.TrainConfig(**cfg))
        got = np.array([sched(int(c)) for c in counts], np.float32)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
        assert got[0] == (0.0 if kw else 3e-3)

    def _trees(self, seed):
        _, params = flax_params(seed=seed)
        rng = np.random.RandomState(seed)
        grads = jax.tree_util.tree_map(
            lambda p: (rng.standard_normal(p.shape)
                       * (rng.rand(*p.shape) < 0.9) * 1e-2).astype(np.float32)
            + np.float32(1e-9), params)
        return params, grads

    @pytest.mark.parametrize("scale", [0.25, 4.0])
    def test_clip_by_global_norm_equals_optax(self, scale):
        _, grads = self._trees(1)
        model = port_trainer(flax_params()[1]).model
        gl = [g for g in tconvert.tensors_from_flax(grads, model).values()]
        norm = float(torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in gl])))
        max_norm = norm * scale
        ref, _ = jax.jit(optax.clip_by_global_norm(max_norm).update)(
            grads, None)
        before = [g.clone() for g in gl]
        toptim.clip_by_global_norm_(gl, max_norm)
        want = tconvert.tensors_from_flax(host(ref), model)
        for g, w, b in zip(gl, want.values(), before):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                       atol=1e-12)
            if scale > 1:
                assert torch.equal(g, b)

    def test_adamw_updates_on_identical_gradients_equal_optax(self):
        cfg = ttrainer.TrainConfig(**{**CFG, "schedule": "cosine",
                                      "warmup_steps": 1, "total_steps": 5})
        jcfg = jtrainer.TrainConfig(**{**CFG, "schedule": "cosine",
                                       "warmup_steps": 1, "total_steps": 5})
        params, _ = self._trees(0)
        jt = jax_trainer(jcfg, params)
        tx, p, state = jt.tx, jt.state.params, jt.state.opt_state
        tt = port_trainer(params, **{"schedule": "cosine",
                                     "warmup_steps": 1, "total_steps": 5})
        st = tt.state
        sched = toptim.make_schedule(cfg)
        update = jax.jit(lambda g, s, p: tx.update(g, s, p))
        for s in range(3):
            _, g = self._trees(10 + s)
            upd, state = update(g, state, p)
            p = optax.apply_updates(p, upd)
            gl = list(tconvert.tensors_from_flax(g, tt.model).values())
            toptim.clip_by_global_norm_(gl, cfg.grad_clip_norm)
            opt = st.opt_state
            opt.count = toptim.adamw_update_(
                list(st.params.values()), gl, list(opt.mu.values()),
                list(opt.nu.values()), opt.count, sched(opt.count),
                cfg.weight_decay)
        ref = tconvert.adamw_state_from_optax(host(state), tt.model)
        assert st.opt_state.count == ref.count == 3
        want = tconvert.tensors_from_flax(host(p), tt.model)
        # held to each tensor's scale: an entry whose terms nearly cancel
        # keeps the rounding of the terms, not of its own size
        for n in st.params:
            for got, w in ((st.params[n], want[n]),
                           (st.opt_state.mu[n], ref.mu[n]),
                           (st.opt_state.nu[n], ref.nu[n])):
                err = float((got.detach() - w).abs().max())
                assert err <= 1e-6 * float(w.abs().max()), (n, err)


class TestTraining:
    def test_train_steps_equal_jax_trainer(self, jax_run):
        tt = port_trainer(jax_run["params"])
        for s in range(STEPS):
            got = tt.train_step(*batch(s))
            ref = jax_run["metrics"][s]
            np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-4)
            assert abs(got["accuracy"] - ref["accuracy"]) <= PIXEL
        assert tt.state.step == tt.state.opt_state.count == STEPS
        dist = max_param_diff(tt, jax_run["state"][0])
        print(f"max |param port - param JAX| after {STEPS} steps: {dist:.3g} "
              f"(tolerance {PARAM_ATOL})")
        assert dist <= PARAM_ATOL

    def test_carried_optax_state_next_step_equals_jax(self, jax_run):
        params, opt_state, step = jax_run["state"]
        tt = port_trainer(params).load_optax_state(opt_state)
        assert tt.state.step == step == STEPS
        got = tt.train_step(*batch(STEPS))
        ref = jax_run["metrics"][STEPS]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-4)
        assert abs(got["accuracy"] - ref["accuracy"]) <= PIXEL
        dist = max_param_diff(tt, jax_run["final"])
        print(f"max |param port - param JAX| after the carried step: "
              f"{dist:.3g} (tolerance {PARAM_ATOL / STEPS})")
        assert dist <= PARAM_ATOL / STEPS
        # the moments after the carried step: mu and nu that were not
        # carried (zeros) would be off by 0.9 mu and 0.999 nu
        ref = tconvert.adamw_state_from_optax(jax_run["final_opt"], tt.model)
        opt = tt.state.opt_state
        assert opt.count == ref.count == STEPS + 1
        worst = 0.0
        for n in opt.mu:
            for got, w in ((opt.mu[n], ref.mu[n]), (opt.nu[n], ref.nu[n])):
                err = float((got - w).abs().max()) / float(w.abs().max())
                worst = max(worst, err)
        print(f"max |moment port - moment JAX| / max |moment JAX| after the "
              f"carried step: {worst:.3g} (tolerance {MOMENT_RTOL})")
        assert worst <= MOMENT_RTOL

    def test_bf16_step_loss_equals_jax(self):
        _, params = flax_params()
        kw = {**CFG, "precision": "bf16"}
        jt = jax_trainer(jtrainer.TrainConfig(**kw), params)
        tt = port_trainer(params, precision="bf16")
        ref = jt.train_step(*batch(0))
        got = tt.train_step(*batch(0))
        assert abs(got["loss"] - ref["loss"]) <= 5e-2

    def test_train_scanned_replays_jax_draws(self):
        kw = {**CFG, "augment_invert": 0.3, "augment_brightness": 0.1,
              "augment_contrast": 0.2}
        _, params = flax_params()
        jt = jax_trainer(jtrainer.TrainConfig(**kw), params)
        x = np.concatenate([batch(s)[0] for s in range(2)])
        y = np.concatenate([batch(s)[1] for s in range(2)])
        # a refresh of 3 examples after each dispatch (offsets 0, then 3):
        # the second dispatch samples a pool the first refresh changed
        fresh = [(batch(20 + s)[0][:3], batch(20 + s)[1][:3])
                 for s in range(2)]
        jp = jpool.DeviceDataPool(x, y)
        ref = jt.train_scanned(jp, total_steps=4, steps_per_dispatch=2,
                               refresh_feed=iter(fresh), seed=3,
                               augment=True)
        tt = port_trainer(params, **kw)
        cfg = tt.config
        draws = []
        key = jax.random.PRNGKey(3)
        for _ in range(4):
            key, sub = jax.random.split(key)
            idx = jax.random.randint(sub, (N,), 0, len(x))
            key, asub = jax.random.split(key)
            draws.append({"idx": torch.from_numpy(np.array(idx)),
                          "augment": jax_augment_draws(asub, N, cfg)})
        tp = tpool.DeviceDataPool(x, y, device="cpu")
        got = tt.train_scanned(tp, total_steps=4, steps_per_dispatch=2,
                               refresh_feed=iter(fresh), augment=True,
                               draws=draws)
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-4)
        assert abs(got["accuracy"] - ref["accuracy"]) <= PIXEL
        assert len(tt.scan_losses) == 4 and tt.state.step == 4
        np.testing.assert_array_equal(tp.images.numpy(), np.asarray(jp.images))
        np.testing.assert_array_equal(tp.labels.numpy(), np.asarray(jp.labels))
        np.testing.assert_array_equal(tp.images[:6].numpy(), np.concatenate(
            [f[0] for f in fresh]))
        assert tt.feed_seconds > 0
        assert got["loss"] == tt.scan_losses[-1]
        dist = max_param_diff(tt, jt.state.params)
        print(f"max |param port - param JAX| after 4 scanned steps: "
              f"{dist:.3g} (tolerance {2 * CFG['learning_rate'] * 4})")
        assert dist <= 2 * CFG["learning_rate"] * 4
        for k in ("examples_per_sec", "duty_cycle", "duty_cycle_lower"):
            assert got[k] > 0

    def test_evaluate_equals_jax(self):
        _, params = flax_params()
        jt = jax_trainer(jtrainer.TrainConfig(**CFG), params)
        tt = port_trainer(params)
        batches = [batch(10 + s, nodata=0.3) for s in range(3)]
        ref = jt.evaluate(iter(batches))
        got = tt.evaluate(iter(batches))
        assert got["batches"] == ref["batches"] == 3
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
        share = PIXEL / 3
        for k in ("accuracy", "miou"):
            assert abs(got[k] - ref[k]) <= share, k
        for k in ("per_class_iou", "per_class_f1"):
            np.testing.assert_allclose(got[k], ref[k], atol=3 * share)
        empty = tt.evaluate(iter([]))
        assert empty["batches"] == 0 and np.isnan(empty["miou"])


def jax_augment_draws(key, n, cfg):
    """augment_pairs' draws from ``key``, as the JAX package makes them."""
    k_h, k_v, k_r, k_i, k_b, k_c = jax.random.split(key, 6)
    d = {"hflip": jax.random.bernoulli(k_h, 0.5, (n,)),
         "vflip": jax.random.bernoulli(k_v, 0.5, (n,)),
         "k": jax.random.randint(k_r, (n,), 0, 4)}
    if cfg.augment_invert > 0:
        d["invert"] = jax.random.bernoulli(k_i, cfg.augment_invert, (n,))
    if cfg.augment_contrast > 0:
        c = cfg.augment_contrast
        d["contrast"] = jax.random.uniform(k_c, (n, 1, 1, 1),
                                           minval=1.0 - c, maxval=1.0 + c)
    if cfg.augment_brightness > 0:
        b = cfg.augment_brightness
        d["brightness"] = jax.random.uniform(k_b, (n, 1, 1, 1),
                                             minval=-b, maxval=b)
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


class TestAugmentAndPool:
    @pytest.mark.parametrize("photometric", [False, True])
    def test_augment_pairs_with_jax_draws(self, photometric):
        cfg = ttrainer.TrainConfig(
            augment_invert=0.5 if photometric else 0.0,
            augment_brightness=0.2 if photometric else 0.0,
            augment_contrast=0.3 if photometric else 0.0)
        x, y = batch(7)
        x = x.astype(np.float32) / 255.0
        key = jax.random.PRNGKey(11)
        ri, rl = jaugment.augment_pairs(
            key, jnp.asarray(x), jnp.asarray(y),
            invert_prob=cfg.augment_invert,
            brightness=cfg.augment_brightness,
            contrast=cfg.augment_contrast)
        draws = jax_augment_draws(key, N, cfg)
        assert set(draws["k"].tolist()) != {0}
        gi, gl = taugment.apply_augment(torch.from_numpy(x),
                                        torch.from_numpy(y), draws)
        np.testing.assert_array_equal(gl.numpy(), np.asarray(rl))
        if photometric:
            np.testing.assert_allclose(gi.numpy(), np.asarray(ri), atol=1e-6)
        else:
            np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))

    def test_draws_come_from_the_generator(self):
        x, y = batch(8)
        x = torch.from_numpy(x.astype(np.float32) / 255.0)

        def run(seed):
            g = torch.Generator().manual_seed(seed)
            return taugment.augment_pairs(x, torch.from_numpy(y), g,
                                          invert_prob=0.5, brightness=0.1,
                                          contrast=0.1)
        a, b, c = run(1), run(1), run(2)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        assert not torch.equal(a[0], c[0])
        d = taugment.draw_augment(torch.Generator().manual_seed(0), 1000,
                                  invert_prob=0.25, brightness=0.1,
                                  contrast=0.3)
        assert 0.2 < float(d["invert"].float().mean()) < 0.3
        assert set(d["k"].tolist()) == {0, 1, 2, 3}
        assert float(d["contrast"].min()) >= 0.7
        assert float(d["brightness"].abs().max()) <= 0.1

    def test_random_invert_pairs_and_normalize_equal_jax(self):
        x, y = batch(9)
        x = x.astype(np.float32)
        key = jax.random.PRNGKey(5)
        ri, _ = jaugment.random_invert_pairs(key, jnp.asarray(x),
                                             jnp.asarray(y), 0.5, 255.0)
        flip = np.array(jax.random.uniform(key, (N,)) < 0.5)
        gi, gl = taugment.random_invert_pairs(
            torch.from_numpy(x), torch.from_numpy(y), 0.5, 255.0,
            flip=torch.from_numpy(flip))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
        assert gl.data_ptr() == torch.from_numpy(y).data_ptr() or \
            np.array_equal(gl.numpy(), y)
        mean, std = np.float32([10, 20, 30]), np.float32([2, 4, 8])
        np.testing.assert_array_equal(
            taugment.normalize(torch.from_numpy(x), torch.from_numpy(mean),
                               torch.from_numpy(std)).numpy(),
            np.asarray(jaugment.normalize(x, mean, std)))

    @pytest.mark.parametrize("shape,degrees,seed", [
        ((6, 37, 29, 3), 180.0, 3), ((4, 64, 64, 4), 30.0, 5),
        ((8, 16, 16, 1), 180.0, 7), ((3, 33, 33, 2), 90.0, 9)])
    def test_rotate_pairs_equal_jax_random_rotate_pairs(self, shape, degrees,
                                                        seed):
        rng = np.random.default_rng(seed)
        x = rng.random(shape, dtype=np.float32)
        y = rng.integers(0, 9, shape[:3]).astype(np.uint8)
        key = jax.random.PRNGKey(seed)
        ri, rl = jaugment.random_rotate_pairs(key, x, y, max_degrees=degrees)
        angles = jax.jit(lambda k: jax.random.uniform(
            k, (shape[0],), minval=-1.0, maxval=1.0)
            * (degrees * jnp.pi / 180.0))(key)
        gi, gl = taugment.rotate_pairs(torch.from_numpy(x),
                                       torch.from_numpy(y),
                                       torch.from_numpy(np.asarray(angles)))
        assert gl.dtype == torch.uint8 and (gl.numpy() == 255).any()
        np.testing.assert_array_equal(gl.numpy(), np.asarray(rl))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))

    @pytest.mark.parametrize("dtype", [np.uint8, np.int32])
    @pytest.mark.parametrize("size", [(31, 31), (37, 28), (32, 32)])
    def test_rotate_pairs_at_fixed_angles_and_ties(self, size, dtype):
        """Bitwise, but for int32 labels at pixels whose source coordinate
        lies within 1e-5 of a rounding tie: XLA rounds those as the
        index of uint8 labels rounds them in one program and otherwise in
        another (4 of the 10,240 labels at 45 degrees on 32 x 32)."""
        h, w = size
        angles = np.float32([0.0, np.pi / 2, -np.pi / 2, np.pi, -np.pi,
                             1e-7, np.pi / 4, -np.pi / 4, 0.5, -2.9])
        n = len(angles)
        rng = np.random.default_rng(h)
        x = rng.random((n, h, w, 2), dtype=np.float32)
        # one channel holds its column: a sample's x coordinate shows
        x[..., 0] = np.arange(w, dtype=np.float32)
        y = rng.integers(0, 9, (n, h, w)).astype(dtype)
        rot = jax.jit(lambda im, lb, a: (
            jax.vmap(lambda i, t: jaugment._rotate_one(i, t, 1, 0.0))(im, a),
            jax.vmap(lambda lab, t: jaugment._rotate_one(
                lab.astype(jnp.float32), t, 0, 7.0))(lb, a).astype(lb.dtype)))
        ri, rl = rot(x, y, angles)
        gi, gl = taugment.rotate_pairs(torch.from_numpy(x),
                                       torch.from_numpy(y),
                                       torch.from_numpy(angles), fill_label=7)
        tie = np.zeros((n, h, w), bool)
        if dtype == np.int32:
            a = angles.astype(np.float64)[:, None, None]
            dy = np.arange(h)[:, None] - (h - 1) / 2.0
            dx = np.arange(w)[None, :] - (w - 1) / 2.0
            for s in ((h - 1) / 2.0 + dy * np.cos(a) - dx * np.sin(a),
                      (w - 1) / 2.0 + dy * np.sin(a) + dx * np.cos(a)):
                tie |= np.abs(np.abs(s - np.floor(s)) - 0.5) < 1e-5
        np.testing.assert_array_equal(gl.numpy()[~tie],
                                      np.asarray(rl)[~tie])
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
        # 0 degrees is the identity
        np.testing.assert_array_equal(gl.numpy()[0], y[0])
        np.testing.assert_array_equal(gi.numpy()[0], x[0])

    def test_random_rotate_pairs_draws_from_the_generator(self):
        x, y = batch(10)
        x = torch.from_numpy(x.astype(np.float32) / 255.0)

        def run(seed, degrees=180.0):
            return taugment.random_rotate_pairs(
                torch.Generator().manual_seed(seed), x, torch.from_numpy(y),
                max_degrees=degrees)
        a, b, c = run(1), run(1), run(2)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        assert not torch.equal(a[1], c[1])
        flat = run(3, 0.0)
        assert torch.equal(flat[0], x) and torch.equal(flat[1],
                                                       torch.from_numpy(y))

    def test_sample_batch_and_refresh_equal_jax(self):
        x = np.random.RandomState(0).randint(0, 256, (6, 4, 4, 3)).astype(
            np.uint8)
        y = np.arange(6 * 16, dtype=np.int32).reshape(6, 4, 4) % 7
        jp = jpool.DeviceDataPool(x, y)
        tp = tpool.DeviceDataPool(x, y, device="cpu")
        assert tp.size == 6 and tp.images.dtype == torch.uint8
        key = jax.random.PRNGKey(2)
        ri, rl = jpool.sample_batch(key, jp.images, jp.labels, 5)
        idx = jax.random.randint(key, (5,), 0, 6)
        gi, gl = tpool.sample_batch(tp.images, tp.labels,
                                    torch.from_numpy(np.array(idx)))
        assert gl.dtype == torch.int32
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(gl.numpy(), np.asarray(rl))
        new_x = np.full((3, 4, 4, 3), 9, np.uint8)
        new_y = np.full((3, 4, 4), 5, np.int64)
        for offset in (1, 5):  # 5 runs past the end: moved back to 3
            jp.refresh(new_x, new_y, offset)
            tp.refresh(new_x, new_y, offset)
            np.testing.assert_array_equal(tp.images.numpy(),
                                          np.asarray(jp.images))
            np.testing.assert_array_equal(tp.labels.numpy(),
                                          np.asarray(jp.labels))
        with pytest.raises(ValueError, match="larger than the pool"):
            tp.refresh(np.zeros((7, 4, 4, 3), np.uint8),
                       np.zeros((7, 4, 4), np.int32))
        feed = iter([(x[:4], y[:4]), (x[4:], y[4:]), (x, y)])
        pool = tpool.DeviceDataPool.from_feed(feed, 5, device="cpu")
        np.testing.assert_array_equal(pool.images.numpy(), x[:5])


class TestCheckpoints:
    def test_round_trip_and_manager(self, tmp_path):
        _, params = flax_params()
        tt = port_trainer(params)
        tt.train_step(*batch(0))
        path = str(tmp_path / "ck" / "model.pt")
        tt.save_checkpoint(path)
        assert os.listdir(tmp_path / "ck") == ["model.pt"]
        fresh = ttrainer.Trainer(tt.config, device="cpu")
        fresh.restore_checkpoint(path)
        assert fresh.state.step == 1 and fresh.state.opt_state.count == 1
        for a, b in ((tt.state.params, fresh.state.params),
                     (tt.state.opt_state.mu, fresh.state.opt_state.mu),
                     (tt.state.opt_state.nu, fresh.state.opt_state.nu)):
            assert all(torch.equal(a[n], b[n]) for n in a)
        x = batch(1)[0]
        np.testing.assert_array_equal(fresh.predict(x), tt.predict(x))
        # the next step continues the same run
        np.testing.assert_array_equal(
            fresh.train_step(*batch(1))["loss"],
            tt.train_step(*batch(1))["loss"])
        mgr = tt.checkpoint_manager(str(tmp_path / "managed"), keep=2)
        assert tt.restore_latest(mgr) is None
        for _ in range(3):
            tt.save_managed(mgr)
            tt.state.step += 1
        assert mgr.all_steps() == [3, 4]
        other = ttrainer.Trainer(tt.config, device="cpu")
        assert other.restore_latest(mgr) == 4 and other.state.step == 4

    def test_classic_checkpoint_migrates_into_auto_trainer(self, tmp_path):
        kw = dict(num_classes=2, base_features=8, levels=1, image_size=128,
                  batch_size=2)
        classic = ttrainer.Trainer(ttrainer.TrainConfig(s2d=1, **kw),
                                   device="cpu")
        path = str(tmp_path / "classic.pt")
        classic.save_checkpoint(path)
        auto = ttrainer.Trainer(ttrainer.TrainConfig(**kw), device="cpu")
        assert (auto.s2d, auto.model_features) == (2, 16)
        auto.restore_checkpoint(path)
        assert (auto.s2d, auto.model_features) == (1, 8)
        x = np.random.RandomState(0).rand(2, 128, 128, 3).astype(np.float32)
        np.testing.assert_array_equal(auto.predict_probs(x),
                                      classic.predict_probs(x))
        explicit = ttrainer.Trainer(ttrainer.TrainConfig(s2d=2, **kw),
                                    device="cpu")
        with pytest.raises(ValueError, match="does not match"):
            explicit.restore_checkpoint(path)

    @pytest.mark.parametrize("precision", ["fp32", "bf16"])
    def test_remat_steps_equal_the_plain_steps(self, precision):
        """remat recomputes the forward in backward (each conv runs twice
        a step) and gives the plain step's loss and parameters, bitwise."""
        _, params = flax_params()
        runs = {}
        for remat in (False, True):
            tt = port_trainer(params, remat=remat, precision=precision)
            calls = []
            tt.model.down_blocks[0].register_forward_hook(
                lambda *_: calls.append(1))
            losses = [tt.train_step(*batch(s)) for s in range(2)]
            runs[remat] = (losses, tt.state.params, len(calls))
        assert runs[False][2] == 2 and runs[True][2] == 4
        assert runs[True][0] == runs[False][0]
        for n, p in runs[False][1].items():
            assert torch.equal(runs[True][1][n], p), n

    def test_orbax_checkpoint_of_the_jax_run_resumes(self, jax_run,
                                                     tmp_path):
        """The JAX run's state after STEPS steps, saved by orbax as the JAX
        Trainer saves it, restores into the port as the same state given
        through load_flax_params and load_optax_state; the next step of
        each is the same, bitwise."""
        params, opt_state, step = jax_run["state"]
        path = str(tmp_path / "ck")
        ckptr = ocp.StandardCheckpointer()
        ckptr.save(path, jax.tree_util.tree_map(jnp.asarray, {
            "params": params, "opt_state": opt_state,
            "step": np.int32(step)}))
        ckptr.wait_until_finished()
        got = ttrainer.Trainer(ttrainer.TrainConfig(**CFG), device="cpu")
        got.restore_checkpoint(path)
        want = port_trainer(params).load_optax_state(opt_state, step=step)
        assert got.state.step == want.state.step == STEPS
        assert got.train_step(*batch(STEPS)) == want.train_step(*batch(STEPS))
        for n, p in want.state.params.items():
            assert torch.equal(got.state.params[n], p), n


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_train_step_takes_deterministic_cudnn_and_restores(precision,
                                                           monkeypatch):
    """The train step's forward and backward run with cuDNN's
    deterministic algorithms (and benchmark off); inference keeps the
    caller's choice; the switches come back after each call."""
    cudnn = torch.backends.cudnn
    monkeypatch.setattr(cudnn, "benchmark", True)
    monkeypatch.setattr(cudnn, "deterministic", False)
    cfg = ttrainer.TrainConfig(**{**CFG, "precision": precision})
    tt = ttrainer.Trainer(cfg, device="cpu")
    seen = []
    tt.model.register_forward_pre_hook(lambda *_: seen.append(
        (cudnn.benchmark, cudnn.deterministic)))
    tt.model.register_full_backward_pre_hook(lambda *_: seen.append(
        ("backward", cudnn.benchmark, cudnn.deterministic)))
    x = np.random.RandomState(0).rand(N, SIZE, SIZE, 3).astype(np.float32)
    y = np.random.RandomState(1).randint(0, K, (N, SIZE, SIZE)).astype(
        np.int32)
    tt.train_step(x, y)
    assert seen == [(False, True), ("backward", False, True)]
    assert (cudnn.benchmark, cudnn.deterministic) == (True, False)
    tt.predict(x)
    assert seen[2:] == [(False, False)]
    assert (cudnn.benchmark, cudnn.deterministic) == (True, False)

