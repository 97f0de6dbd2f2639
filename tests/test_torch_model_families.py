"""The PyTorch port's shared layers, DeepLab-lite, SegFormer-lite, their
flax converters and their Trainer steps against the JAX package, on the
CPU.

Sizes: DeepLab-lite base_features 8 with ASPP 16, SegFormer-lite
base_features 8 with decoder 32 (one block a stage in the Trainer steps,
whose XLA compile is the file's largest cost), 3 classes, 32-64 px;
inputs and weights made from numpy seeds. Tolerances, with what was
measured on the CPU:

* ``same_pads``: equal to lax's SAME padding;
* ``resize_bilinear``: bitwise against ``jax.image.resize`` at bf16
  (H contracted first; the other order is off in 40% of outputs), within
  1e-5 at fp32 (measured 4.4e-6 on N(0, 1) values), odd sizes included;
* ``layer_norm`` and ``gelu``: within 1e-6 of flax at fp32;
* fp32 logits through the converter: |port - JAX| <= 1e-4 + 1e-4 |JAX|
  (measured <= 3.0e-6), class maps equal where JAX's top two differ by
  more than 1e-3; bf16 probabilities within 5e-2, class maps equal where
  the top two probabilities differ by more than 0.1;
* 3 fp32 Trainer steps from the same weights: losses within 1e-4
  relative, and the AdamW moments converted from optax within 1e-4 of
  each tensor's largest entry (the Adam moments, not the parameters:
  Adam's first steps move a near-zero gradient's parameter lr either
  way).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from jax import lax
from torch.utils.flop_counter import FlopCounterMode

from dl_image_segmentation_tpu.models import deeplab as jdeeplab
from dl_image_segmentation_tpu.models import segformer as jsegformer
from dl_image_segmentation_tpu.train import trainer as jtrainer
from dl_image_segmentation_tpu_torch import models as tmodels
from dl_image_segmentation_tpu_torch.models import convert as tconvert
from dl_image_segmentation_tpu_torch.models import layers as tlayers
from dl_image_segmentation_tpu_torch.train import trainer as ttrainer

from tests.test_torch_models import seeded_tree, top2_gap
from tests.test_torch_train import host, jax_trainer

# one intra-op thread: the test workers share the host's cores
torch.set_num_threads(1)

FP32_ATOL = FP32_RTOL = 1e-4
FP32_GAP = 1e-3
BF16_ATOL = 5e-2
BF16_GAP = 0.1
K = 3


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).float().numpy()


@pytest.mark.parametrize("n,k,s,d", [
    (256, 3, 2, 1), (255, 3, 2, 1), (256, 7, 4, 1), (257, 7, 4, 1),
    (32, 3, 1, 6), (32, 3, 1, 18), (33, 2, 2, 1), (64, 8, 8, 1),
    (63, 8, 8, 1), (5, 1, 1, 1)])
def test_same_pads_equal_lax(n, k, s, d):
    (ref,) = lax.padtype_to_pads((n,), ((k - 1) * d + 1,), (s,), "SAME")
    assert tlayers.same_pads(n, k, s, d) == tuple(ref)


@pytest.mark.parametrize("shape", [(32, 32, 128, 128), (32, 32, 125, 125),
                                   (63, 63, 250, 250), (8, 5, 16, 33),
                                   (7, 9, 7, 20), (32, 32, 16, 16)])
@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_resize_bilinear_equals_jax(shape, precision):
    h, w, ho, wo = shape
    jd, td = ((jnp.bfloat16, torch.bfloat16) if precision == "bf16"
              else (jnp.float32, torch.float32))
    x = np.random.RandomState(h + w).randn(2, h, w, 5).astype(np.float32)
    xj = jnp.asarray(x).astype(jd)
    ref = np.asarray(jax.jit(lambda a: jax.image.resize(
        a, (2, ho, wo, 5), "bilinear"))(xj).astype(jnp.float32))
    xt = nchw(np.asarray(xj.astype(jnp.float32))).to(td)
    got = tlayers.resize_bilinear(xt, ho, wo)
    assert got.dtype == td
    if precision == "bf16":
        np.testing.assert_array_equal(nhwc(got), ref)
    else:
        np.testing.assert_allclose(nhwc(got), ref, atol=1e-5, rtol=0)


def test_resize_weights_are_not_inference_tensors():
    """Weights first made under inference_mode serve a train step later."""
    with torch.inference_mode():
        tlayers.resize_bilinear(torch.ones(1, 1, 3, 3), 6, 6)
    x = torch.ones(1, 1, 3, 3, requires_grad=True)
    tlayers.resize_bilinear(x, 6, 6).sum().backward()
    assert x.grad is not None


def test_layer_norm_and_gelu_equal_flax():
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 50, 24) * 3 + 1).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(24)).astype(np.float32)
    bias = (0.1 * rng.randn(24)).astype(np.float32)
    ref = np.asarray(nn.LayerNorm(dtype=jnp.float32).apply(
        {"params": {"scale": scale, "bias": bias}}, x))
    norm = torch.nn.LayerNorm(24, eps=tlayers.LN_EPS)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(scale))
        norm.bias.copy_(torch.from_numpy(bias))
        got = tlayers.layer_norm(norm, torch.from_numpy(x), torch.float32)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        tlayers.gelu(torch.from_numpy(x)).numpy(),
        np.asarray(nn.gelu(jnp.asarray(x))), atol=1e-6, rtol=1e-6)


def deeplab(td=torch.float32, aspp=16):
    return tmodels.DeepLabLite(K, 8, aspp, dtype=td)


def segformer(td=torch.float32, decoder=32):
    return tmodels.SegFormerLite(K, 8, decoder_dim=decoder, dtype=td)


FAMILIES = {
    "deeplab": (lambda jd: jdeeplab.DeepLabLite(
        num_classes=K, base_features=8, aspp_features=16, dtype=jd),
        deeplab),
    "segformer": (lambda jd: jsegformer.SegFormerLite(
        num_classes=K, base_features=8, decoder_dim=32, dtype=jd),
        segformer),
}


@pytest.mark.parametrize("family,size,precision", [
    ("deeplab", 32, "fp32"), ("deeplab", 33, "fp32"), ("deeplab", 33, "bf16"),
    ("segformer", 64, "fp32"), ("segformer", 62, "fp32"),
    ("segformer", 62, "bf16")])
def test_forward_through_the_converter_equals_flax(family, size, precision):
    jd, td = ((jnp.float32, torch.float32) if precision == "fp32"
              else (jnp.bfloat16, torch.bfloat16))
    make_j, make_t = FAMILIES[family]
    jm = make_j(jd)
    params = seeded_tree(jm, size, seed=size)
    x = np.random.RandomState(size + 1).rand(2, size, size, 3).astype(
        np.float32)
    ref = np.asarray(jax.jit(jm.apply)({"params": params}, x))
    tm = tmodels.params_from_flax(params, make_t(td))
    with torch.no_grad():
        got = nhwc(tm(nchw(x)))
    assert got.shape == ref.shape == (2, size, size, K)
    if precision == "fp32":
        print(f"{family} {size}: max |port - JAX| {np.abs(got - ref).max():.3g}")
        np.testing.assert_allclose(got, ref, atol=FP32_ATOL, rtol=FP32_RTOL)
        sure = top2_gap(ref) > FP32_GAP
        np.testing.assert_array_equal(got.argmax(-1)[sure],
                                      ref.argmax(-1)[sure])
    else:
        pr = np.asarray(jax.nn.softmax(ref, axis=-1))
        pg = torch.softmax(torch.from_numpy(got), -1).numpy()
        np.testing.assert_allclose(pg, pr, atol=BF16_ATOL, rtol=0)
        sure = top2_gap(pr) > BF16_GAP
        np.testing.assert_array_equal(pg.argmax(-1)[sure],
                                      pr.argmax(-1)[sure])


@pytest.mark.parametrize("family", ["deeplab", "segformer"])
class TestConverter:
    def _tree(self, family):
        jm = FAMILIES[family][0](jnp.float32)
        return seeded_tree(jm, 64)

    def test_flatten_names_every_leaf(self, family):
        names = tconvert.flatten_tree(self._tree(family))
        model = FAMILIES[family][1]()
        plan = tconvert._plan(model)
        assert sorted(names) == sorted(n for n, _, _ in plan)
        assert len(plan) == len(list(model.parameters()))

    def test_missing_and_extra_leaves_raise(self, family):
        tree = self._tree(family)
        name = "ASPP_0" if family == "deeplab" else "Block_3"
        model = FAMILIES[family][1]()
        gone = tree.pop(name)
        with pytest.raises(ValueError, match=f"lack .*{name}"):
            tmodels.params_from_flax(tree, model)
        tree[name] = gone
        tree["Dense_9"] = {"kernel": np.zeros((4, 4), np.float32)}
        with pytest.raises(ValueError, match="no place for.*Dense_9"):
            tmodels.params_from_flax(tree, model)

    def test_layouts(self, family):
        """A Dense kernel (in, out) becomes Linear's (out, in); a
        depthwise (3, 3, 1, C) kernel becomes (C, 1, 3, 3)."""
        tree = self._tree(family)
        model = tmodels.params_from_flax(tree, FAMILIES[family][1]())
        if family == "deeplab":
            k = tree["ASPP_0"]["_ConvBNAct_2"]["Conv_0"]["kernel"]
            w = model.aspp.branches[2].conv.weight
            np.testing.assert_array_equal(
                w.detach().numpy(), k.transpose(3, 2, 0, 1))
            return
        k = tree["Block_0"]["MixFFN_0"]["Conv_0"]["kernel"]
        assert k.shape == (3, 3, 1, 32)
        dw = model.stages[0][0].ffn.dw.weight.detach().numpy()
        assert dw.shape == (32, 1, 3, 3)
        np.testing.assert_array_equal(dw[5, 0], k[:, :, 0, 5])
        q = tree["Block_2"]["SRAttention_0"]["Dense_0"]["kernel"]
        np.testing.assert_array_equal(
            model.stages[1][0].attn.q.weight.detach().numpy(), q.T)


@pytest.mark.parametrize("make,size", [(deeplab, 32), (deeplab, 33),
                                       (segformer, 64), (segformer, 62)])
def test_flops_equal_torch_counter(make, size):
    m = make()
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        m(torch.zeros(2, 3, size, size))
    assert fc.get_total_flops() == 2 * m.flops(size, size)


def test_full_width_flops_and_parameters():
    """The TrainConfig defaults at 256 px: DeepLab-lite 1.82 M
    parameters, SegFormer-lite 3.72 M (as the flax trees count them)."""
    for make_j, make_t, n_params in (
            (lambda: jdeeplab.DeepLabLite(num_classes=10), lambda:
             tmodels.DeepLabLite(10), 1_820_000),
            (lambda: jsegformer.SegFormerLite(num_classes=10), lambda:
             tmodels.SegFormerLite(10), 3_720_000)):
        shapes = jax.eval_shape(make_j().init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 256, 256, 3)))["params"]
        flax_n = sum(int(np.prod(a.shape))
                     for a in jax.tree_util.tree_leaves(shapes))
        model = make_t()
        assert sum(p.numel() for p in model.parameters()) == flax_n
        assert abs(flax_n - n_params) < 10_000
        assert model.flops(256, 256) > 1e9


# -- Trainer --------------------------------------------------------------
N, SIZE = 2, 32
CFG = dict(num_classes=K, base_features=8, image_size=SIZE, batch_size=N,
           precision="fp32", learning_rate=1e-3, grad_clip_norm=1.0)
STEPS = 3


def batch(seed):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 256, (N, SIZE, SIZE, 3)).astype(np.uint8)
    y = rng.randint(0, K, (N, SIZE, SIZE)).astype(np.int32)
    y[rng.rand(N, SIZE, SIZE) < 0.1] = 255
    return x, y


@pytest.mark.parametrize("family", ["deeplab", "segformer"])
def test_train_steps_equal_jax_trainer(family, monkeypatch):
    """Both Trainers build the family narrowed as above (each Trainer's
    own model class, with ASPP 16 or one block a stage and decoder 32)."""
    cfg = {**CFG, "model": family}
    jcfg = jtrainer.TrainConfig(**cfg)
    if family == "deeplab":
        jmod, tname, narrow = jdeeplab, "DeepLabLite", dict(aspp_features=16)
    else:
        jmod, tname = jsegformer, "SegFormerLite"
        narrow = dict(depths=(1, 1, 1, 1), decoder_dim=32)
    jcls = getattr(jmod, tname)
    monkeypatch.setattr(jmod, tname, functools.partial(jcls, **narrow))
    monkeypatch.setattr(ttrainer, tname, functools.partial(
        getattr(ttrainer, tname), **narrow))
    params = seeded_tree(jcls(num_classes=K, base_features=8, **narrow),
                         SIZE, seed=7)
    jt = jax_trainer(jcfg, params)
    tt = ttrainer.Trainer(ttrainer.TrainConfig(**cfg), device="cpu")
    tt.load_flax_params(params)
    for s in range(STEPS):
        ref = jt.train_step(*batch(s))
        got = tt.train_step(*batch(s))
        print(f"{family} step {s}: loss port {got['loss']:.7f} JAX "
              f"{ref['loss']:.7f}")
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-4)
    # the optax state converts onto this family's parameters
    opt = tconvert.adamw_state_from_optax(host(jt.state.opt_state),
                                          tt.model)
    assert opt.count == tt.state.opt_state.count == STEPS
    for n in opt.mu:
        for got, want in ((tt.state.opt_state.mu[n], opt.mu[n]),
                          (tt.state.opt_state.nu[n], opt.nu[n])):
            err = float((got - want).abs().max())
            assert err <= 1e-4 * float(want.abs().max()) + 1e-12, (n, err)


@pytest.mark.parametrize("family", ["deeplab", "segformer"])
def test_checkpoint_carries_the_family(family, tmp_path):
    path = str(tmp_path / "ckpt.pt")
    cfg = dict(CFG, model=family)
    t = ttrainer.Trainer(ttrainer.TrainConfig(**cfg), device="cpu")
    t.train_step(*batch(0))
    t.save_checkpoint(path)
    again = ttrainer.Trainer(ttrainer.TrainConfig(**cfg), device="cpu")
    again.restore_checkpoint(path)
    x = batch(1)[0]
    np.testing.assert_array_equal(again.predict(x), t.predict(x))
    assert again.state.step == 1
    unet = ttrainer.Trainer(ttrainer.TrainConfig(
        **{**CFG, "levels": 1}), device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        unet.restore_checkpoint(path)


def test_trainer_builds_each_family_on_its_config():
    for family, cls in (("deeplab", tmodels.DeepLabLite),
                        ("segformer", tmodels.SegFormerLite)):
        t = ttrainer.Trainer(ttrainer.TrainConfig(
            **{**CFG, "model": family, "in_channels": 4, "seed": 3}),
            device="cpu")
        assert isinstance(t.model, cls) and t.infer_model is t.model
        assert (t.s2d, t.model_features) == (1, 8)
        out = t.predict(np.zeros((1, SIZE, SIZE, 4), np.float32))
        assert out.shape == (1, SIZE, SIZE) and out.dtype == np.int32
        # seeded: the same config gives the same weights
        again = ttrainer.Trainer(t.config, device="cpu")
        assert all(torch.equal(a, b) for a, b in zip(
            t.model.parameters(), again.model.parameters()))
