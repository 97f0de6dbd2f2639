"""The PyTorch port's U-Net, weight converter and Trainer against the JAX
package, on the CPU: layout moves, the transposed conv's orientation,
forward passes through the converter at fp32 and bf16, s2d resolution
(the real Trainer of each family), and the configurations the port
refuses.

Tolerances, with the largest differences measured on this CPU (numpy
seeds below; JAX and the port both on the CPU):

* fp32 logits: |port - JAX| <= 1e-4 + 1e-4 * |JAX| (measured at most
  2.4e-6 absolute over the three forward cases); class maps equal
  wherever JAX's top two logits differ by more than 1e-3.
* bf16 probabilities: |port - JAX| <= 5e-2 (measured at most 1.2e-2);
  class maps equal wherever JAX's top two probabilities differ by more
  than 0.1. The port adds each conv's bias inside the conv (one bf16
  rounding) where flax rounds twice.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn
from torch.utils.flop_counter import FlopCounterMode

from dl_image_segmentation_tpu.models import unet as junet
from dl_image_segmentation_tpu.train import trainer as jtrainer
from dl_image_segmentation_tpu_torch import models as tmodels
from dl_image_segmentation_tpu_torch.models import convert as tconvert
from dl_image_segmentation_tpu_torch.models import layers as tlayers
from dl_image_segmentation_tpu_torch.models import unet as tunet
from dl_image_segmentation_tpu_torch.train import trainer as ttrainer

# one intra-op thread: the test workers share the host's cores
torch.set_num_threads(1)

FP32_ATOL = FP32_RTOL = 1e-4
FP32_GAP = 1e-3
BF16_ATOL = 5e-2
BF16_GAP = 0.1


def seeded_tree(model, size=32, seed=0):
    """The param tree of ``model.init`` (names and shapes from
    jax.eval_shape, so nothing is compiled), filled from a numpy seed:
    kernels ~ N(0, 1 / fan_in), GroupNorm scales ~ 1 + N(0, 0.1^2), all
    biases ~ N(0, 0.1^2) so that a misplaced bias shows."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3)))["params"]

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape)
                    / np.sqrt(fan_in)).astype(np.float32)
        base = 1.0 if name.endswith("['scale']") else 0.0
        return (base + 0.1 * rng.standard_normal(leaf.shape)).astype(
            np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def flax_params(num_classes=3, base_features=8, levels=2, s2d=1, size=32,
                dtype=jnp.float32, seed=0):
    model = junet.UNet(num_classes=num_classes, base_features=base_features,
                       levels=levels, s2d=s2d, dtype=dtype)
    return model, seeded_tree(model, size, seed)


def jax_trainer(cfg, monkeypatch, params):
    """The JAX package's Trainer for ``cfg`` holding ``params``, built
    without compiling its init or step."""
    monkeypatch.setattr(jtrainer.Trainer, "_init_state", lambda self: None)
    monkeypatch.setattr(jtrainer.Trainer, "_build_step", lambda self: None)
    t = jtrainer.Trainer(cfg)
    t.state = jtrainer.TrainState(params, None, 0)
    return t


def top2_gap(x):
    s = np.sort(x, axis=-1)
    return s[..., -1] - s[..., -2]


@pytest.mark.parametrize("block", [2, 4])
def test_space_to_depth_and_back_equal_jax(block):
    x = np.random.RandomState(block).rand(2, 8, 12, 5).astype(np.float32)
    ref = np.array(junet.space_to_depth(jnp.asarray(x), block))
    got = tmodels.space_to_depth(torch.from_numpy(x).permute(0, 3, 1, 2),
                                 block).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, ref)
    back = np.asarray(junet.depth_to_space(jnp.asarray(ref), block))
    got = tmodels.depth_to_space(torch.from_numpy(ref).permute(0, 3, 1, 2),
                                 block).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, back)
    np.testing.assert_array_equal(got, x)


@pytest.mark.parametrize("a,b", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_conv_transpose_orientation(a, b):
    """A one-hot flax ConvTranspose kernel at (a, b) writes out[2i + 1 -
    a, 2j + 1 - b]; the converter's flip reproduces it in torch."""
    kernel = np.zeros((2, 2, 3, 2), np.float32)
    kernel[a, b, 1, 0] = 1.0
    x = np.random.RandomState(0).rand(1, 3, 4, 3).astype(np.float32)
    ref = np.asarray(nn.ConvTranspose(2, (2, 2), strides=(2, 2),
                                      use_bias=False).apply(
        {"params": {"kernel": kernel}}, x))
    assert np.array_equal(ref[0, 1 - a::2, 1 - b::2, 0], x[0, :, :, 1])
    w = torch.from_numpy(tconvert._conv_transpose_kernel(kernel).copy())
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = F.conv_transpose2d(xt, w, stride=2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, ref)
    # the model's form: a 1x1 conv to 4x the channels + pixel shuffle
    up = torch.nn.ConvTranspose2d(3, 2, 2, stride=2)
    with torch.no_grad():
        up.weight.copy_(w)
        up.bias.copy_(torch.tensor([0.5, -0.25]))
        got = tunet._upsample(up, xt, torch.float32)
        want = F.conv_transpose2d(xt, w, up.bias, stride=2)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("s2d,size", [(1, 32), (1, 33), (2, 32)])
def test_unet_forward_equals_jax(s2d, size, precision):
    jd, td = ((jnp.float32, torch.float32) if precision == "fp32"
              else (jnp.bfloat16, torch.bfloat16))
    jm, params = flax_params(s2d=s2d, size=size, dtype=jd)
    x = np.random.RandomState(size + s2d).rand(4, size, size, 3).astype(
        np.float32)
    ref = np.asarray(jax.jit(jm.apply)({"params": params}, x))
    tm = tmodels.params_from_flax(
        params, tmodels.UNet(3, 8, 2, dtype=td, s2d=s2d))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    if precision == "fp32":
        np.testing.assert_allclose(got, ref, atol=FP32_ATOL, rtol=FP32_RTOL)
        sure = top2_gap(ref) > FP32_GAP
        np.testing.assert_array_equal(got.argmax(-1)[sure],
                                      ref.argmax(-1)[sure])
    else:
        pr = np.asarray(jax.nn.softmax(ref, axis=-1))
        pg = torch.softmax(torch.from_numpy(got), -1).numpy()
        np.testing.assert_allclose(pg, pr, atol=BF16_ATOL, rtol=0)
        sure = top2_gap(pr) > BF16_GAP
        assert sure.mean() > 0.5
        np.testing.assert_array_equal(pg.argmax(-1)[sure],
                                      pr.argmax(-1)[sure])


class TestConverter:
    def test_missing_leaf_raises(self):
        _, params = flax_params()
        del params["ConvBlock_3"]["GroupNorm_1"]["scale"]
        with pytest.raises(ValueError, match="lack 1 leaves.*ConvBlock_3"):
            tmodels.params_from_flax(params, tmodels.UNet(3, 8, 2))

    def test_extra_leaf_raises(self):
        _, params = flax_params()
        params["Conv_9"] = {"kernel": np.zeros((1, 1, 8, 3), np.float32)}
        with pytest.raises(ValueError, match="no place for.*Conv_9"):
            tmodels.params_from_flax(params, tmodels.UNet(3, 8, 2))

    def test_wrong_tree_raises(self):
        """An s2d=2 tree does not fit the classic model (stem and head
        widths differ)."""
        _, params = flax_params(s2d=2)
        with pytest.raises(ValueError, match="does not fit"):
            tmodels.params_from_flax(params, tmodels.UNet(3, 8, 2))

    def test_flatten_names_every_leaf(self):
        _, params = flax_params(levels=3)
        names = tconvert.flatten_tree(params)
        plan = tconvert._plan(tmodels.UNet(3, 8, 3))
        assert sorted(names) == sorted(n for n, _, _ in plan)
        assert len(plan) == len(list(tmodels.UNet(3, 8, 3).parameters()))


class TestInit:
    def test_flax_scheme_from_a_seeded_generator(self):
        def make(seed):
            return tmodels.UNet(2, 16, 2, generator=torch.Generator()
                                .manual_seed(seed))
        a, b, c = make(0), make(0), make(1)
        for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                      c.parameters()):
            assert torch.equal(pa, pb), name
            if name.endswith("weight") and pa.dim() == 4:
                assert not torch.equal(pa, pc), name
        w = a.bottom.conv1.weight.detach()  # fan_in 9 * 64
        std = (1.0 / (9 * 64)) ** 0.5
        assert abs(float(w.std()) / std - 1) < 0.05
        assert float(w.abs().max()) <= 2 * std / 0.87962566103423978
        up = a.ups[0].weight.detach()  # ConvTranspose: fan_in 4 * in channels
        assert abs(float(up.std()) / (1.0 / (4 * 64)) ** 0.5 - 1) < 0.05
        assert all(float(m.bias.detach().abs().max()) == 0 for m in a.modules()
                   if isinstance(m, (torch.nn.Conv2d,
                                     torch.nn.ConvTranspose2d)))
        assert torch.equal(a.bottom.norm0.weight, torch.ones(64))

    @pytest.mark.parametrize("s2d,size", [(1, 32), (1, 33), (2, 32)])
    def test_conv_flops_equal_torch_counter(self, s2d, size):
        m = tmodels.UNet(3, 8, 2, dtype=torch.float32, s2d=s2d)
        with FlopCounterMode(display=False) as fc, torch.no_grad():
            m(torch.zeros(2, 3, size, size))
        assert fc.get_total_flops() == 2 * m.flops(size, size)


def jax_trainer_resolution(cfg, monkeypatch):
    t = jax_trainer(cfg, monkeypatch, None)
    return t.s2d, t.model_features


@pytest.mark.parametrize("model", ["unet", "deeplab", "segformer"])
def test_s2d_resolution_equals_jax_trainer(model, monkeypatch):
    seen = set()
    for s2d in (0, 1):
        for bf in (8, 32, 48, 64):
            for size in (64, 126, 128, 129, 256):
                kw = dict(model=model, base_features=bf, image_size=size,
                          s2d=s2d, levels=1, num_classes=2)
                ref = jax_trainer_resolution(jtrainer.TrainConfig(**kw),
                                             monkeypatch)
                got = ttrainer.resolve_s2d(ttrainer.TrainConfig(**kw))
                assert got == ref, kw
                seen.add(got[0])
                if size <= 128 and (model == "unet" or bf <= 32):
                    t = ttrainer.Trainer(ttrainer.TrainConfig(**kw),
                                         device="cpu")
                    assert (t.s2d, t.model_features) == ref
                    assert t.model.base_features == ref[1]
    assert seen == ({1, 2} if model == "unet" else {1})


def test_train_config_fields_equal_jax():
    import dataclasses
    ref = {f.name: f.default for f in dataclasses.fields(jtrainer.TrainConfig)}
    got = {f.name: f.default for f in dataclasses.fields(ttrainer.TrainConfig)}
    assert got == ref


@pytest.mark.parametrize("kw,exc,match", [
    ({"model": "deeplab", "s2d": 2}, ValueError, "model='unet' only"),
    ({"model": "segformer", "s2d": 2}, ValueError, "model='unet' only"),
    ({"model": "deeplab", "quantize": "int8"}, ValueError,
     "model='unet' only"),
    ({"model": "segformer", "quantize": "int8-static"}, ValueError,
     "model='unet' only"),
    ({"n_model": 2}, NotImplementedError, "queue 1 item 8"),
    ({"spatial": True}, NotImplementedError, "queue 1 item 8"),
    ({"fsdp": True}, NotImplementedError, "queue 1 item 8"),
    ({"model": "resnet"}, ValueError, "unknown model"),
    ({"quantize": "int4"}, ValueError, "unknown quantize"),
    ({"precision": "fp16"}, ValueError, "unknown precision"),
    ({"class_weights": (1.0,)}, ValueError, "class_weights"),
    ({"s2d": 2, "image_size": 33}, ValueError, "divide"),
])
def test_unsupported_configs_raise(kw, exc, match):
    cfg = ttrainer.TrainConfig(**{"base_features": 8, "levels": 1,
                                  "image_size": 32, **kw})
    with pytest.raises(exc, match=match):
        ttrainer.Trainer(cfg, device="cpu")


def test_trainer_without_device_raises_here():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = ttrainer.TrainConfig(base_features=8, levels=1, image_size=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrainer.Trainer(cfg)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_forward_fixes_cudnn_switches_and_restores_them(precision,
                                                        monkeypatch):
    """cuDNN benchmark is off during every forward (its per-thread choice
    would let a server thread's logits differ from predict's) and TF32
    is off at fp32; the caller's switches come back after the call."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    monkeypatch.setattr(cudnn, "benchmark", True)
    monkeypatch.setattr(cudnn, "allow_tf32", True)
    monkeypatch.setattr(matmul, "allow_tf32", True)
    cfg = ttrainer.TrainConfig(base_features=8, levels=1, image_size=32,
                               batch_size=2, precision=precision)
    t = ttrainer.Trainer(cfg, device="cpu")
    seen = []
    t.model.register_forward_pre_hook(lambda *_: seen.append(
        (cudnn.benchmark, cudnn.allow_tf32, matmul.allow_tf32)))
    t.predict(np.zeros((2, 32, 32, 3), np.float32))
    tf32 = precision == "bf16"
    assert seen == [(False, tf32, tf32)]
    assert (cudnn.benchmark, cudnn.allow_tf32, matmul.allow_tf32) == (
        True, True, True)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int32,
                                   np.float32])
def test_normalize_images_equal_jax(dtype):
    x = (np.random.RandomState(0).rand(2, 4, 4, 3) * 250).astype(dtype)
    ref = np.asarray(jtrainer.normalize_images(jnp.asarray(x)))
    got = ttrainer.normalize_images(torch.from_numpy(x)).numpy()
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_trainer_predict_equals_jax_trainer(precision, monkeypatch):
    """Trainer.predict_probs / predict / predict_both after
    load_flax_params against the JAX Trainer on the same weights and
    uint8 images (scaled on the device by both)."""
    kw = dict(num_classes=3, base_features=8, levels=2, image_size=32,
              batch_size=4, precision=precision)
    _, params = flax_params()
    jt = jax_trainer(jtrainer.TrainConfig(**kw), monkeypatch, params)
    tt = ttrainer.Trainer(ttrainer.TrainConfig(**kw), device="cpu")
    tt.load_flax_params(params)
    assert tt.state.step == 0 and tt.s2d == jt.s2d == 1
    x = np.random.RandomState(7).randint(0, 256, (4, 32, 32, 3), np.uint8)
    ref = jt.predict_probs(x)
    got = tt.predict_probs(x)
    atol = FP32_ATOL if precision == "fp32" else BF16_ATOL
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0)
    sure = top2_gap(ref) > (FP32_GAP if precision == "fp32" else BF16_GAP)
    cls = tt.predict(x)
    assert cls.dtype == np.int32 and cls.shape == (4, 32, 32)
    np.testing.assert_array_equal(cls[sure], jt.predict(x)[sure])
    both_cls, both_probs = tt.predict_both(x)
    np.testing.assert_array_equal(both_cls, cls)
    np.testing.assert_array_equal(both_probs, got)


def test_slot_check_sees_a_slot_dependent_conv(monkeypatch):
    """``_slot_dependent`` finds a conv that gives an image other bits in
    another batch slot (a fake conv that adds its slot index) and passes
    the CPU's conv, whose images do not depend on their slots."""
    x = torch.zeros(4, 16, 8, 8)
    w, b = torch.zeros(32, 16, 3, 3), torch.zeros(32)
    assert not tlayers._slot_dependent(x, w, b, 1, 1)
    conv = F.conv2d

    def by_slot(x, w, b=None, **kw):
        y = conv(x, w, b, **kw)
        return y + 1e-3 * torch.arange(y.shape[0]).view(-1, 1, 1, 1)
    monkeypatch.setattr(tlayers.F, "conv2d", by_slot)
    assert tlayers._slot_dependent(x, w, b, 1, 1)


def test_cpu_forward_runs_no_slot_check():
    """Only an inference forward on the card tests its convs' slots: the
    CPU forward is the plain F.conv2d."""
    t = ttrainer.Trainer(ttrainer.TrainConfig(
        base_features=8, levels=1, image_size=32, batch_size=2),
        device="cpu")
    before = dict(tlayers._SLOT_DEPENDENT)
    t.predict(np.zeros((2, 32, 32, 3), np.float32))
    assert tlayers._SLOT_DEPENDENT == before
