"""Load the JAX package's flax params into the port's models.

``params_from_flax(params, model)`` takes the flax param tree as nested
dicts of numpy arrays (``jax.tree_util.tree_map(np.asarray,
variables["params"])`` on the JAX side; nothing here imports JAX) and
copies every leaf into ``model`` (a ``UNet``, ``DeepLabLite`` or
``SegFormerLite``) by NAME. The flax names, in flax's auto-numbering:

* U-Net: ``ConvBlock_0 .. ConvBlock_{L-1}`` the down blocks,
  ``ConvBlock_L`` the bottom, ``ConvBlock_{L+1} .. ConvBlock_{2L}`` the
  up blocks, each ``Conv_0``, ``GroupNorm_0``, ``Conv_1``,
  ``GroupNorm_1``; ``Conv_0 .. Conv_{L-1}`` the 2x2 stride-2 down convs
  (names pinned), ``Conv_L`` the 1x1 head (pinned);
  ``ConvTranspose_0 .. ConvTranspose_{L-1}`` the upsamplers, deepest
  first.
* DeepLab-lite: ``_ConvBNAct_0 .. 5`` the encoder, ``ASPP_0`` (its
  ``_ConvBNAct_0 .. 3`` the rate branches, ``_ConvBNAct_4`` the pooled
  branch, ``_ConvBNAct_5`` the projection), ``_ConvBNAct_6`` the
  48-channel skip projection, ``_ConvBNAct_7`` the fuse, ``Conv_0`` the
  head; each ``_ConvBNAct`` holds ``Conv_0`` and ``GroupNorm_0``.
* SegFormer-lite: stage s has the patch embedding ``Conv_s``, the
  LayerNorms ``LayerNorm_{2s}`` (after the embedding) and
  ``LayerNorm_{2s+1}`` (after the blocks) and its blocks ``Block_i`` in
  order; each block ``LayerNorm_0``, ``SRAttention_0`` (``Dense_0`` q,
  ``Conv_0`` and ``LayerNorm_0`` of the reduction where sr > 1,
  ``Dense_1`` k, ``Dense_2`` v, ``Dense_3`` out), ``LayerNorm_1``,
  ``MixFFN_0`` (``Dense_0``, the depthwise ``Conv_0``, ``Dense_1``);
  ``Dense_0 .. 3`` the decoder's stage projections, ``Dense_4`` the
  fuse, ``Dense_5`` the head.

Layouts: a flax conv kernel (kh, kw, in, out) becomes torch's (out, in,
kh, kw) (a depthwise (3, 3, 1, C) kernel becomes (C, 1, 3, 3)); a Dense
kernel (in, out) becomes ``Linear``'s (out, in). A flax ConvTranspose
with ``transpose_kernel=False`` computes ``out[2i + a, 2j + b] = sum
x[i, j] * K[1 - a, 1 - b]``, while torch's ``conv_transpose2d`` uses
``W[a, b]``: the kernel is flipped in both spatial axes and laid out
(in, out, kh, kw).

Raises ``ValueError`` naming the leaves if any flax leaf is left unused,
any torch param is left unfilled, or a shape disagrees.

The same mapping carries other trees of the param tree's shape:
gradients (``tensors_from_flax``) and the moments of the JAX package's
optax AdamW state (``adamw_state_from_optax``), so that a run trained in
the JAX package continues in the port. ``quant_from_flax`` loads the
int8-static U-Net's ``"quant"`` collection (one ``act_amax`` per
``Int8Conv``) into the port's buffers.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from .deeplab import ConvBNAct, DeepLabLite
from .quant import Int8Conv
from .segformer import SegFormerLite
from .unet import ConvBlock, UNet

__all__ = ["adamw_state_from_optax", "flatten_tree", "flax_from_tensors",
           "optax_from_adamw", "params_from_flax", "quant_from_flax",
           "tensors_from_flax"]


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """{"a/b/kernel": array} from nested dicts."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, name + "/"))
        else:
            out[name] = np.asarray(v)
    return out


def _conv_kernel(k: np.ndarray) -> np.ndarray:
    return k.transpose(3, 2, 0, 1)


def _conv_transpose_kernel(k: np.ndarray) -> np.ndarray:
    return k[::-1, ::-1].transpose(2, 3, 0, 1)


def _dense_kernel(k: np.ndarray) -> np.ndarray:
    return k.T


# torch layout -> flax layout, for each layout above
_TO_FLAX = {
    _conv_kernel: lambda t: t.transpose(2, 3, 1, 0),
    _conv_transpose_kernel: lambda t: t.transpose(2, 3, 0, 1)[::-1, ::-1],
    _dense_kernel: lambda t: t.T,
}


class _Plan:
    """[(flax leaf name, torch param, layout function)] and the convs by
    flax name, collected by walking a model in flax's names."""

    def __init__(self):
        self.leaves = []
        self.convs = []

    def conv(self, name, mod, kernel_fn=_conv_kernel):
        self.leaves.append((f"{name}/kernel", mod.weight, kernel_fn))
        self.leaves.append((f"{name}/bias", mod.bias, None))
        self.convs.append((name, mod))

    def dense(self, name, mod: nn.Linear):
        self.leaves.append((f"{name}/kernel", mod.weight, _dense_kernel))
        self.leaves.append((f"{name}/bias", mod.bias, None))

    def norm(self, name, mod):
        self.leaves.append((f"{name}/scale", mod.weight, None))
        self.leaves.append((f"{name}/bias", mod.bias, None))


def _unet_plan(model: UNet, plan: _Plan) -> None:
    L = model.levels

    def block(name, blk: ConvBlock):
        for i, (c, n) in enumerate(((blk.conv0, blk.norm0),
                                    (blk.conv1, blk.norm1))):
            plan.conv(f"{name}/Conv_{i}", c)
            plan.norm(f"{name}/GroupNorm_{i}", n)

    for lvl in range(L):
        block(f"ConvBlock_{lvl}", model.down_blocks[lvl])
        plan.conv(f"Conv_{lvl}", model.downs[lvl])
    block(f"ConvBlock_{L}", model.bottom)
    for i in range(L):
        plan.conv(f"ConvTranspose_{i}", model.ups[i], _conv_transpose_kernel)
        block(f"ConvBlock_{L + 1 + i}", model.up_blocks[i])
    plan.conv(f"Conv_{L}", model.head)


def _deeplab_plan(model: DeepLabLite, plan: _Plan) -> None:
    def cba(name, m: ConvBNAct):
        plan.conv(f"{name}/Conv_0", m.conv)
        plan.norm(f"{name}/GroupNorm_0", m.norm)

    for i, m in enumerate(model.encoder):
        cba(f"_ConvBNAct_{i}", m)
    aspp = model.aspp
    for i, m in enumerate([*aspp.branches, aspp.pooled, aspp.project]):
        cba(f"ASPP_0/_ConvBNAct_{i}", m)
    cba("_ConvBNAct_6", model.low)
    cba("_ConvBNAct_7", model.fuse)
    plan.conv("Conv_0", model.head)


def _segformer_plan(model: SegFormerLite, plan: _Plan) -> None:
    b = 0
    for s in range(4):
        plan.conv(f"Conv_{s}", model.embeds[s])
        plan.norm(f"LayerNorm_{2 * s}", model.embed_norms[s])
        for blk in model.stages[s]:
            name = f"Block_{b}"
            plan.norm(f"{name}/LayerNorm_0", blk.norm1)
            att = blk.attn
            plan.dense(f"{name}/SRAttention_0/Dense_0", att.q)
            if att.sr_ratio > 1:
                plan.conv(f"{name}/SRAttention_0/Conv_0", att.sr)
                plan.norm(f"{name}/SRAttention_0/LayerNorm_0", att.sr_norm)
            for i, d in enumerate((att.k, att.v, att.out), start=1):
                plan.dense(f"{name}/SRAttention_0/Dense_{i}", d)
            plan.norm(f"{name}/LayerNorm_1", blk.norm2)
            plan.dense(f"{name}/MixFFN_0/Dense_0", blk.ffn.fc1)
            plan.conv(f"{name}/MixFFN_0/Conv_0", blk.ffn.dw)
            plan.dense(f"{name}/MixFFN_0/Dense_1", blk.ffn.fc2)
            b += 1
        plan.norm(f"LayerNorm_{2 * s + 1}", model.stage_norms[s])
    for i, d in enumerate([*model.proj, model.fuse, model.head]):
        plan.dense(f"Dense_{i}", d)


def _walk(model: nn.Module) -> _Plan:
    plan = _Plan()
    for cls, fn in ((UNet, _unet_plan), (DeepLabLite, _deeplab_plan),
                    (SegFormerLite, _segformer_plan)):
        if isinstance(model, cls):
            fn(model, plan)
            return plan
    raise TypeError(f"no flax mapping for {type(model).__name__}")


def _plan(model: nn.Module):
    """[(flax leaf name, torch param, layout function)] for ``model``."""
    return _walk(model).leaves


def _mapped(tree: Mapping, model: nn.Module, what: str = "flax params"):
    """[(torch param name, torch param, array in torch layout)] for a
    tree shaped like the flax params, in ``model.named_parameters()``
    order; raises on a missing or unused leaf,
    an unfilled param or a shape that does not fit."""
    leaves = flatten_tree(tree)
    plan = _plan(model)
    missing = [name for name, _, _ in plan if name not in leaves]
    if missing:
        raise ValueError(f"{what} lack {len(missing)} leaves the "
                         f"port's {type(model).__name__} needs: "
                         f"{missing[:8]}")
    used = {name for name, _, _ in plan}
    extra = sorted(set(leaves) - used)
    if extra:
        raise ValueError(f"{what} hold {len(extra)} leaves the "
                         f"port's {type(model).__name__} has no place for: "
                         f"{extra[:8]}")
    names = {id(p): n for n, p in model.named_parameters()}
    filled = {id(p) for _, p, _ in plan}
    unfilled = [n for i, n in names.items() if i not in filled]
    if unfilled:
        raise ValueError(f"torch params left unfilled: {unfilled[:8]}")
    out = []
    for name, param, layout in plan:
        value = leaves[name].astype(np.float32)
        if layout is not None:
            value = layout(value)
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"{name}: flax shape {leaves[name].shape} "
                             f"does not fit torch {tuple(param.shape)}")
        out.append((names[id(param)], param, np.ascontiguousarray(value)))
    order = {n: i for i, n in enumerate(names.values())}
    return sorted(out, key=lambda item: order[item[0]])


def tensors_from_flax(tree: Mapping, model: nn.Module
                      ) -> Dict[str, torch.Tensor]:
    """A tree shaped like the flax params (the params themselves, their
    gradients, Adam's moments) as float32 CPU tensors in torch layout,
    by ``model``'s parameter names, in its order."""
    return {n: torch.from_numpy(v) for n, _, v in _mapped(tree, model)}


def params_from_flax(params: Mapping, model: nn.Module) -> nn.Module:
    """Copy the flax param tree ``params`` into ``model`` (in place);
    returns ``model``."""
    with torch.no_grad():
        for _, param, value in _mapped(params, model):
            param.copy_(torch.from_numpy(value))
    return model


def quant_from_flax(quant: Mapping, model: UNet) -> UNet:
    """Copy the JAX package's ``"quant"`` collection (``{"ConvBlock_0":
    {"Conv_0": {"act_amax": ...}}, "Conv_0": {"act_amax": ...}, ...}`` as
    numpy arrays) into the ``act_amax`` buffers of an int8-static U-Net
    (in place); raises on a missing or unused leaf. Returns ``model``."""
    leaves = flatten_tree(quant)
    want = {f"{name}/act_amax": mod for name, mod in _walk(model).convs
            if isinstance(mod, Int8Conv) and mod.static}
    missing = sorted(set(want) - set(leaves))
    extra = sorted(set(leaves) - set(want))
    if missing or extra:
        raise ValueError(f"quant collection: missing {missing[:8]}, no "
                         f"place for {extra[:8]}")
    with torch.no_grad():
        for name, mod in want.items():
            mod.act_amax.fill_(float(np.float32(leaves[name])))
    return model


def _states(tree):
    """Every node of a nested tuple/list optax state."""
    yield tree
    if isinstance(tree, (tuple, list)):
        for child in tree:
            yield from _states(child)


def _field(state, name: str):
    """A field of an optax NamedTuple state, or of the dict that an orbax
    checkpoint makes of one (a plain tuple's ``count`` method is not a
    field), or None."""
    if isinstance(state, Mapping):
        return state.get(name)
    return getattr(state, name) if name in getattr(state, "_fields", ()) \
        else None


def adamw_state_from_optax(opt_state, model: nn.Module, device=None):
    """The port's AdamWState from the state of the JAX package's
    optimizer as numpy arrays (``jax.tree_util.tree_map(np.asarray,
    opt_state)``): ``(ScaleByAdamState(count, mu, nu), EmptyState(),
    EmptyState() or ScaleByScheduleState(count))``, optionally behind the
    clip's ``(EmptyState(), ...)``. The tree that
    ``train/orbax.py:read_checkpoint`` gives is taken too: there each
    NamedTuple is a dict of its fields and each EmptyState is None. mu
    and nu are mapped like the params; every count in the state must
    agree."""
    from ..train.optim import AdamWState
    adam = [s for s in _states(opt_state)
            if _field(s, "mu") is not None and _field(s, "nu") is not None]
    if len(adam) != 1:
        raise ValueError(f"expected one Adam state (mu, nu) in the optax "
                         f"state, found {len(adam)}")
    counts = {int(np.asarray(_field(s, "count")))
              for s in _states(opt_state) if _field(s, "count") is not None}
    if len(counts) != 1:
        raise ValueError(f"the optax state's counts disagree: {counts}")

    def moments(tree, what):
        return {n: torch.from_numpy(v).to(device)
                for n, _, v in _mapped(tree, model, what)}
    return AdamWState(counts.pop(),
                      moments(_field(adam[0], "mu"), "Adam's mu"),
                      moments(_field(adam[0], "nu"), "Adam's nu"))


def flax_from_tensors(tensors: Mapping[str, torch.Tensor], model: nn.Module
                      ) -> dict:
    """The inverse of :func:`tensors_from_flax`: float32 tensors by
    ``model``'s parameter names (the params, or Adam's moments) as the
    flax tree, nested dicts of numpy arrays in flax layout."""
    names = {id(p): n for n, p in model.named_parameters()}
    out: dict = {}
    for leaf, param, layout in _plan(model):
        value = tensors[names[id(param)]].detach().to("cpu",
                                                      torch.float32).numpy()
        if layout is not None:
            value = _TO_FLAX[layout](value)
        node = out
        *path, last = leaf.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = np.ascontiguousarray(value)
    return out


def optax_from_adamw(opt_state, model: nn.Module, clip: bool,
                     schedule: bool) -> tuple:
    """The port's AdamWState as the JAX package's optax state, in the
    form ``train/orbax.py`` writes: ``({"count", "mu", "nu"}, None,
    {"count"} with a schedule else None)``, behind ``(None, ...)`` when
    the optimizer clips. Counts are int32, as optax keeps them."""
    count = np.asarray(int(opt_state.count), np.int32)
    adam = {"count": count, "mu": flax_from_tensors(opt_state.mu, model),
            "nu": flax_from_tensors(opt_state.nu, model)}
    state = (adam, None, {"count": count} if schedule else None)
    return (None, state) if clip else state
