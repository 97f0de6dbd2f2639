"""Load the JAX package's flax U-Net params into the port's UNet.

``unet_params_from_flax(params, model)`` takes the flax param tree as
nested dicts of numpy arrays (``jax.tree_util.tree_map(np.asarray,
variables["params"])`` on the JAX side; nothing here imports JAX) and
copies every leaf into ``model`` by NAME:

* ``ConvBlock_0 .. ConvBlock_{L-1}`` are the down blocks,
  ``ConvBlock_L`` the bottom, ``ConvBlock_{L+1} .. ConvBlock_{2L}`` the
  up blocks, in call order (flax auto-numbering); inside each,
  ``Conv_0``, ``GroupNorm_0``, ``Conv_1``, ``GroupNorm_1``;
* ``Conv_0 .. Conv_{L-1}`` the 2x2 stride-2 down convs (names pinned),
  ``Conv_L`` the 1x1 head (pinned);
* ``ConvTranspose_0 .. ConvTranspose_{L-1}`` the upsamplers, deepest
  first.

Layouts: a flax conv kernel (kh, kw, in, out) becomes torch's
(out, in, kh, kw). A flax ConvTranspose with ``transpose_kernel=False``
computes ``out[2i + a, 2j + b] = sum x[i, j] * K[1 - a, 1 - b]``, while
torch's ``conv_transpose2d`` uses ``W[a, b]``: the kernel is flipped in
both spatial axes and laid out (in, out, kh, kw).

Raises ``ValueError`` naming the leaves if any flax leaf is left unused,
any torch param is left unfilled, or a shape disagrees.

The same mapping carries other trees of the param tree's shape:
gradients (``tensors_from_flax``) and the moments of the JAX package's
optax AdamW state (``adamw_state_from_optax``), so that a run trained in
the JAX package continues in the port.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .unet import ConvBlock, UNet

__all__ = ["adamw_state_from_optax", "flatten_tree", "tensors_from_flax",
           "unet_params_from_flax"]


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


def _plan(model: UNet):
    """[(flax leaf name, torch param, layout function)] for ``model``."""
    L = model.levels
    plan = []

    def conv(name, mod, kernel_fn=_conv_kernel):
        plan.append((f"{name}/kernel", mod.weight, kernel_fn))
        plan.append((f"{name}/bias", mod.bias, None))

    def block(name, blk: ConvBlock):
        for i, (c, n) in enumerate(((blk.conv0, blk.norm0),
                                    (blk.conv1, blk.norm1))):
            conv(f"{name}/Conv_{i}", c)
            plan.append((f"{name}/GroupNorm_{i}/scale", n.weight, None))
            plan.append((f"{name}/GroupNorm_{i}/bias", n.bias, None))

    for lvl in range(L):
        block(f"ConvBlock_{lvl}", model.down_blocks[lvl])
        conv(f"Conv_{lvl}", model.downs[lvl])
    block(f"ConvBlock_{L}", model.bottom)
    for i in range(L):
        conv(f"ConvTranspose_{i}", model.ups[i], _conv_transpose_kernel)
        block(f"ConvBlock_{L + 1 + i}", model.up_blocks[i])
    conv(f"Conv_{L}", model.head)
    return plan


def _mapped(tree: Mapping, model: UNet, what: str = "flax params"):
    """[(torch param name, torch param, array in torch layout)] for a
    tree shaped like the flax params, in ``model.named_parameters()``
    order; raises on a missing or unused leaf,
    an unfilled param or a shape that does not fit."""
    leaves = flatten_tree(tree)
    plan = _plan(model)
    missing = [name for name, _, _ in plan if name not in leaves]
    if missing:
        raise ValueError(f"{what} lack {len(missing)} leaves the "
                         f"port's UNet needs: {missing[:8]}")
    used = {name for name, _, _ in plan}
    extra = sorted(set(leaves) - used)
    if extra:
        raise ValueError(f"{what} hold {len(extra)} leaves the "
                         f"port's UNet has no place for: {extra[:8]}")
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


def tensors_from_flax(tree: Mapping, model: UNet) -> Dict[str, torch.Tensor]:
    """A tree shaped like the flax params (the params themselves, their
    gradients, Adam's moments) as float32 CPU tensors in torch layout,
    by ``model``'s parameter names, in its order."""
    return {n: torch.from_numpy(v) for n, _, v in _mapped(tree, model)}


def unet_params_from_flax(params: Mapping, model: UNet) -> UNet:
    """Copy the flax param tree ``params`` into ``model`` (in place);
    returns ``model``."""
    with torch.no_grad():
        for _, param, value in _mapped(params, model):
            param.copy_(torch.from_numpy(value))
    return model


def _states(tree):
    """Every node of a nested tuple/list optax state."""
    yield tree
    if isinstance(tree, (tuple, list)):
        for child in tree:
            yield from _states(child)


def _field(state, name: str):
    """A field of an optax NamedTuple state (a plain tuple's ``count``
    method is not one), or None."""
    return getattr(state, name) if name in getattr(state, "_fields", ()) \
        else None


def adamw_state_from_optax(opt_state, model: UNet, device=None):
    """The port's AdamWState from the state of the JAX package's
    optimizer as numpy arrays (``jax.tree_util.tree_map(np.asarray,
    opt_state)``): ``(ScaleByAdamState(count, mu, nu), EmptyState(),
    EmptyState() or ScaleByScheduleState(count))``, optionally behind the
    clip's ``(EmptyState(), ...)``. mu and nu are mapped like the params;
    every count in the state must agree."""
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
    return AdamWState(counts.pop(), moments(adam[0].mu, "Adam's mu"),
                      moments(adam[0].nu, "Adam's nu"))
