"""Batch augmentation of segmentation pairs on the device.

A port of the JAX package's ``ops/augment.py``. Each random op has two
parts: a draw function that takes its random numbers from an explicit
``torch.Generator`` (on the batch's device), and a pure apply function
that takes those draws as tensors, so the same draws (the JAX package's,
in the tests) give the same output. Geometric ops are the dihedral
group (flips and 90-degree rotations: exact, label-safe), applied to
image and label alike; photometric ops touch the image only. The order
is the JAX package's: hflip, vflip, rot90, invert, contrast, then
brightness with clip.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

__all__ = ["apply_augment", "augment_pairs", "draw_augment", "normalize",
           "random_invert_pairs"]


def draw_augment(generator: torch.Generator, n: int, hflip: bool = True,
                 vflip: bool = True, rot90: bool = True,
                 invert_prob: float = 0.0, brightness: float = 0.0,
                 contrast: float = 0.0, device=None
                 ) -> Dict[str, torch.Tensor]:
    """The random draws of :func:`apply_augment` for ``n`` examples: bool
    masks ``hflip``, ``vflip``, ``invert`` (n,), rotation counts ``k``
    in [0, 4) (n,), contrast factors ~ U(1 - c, 1 + c) and brightness
    deltas ~ U(-b, b) (n, 1, 1, 1); only the enabled ones."""
    dev = generator.device if device is None else device
    d: Dict[str, torch.Tensor] = {}

    def coin(p):
        return torch.rand(n, generator=generator, device=dev) < p

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand((n, 1, 1, 1), generator=generator,
                                           device=dev)
    if hflip:
        d["hflip"] = coin(0.5)
    if vflip:
        d["vflip"] = coin(0.5)
    if rot90:
        d["k"] = torch.randint(0, 4, (n,), generator=generator, device=dev)
    if invert_prob > 0:
        d["invert"] = coin(invert_prob)
    if contrast > 0:
        d["contrast"] = uniform(1.0 - contrast, 1.0 + contrast)
    if brightness > 0:
        d["brightness"] = uniform(-brightness, brightness)
    return d


def _select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    return torch.where(mask.view((-1,) + (1,) * (a.dim() - 1)), a, b)


def apply_augment(images: torch.Tensor, labels: torch.Tensor,
                  draws: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply the draws of :func:`draw_augment`: images (N, H, W, C)
    float, labels (N, H, W). A key missing from ``draws`` is an op that
    is off."""
    if "hflip" in draws:
        m = draws["hflip"]
        images = _select(m, images.flip(2), images)
        labels = _select(m, labels.flip(2), labels)
    if "vflip" in draws:
        m = draws["vflip"]
        images = _select(m, images.flip(1), images)
        labels = _select(m, labels.flip(1), labels)
    if "k" in draws:
        if images.shape[1] != images.shape[2]:
            raise ValueError(
                f"rot90 augmentation needs square tiles, got "
                f"{images.shape[1]}x{images.shape[2]}; pass rot90=False "
                "for rectangular chips")
        k = draws["k"]
        out_i, out_l = images, labels
        for j in (1, 2, 3):
            out_i = _select(k == j, torch.rot90(images, j, dims=(1, 2)),
                            out_i)
            out_l = _select(k == j, torch.rot90(labels, j, dims=(1, 2)),
                            out_l)
        images, labels = out_i, out_l
    if "invert" in draws:
        images = _select(draws["invert"], 1.0 - images, images)
    if "contrast" in draws:
        mean = images.mean(dim=(1, 2), keepdim=True)
        images = mean + (images - mean) * draws["contrast"]
    if "brightness" in draws:
        images = torch.clamp(images + draws["brightness"], 0.0, 1.0)
    return images, labels


def augment_pairs(images: torch.Tensor, labels: torch.Tensor,
                  generator: torch.Generator, hflip: bool = True,
                  vflip: bool = True, rot90: bool = True,
                  invert_prob: float = 0.0, brightness: float = 0.0,
                  contrast: float = 0.0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random dihedral and photometric augmentation: draws from
    ``generator``, then :func:`apply_augment`. Photometric knobs, per
    example: ``invert_prob`` (images on [0, 1]), ``brightness`` (additive
    U(-b, b), clipped to [0, 1]) and ``contrast`` (factor U(1 - c, 1 + c)
    around the per-example, per-channel mean)."""
    draws = draw_augment(generator, images.shape[0], hflip, vflip, rot90,
                         invert_prob, brightness, contrast,
                         device=images.device)
    return apply_augment(images, labels, draws)


def normalize(images: torch.Tensor, mean: torch.Tensor,
              std: torch.Tensor) -> torch.Tensor:
    """(x - mean) / std per channel."""
    return (images - mean) / std


def random_invert_pairs(images: torch.Tensor, labels: torch.Tensor,
                        prob: float = 0.5, max_value: float = 1.0,
                        generator: Optional[torch.Generator] = None,
                        flip: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-example intensity inversion ``max_value - x`` with probability
    ``prob``; labels unchanged. ``flip`` (n,) bool is the draw; without
    it, ``torch.rand(n) < prob`` from ``generator``."""
    if flip is None:
        if generator is None:
            raise ValueError("pass a generator or the flip draws")
        flip = torch.rand(images.shape[0], generator=generator,
                          device=images.device) < prob
    return _select(flip, max_value - images, images), labels
