"""U-Net trainer, inference part: config, input scaling, s2d resolution,
predict and predict_probs on one CUDA card.

A port of the JAX package's ``train/trainer.py`` for serving. Training
(loss, optimizer, steps, checkpoints) is ROADMAP queue 1 item 4 and not
here yet: ``Trainer.state.step`` stays 0, and weights come from
``load_flax_params`` (a flax param tree as numpy arrays) or from the
seeded init. The entry points run on the CUDA card unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.convert import unet_params_from_flax
from ..models.unet import UNet

__all__ = ["TrainConfig", "TrainState", "Trainer", "normalize_images",
           "resolve_s2d"]


@dataclasses.dataclass
class TrainConfig:
    """The JAX package's TrainConfig: same fields, same defaults. The
    port reads the model, precision, s2d, batch and image fields; the
    training fields wait for the training slice."""
    num_classes: int = 2
    in_channels: int = 3
    base_features: int = 32
    levels: int = 4
    image_size: int = 256
    batch_size: int = 32
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    label_nodata: int = 255
    n_model: int = 1
    spatial: bool = False
    fsdp: bool = False
    remat: bool = False
    seed: int = 0
    model: str = "unet"  # "unet" | "deeplab" | "segformer"
    # "bf16": bfloat16 convs with float32 params and a float32 head;
    # "fp32": float32 everywhere, TF32 off
    precision: str = "bf16"
    quantize: str = "none"
    # 0 = AUTO (see resolve_s2d), 1 = classic, >1 = explicit packing
    s2d: int = 0
    schedule: str = "constant"
    warmup_steps: int = 0
    total_steps: int = 10000
    grad_clip_norm: float = 0.0
    class_weights: Optional[Tuple[float, ...]] = None
    augment_invert: float = 0.0
    augment_brightness: float = 0.0
    augment_contrast: float = 0.0
    augment_geometric: bool = True


@dataclasses.dataclass
class TrainState:
    step: int = 0


def resolve_s2d(config: TrainConfig) -> Tuple[int, int]:
    """(s2d, model_features) for ``config``. AUTO (s2d=0) picks the
    equal-FLOPs packing -- s2d=2 with the width doubled -- for a U-Net
    with base_features <= 48 and an even image_size >= 128, the classic
    tree otherwise; an explicit s2d is taken as-is."""
    if config.s2d == 0:
        if (config.model == "unet" and config.base_features <= 48
                and config.image_size >= 128
                and config.image_size % 2 == 0):
            return 2, config.base_features * 2
        return 1, config.base_features
    return config.s2d, config.base_features


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """uint8 / 255, uint16 / 65535, other integers cast to float32,
    floats unchanged."""
    if images.dtype == torch.uint8:
        return images.to(torch.float32) / 255.0
    if images.dtype == torch.uint16:
        return images.to(torch.float32) / 65535.0
    if not images.dtype.is_floating_point:
        return images.to(torch.float32)
    return images


# cuDNN's switches are process-wide, while PyTorch keeps the algorithms
# that benchmark mode picks per thread: with benchmark on, a server's
# worker thread can run other algorithms than the caller of ``predict``,
# and its bf16 logits then differ in the last bits. So every forward runs
# with benchmark off (cuDNN's heuristics give every thread the same
# choice) and, at fp32, with TF32 off; the lock keeps one thread from
# restoring the switches while another's forward is being launched.
_FORWARD_FLAGS = threading.Lock()


@contextlib.contextmanager
def _forward_flags(fp32: bool):
    """cuDNN benchmark off, and TF32 off when ``fp32``, for the block;
    the switches are restored after it."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    with _FORWARD_FLAGS:
        saved = (cudnn.benchmark, cudnn.allow_tf32, matmul.allow_tf32)
        cudnn.benchmark = False
        if fp32:
            cudnn.allow_tf32 = matmul.allow_tf32 = False
        try:
            yield
        finally:
            cudnn.benchmark, cudnn.allow_tf32, matmul.allow_tf32 = saved


_NOT_PORTED = {
    "model": "DeepLab and SegFormer are not ported yet: ROADMAP queue 1 "
             "item 7",
    "quantize": "int8 inference is not ported yet: ROADMAP queue 1 item 7 "
                "(models/quant.py)",
    "parallel": "model-axis, spatial and FSDP sharding are not ported "
                "yet: ROADMAP queue 1 item 8 (parallel/)",
}


class Trainer:
    """Holds the model on one device and runs inference on host batches.

    ``Trainer(config, device=None)``: ``device=None`` is the CUDA card
    (raises without one), ``device="cpu"`` the plain CPU run. Weights
    are the seeded flax-scheme init (``config.seed``) until
    ``load_flax_params`` or ``model.load_state_dict`` replaces them."""

    def __init__(self, config: TrainConfig, device=None):
        self.config = config
        if config.precision == "bf16":
            self.compute_dtype = torch.bfloat16
        elif config.precision == "fp32":
            self.compute_dtype = torch.float32
        else:
            raise ValueError(f"unknown precision {config.precision!r} "
                             "(expected 'bf16' or 'fp32')")
        if (config.class_weights is not None
                and len(config.class_weights) != config.num_classes):
            raise ValueError(
                f"class_weights has {len(config.class_weights)} entries "
                f"for {config.num_classes} classes")
        if config.model in ("deeplab", "segformer"):
            raise NotImplementedError(f"model={config.model!r}: "
                                      + _NOT_PORTED["model"])
        if config.model != "unet":
            raise ValueError(f"unknown model {config.model!r} "
                             "(expected 'unet', 'deeplab' or "
                             "'segformer')")
        if config.quantize in ("int8", "int8-static"):
            raise NotImplementedError(f"quantize={config.quantize!r}: "
                                      + _NOT_PORTED["quantize"])
        if config.quantize != "none":
            raise ValueError(f"unknown quantize {config.quantize!r} "
                             "(expected 'none', 'int8' or "
                             "'int8-static')")
        if config.n_model > 1 or config.spatial or config.fsdp:
            raise NotImplementedError(
                f"n_model={config.n_model}, spatial={config.spatial}, "
                f"fsdp={config.fsdp}: " + _NOT_PORTED["parallel"])
        self.s2d, self.model_features = resolve_s2d(config)
        if self.s2d > 1 and config.image_size % self.s2d:
            raise ValueError(f"image_size {config.image_size} must divide "
                             f"by s2d {self.s2d}")
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(config.seed)
        model = UNet(num_classes=config.num_classes,
                     base_features=self.model_features,
                     levels=config.levels, dtype=self.compute_dtype,
                     s2d=self.s2d, in_channels=config.in_channels,
                     generator=gen)
        self.model = model.to(self.device).eval()
        self.state = TrainState()

    def load_flax_params(self, params: Mapping) -> "Trainer":
        """Load the JAX package's flax param tree (nested dicts of numpy
        arrays) into the model."""
        unet_params_from_flax(params, self.model)
        return self

    def _to_device(self, images) -> torch.Tensor:
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(np.ascontiguousarray(images))
        return images.to(self.device, non_blocking=True)

    def logits(self, images: torch.Tensor) -> torch.Tensor:
        """(N, H, W, C) images on the model's device -> (N, H, W,
        num_classes) float32 logits on the device, the same bits in
        every thread (see ``_forward_flags``)."""
        x = normalize_images(images).permute(0, 3, 1, 2)
        with torch.inference_mode(), _forward_flags(
                self.compute_dtype == torch.float32):
            return self.model(x).permute(0, 2, 3, 1)

    def predict_both(self, images) -> Tuple[np.ndarray, np.ndarray]:
        """(class map int32 (N, H, W), probabilities float32 (N, H, W,
        num_classes)) from one forward; the class map is
        :meth:`predict`'s."""
        logits = self.logits(self._to_device(images))
        classes = torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits.float(), dim=-1)
        return classes.cpu().numpy(), probs.cpu().numpy()

    def predict_probs(self, images) -> np.ndarray:
        """(N, H, W, C) host batch -> (N, H, W, num_classes) float32
        softmax probabilities."""
        logits = self.logits(self._to_device(images))
        return torch.softmax(logits.float(), dim=-1).cpu().numpy()

    def predict(self, images) -> np.ndarray:
        """(N, H, W, C) host batch -> (N, H, W) int32 class map (the
        first maximum wins, as in jnp.argmax)."""
        logits = self.logits(self._to_device(images))
        return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()

