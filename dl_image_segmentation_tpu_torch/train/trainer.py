"""U-Net trainer on one CUDA card: config, loss and mIoU, optax-equal
AdamW steps, scanned training from a device pool, evaluation,
checkpoints, and inference (predict, predict_probs).

A port of the JAX package's ``train/trainer.py`` for one device. The
entry points run on the CUDA card unless the caller passes
``device="cpu"``. Every forward and backward runs under
``_forward_flags`` (cuDNN benchmark off, and TF32 off at fp32), so a
training thread and a serving thread launch the same algorithms; the
train step also takes cuDNN's deterministic algorithms, so two runs of
the same steps end with the same parameters, as in the JAX package.
Inference runs in batch_size chunks padded as the server pads, so
``predict`` gives each image the server's class map.
Checkpoints are ``torch.save`` files of ``{"params", "opt_state",
"step"}`` (orbax checkpoints of the JAX package are not read).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import re
import threading
import time
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.convert import adamw_state_from_optax, unet_params_from_flax
from ..models.unet import UNet
from ..ops.augment import apply_augment, draw_augment
from ..records.tfrecord import check_local
from .optim import (AdamWState, adamw_init, adamw_update_,
                    clip_by_global_norm_, make_schedule)
from .pool import sample_batch

__all__ = ["CheckpointManager", "TrainConfig", "TrainState", "Trainer",
           "masked_miou", "masked_xent_loss", "normalize_images",
           "resolve_s2d"]


@dataclasses.dataclass
class TrainConfig:
    """The JAX package's TrainConfig: same fields, same defaults."""
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
    """The step, the model's float32 parameters by name (the live
    tensors) and the optimizer state."""
    step: int
    params: Dict[str, torch.Tensor]
    opt_state: AdamWState


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
    floats unchanged. The cast is the first op: torch.uint16 has few."""
    if images.dtype == torch.uint8:
        return images.to(torch.float32) / 255.0
    if images.dtype == torch.uint16:
        return images.to(torch.float32) / 65535.0
    if not images.dtype.is_floating_point:
        return images.to(torch.float32)
    return images


def masked_miou(pred: torch.Tensor, labels: torch.Tensor, num_classes: int,
                nodata: int) -> torch.Tensor:
    """Mean IoU over the classes present in prediction or labels,
    ignoring nodata pixels; pred and labels are class maps of one
    shape."""
    valid = labels != nodata
    safe = torch.where(valid, labels, 0)
    ious = []
    for c in range(num_classes):
        p = (pred == c) & valid
        t = (safe == c) & valid
        inter = (p & t).sum()
        union = (p | t).sum()
        ious.append(torch.where(union > 0, inter / union.clamp(min=1),
                                float("nan")))
    ious = torch.stack(ious)
    present = ~torch.isnan(ious)
    return (torch.where(present, ious, 0.0).sum()
            / present.sum().clamp(min=1))


def masked_xent_loss(logits: torch.Tensor, labels: torch.Tensor,
                     nodata: int,
                     class_weights: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax cross-entropy over the pixels whose label is not
    ``nodata``; logits (..., K). Returns (mean loss, accuracy over valid
    pixels), float32. With ``class_weights`` (K,) the loss is
    sum(w[label] * nll) / sum(w[label]); a weight of 0 removes a class.
    Accuracy stays unweighted."""
    valid = labels != nodata
    safe = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    denom = valid.sum().clamp(min=1)
    if class_weights is not None:
        w = torch.where(valid, class_weights[safe], 0.0)
        loss = -(w * ll).sum() / w.sum().clamp(min=1e-9)
    else:
        loss = -torch.where(valid, ll, 0.0).sum() / denom
    acc = (valid & (logits.argmax(-1) == safe)).sum() / denom
    return loss, acc


# cuDNN's switches are process-wide, while PyTorch keeps the algorithms
# that benchmark mode picks per thread: with benchmark on, a server's
# worker thread can run other algorithms than the caller of ``predict``,
# and its bf16 logits then differ in the last bits. So every forward and
# backward runs with benchmark off (cuDNN's heuristics give every thread
# the same choice) and, at fp32, with TF32 off; the lock keeps one thread
# from restoring the switches while another's work is being launched.
# The train step also asks cuDNN for deterministic algorithms: at fp32
# its default backward convs accumulate in an order that changes from
# run to run, so two runs of the same steps ended with other parameters.
_FORWARD_FLAGS = threading.Lock()


@contextlib.contextmanager
def _forward_flags(fp32: bool, deterministic: bool = False):
    """cuDNN benchmark off, TF32 off when ``fp32``, and cuDNN's
    deterministic algorithms when ``deterministic``, for the block; the
    switches are restored after it."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    with _FORWARD_FLAGS:
        saved = (cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32,
                 matmul.allow_tf32)
        cudnn.benchmark = False
        if deterministic:
            cudnn.deterministic = True
        if fp32:
            cudnn.allow_tf32 = matmul.allow_tf32 = False
        try:
            yield
        finally:
            (cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32,
             matmul.allow_tf32) = saved


_NOT_PORTED = {
    "model": "DeepLab and SegFormer are not ported yet: ROADMAP queue 1 "
             "item 7",
    "quantize": "int8 inference is not ported yet: ROADMAP queue 1 item 7 "
                "(models/quant.py)",
    "parallel": "model-axis, spatial and FSDP sharding are not ported "
                "yet: ROADMAP queue 1 item 8 (parallel/)",
    "remat": "activation rematerialisation is not ported yet: ROADMAP "
             "queue 1 item 1",
    "orbax": "reading the JAX package's orbax checkpoints is not ported "
             "yet: ROADMAP queue 1 item 1",
}


class CheckpointManager:
    """Rotating checkpoints in a local directory, one ``<step>.pt`` file
    per saved step; the newest ``keep`` are kept."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(check_local(directory))
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in (
            re.fullmatch(r"(\d+)\.pt", n) for n in os.listdir(self.directory))
            if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def prune(self) -> None:
        for step in self.all_steps()[:-self.keep]:
            os.unlink(self.path(step))


class Trainer:
    """Holds the model and its optimizer state on one device.

    ``Trainer(config, device=None)``: ``device=None`` is the CUDA card
    (raises without one), ``device="cpu"`` the plain CPU run. Weights
    are the seeded flax-scheme init (``config.seed``) until
    ``load_flax_params``, a checkpoint, or ``model.load_state_dict``
    replaces them."""

    def __init__(self, config: TrainConfig, device=None,
                 _variant: Optional[Tuple[int, int]] = None):
        # _variant: the (s2d, model_features) a checkpoint migration
        # rebuilds as (_try_other_s2d_variant); not a public knob
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
        if config.remat:
            raise NotImplementedError("remat=True: " + _NOT_PORTED["remat"])
        self._s2d_auto = config.s2d == 0 and _variant is None
        self.s2d, self.model_features = _variant or resolve_s2d(config)
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
        params = dict(self.model.named_parameters())
        self.state = TrainState(0, params, adamw_init(params))
        self.schedule = make_schedule(config)
        self._class_weights = (
            torch.tensor(config.class_weights, dtype=torch.float32,
                         device=self.device)
            if config.class_weights is not None else None)
        self.device_seconds = 0.0
        self.feed_seconds = 0.0
        self.wall_start = None
        self.examples_seen = 0
        self.scan_losses: List[float] = []

    # -- state --------------------------------------------------------------
    def load_flax_params(self, params: Mapping) -> "Trainer":
        """Load the JAX package's flax param tree (nested dicts of numpy
        arrays) into the model."""
        unet_params_from_flax(params, self.model)
        return self

    def load_optax_state(self, opt_state, step: Optional[int] = None
                         ) -> "Trainer":
        """Continue a run of the JAX package: its optax AdamW state as
        numpy arrays becomes this trainer's optimizer state; the step is
        ``step``, or the state's count."""
        self.state.opt_state = adamw_state_from_optax(
            opt_state, self.model, self.device)
        self.state.step = (self.state.opt_state.count if step is None
                           else int(step))
        return self

    # -- stepping -----------------------------------------------------------
    def place_batch(self, images, labels):
        """Host numpy batch -> (images, labels) tensors on the device:
        pinned and copied with ``non_blocking`` on the card."""
        def put(x):
            t = torch.from_numpy(np.ascontiguousarray(x))
            if self.device.type == "cuda":
                t = t.pin_memory()
            return t.to(self.device, non_blocking=True)
        return put(images), put(labels)

    def _step(self, images: torch.Tensor, labels: torch.Tensor):
        """Forward, backward and optimizer update on device tensors
        (images already scaled); (loss, accuracy) as device scalars, with
        no host sync."""
        st = self.state
        params = list(st.params.values())
        for p in params:
            p.grad = None
        # cuDNN reads the switches when each conv is launched, so the
        # lock is held until backward() has launched
        with _forward_flags(self.compute_dtype == torch.float32,
                            deterministic=True):
            self.model.train()
            logits = self.model(images.permute(0, 3, 1, 2))
            loss, acc = masked_xent_loss(logits.permute(0, 2, 3, 1), labels,
                                         self.config.label_nodata,
                                         self._class_weights)
            loss.backward()
        grads = [p.grad for p in params]
        if self.config.grad_clip_norm > 0:
            clip_by_global_norm_(grads, self.config.grad_clip_norm)
        opt = st.opt_state
        opt.count = adamw_update_(
            params, grads, list(opt.mu.values()), list(opt.nu.values()),
            opt.count, self.schedule(opt.count), self.config.weight_decay)
        st.step += 1
        return loss.detach(), acc

    def train_step_async(self, images, labels) -> Dict[str, torch.Tensor]:
        """One step without a host sync; returns the device metrics
        (read them only when reporting)."""
        if isinstance(images, np.ndarray):
            images, labels = self.place_batch(images, labels)
        loss, acc = self._step(normalize_images(images), labels)
        self.examples_seen += images.shape[0]
        return {"loss": loss, "accuracy": acc}

    def train_step(self, images, labels) -> Dict[str, float]:
        """One step on a placed (or host numpy) batch; waits for it."""
        if self.wall_start is None:
            self.wall_start = time.perf_counter()
        t0 = time.perf_counter()
        metrics = self.train_step_async(images, labels)
        out = {k: float(v) for k, v in metrics.items()}
        self.device_seconds += time.perf_counter() - t0
        return out

    def train_scanned(self, pool, total_steps: int,
                      steps_per_dispatch: int = 20,
                      refresh_feed: Optional[Iterator] = None,
                      refresh_every: int = 1, seed: int = 0,
                      augment: bool = False,
                      draws: Optional[List[dict]] = None
                      ) -> Dict[str, float]:
        """Train from a DeviceDataPool, K = ``steps_per_dispatch`` steps
        per dispatch: batch sampling, augmentation, forward, backward and
        update are all launched on the device with no host sync, and the
        K losses are read once after the dispatch.

        Each step draws the batch's pool indices (and, with ``augment``,
        the augmentation's draws) from a device ``torch.Generator``
        seeded with ``seed``; ``draws`` replaces them with given draws,
        one ``{"idx": (B,) indices, "augment": draw_augment's dict}`` per
        step. Every step's loss is appended to ``self.scan_losses``.
        ``refresh_feed`` yields (images, labels) host batches that
        replace a slice of the pool every ``refresh_every`` dispatches,
        while the dispatch runs. Returns the last step's loss and
        accuracy with ``throughput_stats``."""
        cfg = self.config
        if self.wall_start is None:
            self.wall_start = time.perf_counter()
        if total_steps <= 0:
            return {"loss": float("nan"), "accuracy": float("nan"),
                    **self.throughput_stats()}
        gen = torch.Generator(device=self.device).manual_seed(seed)
        geo = cfg.augment_geometric
        done = offset = dispatch = 0
        while done < total_steps:
            k = min(steps_per_dispatch, total_steps - done)
            t0 = time.perf_counter()
            losses, accs = [], []
            for i in range(k):
                if draws is not None:
                    idx = draws[done + i]["idx"].to(self.device)
                    aug = draws[done + i].get("augment")
                else:
                    idx = torch.randint(0, pool.size, (cfg.batch_size,),
                                        generator=gen, device=self.device)
                    aug = (draw_augment(
                        gen, cfg.batch_size, geo, geo, geo,
                        cfg.augment_invert, cfg.augment_brightness,
                        cfg.augment_contrast) if augment else None)
                images, labels = sample_batch(pool.images, pool.labels, idx)
                images = normalize_images(images)
                if augment:
                    images, labels = apply_augment(
                        images, labels,
                        {n: t.to(self.device) for n, t in aug.items()})
                loss, acc = self._step(images, labels)
                losses.append(loss)
                accs.append(acc)
            if refresh_feed is not None and \
                    dispatch % max(1, refresh_every) == 0:
                # host parse overlaps the dispatch in flight; its time is
                # kept apart for duty_cycle_lower (throughput_stats)
                tr0 = time.perf_counter()
                try:
                    imgs, lbls = next(refresh_feed)
                    pool.refresh(imgs, lbls, offset)
                    offset = (offset + len(imgs)) % max(
                        1, pool.size - len(imgs) + 1)
                except StopIteration:
                    refresh_feed = None
                self.feed_seconds += time.perf_counter() - tr0
            # the dispatch's one sync
            hist = torch.stack([torch.stack(losses), torch.stack(accs)]).cpu()
            self.device_seconds += time.perf_counter() - t0
            self.scan_losses.extend(hist[0].tolist())
            done += k
            dispatch += 1
            self.examples_seen += k * cfg.batch_size
        return {"loss": float(hist[0, -1]), "accuracy": float(hist[1, -1]),
                **self.throughput_stats()}

    # -- evaluation / inference ---------------------------------------------
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
            self.model.eval()
            return self.model(x).permute(0, 2, 3, 1)

    def _chunked_logits(self, images):
        """Logits of ``images`` in batch_size chunks, the last padded with
        zeros as the server pads its dispatches: cuDNN picks its engine
        by shape, so an image's bits depend on the batch's size, and
        predict must give the class map the server gives for the same
        image. Yields the logits of each chunk's real images."""
        x = self._to_device(images)
        bs = int(self.config.batch_size)
        for i in range(0, x.shape[0], bs):
            chunk = x[i:i + bs]
            n = chunk.shape[0]
            if n < bs:
                chunk = torch.cat([chunk, chunk.new_zeros(
                    (bs - n,) + tuple(chunk.shape[1:]))])
            yield self.logits(chunk)[:n]

    def predict_both(self, images) -> Tuple[np.ndarray, np.ndarray]:
        """(class map int32 (N, H, W), probabilities float32 (N, H, W,
        num_classes)) from the same forwards; the class map is
        :meth:`predict`'s."""
        classes, probs = [], []
        for logits in self._chunked_logits(images):
            classes.append(torch.argmax(logits, dim=-1).to(torch.int32))
            probs.append(torch.softmax(logits.float(), dim=-1))
        return (torch.cat(classes).cpu().numpy(),
                torch.cat(probs).cpu().numpy())

    def predict_probs(self, images) -> np.ndarray:
        """(N, H, W, C) host batch -> (N, H, W, num_classes) float32
        softmax probabilities, in padded batch_size chunks."""
        return torch.cat([torch.softmax(lg.float(), dim=-1)
                          for lg in self._chunked_logits(images)]
                         ).cpu().numpy()

    def predict(self, images) -> np.ndarray:
        """(N, H, W, C) host batch -> (N, H, W) int32 class map (the
        first maximum wins, as in jnp.argmax), in padded batch_size
        chunks: the map the server gives each image."""
        return torch.cat([torch.argmax(lg, dim=-1).to(torch.int32)
                          for lg in self._chunked_logits(images)]
                         ).cpu().numpy()

    def _eval_sums(self, images, labels):
        """One batch's sums: loss over valid pixels, correct count,
        valid count and the K x K confusion matrix cm[true, pred]."""
        K = self.config.num_classes
        logits = self.logits(images)
        with torch.inference_mode():
            valid = labels != self.config.label_nodata
            safe = torch.where(valid, labels, 0).long()
            logp = torch.log_softmax(logits.float(), dim=-1)
            ll = logp.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
            loss_sum = -torch.where(valid, ll, 0.0).sum()
            pred = logits.argmax(-1)
            correct = (valid & (pred == safe)).sum()
            # invalid pixels (and labels past K) go to an overflow bin that
            # is dropped; index_add_, unlike bincount, needs no host sync
            flat = torch.where(valid, safe * K + pred, K * K).reshape(-1)
            cm = torch.zeros(K * K + 1, dtype=torch.int64,
                             device=flat.device).index_add_(
                0, flat.clamp(max=K * K), torch.ones_like(flat))
            return loss_sum, correct, valid.sum(), cm[:K * K].reshape(K, K)

    def evaluate(self, batches, max_batches: Optional[int] = None
                 ) -> Dict[str, float]:
        """Dataset-level loss, accuracy, mIoU and per-class IoU and F1
        over an iterator of (images, labels): the sums and the confusion
        matrix accumulate on the device over all batches and are read
        once. (The JAX package pads each host batch to its mesh's data
        axis with nodata labels; on one device that is a no-op.)"""
        K = self.config.num_classes
        cm = torch.zeros((K, K), dtype=torch.int64, device=self.device)
        sums = torch.zeros(3, dtype=torch.float64, device=self.device)
        n_batches = 0
        for i, (images, labels) in enumerate(batches):
            if max_batches is not None and i >= max_batches:
                break
            if isinstance(images, np.ndarray):
                images, labels = self.place_batch(images, labels)
            ls, cor, nv, c = self._eval_sums(images, labels)
            # float64 like the JAX package's host sum of float32 losses
            sums += torch.stack([ls.double(), cor.double(), nv.double()])
            cm += c
            n_batches += 1
        loss_sum, correct, n_valid = sums.tolist()
        total_cm = cm.cpu().numpy()
        tp = np.diag(total_cm).astype(np.float64)
        fp = total_cm.sum(axis=0) - tp  # predicted k, true != k
        fn = total_cm.sum(axis=1) - tp  # true k, predicted != k
        union = tp + fp + fn
        present = union > 0
        iou = np.where(present, tp / np.maximum(union, 1), np.nan)
        f1_den = 2 * tp + fp + fn
        f1 = np.where(f1_den > 0, 2 * tp / np.maximum(f1_den, 1), np.nan)
        miou = float(iou[present].mean()) if present.any() else float("nan")
        denom = max(n_valid, 1)
        # per-class entries are None for classes absent from both
        # predictions and labels
        return {"loss": loss_sum / denom, "accuracy": correct / denom,
                "miou": miou, "batches": n_batches,
                "per_class_iou": [float(v) if np.isfinite(v) else None
                                  for v in iou],
                "per_class_f1": [float(v) if np.isfinite(v) else None
                                 for v in f1]}

    # -- metrics --------------------------------------------------------------
    def throughput_stats(self) -> Dict[str, float]:
        """duty_cycle counts each dispatch from its launch to its result,
        so host feed work overlapped with a dispatch in flight is inside
        it: an upper bound on device busy-ness. duty_cycle_lower
        subtracts all feed time (no overlap at all); the true duty lies
        between the two."""
        wall = (time.perf_counter() - self.wall_start
                if self.wall_start else 0.0)
        return {
            "examples_per_sec": self.examples_seen / wall if wall else 0.0,
            "duty_cycle": self.device_seconds / wall if wall else 0.0,
            "duty_cycle_lower": (
                max(0.0, self.device_seconds - self.feed_seconds) / wall
                if wall else 0.0),
            "wall_seconds": wall,
            "device_seconds": self.device_seconds,
            "feed_seconds": self.feed_seconds,
        }

    # -- checkpoints ----------------------------------------------------------
    def _payload(self) -> dict:
        st = self.state

        def cpu(d):
            return {n: t.detach().cpu() for n, t in d.items()}
        return {"params": cpu(st.params),
                "opt_state": {"count": st.opt_state.count,
                              "mu": cpu(st.opt_state.mu),
                              "nu": cpu(st.opt_state.nu)},
                "step": st.step}

    def _load_payload(self, payload: dict) -> None:
        st = self.state
        trees = [(payload["params"], st.params),
                 (payload["opt_state"]["mu"], st.opt_state.mu),
                 (payload["opt_state"]["nu"], st.opt_state.nu)]
        for src, dst in trees:
            bad = sorted(n for n in set(src) | set(dst)
                         if n not in src or n not in dst
                         or src[n].shape != dst[n].shape)
            if bad:
                raise ValueError(f"checkpoint does not match the model's "
                                 f"parameters: {bad[:4]}")
        with torch.no_grad():
            for src, dst in trees:
                for n, t in dst.items():
                    t.copy_(src[n])
        st.opt_state.count = int(payload["opt_state"]["count"])
        st.step = int(payload["step"])

    def save_checkpoint(self, path: str) -> None:
        """``torch.save`` of {"params", "opt_state", "step"} to ``path``,
        written to ``path.tmp`` and renamed into place."""
        path = os.path.abspath(check_local(path))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp"
        torch.save(self._payload(), tmp)
        os.replace(tmp, path)

    def restore_checkpoint(self, path: str) -> None:
        """Load a checkpoint of :meth:`save_checkpoint`; under s2d AUTO a
        checkpoint of another reachable tree rebuilds this trainer as
        that tree (``_try_other_s2d_variant``). A directory (an orbax
        checkpoint of the JAX package) raises NotImplementedError."""
        if os.path.isdir(check_local(path)):
            raise NotImplementedError(f"{path} is a directory: "
                                      + _NOT_PORTED["orbax"])
        payload = torch.load(check_local(path), map_location="cpu",
                             weights_only=True)
        try:
            self._load_payload(payload)
        except ValueError as e:
            if not self._try_other_s2d_variant(e):
                raise
            self.restore_checkpoint(path)

    def checkpoint_manager(self, directory: str, keep: int = 3
                           ) -> CheckpointManager:
        """Rotating checkpoints (the newest ``keep``) for save_managed and
        restore_latest."""
        return CheckpointManager(directory, keep)

    def save_managed(self, manager: CheckpointManager) -> int:
        step = int(self.state.step)
        self.save_checkpoint(manager.path(step))
        manager.prune()
        return step

    def restore_latest(self, manager: CheckpointManager) -> Optional[int]:
        """Restore the newest managed checkpoint; None if there is none."""
        step = manager.latest_step()
        if step is None:
            return None
        self.restore_checkpoint(manager.path(step))
        return step

    def _try_other_s2d_variant(self, err: Exception) -> bool:
        """Checkpoint migration under s2d AUTO: three trees are reachable
        for a unet config of base_features bf -- (s2d 1, width bf)
        classic, (s2d 2, width 2 bf) the auto packing, and (s2d 2, width
        bf) an explicit s2d 2 run. After a restore failed on the tree,
        rebuild this trainer as the next untried variant and return True
        so the caller retries; an explicit s2d never switches."""
        cands = getattr(self, "_s2d_untried", None)
        if cands is None:
            if not self._s2d_auto:
                return False
            bf = self.config.base_features
            variants = [(1, bf)]
            if self.config.image_size % 2 == 0:
                variants += [(2, 2 * bf), (2, bf)]
            cands = [v for v in variants
                     if v != (self.s2d, self.model_features)]
        if not cands:
            return False
        (s2d, feats), rest = cands[0], cands[1:]
        print(f"checkpoint does not match the s2d={self.s2d}/"
              f"features={self.model_features} parameter tree "
              f"({type(err).__name__}); retrying as the s2d={s2d}/"
              f"features={feats} variant")
        self.__init__(self.config, device=self.device, _variant=(s2d, feats))
        self._s2d_untried = rest
        return True
