"""Trainer on one CUDA card for the U-Net, DeepLab-lite and
SegFormer-lite: config, loss and mIoU, optax-equal AdamW steps, scanned
training from a device pool, evaluation, checkpoints, and inference
(predict, predict_probs), float or int8 (the U-Net's ``quantize="int8"``
and calibrated ``"int8-static"``, on the float model's parameters).

A port of the JAX package's ``train/trainer.py``. The entry points run
on the CUDA card unless the caller passes ``device="cpu"``. In a
``torch.distributed`` world (``parallel/``) the trainer runs on a
("data", "model") mesh of the world's ranks, one device each, in the
JAX package's four regimes: data parallel, channel tensor parallel
(``n_model > 1``), spatial (``spatial=True``: the image height over
"model" in bands of any height, every family) and FSDP (``fsdp=True``:
large kernels and their Adam moments stored sharded over "data"), each
computing what the one-process step computes, and int8 inference on
each. Every rank passes the same global batches (or, ``place_rows``,
its rows of them); each keeps its rows (and band). The loss is the
global masked mean: the valid-pixel count is summed over the ranks that
hold other pixels, and each rank's gradient of its own pixels is summed
after the backward.
Every forward and backward runs under ``_forward_flags`` (cuDNN
benchmark off, and TF32 off at fp32), so a training thread and a serving
thread launch the same algorithms; the
train step also takes cuDNN's deterministic algorithms, so two runs of
the same steps end with the same parameters, as in the JAX package.
``remat=True`` recomputes the forward in the backward
(``torch.utils.checkpoint``), under the same switches.
Inference runs in batch_size chunks padded as the server pads, so
``predict`` gives each image the server's class map.
Checkpoints are ``torch.save`` files of ``{"params", "opt_state",
"step", "model"}``, local or on gs:// / s3://; the JAX package's orbax
checkpoints, single or in a managed directory, restore too
(``train/orbax.py``), and ``orbax_tree`` gives the state in their form.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import itertools
import os
import re
import threading
import time
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint as _remat

from .. import storage
from ..device import resolve_device
from ..models.convert import (_walk, adamw_state_from_optax,
                              flax_from_tensors, optax_from_adamw,
                              params_from_flax, quant_from_flax,
                              tensors_from_flax)
from ..models.deeplab import DeepLabLite
from ..models.quant import Int8Conv
from ..models.segformer import SegFormerLite
from ..models.unet import UNet, share_parameters
from ..ops.augment import apply_augment, draw_augment
from ..parallel.distributed import is_primary
from ..parallel.sharding import make_mesh, shard_batch_local, shard_slice
from ..parallel.spmd import (GradSync, all_gather, all_reduce, full_tensor,
                             local_shard, norm_group, shard_model,
                             wrap_layers)
from ..utils.profiling import duty
from . import orbax
from .optim import (AdamWState, adamw_init, adamw_update_,
                    clip_by_global_norm_, make_schedule)

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
                     class_weights: Optional[torch.Tensor] = None,
                     reduce=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax cross-entropy over the pixels whose label is not
    ``nodata``; logits (..., K). Returns (mean loss, accuracy over valid
    pixels), float32. With ``class_weights`` (K,) the loss is
    sum(w[label] * nll) / sum(w[label]); a weight of 0 removes a class.
    Accuracy stays unweighted. ``reduce`` sums a count over the ranks
    that hold the batch's other pixels: the loss is then this rank's
    numerator over the global denominator (the global mean's share of
    this rank), and the accuracy global."""
    valid = labels != nodata
    safe = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    denom = valid.sum()
    correct = (valid & (logits.argmax(-1) == safe)).sum()
    if reduce is not None:
        denom, correct = reduce(denom), reduce(correct)
    denom = denom.clamp(min=1)
    if class_weights is not None:
        w = torch.where(valid, class_weights[safe], 0.0)
        wsum = w.sum() if reduce is None else reduce(w.sum())
        loss = -(w * ll).sum() / wsum.clamp(min=1e-9)
    else:
        loss = -torch.where(valid, ll, 0.0).sum() / denom
    acc = correct / denom
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


def _step_layout(x: torch.Tensor) -> torch.Tensor:
    """The (N, C, H, W) view of an NHWC batch in the layout in which a
    train step's CPU convs sum precisely: oneDNN's take it contiguous
    (channels-last, its backward put a U-Net's first gradient norm 2.4e-5
    off a float64 step; contiguous, 2e-7), torch's native ones keep the
    view's channels-last strides (contiguous, 1.7e-5 off; channels-last,
    1e-7). The card takes the view as it is."""
    if x.device.type == "cpu" and torch.backends.mkldnn.is_available() \
            and torch.backends.mkldnn.enabled:
        return x.contiguous()
    return x


class CheckpointManager:
    """Rotating checkpoints in a directory, one ``<step>.pt`` file per
    saved step; the newest ``keep`` are kept. The steps of the JAX
    package's orbax ``CheckpointManager`` in the same directory
    (``<step>/default/``) count as steps too, so a run resumes from the
    newest of either kind; they are never pruned or deleted here.

    A gs:// or s3:// directory is mirrored through a local staging
    directory keyed by the URI's hash, as the JAX package mirrors its
    orbax trees: the remote steps are downloaded before the manager
    opens, as an exact mirror (a stale staging directory left by an
    earlier run at the same URI must not fabricate a resume point);
    ``sync`` uploads every new step file and deletes remotely the steps
    pruned here."""

    def __init__(self, directory: str, keep: int = 3):
        self.keep = keep
        self.remote: Optional[str] = None
        if storage.is_remote(directory):
            import hashlib
            import tempfile
            self.remote = directory.rstrip("/")
            self.directory = os.path.join(
                tempfile.gettempdir(), "dlseg-torch-ckpt-mirror",
                hashlib.sha1(self.remote.encode()).hexdigest()[:16])
            os.makedirs(self.directory, exist_ok=True)
            storage.download_dir(self.remote, self.directory,
                                 delete_extras=True)
        else:
            self.directory = os.path.abspath(directory)
            os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        """Where a new save of ``step`` goes."""
        return os.path.join(self.directory, f"{step}.pt")

    def restore_path(self, step: int) -> str:
        """The checkpoint of ``step``: its ``.pt`` file, else its orbax
        step."""
        if os.path.isfile(self.path(step)):
            return self.path(step)
        return orbax.step_path(self.directory, step)

    def _pt_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in (
            re.fullmatch(r"(\d+)\.pt", n) for n in os.listdir(self.directory))
            if m)

    def all_steps(self) -> List[int]:
        return sorted(set(self._pt_steps())
                      | set(orbax.all_steps(self.directory)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def prune(self) -> None:
        for step in self._pt_steps()[:-self.keep]:
            os.unlink(self.path(step))

    def sync(self) -> None:
        """Make the remote directory hold this directory's step files:
        upload the new ones, delete the pruned ones (a no-op for a
        local directory). Step files are write-once, so presence is
        enough of a freshness check."""
        if self.remote is None:
            return
        remote = set(storage.listdir(self.remote))
        local = {f"{s}.pt" for s in self._pt_steps()}
        for name in sorted(local - remote):
            storage.upload_file(os.path.join(self.directory, name),
                                storage.join(self.remote, name))
        for name in sorted(remote - local):
            if re.fullmatch(r"\d+\.pt", name):
                storage.unlink(storage.join(self.remote, name))


class Trainer:
    """Holds the model and its optimizer state on this rank's device.

    ``Trainer(config, device=None, mesh=None)``: ``device=None`` is the
    rank's CUDA card (raises without one), ``device="cpu"`` the plain
    CPU run; ``mesh=None`` is ``make_mesh(n_model=config.n_model)`` over
    the world, or the one device outside a world. Weights are the
    seeded flax-scheme init (``config.seed``, the same on every rank)
    until ``load_flax_params``, a checkpoint, or
    ``model.load_state_dict`` replaces them; on a mesh each parameter
    the sharding rule shards holds this rank's shard
    (``self.shardings``), and its Adam moments follow. ``model`` trains;
    ``infer_model`` predicts and evaluates: the model itself, or with
    ``quantize`` its int8 twin, which holds the same parameter tensors
    (and, for ``int8-static``, the calibrated ``act_amax`` buffers)."""

    def __init__(self, config: TrainConfig, device=None, mesh=None,
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
        if config.model not in ("unet", "deeplab", "segformer"):
            raise ValueError(f"unknown model {config.model!r} "
                             "(expected 'unet', 'deeplab' or "
                             "'segformer')")
        if config.quantize not in ("none", "int8", "int8-static"):
            raise ValueError(f"unknown quantize {config.quantize!r} "
                             "(expected 'none', 'int8' or "
                             "'int8-static')")
        if config.quantize != "none" and config.model != "unet":
            raise ValueError(
                f"quantize={config.quantize!r} currently supports "
                f"model='unet' only (got {config.model!r})")
        self._s2d_auto = config.s2d == 0 and _variant is None
        self.s2d, self.model_features = _variant or resolve_s2d(config)
        if self.s2d > 1 and config.model != "unet":
            raise ValueError(f"s2d>1 currently supports model='unet' only "
                             f"(got {config.model!r})")
        if self.s2d > 1 and config.image_size % self.s2d:
            raise ValueError(f"image_size {config.image_size} must divide "
                             f"by s2d {self.s2d}")
        self.mesh = mesh if mesh is not None else make_mesh(
            n_model=config.n_model, device=device)
        self.device = (self.mesh.device if device is None
                       else resolve_device(device))
        self._spatial = config.spatial and self.mesh.shape["model"] > 1
        if self._spatial and config.image_size % self.mesh.shape["model"]:
            raise ValueError(
                f"spatial=True: image_size {config.image_size} must divide "
                f"by n_model {self.mesh.shape['model']} (the JAX package's "
                "TrainConfig rule: the image height is split into equal "
                "bands)")
        model = self._build(False)
        # the full-shape model (on the meta device in a world) through
        # which flax trees and checkpoints map to parameter names
        self._template = model
        self.shardings = None
        if self.mesh.size > 1:
            self._template = copy.deepcopy(model).to("meta")
            self.shardings = shard_model(model, self.mesh, config)
        self.model = model.to(self.device).eval()
        self.infer_model = self.model
        if config.quantize != "none":
            # the int8 twin computes on the float model's parameter
            # tensors: a train step or a checkpoint changes what it
            # quantizes, and a float checkpoint serves quantized as is;
            # on a mesh it runs on the same shards through wrappers of
            # its own
            twin = self._build("static" if config.quantize == "int8-static"
                               else True)
            self.infer_model = share_parameters(self.model, twin).to(
                self.device).eval()
            if self.shardings is not None:
                wrap_layers(self.infer_model, self.mesh, config,
                            self.shardings)
        self._calibrated = False
        params = dict(self.model.named_parameters())
        self.state = TrainState(0, params, adamw_init(params))
        self._grad_sync = self._norm_groups = self._loss_group = None
        if self.shardings is not None:
            self._grad_sync = GradSync(self.mesh, self.shardings,
                                       self._spatial)
            groups = [norm_group(self.shardings[n]) for n in params]
            if any(g is not None for g in groups):
                self._norm_groups = groups
            # the ranks whose pixels are the batch's others
            self._loss_group = self.mesh.group(
                "world" if self._spatial else "data")
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
        # the last step's global gradient norm before clipping (a device
        # scalar; None without clipping). The clipped gradients stay in
        # each parameter's .grad until the next step
        self.grad_norm: Optional[torch.Tensor] = None

    def _build(self, quant):
        """The config's model on the CPU, seeded init (``quant``: the
        U-Net's int8 mode)."""
        cfg = self.config
        kw = dict(num_classes=cfg.num_classes, dtype=self.compute_dtype,
                  in_channels=cfg.in_channels,
                  generator=torch.Generator().manual_seed(cfg.seed))
        if cfg.model == "deeplab":
            return DeepLabLite(base_features=cfg.base_features, **kw)
        if cfg.model == "segformer":
            return SegFormerLite(base_features=cfg.base_features, **kw)
        return UNet(base_features=self.model_features, levels=cfg.levels,
                    s2d=self.s2d, quant=quant, **kw)

    # -- state --------------------------------------------------------------
    def load_flax_params(self, params: Mapping) -> "Trainer":
        """Load the JAX package's flax param tree (nested dicts of numpy
        arrays) into the model (each rank its shards)."""
        if self.shardings is None:
            params_from_flax(params, self.model)
            return self
        full = tensors_from_flax(params, self._template)
        with torch.no_grad():
            for n, t in self.state.params.items():
                t.copy_(self._local(n, full[n]))
        return self

    def load_flax_quant(self, quant: Mapping) -> "Trainer":
        """Load the JAX package's ``"quant"`` collection (calibrated
        ``act_amax`` per int8 conv, numpy arrays) into the int8-static
        model; it then counts as calibrated."""
        quant_from_flax(quant, self.infer_model)
        self._calibrated = True
        return self

    def load_optax_state(self, opt_state, step: Optional[int] = None
                         ) -> "Trainer":
        """Continue a run of the JAX package: its optax AdamW state as
        numpy arrays becomes this trainer's optimizer state; the step is
        ``step``, or the state's count."""
        if self.shardings is None:
            self.state.opt_state = adamw_state_from_optax(
                opt_state, self.model, self.device)
        else:
            full = adamw_state_from_optax(opt_state, self._template)
            self.state.opt_state = type(full)(
                full.count,
                *({n: self._local(n, t).to(self.device).contiguous()
                   for n, t in d.items()} for d in (full.mu, full.nu)))
        self.state.step = (self.state.opt_state.count if step is None
                           else int(step))
        return self

    # -- stepping -----------------------------------------------------------
    def place_batch(self, images, labels):
        """Host numpy batch -> (images, labels) tensors on the device:
        this rank's rows (and, spatial, its band of image rows) of the
        global batch, pinned and copied with ``non_blocking`` on the
        card."""
        return shard_batch_local(self.mesh, (images, labels),
                                 spatial=self._spatial)

    def place_rows(self, images, labels):
        """:meth:`place_batch` of a host batch that holds this rank's
        data rows already (a ``TFRecordFeed`` with ``rows``)."""
        return shard_batch_local(self.mesh, (images, labels),
                                 spatial=self._spatial, local_rows=True)

    def data_rows(self, batch_size: int) -> Optional[Tuple[int, int]]:
        """The rows [lo, hi) of a global batch that this rank holds, for
        a feed that decodes only them; None outside a world with more
        than one data rank, or for a batch that does not divide by it."""
        nd = self.mesh.shape["data"]
        if nd == 1 or batch_size % nd:
            return None
        rows = shard_slice(batch_size, "data", self.mesh)
        return rows.start, rows.stop

    def _local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of a full tensor of parameter ``name``."""
        if self.shardings is None:
            return full
        return local_shard(full, self.shardings[name])

    def _full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The full tensor of this rank's shard of parameter ``name``
        (every rank calls)."""
        if self.shardings is None:
            return t
        return full_tensor(t, self.shardings[name])

    def _count_sum(self, t: torch.Tensor) -> torch.Tensor:
        return all_reduce(t, self._loss_group)

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
            x = _step_layout(images.permute(0, 3, 1, 2))
            # remat: the forward runs again in backward(), inside this
            # block, so the recompute takes the same algorithms
            logits = (_remat(self.model, x, use_reentrant=False)
                      if self.config.remat else self.model(x))
            loss, acc = masked_xent_loss(
                logits.permute(0, 2, 3, 1), labels, self.config.label_nodata,
                self._class_weights,
                self._count_sum if self._loss_group is not None else None)
            loss.backward()
        if self._grad_sync is not None:
            self._grad_sync(st.params)
        grads = [p.grad for p in params]
        if self.config.grad_clip_norm > 0:
            self.grad_norm = clip_by_global_norm_(
                grads, self.config.grad_clip_norm, self._norm_groups)
        opt = st.opt_state
        opt.count = adamw_update_(
            params, grads, list(opt.mu.values()), list(opt.nu.values()),
            opt.count, self.schedule(opt.count), self.config.weight_decay)
        st.step += 1
        return all_reduce(loss.detach(), self._loss_group), acc

    def train_step_async(self, images, labels) -> Dict[str, torch.Tensor]:
        """One step without a host sync; returns the device metrics
        (read them only when reporting)."""
        if isinstance(images, np.ndarray):
            n = images.shape[0]
            images, labels = self.place_batch(images, labels)
        else:
            n = images.shape[0] * self.mesh.shape["data"]
        loss, acc = self._step(normalize_images(images), labels)
        self.examples_seen += n
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
        seeded with ``seed`` (on a mesh every rank draws the global batch
        and keeps its rows; a pool sharded over "data" fetches them
        wherever they live); ``draws`` replaces them with given draws,
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
                rows = shard_slice(len(idx), "data", self.mesh)
                images, labels = pool.take(idx[rows])
                images = normalize_images(images)
                if augment:
                    images, labels = apply_augment(
                        images, labels,
                        {n: t[rows].to(self.device) for n, t in aug.items()})
                if self._spatial:
                    band = shard_slice(images.shape[1], "model", self.mesh)
                    images, labels = images[:, band], labels[:, band]
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
        num_classes) float32 logits of ``infer_model`` on the device, the
        same bits in every thread (see ``_forward_flags``)."""
        self._quant_arg()
        x = normalize_images(images).permute(0, 3, 1, 2)
        with torch.inference_mode(), _forward_flags(
                self.compute_dtype == torch.float32):
            self.infer_model.eval()
            return self.infer_model(x).permute(0, 2, 3, 1)

    # -- int8-static calibration --------------------------------------------
    def _quant_arg(self, auto_batch=None) -> None:
        """Readies int8-static for inference (the JAX package's
        ``_quant_arg``, whose scales here live in ``infer_model``'s
        buffers): uncalibrated, it calibrates on ``auto_batch`` (the host
        batch about to be inferred) when given; without one it raises,
        rather than let zero scales saturate every activation."""
        if self.config.quantize == "int8-static" and not self._calibrated:
            if auto_batch is None:
                raise RuntimeError(
                    "quantize='int8-static' requires calibration before "
                    "inference: run Trainer.calibrate(batches) first "
                    "(CLI: --calibrate-batches N)")
            self.calibrate([auto_batch], max_batches=1)

    @property
    def quant_vars(self) -> dict:
        """The calibrated activation max-abs of each int8 conv as the JAX
        package's ``"quant"`` collection (``{"ConvBlock_0": {"Conv_0":
        {"act_amax": float32}}, ...}``); {} until int8-static is
        calibrated."""
        if self.config.quantize != "int8-static" or not self._calibrated:
            return {}
        out: dict = {}
        for name, mod in _walk(self.infer_model).convs:
            if isinstance(mod, Int8Conv):
                node = out
                for part in name.split("/"):
                    node = node.setdefault(part, {})
                node["act_amax"] = np.float32(mod.act_amax.item())
        return out

    def calibrate(self, batches, max_batches: int = 8) -> int:
        """Calibrate int8-static activation scales over up to
        ``max_batches`` batches (each (images, labels) or bare images):
        every int8 conv folds the max-abs of its input into its
        ``act_amax`` (a layer sees its input as the layers before it, with
        the scales updated so far, compute it), and inference then
        quantizes with those constants. Returns the batches consumed; a
        no-op for other quantize modes."""
        if self.config.quantize != "int8-static":
            return 0
        convs = [m for m in self.infer_model.modules()
                 if isinstance(m, Int8Conv)]
        n = 0
        for batch in batches:
            if n >= max_batches:
                break
            images = batch[0] if isinstance(batch, (tuple, list)) else batch
            x = normalize_images(self._to_device(images)).permute(0, 3, 1, 2)
            if self._spatial:
                # every example, this rank's band: each int8 conv folds
                # the maximum over the bands
                x = x[:, :, shard_slice(x.shape[2], "model", self.mesh)]
            for m in convs:
                m.calibrating = True
            try:
                with torch.no_grad(), _forward_flags(
                        self.compute_dtype == torch.float32):
                    self.infer_model.eval()
                    self.infer_model(x)
            finally:
                for m in convs:
                    m.calibrating = False
            n += 1
        self._calibrated = self._calibrated or n > 0
        return n

    def _chunked_logits(self, images):
        """Logits of ``images`` in batch_size chunks, the last padded with
        zeros as the server pads its dispatches: cuDNN picks its engine
        by shape, so an image's bits depend on the batch's size, and
        predict must give the class map the server gives for the same
        image. Yields the logits of each chunk's real images. Uncalibrated
        int8-static first calibrates on a host batch of ``images``."""
        self._quant_arg(images if isinstance(images, np.ndarray) else None)
        if self.mesh.size > 1:
            yield from self._world_logits(images)
            return
        x = self._to_device(images)
        bs = int(self.config.batch_size)
        for i in range(0, x.shape[0], bs):
            chunk = x[i:i + bs]
            n = chunk.shape[0]
            if n < bs:
                chunk = torch.cat([chunk, chunk.new_zeros(
                    (bs - n,) + tuple(chunk.shape[1:]))])
            yield self.logits(chunk)[:n]

    def _world_logits(self, images):
        """``_chunked_logits`` on a mesh: every rank passes the same
        images; each chunk (batch_size rounded up to the data axis,
        padded with zeros) is split into this rank's rows and band, and
        the logits are gathered back, so every rank yields every
        image's."""
        if isinstance(images, torch.Tensor):
            images = images.cpu().numpy()
        nd = self.mesh.shape["data"]
        bs = -(-int(self.config.batch_size) // nd) * nd
        for i in range(0, images.shape[0], bs):
            chunk = images[i:i + bs]
            n = chunk.shape[0]
            if n < bs:
                chunk = np.concatenate([chunk, np.zeros(
                    (bs - n,) + chunk.shape[1:], chunk.dtype)])
            logits = self.logits(shard_batch_local(self.mesh, chunk,
                                                   spatial=self._spatial))
            if self._spatial:
                logits = all_gather(logits, self.mesh.group("model"), 1)
            yield all_gather(logits, self.mesh.group("data"), 0)[:n]

    def _pad_to_data_axis(self, images: np.ndarray, labels: np.ndarray):
        """A host batch padded to a multiple of the data axis, the padded
        examples all zeros with ``label_nodata`` labels (they add nothing
        to any masked sum), as the JAX package pads."""
        pad = (-images.shape[0]) % self.mesh.shape["data"]
        if pad:
            images = np.concatenate([images, np.zeros(
                (pad,) + images.shape[1:], images.dtype)])
            labels = np.concatenate([labels, np.full(
                (pad,) + labels.shape[1:], self.config.label_nodata,
                labels.dtype)])
        return images, labels

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

    def evaluate(self, batches, max_batches: Optional[int] = None,
                 rows: bool = False) -> Dict[str, float]:
        """Dataset-level loss, accuracy, mIoU and per-class IoU and F1
        over an iterator of (images, labels), through ``infer_model``
        (uncalibrated int8-static calibrates on the first batch): the
        sums and the confusion matrix accumulate on the device over all
        batches and are read once. On a mesh every rank passes the same
        host batches; each is padded to the data axis with nodata labels
        (as the JAX package pads), each rank sums its rows (and band), the
        sums are added over the ranks once at the end, and every rank
        returns the same metrics. The ranks agree before each batch that
        each of them has one, so iterators of unequal lengths stop at the
        shortest instead of leaving a rank waiting in a collective.
        ``rows``: each host batch holds this rank's data rows only (a
        feed with ``rows``; no padding)."""
        if self.config.quantize == "int8-static" and not self._calibrated:
            # calibrate on the first batch; an empty iterable gives empty
            # metrics (the JAX package raises there)
            batches = iter(batches)
            first = next(batches, None)
            if first is not None:
                self.calibrate([first], max_batches=1)
                batches = itertools.chain([first], batches)
        K = self.config.num_classes
        cm = torch.zeros((K, K), dtype=torch.int64, device=self.device)
        sums = torch.zeros(3, dtype=torch.float64, device=self.device)
        n_batches = 0
        batches = iter(batches)
        world = self.mesh.group("world")
        while max_batches is None or n_batches < max_batches:
            item = next(batches, None)
            if world is not None:
                have = torch.tensor([item is not None], dtype=torch.int32,
                                    device=self.device)
                if not all_reduce(have, world, torch.distributed.ReduceOp
                                  .MIN).item():
                    break
            if item is None:
                break
            images, labels = item
            if isinstance(images, np.ndarray):
                images, labels = (self.place_rows(images, labels) if rows
                                  else self.place_batch(
                                      *self._pad_to_data_axis(images,
                                                              labels)))
            ls, cor, nv, c = self._eval_sums(images, labels)
            # float64 like the JAX package's host sum of float32 losses
            sums += torch.stack([ls.double(), cor.double(), nv.double()])
            cm += c
            n_batches += 1
        sums = all_reduce(sums, self._loss_group)
        cm = all_reduce(cm, self._loss_group)
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
            "duty_cycle": duty(self.device_seconds, wall),
            "duty_cycle_lower": duty(
                max(0.0, self.device_seconds - self.feed_seconds), wall),
            "wall_seconds": wall,
            "device_seconds": self.device_seconds,
            "feed_seconds": self.feed_seconds,
        }

    # -- checkpoints ----------------------------------------------------------
    def _payload(self) -> dict:
        """The state as full CPU tensors (on a mesh every rank calls: the
        shards are gathered)."""
        st = self.state

        def cpu(d):
            return {n: self._full(n, t.detach()).cpu() for n, t in d.items()}
        return {"params": cpu(st.params),
                "opt_state": {"count": st.opt_state.count,
                              "mu": cpu(st.opt_state.mu),
                              "nu": cpu(st.opt_state.nu)},
                "step": st.step, "model": self.config.model}

    def _load_payload(self, payload: dict) -> None:
        """Load full tensors; on a mesh each rank keeps its shards (the
        restore re-shards onto the live mesh)."""
        st = self.state
        shapes = {n: p.shape for n, p in self._template.named_parameters()}
        trees = [(payload["params"], st.params),
                 (payload["opt_state"]["mu"], st.opt_state.mu),
                 (payload["opt_state"]["nu"], st.opt_state.nu)]
        for src, dst in trees:
            bad = sorted(n for n in set(src) | set(dst)
                         if n not in src or n not in dst
                         or src[n].shape != shapes[n])
            if bad:
                raise ValueError(f"checkpoint does not match the model's "
                                 f"parameters: {bad[:4]}")
        with torch.no_grad():
            for src, dst in trees:
                for n, t in dst.items():
                    t.copy_(self._local(n, src[n]))
        st.opt_state.count = int(payload["opt_state"]["count"])
        st.step = int(payload["step"])

    def save_checkpoint(self, path: str) -> None:
        """``torch.save`` of {"params", "opt_state", "step", "model"} (the
        family) to ``path``: written to ``path.tmp`` and renamed into
        place. A gs:// / s3:// path is saved to a local file of the same
        name (torch names the archive's records after the file, so the
        object's bytes equal a local save's), then uploaded: one atomic
        object creation. On a mesh every rank calls: the shards are
        gathered, the primary writes the full arrays, and every rank
        returns once the file is in place."""
        payload = self._payload()
        if is_primary():
            _write_payload(payload, path)
        self._barrier()

    def _barrier(self) -> None:
        if self.mesh.size > 1:
            torch.distributed.barrier()

    def orbax_tree(self) -> dict:
        """The state as the JAX ``Trainer``'s checkpoint tree (flax
        params, the optax AdamW state with this config's clip and
        schedule, an int32 step), numpy arrays on the host: what
        ``train/orbax.py:write_checkpoint`` writes for the JAX package."""
        cfg = self.config
        full = self._payload()
        opt = type(self.state.opt_state)(self.state.opt_state.count,
                                         full["opt_state"]["mu"],
                                         full["opt_state"]["nu"])
        return {"params": flax_from_tensors(full["params"], self._template),
                "opt_state": optax_from_adamw(
                    opt, self._template, cfg.grad_clip_norm > 0,
                    cfg.schedule == "cosine" or cfg.warmup_steps > 0),
                "step": np.asarray(self.state.step, np.int32)}

    def _load_orbax_tree(self, tree: dict) -> None:
        """Load a tree of ``orbax.read_checkpoint``; s2d migration as for
        ``.pt`` files."""
        try:
            params = tensors_from_flax(tree["params"], self._template)
            opt = adamw_state_from_optax(tree["opt_state"], self._template)
        except ValueError as e:
            if not self._try_other_s2d_variant(e):
                raise
            return self._load_orbax_tree(tree)
        self._load_payload({"params": params,
                            "opt_state": {"count": opt.count, "mu": opt.mu,
                                          "nu": opt.nu},
                            "step": int(tree["step"])})

    def restore_checkpoint(self, path: str) -> None:
        """Load a checkpoint: a file of :meth:`save_checkpoint`, or a
        directory (or gs:// / s3:// prefix) holding an orbax checkpoint
        of the JAX ``Trainer`` (``_METADATA``; read by
        ``train/orbax.py``). Under s2d AUTO a checkpoint of another
        reachable tree rebuilds this trainer as that tree
        (``_try_other_s2d_variant``). A ``.pt`` ``path`` may be a gs://,
        s3:// or http(s):// object."""
        if orbax.is_checkpoint(path):
            self._load_orbax_tree(orbax.read_checkpoint(path))
            return
        if not storage.is_remote(path) and os.path.isdir(path):
            raise ValueError(f"{path} is a directory without an orbax "
                             "checkpoint's _METADATA")
        with storage.open_read(path) as f:
            payload = torch.load(f, map_location="cpu", weights_only=True)
        family = payload.get("model", "unet")
        if family != self.config.model:
            raise ValueError(f"checkpoint does not match the model's "
                             f"parameters: {path} holds a {family!r} model, "
                             f"this trainer builds {self.config.model!r}")
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
        if is_primary():
            manager.prune()
            manager.sync()
        self._barrier()
        return step

    def restore_latest(self, manager: CheckpointManager) -> Optional[int]:
        """Restore the newest managed checkpoint; None if there is none."""
        step = manager.latest_step()
        if step is None:
            return None
        self.restore_checkpoint(manager.restore_path(step))
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
            if not self._s2d_auto or self.config.model != "unet":
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
        self.__init__(self.config, device=self.device, mesh=self.mesh,
                      _variant=(s2d, feats))
        self._s2d_untried = rest
        return True


def _write_payload(payload: dict, path: str) -> None:
    """``torch.save`` to ``path.tmp``, renamed into place; a gs:// / s3://
    path through a local file of the same name, then uploaded."""
    if storage.is_remote(path):
        import tempfile
        with tempfile.TemporaryDirectory() as d:
            local = os.path.join(d, storage.basename(path))
            _write_payload(payload, local)
            storage.upload_file(local, path)
        return
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
