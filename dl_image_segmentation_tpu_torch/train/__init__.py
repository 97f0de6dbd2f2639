"""U-Net training and inference: config, loss, optimizer, steps, scanned
training from a device pool, evaluation, checkpoints and predict."""

from .optim import AdamWState
from .pool import DeviceDataPool, sample_batch
from .trainer import (CheckpointManager, TrainConfig, TrainState, Trainer,
                      masked_miou, masked_xent_loss, normalize_images,
                      resolve_s2d)

__all__ = ["AdamWState", "CheckpointManager", "DeviceDataPool",
           "TrainConfig", "TrainState", "Trainer", "masked_miou",
           "masked_xent_loss", "normalize_images", "resolve_s2d",
           "sample_batch"]
