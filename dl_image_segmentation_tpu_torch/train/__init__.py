"""U-Net inference: config, s2d resolution, predict and predict_probs."""

from .trainer import (TrainConfig, TrainState, Trainer, normalize_images,
                      resolve_s2d)

__all__ = ["TrainConfig", "TrainState", "Trainer", "normalize_images",
           "resolve_s2d"]
