"""Config, presets, optimizers and the Trainer."""

from graphax_torch.train.config import Config
from graphax_torch.models.early import masked_accuracy
from graphax_torch.train.loop import (
    Meter, Trainer, add_labels, cross_entropy_loss, get_label_masks,
)
from graphax_torch.train.optimizers import OptaxOptimizer, get_optimizer
from graphax_torch.train.presets import BEST_PARAMS, best_config

__all__ = ["BEST_PARAMS", "Config", "Meter", "OptaxOptimizer", "Trainer",
           "add_labels", "best_config", "cross_entropy_loss",
           "get_label_masks", "get_optimizer", "masked_accuracy"]
