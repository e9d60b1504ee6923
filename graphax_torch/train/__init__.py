"""Config, presets, optimizers and the Trainer."""

from graphax_torch.train.config import Config
from graphax_torch.models.early import masked_accuracy
from graphax_torch.train.loop import Meter, Trainer, cross_entropy_loss
from graphax_torch.train.optimizers import OptaxOptimizer, get_optimizer
from graphax_torch.train.presets import BEST_PARAMS, best_config

__all__ = ["BEST_PARAMS", "Config", "Meter", "OptaxOptimizer", "Trainer",
           "best_config", "cross_entropy_loss", "get_optimizer",
           "masked_accuracy"]
