"""Fine-tuning: the single-card, non-banded trainer and checkpoints."""

from . import checkpoint, trainer
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .trainer import TrainConfig, Trainer, make_optimizer
