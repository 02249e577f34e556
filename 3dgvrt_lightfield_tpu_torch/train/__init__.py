"""Fine-tuning: the single-card trainer (unbanded and banded), checkpoints
and camera-pose refinement."""

from . import checkpoint, pose, trainer
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .pose import optimize_camera_poses, perturb_cameras, tile_rays_pose
from .trainer import TrainConfig, Trainer, make_optimizer
