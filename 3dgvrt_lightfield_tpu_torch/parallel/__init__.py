"""Multi-device rendering and training on `torch.distributed`: one rank per
card, the camera batch or a frame's tile rows sharded over the ranks."""

from . import distributed, sharding
from .distributed import data_parallel_mesh, init_distributed
from .sharding import (CameraBatch, Mesh, average_gradients, camera_batch,
                       make_mesh, plan_capacity_sharded, render_batch_sharded,
                       render_image_tile_sharded, replicate_model)
