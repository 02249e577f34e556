"""Camera batches for the trainer; the sharded functions of the JAX
package's `parallel/` come with multi-device work (ROADMAP.md section 1
item 11)."""

from . import sharding
from .sharding import CameraBatch, camera_batch
