"""3dgvrt_lightfield_tpu_torch — the PyTorch and CUDA port of the Gaussian
ray tracer in `3dgvrt_lightfield_tpu`.

Same layout as the JAX package, so each module's counterpart is at the same
relative path; the JAX package stays the reference the port is tested
against.  The port imports torch and NumPy only, never JAX or the JAX
package.  Its hand-written CUDA kernels live in `csrc/` and are built with
nvcc at first use (`_build.py`).

The directory name is not a valid Python identifier; import via the
repo-root shim ``import gvrt_tpu_torch``.  Submodules are imported eagerly.
"""

from . import config
from .config import DEFAULT_CONFIG, RenderConfig, resolve_device

from . import ops
from . import io
from . import models
from . import render
from . import utils
from . import parallel
from . import train
from . import native
from . import hybrid

from .models.gaussians import GaussianModel, random_gaussians
from .io.cameras import Camera, load_nerf_cameras, perspective_vulkan
from .io.ply import SplatSet, load_splats, save_splats

__version__ = "0.1.0"
