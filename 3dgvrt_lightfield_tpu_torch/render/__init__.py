"""Renderers: brute-force ground truth and the tiled path, differentiable."""

from . import binning
from . import pallas_forward
from . import pallas_vjp
from . import param_grads
from . import reference
from . import rows_vjp
from . import segreduce
from . import tile_math
from . import tiled
from .pallas_forward import tile_forward, tile_forward_residual
from .pallas_vjp import render_tiles_ad, tile_backward
from .rows_vjp import rows64_from_model
from .segreduce import segment_reduce
from .reference import render_image, render_rays
from .tiled import TiledRenderer, render_image_tiled
