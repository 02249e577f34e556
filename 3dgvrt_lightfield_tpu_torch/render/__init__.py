"""Renderers: brute-force ground truth, the tiled and the banded paths,
differentiable, and the combined Gaussian-and-mesh render."""

from . import banded
from . import binning
from . import combined
from . import pallas_forward
from . import pallas_vjp
from . import param_grads
from . import reference
from . import rows_vjp
from . import scan
from . import segreduce
from . import tile_math
from . import tiled
from .pallas_forward import tile_forward, tile_forward_residual
from .pallas_vjp import render_tiles_ad, tile_backward
from .rows_vjp import frame_params
from .segreduce import segment_reduce, segment_reduce_compact
from .reference import render_image, render_rays
from .tiled import TiledRenderer, render_image_tiled
from .banded import BandedRenderer, render_image_banded
from .combined import render_combined
