"""Renderers: brute-force ground truth and the tiled production path."""

from . import binning
from . import pallas_forward
from . import reference
from . import tile_math
from . import tiled
from .pallas_forward import tile_forward
from .reference import render_image, render_rays
from .tiled import TiledRenderer, render_image_tiled
