"""Asset and scene I/O: PLY splats, NeRF cameras, images, KTX (NumPy only)."""

from . import cameras
from . import image
from . import ktx
from . import ply

from .cameras import Camera, load_nerf_cameras, look_at_inverse, perspective_vulkan
from .image import load_cubemap, load_png, save_png, to_uint8
from .ktx import load_ktx, save_ktx1, save_ktx2
from .ply import SplatSet, load_splats, save_splats
