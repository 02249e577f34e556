"""Math ops (the analog of the reference's GLSL device library)."""

from . import aabb
from . import hit
from . import kernels
from . import quaternion
from . import sh

from .aabb import gaussian_world_aabb, intersect_aabb
from .hit import composite_sorted, ray_gaussian_hit
from .kernels import kernel_scale, particle_response, scale_activation, sigmoid
from .quaternion import (normalize_quat, quat_to_rot9,
                         quat_to_rotmat, safe_normalize)
from .sh import radiance_from_sh, sh_basis, sh_basis_components
