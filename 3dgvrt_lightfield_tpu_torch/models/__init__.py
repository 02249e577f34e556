"""Scene models."""

from . import gaussians
from . import lightfield
from .gaussians import ActivatedGaussians, GaussianModel, random_gaussians
from .lightfield import (LightFieldConfig, compute_light_field,
                         sampling_cameras, save_light_field)
