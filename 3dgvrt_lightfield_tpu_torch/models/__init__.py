"""Scene models."""

from . import gaussians
from .gaussians import ActivatedGaussians, GaussianModel, random_gaussians
