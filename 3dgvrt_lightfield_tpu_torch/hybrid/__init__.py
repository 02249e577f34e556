"""Hybrid mesh renderer: G-buffer + ray-traced lighting for glTF scenes.

The PyTorch port of the JAX package's `hybrid/`, the rebuild of the
reference's second app, VulkanHybrid (projects/VulkanHybrid/
VulkanHybrid.cpp): a G-buffer pass (here a primary-ray cast against the
triangle soup, the same contents for the pinhole cameras both apps use),
then ray-traced direct lighting with shadow rays and an iterative
reflection/refraction loop (shaders/glsl/VulkanHybrid/raygen.rgen).

`trace.py` intersects ray blocks with Morton-ordered triangle chunks in
plain PyTorch (Möller-Trumbore and a masked argmin, no BVH); hybrid scenes
hold O(10k) triangles.  The bounce loop runs a fixed number of iterations
with per-pixel active masks.  `mesh.py` is a copy of the JAX package's
NumPy-only scene model and glTF loader.
"""

from . import mesh
from . import shade
from . import trace
from .mesh import (Light, Material, MeshScene, SceneObject, cornell_scene,
                   load_gltf)
from .pipeline import HybridConfig, HybridRenderer, render_hybrid
from .trace import closest_hit, occluded
