"""Scenes shared by the PyTorch port's parity tests (tests/test_torch_*.py).

Scenes are built with the JAX package's generator and carried into the port
as NumPy arrays through `GaussianModel.from_numpy`, so both packages render
exactly the same Gaussians.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import gvrt_tpu as g3
import gvrt_tpu_torch as gt

#: the small-tile config of tests/test_tiled.py
CFG_T8 = g3.DEFAULT_CONFIG.replace(tile_size=8, chunk_size=128)


def jax_scene(n=128, seed=0, spread=0.8, scale_range=(-4.5, -2.5)):
    model = g3.random_gaussians(jax.random.key(seed), n, extent=spread,
                                scale_range=scale_range)
    model.means = model.means.at[:, 2].add(-3.0)
    return model


def carry(model) -> "gt.GaussianModel":
    """The JAX model's six leaves -> a port model on the CPU."""
    return gt.GaussianModel.from_numpy(
        {k: np.asarray(getattr(model, k)) for k in gt.models.gaussians.LEAVES},
        device="cpu")


def torch_cfg(cfg) -> "gt.RenderConfig":
    """The port's RenderConfig with the same field values as a JAX one."""
    return gt.RenderConfig(**{f.name: getattr(cfg, f.name)
                              for f in dataclasses.fields(cfg)})


def carry_topology(topo) -> "gt.render.binning.BinTopology":
    """A JAX BinTopology (with its reduce plan) -> the port's, on the CPU."""
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    red = gt.render.segreduce.ReducePlan(*(t(x) for x in topo.red))
    return gt.render.binning.BinTopology(*(t(x) for x in topo[:-1]), red=red)


def camera(res=32, fov=60.0, height=None):
    return g3.Camera.from_fovy(res, height or res, fov, np.eye(4))


def assert_grad_close(got, want, name=""):
    """The gradient tolerance of tests/test_backward.py:53-58, per leaf:
    atol = max(2e-5 * scale, 1e-7) with `scale` the leaf's max |grad|, and
    rtol = 2e-4 (float summation orders differ between the packages)."""
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-8)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=max(2e-5 * scale, 1e-7), rtol=2e-4,
                               err_msg=name)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a test module's torch ops on one intra-op thread (autouse where
    a module imports it): tier-1 runs six workers on a few cores, and each
    worker's own torch thread pool slows the small ops of these tests by
    one to two orders of magnitude there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
