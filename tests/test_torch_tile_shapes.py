"""PyTorch port at tile and chunk sizes other than the defaults, on the CPU.

The JAX kernels take any rays per tile R = tile_size^2 and any chunk size
G; the port's kernels split a large tile into slabs of rays and a large
chunk into pieces or sub-chunks, which leaves every function unchanged
(tests/test_torch_cuda.py holds them to their plain versions on the card).
Here the port's plain path, which the CPU runs, meets JAX's impl="scan" at
those shapes: tiles of 23, 24 and 32 pixels (R = 529, 576, 1024) and
chunks of 256.

* The serving frame (each package bins for itself): test_torch_tiled.py's
  tolerances, rgb and transmittance 1e-4, depth 1e-3, hit counts equal on
  99.9% of rays.
* The training step's six per-leaf gradients through `render_bound` on
  JAX's own topology: test_torch_train.py's tolerance (atol = max(2e-5 *
  scale, 1e-7), rtol = 2e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gvrt_tpu as g3
import gvrt_tpu_torch as gt
from gvrt_tpu.render.tiled import TiledRenderer as JaxTiledRenderer
from gvrt_tpu.render.tiled import render_image_tiled as jax_render_tiled
from gvrt_tpu_torch.models.gaussians import LEAVES

from port_scenes import (assert_grad_close, camera, carry,  # noqa: F401
                         carry_topology, jax_scene, one_torch_thread,
                         torch_cfg)

#: (tile, chunk, image side)
SHAPES = [(24, 64, 48), (32, 64, 64), (16, 256, 64), (32, 256, 64),
          (23, 64, 46)]
IDS = [f"t{t}_g{g}_{res}px" for t, g, res in SHAPES]


def _cfg(tile, chunk):
    return g3.DEFAULT_CONFIG.replace(tile_size=tile, chunk_size=chunk)


@pytest.mark.parametrize("tile,chunk,res", SHAPES, ids=IDS)
def test_frame_matches_jax_scan(tile, chunk, res):
    cfg = _cfg(tile, chunk)
    jm = jax_scene(500, seed=11)
    cam = camera(res)
    want = jax_render_tiled(jm, cam, cfg, impl="scan")
    out = gt.render.TiledRenderer(res, res, torch_cfg(cfg),
                                  device="cpu").render(carry(jm), cam)
    got = {k: v.detach().numpy() for k, v in out.items()}
    assert int(got["overflow"]) == 0 and int(got["num_pairs"]) == int(
        want["num_pairs"])
    np.testing.assert_allclose(got["rgb"], np.asarray(want["rgb"]), atol=1e-4)
    np.testing.assert_allclose(got["transmittance"],
                               np.asarray(want["transmittance"]), atol=1e-4)
    np.testing.assert_allclose(got["depth"], np.asarray(want["depth"]),
                               atol=1e-3)
    assert (got["hit_count"] == np.asarray(want["hit_count"])).mean() >= 0.999
    assert got["hit_count"].mean() > 1.0


@pytest.mark.parametrize("tile,chunk,res", SHAPES, ids=IDS)
def test_step_gradients_match_jax_scan(tile, chunk, res):
    cfg = _cfg(tile, chunk)
    jm = jax_scene(200, seed=41, spread=0.6, scale_range=(-2.3, -1.6))
    cam = camera(res)
    jr = JaxTiledRenderer(res, res, cfg, impl="scan")
    jr.plan(jm, [cam])
    topo = jr.bind(jm, cam)

    def jax_loss(m):
        o = jr.render_bound(m)
        return jnp.mean((o["rgb"] - 0.25) ** 2) + 1e-2 * jnp.mean(o["depth"])

    want = jax.jit(jax.grad(jax_loss))(jm)

    tm = carry(jm)
    tr = gt.render.TiledRenderer(res, res, torch_cfg(cfg), device="cpu")
    tr._bound = (carry_topology(topo), tr._rays(cam))
    out = tr.render_bound(tm)
    (((out["rgb"] - 0.25) ** 2).mean()
     + 1e-2 * out["depth"].mean()).backward()
    for k in LEAVES:
        assert np.abs(np.asarray(getattr(want, k))).max() > 0, k
        assert_grad_close(getattr(tm, k).grad.numpy(), getattr(want, k), k)
