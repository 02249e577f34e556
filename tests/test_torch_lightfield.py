"""The port's Gaussian light field against the JAX package's, on the CPU.

* `sampling_cameras`: eyes, view_inverse and proj_inverse within 1e-6;
* `compute_light_field` against JAX's with impl="scan", at 40^2 on tile 8
  and at 60^2 on tile 20 (400 rays per tile, the light field's own tile):
  images within 1e-5, ray directions within 1e-6;
* the same on a 2-rank gloo mesh (one run of
  tests/port_parallel_worker.py): equal to the one-process render;
* `save_light_field` and the CLI's `lightfield --size 40 --device cpu`.
"""

import os

import jax
import numpy as np
import pytest

import gvrt_tpu as g3
import gvrt_tpu_torch as gt
from gvrt_tpu.models.lightfield import LightFieldConfig as JaxLightFieldConfig
from gvrt_tpu.models.lightfield import compute_light_field as jax_light_field
from gvrt_tpu.models.lightfield import sampling_cameras as jax_cameras
from gvrt_tpu_torch.app import main as cli_main
from gvrt_tpu_torch.models.gaussians import LEAVES
from gvrt_tpu_torch.models.lightfield import (LightFieldConfig,
                                              compute_light_field,
                                              sampling_cameras,
                                              save_light_field)

import port_parallel_worker as w
from port_scenes import carry, one_torch_thread  # noqa: F401

#: (size, tile): tests/test_lightfield.py's, and the light field's own tile
SIZES = [(40, 8), (60, 20)]


def _scene(n=48):
    """tests/test_lightfield.py's scene."""
    return g3.random_gaussians(jax.random.key(0), n, extent=0.5)


def _configs(size, tile):
    kw = dict(width=size, height=size, tile_size=tile)
    return JaxLightFieldConfig(**kw), LightFieldConfig(**kw)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Rank 0's light field of the scene at 40^2 / tile 8 on a 2-rank mesh,
    and the one-process render of the same."""
    work = tmp_path_factory.mktemp("lightfield_ranks")
    model = _scene()
    np.savez(work / "inputs.npz",
             **{k: np.asarray(getattr(model, k)) for k in LEAVES})
    finish = w.start_ranks("lightfield", work)
    try:
        one = compute_light_field(carry(model), _configs(w.LF_SIZE,
                                                         w.LF_TILE)[1],
                                  device="cpu")
    finally:
        finish()
    return dict(np.load(work / "out0.npz")), one


def test_sampling_cameras_match_jax():
    model = _scene()
    lf_j, lf_t = _configs(40, 8)
    want, got = jax_cameras(model, lf_j), sampling_cameras(carry(model), lf_t)
    assert [c.name for c in got] == [c.name for c in want]
    for g, c in zip(got, want):
        assert (g.width, g.height) == (c.width, c.height)
        np.testing.assert_allclose(g.view_inverse[:3, 3],
                                   c.view_inverse[:3, 3], atol=1e-6)
        np.testing.assert_allclose(g.view_inverse, c.view_inverse, atol=1e-6)
        np.testing.assert_allclose(g.proj_inverse, c.proj_inverse, atol=1e-6)


@pytest.mark.parametrize("size,tile", SIZES, ids=["40px_t8", "60px_t20"])
def test_compute_light_field_matches_jax(size, tile):
    model = _scene()
    lf_j, lf_t = _configs(size, tile)
    want = jax_light_field(model, lf_j, impl="scan")
    got = compute_light_field(carry(model), lf_t, device="cpu")
    assert got["images"].shape == (4, size, size, 3)
    assert got["images"].max() > 0.01
    np.testing.assert_allclose(got["images"], want["images"], atol=1e-5)
    np.testing.assert_allclose(got["ray_dirs"], want["ray_dirs"], atol=1e-6)


def test_light_field_on_two_ranks_equals_one_process(two_ranks):
    sharded, one = two_ranks
    np.testing.assert_array_equal(sharded["images"], one["images"])
    np.testing.assert_array_equal(sharded["ray_dirs"], one["ray_dirs"])


def test_save_light_field(tmp_path):
    res = compute_light_field(carry(_scene()), _configs(40, 8)[1],
                              device="cpu")
    paths = save_light_field(str(tmp_path), res)
    assert [os.path.basename(p) for p in paths] == [
        f"sampling_cam{i:04d}.png" for i in range(4)]
    img = gt.io.load_png(paths[0])
    assert img.shape == (40, 40, 3)
    np.testing.assert_array_equal(np.load(tmp_path / "ray_dirs.npy"),
                                  res["ray_dirs"])


def test_cli_lightfield(tmp_path, capsys):
    ply = str(tmp_path / "scene.ply")
    carry(_scene()).to_ply(ply)
    out_dir = str(tmp_path / "lf")
    cli_main(["lightfield", "--device", "cpu", "--ply", ply, "--out",
              out_dir, "--size", "40"])
    printed = capsys.readouterr().out.split()
    assert printed == [os.path.join(out_dir, f"sampling_cam{i:04d}.png")
                       for i in range(4)]
    assert all(os.path.exists(p) for p in printed)
    assert np.load(os.path.join(out_dir, "ray_dirs.npy")).shape == \
        (4, 40, 40, 3)
