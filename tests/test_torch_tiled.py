"""PyTorch port, the slice as a whole: the tiled serving path on the CPU.

Each package bins for itself here, so a last-ulp difference in a depth key
can swap two near-equal depths; the bounds are therefore looser than the
same-topology comparison in test_torch_tile_forward.py: rgb and
transmittance 1e-4, depth 1e-3, hit counts equal on 99.9% of rays.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import gvrt_tpu as g3
import gvrt_tpu_torch as gt
from gvrt_tpu.render.reference import render_image as jax_render_image
from gvrt_tpu.render.tiled import render_image_tiled as jax_render_tiled
from gvrt_tpu_torch.app import main as cli_main

import golden_scenes
from port_scenes import CFG_T8, camera, carry, jax_scene, torch_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(out):
    return {k: v.detach().numpy() for k, v in out.items()}


@pytest.mark.parametrize("cfg", [g3.DEFAULT_CONFIG, CFG_T8],
                         ids=["default", "t8_g128"])
def test_tiled_matches_jax_scan(cfg):
    jm = jax_scene(500, seed=11)
    cam = camera(64)
    want = jax_render_tiled(jm, cam, cfg, impl="scan")
    got = _np(gt.render.TiledRenderer(64, 64, torch_cfg(cfg),
                                      device="cpu").render(carry(jm), cam))
    assert int(got["overflow"]) == 0 and int(got["num_pairs"]) == int(
        want["num_pairs"])
    np.testing.assert_allclose(got["rgb"], np.asarray(want["rgb"]), atol=1e-4)
    np.testing.assert_allclose(got["transmittance"],
                               np.asarray(want["transmittance"]), atol=1e-4)
    np.testing.assert_allclose(got["depth"], np.asarray(want["depth"]),
                               atol=1e-3)
    assert (got["hit_count"] == np.asarray(want["hit_count"])).mean() >= 0.999
    assert got["hit_count"].mean() > 1.0


def test_brute_force_matches_jax():
    jm = jax_scene(120, seed=12)
    cam = camera(24)
    want = jax_render_image(jm, cam)
    got = _np(gt.render.render_image(carry(jm), cam, device="cpu"))
    for k in ("rgb", "transmittance"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-5,
                                   err_msg=k)
    # depth is a distance of ~3 units: 1e-5 of it, as for the unit quantities
    np.testing.assert_allclose(got["depth"], np.asarray(want["depth"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got["hit_count"],
                                  np.asarray(want["hit_count"]))


def test_tiled_matches_own_brute_force():
    """Center-depth order vs exact per-ray order (tests/test_tiled.py:73-91)."""
    model = carry(jax_scene(128, seed=1))
    cam = camera(32)
    brute = _np(gt.render.render_image(model, cam, device="cpu"))
    tiled = _np(gt.render.render_image_tiled(model, cam, torch_cfg(CFG_T8),
                                             device="cpu"))
    assert int(tiled["overflow"]) == 0
    np.testing.assert_allclose(tiled["transmittance"], brute["transmittance"],
                               atol=2e-3)
    mse = np.mean((tiled["rgb"] - brute["rgb"]) ** 2)
    psnr = 10 * np.log10(1.0 / max(mse, 1e-12))
    assert psnr > 35.0, f"tiled vs brute-force PSNR too low: {psnr:.1f} dB"
    assert np.isclose(tiled["rgb"], brute["rgb"], atol=1e-3).mean() > 0.95


def test_empty_tiles_are_background():
    model = carry(jax_scene(4, seed=4, spread=0.05))
    out = _np(gt.render.render_image_tiled(model, camera(32),
                                           torch_cfg(CFG_T8), device="cpu"))
    t, rgb = out["transmittance"], out["rgb"]
    assert t[0, 0] == 1.0 and t[-1, -1] == 1.0
    np.testing.assert_array_equal(rgb[0, 0], 0.0)
    assert out["hit_count"][0, 0] == 0 and out["depth"][0, 0] == 0.0
    assert np.isfinite(rgb).all() and out["hit_count"].max() > 0


def test_overflow_replans_and_renders_correctly():
    model = carry(jax_scene(300, seed=13))
    cam = camera(32)
    cfg = torch_cfg(CFG_T8)
    fresh = gt.render.TiledRenderer(32, 32, cfg, device="cpu")
    want = _np(fresh.render(model, cam))
    small = (fresh.capacity[0] // 4 // 128 * 128 or 128, 256)
    r = gt.render.TiledRenderer(32, 32, cfg, capacity=small, device="cpu")
    got = _np(r.render(model, cam))
    assert int(got["overflow"]) == 0
    assert r.capacity[0] >= fresh.capacity[0] and r.capacity[1] > small[1]
    for k in ("rgb", "depth", "transmittance", "hit_count"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_render_bound_equals_render():
    model = carry(jax_scene(300, seed=14))
    cam = camera(32)
    r = gt.render.TiledRenderer(32, 32, torch_cfg(CFG_T8), device="cpu")
    with pytest.raises(RuntimeError, match="bind"):
        r.render_bound(model)
    want = _np(r.render(model, cam))
    topo = r.bind(model, cam)
    assert int(topo.overflow) == 0
    got = _np(r.render_bound(model))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_goldens_r04():
    """The committed 128^2 views (rendered on a TPU by the compiled Pallas
    kernel with bf16 SH dots) at the CPU bound of tests/test_goldens.py."""
    gdir = os.path.join(REPO, "artifacts", "goldens_r04")
    with open(os.path.join(gdir, "goldens.json")) as f:
        views = json.load(f)["views"]
    model = carry(golden_scenes.golden_model())
    cams = golden_scenes.golden_cameras()
    r = gt.render.TiledRenderer(golden_scenes.SIZE, golden_scenes.SIZE,
                                gt.DEFAULT_CONFIG, device="cpu")
    r.plan(model, cams)
    assert sorted(c.name for c in cams) == sorted(views)
    for cam in cams:
        rgb = r.render(model, cam)["rgb"].detach().numpy()
        golden = np.load(os.path.join(gdir, f"{cam.name}.npy"))
        np.testing.assert_allclose(rgb, golden, atol=4e-3, err_msg=cam.name)


def test_cli_render_writes_png(tmp_path):
    ply = str(tmp_path / "scene.ply")
    carry(jax_scene(200, seed=15, spread=0.5)).to_ply(ply)
    out = str(tmp_path / "renders")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "3dgvrt_lightfield_tpu_torch", "render",
         "--device", "cpu", "--ply", ply, "--width", "32", "--height", "32",
         "--frames", "2", "--out", out, "--hit-counts"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    img = gt.io.load_png(os.path.join(out, "orbit_0000.png"))
    assert img.shape == (32, 32, 3) and img.max() > 0
    assert os.path.exists(os.path.join(out, "orbit_0001.png"))
    assert os.path.getsize(os.path.join(out, "rayHitCountsOutput.txt")) > 0


def test_cli_info_and_benchmark(tmp_path, capsys, monkeypatch):
    ply = str(tmp_path / "scene.ply")
    carry(jax_scene(100, seed=16, spread=0.5)).to_ply(ply)
    cli_main(["info", "--ply", ply, "--device", "cpu"])
    assert "gaussians: 100" in capsys.readouterr().out
    monkeypatch.chdir(tmp_path)
    cli_main(["benchmark", "--ply", ply, "--device", "cpu", "--width", "16",
              "--height", "16", "-bw", "0.05", "-br", "0.2"])
    out = capsys.readouterr().out
    assert "fps" in out and "rays/s" in out
    assert "frame,ms" in open("fps.txt").read()


def test_missing_cuda_raises_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gt.render.TiledRenderer(16, 16)
    model = carry(jax_scene(10, seed=17))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gt.render.render_image_tiled(model, camera(16))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_main(["info"])
    assert gt.render.TiledRenderer(16, 16, device="cpu").impl == "torch"


def test_import_loads_neither_jax_nor_the_jax_package():
    code = ("import sys, gvrt_tpu_torch\n"
            "import gvrt_tpu_torch.render.pallas_vjp, "
            "gvrt_tpu_torch.render.segreduce, "
            "gvrt_tpu_torch.render.param_grads, "
            "gvrt_tpu_torch.render.rows_vjp, gvrt_tpu_torch.render.banded, "
            "gvrt_tpu_torch.train.trainer, "
            "gvrt_tpu_torch.train.checkpoint, gvrt_tpu_torch.train.pose, "
            "gvrt_tpu_torch.parallel, gvrt_tpu_torch.utils.metrics, "
            "gvrt_tpu_torch.utils.evaluate, gvrt_tpu_torch.app\n"
            "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
            " or k in ('3dgvrt_lightfield_tpu', 'gvrt_tpu')"
            " or k.startswith(('3dgvrt_lightfield_tpu.', 'gvrt_tpu.'))]\n"
            "print(bad)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, timeout=120,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
