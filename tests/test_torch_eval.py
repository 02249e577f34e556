"""PyTorch port, `eval` and `utils/evaluate.py` against the JAX package.

`evaluate_dirs` is a copy of the JAX package's NumPy code: on the same
image pairs it must give the same PSNR/SSIM.  The CLI's `eval` on the CPU,
in the style of tests/test_app_cli.py:55 (`--gt-dir` against its own
renders: PSNR inf) and :128 (`--bands 2` against the unbanded renders: the
port's banded frames equal the unbanded one bit for bit, so the 8-bit
images are identical).
"""

import json
import os

import numpy as np
import torch

from gvrt_tpu.utils.evaluate import evaluate_dirs as jax_evaluate_dirs
import gvrt_tpu_torch as gt
from gvrt_tpu_torch.app import main as cli_main
from gvrt_tpu_torch.utils.evaluate import (evaluate_dirs, render_eval_set,
                                           save_hit_counts)

from port_scenes import camera, carry, jax_scene
from port_scenes import one_torch_thread  # noqa: F401 (autouse)


def test_evaluate_dirs_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    dirs = {d: tmp_path / d for d in ("gt", "a", "b")}
    for p in dirs.values():
        p.mkdir()
    for i in range(3):
        img = rng.integers(0, 256, (24, 20, 3), dtype=np.uint8)
        gt.io.save_png(str(dirs["gt"] / f"r_{i}.png"), img)
        noisy = np.clip(img.astype(int) + rng.integers(-20, 21, img.shape),
                        0, 255).astype(np.uint8)
        gt.io.save_png(str(dirs["a"] / f"r_{i}.png"), noisy)
        if i != 1:  # a view missing from one method is skipped
            gt.io.save_png(str(dirs["b"] / f"r_{i}.png"), img // 2)
    tests = [str(dirs["a"]), str(dirs["b"])]
    want = jax_evaluate_dirs(str(dirs["gt"]), tests, verbose=False)
    got = evaluate_dirs(str(dirs["gt"]), tests, verbose=False)
    assert got == want
    assert got[tests[1]]["num_views"] == 2


def test_render_eval_set_and_hit_counts(tmp_path):
    model = carry(jax_scene(60, seed=21, spread=0.5))
    cams = [camera(16), camera(16, 50.0)]
    paths = render_eval_set(model, cams, str(tmp_path / "views"),
                            device="cpu")
    assert [os.path.basename(p) for p in paths] == ["r_0.png", "r_1.png"]
    with torch.no_grad():
        want = gt.render.render_image_tiled(model, cams[1], device="cpu")
    np.testing.assert_array_equal(gt.io.load_png(paths[1]),
                                  gt.io.to_uint8(want["rgb"].numpy()))
    path = str(tmp_path / "texts" / "hits.txt")
    save_hit_counts(want["hit_count"], path)
    rows = open(path).read().splitlines()
    assert len(rows) == 16 and len(rows[0].split()) == 16
    assert sum(int(v) for r in rows for v in r.split()) == int(
        want["hit_count"].sum())


def _scene_ply(tmp_path):
    path = str(tmp_path / "scene.ply")
    carry(jax_scene(200, seed=0, spread=0.5)).to_ply(path)
    return path


def test_cli_eval_with_gt(tmp_path, capsys):
    ply = _scene_ply(tmp_path)
    cam_json = {"camera_angle_x": 0.69,
                "frames": [{"file_path": f"./r_{i}",
                            "transform_matrix": np.eye(4).tolist()}
                           for i in range(2)]}
    jpath = str(tmp_path / "transforms_val.json")
    with open(jpath, "w") as f:
        json.dump(cam_json, f)
    out_dir = str(tmp_path / "out")
    base = ["eval", "--device", "cpu", "--ply", ply, "--width", "16",
            "--height", "16", "--camera-json", jpath, "--frames", "2"]
    cli_main(base + ["--out", out_dir])
    assert sorted(os.listdir(out_dir)) == ["r_0.png", "r_1.png"]
    # the second run compares against the first as ground truth: PSNR inf
    cli_main(base + ["--out", str(tmp_path / "out2"), "--gt-dir", out_dir])
    out = capsys.readouterr().out
    assert "rendered 2 views" in out and "Average -> PSNR: inf" in out


def test_cli_eval_banded(tmp_path, capsys):
    ply = _scene_ply(tmp_path)
    base = ["eval", "--device", "cpu", "--ply", ply, "--width", "32",
            "--height", "32", "--frames", "2"]
    banded = str(tmp_path / "out_banded")
    cli_main(base + ["--out", banded, "--bands", "2"])
    assert sorted(os.listdir(banded)) == ["r_0.png", "r_1.png"]
    unbanded = str(tmp_path / "out_unbanded")
    cli_main(base + ["--out", unbanded, "--gt-dir", banded])
    out = capsys.readouterr().out
    assert "Average -> PSNR: inf" in out
    for f in ("r_0.png", "r_1.png"):
        assert gt.io.load_png(os.path.join(banded, f)).max() > 0
        np.testing.assert_array_equal(
            gt.io.load_png(os.path.join(banded, f)),
            gt.io.load_png(os.path.join(unbanded, f)))
