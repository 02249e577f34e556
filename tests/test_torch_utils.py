"""The port's profiling and debug utilities, on the CPU, in the style of
tests/test_aux.py and tests/test_debug.py: `FrameTimer`, `device_sync`,
`trace` writing a Chrome trace, `assert_finite`, and `checked` passing a
clean render (and its backward) and naming the op where a planted NaN
first appears."""

import json

import numpy as np
import pytest
import torch

import gvrt_tpu_torch as gt
from gvrt_tpu_torch.utils import (FrameTimer, assert_finite, checked,
                                  device_sync, trace)

from port_scenes import carry, jax_scene, one_torch_thread  # noqa: F401


def _renderer():
    """tests/test_debug.py's render: 32 Gaussians at 16^2, tile 8."""
    model = carry(jax_scene(32, seed=0, spread=0.6))
    cam = gt.Camera.from_fovy(16, 16, 60.0, np.eye(4))
    cfg = gt.DEFAULT_CONFIG.replace(tile_size=8, chunk_size=64)
    r = gt.render.TiledRenderer(16, 16, cfg, device="cpu")
    r.plan(model, [cam])
    return model, r, cam


def test_frame_timer_reports_stats():
    x = torch.ones((64, 64))
    timer = FrameTimer(warmup=1)
    for _ in range(4):
        timer.frame(lambda t: t * 2.0, x)
    s = timer.summary()
    assert s["frames"] == 3
    assert s["mean_ms"] > 0 and s["fps"] > 0
    assert s["best_ms"] <= s["mean_ms"] <= s["worst_ms"]
    assert FrameTimer().summary() == {"frames": 0}


def test_device_sync_returns_value():
    out = device_sync(torch.arange(4.0))
    np.testing.assert_array_equal(out.numpy(), [0, 1, 2, 3])
    tree = {"rgb": torch.zeros(2, 3), "n": 3}
    assert device_sync(tree) is tree
    model = carry(jax_scene(8))
    assert device_sync(model) is model


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "prof")) as prof:
        torch.ones(32, 32).matmul(torch.ones(32, 32))
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in a.key for a in prof.key_averages())


def test_assert_finite():
    assert_finite({"a": torch.ones(3)}, "ok")
    assert_finite(carry(jax_scene(8)), "model")
    with pytest.raises(FloatingPointError,
                       match=r"bad\['a'\]: 1/2 non-finite values"):
        assert_finite({"a": torch.tensor([1.0, float("nan")])}, "bad")
    with pytest.raises(FloatingPointError, match=r"t\[1\]: 1/1 non-finite"):
        assert_finite((torch.ones(2), np.asarray([np.inf])), "t")
    model = carry(jax_scene(8))
    with torch.no_grad():
        model.sh_dc[2, 1] = float("nan")
    with pytest.raises(FloatingPointError, match=r"model\.sh_dc: 1/24"):
        assert_finite(model, "model")


def test_checked_passes_clean_function():
    f = checked(lambda x: torch.sqrt(x) * 2.0)
    np.testing.assert_allclose(f(torch.tensor([1.0, 4.0])).numpy(),
                               [2.0, 4.0])


def test_checked_raises_on_nan():
    f = checked(lambda x: torch.log(x))      # log(-1) -> nan
    with pytest.raises(FloatingPointError, match="aten.log"):
        f(torch.tensor([-1.0]))


def test_checked_render_is_clean_and_names_a_planted_nan():
    model, r, cam = _renderer()
    safe = checked(lambda m: r.render(m, cam)["rgb"])
    img = safe(model)
    assert bool(torch.isfinite(img).all())
    checked(lambda: img.mean().backward())()
    assert bool(torch.isfinite(model.means.grad).all())
    with torch.no_grad():
        model.opacity_logit[3] = float("nan")
    # the first op that sees it: the opacity's activation
    with pytest.raises(FloatingPointError, match="aten.sigmoid"):
        safe(model)
