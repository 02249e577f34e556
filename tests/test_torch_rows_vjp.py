"""PyTorch port, the parameter-layer VJP (render/rows_vjp.py).

`rows64_from_model`'s hand-derived backward against JAX's on the same
model and cotangent, and against torch autograd of
`param_rows(model.activate())`.  Tolerance: 2e-6 of each leaf's largest
gradient (tests/test_rows_vjp.py's CPU bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import gvrt_tpu as g3
from gvrt_tpu.render.rows_vjp import rows64_from_model as jax_rows64
from gvrt_tpu_torch.models.gaussians import LEAVES
from gvrt_tpu_torch.render.binning import param_rows
from gvrt_tpu_torch.render.rows_vjp import rows64_from_model

from port_scenes import carry, jax_scene, torch_cfg

CFG = g3.DEFAULT_CONFIG


def _scaled_close(got, want, name):
    want = np.asarray(want)
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale,
                               atol=2e-6, err_msg=name)


def _cotangent(n, seed=1):
    return np.random.default_rng(seed).normal(size=(n + 1, 64)).astype(
        np.float32)


def test_rows64_backward_matches_jax():
    jm = jax_scene(700, seed=0)
    g = _cotangent(700)
    rows_j, vjp = jax.vjp(lambda m: jax_rows64(m, CFG), jm)
    (want,) = vjp(jnp.asarray(g))
    tm = carry(jm)
    rows = rows64_from_model(tm, torch_cfg(CFG))
    # XLA contracts the frame columns' products into FMAs on the CPU and
    # torch does not: 1e-5 of each column's magnitude (ROADMAP.md section 3)
    rows_j = np.asarray(rows_j)
    np.testing.assert_allclose(rows.detach().numpy() / (
        np.abs(rows_j).max(0) + 1e-12), rows_j / (np.abs(rows_j).max(0)
                                                  + 1e-12), atol=1e-5)
    rows.backward(torch.from_numpy(g))
    for k in LEAVES:
        _scaled_close(getattr(tm, k).grad.numpy(), getattr(want, k), k)


def test_rows64_backward_matches_torch_autograd():
    tm = carry(jax_scene(500, seed=3))
    g = torch.from_numpy(_cotangent(500, seed=4))
    cfg = torch_cfg(CFG)
    rows = rows64_from_model(tm, cfg)
    rows.backward(g)
    got = {k: getattr(tm, k).grad.clone() for k in LEAVES}
    tm.zero_grad(set_to_none=True)
    plain = param_rows(tm.activate(), cfg)
    torch.testing.assert_close(rows.detach(), plain.detach(), rtol=0, atol=0)
    plain.backward(g)
    for k in LEAVES:
        _scaled_close(got[k].numpy(), getattr(tm, k).grad.numpy(), k)


def test_rows64_and_gather_without_grad_are_the_bare_forward():
    """Under no_grad neither Function is entered: the same bits, no graph."""
    from gvrt_tpu_torch.render.param_grads import chunked_gather
    tm = carry(jax_scene(300, seed=5))
    cfg = torch_cfg(CFG)
    rows = rows64_from_model(tm, cfg)
    idx = torch.from_numpy(np.random.default_rng(6).integers(
        0, 301, size=4 * 64).astype(np.int32))
    none = torch.zeros(1, dtype=torch.int32)
    chunks = chunked_gather(64, rows, idx, none, none, none)
    assert rows.grad_fn is not None and chunks.grad_fn is not None
    with torch.no_grad():
        rows_ng = rows64_from_model(tm, cfg)
        chunks_ng = chunked_gather(64, rows_ng, idx, none, none, none)
    assert rows_ng.grad_fn is None and chunks_ng.grad_fn is None
    torch.testing.assert_close(rows_ng, rows.detach(), rtol=0, atol=0)
    torch.testing.assert_close(chunks_ng, chunks.detach(), rtol=0, atol=0)


def test_rows64_dummy_row_cotangent_is_ignored():
    tm = carry(jax_scene(64, seed=2))
    g = torch.zeros((65, 64))
    g[64] = 1.0
    rows64_from_model(tm, torch_cfg(CFG)).backward(g)
    for k in LEAVES:
        assert not getattr(tm, k).grad.any(), k
