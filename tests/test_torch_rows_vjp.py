"""PyTorch port, the parameter-layer VJP (render/rows_vjp.py).

The table of `frame_params`, with its hand-derived backward, against
JAX's `rows64_from_model` on the same model and cotangent, and against
torch autograd of `param_rows(model.activate())`.  Tolerance: 2e-6 of
each leaf's largest gradient (tests/test_rows_vjp.py's CPU bound).  On the
CPU `frame_params` takes the plain route whatever `impl` allows, with no
kernel launched; impl "cuda" raises (the table's kernels are checked on the
card in tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gvrt_tpu as g3
from gvrt_tpu.render.rows_vjp import rows64_from_model as jax_rows64
from gvrt_tpu_torch.models.gaussians import LEAVES
from gvrt_tpu_torch.render.binning import param_rows
from gvrt_tpu_torch.render.rows_vjp import frame_params

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
    rows = frame_params(tm, torch_cfg(CFG))[1]
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
    rows = frame_params(tm, cfg)[1]
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
    rows = frame_params(tm, cfg)[1]
    idx = torch.from_numpy(np.random.default_rng(6).integers(
        0, 301, size=4 * 64).astype(np.int32))
    none = torch.zeros(1, dtype=torch.int32)
    chunks = chunked_gather(64, rows, idx, none, none, none)
    assert rows.grad_fn is not None and chunks.grad_fn is not None
    with torch.no_grad():
        rows_ng = frame_params(tm, cfg)[1]
        chunks_ng = chunked_gather(64, rows_ng, idx, none, none, none)
    assert rows_ng.grad_fn is None and chunks_ng.grad_fn is None
    torch.testing.assert_close(rows_ng, rows.detach(), rtol=0, atol=0)
    torch.testing.assert_close(chunks_ng, chunks.detach(), rtol=0, atol=0)


def test_rows64_dummy_row_cotangent_is_ignored():
    tm = carry(jax_scene(64, seed=2))
    g = torch.zeros((65, 64))
    g[64] = 1.0
    frame_params(tm, torch_cfg(CFG))[1].backward(g)
    for k in LEAVES:
        assert not getattr(tm, k).grad.any(), k


def test_frame_params_cuda_impl_raises_on_the_cpu():
    """The table's kernels run on the card only: impl "cuda" with CPU
    leaves raises, and so do the kernel wrappers themselves."""
    from gvrt_tpu_torch.render import rows_vjp
    tm = carry(jax_scene(40, seed=7))
    with pytest.raises(ValueError, match="CUDA"):
        frame_params(tm, torch_cfg(CFG), impl="cuda")
    leaves = tuple(p.detach() for p in tm.leaves())
    with pytest.raises(ValueError, match="CUDA"):
        rows_vjp.param_table_forward(*leaves)
    with pytest.raises(ValueError, match="CUDA"):
        rows_vjp.param_table_backward(torch.zeros((41, 64)), leaves)


def test_table_kernels_are_dispatcher_ops():
    """Each table kernel launches inside an op of its own,
    `gvrt_port::param_table_forward` and `::param_table_backward`, defined
    once a process with a CUDA kernel alone, so that a profiler links the
    kernel to a host op inside the caller's range."""
    from gvrt_tpu_torch.render import rows_vjp
    ns = rows_vjp._ops()
    assert rows_vjp._ops() is ns and len(rows_vjp._library) == 1
    tm = carry(jax_scene(40, seed=7))
    leaves = tuple(p.detach() for p in tm.leaves())
    with pytest.raises(NotImplementedError, match="CPU"):
        ns.param_table_forward(*leaves)
    with pytest.raises(NotImplementedError, match="CPU"):
        ns.param_table_backward(torch.zeros((41, 64)), *leaves)


def _bits(x):
    return x.detach().contiguous().view(torch.int32)


@pytest.mark.parametrize("impl", ["auto", "torch"])
def test_frame_params_on_the_cpu_takes_the_plain_route(impl):
    """"auto" and "torch" on the CPU: the table and the activated view are
    `activate_leaves` + `param_rows`' bits, the gradients the plain
    backward's, with no kernel launched and no kernel counted."""
    from gvrt_tpu_torch.models.gaussians import activate_leaves
    from gvrt_tpu_torch.render import rows_vjp
    from gvrt_tpu_torch.utils import profiling
    tm = carry(jax_scene(200, seed=9))
    cfg = torch_cfg(CFG)
    g = torch.from_numpy(_cotangent(200, seed=10))
    before = (rows_vjp.param_table_forward.launches,
              rows_vjp.param_table_backward.launches)
    profiling.reset()
    with torch.profiler.profile():
        act, rows = frame_params(tm, cfg, impl=impl)
        rows.backward(g)
    rec = profiling.recorded()
    profiling.reset()
    assert (rows_vjp.param_table_forward.launches,
            rows_vjp.param_table_backward.launches) == before
    assert "gvrt.param_table.kernel" not in rec["counts"]
    assert "gvrt.param_table.bwd.kernel" not in rec["counts"]
    assert rec["spans"]["gvrt.param_table"]["calls"] == 2
    assert rec["spans"]["gvrt.param_table.bwd"]["calls"] == 1
    leaves = tuple(p.detach() for p in tm.leaves())
    with torch.no_grad():
        act_p = activate_leaves(*leaves)
        rows_p = param_rows(act_p, cfg)
    assert torch.equal(_bits(rows), _bits(rows_p))
    for field in act_p._fields:
        assert torch.equal(_bits(getattr(act, field)),
                           _bits(getattr(act_p, field))), field
    want = rows_vjp._plain_backward(g, *leaves[:4])
    for k, w in zip(LEAVES, want):
        assert torch.equal(_bits(getattr(tm, k).grad), _bits(w)), k
