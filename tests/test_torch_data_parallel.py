"""Data-parallel training of the port against the benchmark's plain
reference (`portbench/reference/batch.py`), on the CPU.

One run of four gloo ranks of tests/port_parallel_worker.py (mode
"data_parallel", its own rendezvous and a 240-s deadline) takes two
`Trainer(mesh)` steps, each a batch of four views, one a rank, on a
3000-Gaussian scene at 64 x 64, tile 16 (the garden cell's tile and
chunk); the reference takes the same two batch steps meanwhile in this
process.  Tolerances, each from the rounding of one side against the
other in float32 (the reference's own blocks, binning and autograd; the
program's gather, plain tile composite and its backward, and the sums of
the collective):

  * the loss: rtol 1e-5 (tests/test_torch_parallel.py's step loss);
  * each leaf's gradient: 2e-4 of the leaf's largest |gradient|
    (tests/test_torch_parallel.py's tile-sharded gradients);
  * the leaves after each step: atol 1e-6 (tests/test_torch_parallel.py's
    sharded step) wherever the element's reference gradient was at least
    1e-3 of its leaf's largest at every step so far.  Below that the
    gradient's own error (up to 2e-4 of the largest, above) is a fifth of
    it or more, and Adam moves an element by about its learning rate
    whatever the gradient's size, so such an element's second step can
    take any value of that size: it is held within twice the leaf's
    learning rate a step (`reference/adam.py`'s rates);
  * every rank's leaves, gradients and loss bit-identical.

And the reference's batch step at a batch of one is its one-view step
(`composite.loss_and_grads` after `binning.bin_frame`, then Adam) bit for
bit.
"""

import numpy as np
import pytest
import torch

from portbench.reference import adam as ref_adam
from portbench.reference import batch as ref_batch
from portbench.reference import binning as ref_bin
from portbench.reference import camera as ref_cam
from portbench.reference import composite as ref_comp
from portbench.reference.math import Settings, activate
from portbench.scene import LEAVES, draw

import port_parallel_worker as w
from port_scenes import one_torch_thread  # noqa: F401

RANKS, STEPS = 4, 2
CONFIG = {"gaussians": 3000, "extent": 1.0, "centre": [0.0, 0.0, -3.0],
          "scale_log_range": [-3.6, -2.8], "opacity_logit_range": [-3.5, 0.5]}
PERTURB = {"opacity_logit": 0.5, "sh_dc": 0.1}
ST = Settings(tile_size=16, chunk_size=64)
SEED = 2 ** 31 + 11


def _views():
    """(STEPS, RANKS) orbit views: every 45 degrees, so a step's views
    share many Gaussians and the two steps' views differ."""
    return [[ref_cam.orbit_view(CONFIG["centre"], 3.0, 45.0 * (k * RANKS + r),
                                w.DP_FOVY, w.DP_RES, w.DP_RES)
             for r in range(RANKS)] for k in range(STEPS)]


def _leaves():
    _, model = draw(CONFIG, SEED, torch.device("cpu"), PERTURB)
    return model


def _targets():
    return np.random.default_rng(5).uniform(
        0.0, 0.6, (STEPS, RANKS, w.DP_RES, w.DP_RES, 3)).astype(np.float32)


def _reference(leaves, views, targets):
    """The reference's batch steps: per step the loss, the gradients and
    the leaves after it."""
    params = [x.clone() for x in leaves]
    opt = ref_adam.Adam(params)
    out = []
    for k in range(STEPS):
        tiles = [ref_cam.to_tiles(torch.as_tensor(t), ST.tile_size)
                 for t in targets[k]]
        loss, grads, _ = ref_batch.batch_step(params, opt, views[k], tiles,
                                              ST)
        out.append((loss, [g.numpy().copy() for g in grads],
                    [p.numpy().copy() for p in params]))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's steps, every rank's outputs) of one 4-rank run."""
    work = tmp_path_factory.mktemp("four_ranks")
    leaves, views, targets = _leaves(), _views(), _targets()
    np.savez(work / "inputs.npz", targets=targets,
             c2w=np.array([[v.c2w for v in step] for step in views]),
             **{k: x.numpy() for k, x in zip(LEAVES, leaves)})
    finish = w.start_ranks("data_parallel", work, world=RANKS)
    try:
        ref = _reference(leaves, views, targets)
    finally:
        finish()
    return ref, [dict(np.load(work / f"out{r}.npz")) for r in range(RANKS)]


def test_ranks_hold_identical_state(runs):
    _, outs = runs
    for r in range(1, RANKS):
        for key, value in outs[0].items():
            np.testing.assert_array_equal(outs[r][key], value,
                                          err_msg=f"rank {r}: {key}")


@pytest.mark.parametrize("k", range(STEPS))
def test_steps_match_the_reference(runs, k):
    ref, (r0, *_) = runs
    loss, grads, params = ref[k]
    np.testing.assert_allclose(float(r0[f"loss{k}"]), loss, rtol=1e-5)
    for i, (name, g, p) in enumerate(zip(LEAVES, grads, params)):
        scale = np.abs(g).max()
        assert scale > 0, name
        np.testing.assert_allclose(r0[f"grad{k}_{name}"] / scale, g / scale,
                                   atol=2e-4, err_msg=name)
        settled = np.ones(g.shape, bool)
        for _, gs, _ in ref[:k + 1]:
            settled &= np.abs(gs[i]) >= 1e-3 * np.abs(gs[i]).max()
        got = r0[f"param{k}_{name}"]
        np.testing.assert_allclose(got[settled], p[settled], atol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(got, p, atol=2 * ref_adam.LEAF_LRS[i]
                                   * (k + 1), err_msg=name)


def test_batch_of_one_is_the_one_view_step():
    leaves, view = _leaves(), _views()[0][0]
    target = ref_cam.to_tiles(torch.as_tensor(_targets()[0, 0]),
                              ST.tile_size)
    params = [x.clone() for x in leaves]
    loss, grads, hits = ref_batch.batch_step(params, ref_adam.Adam(params),
                                             [view], [target], ST)
    w2c, proj = ref_cam.matrices(view, ST)
    binned = ref_bin.bin_frame(activate(*leaves), w2c, proj, view.width,
                               view.height, ST)
    want_loss, want_grads, want_hits = ref_comp.loss_and_grads(
        leaves, binned, ref_cam.tile_rays(view, ST, torch.device("cpu")),
        target, ST)
    want = [x.clone() for x in leaves]
    ref_adam.Adam(want).step(want_grads)
    assert (loss, hits) == (want_loss, want_hits)
    for name, a, b, p, q in zip(LEAVES, grads, want_grads, params, want):
        assert torch.equal(a, b), name
        assert torch.equal(p, q), name
