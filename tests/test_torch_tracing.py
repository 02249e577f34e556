"""The port's spans and counters (`utils/profiling.py`): what a frame and
a training step record, on the CPU, and on the card the host-sync counter
against PyTorch's own sync debug mode.

The CPU tests build small scenes with `gt.random_gaussians` (no JAX), so
the file also runs where JAX is not installed; the card test is marked
`cuda` and skips without a card:

    python -m pytest tests/test_torch_tracing.py -q --noconftest \
        -p no:cacheprovider
"""

import json
import os
import sys
import warnings

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import gvrt_tpu_torch as gt  # noqa: E402
from gvrt_tpu_torch.utils import profiling  # noqa: E402

RES = 32
CFG = gt.DEFAULT_CONFIG.replace(tile_size=8, chunk_size=64)
FRAME_SPANS = ("gvrt.rays", "gvrt.binning", "gvrt.param_table",
               "gvrt.gather", "gvrt.composite")
BINNING_STAGES = ("gvrt.binning.cull", "gvrt.binning.expand",
                  "gvrt.binning.sort", "gvrt.binning.layout")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def empty_record():
    profiling.reset()
    yield
    profiling.reset()


def _scene(device, n=300, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    model = gt.random_gaussians(g, n, extent=0.6, device=device)
    with torch.no_grad():
        model.means[:, 2] -= 3.0
    return model


def _camera(dx=0.0):
    c2w = np.eye(4)
    c2w[0, 3] = dx
    return gt.Camera.from_fovy(RES, RES, 60.0, c2w)


def _frame(device):
    """A planned renderer, the model and a camera; the frame renders."""
    model = _scene(device)
    r = gt.render.TiledRenderer(RES, RES, CFG, device=device)
    cam = _camera()
    r.plan(model, [cam])
    return r, model, cam


def _unbanded(device):
    """A step closure of the unbanded trainer (one camera a step)."""
    model = _scene(device, seed=1)
    cam = _camera(0.02)
    planner = gt.render.TiledRenderer(RES, RES, CFG, device=device)
    trainer = gt.train.Trainer(RES, RES, CFG, gt.train.TrainConfig(),
                               planner.plan(model, [cam]), device=device)
    state = [trainer.init(model)]
    batch = gt.parallel.camera_batch([cam], CFG, device)
    target = torch.rand((1, RES, RES, 3), generator=torch.Generator(
        device=device).manual_seed(2), device=device)

    def step():
        state[0], _ = trainer.step(state[0], batch, target)
    return step


def _banded(device):
    """A step closure of the banded trainer: 2 span bands, remat "full";
    its first step binds."""
    model = _scene(device, seed=3)
    cam = _camera(-0.02)
    model = model.sorted_for_camera(cam, CFG)
    tc = gt.train.TrainConfig(span_bands=True, banded_remat="full")
    trainer = gt.train.Trainer(RES, RES, CFG, tc, n_bands=2, device=device)
    state = [trainer.init(model)]
    target = torch.rand((RES, RES, 3), generator=torch.Generator(
        device=device).manual_seed(4), device=device)

    def step():
        state[0], _ = trainer.step(state[0], cam, target)
    return step


def _log():
    """Every span closed since the last reset, in closing order: (name,
    the parent's name or None, unit, host ms)."""
    closed = list(profiling._closed)
    names = {sid: name for name, sid, *_ in closed}
    return [(name, names.get(parent), unit, 1e3 * (t1 - t0))
            for name, _, parent, unit, t0, t1, _, _ in closed]


def _parents(log, name):
    return {p for n, p, _, _ in log if n == name}


def test_off_records_nothing():
    r, model, cam = _frame("cpu")
    with torch.no_grad():
        r.render(model, cam)
    _unbanded("cpu")()
    _banded("cpu")()
    assert not torch.autograd.profiler._is_profiler_enabled
    assert profiling.recorded() == {"spans": {}, "counts": {}, "units": {}}
    assert _log() == []


def test_frame_spans_parents_and_units():
    r, model, cam = _frame("cpu")
    with torch.profiler.profile():
        assert torch.autograd.profiler._is_profiler_enabled
        with torch.no_grad():
            r.render(model, cam)
            r.render(model, _camera(0.01))
    rec, log = profiling.recorded(), _log()
    assert rec["units"] == {"gvrt.frame": 2}
    assert rec["spans"]["gvrt.frame"]["calls"] == 2
    assert _parents(log, "gvrt.frame") == {None}
    for name in FRAME_SPANS:
        assert _parents(log, name) == {"gvrt.frame"}, name
        # the parameter table twice a frame: the activation, the rows
        calls = 4 if name == "gvrt.param_table" else 2
        assert rec["spans"][name]["calls"] == calls, name
    for name in BINNING_STAGES:
        assert _parents(log, name) == {"gvrt.binning"}, name
    # no grad: no reduce plan
    assert "gvrt.binning.reduce_plan" not in rec["spans"]
    for name in ("gvrt.rays.numpy", "gvrt.rays.upload", "gvrt.rays.rows"):
        assert _parents(log, name) == {"gvrt.rays"}, name
    # each span's unit is the frame it ran in
    units = {}
    for name, _, unit, _ in log:
        units.setdefault(name, []).append(unit)
    for name in FRAME_SPANS + BINNING_STAGES + ("gvrt.frame",):
        assert set(units[name]) == {1, 2}, name
        assert units[name].count(1) == units[name].count(2), name
    assert rec["counts"]["gvrt.pairs"] > 0
    assert rec["counts"].get("gvrt.host_syncs", 0) == 0   # the CPU's
    assert all(row["device_ms"] is None for row in rec["spans"].values())


def test_rays_on_the_cpu_keep_the_plain_route():
    """`tile_rays` with impl "auto" on the CPU: NumPy, the upload and
    `tile_ray_rows` under their spans, bit for bit `tile_ray_rows` of
    `Camera.rays()`; no kernel span or counter."""
    cam = _camera(0.01)
    o, d = cam.rays()
    want = gt.render.binning.tile_ray_rows(torch.from_numpy(o),
                                           torch.from_numpy(d), CFG)
    with torch.profiler.profile():
        got = gt.render.binning.tile_rays(cam, CFG, "cpu")
    rec, log = profiling.recorded(), _log()
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert _parents(log, "gvrt.rays") == {None}
    for name in ("gvrt.rays.numpy", "gvrt.rays.upload", "gvrt.rays.rows"):
        assert _parents(log, name) == {"gvrt.rays"}, name
        assert rec["spans"][name]["calls"] == 1, name
    assert "gvrt.rays.kernel" not in rec["spans"]
    assert "gvrt.rays.kernel" not in rec["counts"]


def test_cpu_run_fills_count_no_scan_kernel():
    """On the CPU binning's run fills take the plain cummax: a frame and an
    unbanded step bin, and the max-scan kernel's counter stays at 0."""
    r, model, cam = _frame("cpu")
    step = _unbanded("cpu")
    with torch.profiler.profile():
        with torch.no_grad():
            r.render(model, cam)
        step()
    rec = profiling.recorded()
    assert rec["units"] == {"gvrt.frame": 1, "gvrt.step": 1}
    assert rec["counts"]["gvrt.pairs"] > 0
    assert rec["counts"].get("gvrt.binning.scan", 0) == 0


def test_cpu_expansion_counts_no_pair_kernel():
    """On the CPU binning's pair expansion takes its plain version: a frame
    and an unbanded step bin, `expand_pairs` counts no launch and the pair
    kernel's counter stays at 0."""
    expand = gt.render.binning.expand_pairs
    r, model, cam = _frame("cpu")
    step = _unbanded("cpu")
    before = expand.launches
    with torch.profiler.profile():
        with torch.no_grad():
            r.render(model, cam)
        step()
    rec = profiling.recorded()
    assert rec["units"] == {"gvrt.frame": 1, "gvrt.step": 1}
    assert rec["spans"]["gvrt.binning.expand"]["calls"] == 2
    assert expand.launches == before
    assert rec["counts"].get("gvrt.binning.expand.kernel", 0) == 0


def test_self_time_is_duration_less_children():
    r, model, cam = _frame("cpu")
    with torch.profiler.profile():
        with torch.no_grad():
            r.render(model, cam)
    rec, log = profiling.recorded(), _log()
    for name in ("gvrt.frame", "gvrt.binning", "gvrt.rays"):
        row = rec["spans"][name]
        inner = sum(ms for _, p, _, ms in log if p == name)
        assert inner > 0, name
        assert row["self_host_ms"] == pytest.approx(row["host_ms"] - inner,
                                                    abs=1e-6), name
        assert 0 < row["self_host_ms"] < row["host_ms"]
    leaf = rec["spans"]["gvrt.binning.sort"]
    assert leaf["self_host_ms"] == pytest.approx(leaf["host_ms"])


def test_rays_built_each_frame():
    """Two frames of one camera build its rays twice: the renderer holds
    no rays between frames."""
    r, model, cam = _frame("cpu")
    with torch.profiler.profile():
        with torch.no_grad():
            r.render(model, cam)
            r.render(model, cam)
    rec = profiling.recorded()
    assert rec["counts"]["gvrt.rays.built"] == 2
    assert "gvrt.rays.cache_hit" not in rec["counts"]
    assert rec["spans"]["gvrt.rays"]["calls"] == 2


@pytest.mark.parametrize("path", ("unbanded", "banded"))
def test_step_spans_and_parents(path):
    step = (_unbanded if path == "unbanded" else _banded)("cpu")
    with torch.profiler.profile():
        step()
    rec, log = profiling.recorded(), _log()
    assert rec["units"] == {"gvrt.step": 1}
    assert {u for _, _, u, _ in log} == {1}
    for name in ("gvrt.loss", "gvrt.backward", "gvrt.optimizer"):
        assert _parents(log, name) == {"gvrt.step"}, name
    for name in ("gvrt.composite.bwd", "gvrt.gather.bwd"):
        assert _parents(log, name) == {"gvrt.backward"}, name
    assert rec["counts"].get("gvrt.host_syncs", 0) == 0
    if path == "unbanded":
        for name in ("gvrt.binning", "gvrt.param_table", "gvrt.gather",
                     "gvrt.composite"):
            assert _parents(log, name) == {"gvrt.step"}, name
        assert _parents(log, "gvrt.binning.reduce_plan") == {"gvrt.binning"}
        assert "gvrt.rays" not in rec["spans"]   # the batch holds its rays
        # the table's hand-derived backward, from the rows to the leaves
        assert _parents(log, "gvrt.param_table.bwd") == {"gvrt.backward"}
        assert rec["spans"]["gvrt.param_table.bwd"]["calls"] == 1
        return
    # banded: the first step binds; "full" remat gathers and composites
    # again inside the backward
    assert _parents(log, "gvrt.bind") == {"gvrt.step"}
    assert rec["spans"]["gvrt.bind"]["calls"] == 1   # Trainer's and the
    for name in ("gvrt.plan", "gvrt.rays", "gvrt.binning"):  # renderer's
        assert _parents(log, name) == {"gvrt.bind"}, name
    assert rec["spans"]["gvrt.binning"]["calls"] == 2   # one a band
    assert _parents(log, "gvrt.binning.reduce_plan") == {"gvrt.binning"}
    # the table, and the activation that the plan's and the bind's cull
    # tables read
    assert _parents(log, "gvrt.param_table") == {"gvrt.step", "gvrt.plan",
                                                 "gvrt.bind"}
    assert _parents(log, "gvrt.param_table.bwd") == {"gvrt.backward"}
    for name in ("gvrt.gather", "gvrt.composite"):
        assert _parents(log, name) == {"gvrt.step", "gvrt.backward"}, name
        assert rec["spans"][name]["calls"] == 4, name


def test_span_is_a_decorator_and_a_context_manager():
    @profiling.span("t.outer")
    def outer():
        with profiling.span("t.inner"):
            with profiling.span("t.inner"):   # counts once
                profiling.count("t.n", torch.tensor(2))
                profiling.count("t.n")
        return 7

    assert outer() == 7
    assert profiling.recorded()["spans"] == {}
    with torch.profiler.profile():
        assert outer() == 7
    rec = profiling.recorded()
    assert rec["spans"]["t.inner"]["calls"] == 1
    assert rec["counts"] == {"t.n": 3}
    assert rec["units"] == {"t.outer": 1}
    assert _log()[0][:3] == ("t.inner", "t.outer", 1)


def _wall():
    """A camera-facing wall over the left half of the image, behind the
    scenes of `_scene`."""
    from gvrt_tpu_torch.hybrid.mesh import (Light, Material, MeshScene,
                                            _quad)
    s = MeshScene()
    pos, idx = _quad([-5, -5, -4], [-5, 5, -4], [0, 5, -4], [0, -5, -4])
    s.add_object("wall", pos, idx, Material(
        base_color=(1.0, 1.0, 1.0, 1.0), metallic=0.0, roughness=1.0,
        emissive=(0.5, 0.5, 0.5)))
    s.lights.append(Light(position=(0.0, 0.0, 0.0), color=(1, 1, 1),
                          radius=50.0))
    return s


def _backward(rgb):
    with profiling.span("gvrt.backward"):
        ((rgb - 0.3) ** 2).mean().backward()


def _differentiated(path, model):
    """One differentiated frame (or unbanded Trainer step) of `path`
    through `model`, on the CPU."""
    cam = _camera(0.01)
    cap = gt.render.TiledRenderer(RES, RES, CFG, device="cpu").plan(
        model, [cam])
    if path == "render":
        r = gt.render.TiledRenderer(RES, RES, CFG, capacity=cap,
                                    device="cpu")
        _backward(r.render(model, cam)["rgb"])
    elif path == "trainer":
        t = gt.train.Trainer(RES, RES, CFG, gt.train.TrainConfig(), cap,
                             device="cpu")
        t.step(t.init(model), gt.parallel.camera_batch([cam], CFG, "cpu"),
               torch.full((1, RES, RES, 3), 0.3))
    elif path == "banded":
        r = gt.render.BandedRenderer(RES, RES, 2, CFG, span=True,
                                     device="cpu")
        r.bind(model, cam)
        _backward(r.render_bound(model)["rgb"])
    elif path == "combined":
        hcfg = gt.hybrid.HybridConfig(reflection=False, refraction=False,
                                      shadow_rays=False)
        _backward(gt.render.render_combined(model, _wall(), cam, CFG, hcfg,
                                            capacity=cap)["rgb"])
    else:   # a one-rank mesh without a process group
        mesh = gt.parallel.make_mesh(1, devices=["cpu"])
        if path == "batch_sharded":
            img = gt.parallel.render_batch_sharded(
                model, gt.parallel.camera_batch([cam], CFG, "cpu"), mesh,
                RES, RES, CFG, *cap)
        else:
            img = gt.parallel.render_image_tile_sharded(model, cam, mesh,
                                                        CFG)
        _backward(img[..., 0:3])


@pytest.mark.parametrize("path", ("render", "trainer", "batch_sharded",
                                  "tile_sharded", "combined", "banded"))
def test_table_backward_is_the_hand_vjp(monkeypatch, path):
    """Every differentiated render path takes the table's hand-derived
    backward (`rows_vjp._Rows64`) once a frame, inside `gvrt.backward`,
    and the leaves' gradients equal plain autograd's through
    `param_rows(model.activate())` with the same table cotangent, within
    4e-6 of each leaf's largest.  On these render cotangents each float32
    chain is up to 2.6e-6 of the quaternions' largest gradient off
    float64 autograd's, twice tests/test_torch_rows_vjp.py's 2e-6 (a
    random cotangent there): the bound is the two errors' sum."""
    from gvrt_tpu_torch.render import rows_vjp
    from gvrt_tpu_torch.render.binning import param_rows
    seen = []
    hand = rows_vjp._Rows64.backward

    def backward(ctx, g):
        seen.append(g.clone())
        return hand(ctx, g)
    monkeypatch.setattr(rows_vjp._Rows64, "backward", staticmethod(backward))
    model = _scene("cpu", n=300, seed=8)
    if path == "banded":
        model = model.sorted_for_camera(_camera(0.01), CFG)
    # copies: on the CPU `to_numpy` shares the leaves' memory, which the
    # trainer's optimizer step moves
    before = {k: v.copy() for k, v in model.to_numpy().items()}
    with torch.profiler.profile():
        _differentiated(path, model)
    rec, log = profiling.recorded(), _log()
    assert rec["spans"]["gvrt.param_table.bwd"]["calls"] == 1
    assert _parents(log, "gvrt.param_table.bwd") == {"gvrt.backward"}
    assert len(seen) == 1
    plain = gt.GaussianModel.from_numpy(before, "cpu")
    param_rows(plain.activate(), CFG).backward(seen[0])
    for k in gt.models.gaussians.LEAVES:
        got = getattr(model, k).grad.numpy()
        want = getattr(plain, k).grad.numpy()
        scale = np.abs(want).max() + 1e-12
        assert np.abs(want).max() > 0, k
        np.testing.assert_allclose(got / scale, want / scale, atol=4e-6,
                                   err_msg=k)


@pytest.mark.parametrize("mode", (0, 1))
def test_sync_watch_counts_and_passes_on(monkeypatch, mode):
    """A root span's watch turns sync debug mode on where it was off,
    counts its warnings into the host-sync counter and passes every other
    warning on, and these too where the mode was on already."""
    modes = [mode]
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: modes[0])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda m: modes.__setitem__(0, m))
    with torch.profiler.profile():
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            watch = profiling._SyncWatch()
            assert modes[0] == 1
            for _ in range(2):
                warnings.warn("called a synchronizing CUDA operation")
            warnings.warn("another warning")
            watch.close()
    assert modes[0] == mode
    assert profiling.recorded()["counts"] == {profiling.HOST_SYNCS: 2}
    passed = sorted(str(w.message) for w in seen)
    assert passed == (["another warning"] if mode == 0 else [
        "another warning"] + 2 * ["called a synchronizing CUDA operation"])


def test_trace_writes_the_span_table(tmp_path):
    r, model, cam = _frame("cpu")
    logdir = str(tmp_path / "prof")
    with profiling.trace(logdir):
        with torch.no_grad():
            r.render(model, cam)
    with open(os.path.join(logdir, "trace.json")) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert {"gvrt.frame", "gvrt.binning", "gvrt.rays.numpy"} <= names
    with open(os.path.join(logdir, "span_table.json")) as f:
        table = json.load(f)
    assert table["units"] == {"gvrt.frame": 1}
    assert table["spans"]["gvrt.composite"]["calls"] == 1
    assert table["counts"]["gvrt.rays.built"] == 1


def test_allreduce_spans_and_counters(tmp_path):
    """Two gloo ranks of `Trainer(mesh)` (tests/port_parallel_worker.py,
    mode "tracing"), two steps of a view a rank: on each rank
    `gvrt.allreduce`, `.pack` and `.unpack` open once a step, the bucket's
    bytes count 4 x (the leaves' elements + the loss) a step, the ranks
    2 a step, and the model's broadcast is one `gvrt.replicate`."""
    import port_parallel_worker as w
    model = _scene("cpu", n=200, seed=6)
    c2w = np.tile(np.eye(4), (2, 2, 1, 1))
    c2w[:, :, 0, 3] = [[0.0, 0.02], [-0.02, 0.01]]
    targets = np.random.default_rng(7).uniform(
        0.0, 0.5, (2, 2, w.DP_RES, w.DP_RES, 3)).astype(np.float32)
    np.savez(tmp_path / "inputs.npz", c2w=c2w, targets=targets,
             **model.to_numpy())
    w.start_ranks("tracing", tmp_path, world=2)()
    numel = sum(p.numel() for p in model.leaves())
    for r in range(2):
        rec = json.loads(str(np.load(tmp_path / f"out{r}.npz")["record"]))
        assert rec["units"]["gvrt.step"] == 2
        for name in ("gvrt.allreduce", "gvrt.allreduce.pack",
                     "gvrt.allreduce.unpack"):
            assert rec["spans"][name]["calls"] == 2, (r, name)
        assert rec["spans"]["gvrt.replicate"]["calls"] == 1
        assert rec["counts"]["gvrt.allreduce.bytes"] == 2 * 4 * (numel + 1)
        assert rec["counts"]["gvrt.ranks"] == 2 * 2


def _pose_refiner(device, camera=None):
    """A `PoseRefiner` of a perturbed camera against the true camera's
    render (its bind recorded where the profiler records)."""
    model = _scene(device, seed=2)
    cam = _camera()
    with torch.no_grad():
        target = gt.render.render_image_tiled(model, cam, CFG,
                                              device=device)["rgb"]
    bad = camera or gt.train.perturb_cameras([cam], 0.03, seed=1)[0]
    return gt.train.PoseRefiner(model, bad, target, CFG)


def test_pose_step_spans_and_counters():
    """A pose step opens `gvrt.pose.rays` (the posed rays) and, inside its
    backward, `gvrt.pose.rays.bwd` once each; every bind counts one
    `gvrt.pose.binds`; the CLI's loop, a refiner per camera, records the
    same per step."""
    with torch.profiler.profile():
        refiner = _pose_refiner("cpu")
        refiner.initial_loss()
        for _ in range(3):
            refiner.step()
    rec, log = profiling.recorded(), _log()
    assert rec["units"]["gvrt.step"] == 3
    assert rec["counts"]["gvrt.pose.binds"] == 1
    assert rec["spans"]["gvrt.bind"]["calls"] == 1
    for name in ("gvrt.pose.rays.bwd", "gvrt.backward", "gvrt.optimizer"):
        assert rec["spans"][name]["calls"] == 3, name
    # the base pose's loss runs the posed rays once more, outside a step
    assert rec["spans"]["gvrt.pose.rays"]["calls"] == 4
    assert [p for n, p, _, _ in log if n == "gvrt.pose.rays"] == \
        [None] + ["gvrt.step"] * 3
    assert _parents(log, "gvrt.pose.rays.bwd") == {"gvrt.backward"}
    assert "gvrt.pose.rays" in _parents(log, "gvrt.rays.rows")
    assert "gvrt.composite.bwd.rays" not in rec["counts"]   # no kernel here

    profiling.reset()
    model = _scene("cpu", seed=2)
    cams = [_camera(), _camera(0.02)]
    with torch.no_grad():
        targets = [gt.render.render_image_tiled(model, c, CFG,
                                                device="cpu")["rgb"]
                   for c in cams]
    with torch.profiler.profile():
        gt.train.optimize_camera_poses(model, cams, targets, CFG, steps=2,
                                       verbose=False)
    rec = profiling.recorded()
    assert rec["counts"]["gvrt.pose.binds"] == 2
    assert rec["units"]["gvrt.step"] == 4
    assert rec["spans"]["gvrt.pose.rays.bwd"]["calls"] == 4


# ---- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the tile kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _syncs(fn):
    """(the host-sync counter, the synchronizing calls that sync debug
    mode warns of, their places) over one call of `fn` under the
    profiler."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        profiling.reset()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode(1)
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    synced = [w for w in caught
              if "called a synchronizing CUDA operation" in str(w.message)]
    counted = profiling.recorded()["counts"].get(profiling.HOST_SYNCS, 0)
    return counted, len(synced), sorted(
        f"{os.path.basename(w.filename)}:{w.lineno}" for w in synced)


@pytest.mark.cuda
def test_frame_rays_come_from_the_kernel(cuda):
    """On the card a frame's rays are one kernel launch under `gvrt.rays`,
    counted once per build; the plain route's spans stay shut."""
    r, model, cam = _frame(cuda)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        with torch.no_grad():
            r.render(model, cam)
            r.render(model, _camera(0.01))
            r.render(model, cam)   # built again: no rays are held
        torch.cuda.synchronize()
    rec, log = profiling.recorded(), _log()
    assert _parents(log, "gvrt.rays.kernel") == {"gvrt.rays"}
    assert rec["spans"]["gvrt.rays.kernel"]["calls"] == 3
    assert rec["counts"]["gvrt.rays.kernel"] == 3
    assert rec["counts"]["gvrt.rays.built"] == 3
    for name in ("gvrt.rays.numpy", "gvrt.rays.upload", "gvrt.rays.rows"):
        assert name not in rec["spans"], name


@pytest.mark.cuda
def test_run_fills_come_from_the_scan_kernel(cuda):
    """On the card each of binning's run fills is one launch of the max-scan
    kernel, counted as `gvrt.binning.scan`: three a serving frame (pair ->
    Gaussian, chunk -> tile, sorted pair -> slot delta), four an unbanded
    step's bind (and reduce block -> output group)."""
    scan = gt.render.scan
    r, model, cam = _frame(cuda)
    step = _unbanded(cuda)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        before = scan.max_scan.launches
        with torch.no_grad():
            r.render(model, cam)
            r.render(model, _camera(0.01))
        frames = scan.max_scan.launches - before
        step()
        torch.cuda.synchronize()
    steps = scan.max_scan.launches - before - frames
    rec = profiling.recorded()
    assert (frames, steps) == (6, 4)
    assert rec["counts"]["gvrt.binning.scan"] == 10


@pytest.mark.cuda
@pytest.mark.parametrize("path", ("unbanded", "banded"))
def test_table_kernels_run_inside_their_ranges(cuda, path):
    """In the profiler's events each parameter-table kernel links to a host
    op that opens inside its `gvrt.param_table` or `gvrt.param_table.bwd`
    range, so the layer's device time as `portbench/program_record.py`
    reads it is both kernels' time and nothing else."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    from portbench import program_record
    step = (_unbanded if path == "unbanded" else _banded)(cuda)
    step()   # builds the kernels and, banded, binds
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        # the first device work of a window can go unrecorded: let it be
        # this, not a table kernel
        torch.ones(1, device=cuda).add_(1.0)
        torch.cuda.synchronize()
        step()
        step()
        torch.cuda.synchronize()
    kernels = ("param_table_forward_kernel", "param_table_backward_kernel")
    us = {k: [e.duration_ns() / 1e3
              for e in prof.profiler.kineto_results.events()
              if e.device_type() != DeviceType.CPU and k in e.name()]
          for k in kernels}
    assert all(us.values()), {k: len(v) for k, v in us.items()}
    got = program_record.launched_ms_per_unit(
        SimpleNamespace(prof=prof), "gvrt.step",
        ["gvrt.param_table", "gvrt.param_table.bwd"])
    want = sum(sum(v) for v in us.values()) / 1e3 / 2
    assert got == pytest.approx(want, rel=1e-9)


@pytest.mark.cuda
def test_host_syncs_match_sync_debug_mode(cuda):
    r, model, cam = _frame(cuda)
    unbanded, banded = _unbanded(cuda), _banded(cuda)
    with torch.no_grad():
        r.render(model, _camera(0.03))   # builds K1
    unbanded()

    def frame():
        with torch.no_grad():
            r.render(model, cam)

    got = {name: _syncs(fn) for name, fn in (
        ("frame", frame), ("unbanded step", unbanded),
        ("banded step (binds)", banded), ("banded step (held)", banded))}
    for name, (counted, warned, where) in got.items():
        assert warned > 0, name
        assert counted == warned, (name, counted, where)


@pytest.mark.cuda
def test_pose_step_counts_its_ray_gradient_launch(cuda):
    """On the card a pose step launches K2's ray-gradient instance once,
    counted as `gvrt.composite.bwd.rays`; a training step, whose rays are
    constants, counts none."""
    refiner = _pose_refiner(cuda)
    step = _unbanded(cuda)
    refiner.step()   # builds the kernels
    step()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        profiling.reset()
        for _ in range(3):
            refiner.step()
        step()
        torch.cuda.synchronize()
    rec = profiling.recorded()
    assert rec["units"]["gvrt.step"] == 4
    assert rec["counts"]["gvrt.composite.bwd.rays"] == 3
