"""PyTorch port, the banded slice (render/banded.py, the compact gradient
reduce, banded training and the banded CLI) against the JAX package, on the
CPU.

Scenes are built in JAX and carried across (port_scenes.carry), at 32^2 with
tile_size=8 and chunk_size=32 as tests/test_banded.py uses.  What must agree:
  * the host plans (`plan_capacity_banded` stride and contig,
    `plan_capacity_balanced`, `plan_row_split`,
    `plan_compact_reduce_from_table`) and `build_reduce_plan_compact`'s
    seven arrays and overflow: exactly;
  * `segment_reduce_compact_plain` against JAX's K4 in interpret mode, on
    the live compact ids: relative L2 <= 1e-6 (another summation order);
  * the compact route of `chunked_gather` against the full plan at 2e-6 of
    the gradient's scale and the prefix fallback at 2e-4
    (tests/test_banded.py:187-230), and against JAX's `_gather_bwd`;
  * banded images against the port's unbanded render and JAX's banded one:
    rgb and T within 1e-5, hit counts equal;
  * banded gradients of the six leaves, on JAX's own topologies, for each
    recompute setting: atol 3e-6 of each leaf's scale
    (tests/test_banded.py:256-259) and rtol 1e-5, on scenes of scales
    >= ~0.1.  The rtol is for the quaternion chain of the parameter layer,
    where XLA contracts FMAs on the CPU and torch does not (ROADMAP.md
    section 3): its largest element differs by ~4e-6 of itself;
  * `Trainer(n_bands=2)` parameters after one and two steps, span and
    balanced, against the JAX Trainer's: 1e-6 of each leaf's magnitude.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gvrt_tpu as g3
import gvrt_tpu_torch as gt
from gvrt_tpu.render import banded as jbd
from gvrt_tpu.render import binning as jb
from gvrt_tpu.render import param_grads as jpg
from gvrt_tpu.render import segreduce as jsr
from gvrt_tpu.render.tiled import _camera_mats
from gvrt_tpu_torch.app import main as cli_main
from gvrt_tpu_torch.models.gaussians import LEAVES
from gvrt_tpu_torch.render import banded as tbd
from gvrt_tpu_torch.render import binning as tb
from gvrt_tpu_torch.render import param_grads as tpg
from gvrt_tpu_torch.render import segreduce as tsr

from port_scenes import camera, carry, jax_scene, torch_cfg

CFG = g3.DEFAULT_CONFIG.replace(tile_size=8, chunk_size=32)
TCFG = torch_cfg(CFG)
RES = 32


def _t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def _scene(n=200, seed=3, sorted_=False, wide=False):
    """A JAX scene (wide: scales >= ~0.1, for the gradient comparisons),
    optionally y-sorted for the 32^2 camera by JAX's sorted_for_camera."""
    kw = {"spread": 0.6, "scale_range": (-2.3, -1.6)} if wide else \
        {"spread": 0.8, "scale_range": (-4.0, -2.5)}
    model = jax_scene(n, seed=seed, **kw)
    if sorted_:
        model = model.sorted_for_camera(camera(RES), CFG)
    return model


def _tables(jm):
    cam = camera(RES)
    w2c, proj = _camera_mats(cam)
    jtab = jax.tree.map(np.asarray, jb.frame_cull_table(
        jm.activate(), jnp.asarray(w2c), jnp.asarray(proj), RES, RES, CFG))
    with torch.no_grad():
        ttab = tb.frame_cull_table(carry(jm).activate(), w2c, proj, RES, RES,
                                   TCFG)
    return cam, proj, jtab, ttab


# ---- plans -----------------------------------------------------------------

@pytest.mark.parametrize("mode", ["stride", "contig", "balanced"])
def test_plans_match_jax(mode):
    jm = _scene(300, seed=5, sorted_=mode != "stride")
    cam, proj, jtab, ttab = _tables(jm)
    tm = carry(jm)
    if mode == "balanced":
        want = jbd.plan_capacity_balanced(jm, cam, 3, CFG)
        got = tbd.plan_capacity_balanced(tm, cam, 3, TCFG)
        assert got == want and got[0] == jb.plan_row_split(
            jtab, proj, RES, RES, CFG, 3)
        assert tb.plan_row_split(ttab, proj, RES, RES, TCFG, 3) == got[0]
    else:
        for n_bands in (2, 4):
            got = tbd.plan_capacity_banded(tm, cam, n_bands, TCFG,
                                           with_reduce=True, mode=mode)
            assert got == jbd.plan_capacity_banded(
                jm, cam, n_bands, CFG, with_reduce=True, mode=mode)
            assert got[:2] == tbd.plan_capacity_banded(tm, cam, n_bands,
                                                       TCFG, mode=mode)
    band = (1, 2) if mode == "stride" else (1, 1, 2)
    got = tb.plan_compact_reduce_from_table(ttab, proj, RES, RES, TCFG,
                                            band=band)
    assert got == jb.plan_compact_reduce_from_table(jtab, proj, RES, RES, CFG,
                                                    band=band)
    assert got[0] % tsr.GROUP == 0 and got[2] <= 300


# ---- the compact plan and K4's plain version --------------------------------

@functools.lru_cache(maxsize=None)
def _layout(band):
    """The pre-sort pair structure of one band of a y-sorted scene (JAX
    binning) as NumPy, with the band's compact plan sizes."""
    jm = _scene(700, seed=31, sorted_=True)
    cam, proj, jtab, _ = _tables(jm)
    w2c, _ = _camera_mats(cam)
    act = jm.activate()
    cap, cap_pad = jb.plan_capacity_from_table(jtab, proj, RES, RES, CFG,
                                               band=band)
    cap_live, cap_r, cap_range = jb.plan_compact_reduce_from_table(
        jtab, proj, RES, RES, CFG, band=band)
    topo = jb.bin_topology(act, w2c, proj, RES, RES, CFG, cap, cap_pad,
                           row_offset=band[0], row_stride=band[1],
                           row_count=band[2], capacity_reduce=cap_r,
                           capacity_live=cap_live, capacity_range=cap_range)
    assert int(topo.overflow) == 0
    offsets = np.asarray(topo.gauss_offsets).astype(np.int64)
    counts = np.asarray(topo.gauss_counts).astype(np.int64)
    pair_g = np.zeros(cap, np.int64)
    has = (counts > 0) & (offsets < cap)
    np.maximum.at(pair_g, offsets[has], np.nonzero(has)[0])
    pair_g = np.maximum.accumulate(pair_g)
    return dict(pair_g=pair_g, pair_pos=np.asarray(topo.pair_pos).astype(
        np.int64), offsets=offsets, counts=counts, cap=cap, cap_pad=cap_pad,
        cap_live=cap_live, cap_r=cap_r, cap_range=cap_range, topo=topo)


#: case -> (band, cap_live, cap_r, cap_range) overrides of the planned sizes
PLAN_CASES = {
    "planned": ((0, 1, 0), None, None, 0),
    "window": ((2, 1, 2), None, None, None),
    # cap_live past the band's live groups: the spill-group claim
    "spill": ((2, 1, 2), 4 * tsr.GROUP, None, None),
    "overflow": ((0, 1, 0), tsr.GROUP, 2 * tsr.GROUP, 2 * tsr.GROUP),
}


def _plans(case):
    band, cl, cr, crg = PLAN_CASES[case]
    lay = _layout(band)
    n = lay["offsets"].shape[0]
    cl = lay["cap_live"] if cl is None else cl
    cr = lay["cap_r"] if cr is None else cr
    crg = lay["cap_range"] if crg is None else crg
    args = (n, lay["cap"], lay["cap_pad"], cl, cr, crg)
    jred, jovf = jsr.build_reduce_plan_compact(
        *(jnp.asarray(lay[k], jnp.int32)
          for k in ("pair_g", "pair_pos", "offsets", "counts")), *args)
    tred, tovf = tsr.build_reduce_plan_compact(
        *(torch.from_numpy(lay[k])
          for k in ("pair_g", "pair_pos", "offsets", "counts")), *args)
    return lay, jred, int(jovf), tred, int(tovf)


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_build_reduce_plan_compact_equals_jax(case):
    lay, jred, jovf, tred, tovf = _plans(case)
    for f in tsr.CompactReducePlan._fields:
        x, y = np.asarray(getattr(jred, f)), getattr(tred, f).numpy()
        assert y.dtype == np.int32 and y.shape == x.shape, f
        np.testing.assert_array_equal(y, x, err_msg=f)
    assert tovf == jovf and (tovf > 0) == (case == "overflow")
    if case == "window":
        n = lay["offsets"].shape[0]
        assert 0 < int(tred.base[0]) and tred.src_range.shape[0] < n
    if case == "spill":
        # the band's live ids fill fewer groups than cap_live holds
        n_live = int((tred.src_range < 4 * tsr.GROUP).sum())
        assert n_live <= 2 * tsr.GROUP


@pytest.mark.parametrize("case", ["planned", "window", "spill"])
def test_segment_reduce_compact_plain_matches_interpreted_pallas(case):
    lay, jred, _, tred, _ = _plans(case)
    n_groups = tred.out_shape.shape[0]
    cap_pad = lay["cap_pad"]
    bar_flat = np.random.default_rng(0).normal(size=(cap_pad, 64))
    bar_flat = bar_flat.astype(np.float32)
    bar_pre = jnp.asarray(bar_flat)[jnp.minimum(jred.slot, cap_pad - 1)]
    want = np.asarray(jsr.segment_reduce_compact(bar_pre, jred, n_groups,
                                                 interpret=True))
    before = tsr.segment_reduce_compact.launches
    got = tsr.segment_reduce_compact(torch.from_numpy(bar_flat), tred,
                                     n_groups)
    assert tsr.segment_reduce_compact.launches == before  # CPU: plain
    assert got.shape == want.shape
    # compact ids are 0..n_live-1, every one of them in the window
    n_live = int((tred.src_range < n_groups * tsr.GROUP).sum())
    live = got[:n_live].numpy()
    assert np.linalg.norm(live - want[:n_live]) <= 1e-6 * np.linalg.norm(
        want[:n_live])
    # ids past the last live one are exactly zero (the JAX rows there are
    # undefined past the spill group)
    assert not got[n_live:].any() and np.abs(live).sum(1).min() > 0


def test_chunked_gather_compact_route_matches_full_prefix_and_jax():
    lay = _layout((0, 1, 0))
    topo = lay["topo"]
    n = lay["offsets"].shape[0]
    g = CFG.chunk_size
    rng = np.random.default_rng(1)
    rows = rng.normal(size=(n + 1, 64)).astype(np.float32)
    bar = rng.normal(size=(lay["cap_pad"] // g, g, 64)).astype(np.float32)
    full, _ = tsr.build_reduce_plan(
        *(torch.from_numpy(lay[k])
          for k in ("pair_g", "pair_pos", "offsets", "counts")),
        n, lay["cap"], lay["cap_pad"])
    grads = {}
    for route, red in (("compact", tsr.CompactReducePlan(
            *(_t(x) for x in topo.red))), ("full", full), ("prefix", None)):
        trows = torch.from_numpy(rows).requires_grad_()
        out = tpg.chunked_gather(g, trows, _t(topo.pair_gauss),
                                 _t(topo.pair_pos), _t(topo.gauss_offsets),
                                 _t(topo.gauss_counts), red, "torch")
        out.backward(torch.from_numpy(bar))
        grads[route] = trows.grad.numpy()
    scale = np.abs(grads["full"]).max()
    np.testing.assert_allclose(grads["compact"] / scale,
                               grads["full"] / scale, atol=2e-6)
    np.testing.assert_allclose(grads["prefix"] / scale,
                               grads["full"] / scale, atol=2e-4)
    res = (n + 1, topo.pair_gauss, topo.pair_pos, topo.gauss_offsets,
           topo.gauss_counts, topo.red)
    want = np.asarray(jpg._gather_bwd(g, res, jnp.asarray(bar))[0])
    np.testing.assert_allclose(grads["compact"], want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


# ---- rays, images, the y-sort -------------------------------------------------

def test_band_rays_unband_and_sort_match_jax():
    cam = camera(RES, height=48)
    for mode in ("stride", "contig"):
        want = np.asarray(jb.band_rays(cam, CFG, 3, mode=mode))
        got = tb.band_rays(cam, TCFG, 3, "cpu", mode=mode)
        assert got.shape == want.shape and got[1].is_contiguous()
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
        img = np.random.default_rng(2).normal(size=(3, 16, RES, 8))
        img = img.astype(np.float32)
        np.testing.assert_array_equal(
            tb.unband_image(torch.from_numpy(img), RES, 48, 8, mode).numpy(),
            np.asarray(jb.unband_image(jnp.asarray(img), RES, 48, 8, mode)))
    specs = ((0, 1), (1, 4), (5, 1))
    for a, b in zip(tb.band_rays_split(cam, TCFG, specs, "cpu"),
                    jb.band_rays_split(cam, CFG, specs)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    jm = _scene(300, seed=5)
    want = jm.sorted_for_camera(camera(RES), CFG)
    got = carry(jm).sorted_for_camera(camera(RES), TCFG)
    for k in LEAVES:
        np.testing.assert_array_equal(getattr(got, k).detach().numpy(),
                                      np.asarray(getattr(want, k)), err_msg=k)


def _np(out):
    return {k: v.detach().numpy() for k, v in out.items()}


def _assert_same_image(got, want, atol=1e-5):
    for k in ("rgb", "transmittance"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=atol,
                                   err_msg=k)
    np.testing.assert_array_equal(got["hit_count"],
                                  np.asarray(want["hit_count"]))


@pytest.mark.parametrize("n_bands,span", [(2, False), (2, True)],
                         ids=["stride2", "span2"])
def test_banded_image_matches_unbanded_and_jax(n_bands, span):
    jm = _scene(200, seed=3, sorted_=span, wide=True)
    tm = carry(jm)
    cam = camera(RES)
    with torch.no_grad():
        got = _np(tbd.render_image_banded(tm, cam, n_bands, TCFG, span=span,
                                          device="cpu"))
        full = _np(gt.render.TiledRenderer(RES, RES, TCFG, device="cpu")
                   .render(tm, cam))
    assert int(got["overflow"]) == 0 and got["hit_count"].mean() > 1.0
    _assert_same_image(got, full)
    _assert_same_image(got, jbd.render_image_banded(jm, cam, n_bands, CFG,
                                                    impl="scan", span=span))


def test_band_binning_is_full_binning_restricted():
    """Bands quantize depth at the frame's levels, so every band tile's pair
    list, ties included, is the unbanded frame's, and the banded image is
    the unbanded one bit for bit.  Most depths here sit within a few
    levels; per-band levels (the band's tile count and valid set, as the
    JAX package cuts them) order their ties differently."""
    cam = camera(128)
    tm = carry(jax_scene(1500, seed=50, spread=0.8, scale_range=(-3.5, -2.5)))
    rng = np.random.default_rng(0)
    with torch.no_grad():
        # depths within ~7 frame levels, two small opaque outliers at depth
        # 1.5 and 60 in the centre setting the frame's range
        tm.means[2:, 2] = torch.from_numpy(
            -3.0 + 1e-4 * rng.random(1498).astype(np.float32))
        tm.means[:2] = torch.tensor([[0.0, 0.0, -1.5], [0.0, 0.0, -60.0]])
        tm.opacity_logit[:2] = 3.0
        full = _np(gt.render.TiledRenderer(128, 128, TCFG, device="cpu")
                   .render(tm, cam))
        for n_bands, span in ((4, False), (2, True)):
            got = _np(tbd.render_image_banded(tm, cam, n_bands, TCFG,
                                              span=span, device="cpu"))
            for k in ("rgb", "transmittance", "depth", "hit_count"):
                np.testing.assert_array_equal(got[k], full[k], err_msg=k)
    assert full["hit_count"].mean() > 1.0


# ---- gradients on JAX's topologies ------------------------------------------

def _loss_j(img):
    return (jnp.mean((img[..., 0:3] - 0.3) ** 2)
            + 1e-2 * jnp.mean(img[..., 3]))


def _loss_t(out):
    return ((out["rgb"] - 0.3) ** 2).mean() + 1e-2 * out["depth"].mean()


def _carry_topos(topos, balance):
    """JAX per-band topologies (stacked, or a tuple) -> the port's list."""
    if not balance:
        topos = [jax.tree.map(lambda x, b=b: x[b], topos)
                 for b in range(topos.chunk_tile.shape[0])]
    return [tb.BinTopology(*(_t(x) for x in t[:-1]),
                           red=tsr.CompactReducePlan(*(_t(x) for x in t.red)))
            for t in topos]


@functools.lru_cache(maxsize=None)
def _jax_bound(span, balance):
    jm = _scene(200, seed=9, sorted_=span, wide=True)
    r = jbd.BandedRenderer(RES, RES, 2, CFG, impl="scan", span=span,
                           balance=balance)
    topos = r.bind(jm, camera(RES))
    rays = r._bound[1]
    grads = jax.grad(lambda m: _loss_j(jbd._render_banded_bound(
        m, topos, rays, RES, RES, CFG, "scan", remat="full",
        mode=r.mode)[0]))(jm)
    return jm, topos, grads


@pytest.mark.parametrize("remat,span,balance",
                         [("full", False, False), ("gather", True, False),
                          ("none", True, True)],
                         ids=["full_stride", "gather_span", "none_balanced"])
def test_banded_grads_match_jax(remat, span, balance):
    jm, topos, want = _jax_bound(span, balance)
    tm = carry(jm)
    r = tbd.BandedRenderer(RES, RES, 2, TCFG, remat=remat, span=span,
                           balance=balance, device="cpu")
    r.bind(tm, camera(RES))  # the rays; the topologies are JAX's
    r._bound = (_carry_topos(topos, balance), r._bound[1])
    out = r.render_bound(tm)
    assert int(out["overflow"]) == 0
    _loss_t(out).backward()
    for k in LEAVES:
        w = np.asarray(getattr(want, k))
        scale = max(np.abs(w).max(), 1e-10)
        assert scale > 1e-8, k
        np.testing.assert_allclose(getattr(tm, k).grad.numpy() / scale,
                                   w / scale, rtol=1e-5, atol=3e-6,
                                   err_msg=k)


def test_banded_renderer_bound_and_balanced():
    cam = camera(RES)
    jm = _scene(150, seed=43, sorted_=True)
    tm = carry(jm)
    with torch.no_grad():
        full = _np(gt.render.TiledRenderer(RES, RES, TCFG, device="cpu")
                   .render(tm, cam))
        for span, balance, n_bands in ((False, False, 2), (True, False, 2),
                                       (True, True, 3)):
            r = tbd.BandedRenderer(RES, RES, n_bands, TCFG, span=span,
                                   balance=balance, device="cpu")
            with pytest.raises(RuntimeError, match="bind"):
                r.render_bound(tm)
            topos = r.bind(tm, cam)
            assert all(isinstance(t.red, tsr.CompactReducePlan)
                       for t in topos)
            out = _np(r.render_bound(tm))
            assert int(out["overflow"]) == 0
            _assert_same_image(out, full)
            if balance:
                jr = jbd.BandedRenderer(RES, RES, n_bands, CFG, impl="scan",
                                        span=True, balance=True)
                jr.plan(jm, cam)
                assert (r.band_specs, r.band_caps) == (jr.band_specs,
                                                       jr.band_caps)
    with pytest.raises(ValueError, match="span"):
        tbd.BandedRenderer(RES, RES, 2, TCFG, balance=True, device="cpu")


# ---- the trainer ------------------------------------------------------------

def _trainer_steps_match_jax(balance, refresh_every, steps, forced=()):
    """`steps` banded Trainer steps of the port and of JAX side by side:
    the loss and the six leaves after every step, and the bind age (the
    held topologies' refresh points).  Before each step in `forced`, both
    trainers are told that their held window dropped pairs, so their next
    rebind re-plans and max-merges; the capacities must then agree."""
    from gvrt_tpu.train import TrainConfig as JaxTrainConfig
    from gvrt_tpu.train import Trainer as JaxTrainer
    cam = camera(RES)
    tm = carry(_scene(120, seed=44, sorted_=True, wide=True))
    # a copy: the JAX step donates its state's buffers
    jm = jax.tree.map(jnp.array, _scene(120, seed=44, sorted_=True,
                                        wide=True))
    target = np.full((RES, RES, 3), 0.3, np.float32)
    kw = dict(total_steps=4, refresh_every=refresh_every, span_bands=True,
              balance_bands=balance)
    jt = JaxTrainer(RES, RES, CFG, JaxTrainConfig(**kw), impl="scan",
                    n_bands=2)
    jstate = jt.init(jm)
    tt = gt.train.Trainer(RES, RES, TCFG, gt.train.TrainConfig(**kw),
                          n_bands=2, device="cpu")
    tstate = tt.init(tm)
    r, jr = tt.renderer, jt._banded
    for i in range(steps):
        if i in forced:
            jt.last_overflow, tt.last_overflow = jnp.int32(1), torch.tensor(1)
            # held one pair short of the plan: only a re-plan restores it
            shrunk = (r.capacity[0] - 1, r.capacity[1])
            r.capacity = jr.capacity = shrunk
        jstate, jloss = jt.step(jstate, cam, jnp.asarray(target))
        tstate, tloss = tt.step(tstate, cam, torch.from_numpy(target))
        assert tt._bind_age == jt._bind_age == i % refresh_every + 1
        if i in forced:
            assert r.capacity[0] > shrunk[0]
        assert (r.capacity, r.capacity_live, r.capacity_reduce,
                r.capacity_range, r.band_specs, r.band_caps) == (
            jr.capacity, jr.capacity_live, jr.capacity_reduce,
            jr.capacity_range, jr.band_specs, jr.band_caps)
        # the JAX step activates inside its jit: ~1e-6-class fusion drift
        # per pixel (tests/test_banded.py:37-40)
        assert float(tloss) == pytest.approx(float(jloss), rel=2e-5)
        for k in LEAVES:
            want = np.asarray(getattr(jstate[0], k))
            np.testing.assert_allclose(
                getattr(tstate[0], k).detach().numpy(), want, rtol=0,
                atol=1e-6 * np.abs(want).max(), err_msg=k)
    assert int(tt.last_overflow) == 0


@pytest.mark.parametrize("balance", [False, True], ids=["span", "balanced"])
def test_trainer_banded_steps_match_jax(balance):
    _trainer_steps_match_jax(balance, refresh_every=1, steps=2)


@pytest.mark.parametrize("balance", [False, True], ids=["span", "balanced"])
def test_trainer_banded_held_topologies_match_jax(balance):
    # refresh_every=2: step 2 renders the topologies bound before step 1
    # while Adam has moved the parameters, step 3 rebinds, and re-plans
    # first because its held window reports dropped pairs
    _trainer_steps_match_jax(balance, refresh_every=2, steps=3, forced=(2,))


def test_cli_banded_render_benchmark_and_train(tmp_path, capsys,
                                               monkeypatch):
    ply = str(tmp_path / "scene.ply")
    carry(jax_scene(150, seed=45, spread=0.5)).to_ply(ply)
    out = str(tmp_path / "renders")
    cli_main(["render", "--device", "cpu", "--ply", ply, "--width", "32",
              "--height", "32", "--frames", "3", "--bands", "2", "--out",
              out])
    img = gt.io.load_png(str(tmp_path / "renders" / "orbit_0000.png"))
    assert img.shape == (32, 32, 3) and img.max() > 0
    monkeypatch.chdir(tmp_path)
    cli_main(["benchmark", "--device", "cpu", "--ply", ply, "--width", "32",
              "--height", "32", "--bands", "2", "-bw", "0.05", "-br", "0.2"])
    assert "rays/s" in capsys.readouterr().out
    assert "frame,ms" in open("fps.txt").read()
    tuned = str(tmp_path / "tuned.ply")
    cli_main(["train", "--device", "cpu", "--ply", ply, "--width", "32",
              "--height", "32", "--frames", "3", "--steps", "2", "--bands",
              "2", "--span-bands", "--sort-scene", "--images-dir", out,
              "--out", tuned])
    psnrs = [float(line.split("psnr")[1])
             for line in capsys.readouterr().out.splitlines()
             if "psnr" in line]
    assert psnrs and all(np.isfinite(psnrs))
    assert gt.GaussianModel.from_ply(tuned, device="cpu").num_gaussians == 150
