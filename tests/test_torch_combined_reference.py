"""The port's combined Gaussian-and-mesh frame (`render.combined`) against
the benchmark's plain mesh reference (`portbench/reference/mesh.py` over
its Gaussian reference), on the CPU; `CombinedRenderer` against
`render_combined`, the frame's one ray build against the rays it
replaced, and the CLI's `--mesh`.

The scene: 3000 Gaussians drawn by `portbench/scene.py` (extent 1 about
(0, 0, -3), log-scales U(-3.6, -2.8): ~24 hits a ray), a floor quad across
the cloud's x-z footprint a quarter of its height up, a subdivision-1
icosphere (80 triangles) resting on it, one light off-axis above the
cloud, shadow rays on; 64 x 64 views on the orbit of radius 3, tile 8,
chunk 64.  Tolerances, each from the rounding of one side against the
other in float32 (the program's hit test in emulated fused multiply-adds,
the reference's in plain float32; the rest the same equations in another
order of operations):

  * mesh hit or miss: equal on every pixel (no ray of these views grazes
    an edge);
  * mesh t: rtol 1e-6 (read up to 3.3e-7 over three seeds); mesh rgb:
    atol 1e-5, the serving cells' rgb test (read up to 4.5e-6: the GGX
    terms in another order of operations);
  * the combined rgb, T: atol 1e-5, depth 1e-4, hit counts equal: the
    serving cells' `rays_off` test, here on every pixel (read up to 2.3e-6,
    0, 4.8e-7, equal).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import gvrt_tpu_torch as gt  # noqa: E402
from gvrt_tpu_torch.app import main as cli_main  # noqa: E402
from gvrt_tpu_torch.render import binning  # noqa: E402
from portbench.reference import binning as ref_bin  # noqa: E402
from portbench.reference import camera as ref_cam  # noqa: E402
from portbench.reference import mesh as ref_mesh  # noqa: E402
from portbench.reference.math import Settings, activate, param_rows  # noqa: E402
from portbench.scene import draw  # noqa: E402

RES = 64
CFG = gt.DEFAULT_CONFIG.replace(tile_size=8, chunk_size=64)
ST = Settings(tile_size=8, chunk_size=64)
CONFIG = {"gaussians": 3000, "extent": 1.0, "centre": [0.0, 0.0, -3.0],
          "scale_log_range": [-3.6, -2.8], "opacity_logit_range": [-3.5, 0.5]}
MESH = {"floor": [[-1.0, -0.5, -4.0], [-1.0, -0.5, -2.0], [1.0, -0.5, -2.0],
                  [1.0, -0.5, -4.0]],
        "floor_material": {"base_color": [0.7, 0.7, 0.7, 1.0],
                           "metallic": 0.0, "roughness": 0.8, "ior": 1.45},
        "sphere_center": [0.0, -0.125, -3.0], "sphere_radius": 0.375,
        "sphere_subdiv": 1,
        "sphere_material": {"base_color": [0.8, 0.3, 0.2, 1.0],
                            "metallic": 0.2, "roughness": 0.4, "ior": 1.45},
        "light_position": [0.5, 2.0, -2.5], "light_color": [1.0, 1.0, 1.0],
        "light_radius": 20.0, "shadow_rays": True, "scene": "quad_icosphere"}
ANGLES = (0.0, 37.0)
SEED = 20260501


@pytest.fixture(autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(2, n))
    yield
    torch.set_num_threads(n)


def _scene():
    """The CLI's quad_icosphere in the cloud's box, as the combined cell
    builds its mesh, at subdivision 1."""
    c, e = np.asarray(CONFIG["centre"]), CONFIG["extent"]
    return gt.hybrid.mesh.quad_icosphere(c - e, c + e, up=1, subdiv=1)


def _view(angle):
    return ref_cam.orbit_view(CONFIG["centre"], 3.0, angle, 50.0, RES, RES)


def _camera(view):
    return gt.Camera.from_fovy(view.width, view.height, view.fovy_deg,
                               view.c2w)


@pytest.fixture(scope="module")
def frames():
    """{angle: (program's frame, reference's frame)} and the renderer."""
    leaves, _ = draw(CONFIG, SEED, "cpu")
    model = gt.GaussianModel(*(x.clone() for x in leaves))
    r = gt.render.combined.CombinedRenderer(
        RES, RES, _scene(), CFG, gt.hybrid.HybridConfig(), device="cpu")
    r.plan(model, [_camera(_view(a)) for a in ANGLES])
    act = activate(*leaves)
    rows = param_rows(act)
    mesh = ref_mesh.Mesh(MESH, "cpu")
    out = {}
    for a in ANGLES:
        view = _view(a)
        with torch.no_grad():
            got = r.render(model, _camera(view))
        binned = ref_bin.bin_frame(act, *ref_cam.matrices(view, ST), RES,
                                   RES, ST)
        out[a] = (got, ref_mesh.render(rows, binned, view, ST, mesh, "cpu"))
    return out, r, model


@pytest.mark.parametrize("angle", ANGLES)
def test_mesh_pass_matches_the_reference(frames, angle):
    got, want = frames[0][angle]
    hit = torch.isfinite(want["mesh_t"])
    assert torch.equal(torch.isfinite(got["mesh_t"]), hit)
    # the mesh is in view, and its shadow: some hit pixels are lit by the
    # ambient term alone
    assert 0.1 < float(hit.float().mean()) < 0.9
    ambient = (want["mesh_rgb"] - ref_mesh.AMBIENT * torch.tensor(
        [0.7, 0.7, 0.7])).abs().amax(-1) < 1e-6
    assert bool((ambient & hit).any())
    torch.testing.assert_close(got["mesh_t"][hit], want["mesh_t"][hit],
                               rtol=1e-6, atol=0)
    torch.testing.assert_close(got["mesh_rgb"], want["mesh_rgb"], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("angle", ANGLES)
def test_combined_frame_matches_the_reference(frames, angle):
    got, want = frames[0][angle]
    for key, atol in (("rgb", 1e-5), ("transmittance", 1e-5),
                      ("depth", 1e-4)):
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=atol,
                                   msg=key)
    assert torch.equal(got["hit_count"], want["hit_count"])
    assert int(got["overflow"]) == 0
    # the mesh ends the march: fewer hits on its pixels than off them
    on = torch.isfinite(want["mesh_t"])
    assert float(want["hit_count"][on].mean()) < float(
        want["hit_count"][~on].mean())


def test_renderer_equals_render_combined(frames):
    _, r, model = frames
    cam = _camera(_view(ANGLES[1]))
    with torch.no_grad():
        a = r.render(model, cam)
        b = gt.render.render_combined(model, _scene(), cam, CFG,
                                      gt.hybrid.HybridConfig(),
                                      capacity=r.gaussians.capacity)
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])), k


def test_one_ray_build_gives_the_rays_it_replaced(frames):
    """The mesh pass's rows of the frame's tile rays are `Camera.rays()` in
    float32, and the clipped rows are `tile_rays(..., tmax_clip=)`'s."""
    got, _ = frames[0][ANGLES[0]]
    cam = _camera(_view(ANGLES[0]))
    rays = binning.tile_rays(cam, CFG, "cpu")
    o, d = cam.rays()
    flat = binning.untile(rays[:, 0:6], RES, RES, CFG.tile_size)
    assert torch.equal(flat, torch.from_numpy(np.concatenate([o, d], -1)))
    clipped = binning.tile_rays(cam, CFG, "cpu", tmax_clip=got["mesh_t"])
    seen = []
    real = gt.render.tiled.forward_dispatch

    def spy(binned, rays, cfg, impl):
        seen.append(rays.clone())
        return real(binned, rays, cfg, impl)
    gt.render.tiled.forward_dispatch = spy
    try:
        _, r, model = frames
        with torch.no_grad():
            r.render(model, cam)
    finally:
        gt.render.tiled.forward_dispatch = real
    assert len(seen) == 1 and torch.equal(seen[0], clipped)
    assert bool((clipped[:, 7] < rays[:, 7]).any())


@pytest.mark.parametrize("config", ("garden5m_mesh", "small"))
def test_the_mesh_is_the_configurations(config):
    """The numbers under a configuration's `mesh`, from which the reference
    builds its mesh, are the program's: the CLI's quad_icosphere in the
    cloud's box (the cell's configuration file, and this file's)."""
    if config == "small":
        conf = {**CONFIG, "mesh": MESH}
    else:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        with open(os.path.join(root, "portbench", "configs",
                               config + ".json")) as f:
            conf = json.load(f)
    m = conf["mesh"]
    c, e = np.asarray(conf["centre"]), conf["extent"]
    scene = gt.hybrid.mesh.PROCEDURAL[m["scene"]](
        c - e, c + e, up=1, subdiv=m["sphere_subdiv"])
    ref = ref_mesh.Mesh(m, "cpu")
    tris = sorted(map(tuple, scene.tri_pos.reshape(-1, 9).tolist()))
    assert tris == sorted(map(tuple, ref.tris.reshape(-1, 9).tolist()))
    light = scene.lights[0]
    assert len(scene.lights) == 1 and list(light.position) == m[
        "light_position"] and list(light.color) == m["light_color"]
    assert light.radius == m["light_radius"]
    for mat, key in zip(scene.materials, ("floor_material",
                                          "sphere_material")):
        want = m[key]
        assert list(mat.base_color) == want["base_color"], key
        assert (mat.metallic, mat.roughness, mat.ior) == (
            want["metallic"], want["roughness"], want["ior"]), key
        assert mat.emissive == (0.0, 0.0, 0.0) and mat.reflectance == 0.0 \
            and mat.refractance == 0.0 and mat.tex_base_color < 0, key


@pytest.fixture(scope="module")
def ply(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh_cli") / "scene.ply"
    g = torch.Generator().manual_seed(3)
    gt.random_gaussians(g, 500, extent=0.8, device="cpu").to_ply(str(path))
    return str(path)


def test_cli_render_with_a_mesh(ply, tmp_path, capsys):
    from gvrt_tpu_torch.io.image import load_png
    out = tmp_path / "frames"
    cli_main(["render", "--device", "cpu", "--ply", ply, "-w", "32",
                 "--height", "32", "--frames", "2", "--mesh",
                 "quad_icosphere", "--out", str(out)])
    pngs = sorted(os.listdir(out))
    assert pngs == ["orbit_0000.png", "orbit_0001.png"]
    assert capsys.readouterr().out.split() == [str(out / p) for p in pngs]
    plain = tmp_path / "plain"
    cli_main(["render", "--device", "cpu", "--ply", ply, "-w", "32",
                 "--height", "32", "--frames", "1", "--out", str(plain)])
    # the mesh shows: the frame differs from the Gaussians alone
    assert not np.array_equal(load_png(str(out / pngs[0])),
                              load_png(str(plain / pngs[0])))


@pytest.mark.parametrize("extra", (["--bands", "2"], ["--mesh", "nothing"]))
def test_cli_mesh_refuses(ply, tmp_path, extra):
    args = ["render", "--device", "cpu", "--ply", ply, "-w", "32",
            "--height", "32", "--frames", "1", "--out", str(tmp_path)]
    if extra[0] == "--bands":
        extra = extra + ["--mesh", "quad_icosphere"]
    with pytest.raises(SystemExit, match="--mesh"):
        cli_main(args + extra)
