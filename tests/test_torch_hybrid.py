"""PyTorch port, the hybrid mesh renderer (hybrid/) against the JAX package
on the CPU.

* `closest_hit` and `occluded` on a seeded triangle soup (rays that miss
  everything, axis-parallel rays, a ray count that is no multiple of the
  cull block) at tri_chunk 256 and 512: t and u, v within 1e-5, triangle
  ids and occlusion equal (the port rounds the intersection's products as
  XLA's fused multiply-adds round them, so edge rays resolve alike);
* the shading functions elementwise, within 1e-5 relative (1e-6 absolute);
* `HybridRenderer.render` in four configurations at 48^2 (mirror, glass
  with animation time, no shadows or bounces on a textured normal-mapped
  quad before an equirect map, the cornell box under its default light):
  rgb within 1e-5 on >= 99.9% of pixels, depth (1e-5) and object ids on
  >= 99.9%;
* the minimal glTF of tests/test_hybrid.py, instancing, and the CLI's
  `hybrid --device cpu` at 32^2 against the JAX CLI's PNG.
"""

import base64
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gvrt_tpu as g3
import gvrt_tpu_torch as gt
from gvrt_tpu.app import main as jax_cli
from gvrt_tpu.hybrid import HybridConfig as JaxHybridConfig
from gvrt_tpu.hybrid import HybridRenderer as JaxHybridRenderer
from gvrt_tpu.hybrid import shade as jshade
from gvrt_tpu.hybrid import trace as jtrace
from gvrt_tpu_torch.app import main as cli_main
from gvrt_tpu_torch.hybrid import (HybridConfig, HybridRenderer, Material,
                                   MeshScene, cornell_scene, load_gltf)
from gvrt_tpu_torch.hybrid import mesh as tmesh
from gvrt_tpu_torch.hybrid import shade as tshade
from gvrt_tpu_torch.hybrid import trace as ttrace

from port_scenes import one_torch_thread  # noqa: F401


def _soup(seed=5, n=700):
    """Clustered random triangles, and 301 rays: random ones, rays that
    miss everything (pointing away from the soup's box), and rays along
    the axes."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-4, 4, size=(n, 3))
    tri = (centers[:, None, :]
           + 0.4 * rng.standard_normal((n, 3, 3))).astype(np.float32)
    o = rng.uniform(-6, 6, size=(301, 3))
    d = rng.standard_normal((301, 3))
    o[:40] = [0.0, 0.0, 20.0]
    d[:40] = rng.uniform(0.1, 1.0, (40, 3))          # away from the soup
    axes = np.eye(3)[rng.integers(0, 3, 60)] * rng.choice([-1, 1], (60, 1))
    d[40:100] = axes
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = np.concatenate([o, d], 1).astype(np.float32)
    tmin = rng.uniform(0.0, 0.5, 301).astype(np.float32)
    tmax = rng.uniform(2.0, 12.0, 301).astype(np.float32)
    return tri, rays, tmin, tmax


@pytest.mark.parametrize("chunk", [256, 512])
def test_trace_matches_jax(chunk):
    tri, rays, tmin, tmax = _soup()
    jp = jtrace.pack_triangles(tri, chunk)
    tp = ttrace.pack_triangles(tri, chunk, device="cpu")
    np.testing.assert_array_equal(tp.tri_id.numpy(), np.asarray(jp.tri_id))
    np.testing.assert_array_equal(tp.lo.numpy(), np.asarray(jp.lo))
    want = jtrace.closest_hit(jnp.asarray(rays), jp, tmin=jnp.asarray(tmin),
                              block=64)
    got = ttrace.closest_hit(torch.from_numpy(rays), tp,
                             tmin=torch.from_numpy(tmin), block=64, batch=128)
    np.testing.assert_array_equal(got["tri"].numpy(),
                                  np.asarray(want["tri"]))
    for k in ("t", "u", "v"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    hit = got["tri"].numpy() >= 0
    assert 0 < hit.sum() < len(hit) and not hit[:40].any()
    assert hit[40:100].any()
    occ_w = jtrace.occluded(jnp.asarray(rays), jp, jnp.asarray(tmin),
                            jnp.asarray(tmax), block=64)
    occ_g = ttrace.occluded(torch.from_numpy(rays), tp,
                            torch.from_numpy(tmin), torch.from_numpy(tmax),
                            block=64, batch=128)
    np.testing.assert_array_equal(occ_g.numpy(), np.asarray(occ_w))
    assert 0 < occ_g.sum() < len(occ_g)


def test_trace_cull_is_conservative():
    """Morton-ordered, culled, block-split traversal equals the unordered
    scan in one block (tests/test_hybrid.py:85-118 on the port)."""
    tri, rays, tmin, tmax = _soup(seed=6, n=200)
    r, tn, tx = (torch.from_numpy(x) for x in (rays, tmin, tmax))
    brute = ttrace.pack_triangles(tri, 8, reorder=False, device="cpu")
    culled = ttrace.pack_triangles(tri, 8, reorder=True, device="cpu")
    a = ttrace.closest_hit(r, brute, tmin=tn, block=len(rays))
    b = ttrace.closest_hit(r, culled, tmin=tn, block=16, batch=48)
    assert torch.equal(a["tri"], b["tri"])
    torch.testing.assert_close(a["t"], b["t"], rtol=1e-6, atol=0.0)
    assert torch.equal(ttrace.occluded(r, brute, tn, tx, block=len(rays)),
                       ttrace.occluded(r, culled, tn, tx, block=16, batch=48))


def _shade_inputs(rng, n=257):
    def unit(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)
    f = np.float32
    return {
        "pos": rng.uniform(-2, 2, (n, 3)).astype(f),
        "normal": unit(rng.standard_normal((n, 3))).astype(f),
        "view": unit(rng.standard_normal((n, 3))).astype(f),
        "albedo": rng.uniform(0, 1, (n, 3)).astype(f),
        "metallic": rng.uniform(0, 1, n).astype(f),
        "roughness": rng.uniform(0.05, 1, n).astype(f),
        "ior": rng.uniform(1.0, 2.0, n).astype(f),
        "eta": rng.uniform(0.5, 1.6, n).astype(f),
        "cos": rng.uniform(-0.2, 1.2, n).astype(f),
        "lit": rng.uniform(0, 1, n) > 0.3,
        "dirs": rng.standard_normal((n, 3)).astype(f),
        "uv": rng.uniform(-3, 3, (n, 2)).astype(f),
        "env": rng.uniform(0, 1, (9, 17, 3)).astype(f),
        "cube": rng.uniform(0, 1, (6, 7, 7, 3)).astype(f),
        "tex": rng.uniform(0, 1, (5, 11, 4)).astype(f),
    }


SHADE_FNS = {
    "fresnel_schlick": lambda m, x: m.fresnel_schlick(
        x["cos"][:, None], x["albedo"]),
    "distribution_ggx": lambda m, x: m.distribution_ggx(x["cos"],
                                                        x["roughness"]),
    "geometry_smith": lambda m, x: m.geometry_smith(
        x["cos"].clip(0, 1), x["metallic"], x["roughness"]),
    "apply_attenuation": lambda m, x: m.apply_attenuation(
        x["albedo"][0], x["ior"] * 4.0, x["roughness"][0] * 8.0,
        m.LightAttenuation()),
    "direct_lighting": lambda m, x: m.direct_lighting(
        x["pos"], x["normal"], x["view"], x["albedo"], x["metallic"],
        x["roughness"], m.base_f0(x["ior"], x["albedo"], x["metallic"]),
        x["albedo"][1] * 3.0, x["albedo"][2], x["ior"][0] * 3.0, x["lit"],
        m.LightAttenuation()),
    "reflect": lambda m, x: m.reflect(x["view"], x["normal"]),
    "refract": lambda m, x: m.refract(x["view"], x["normal"], x["eta"]),
    "sample_env_equirect": lambda m, x: m.sample_env_equirect(x["env"],
                                                              x["dirs"]),
    "sample_env_cube": lambda m, x: m.sample_env_cube(x["cube"], x["dirs"]),
    "procedural_sky": lambda m, x: m.procedural_sky(x["dirs"]),
    "sample_texture_bilinear": lambda m, x: m.sample_texture_bilinear(
        x["tex"], x["uv"]),
}


@pytest.mark.parametrize("name", sorted(SHADE_FNS))
def test_shade_matches_jax(name):
    x = _shade_inputs(np.random.default_rng(len(name)))
    want = SHADE_FNS[name](jshade, {k: jnp.asarray(v) for k, v in x.items()})
    got = SHADE_FNS[name](tshade, {k: torch.from_numpy(np.asarray(v))
                                   for k, v in x.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def _cornell_cam(res=48):
    c2w = np.eye(4)
    c2w[:3, 3] = [0.0, 1.0, 3.2]
    return g3.Camera.from_fovy(res, res, 60.0, c2w)


def _textured_scene():
    """A normal-mapped, textured quad before an equirect env map: the
    texture slots and the tangent frame of `_surface_attributes`."""
    rng = np.random.default_rng(8)
    s = MeshScene()
    s.textures.append(rng.uniform(0, 1, (16, 16, 4)).astype(np.float32))
    s.textures.append(rng.uniform(0, 1, (8, 8, 4)).astype(np.float32))
    pos, idx = tmesh._quad([-1, 0, -1], [1, 0, -1], [1, 2, -1], [-1, 2, -1])
    uv = np.asarray([[0, 0], [2.5, 0], [2.5, 2.5], [0, 2.5]], np.float32)
    tan = np.tile(np.asarray([[1, 0, 0, 1]], np.float32), (4, 1))
    s.add_object("panel", pos, idx, Material(
        base_color=(0.8, 0.8, 0.8, 1), metallic=0.3, roughness=0.6,
        tex_base_color=0, tex_metallic_roughness=1, tex_emissive=-1,
        tex_normal=1), uvs=uv, tangents=tan)
    v, f, n = tmesh._icosphere(0.3, (0.3, 0.8, -0.4), subdiv=1)
    s.add_object("ball", v, f, Material(base_color=(0.2, 0.5, 0.9, 1),
                                        metallic=0.0, roughness=0.4,
                                        emissive=(0.1, 0.0, 0.0),
                                        tex_emissive=0), normals=n)
    s.lights.append(tmesh.Light(position=(0.5, 1.5, 1.5), radius=10.0))
    s.env_map = rng.uniform(0, 1, (12, 24, 3)).astype(np.float32)
    return s


def _animated_glass():
    s = cornell_scene(with_mirror=True, with_glass=True)
    s.objects[-1].dynamic = True
    s.objects[-1].update = tmesh.rotate_y(90.0)
    s.objects[-2].dynamic = True
    s.objects[-2].update = tmesh.oscillate(1, 0.2, 1.0)
    return s


#: (scene, config switches, animation time)
FRAMES = {
    "mirror": (lambda: cornell_scene(with_mirror=True), {}, 0.0),
    "glass_animated": (_animated_glass, {}, 0.3),
    "textured_flat": (_textured_scene, dict(shadow_rays=False,
                                            reflection=False,
                                            refraction=False), 0.0),
    "plain_shadows": (lambda: cornell_scene(with_mirror=False),
                      dict(reflection=False, iterations=3), 0.0),
}


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_hybrid_frame_matches_jax(name):
    scene_fn, kw, time = FRAMES[name]
    cam = _cornell_cam()
    scene = scene_fn()
    want = JaxHybridRenderer(48, 48, JaxHybridConfig(tri_chunk=256, **kw)) \
        .render(scene, cam, time=time)
    got = HybridRenderer(48, 48, HybridConfig(tri_chunk=256, **kw),
                         device="cpu").render(scene, cam, time=time)
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in got.items()}
    d = np.abs(got["rgb"] - want["rgb"]).max(-1)
    assert (d <= 1e-5).mean() >= 0.999, (d.max(), (d > 1e-5).sum())
    assert (np.abs(got["depth"] - want["depth"]) <= 1e-5).mean() >= 0.999
    assert (got["object"] == want["object"]).mean() >= 0.999
    for k in ("position", "normal", "albedo"):
        assert (np.abs(got[k] - want[k]).max(-1) <= 1e-5).mean() >= 0.999, k
    assert got["rgb"].mean() > 0.01 and (got["object"] >= 0).any()


def test_hybrid_background_cubemap():
    """A miss-only frame reads the cubemap (tests/test_cubemap.py:203-213),
    which takes precedence over an equirect map."""
    faces = np.zeros((6, 4, 4, 3), np.float32)
    faces[:] = np.eye(6, 3, dtype=np.float32)[:, None, None, :] + 0.25
    scene = MeshScene()
    scene.env_cube = faces
    scene.env_map = np.ones((4, 8, 3), np.float32)
    dev = gt.hybrid.pipeline._DeviceScene(scene, HybridConfig(), "cpu")
    out = dev.background(torch.tensor([[0, 0, -1.0], [1.0, 0, 0]])).numpy()
    np.testing.assert_allclose(out[0], faces[5, 0, 0], atol=1e-6)
    np.testing.assert_allclose(out[1], faces[0, 0, 0], atol=1e-6)


def test_load_minimal_gltf(tmp_path):
    """tests/test_hybrid.py:234's one-triangle glTF through the port's
    loader and renderer."""
    pos = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    idx = np.asarray([0, 1, 2], np.uint16)
    buf = pos.tobytes() + idx.tobytes()
    gltf = {
        "asset": {"version": "2.0"}, "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "translation": [0, 0, -2]}],
        "meshes": [{"name": "tri", "primitives": [{
            "attributes": {"POSITION": 0}, "indices": 1, "material": 0}]}],
        "materials": [{"name": "m", "pbrMetallicRoughness": {
            "baseColorFactor": [1, 0, 0, 1], "metallicFactor": 0.0,
            "roughnessFactor": 0.5}}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 3,
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5123, "count": 3,
             "type": "SCALAR"}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": 36},
            {"buffer": 0, "byteOffset": 36, "byteLength": 6}],
        "buffers": [{"byteLength": len(buf),
                     "uri": "data:application/octet-stream;base64,"
                            + base64.b64encode(buf).decode()}],
    }
    path = tmp_path / "tri.gltf"
    path.write_text(json.dumps(gltf))
    scene = load_gltf(str(path))
    want = g3.hybrid.load_gltf(str(path))
    assert scene.num_tris == 1
    np.testing.assert_array_equal(scene.tri_pos, want.tri_pos)
    np.testing.assert_array_equal(scene.material_table(),
                                  want.material_table())
    scene.lights.append(tmesh.Light(position=(0.3, 0.3, 0.0), radius=10.0))
    out = HybridRenderer(16, 16, device="cpu").render(
        scene, g3.Camera.from_fovy(16, 16, 60.0, np.eye(4)))
    obj = out["object"].numpy()
    assert (obj == 0).any() and (obj == -1).any()


def test_instanced_objects():
    """add_instanced (tests/test_hybrid.py:300-333): K instances share one
    material and animate one by one, as in the JAX package."""
    def build(m):
        s = m.MeshScene()
        pos, idx = m._quad([-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0])
        trs = []
        for i in range(3):
            t = np.eye(4, dtype=np.float32)
            t[0, 3] = 3.0 * i
            trs.append(t)
        objs = s.add_instanced("panel", pos, idx,
                               m.Material(base_color=(1.0, 0.0, 0.0, 1.0)),
                               trs, dynamic=True,
                               update=[None, None, m.oscillate(1, 0.5, 1.0)])
        return s, objs
    s, objs = build(tmesh)
    w, _ = build(g3.hybrid.mesh)
    assert len(s.materials) == 1 and s.num_tris == 6
    assert [o.name for o in objs] == ["panel.0", "panel.1", "panel.2"]
    np.testing.assert_array_equal(s.animated(0.25).tri_pos,
                                  w.animated(0.25).tri_pos)
    moved = s.animated(0.25).tri_pos[objs[2].first_tri:]
    assert np.abs(moved[..., 1] - s.tri_pos[objs[2].first_tri:][..., 1]) \
        .max() > 0.4


def test_cli_hybrid_matches_jax(tmp_path):
    """`hybrid --device cpu` at 32^2 against the JAX CLI's PNG, and the
    refusal without CUDA when no device is named."""
    args = ["hybrid", "-w", "32", "--height", "32"]
    cli_main(args + ["--device", "cpu", "--out", str(tmp_path / "port")])
    jax_cli(args + ["--out", str(tmp_path / "jax")])
    got = gt.io.load_png(str(tmp_path / "port" / "hybrid_0000.png"))
    want = g3.io.load_png(str(tmp_path / "jax" / "hybrid_0000.png"))
    assert got.shape == (32, 32, 3) and got.max() > 0
    diff = np.abs(got.astype(int) - want.astype(int)).max(-1)
    assert (diff <= 1).mean() >= 0.999, diff.max()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli_main(args + ["--out", str(tmp_path / "no_device")])
