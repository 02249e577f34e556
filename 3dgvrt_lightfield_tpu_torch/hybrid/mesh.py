"""Triangle-mesh scene model + minimal glTF loader + procedural scenes.

Covers the reference's mesh data path: vkglTF::Model loading
(base/VulkanglTFModel.cpp, used by VulkanHybrid.cpp:1384+), the per-geometry
`GeometryNode` material record (shaders/glsl/base/geometrytypes.glsl:26-39:
texture indices, reflectance, refractance, ior, metallic/roughness factors),
the `Light` struct (shaders/glsl/base/light.glsl:19-24: position, radius,
color) and the SceneObjectManager named static/dynamic object registry with
per-frame animation update (base/SceneObjectManager.h:41-49).

The loader is a from-scratch minimal glTF 2.0 reader (JSON + buffers), not a
tinygltf port: it supports TRIANGLES primitives with POSITION / NORMAL /
TEXCOORD_0 / TANGENT attributes, node hierarchies with TRS or matrix
transforms, pbrMetallicRoughness materials, and base-color / emissive /
metallic-roughness / normal textures from PNG images.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import struct
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Materials / lights
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Material:
    """Per-object shading record (GeometryNode, geometrytypes.glsl:26-39)."""
    base_color: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    metallic: float = 1.0
    roughness: float = 1.0
    emissive: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    ior: float = 1.45
    reflectance: float = 0.0
    refractance: float = 0.0
    tex_base_color: int = -1
    tex_metallic_roughness: int = -1
    tex_emissive: int = -1
    tex_normal: int = -1


@dataclasses.dataclass
class Light:
    """Point light (light.glsl:19-24)."""
    position: Tuple[float, float, float]
    color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    radius: float = 100.0
    static: bool = False   # ubo.lights vs uboStaticLight (raygen.rgen:104-108)


@dataclasses.dataclass
class SceneObject:
    """Named object registry entry (base/SceneObjectManager.h:19-49).

    `update` maps (base transform, time) -> transform, the functional version
    of SceneObjectManager::Update's per-frame scale/rotate/translate/sine/
    follow-cam animation hooks.
    """
    name: str
    first_tri: int
    num_tris: int
    material: int
    dynamic: bool = False
    update: Optional[Callable[[np.ndarray, float], np.ndarray]] = None


def rotate_y(deg_per_s: float) -> Callable[[np.ndarray, float], np.ndarray]:
    """Animation hook: spin around +Y (SceneObjectManager.h ROTATE)."""
    def fn(base: np.ndarray, t: float) -> np.ndarray:
        a = math.radians(deg_per_s * t)
        r = np.eye(4, dtype=np.float32)
        r[0, 0] = r[2, 2] = math.cos(a)
        r[0, 2] = math.sin(a)
        r[2, 0] = -math.sin(a)
        return base @ r
    return fn


def oscillate(axis: int, amplitude: float,
              hz: float) -> Callable[[np.ndarray, float], np.ndarray]:
    """Animation hook: sine translation (SceneObjectManager.h SINE)."""
    def fn(base: np.ndarray, t: float) -> np.ndarray:
        out = base.copy()
        out[axis, 3] += amplitude * math.sin(2.0 * math.pi * hz * t)
        return out
    return fn


# ---------------------------------------------------------------------------
# Scene container
# ---------------------------------------------------------------------------

class MeshScene:
    """SoA triangle soup + materials + lights + env map.

    Arrays (NumPy on host; `device_arrays` packs them for the tracer):
      tri_pos (T, 3, 3) float32, tri_normal (T, 3, 3), tri_uv (T, 3, 2),
      tri_tangent (T, 3, 4), tri_material (T,) int32.
    """

    def __init__(self):
        self.tri_pos = np.zeros((0, 3, 3), np.float32)
        self.tri_normal = np.zeros((0, 3, 3), np.float32)
        self.tri_uv = np.zeros((0, 3, 2), np.float32)
        self.tri_tangent = np.zeros((0, 3, 4), np.float32)
        self.tri_material = np.zeros((0,), np.int32)
        self.materials: List[Material] = []
        self.lights: List[Light] = []
        self.objects: List[SceneObject] = []
        self.textures: List[np.ndarray] = []   # each (H, W, 4) float32
        self.env_map: Optional[np.ndarray] = None  # equirect (H, W, 3)
        #: 6-face cubemap (6, S, S, 3) in Vulkan/KTX layer order
        #: [+X, -X, +Y, -Y, +Z, -Z]; takes precedence over env_map
        self.env_cube: Optional[np.ndarray] = None

    # -- construction ------------------------------------------------------

    def add_object(self, name: str, positions: np.ndarray, indices: np.ndarray,
                   material: Material, normals: Optional[np.ndarray] = None,
                   uvs: Optional[np.ndarray] = None,
                   tangents: Optional[np.ndarray] = None,
                   transform: Optional[np.ndarray] = None,
                   dynamic: bool = False,
                   update: Optional[Callable] = None) -> SceneObject:
        positions = np.asarray(positions, np.float32)
        indices = np.asarray(indices, np.int64).reshape(-1, 3)
        if transform is not None:
            m = np.asarray(transform, np.float32)
            positions = positions @ m[:3, :3].T + m[:3, 3]
            if normals is not None:
                nrm_m = np.linalg.inv(m[:3, :3]).T
                normals = np.asarray(normals, np.float32) @ nrm_m.T
        tp = positions[indices]                       # (T, 3, 3)
        if normals is None:
            e1 = tp[:, 1] - tp[:, 0]
            e2 = tp[:, 2] - tp[:, 0]
            fn = np.cross(e1, e2)
            fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-12)
            tn = np.repeat(fn[:, None, :], 3, axis=1)
        else:
            normals = np.asarray(normals, np.float32)
            normals = normals / np.maximum(
                np.linalg.norm(normals, axis=-1, keepdims=True), 1e-12)
            tn = normals[indices]
        tu = (np.asarray(uvs, np.float32)[indices] if uvs is not None
              else np.zeros((len(indices), 3, 2), np.float32))
        tt = (np.asarray(tangents, np.float32)[indices] if tangents is not None
              else np.zeros((len(indices), 3, 4), np.float32))

        # material may be an existing table index (instanced registration
        # shares one material across instances, SceneObjectManager.h:41-49)
        if isinstance(material, Material):
            mat_id = len(self.materials)
            self.materials.append(material)
        else:
            mat_id = int(material)
            assert 0 <= mat_id < len(self.materials), mat_id
        obj = SceneObject(name=name, first_tri=len(self.tri_pos),
                          num_tris=len(tp), material=mat_id, dynamic=dynamic,
                          update=update)
        self.objects.append(obj)
        self.tri_pos = np.concatenate([self.tri_pos, tp])
        self.tri_normal = np.concatenate([self.tri_normal, tn])
        self.tri_uv = np.concatenate([self.tri_uv, tu])
        self.tri_tangent = np.concatenate([self.tri_tangent, tt])
        self.tri_material = np.concatenate(
            [self.tri_material, np.full((len(tp),), mat_id, np.int32)])
        return obj

    def add_instanced(self, name: str, positions: np.ndarray,
                      indices: np.ndarray, material: Material,
                      transforms, normals: Optional[np.ndarray] = None,
                      uvs: Optional[np.ndarray] = None,
                      tangents: Optional[np.ndarray] = None,
                      dynamic: bool = False,
                      update=None) -> List[SceneObject]:
        """Register K instances sharing one geometry + one material entry
        (the reference's instanced registration,
        base/SceneObjectManager.h:41-49).

        `transforms` is a sequence of (4, 4) per-instance matrices; each
        instance becomes its own named SceneObject (``f"{name}.{i}"``) so
        the per-frame animation hooks apply per instance — `update` may be
        one callable shared by all instances or a per-instance sequence.
        """
        mat_id = len(self.materials)
        self.materials.append(material)
        objs = []
        for i, tr in enumerate(transforms):
            upd = update[i] if isinstance(update, (list, tuple)) else update
            objs.append(self.add_object(
                f"{name}.{i}", positions, indices, mat_id, normals=normals,
                uvs=uvs, tangents=tangents, transform=tr, dynamic=dynamic,
                update=upd))
        return objs

    @property
    def num_tris(self) -> int:
        return len(self.tri_pos)

    # -- animation (SceneObjectManager::Update) ---------------------------

    def animated(self, t: float) -> "MeshScene":
        """Return a scene with dynamic objects' update(base, t) applied."""
        if not any(o.dynamic and o.update for o in self.objects):
            return self
        out = MeshScene()
        out.materials = self.materials
        out.lights = self.lights
        out.objects = self.objects
        out.textures = self.textures
        out.env_map = self.env_map
        out.env_cube = self.env_cube
        out.tri_pos = self.tri_pos.copy()
        out.tri_normal = self.tri_normal.copy()
        out.tri_uv = self.tri_uv
        out.tri_tangent = self.tri_tangent
        out.tri_material = self.tri_material
        for o in self.objects:
            if not (o.dynamic and o.update):
                continue
            m = o.update(np.eye(4, dtype=np.float32), t)
            s = slice(o.first_tri, o.first_tri + o.num_tris)
            p = self.tri_pos[s]
            out.tri_pos[s] = p @ m[:3, :3].T + m[:3, 3]
            nrm_m = np.linalg.inv(m[:3, :3]).T
            n = self.tri_normal[s] @ nrm_m.T
            out.tri_normal[s] = n / np.maximum(
                np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
        return out

    # -- packing for the tracer -------------------------------------------

    def material_table(self) -> np.ndarray:
        """(M, 16) float32 rows mirroring GeometryNode."""
        rows = []
        for m in self.materials:
            rows.append([*m.base_color[:3], m.metallic, m.roughness,
                         *m.emissive, m.ior, m.reflectance, m.refractance,
                         float(m.tex_base_color),
                         float(m.tex_metallic_roughness),
                         float(m.tex_emissive), float(m.tex_normal), 0.0])
        return np.asarray(rows, np.float32).reshape(-1, 16)

    def light_table(self) -> np.ndarray:
        """(L, 8): [px py pz radius cr cg cb static]."""
        rows = [[*l.position, l.radius, *l.color, float(l.static)]
                for l in self.lights]
        return (np.asarray(rows, np.float32).reshape(-1, 8)
                if rows else np.zeros((0, 8), np.float32))


# ---------------------------------------------------------------------------
# Minimal glTF 2.0 loader
# ---------------------------------------------------------------------------

_COMPONENT = {5120: np.int8, 5121: np.uint8, 5122: np.int16,
              5123: np.uint16, 5125: np.uint32, 5126: np.float32}
_NUMEL = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
          "MAT3": 9, "MAT4": 16}


def _read_glb(path: str) -> Tuple[dict, List[bytes]]:
    with open(path, "rb") as f:
        magic, _, _ = struct.unpack("<III", f.read(12))
        if magic != 0x46546C67:
            raise ValueError(f"{path}: not a GLB file")
        gltf = None
        buffers: List[bytes] = []
        while True:
            head = f.read(8)
            if len(head) < 8:
                break
            length, ctype = struct.unpack("<II", head)
            chunk = f.read(length)
            if ctype == 0x4E4F534A:     # 'JSON'
                gltf = json.loads(chunk)
            elif ctype == 0x004E4942:   # 'BIN'
                buffers.append(chunk)
        return gltf, buffers


def _accessor(gltf: dict, buffers: List[bytes], idx: int) -> np.ndarray:
    acc = gltf["accessors"][idx]
    view = gltf["bufferViews"][acc["bufferView"]]
    data = buffers[view.get("buffer", 0)]
    dtype = _COMPONENT[acc["componentType"]]
    numel = _NUMEL[acc["type"]]
    count = acc["count"]
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = view.get("byteStride") or numel * np.dtype(dtype).itemsize
    if stride == numel * np.dtype(dtype).itemsize:
        arr = np.frombuffer(data, dtype, count * numel, offset)
    else:  # interleaved
        raw = np.frombuffer(data, np.uint8,
                            stride * (count - 1) + numel * np.dtype(dtype).itemsize,
                            offset)
        arr = np.lib.stride_tricks.as_strided(
            raw.view(dtype), (count, numel),
            (stride, np.dtype(dtype).itemsize)).copy()
    arr = arr.reshape(count, numel) if numel > 1 else arr.reshape(count)
    if acc.get("normalized") and dtype != np.float32:
        arr = arr.astype(np.float32) / np.iinfo(dtype).max
    return arr


def _node_transform(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float32)
    if "scale" in node:
        m[:3, :3] *= np.asarray(node["scale"], np.float32)
    if "rotation" in node:  # glTF quaternion xyzw
        x, y, z, w = node["rotation"]
        r = np.asarray([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ], np.float32)
        m[:3, :3] = r @ m[:3, :3]
    if "translation" in node:
        m[:3, 3] = node["translation"]
    return m


def _load_texture(gltf: dict, buffers: List[bytes], base_dir: str,
                  scene: MeshScene, tex_idx: int) -> int:
    """Decode a glTF texture's PNG into scene.textures; returns slot id."""
    from ..io.image import load_png
    tex = gltf["textures"][tex_idx]
    img = gltf["images"][tex["source"]]
    if "uri" in img and not img["uri"].startswith("data:"):
        arr = load_png(os.path.join(base_dir, img["uri"]))
    elif "bufferView" in img:
        import io as _io
        view = gltf["bufferViews"][img["bufferView"]]
        data = buffers[view.get("buffer", 0)]
        off = view.get("byteOffset", 0)
        raw = data[off:off + view["byteLength"]]
        arr = load_png(_io.BytesIO(raw))
    else:
        return -1
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, axis=-1)
    if arr.shape[-1] == 3:
        arr = np.concatenate([arr, np.ones_like(arr[..., :1])], axis=-1)
    scene.textures.append(arr.astype(np.float32))
    return len(scene.textures) - 1


def load_gltf(path: str, extras: Optional[Dict[str, dict]] = None) -> MeshScene:
    """Load a .gltf/.glb file into a MeshScene.

    `extras` maps material name -> {reflectance, refractance, ior} overrides —
    the reference carries these in GeometryNode from its scene conventions.
    """
    base_dir = os.path.dirname(os.path.abspath(path))
    if path.endswith(".glb"):
        gltf, buffers = _read_glb(path)
    else:
        with open(path) as f:
            gltf = json.load(f)
        buffers = []
        for buf in gltf.get("buffers", []):
            uri = buf["uri"]
            if uri.startswith("data:"):
                import base64
                buffers.append(base64.b64decode(uri.split(",", 1)[1]))
            else:
                with open(os.path.join(base_dir, uri), "rb") as f:
                    buffers.append(f.read())

    scene = MeshScene()
    tex_cache: Dict[int, int] = {}

    def get_tex(idx: Optional[int]) -> int:
        if idx is None:
            return -1
        if idx not in tex_cache:
            tex_cache[idx] = _load_texture(gltf, buffers, base_dir, scene, idx)
        return tex_cache[idx]

    def material_for(prim: dict) -> Material:
        mi = prim.get("material")
        if mi is None:
            return Material()
        m = gltf["materials"][mi]
        pbr = m.get("pbrMetallicRoughness", {})
        mat = Material(
            base_color=tuple(pbr.get("baseColorFactor", (1, 1, 1, 1))),
            metallic=pbr.get("metallicFactor", 1.0),
            roughness=pbr.get("roughnessFactor", 1.0),
            emissive=tuple(m.get("emissiveFactor", (0, 0, 0))),
            tex_base_color=get_tex(
                pbr.get("baseColorTexture", {}).get("index")),
            tex_metallic_roughness=get_tex(
                pbr.get("metallicRoughnessTexture", {}).get("index")),
            tex_emissive=get_tex(m.get("emissiveTexture", {}).get("index")),
            tex_normal=get_tex(m.get("normalTexture", {}).get("index")),
        )
        for k, v in (extras or {}).get(m.get("name", ""), {}).items():
            setattr(mat, k, v)
        return mat

    def walk(node_idx: int, parent: np.ndarray):
        node = gltf["nodes"][node_idx]
        xform = parent @ _node_transform(node)
        if "mesh" in node:
            mesh = gltf["meshes"][node["mesh"]]
            for pi, prim in enumerate(mesh.get("primitives", [])):
                if prim.get("mode", 4) != 4:   # TRIANGLES only
                    continue
                attrs = prim["attributes"]
                pos = _accessor(gltf, buffers, attrs["POSITION"]).astype(
                    np.float32)
                idx = (_accessor(gltf, buffers, prim["indices"]).astype(np.int64)
                       if "indices" in prim
                       else np.arange(len(pos), dtype=np.int64))
                nrm = (_accessor(gltf, buffers, attrs["NORMAL"]).astype(
                    np.float32) if "NORMAL" in attrs else None)
                uv = (_accessor(gltf, buffers, attrs["TEXCOORD_0"]).astype(
                    np.float32) if "TEXCOORD_0" in attrs else None)
                tan = (_accessor(gltf, buffers, attrs["TANGENT"]).astype(
                    np.float32) if "TANGENT" in attrs else None)
                name = mesh.get("name", f"mesh{node['mesh']}") + f"#{pi}"
                scene.add_object(name, pos, idx, material_for(prim),
                                 normals=nrm, uvs=uv, tangents=tan,
                                 transform=xform)
        for child in node.get("children", []):
            walk(child, xform)

    scene_def = gltf["scenes"][gltf.get("scene", 0)]
    for root in scene_def.get("nodes", []):
        walk(root, np.eye(4, dtype=np.float32))

    for ext_l in gltf.get("extensions", {}).get(
            "KHR_lights_punctual", {}).get("lights", []):
        scene.lights.append(Light(position=(0.0, 0.0, 0.0),
                                  color=tuple(ext_l.get("color", (1, 1, 1))),
                                  radius=ext_l.get("range", 100.0)))
    return scene


# ---------------------------------------------------------------------------
# Procedural scenes (for tests / demos without assets)
# ---------------------------------------------------------------------------

def _quad(a, b, c, d):
    pos = np.asarray([a, b, c, d], np.float32)
    idx = np.asarray([[0, 1, 2], [0, 2, 3]], np.int64)
    return pos, idx


def _icosphere(radius: float = 1.0, center=(0, 0, 0), subdiv: int = 2):
    t = (1.0 + math.sqrt(5.0)) / 2.0
    verts = np.asarray([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    verts = list(map(tuple, verts))
    for _ in range(subdiv):
        cache: Dict[Tuple[int, int], int] = {}

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                m = np.asarray(verts[i]) + np.asarray(verts[j])
                m /= np.linalg.norm(m)
                verts.append(tuple(m))
                cache[key] = len(verts) - 1
            return cache[key]

        new_faces = []
        for (i, j, k) in faces:
            a, b, c = midpoint(i, j), midpoint(j, k), midpoint(k, i)
            new_faces += [(i, a, c), (j, b, a), (k, c, b), (a, b, c)]
        faces = new_faces
    v = np.asarray(verts, np.float32)
    n = v.copy()
    v = v * radius + np.asarray(center, np.float32)
    return v, np.asarray(faces, np.int64), n


def quad_icosphere(lo, hi, up: int = 1, subdiv: int = 2) -> MeshScene:
    """Mesh props placed in the box lo..hi (a Gaussian cloud's bounds) with
    `up` its vertical axis: a grey diffuse floor quad of two triangles
    across the box's footprint a quarter of its height up (normal up), a
    red-brown plastic icosphere (`subdiv` subdivisions, smooth normals; 320
    triangles at 2) of radius 3/16 of the box's height resting on it under
    the box's centre (at garden scale's orbit it and the floor then cover
    21-23% of every view), and one white point light of radius 20 half the
    box's height above its top, off the vertical through the centre by a
    quarter of the footprint, so the ball's shadow falls beside it."""
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    c, half = (lo + hi) / 2.0, (hi - lo) / 2.0
    a, b = [k for k in range(3) if k != up]
    y = c[up] - half[up] / 2.0

    def point(pa, pb, pu):
        p = np.zeros(3)
        p[a], p[b], p[up] = pa, pb, pu
        return p

    floor = [point(lo[a], lo[b], y), point(lo[a], hi[b], y),
             point(hi[a], hi[b], y), point(hi[a], lo[b], y)]
    if np.cross(floor[1] - floor[0], floor[2] - floor[0])[up] < 0:
        floor = floor[::-1]
    # a Python float keeps `_icosphere`'s scaling in float32
    r = float(3.0 * half[up] / 8.0)
    s = MeshScene()
    pos, idx = _quad(*floor)
    s.add_object("floor", pos, idx, Material(
        base_color=(0.7, 0.7, 0.7, 1.0), metallic=0.0, roughness=0.8))
    v, f, n = _icosphere(r, point(c[a], c[b], y + r), subdiv=subdiv)
    s.add_object("ball", v, f, Material(
        base_color=(0.8, 0.3, 0.2, 1.0), metallic=0.2, roughness=0.4),
        normals=n)
    light = point(c[a] + half[a] / 2.0, c[b] + half[b] / 2.0,
                  hi[up] + half[up])
    s.lights.append(Light(position=tuple(float(x) for x in light),
                          radius=20.0))
    return s


#: the procedural mesh scenes the CLI's `--mesh NAME` places in a
#: Gaussian scene's bounds: name -> fn(lo, hi, up, subdiv) -> MeshScene
PROCEDURAL = {"quad_icosphere": quad_icosphere}


def cornell_scene(with_mirror: bool = True,
                  with_glass: bool = False) -> MeshScene:
    """Cornell-style box + spheres: the asset-free hybrid demo scene."""
    s = MeshScene()
    white = Material(base_color=(0.73, 0.73, 0.73, 1), metallic=0.0,
                     roughness=0.9)
    red = Material(base_color=(0.65, 0.05, 0.05, 1), metallic=0.0,
                   roughness=0.9)
    green = Material(base_color=(0.12, 0.45, 0.15, 1), metallic=0.0,
                     roughness=0.9)

    # windings chosen so geometric normals face INTO the box (+y floor,
    # -y ceiling, +z back, +x left, -x right)
    pos, idx = _quad([-1, 0, -1], [-1, 0, 1], [1, 0, 1], [1, 0, -1])
    s.add_object("floor", pos, idx, dataclasses.replace(white))
    pos, idx = _quad([-1, 2, -1], [1, 2, -1], [1, 2, 1], [-1, 2, 1])
    s.add_object("ceiling", pos, idx, dataclasses.replace(white))
    pos, idx = _quad([-1, 0, -1], [1, 0, -1], [1, 2, -1], [-1, 2, -1])
    s.add_object("back", pos, idx, dataclasses.replace(white))
    pos, idx = _quad([-1, 0, 1], [-1, 0, -1], [-1, 2, -1], [-1, 2, 1])
    s.add_object("left", pos, idx, red)
    pos, idx = _quad([1, 0, -1], [1, 0, 1], [1, 2, 1], [1, 2, -1])
    s.add_object("right", pos, idx, green)

    v, f, n = _icosphere(0.35, (-0.4, 0.35, -0.3), subdiv=2)
    mat = (Material(base_color=(0.9, 0.9, 0.9, 1), metallic=1.0,
                    roughness=0.1, reflectance=0.8) if with_mirror
           else dataclasses.replace(white))
    s.add_object("sphere_l", v, f, mat, normals=n)

    v, f, n = _icosphere(0.3, (0.45, 0.3, 0.35), subdiv=2)
    mat = (Material(base_color=(1, 1, 1, 1), metallic=0.0, roughness=0.05,
                    refractance=0.9, ior=1.5) if with_glass
           else Material(base_color=(0.85, 0.65, 0.2, 1), metallic=0.6,
                         roughness=0.3))
    s.add_object("sphere_r", v, f, mat, normals=n)

    # off-axis so sphere shadows fall visibly beside the spheres
    s.lights.append(Light(position=(0.55, 1.7, 0.85), color=(1.0, 0.95, 0.9),
                          radius=8.0))
    return s
