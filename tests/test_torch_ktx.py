"""PyTorch port, KTX cubemaps (io/ktx.py, io/image.py::load_cubemap) against
the JAX package's, in both directions: the port reads what JAX wrote and
JAX reads what the port wrote, float payloads bit for bit.

Two deliberate differences from the JAX package, one test each: a ZLIB
level inflates to at most its index's length (more raises ValueError
without inflating the stream whole), and `save_ktx2` aligns an
uncompressed level's offset to lcm(texel bytes, 4).
"""

import struct
import tracemalloc
import zlib

import numpy as np
import pytest
import torch

import gvrt_tpu as g3
import gvrt_tpu_torch as gt
from gvrt_tpu.hybrid.shade import sample_env_cube as jax_sample_env_cube
from gvrt_tpu.io import ktx as jktx
from gvrt_tpu_torch.hybrid.pipeline import HybridConfig, _DeviceScene
from gvrt_tpu_torch.hybrid.shade import sample_env_cube
from gvrt_tpu_torch.io import ktx as tktx

from port_scenes import one_torch_thread  # noqa: F401

FACE_COLORS = np.array([
    [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0],
    [1.0, 1.0, 0.0], [1.0, 0.0, 1.0], [0.0, 1.0, 1.0]], np.float32)


def _cube(s=8, ch=3, seed=0):
    cube = np.random.default_rng(seed).random((6, s, s, ch), np.float32)
    cube[:, 0, 0, :3] = FACE_COLORS   # corner markers: face order
    return cube


#: (writer, name, image, keyword arguments)
WRITES = {
    "ktx1_cube_f32": ("save_ktx1", "env.ktx", _cube(), {}),
    "ktx1_srgb_u8": ("save_ktx1", "tex.ktx",
                     (np.arange(64, dtype=np.uint8).reshape(4, 4, 4) * 3),
                     {"srgb": True}),
    "ktx1_rgb8_odd": ("save_ktx1", "odd.ktx",
                      (np.arange(75, dtype=np.uint8).reshape(5, 5, 3) * 3)
                      % 251, {}),
    "ktx2_cube_rgba32f": ("save_ktx2", "env.ktx2", _cube(ch=4), {}),
    "ktx2_rgb32f": ("save_ktx2", "rgb.ktx2", _cube(ch=3)[0], {}),
    "ktx2_zlib_srgb": ("save_ktx2", "z.ktx2",
                       np.random.default_rng(12).integers(
                           0, 256, (5, 7, 3), dtype=np.uint8),
                       {"srgb": True, "supercompression": "zlib"}),
    "ktx2_zlib_cube": ("save_ktx2", "zc.ktx2", _cube(ch=4),
                       {"supercompression": "zlib"}),
    "ktx2_zstd_cube": ("save_ktx2", "zs.ktx2", _cube(ch=4),
                       {"supercompression": "zstd"}),
}


@pytest.mark.parametrize("name", sorted(WRITES))
def test_ktx_round_trips_both_ways(tmp_path, name):
    writer, fname, img, kw = WRITES[name]
    if kw.get("supercompression") == "zstd":
        pytest.importorskip("zstandard")
    by_jax, by_port = tmp_path / f"jax_{fname}", tmp_path / f"port_{fname}"
    getattr(jktx, writer)(str(by_jax), img, **kw)
    getattr(tktx, writer)(str(by_port), img, **kw)
    want = jktx.load_ktx(str(by_jax))
    for got in (tktx.load_ktx(str(by_jax)), jktx.load_ktx(str(by_port)),
                tktx.load_ktx(str(by_port))):
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    if img.dtype == np.uint8:
        u = img.astype(np.float32) / 255.0
        if kw.get("srgb"):
            u = np.where(u <= 0.04045, u / 12.92,
                         ((u + 0.055) / 1.055) ** 2.4)
        np.testing.assert_allclose(want, u, atol=1e-6)
    else:
        np.testing.assert_array_equal(want, img)


def test_ktx2_uncompressed_level_offset_is_aligned(tmp_path):
    """lcm(texel bytes, 4): 16 for RGBA32F, 12 for RGB32F, 4 for RGBA8,
    12 for RGB8 (ADVICE.md:4); JAX's writer puts every level at 104."""
    for img, align in ((_cube(ch=4), 16), (_cube(ch=3), 12),
                       (np.zeros((3, 5, 4), np.uint8), 4),
                       (np.zeros((3, 5, 3), np.uint8), 12)):
        path = tmp_path / f"a{align}_{img.shape[-1]}.ktx2"
        tktx.save_ktx2(str(path), img)
        buf = path.read_bytes()
        lvl_off, lvl_len, uncomp = struct.unpack_from("<QQQ", buf, 80)
        assert lvl_off % align == 0 and lvl_off >= 104, (lvl_off, align)
        assert lvl_len == uncomp == img.nbytes
        assert len(buf) == lvl_off + lvl_len
    jktx.save_ktx2(str(tmp_path / "jax.ktx2"), _cube(ch=4))
    assert struct.unpack_from("<Q", (tmp_path / "jax.ktx2").read_bytes(),
                              80)[0] == 104


def _zlib_ktx2(path, payload_chunks, uncomp_len, w=4, h=4):
    """A KTX2 RGBA8 2D file whose ZLIB level is the concatenation of
    `payload_chunks` compressed, with `uncomp_len` in its index."""
    c = zlib.compressobj(1)
    data = b"".join(c.compress(x) for x in payload_chunks) + c.flush()
    header = struct.pack("<9I", 37, 1, w, h, 0, 0, 1, 1, 3)
    buf = (b"\xabKTX 20\xbb\r\n\x1a\n" + header + struct.pack("<4I", 0, 0,
                                                              0, 0)
           + struct.pack("<QQ", 0, 0) + struct.pack("<QQQ", 104, len(data),
                                                    uncomp_len) + data)
    path.write_bytes(buf)
    return data


def test_zlib_level_is_bounded(tmp_path):
    """A ZLIB stream that inflates past uncomp_len (here 256 MiB of zeros
    under an index of 64 bytes) raises ValueError without being inflated
    whole, and a corrupt or truncated one raises ValueError (ADVICE.md:3);
    a stream of exactly uncomp_len bytes loads."""
    zeros = bytes(1 << 20)
    bomb = tmp_path / "bomb.ktx2"
    _zlib_ktx2(bomb, [zeros] * 256, 64)
    tracemalloc.start()
    with pytest.raises(ValueError, match="inflates past"):
        tktx.load_ktx(str(bomb))
    peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    assert peak < (8 << 20), peak
    good = tmp_path / "good.ktx2"
    px = np.arange(64, dtype=np.uint8)
    data = _zlib_ktx2(good, [px.tobytes()], 64)
    np.testing.assert_allclose(tktx.load_ktx(str(good)),
                               px.reshape(4, 4, 4) / 255.0, atol=1e-7)
    corrupt = bytearray(good.read_bytes())
    corrupt[104 + 2:104 + 6] = b"\xff\xff\xff\xff"
    (tmp_path / "corrupt.ktx2").write_bytes(bytes(corrupt))
    with pytest.raises(ValueError):
        tktx.load_ktx(str(tmp_path / "corrupt.ktx2"))
    short = good.read_bytes()[:104 + len(data) // 2]
    (tmp_path / "short.ktx2").write_bytes(short)
    with pytest.raises(ValueError):
        tktx.load_ktx(str(tmp_path / "short.ktx2"))


def test_load_cubemap_matches_jax(tmp_path):
    """load_cubemap from a KTX container and from six PNG faces."""
    cube = _cube(ch=4)
    tktx.save_ktx2(str(tmp_path / "env.ktx2"), cube,
                   supercompression="zlib")
    got = gt.io.load_cubemap(str(tmp_path / "env.ktx2"))
    np.testing.assert_array_equal(
        got, g3.io.load_cubemap(str(tmp_path / "env.ktx2")))
    np.testing.assert_array_equal(got, cube[..., :3])
    paths = []
    for i in range(6):
        paths.append(str(tmp_path / f"face{i}.png"))
        gt.io.save_png(paths[-1], np.broadcast_to(FACE_COLORS[i],
                                                  (4, 4, 3)).copy())
    np.testing.assert_array_equal(gt.io.load_cubemap(paths),
                                  g3.io.load_cubemap(paths))
    tktx.save_ktx2(str(tmp_path / "flat.ktx2"), cube[0])
    with pytest.raises(ValueError, match="not a 6-face cubemap"):
        gt.io.load_cubemap(str(tmp_path / "flat.ktx2"))


def test_sample_env_cube_face_selection_matches_jax():
    """Major axes, off-axis directions and a bilinear sweep across the +Z
    face (tests/test_cubemap.py:33-82) against JAX's sampler."""
    cube = _cube(s=16, seed=3)
    ts = np.linspace(-0.5, 0.5, 41, dtype=np.float32)
    sweep = np.stack([ts, np.zeros_like(ts), np.ones_like(ts)], -1)
    dirs = np.concatenate([
        np.eye(3, dtype=np.float32), -np.eye(3, dtype=np.float32),
        np.asarray([[2.0, 0.3, -0.4], [-5.0, 1.0, 1.0], [0.9, 0.0, 1.0],
                    [-0.9, 0.0, 1.0], [0.0, 0.9, 1.0], [0.0, -0.9, 1.0],
                    [1.0, 1.0, 1.0], [0.0, 0.0, 0.0]], np.float32),
        sweep])
    want = np.asarray(jax_sample_env_cube(cube, dirs))
    got = sample_env_cube(torch.from_numpy(cube),
                          torch.from_numpy(dirs)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    solid = np.broadcast_to(FACE_COLORS[:, None, None, :],
                            (6, 4, 4, 3)).copy()
    np.testing.assert_allclose(sample_env_cube(
        torch.from_numpy(solid), torch.from_numpy(dirs[:6])).numpy(),
        FACE_COLORS[[0, 2, 4, 1, 3, 5]], atol=1e-6)


def test_device_scene_background_reads_the_cubemap(tmp_path):
    """A cubemap the port wrote (ZLIB KTX2) and read back becomes the miss
    path's background (tests/test_cubemap.py:203-213)."""
    solid = np.broadcast_to(FACE_COLORS[:, None, None, :],
                            (6, 8, 8, 3)).copy()
    tktx.save_ktx2(str(tmp_path / "sky.ktx2"), solid, supercompression="zlib")
    scene = gt.hybrid.MeshScene()
    scene.env_cube = gt.io.load_cubemap(str(tmp_path / "sky.ktx2"))
    dev = _DeviceScene(scene, HybridConfig(), "cpu")
    out = dev.background(torch.tensor([[0, 0, -1.0], [1.0, 0, 0]])).numpy()
    np.testing.assert_allclose(out[0], FACE_COLORS[5], atol=1e-6)
    np.testing.assert_allclose(out[1], FACE_COLORS[0], atol=1e-6)
