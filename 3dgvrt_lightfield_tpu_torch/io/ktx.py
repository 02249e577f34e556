"""KTX texture container I/O (v1 and v2, incl. Zstd/ZLIB supercompression).

The reference loads its environment cubemaps from `.ktx` files through the
vendored libktx (base/VulkanTexture.cpp `loadCubemap`, called at
VulkanRTBase.cpp:3656).  This is a from-scratch reader for the two container
revisions covering the formats the renderer consumes (8-bit UNORM/SRGB and
16/32-bit float, RGB/RGBA), plus KTX1/KTX2 writers so cubemaps can be
produced and round-tripped without external tooling.  KTX2 supercompression
schemes 2 (Zstandard) and 3 (ZLIB) are decompressed on load — the per-level
byte-stream schemes libktx handles in ktxTexture2_LoadImageData; BasisLZ
(scheme 1) is a GPU-block-format transcoder and stays out of scope: the
pipeline samples raw float faces (hybrid/shade.py `sample_env_cube`), so
BasisU assets should be converted offline once.

A copy of the JAX package's `io/ktx.py` with two deliberate differences:
a ZLIB level is inflated to at most the length its index gives (a stream
that inflates further, or a corrupt one, raises ValueError), and
`save_ktx2` aligns an uncompressed level's offset to lcm(texel bytes, 4) as
the KTX2 spec asks (the JAX reader honours the stored offset, so it reads
these files too).

Layout notes (Khronos KTX spec v1 / v2):
  * v1: 12-byte magic, 13 uint32 header words, key/value blob, then per mip
    level `imageSize` + payload (cubemaps: 6 faces each padded to 4 bytes).
  * v2: 12-byte magic, fixed header with `vkFormat` + level index table;
    face data for all layers/faces of a level is contiguous at its offset.
"""

from __future__ import annotations

import math
import os
import struct
from typing import Optional

import numpy as np

_KTX1_MAGIC = b"\xabKTX 11\xbb\r\n\x1a\n"
_KTX2_MAGIC = b"\xabKTX 20\xbb\r\n\x1a\n"

# GL enums used by KTX1 (gl.h values; no GL dependency, just constants)
_GL_UNSIGNED_BYTE = 0x1401
_GL_HALF_FLOAT = 0x140B
_GL_FLOAT = 0x1406
_GL_RGB = 0x1907
_GL_RGBA = 0x1908
_GL_RGBA8 = 0x8058
_GL_RGB8 = 0x8051
_GL_SRGB8 = 0x8C41
_GL_SRGB8_ALPHA8 = 0x8C43
_GL_RGBA16F = 0x881A
_GL_RGBA32F = 0x8814

_GL_DTYPES = {
    _GL_UNSIGNED_BYTE: np.dtype(np.uint8),
    _GL_HALF_FLOAT: np.dtype(np.float16),
    _GL_FLOAT: np.dtype(np.float32),
}
_GL_CHANNELS = {_GL_RGB: 3, _GL_RGBA: 4}
_SRGB_INTERNAL = {_GL_SRGB8, _GL_SRGB8_ALPHA8}

# VkFormat values used by KTX2 (vulkan_core.h; constants only)
_VK_FORMATS = {
    23: (np.uint8, 3, False),    # R8G8B8_UNORM
    29: (np.uint8, 3, True),     # R8G8B8_SRGB
    37: (np.uint8, 4, False),    # R8G8B8A8_UNORM
    43: (np.uint8, 4, True),     # R8G8B8A8_SRGB
    90: (np.float16, 3, False),  # R16G16B16_SFLOAT
    97: (np.float16, 4, False),  # R16G16B16A16_SFLOAT
    106: (np.float32, 3, False),  # R32G32B32_SFLOAT
    109: (np.float32, 4, False),  # R32G32B32A32_SFLOAT
}


def _to_float(img: np.ndarray, srgb: bool) -> np.ndarray:
    if img.dtype == np.uint8:
        out = img.astype(np.float32) / 255.0
        if srgb:  # EOTF: the sampler view would decode sRGB -> linear
            out = np.where(out <= 0.04045, out / 12.92,
                           ((out + 0.055) / 1.055) ** 2.4)
        return out.astype(np.float32)
    return img.astype(np.float32)


def _read_ktx1(buf: bytes):
    if len(buf) < 12 + 13 * 4:
        raise ValueError("truncated KTX1 file")
    endian = {0x04030201: "<", 0x01020304: ">"}.get(
        struct.unpack_from("<I", buf, 12)[0])
    if endian is None:
        raise ValueError("bad KTX1 endianness marker")
    (gl_type, _type_size, gl_format, gl_internal, _base_internal,
     width, height, depth, n_array, n_faces, n_mips,
     kv_bytes) = struct.unpack_from(endian + "12I", buf, 16)
    if depth > 1:
        raise ValueError("3D KTX textures unsupported")
    if gl_type not in _GL_DTYPES or gl_format not in _GL_CHANNELS:
        raise ValueError(
            f"unsupported/compressed KTX1 payload (glType=0x{gl_type:X}, "
            f"glFormat=0x{gl_format:X}); convert to RGB/RGBA "
            "u8/f16/f32 offline")
    dtype = np.dtype(_GL_DTYPES[gl_type]).newbyteorder(endian)
    ch = _GL_CHANNELS[gl_format]
    height = max(height, 1)
    n_array = max(n_array, 1)
    n_faces = max(n_faces, 1)
    off = 16 + 12 * 4 + kv_bytes

    # mip 0 only (the renderer builds no mip chain; faces are sampled raw)
    (image_size,) = struct.unpack_from(endian + "I", buf, off)
    off += 4
    # KTX1 stores rows at GL_UNPACK_ALIGNMENT=4: each row is padded to a
    # 4-byte pitch (matters for RGB8 with w*3 % 4 != 0; r2 advisor finding)
    row_bytes = width * ch * dtype.itemsize
    row_pitch = row_bytes + (-row_bytes) % 4
    face_bytes = row_pitch * height
    # KTX1 quirk: for cubemaps imageSize is the size of ONE face
    expected = face_bytes if n_faces == 6 and n_array == 1 \
        else face_bytes * n_array * n_faces
    if image_size not in (expected, face_bytes * n_array * n_faces):
        raise ValueError(f"KTX1 imageSize {image_size} != expected "
                         f"{expected} (w={width} h={height} ch={ch})")
    faces = []
    for _layer in range(n_array):
        for _face in range(n_faces):
            rows = np.frombuffer(buf, np.uint8, face_bytes, off)
            rows = rows.reshape(height, row_pitch)[:, :row_bytes]
            arr = np.ascontiguousarray(rows).view(dtype)
            faces.append(arr.reshape(height, width, ch))
            off += face_bytes + (-face_bytes) % 4  # cubePadding
    img = np.stack(faces) if len(faces) > 1 else faces[0]
    return _to_float(img, gl_internal in _SRGB_INTERNAL)


def _inflate_bounded(data: bytes, uncomp_len: int) -> bytes:
    """Inflate a ZLIB stream to at most `uncomp_len` bytes.

    A stream that would inflate past the level index's length raises
    without being inflated whole, and a corrupt or truncated stream raises
    ValueError, like every other load failure here."""
    import zlib
    d = zlib.decompressobj()
    try:
        # (a max_length of 0 would mean no bound)
        out = d.decompress(data, max(uncomp_len, 1))
        # output stopped at the bound: the rest of the input may only be
        # the stream's end (no further byte)
        if len(out) > uncomp_len or (
                d.unconsumed_tail and d.decompress(d.unconsumed_tail, 1)):
            raise ValueError(f"KTX2 ZLIB level inflates past the {uncomp_len} "
                             "bytes its index gives")
        out += d.flush()
    except zlib.error as e:
        raise ValueError(f"corrupt ZLIB level in KTX2 file: {e}") from e
    if not d.eof:
        raise ValueError("truncated ZLIB level in KTX2 file")
    return out


def _level_alignment(texel_bytes: int) -> int:
    """KTX2 offset alignment of an uncompressed level: lcm(texel bytes, 4)."""
    return texel_bytes * 4 // math.gcd(texel_bytes, 4)


def _decompress_level(scheme: int, data: bytes, uncomp_len: int) -> bytes:
    """Undo KTX2 per-level supercompression (spec section 3.12.3)."""
    if scheme == 2:  # Zstandard
        try:
            import zstandard
        except ImportError as e:  # environment-gated, like native/ply
            raise ValueError(
                "Zstd-supercompressed KTX2 needs the `zstandard` module; "
                "convert offline (ktx2ktx2/toktx --zcmp 0)") from e
        out = zstandard.ZstdDecompressor().decompress(
            data, max_output_size=uncomp_len)
    elif scheme == 3:  # ZLIB
        out = _inflate_bounded(data, uncomp_len)
    else:
        raise ValueError(
            f"supercompressed KTX2 (scheme {scheme}) unsupported — only "
            "None/Zstd/ZLIB payloads; BasisLZ must be transcoded offline")
    if len(out) != uncomp_len:
        raise ValueError(f"KTX2 level decompressed to {len(out)} bytes, "
                         f"index says {uncomp_len}")
    return out


def _read_ktx2(buf: bytes):
    header = struct.unpack_from("<IIIIIIII", buf, 12)
    (vk_format, _type_size, width, height, depth, n_layers, n_faces,
     n_mips) = header
    (scheme,) = struct.unpack_from("<I", buf, 44)
    if depth > 1:
        raise ValueError("3D KTX textures unsupported")
    if vk_format not in _VK_FORMATS:
        raise ValueError(f"unsupported KTX2 vkFormat {vk_format}; supported: "
                         f"{sorted(_VK_FORMATS)}")
    np_dtype, ch, srgb = _VK_FORMATS[vk_format]
    dtype = np.dtype(np_dtype)
    height = max(height, 1)
    n_layers = max(n_layers, 1)
    n_faces = max(n_faces, 1)
    # level index: 3x uint64 per level, after the 80-byte header block
    lvl_off, lvl_len, uncomp = struct.unpack_from("<QQQ", buf, 80)
    face_bytes = width * height * ch * dtype.itemsize
    need = face_bytes * n_layers * n_faces
    if scheme != 0:
        level = _decompress_level(scheme, buf[lvl_off:lvl_off + lvl_len],
                                  uncomp)
        lvl_len, off = len(level), 0
    else:
        level, off = buf, lvl_off
    if lvl_len < need:
        raise ValueError(f"KTX2 level 0 too short ({lvl_len} < {need})")
    faces = []
    for _ in range(n_layers * n_faces):
        arr = np.frombuffer(level, dtype, width * height * ch, off)
        faces.append(arr.reshape(height, width, ch))
        off += face_bytes
    img = np.stack(faces) if len(faces) > 1 else faces[0]
    return _to_float(img, srgb)


def load_ktx(path: str) -> np.ndarray:
    """Read a `.ktx`/`.ktx2` file -> float32 image, mip level 0.

    Returns (H, W, C) for a 2D texture or (faces/layers, H, W, C) for
    cubemaps/arrays — cubemap faces in KTX/Vulkan layer order
    [+X, -X, +Y, -Y, +Z, -Z], matching `hybrid.shade.sample_env_cube`.
    sRGB payloads are decoded to linear (what a Vulkan sRGB view samples).
    """
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:12] == _KTX1_MAGIC:
        return _read_ktx1(buf)
    if buf[:12] == _KTX2_MAGIC:
        return _read_ktx2(buf)
    raise ValueError(f"{path}: not a KTX1/KTX2 file")


def save_ktx1(path: str, img: np.ndarray, srgb: bool = False,
              cubemap: Optional[bool] = None) -> None:
    """Write a KTX v1 file (mip 0 only) from float [0,1] or uint8 pixels.

    img: (H, W, C) or (6, S, S, C) with C in {3, 4}.  Float inputs are
    stored as GL_FLOAT; uint8 as GL_UNSIGNED_BYTE (sRGB internal format
    when `srgb`).  Produces files libktx-compatible enough for the
    reference's loader (VulkanTexture.cpp) and for `load_ktx`.
    """
    img = np.asarray(img)
    if cubemap is None:
        cubemap = img.ndim == 4
    faces = img if cubemap else img[None]
    if cubemap and faces.shape[0] != 6:
        raise ValueError("cubemap must have 6 faces [+X-X+Y-Y+Z-Z]")
    h, w, ch = faces.shape[1:]
    if ch not in (3, 4):
        raise ValueError("channels must be 3 (RGB) or 4 (RGBA)")
    if faces.dtype == np.uint8:
        gl_type, dtype = _GL_UNSIGNED_BYTE, np.dtype(np.uint8)
        internal = ({3: _GL_SRGB8, 4: _GL_SRGB8_ALPHA8} if srgb
                    else {3: _GL_RGB8, 4: _GL_RGBA8})[ch]
    else:
        gl_type, dtype = _GL_FLOAT, np.dtype(np.float32)
        internal = {3: 0x8815, 4: _GL_RGBA32F}[ch]  # RGB32F / RGBA32F
        faces = faces.astype(np.float32)
    gl_format = {3: _GL_RGB, 4: _GL_RGBA}[ch]
    # rows padded to GL_UNPACK_ALIGNMENT=4 pitch, per spec (r2 advisor)
    row_bytes = w * ch * dtype.itemsize
    row_pad = (-row_bytes) % 4
    face_bytes = (row_bytes + row_pad) * h
    n_faces = 6 if cubemap else 1
    # per spec, cubemap imageSize is the size of one face
    image_size = face_bytes

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(_KTX1_MAGIC)
        f.write(struct.pack(
            "<13I", 0x04030201, gl_type, dtype.itemsize, gl_format,
            internal, gl_format, w, h, 0, 0, n_faces, 1, 0))
        f.write(struct.pack("<I", image_size))
        for face in faces:
            raw = np.ascontiguousarray(face, dtype)
            if row_pad:  # only reachable for uint8 RGB (f32 rows align)
                padded = np.zeros((h, row_bytes + row_pad), np.uint8)
                padded[:, :row_bytes] = raw.view(np.uint8).reshape(
                    h, row_bytes)
                raw = padded
            f.write(raw.tobytes())
            # face_bytes is already 4-byte aligned via the row pitch


def save_ktx2(path: str, img: np.ndarray, srgb: bool = False,
              cubemap: Optional[bool] = None,
              supercompression: Optional[str] = None,
              level: int = 9) -> None:
    """Write a KTX v2 file (mip 0 only), optionally supercompressed.

    img: (H, W, C) or (6, S, S, C) with C in {3, 4}; uint8 stays uint8
    (sRGB vkFormat when `srgb`), anything else is stored as float32.
    `supercompression`: None, "zstd" (scheme 2) or "zlib" (scheme 3) —
    the byte-stream schemes `load_ktx` undoes; `level` is the codec level.
    Targets `load_ktx` round-trips (no DFD/KVD blocks are emitted; libktx
    itself requires a DFD, so use `save_ktx1` for reference-tool interop).
    """
    img = np.asarray(img)
    if cubemap is None:
        cubemap = img.ndim == 4
    faces = img if cubemap else img[None]
    if cubemap and faces.shape[0] != 6:
        raise ValueError("cubemap must have 6 faces [+X-X+Y-Y+Z-Z]")
    h, w, ch = faces.shape[1:]
    if ch not in (3, 4):
        raise ValueError("channels must be 3 (RGB) or 4 (RGBA)")
    if faces.dtype == np.uint8:
        vk_format = ({3: 29, 4: 43} if srgb else {3: 23, 4: 37})[ch]
        dtype = np.dtype(np.uint8)
    else:
        vk_format = {3: 106, 4: 109}[ch]  # R32G32B32(A32)_SFLOAT
        dtype = np.dtype(np.float32)
    payload = np.ascontiguousarray(faces, dtype).tobytes()
    uncomp = len(payload)
    if supercompression is None:
        scheme, data = 0, payload
    elif supercompression == "zstd":
        import zstandard
        scheme = 2
        data = zstandard.ZstdCompressor(level=level).compress(payload)
    elif supercompression == "zlib":
        import zlib
        scheme = 3
        data = zlib.compress(payload, level)
    else:
        raise ValueError(f"unknown supercompression {supercompression!r}")

    lvl_off = 12 + 68 + 24  # magic + header/index32 block + 1-level index
    if scheme == 0:
        # an uncompressed level starts at a multiple of lcm(texel bytes, 4)
        # (KTX2 spec; the reader honours the stored offset either way)
        lvl_off += (-lvl_off) % _level_alignment(ch * dtype.itemsize)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(_KTX2_MAGIC)
        f.write(struct.pack(
            "<9I", vk_format, dtype.itemsize, w, h, 0, 0,
            6 if cubemap else 1, 1, scheme))
        f.write(struct.pack("<4I", 0, 0, 0, 0))  # dfd/kvd offset+length
        f.write(struct.pack("<QQ", 0, 0))        # sgd offset+length
        f.write(struct.pack("<QQQ", lvl_off, len(data), uncomp))
        f.write(bytes(lvl_off - f.tell()))
        f.write(data)
