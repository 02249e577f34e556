"""INRIA 3DGS PLY loading/saving (pure NumPy).

Reference: base/Vulkan3DGRTModel.cpp:7-125 (miniply-based loader).  The loader
produces the same SoA layout as the reference's `SplatSet` — positions (N,3),
f_dc (N,3), f_rest re-interleaved from channel-major f_rest_0..44 into
coefficient-major (N,15,3) (Vulkan3DGRTModel.cpp:70-77), opacity (N,),
scale (N,3) log-scale, rotation (N,4) WXYZ quaternions.
"""

from __future__ import annotations

import io as _io
import os
import struct
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


@dataclass
class SplatSet:
    """SoA Gaussian attributes, mirroring vk3DGRT::SplatSet (Vulkan3DGRTModel.h)."""
    positions: np.ndarray   # (N, 3) float32
    scale: np.ndarray       # (N, 3) float32, log-scale (pre-activation)
    rotation: np.ndarray    # (N, 4) float32, WXYZ quaternion (unnormalized)
    opacity: np.ndarray     # (N,)  float32, logit (pre-activation)
    f_dc: np.ndarray        # (N, 3) float32 SH DC
    f_rest: np.ndarray      # (N, 15, 3) float32, coefficient-major interleaved

    @property
    def size(self) -> int:
        return self.positions.shape[0]


def _parse_header(f) -> Tuple[str, List[Tuple[str, int, List[Tuple[str, str]]]]]:
    magic = f.readline().strip()
    if magic != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    elements = []
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unterminated PLY header")
        tokens = line.decode("ascii", "replace").strip().split()
        if not tokens or tokens[0] == "comment":
            continue
        if tokens[0] == "format":
            fmt = tokens[1]
        elif tokens[0] == "element":
            elements.append((tokens[1], int(tokens[2]), []))
        elif tokens[0] == "property":
            if tokens[1] == "list":
                elements[-1][2].append((tokens[4], ("list", tokens[2], tokens[3])))
            else:
                elements[-1][2].append((tokens[2], tokens[1]))
        elif tokens[0] == "end_header":
            break
    return fmt, elements


def read_ply_arrays(path: str) -> Dict[str, np.ndarray]:
    """Read the first vertex element of a PLY file into {property: (N,) array}."""
    with open(path, "rb") as f:
        fmt, elements = _parse_header(f)
        out: Dict[str, np.ndarray] = {}
        for name, count, props in elements:
            if any(isinstance(t, tuple) for _, t in props):
                raise ValueError("list properties unsupported in splat PLY")
            if fmt == "ascii":
                ncols = len(props)
                data = np.loadtxt(_io.StringIO(
                    "".join(f.readline().decode("ascii") for _ in range(count))),
                    dtype=np.float64).reshape(count, ncols)
                for i, (pname, ptype) in enumerate(props):
                    out.setdefault(pname, data[:, i].astype(_PLY_DTYPES[ptype]))
            else:
                endian = "<" if fmt == "binary_little_endian" else ">"
                dt = np.dtype([(pname, endian + _PLY_DTYPES[ptype])
                               for pname, ptype in props])
                arr = np.frombuffer(f.read(count * dt.itemsize), dtype=dt, count=count)
                for pname, _ in props:
                    out.setdefault(pname, np.ascontiguousarray(arr[pname]))
            if name == "vertex":
                break  # reference stops at the first gaussian vertex element
        return out


def load_splats(path: str) -> SplatSet:
    """Load an INRIA 3DGS .ply into a SplatSet (Vulkan3DGRTModel.cpp:7-125)."""
    props = read_ply_arrays(path)
    n = props["x"].shape[0]
    positions = np.stack([props["x"], props["y"], props["z"]], axis=1)
    scale = np.stack([props[f"scale_{i}"] for i in range(3)], axis=1)
    rotation = np.stack([props[f"rot_{i}"] for i in range(4)], axis=1)
    opacity = props["opacity"]
    f_dc = np.stack([props[f"f_dc_{i}"] for i in range(3)], axis=1)
    # channel-major f_rest_{c*15+i} -> (N, 15, 3) coefficient-major
    if "f_rest_0" in props:
        rest = np.stack([props[f"f_rest_{i}"] for i in range(45)], axis=1)
        f_rest = rest.reshape(n, 3, 15).transpose(0, 2, 1)
    else:
        f_rest = np.zeros((n, 15, 3), dtype=np.float32)
    return SplatSet(
        positions=np.ascontiguousarray(positions, np.float32),
        scale=np.ascontiguousarray(scale, np.float32),
        rotation=np.ascontiguousarray(rotation, np.float32),
        opacity=np.ascontiguousarray(opacity, np.float32),
        f_dc=np.ascontiguousarray(f_dc, np.float32),
        f_rest=np.ascontiguousarray(f_rest, np.float32),
    )


def save_splats(path: str, splats: SplatSet) -> None:
    """Write a SplatSet back to a binary INRIA 3DGS .ply (incl. zero normals)."""
    n = splats.size
    names = (["x", "y", "z", "nx", "ny", "nz"]
             + [f"f_dc_{i}" for i in range(3)]
             + [f"f_rest_{i}" for i in range(45)]
             + ["opacity"]
             + [f"scale_{i}" for i in range(3)]
             + [f"rot_{i}" for i in range(4)])
    dt = np.dtype([(name, "<f4") for name in names])
    arr = np.zeros(n, dtype=dt)
    arr["x"], arr["y"], arr["z"] = splats.positions.T
    for i in range(3):
        arr[f"f_dc_{i}"] = splats.f_dc[:, i]
    rest = splats.f_rest.transpose(0, 2, 1).reshape(n, 45)  # back to channel-major
    for i in range(45):
        arr[f"f_rest_{i}"] = rest[:, i]
    arr["opacity"] = splats.opacity
    for i in range(3):
        arr[f"scale_{i}"] = splats.scale[:, i]
    for i in range(4):
        arr[f"rot_{i}"] = splats.rotation[:, i]
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    header += [f"property float {name}" for name in names]
    header += ["end_header"]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(arr.tobytes())
