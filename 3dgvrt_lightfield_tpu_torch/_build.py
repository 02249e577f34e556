"""Build the port's CUDA kernels with nvcc at first use; load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled on its own
into `build/kernels/lib<name>_<hash>.so` at the repository root, keyed on a
hash of the source, the shared headers (`csrc/*.cuh`) and the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.  There is no fallback: a missing nvcc or a
failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Sequence

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")

#: Hopper with its architecture-specific features; IEEE math (no fast math)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

#: C signatures of the entry points, set on the loaded library
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
SIGNATURES = {
    "tile_forward": {
        "gvrt_tile_forward": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _F, _F, _F, _F, _F, _I, _P],
                              ctypes.c_int),
    },
    "tile_backward": {
        "gvrt_tile_backward": ([_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                _I, _I, _F, _F, _F, _F, _I, _P],
                               ctypes.c_int),
        "gvrt_tile_backward_smem": ([_I, _I], ctypes.c_int),
    },
    "segment_reduce": {
        "gvrt_segment_reduce": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
                                ctypes.c_int),
    },
    "camera_rays": {
        "gvrt_camera_rays": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
                             ctypes.c_int),
    },
    "max_scan": {
        "gvrt_max_scan": ([_P, _P, _L, _P, _P], ctypes.c_int),
        "gvrt_max_scan_scratch_words": ([_L], _L),
    },
    "param_table": {
        "gvrt_param_table_forward": ([_P] * 11 + [_L, _P], ctypes.c_int),
        "gvrt_param_table_backward": ([_P] * 11 + [_L, _P], ctypes.c_int),
    },
    "bin_expand": {
        "gvrt_bin_run_starts": ([_P, _P, _L, _L, _P, _P], ctypes.c_int),
        "gvrt_bin_pair_keys": ([_P] * 9 + [_L, _I, _I, _I, _I, _I, _F, _F,
                                          _F, _F, _P], ctypes.c_int),
    },
    "segment_reduce_compact": {
        "gvrt_segment_reduce_compact": ([_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                         _P], ctypes.c_int),
        "gvrt_segment_reduce_compact_table": ([_P, _P, _P, _P, _P, _P, _P, _I,
                                               _I, _I, _I, _I, _I, _P],
                                              ctypes.c_int),
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: on PATH, else under $CUDA_HOME (default /usr/local/cuda)."""
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> str:
    """Build path keyed on the source, every shared header and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for src in [name + ".cu"] + headers:
        with open(os.path.join(CSRC_DIR, src), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def build(names: Sequence[str] = tuple(SIGNATURES)) -> Dict[str, str]:
    """Compile every named kernel that is not built yet, all nvcc processes
    started together; returns {name: library path}.  Raises on any failure."""
    paths = {name: library_path(name) for name in names}
    todo = {n: p for n, p in paths.items() if not os.path.exists(p)}
    if todo:
        os.makedirs(BUILD_DIR, exist_ok=True)
        exe = nvcc()
        procs = {}
        for name, path in todo.items():
            tmp = f"{path}.tmp{os.getpid()}"
            cmd = [exe, *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC_DIR, name + ".cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp)
        failed = []
        for name, (proc, tmp) in procs.items():
            log = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            else:
                os.replace(tmp, todo[name])
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The built library of kernel `name`, with its C signatures set."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(build([name])[name])
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[name] = lib
        return _libs[name]
