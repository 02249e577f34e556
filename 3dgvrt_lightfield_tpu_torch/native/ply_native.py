"""ctypes binding of the native C++ PLY parser (native/ply_native.cpp).

The reference links miniply (external/miniply) for PLY parsing; this is the
repository's native equivalent, a copy of the JAX package's.  The first
call of `available()` in a process compiles the source with g++ into
`build/native/` at the repository root, keyed on a hash of the source, the
flags and the host CPU (`-march=native` ties the library to the machine
that built it), and loads it; an unchanged source on the same machine is
loaded as it is.  Nothing is written into the source tree.  Without g++, or
when the build fails, `available()` is False and `io.ply` reads with NumPy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import Dict, Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "ply_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "native")
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_attempted = False


def _host_cpu() -> bytes:
    """What -march=native depends on: the CPU's model and feature flags."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = [ln for ln in f.read().splitlines()
                     if ln.startswith((b"model name", b"flags"))]
        return b"\n".join(sorted(set(lines)))
    except OSError:
        return platform.processor().encode()


def library_path() -> str:
    """Build path keyed on the source, the flags and the host CPU."""
    digest = hashlib.sha256(" ".join(FLAGS).encode() + _host_cpu())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libply_native_{digest.hexdigest()[:16]}.so")


def build() -> bool:
    """Compile ply_native.cpp with g++ into `library_path()` unless it is
    there; True when the library exists afterwards."""
    out = library_path()
    if os.path.exists(out):
        return True
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    try:
        res = subprocess.run(["g++", *FLAGS, SOURCE, "-o", tmp],
                             capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    if res.returncode != 0:
        return False
    os.replace(tmp, out)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    lib.ply_open.restype = ctypes.c_void_p
    lib.ply_open.argtypes = [ctypes.c_char_p]
    lib.ply_num_rows.restype = ctypes.c_int64
    lib.ply_num_rows.argtypes = [ctypes.c_void_p]
    lib.ply_num_props.restype = ctypes.c_int32
    lib.ply_num_props.argtypes = [ctypes.c_void_p]
    lib.ply_prop_name.restype = ctypes.c_char_p
    lib.ply_prop_name.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.ply_extract.restype = ctypes.c_int32
    lib.ply_extract.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                ctypes.POINTER(ctypes.c_float)]
    lib.ply_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    """True when the native parser is usable, building it on the first call
    of the process (one attempt: a missing or broken toolchain leaves the
    NumPy parser in charge)."""
    global _build_attempted
    with _lock:
        if _load() is not None:
            return True
        if not _build_attempted:
            _build_attempted = True
            if build():
                return _load() is not None
        return False


def read_ply_arrays(path: str) -> Dict[str, np.ndarray]:
    """Read the first vertex element's properties as float32 arrays through
    the C++ parser; raises IOError when it cannot parse the file."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native PLY library not built")
    handle = lib.ply_open(os.fspath(path).encode())
    if not handle:
        raise IOError(f"native PLY parser failed to open {path}")
    try:
        n = lib.ply_num_rows(handle)
        nprops = lib.ply_num_props(handle)
        out: Dict[str, np.ndarray] = {}
        for i in range(nprops):
            name = lib.ply_prop_name(handle, i).decode()
            arr = np.empty(n, dtype=np.float32)
            ok = lib.ply_extract(
                handle, i, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            if ok != 0:
                raise IOError(f"native PLY extract failed for {name}")
            out[name] = arr
        return out
    finally:
        lib.ply_close(handle)
