"""PyTorch port, the native C++ PLY reader (native/ply_native.{cpp,py}) and
io/ply.py::_load_props, against the NumPy reader and the JAX package's
`load_splats`, array for array.

The library is built with g++ at first use into build/native/ at the
repository root, never into the source tree.  A loaded native library that
fails to parse a file raises; it does not fall through to NumPy (the JAX
package's `_load_props` does).
"""

import os

import numpy as np
import pytest

import gvrt_tpu as g3
import gvrt_tpu_torch as gt
from gvrt_tpu_torch.io import ply as tply
from gvrt_tpu_torch.native import ply_native

from port_scenes import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def native():
    if not ply_native.available():
        pytest.skip("g++ unavailable: the native reader cannot be built")
    return ply_native


def _splats(n=101, seed=0):
    rng = np.random.default_rng(seed)
    return gt.SplatSet(
        positions=rng.standard_normal((n, 3)).astype(np.float32),
        scale=rng.uniform(-5, -2, (n, 3)).astype(np.float32),
        rotation=rng.standard_normal((n, 4)).astype(np.float32),
        opacity=rng.standard_normal(n).astype(np.float32),
        f_dc=rng.standard_normal((n, 3)).astype(np.float32),
        f_rest=rng.standard_normal((n, 15, 3)).astype(np.float32))


def test_library_is_built_outside_the_source_tree(native):
    path = native.library_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == os.path.join(REPO, "build", "native")
    src = os.path.dirname(native.SOURCE)
    assert not [f for f in os.listdir(src) if f.endswith(".so")]
    assert native.available()        # loaded once, kept


def test_native_reader_matches_numpy_and_jax(native, tmp_path):
    splats = _splats()
    path = str(tmp_path / "s.ply")
    gt.save_splats(path, splats)
    a = tply.read_ply_arrays(path)
    b = native.read_ply_arrays(path)
    assert set(a) == set(b) and len(a) == 62
    for k in a:
        assert b[k].dtype == np.float32
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    got = gt.load_splats(path)
    want = g3.load_splats(path)
    for f in ("positions", "scale", "rotation", "opacity", "f_dc",
              "f_rest"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
        np.testing.assert_array_equal(getattr(got, f), getattr(splats, f),
                                      err_msg=f)


def test_ascii_ply_through_both_readers(native, tmp_path):
    """An ASCII PLY with an int property: the native reader returns every
    property as float32, equal in value to the NumPy reader's."""
    path = tmp_path / "a.ply"
    rows = [(0.5, -1.25, 2.0, 7), (1.0, 0.0, -3.5, -2), (2.5, 3.0, 4.0, 0)]
    path.write_text("ply\nformat ascii 1.0\nelement vertex 3\n"
                    "property float x\nproperty float y\nproperty float z\n"
                    "property int id\nend_header\n"
                    + "".join(" ".join(str(v) for v in r) + "\n"
                              for r in rows))
    a = tply.read_ply_arrays(str(path))
    b = native.read_ply_arrays(str(path))
    for k in ("x", "y", "z", "id"):
        np.testing.assert_array_equal(b[k], a[k].astype(np.float32))


def test_corrupt_file_raises_through_the_native_reader(native, tmp_path):
    """A big-endian PLY (the native parser reads little-endian and ASCII
    only) and a truncated one raise through `load_splats`, where the JAX
    package falls back to its NumPy parser."""
    splats = _splats(n=17, seed=1)
    good = tmp_path / "good.ply"
    gt.save_splats(str(good), splats)
    big = tmp_path / "big.ply"
    big.write_bytes(good.read_bytes().replace(b"binary_little_endian",
                                              b"binary_big_endian"))
    with pytest.raises(IOError):
        gt.load_splats(str(big))
    g3.load_splats(str(big))                     # JAX: NumPy fallback
    short = tmp_path / "short.ply"
    short.write_bytes(good.read_bytes()[:-200])
    with pytest.raises(IOError):
        gt.load_splats(str(short))
    with pytest.raises(IOError):
        gt.load_splats(str(tmp_path / "missing.ply"))


def test_numpy_reader_when_the_library_is_unavailable(tmp_path,
                                                      monkeypatch):
    """Without the library, `_load_props` reads with NumPy."""
    splats = _splats(n=9, seed=2)
    path = str(tmp_path / "s.ply")
    gt.save_splats(path, splats)
    monkeypatch.setattr(ply_native, "available", lambda: False)
    np.testing.assert_array_equal(gt.load_splats(path).f_rest,
                                  splats.f_rest)
