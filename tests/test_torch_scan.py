"""The port's max-scan wrapper (`render/scan.py::max_scan`) on the CPU.

On CPU tensors `max_scan` is its plain version, cummax's values; the kernel
(`csrc/max_scan.cu`) is held to it on the card by `tests/test_torch_cuda.py`.
These tests hold the plain branch, the input checks, and that the port calls
cummax nowhere else.  They import neither JAX nor the JAX package:

    python -m pytest tests/test_torch_scan.py -q --noconftest \
        -p no:cacheprovider
"""

import os
import re
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gvrt_tpu_torch.render import scan  # noqa: E402

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "3dgvrt_lightfield_tpu_torch")


@pytest.mark.parametrize("n", [0, 1, 1000])
def test_max_scan_on_the_cpu_is_cummax(n):
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.integers(-2**62, 2**62, n, dtype=np.int64))
    x[::7] = 0
    got = scan.max_scan(x)
    assert got.dtype == torch.int64 and got.shape == (n,)
    assert torch.equal(got, torch.cummax(x, 0).values)


@pytest.mark.parametrize("case", ["int32", "two_dims", "strided"])
def test_max_scan_rejects_what_the_kernel_does_not_take(case):
    x = torch.arange(12, dtype=torch.int64)
    bad = {"int32": x.to(torch.int32), "two_dims": x.reshape(3, 4),
           "strided": x[::2]}[case]
    with pytest.raises(ValueError, match="contiguous 1-D int64"):
        scan.max_scan(bad)


def test_no_cummax_outside_the_plain_branch():
    """The port's sources call cummax in one place: `max_scan`'s branch for
    CPU tensors.  Every run fill on the card goes through the kernel."""
    found = []
    for root, _, files in os.walk(PKG):
        for name in files:
            if name.endswith((".py", ".cu", ".cuh")):
                path = os.path.join(root, name)
                with open(path) as f:
                    for i, line in enumerate(f, 1):
                        if re.search(r"\bcummax\s*\(", line):
                            found.append((os.path.relpath(path, PKG), i,
                                          line.strip()))
    assert len(found) == 1, found
    path, i, line = found[0]
    assert path == os.path.join("render", "scan.py"), found
    assert line == "return torch.cummax(x, 0).values", found
    with open(os.path.join(PKG, path)) as f:
        before = f.read().splitlines()[i - 2].strip()
    assert before == 'if x.device.type == "cpu":', before
