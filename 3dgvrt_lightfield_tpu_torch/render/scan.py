"""Inclusive max-scan of a 1-D int64 array: binning's run fills.

Binning fills runs by scattering each run's value at its start into zeros
and taking the running maximum (pair -> Gaussian id, chunk -> tile, sorted
pair -> padded-slot delta, reduce block -> output group).  The JAX package
takes that maximum with `jax.lax.cummax`.  On CUDA tensors `max_scan` runs
it as one launch of `csrc/max_scan.cu`, a single-pass scan over the whole
card; on CPU tensors it takes the plain version, cummax's values.
"""

from __future__ import annotations

import torch

from .. import _build
from ..utils.profiling import count


def max_scan(x: torch.Tensor) -> torch.Tensor:
    """out[i] = max(x[0], ..., x[i]) of a contiguous 1-D int64 tensor, in a
    new tensor, bit for bit the values of cummax along dim 0.

    On CUDA tensors this launches `csrc/max_scan.cu` on the current stream
    (no synchronisation), adds one to `max_scan.launches` and counts
    `gvrt.binning.scan`; fewer than two elements are copied without a
    launch.  On CPU tensors it runs the plain version."""
    if x.dtype != torch.int64 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"max_scan takes a contiguous 1-D int64 tensor, not "
                         f"{x.dtype} of shape {tuple(x.shape)} and strides "
                         f"{x.stride()}")
    if x.device.type == "cpu":
        return torch.cummax(x, 0).values
    if x.device.type != "cuda":
        raise ValueError(f"max_scan runs on CUDA or the CPU, not {x.device}")
    n = x.numel()
    if n <= 1:
        return x.clone()
    lib = _build.load("max_scan")
    out = torch.empty_like(x)
    scratch = torch.empty(lib.gvrt_max_scan_scratch_words(n),
                          dtype=torch.int64, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.gvrt_max_scan(x.data_ptr(), out.data_ptr(), n,
                                scratch.data_ptr(),
                                torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"max_scan kernel launch failed: CUDA error {err}")
    max_scan.launches += 1
    count("gvrt.binning.scan")
    return out


max_scan.launches = 0
