"""The fused forward tile composite: its CUDA kernel, plain version and dispatch.

Counterpart of the JAX package's `render/pallas_forward.py` and of the
forward half of `render/pallas_vjp.py`.  The Pallas kernel
(`pallas_vjp._fwd_kernel`) becomes `csrc/tile_forward.cu`, launched by
`tile_forward`; `forward_tiles_reference` is its plain PyTorch version.

Chunks are laid out in tile order (binning pads each tile's sorted pair list
to whole chunks), so tile t owns the contiguous chunk run
[start[t], start[t] + count[t]) with count = ceil(tile_counts / G) and start
its exclusive prefix sum (`tile_chunk_runs`).  Both versions walk those runs;
trailing dead chunks are never visited.

The same kernel has a residual variant, `tile_forward_residual`, which also
writes T_in (C, R), the transmittance at the start of every chunk: the
residual the backward kernel K2 (`pallas_vjp.py`) reads.  `forward_dispatch`
is differentiable: when grad is enabled and the chunks or rays require it,
it routes through `pallas_vjp.render_tiles_ad` (K1 with the residual, then
K2 in the backward); otherwise it launches K1 without the residual under
`torch.no_grad()`, which is what serving frames run.
"""

from __future__ import annotations

import math

import torch

from .. import _build
from ..config import RenderConfig
from ..ops.kernels import gray_cutoff
from ..utils.profiling import span
from .binning import BinnedScene
from .tile_math import ACC_T, BACKGROUND, RAY_ROWS, chunk_update, init_acc

IMPLS = ("cuda", "torch")
#: (gaussian, ray) pairs per step of the plain version, 1024 tiles at the
#: defaults (G = 64, R = 256): keeps its (B, G, R) temporaries at a few GB
_PAIR_BATCH = 1024 * 64 * 256


def tile_batch(g: int, r: int) -> int:
    """Tiles per step of the plain versions at G gaussians per chunk and R
    rays per tile."""
    return max(1, _PAIR_BATCH // (g * r))


def resolve_impl(impl: str, device: torch.device) -> str:
    """"auto" -> "cuda" on a CUDA device, "torch" (the plain version) on the
    CPU.  "cuda" needs a CUDA device; "torch" on CUDA is taken only when
    asked for by name."""
    if impl == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected auto|cuda|torch")
    if impl == "cuda" and device.type != "cuda":
        raise ValueError(f"impl='cuda' needs a CUDA device, got {device}")
    return impl


def tile_chunk_runs(tile_counts: torch.Tensor, num_chunks: int, g: int):
    """(start, count) int32 of each tile's contiguous chunk run, clipped to
    the `num_chunks` that exist (an overflowing plan truncates the tail)."""
    nch = torch.div(tile_counts.long() + g - 1, g, rounding_mode="floor")
    start = torch.cumsum(nch, 0) - nch
    count = torch.clamp_min(torch.clamp_max(start + nch, num_chunks) - start, 0)
    return start.to(torch.int32), count.to(torch.int32)


def _background_fix(acc, tile_counts):
    """Tiles that received no chunk are sky: [0 0 0 0 1 0 0 0]."""
    bg = torch.tensor(BACKGROUND, dtype=acc.dtype, device=acc.device)
    return torch.where((tile_counts == 0)[:, None, None], bg[None, :, None], acc)


def _composite_plain(chunks, rays, tile_counts, cfg: RenderConfig,
                     residual: bool = False):
    """Plain version of the kernel: the k-th chunk of every live tile at once,
    in batches of `tile_batch` tiles; a tile leaves the walk once its run
    ends or no ray of it is above min_transmittance.  With `residual` it
    also returns T_in (C, R): T at the start of every chunk of a run (the
    saturated T after a tile's early-out) and 1 for the dead trailing
    chunks, as the kernel's residual variant writes it."""
    num_tiles, _, r = rays.shape
    start, count = tile_chunk_runs(tile_counts, chunks.shape[0],
                                   cfg.chunk_size)
    start, count = start.long(), count.long()
    acc = init_acc(r, rays.device, (num_tiles,))
    t_in = (torch.ones((chunks.shape[0], r), dtype=torch.float32,
                       device=rays.device) if residual else None)
    for k in range(int(count.max()) if num_tiles else 0):
        if residual:
            runs = torch.nonzero(count > k).squeeze(1)
            t_in[start[runs] + k] = acc[runs, ACC_T]
        alive = (count > k) & (acc[:, ACC_T, :].amax(dim=1)
                               > cfg.min_transmittance)
        for tiles in torch.nonzero(alive).squeeze(1).split(
                tile_batch(cfg.chunk_size, r)):
            acc[tiles] = chunk_update(rays[tiles], chunks[start[tiles] + k],
                                      acc[tiles], cfg)
    acc = _background_fix(acc, tile_counts)
    return (acc, t_in) if residual else acc


def _check_kernel_inputs(chunks, rays, tile_counts, cfg: RenderConfig):
    num_chunks, g, cols = chunks.shape
    num_tiles, rows, r = rays.shape
    for name, x, dtype in (("chunks", chunks, torch.float32),
                           ("rays", rays, torch.float32),
                           ("tile_counts", tile_counts, torch.int32)):
        if x.device != chunks.device:
            raise ValueError(f"{name} is on {x.device}, chunks on "
                             f"{chunks.device}")
        if x.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if cols != 64 or rows != RAY_ROWS or g != cfg.chunk_size:
        raise ValueError(f"bad shapes: chunks {tuple(chunks.shape)} "
                         f"(G={cfg.chunk_size}, 64), rays {tuple(rays.shape)}")
    if tile_counts.shape != (num_tiles,):
        raise ValueError(f"tile_counts {tuple(tile_counts.shape)} != "
                         f"({num_tiles},)")
    if r < 1 or g < 1:
        raise ValueError(f"bad shapes: R={r} rays, G={g} gaussians per chunk")
    if chunks.data_ptr() % 16:
        raise ValueError("chunks must be 16-byte aligned")


def response_cutoff(kernel_degree: int, hit_min_response: float) -> float:
    """D_hi: the gray distance past which the kernel skips a pair.

    K1's warp-wide early reject skips a gaussian for a warp when every ray
    has cc > D_hi * max(|grdu|^2, 1e-20), a gray distance of at least D_hi
    up to three f32 roundings.  D_hi is the float64 cutoff of a response
    2^-18 below the gate (the card's expf error, a margin of ulps),
    inflated by 2^-13 (the roundings of the product, the division and the
    response's own f32 chain), so a skipped pair's f32 response stays below
    hit_min_response.  +inf (no skip) unless 0 < hit_min_response < 1.
    """
    h = float(hit_min_response)
    if not 0.0 < h < 1.0:
        return math.inf
    return gray_cutoff(h * (1.0 - 2.0 ** -18), kernel_degree) * (
        1.0 + 2.0 ** -13)


def _launch_tile_forward(chunks, rays, tile_counts, cfg: RenderConfig,
                         residual: bool):
    _check_kernel_inputs(chunks, rays, tile_counts, cfg)
    lib = _build.load("tile_forward")
    num_chunks = chunks.shape[0]
    num_tiles, _, r = rays.shape
    start, count = tile_chunk_runs(tile_counts, num_chunks, cfg.chunk_size)
    acc = torch.empty((num_tiles, 8, r), dtype=torch.float32,
                      device=chunks.device)
    t_in = (torch.empty((num_chunks, r), dtype=torch.float32,
                        device=chunks.device) if residual else None)
    with torch.cuda.device(chunks.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gvrt_tile_forward(
            chunks.data_ptr(), rays.data_ptr(), start.data_ptr(),
            count.data_ptr(), tile_counts.data_ptr(), acc.data_ptr(),
            t_in.data_ptr() if residual else None, num_tiles, num_chunks, r,
            cfg.chunk_size, cfg.kernel_degree, cfg.max_alpha, cfg.alpha_min,
            cfg.hit_min_response, cfg.min_transmittance,
            response_cutoff(cfg.kernel_degree, cfg.hit_min_response),
            int(cfg.transmittance_prod), stream)
    if err != 0:
        raise RuntimeError(f"tile_forward kernel launch failed: CUDA error "
                           f"{err}")
    return acc, t_in


def _check_device(fn: str, chunks):
    if chunks.device.type != "cuda":
        raise ValueError(f"{fn} runs on CUDA or the CPU, not {chunks.device}")


def tile_forward(chunks: torch.Tensor, rays: torch.Tensor,
                 tile_counts: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """Fused forward composite: (num_tiles, 8, R) accumulators.

    chunks (C, G, 64) f32, rays (num_tiles, 24, R) f32, tile_counts
    (num_tiles,) i32.  On CUDA tensors this launches `csrc/tile_forward.cu`
    on the current stream (no synchronisation) and adds one to
    `tile_forward.launches`; on CPU tensors it runs the plain version.
    """
    if chunks.device.type == "cpu":
        return _composite_plain(chunks, rays, tile_counts, cfg)
    _check_device("tile_forward", chunks)
    acc, _ = _launch_tile_forward(chunks, rays, tile_counts, cfg, False)
    tile_forward.launches += 1
    return acc


def tile_forward_residual(chunks: torch.Tensor, rays: torch.Tensor,
                          tile_counts: torch.Tensor, cfg: RenderConfig):
    """`tile_forward` that also returns T_in (C, R), the transmittance at the
    start of every chunk (the backward's residual).  On CUDA tensors it
    launches the residual variant of `csrc/tile_forward.cu` and adds one to
    `tile_forward_residual.launches`; on CPU tensors it runs the plain
    version."""
    if chunks.device.type == "cpu":
        return _composite_plain(chunks, rays, tile_counts, cfg, residual=True)
    _check_device("tile_forward_residual", chunks)
    out = _launch_tile_forward(chunks, rays, tile_counts, cfg, True)
    tile_forward_residual.launches += 1
    return out


#: kernel launches since the last reset (plain-version calls do not count)
tile_forward.launches = 0
tile_forward_residual.launches = 0


def forward_tiles(binned: BinnedScene, rays_tiled: torch.Tensor,
                  cfg: RenderConfig) -> torch.Tensor:
    """Run the fused kernel -> (num_tiles, 8, R) [r g b depth T hits 0 0]."""
    if rays_tiled.device.type != "cuda":
        raise ValueError(f"impl='cuda' needs CUDA tensors, got "
                         f"{rays_tiled.device}")
    return tile_forward(binned.chunks, rays_tiled, binned.tile_counts, cfg)


def forward_tiles_reference(binned: BinnedScene, rays_tiled: torch.Tensor,
                            cfg: RenderConfig) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel, on any device."""
    return _composite_plain(binned.chunks, rays_tiled, binned.tile_counts, cfg)


@span("gvrt.composite")
def forward_dispatch(binned: BinnedScene, rays_tiled: torch.Tensor,
                     cfg: RenderConfig, impl: str) -> torch.Tensor:
    """One impl -> kernel dispatch for every render path ("cuda" | "torch").

    Differentiable: with grad enabled and chunks or rays requiring grad it
    goes through `pallas_vjp.render_tiles_ad` (K1 with its residual and K2,
    or their plain versions for "torch"); otherwise it runs the forward
    alone under `torch.no_grad()`, K1 without the residual for "cuda"."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "cuda" and rays_tiled.device.type != "cuda":
        raise ValueError(f"impl='cuda' needs CUDA tensors, got "
                         f"{rays_tiled.device}")
    if torch.is_grad_enabled() and (binned.chunks.requires_grad
                                    or rays_tiled.requires_grad):
        from .pallas_vjp import render_tiles_ad
        acc = render_tiles_ad(binned.chunks, rays_tiled, binned.tile_counts,
                              cfg, impl)
        return _background_fix(acc, binned.tile_counts)
    with torch.no_grad():
        if impl == "cuda":
            return forward_tiles(binned, rays_tiled, cfg)
        return forward_tiles_reference(binned, rays_tiled, cfg)
