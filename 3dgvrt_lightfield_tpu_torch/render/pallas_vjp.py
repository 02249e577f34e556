"""The differentiable tile render: K1 with its residual paired with K2.

Counterpart of the JAX package's `render/pallas_vjp.py`.  `render_tiles_ad`
is a `torch.autograd.Function`:

  * forward: the tile composite (`pallas_forward.tile_forward_residual`, K1's
    residual variant) returns the (num_tiles, 8, R) accumulators and saves
    T_in (C, R), the per-ray transmittance at the start of every chunk, as
    the only residual;
  * backward: K2 (`csrc/tile_backward.cu`, launched by `tile_backward`) walks
    each tile's chunk run in reverse with the bar_T carry and applies the
    hand-derived per-chunk VJP (`tile_math.chunk_core_bwd`), emitting the
    (C, G, 64) chunk cotangents, which the gather's backward
    (`param_grads.chunked_gather`) reduces to per-Gaussian gradients.

With `impl="torch"` both halves are the plain versions,
`_forward_residual_plain` and `_backward_plain`, which walk the chunk runs
as `pallas_forward._composite_plain` does, batched over tiles.

Ray cotangents are emitted when cfg.ray_gradients is set: per-tile (24, R)
blocks for the rays, zero for tiles that own no chunk.  With the flag off
(the default: every training path treats rays as constants) the gradient
w.r.t. the rays is SILENT ZEROS, as in the JAX package
(`pallas_vjp.py:278-284` there).  `_background_fix` stays outside the
Function (`pallas_forward.forward_dispatch`).
"""

from __future__ import annotations

import torch

from .. import _build
from ..config import RenderConfig
from ..utils.profiling import span
from .pallas_forward import (_check_device, _check_kernel_inputs,
                             _composite_plain, tile_batch, tile_chunk_runs,
                             tile_forward_residual)
from .tile_math import ACC_T, chunk_core_bwd

#: the largest dynamic shared memory a block may ask for on an H100 (K2's
#: plan stays within it for every R and G: slabs of rays, sub-chunks of rows)
_MAX_SMEM = 232_448


def _forward_residual_plain(chunks, rays, tile_counts, cfg: RenderConfig):
    """Plain version of K1's residual variant: (acc, T_in)."""
    return _composite_plain(chunks, rays, tile_counts, cfg, residual=True)


def _backward_plain(chunks, rays, tile_counts, t_in, bar_acc,
                    cfg: RenderConfig):
    """Plain version of K2: (bar_chunks (C, G, 64), bar_rays (T, 24, R) or
    None without cfg.ray_gradients).

    The k-th chunk from the end of every tile's run at once, in batches of
    tiles: a chunk whose tile was saturated at its start (max T_in <=
    min_T) keeps a zero block and leaves the bar_T carry as it is; chunks in
    no run (dead trailing capacity) keep zero blocks too."""
    num_tiles, _, r = rays.shape
    start, count = tile_chunk_runs(tile_counts, chunks.shape[0],
                                   cfg.chunk_size)
    start, count = start.long(), count.long()
    bar_chunks = torch.zeros_like(chunks)
    bar_rays = torch.zeros_like(rays) if cfg.ray_gradients else None
    bar_t = bar_acc[:, ACC_T:ACC_T + 1, :].clone()
    last = count - 1
    for k in range(int(count.max()) if num_tiles else 0):
        # chunk index of each tile's k-th chunk counted from its run's end
        pos = start + last - k
        has = count > k
        tin_max = torch.where(
            has, t_in[torch.where(has, pos, 0)].amax(dim=1), 0.0)
        alive = has & (tin_max > cfg.min_transmittance)
        for tiles in torch.nonzero(alive).squeeze(1).split(
                tile_batch(cfg.chunk_size, r)):
            idx = pos[tiles]
            out = chunk_core_bwd(rays[tiles], chunks[idx],
                                 t_in[idx][:, None, :], bar_t[tiles],
                                 bar_acc[tiles, 0:3, :],
                                 bar_acc[tiles, 3:4, :], cfg)
            bar_chunks[idx] = out[0]
            bar_t[tiles] = out[1]
            if cfg.ray_gradients:
                bar_rays[tiles] += out[2]
    return bar_chunks, bar_rays


def tile_backward(chunks: torch.Tensor, rays: torch.Tensor,
                  tile_counts: torch.Tensor, t_in: torch.Tensor,
                  bar_acc: torch.Tensor, cfg: RenderConfig):
    """Fused backward of the tile composite: (bar_chunks (C, G, 64),
    bar_rays (T, 24, R) with cfg.ray_gradients, else None).

    On CUDA tensors this launches `csrc/tile_backward.cu` (K2) on the
    current stream and adds one to `tile_backward.launches`; on CPU tensors
    it runs the plain version."""
    if chunks.device.type == "cpu":
        return _backward_plain(chunks, rays, tile_counts, t_in, bar_acc, cfg)
    _check_device("tile_backward", chunks)
    _check_kernel_inputs(chunks, rays, tile_counts, cfg)
    num_chunks, g, _ = chunks.shape
    num_tiles, _, r = rays.shape
    for name, x, shape in (("t_in", t_in, (num_chunks, r)),
                           ("bar_acc", bar_acc, (num_tiles, 8, r))):
        if (x.device != chunks.device or x.dtype != torch.float32
                or not x.is_contiguous() or tuple(x.shape) != shape):
            raise ValueError(f"{name} must be contiguous f32 {shape} on "
                             f"{chunks.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    lib = _build.load("tile_backward")
    smem = lib.gvrt_tile_backward_smem(r, g)
    if smem > _MAX_SMEM:
        raise ValueError(f"the backward kernel needs {smem} B of shared "
                         f"memory at R={r}, G={g} (limit {_MAX_SMEM})")
    start, count = tile_chunk_runs(tile_counts, num_chunks, g)
    bar_chunks = torch.empty_like(chunks)
    bar_rays = torch.empty_like(rays) if cfg.ray_gradients else None
    with torch.cuda.device(chunks.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gvrt_tile_backward(
            chunks.data_ptr(), rays.data_ptr(), start.data_ptr(),
            count.data_ptr(), t_in.data_ptr(), bar_acc.data_ptr(),
            bar_chunks.data_ptr(),
            bar_rays.data_ptr() if cfg.ray_gradients else None, num_tiles,
            num_chunks, r, g, cfg.kernel_degree, cfg.max_alpha,
            cfg.alpha_min, cfg.hit_min_response, cfg.min_transmittance,
            int(cfg.transmittance_prod), stream)
    if err != 0:
        raise RuntimeError(f"tile_backward kernel launch failed: CUDA error "
                           f"{err}")
    tile_backward.launches += 1
    return bar_chunks, bar_rays


#: kernel launches since the last reset (plain-version calls do not count)
tile_backward.launches = 0


class _RenderTiles(torch.autograd.Function):
    @staticmethod
    def forward(ctx, chunks, rays, tile_counts, cfg: RenderConfig, impl: str):
        if impl == "cuda":
            acc, t_in = tile_forward_residual(chunks, rays, tile_counts, cfg)
        else:
            acc, t_in = _forward_residual_plain(chunks, rays, tile_counts,
                                                cfg)
        ctx.save_for_backward(chunks, rays, tile_counts, t_in)
        ctx.cfg, ctx.impl = cfg, impl
        return acc

    @staticmethod
    @span("gvrt.composite.bwd")
    def backward(ctx, bar_acc):
        chunks, rays, tile_counts, t_in = ctx.saved_tensors
        bar_acc = bar_acc.contiguous()
        if ctx.impl == "cuda":
            bar_chunks, bar_rays = tile_backward(chunks, rays, tile_counts,
                                                 t_in, bar_acc, ctx.cfg)
        else:
            bar_chunks, bar_rays = _backward_plain(chunks, rays, tile_counts,
                                                   t_in, bar_acc, ctx.cfg)
        if not ctx.needs_input_grad[1]:
            bar_rays = None
        elif bar_rays is None:
            # the documented silent zero: rays are constants unless
            # cfg.ray_gradients is set
            bar_rays = torch.zeros_like(rays)
        return bar_chunks, bar_rays, None, None, None


def render_tiles_ad(chunks: torch.Tensor, rays: torch.Tensor,
                    tile_counts: torch.Tensor, cfg: RenderConfig,
                    impl: str = "cuda") -> torch.Tensor:
    """Differentiable fused tile render: raw (num_tiles, 8, R) accumulators.

    impl "cuda": K1 with its residual, K2 in the backward; "torch": their
    plain versions.  Gradients flow to `chunks` and, with
    cfg.ray_gradients, to `rays`."""
    return _RenderTiles.apply(chunks, rays, tile_counts, cfg, impl)
