"""Multi-device rendering and training on `torch.distributed`.

Counterpart of the JAX package's `parallel/sharding.py`.  JAX's `Mesh`
drives N devices from one controller and `shard_map` splits the work; here
the idiom is one process per card, so the port's `Mesh` is SPMD over ranks:
every rank runs the same code on its own card, with the Gaussian
parameters replicated, and the collectives of a process group join them:

  * `render_batch_sharded`: rank r renders its slice of the camera batch;
    an all-gather hands every rank the whole (B, H, W, 8) batch;
  * `render_image_tile_sharded`: rank r bins and renders every D-th tile
    row of one frame; an all-gather assembles the frame on every rank;
  * `average_gradients`: the trainer's gradient (and loss) all-reduce,
    the counterpart of the `pmean`s of the JAX step.

In a single process without a process group a mesh has one rank and the
collectives are no-ops.  Under gloo, tensors on a card travel through host
memory (gloo's transport is the host's); under NCCL they stay on the cards.
`CameraBatch`, `camera_batch` and `_render_one` are the single-card pieces
the trainer shares.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..config import (DEFAULT_CONFIG, RenderConfig, resolve_device,
                      resolve_impl)
from ..models.gaussians import GaussianModel
from ..render.binning import (band_rays, bin_topology, binned_scene,
                              gather_from_rows, plan_capacity, tile_rays,
                              unband_image, untile)
from ..render.pallas_forward import forward_dispatch
from ..render.rows_vjp import frame_params
from ..render.tiled import _camera_mats
from ..utils.profiling import count, span
from .distributed import local_batch_slice, rank_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1D mesh of ranks: the process group (None in a single process
    without one), its size, this rank's index in it, this rank's device and
    the axis name."""
    group: Optional[object]
    size: int
    index: int
    device: torch.device
    axis: str = "cam"

    @property
    def backend(self) -> Optional[str]:
        return None if self.group is None else dist.get_backend(self.group)


def make_mesh(n_devices: Optional[int] = None, axis: str = "cam",
              devices: Optional[Sequence] = None) -> Optional[Mesh]:
    """1D mesh over the first n (default: all) ranks of the initialized
    group; every rank of the group calls it.

    Rank r runs on `devices[r]` when the list is given (one entry per rank
    of the mesh), else on `cuda:LOCAL_RANK`.  Raises when n exceeds the
    world size, and under NCCL when two ranks name one card: ranks may share
    a card only over gloo with the device list named explicitly.  A rank
    past the first n gets None.  Without a process group the world is this
    one process."""
    initialized = dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks: the world has {world} "
                         f"rank(s)")
    if devices is not None:
        devices = [resolve_device(d) for d in devices]
        if len(devices) != n:
            raise ValueError(f"{len(devices)} devices named for a mesh of "
                             f"{n} ranks")
    group = None
    if initialized:
        group = dist.group.WORLD if n == world else dist.new_group(
            list(range(n)))
        if dist.get_backend() == "nccl" and devices is not None:
            cards = [d for d in devices if d.type == "cuda"]
            if len(set(cards)) != len(cards):
                raise ValueError(f"two ranks name one card under NCCL: "
                                 f"{[str(d) for d in devices]}")
    if rank >= n:
        return None
    device = rank_device(None if devices is None else devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(group, n, rank, device, axis)


def _check_axis(mesh: Mesh, axis: str):
    if axis != mesh.axis:
        raise ValueError(f"axis {axis!r}: the mesh's is {mesh.axis!r}")


def _via_host(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The buffer a collective runs on: gloo moves host tensors."""
    return t.cpu() if mesh.backend == "gloo" and t.is_cuda else t


def _all_reduce_sum_(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Sum `t` over the mesh's ranks, in place."""
    if mesh.group is not None:
        buf = _via_host(mesh, t)
        dist.all_reduce(buf, dist.ReduceOp.SUM, group=mesh.group)
        if buf is not t:
            t.copy_(buf)
    return t


def _all_gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """(size, *t.shape): every rank's `t`, in rank order, on t's device."""
    buf = _via_host(mesh, t.contiguous())
    parts = [torch.empty_like(buf) for _ in range(mesh.size)]
    dist.all_gather(parts, buf, group=mesh.group)
    return torch.stack(parts).to(t.device)


def _gather_ranks(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(size, *local.shape), differentiable (`_GatherRanks`)."""
    return local[None] if mesh.group is None else _GatherRanks.apply(local,
                                                                     mesh)


class _GatherRanks(torch.autograd.Function):
    """All-gather with a backward: the gathered cotangent is summed over
    the ranks and this rank's part returned, as
    `torch.distributed.nn.functional.all_gather` does.  When every rank
    computes the same loss of the gathered tensor, that sum is D times this
    rank's cotangent, and `average_gradients` divides the D back out: the
    averaged gradients equal the unsharded ones."""

    @staticmethod
    def forward(ctx, local, mesh):
        ctx.mesh = mesh
        return _all_gather(mesh, local)

    @staticmethod
    def backward(ctx, grad):
        grad = _all_reduce_sum_(ctx.mesh, grad.contiguous().clone())
        return grad[ctx.mesh.index], None


def average_gradients(model: GaussianModel, mesh: Mesh,
                      loss: Optional[torch.Tensor] = None):
    """All-reduce every leaf's gradient (a leaf without one counts as zero)
    and `loss` to their averages over the mesh, in one flat bucket: the
    counterpart of the `pmean`s of the JAX package's sharded step.  Returns
    the averaged loss (None without one).

    Spans: `gvrt.allreduce` around it all, `.pack` for the bucket's
    concatenation, `.unpack` for the copy back into the leaves; counters
    `gvrt.allreduce.bytes` (the bucket's bytes) and `gvrt.ranks` (the
    mesh's size), once a call."""
    leaves = model.leaves()
    with span("gvrt.allreduce"):
        with span("gvrt.allreduce.pack"):
            for p in leaves:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            parts = [p.grad.reshape(-1) for p in leaves]
            if loss is not None:
                parts.append(loss.detach().reshape(1).to(parts[0].dtype))
            flat = torch.cat(parts)
        count("gvrt.allreduce.bytes", flat.numel() * flat.element_size())
        count("gvrt.ranks", mesh.size)
        _all_reduce_sum_(mesh, flat).div_(mesh.size)
        with span("gvrt.allreduce.unpack"):
            off = 0
            for p in leaves:
                p.grad.copy_(flat[off:off + p.numel()].view_as(p))
                off += p.numel()
    # a copy: a view would keep the whole bucket alive with the loss
    return None if loss is None else flat[-1].clone()


class CameraBatch(NamedTuple):
    """Stacked per-camera render inputs; leading axis = camera."""
    w2c: np.ndarray      # (B, 4, 4) float32
    proj: np.ndarray     # (B, 4, 4) float32
    rays: torch.Tensor   # (B, num_tiles, 24, R): binning.tile_rays layout


@span("gvrt.rays")
def camera_batch(cameras: Sequence, cfg: RenderConfig,
                 device=None, impl: str = "auto") -> CameraBatch:
    """Stack the cameras' matrices and tiled rays (rays on `device`, the
    card unless ``device="cpu"``; `impl` as `binning.tile_rays`)."""
    dev = resolve_device(device)
    mats = [_camera_mats(cam) for cam in cameras]
    return CameraBatch(np.stack([m[0] for m in mats]),
                       np.stack([m[1] for m in mats]),
                       torch.stack([tile_rays(cam, cfg, dev, impl=impl)
                                    for cam in cameras]))


def local_cameras(cams: CameraBatch, mesh: Mesh):
    """(this rank's share of a global camera batch with its rays on the
    rank's device, the slice of the batch it is)."""
    sl = local_batch_slice(cams.rays.shape[0], mesh.size, mesh.index)
    return CameraBatch(cams.w2c[sl], cams.proj[sl],
                       cams.rays[sl].to(mesh.device)), sl


def _render_one(act, rows64, w2c, proj, rays, width, height,
                cfg: RenderConfig, cap: int, cap_pad: int,
                impl: str) -> torch.Tensor:
    """Bin `act`, gather `rows64` and composite one camera -> (H, W, 8)
    accumulator image, differentiable w.r.t. the table through the gather
    (`frame_params` makes both; the topology is built without grad, as in
    the JAX package, its reduce plan only when grad is enabled)."""
    with_plan = torch.is_grad_enabled()  # the gather's backward reads it
    with torch.no_grad():
        topo = bin_topology(act, w2c, proj, width, height, cfg, cap, cap_pad,
                            with_reduce_plan=with_plan)
    acc = forward_dispatch(binned_scene(
        gather_from_rows(rows64, topo, cfg, impl), topo), rays, cfg, impl)
    return untile(acc, width, height, cfg.tile_size)


def _check_model(model: GaussianModel, mesh: Mesh):
    if model.device != mesh.device:
        raise ValueError(f"model is on {model.device}, this rank on "
                         f"{mesh.device}")


def render_batch_sharded(model: GaussianModel, cams: CameraBatch,
                         mesh: Mesh, width: int, height: int,
                         cfg: RenderConfig = DEFAULT_CONFIG, cap: int = 0,
                         cap_pad: int = 0, impl: str = "auto",
                         axis: str = "cam") -> torch.Tensor:
    """Render a batch of cameras sharded across the mesh; params replicated.

    Every rank passes the whole batch and renders its `local_batch_slice`;
    returns the (B, H, W, 8) accumulator images (rgb, depth, T, hits) on
    every rank, differentiable as `_GatherRanks` says."""
    _check_axis(mesh, axis)
    _check_model(model, mesh)
    impl = resolve_impl(impl, mesh.device)
    act, rows64 = frame_params(model, cfg, impl)
    local, _ = local_cameras(cams, mesh)
    imgs = torch.stack([
        _render_one(act, rows64, local.w2c[i], local.proj[i], local.rays[i],
                    width, height, cfg, cap, cap_pad, impl)
        for i in range(local.rays.shape[0])])
    return _gather_ranks(imgs, mesh).reshape(-1, height, width,
                                                  imgs.shape[-1])


@span("gvrt.replicate")
def replicate_model(model: GaussianModel, mesh: Mesh) -> GaussianModel:
    """Move the model to this rank's device and broadcast every leaf from
    the mesh's first rank, so all ranks start from the same parameters."""
    model = model.to(mesh.device)
    if mesh.group is not None:
        src = dist.get_global_rank(mesh.group, 0)
        with torch.no_grad():
            for p in model.leaves():
                buf = _via_host(mesh, p.data)
                dist.broadcast(buf, src, group=mesh.group)
                if buf is not p.data:
                    p.copy_(buf)
    return model


@torch.no_grad()
def plan_capacity_sharded(model: GaussianModel, camera, n_devices: int,
                          cfg: RenderConfig = DEFAULT_CONFIG):
    """(capacity, capacity_padded) for tile-row-sharded rendering: the max
    over the per-band plans, so every rank bins with the same shapes (host
    planning)."""
    act = model.activate()
    w2c, proj = _camera_mats(camera)
    cap = cap_pad = 0
    for off in range(n_devices):
        c, cp = plan_capacity(act, w2c, proj, camera.width, camera.height,
                              cfg, band=(off, n_devices))
        cap, cap_pad = max(cap, c), max(cap_pad, cp)
    return cap, cap_pad


def render_image_tile_sharded(model: GaussianModel, camera, mesh: Mesh,
                              cfg: RenderConfig = DEFAULT_CONFIG,
                              impl: str = "auto", capacity=None,
                              axis: str = "cam") -> torch.Tensor:
    """Render ONE camera with its tile rows sharded across the mesh.

    Rank r bins and renders every D-th tile row starting at r (round robin
    for load balance: contiguous bands would put the object's tiles on the
    middle ranks), with the parameters replicated; the bands are gathered
    and the assembled (H, W, 8) accumulator image is returned on every rank.

    Differentiable: the gather's backward sums the image cotangent over
    the ranks (`_GatherRanks`), so after `loss.backward()` on every rank,
    `average_gradients` yields the gradients of the unsharded frame."""
    _check_axis(mesh, axis)
    _check_model(model, mesh)
    impl = resolve_impl(impl, mesh.device)
    d, width, height = mesh.size, camera.width, camera.height
    act, rows64 = frame_params(model, cfg, impl)
    w2c, proj = _camera_mats(camera)
    if capacity is None:
        capacity = plan_capacity_sharded(model, camera, d, cfg)
    cap, cap_pad = capacity
    rays = band_rays(camera, cfg, d, mesh.device,
                     impl=impl)[mesh.index].contiguous()
    with torch.no_grad():
        topo = bin_topology(act, w2c, proj, width, height, cfg, cap, cap_pad,
                            row_offset=mesh.index, row_stride=d,
                            with_reduce_plan=torch.is_grad_enabled())
    acc = forward_dispatch(binned_scene(
        gather_from_rows(rows64, topo, cfg, impl), topo), rays, cfg, impl)
    band = untile(acc, width, height // d, cfg.tile_size)
    return unband_image(_gather_ranks(band, mesh), width, height,
                        cfg.tile_size)
