"""Process-group set-up and the per-rank share of a camera batch.

Counterpart of the JAX package's `parallel/distributed.py` on
`torch.distributed`.  JAX drives every chip of a host from one controller
and joins hosts with `jax.distributed`; PyTorch's idiom is one process
(rank) per card, so here every card is a rank of one process group, on one
host or many:

    init_distributed()                  # no-op in a single process
    mesh = data_parallel_mesh()         # ("cam",) over every rank
    # Trainer(..., mesh=mesh) averages the gradients over the ranks

The group's backend is NCCL when the ranks run on cards, gloo on the CPU.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..config import resolve_device

#: how long the rendezvous and every collective wait for the other ranks
#: before they fail: a rank that dies then ends every rank with an error
#: instead of leaving them waiting
TIMEOUT = datetime.timedelta(minutes=5)


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value else None


def rank_device(device=None) -> torch.device:
    """This rank's device: `device` (as `resolve_device` reads it), else
    the card `cuda:LOCAL_RANK` (LOCAL_RANK from torchrun's environment,
    default 0).  Raises when that card is not visible."""
    if device is None:
        device = torch.device("cuda", _env_int("LOCAL_RANK") or 0)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index >= torch.cuda.device_count():
        raise ValueError(f"{dev} asked for, but {torch.cuda.device_count()} "
                         f"CUDA card(s) are visible")
    return dev


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: Optional[str] = None, device=None) -> bool:
    """Join the default process group when running multi-process; else
    no-op.

    An argument left None is read from torchrun's environment (WORLD_SIZE,
    RANK; MASTER_ADDR and MASTER_PORT give the "env://" rendezvous).
    Without a world size there is one process and nothing to join: returns
    False, as the JAX package's does without a coordinator.  The backend
    defaults to "nccl" when this rank's device (`rank_device(device)`) is a
    card and "gloo" on the CPU; under NCCL that card becomes the current
    one.  Every wait for the other ranks is bounded by `TIMEOUT`.  Returns
    True once the group is initialized."""
    if dist.is_initialized():
        return True
    world_size = world_size if world_size is not None else _env_int(
        "WORLD_SIZE")
    if world_size is None:
        return False
    rank = rank if rank is not None else _env_int("RANK")
    if rank is None:
        raise ValueError("init_distributed: a world size without a rank "
                         "(set RANK or pass rank=)")
    if init_method is None:
        if not os.environ.get("MASTER_ADDR"):
            raise ValueError("init_distributed: no init_method and no "
                             "MASTER_ADDR/MASTER_PORT in the environment")
        init_method = "env://"
    if backend is None:
        backend = "nccl" if rank_device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(rank_device(device))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, timeout=TIMEOUT)
    return True


def data_parallel_mesh(axis: str = "cam", devices=None):
    """1D mesh over every rank of the default group (camera/ray data
    parallel); `devices` as `sharding.make_mesh` takes it."""
    from .sharding import make_mesh
    return make_mesh(None, axis, devices)


def local_batch_slice(global_batch: int, axis_size: Optional[int] = None,
                      index: Optional[int] = None) -> slice:
    """The slice of a global camera batch owned by rank `index` of
    `axis_size` (defaults: this process's rank and the world size)."""
    initialized = dist.is_initialized()
    n = axis_size or (dist.get_world_size() if initialized else 1)
    i = index if index is not None else (dist.get_rank() if initialized
                                         else 0)
    per = global_batch // n
    if per * n != global_batch:
        raise ValueError(f"a batch of {global_batch} cameras does not split "
                         f"over {n} ranks")
    return slice(i * per, (i + 1) * per)
