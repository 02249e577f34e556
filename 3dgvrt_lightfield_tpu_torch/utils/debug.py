"""NaN/Inf guards for the render and training pipeline.

Counterpart of the JAX package's `utils/debug.py`, which wraps functions in
checkify's float checks.  Here:

  * `assert_finite(tree, name)`: a host-side check of concrete outputs (a
    tensor, a model, or dicts, tuples and lists of them);
  * `checked(fn)`: runs `fn` under a `TorchDispatchMode` that tests the
    output of every op and raises `FloatingPointError` naming the first op
    whose output holds a NaN, as checkify's float checks flag NaNs.
    Infinities pass, as there: the renderer uses them as sentinels (masked
    minima and maxima).  It reads every output back to the host, so it is a
    debugging tool and sits on no main path.  The CUDA kernels are not torch
    ops (they are launched through ctypes): a NaN a kernel writes shows up
    at the first op that consumes it.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


def _leaves_with_paths(tree, path=""):
    """(path, leaf) pairs in the JAX package's key notation: ['key'] for a
    dict entry, [i] for a sequence item, .name for a model parameter."""
    if isinstance(tree, torch.nn.Module):
        for name, p in tree.named_parameters():
            yield from _leaves_with_paths(p, f"{path}.{name}")
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_paths(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_paths(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def assert_finite(tree, name: str = "tree") -> None:
    """Host-side check (call on concrete outputs): every floating leaf is
    finite, else FloatingPointError "name[path]: bad/size non-finite
    values"."""
    for path, leaf in _leaves_with_paths(tree):
        arr = (leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
               else np.asarray(leaf))
        if arr.dtype.kind == "f" and not np.isfinite(arr).all():
            bad = int((~np.isfinite(arr)).sum())
            raise FloatingPointError(f"{name}{path}: {bad}/{arr.size} "
                                     f"non-finite values")


#: ops whose output is uninitialised memory, not a computed value
_ALLOCATORS = ("empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided")


class _NaNOutputs(TorchDispatchMode):
    """Raise at the first op with a NaN in a floating output."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ in _ALLOCATORS:
            return out
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and t.is_floating_point() and \
                    bool(torch.isnan(t).any()):
                bad = int(torch.isnan(t).sum())
                raise FloatingPointError(
                    f"{func}: {bad}/{t.numel()} NaN values in its output")
        return out


def checked(fn: Callable) -> Callable:
    """Wrap `fn` so that it raises FloatingPointError at the first op
    inside it whose output holds a NaN, naming that op.  For
    debugging only: every op's output is read back to the host.

        safe_render = checked(lambda m: renderer.render(m, cam)["rgb"])
        img = safe_render(model)
    """
    def wrapper(*args, **kwargs):
        with _NaNOutputs():
            return fn(*args, **kwargs)

    return wrapper
