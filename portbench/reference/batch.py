"""One batch step of the fine-tune, written out: the mean over the batch's
views of each view's L1 loss, its gradient by autograd, and one Adam step.

Each view is binned from the parameters as they stand (no gradient), then
composited and differentiated by `composite.loss_and_grads`, in blocks of
tiles, so that a 5M-Gaussian 1080p view fits on one card beside the
others' summed gradient.  The batch's gradient is the mean of the views'.

Departures from the program, none of which changes the function:

  * the order of the sums: the program accumulates loss_i / B into the
    leaves view after view on each rank, then sums the ranks' buckets in
    the collective's order and divides by the number of ranks; here the
    views' gradients are summed in batch order and divided by B;
  * the loss: each view's is summed in float64 here (the program's is a
    float32 mean), and the batch's is their mean;
  * the views are taken one after the other, where the program's ranks
    take theirs side by side.
"""

from __future__ import annotations

import torch

from .binning import bin_frame
from .camera import matrices, tile_rays
from .composite import loss_and_grads
from .math import Settings, activate


def view_loss_and_grads(leaves, view, target_tiles: torch.Tensor,
                        st: Settings, dtype=torch.float32):
    """One view's (loss, gradients of the six leaves, mean hits per ray):
    binned from `leaves` as they stand, targets (tiles, 3, R)."""
    w2c, proj = matrices(view, st)
    with torch.no_grad():
        binned = bin_frame(activate(*leaves), w2c, proj, view.width,
                           view.height, st)
    rays = tile_rays(view, st, leaves[0].device)
    return loss_and_grads(leaves, binned, rays,
                          target_tiles.to(leaves[0].device), st, dtype)


def batch_loss_and_grads(leaves, views, targets, st: Settings,
                         dtype=torch.float32):
    """The batch's mean loss, mean gradients and mean hits per ray; `views`
    and `targets` (each (tiles, 3, R)) in batch order, the composite in
    `dtype` as `composite.loss_and_grads` takes it."""
    total, hits, grads = 0.0, 0.0, None
    for view, target in zip(views, targets):
        loss, g, h = view_loss_and_grads(leaves, view, target, st, dtype)
        total, hits = total + loss, hits + h
        grads = g if grads is None else [a.add_(b) for a, b in zip(grads, g)]
        del g
    b = len(views)
    return total / b, [g.div_(b) for g in grads], hits / b


def batch_step(params, opt, views, targets, st: Settings,
               dtype=torch.float32):
    """One step of `opt` (`adam.Adam` over `params`) on the batch's mean
    loss; returns (loss, gradients, mean hits per ray)."""
    loss, grads, hits = batch_loss_and_grads(params, views, targets, st,
                                             dtype)
    opt.step(grads)
    return loss, grads, hits
