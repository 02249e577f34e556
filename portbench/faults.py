"""Faults planted in the program's timed path, to show that the comparison
catches them (tests on the CPU, `control.py --fault` on the card).

  * "state_unchanged": the optimizer step returns without updating;
  * "half_batch": the training loss is the mean over the image's top half
    only (half of the batch's rows left out);
  * "answer_altered": the backward's chunk cotangents (K2's output, or its
    plain version's) scaled by 0.9 in training, or a frame's radiance by
    1.001 in serving, where they are produced;
  * "half_frame": the lower half of a frame's tiles left as background.

There is no exchange between cards in a one-card cell.  `plant` returns a
function that takes the fault out again.
"""

from __future__ import annotations

import functools

import torch

TRAIN = ("state_unchanged", "half_batch", "answer_altered")
SERVE = ("answer_altered", "half_frame")


def _patch(undo, owner, name, new):
    undo.append((owner, name, owner.__dict__[name]))
    setattr(owner, name, new)


def plant(gt, name: str, kind: str):
    """Plant fault `name` for a cell whose traffic entry is `kind`
    ("train" or "serve"); returns the undo function."""
    undo = []
    pf, pv = gt.render.pallas_forward, gt.render.pallas_vjp
    tr = gt.train.trainer
    if kind == "train" and name == "state_unchanged":
        _patch(undo, tr.GroupAdam, "step", lambda self, closure=None: None)
    elif kind == "train" and name == "half_batch":
        real_loss = tr._image_loss

        def loss(rgb, target, tc):
            h = rgb.shape[-3] // 2
            return real_loss(rgb[..., :h, :, :], target[..., :h, :, :], tc)
        _patch(undo, tr, "_image_loss", loss)
    elif kind == "train" and name == "answer_altered":
        for fn in ("tile_backward", "_backward_plain"):
            real = getattr(pv, fn)

            @functools.wraps(real)   # keeps the launch counter
            def scaled(*args, _real=real):
                bar_chunks, bar_rays = _real(*args)
                return bar_chunks * 0.9, bar_rays
            _patch(undo, pv, fn, scaled)
    elif kind == "serve" and name in SERVE:
        for fn in ("forward_tiles", "forward_tiles_reference"):
            real = getattr(pf, fn)

            @functools.wraps(real)
            def broken(binned, rays, cfg, _real=real):
                acc = _real(binned, rays, cfg)
                if name == "answer_altered":
                    acc[:, 0:3] *= 1.001
                else:
                    acc[acc.shape[0] // 2:] = torch.tensor(
                        pf.BACKGROUND, device=acc.device)[:, None]
                return acc
            _patch(undo, pf, fn, broken)
    else:
        raise ValueError(f"no fault {name!r} for a {kind} cell")

    def take_out():
        for owner, attr, orig in reversed(undo):
            setattr(owner, attr, orig)
    return take_out
