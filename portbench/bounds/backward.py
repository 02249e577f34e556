"""The backward tile kernel's least time on a sampled view (ms): the gate
chain on every live pair and each hit's hand-derived VJP, against the
touched Gaussians' rows read and their gradients written, the rays and
the accumulators' cotangents read (`counts.frame_bounds`)."""

from portbench import counts


def bound_ms(work):
    return counts.frame_bounds(work.counts, work.touched, work.rays,
                               backward=True)[0]
