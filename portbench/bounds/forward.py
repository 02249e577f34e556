"""The forward tile kernel's least time on a sampled view (ms): the gate
chain on every live pair and the composite of every hit, against the
touched Gaussians' parameter rows read once, the rays read and the
accumulators written (`counts.frame_bounds`)."""

from portbench import counts


def bound_ms(work):
    return counts.frame_bounds(work.counts, work.touched, work.rays)[0]
