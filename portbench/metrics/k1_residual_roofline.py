"""K1's residual variant's share of its roofline over the sampled steps
(%): the least time of one forward's counted work per step over all of
the variant's device time (a recompute counts as time, not as work)."""


def read(run):
    return run.roofline("k1_residual")
