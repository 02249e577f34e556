"""K1's share of its roofline on the serving frames of the sample (%):
the least time of the frames' counted work over K1's device time."""


def read(run):
    return run.roofline("k1")
