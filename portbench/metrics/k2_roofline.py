"""K2's share of its roofline over the sampled steps (%): the least
time of the backward's counted work over K2's device time."""


def read(run):
    return run.roofline("k2")
