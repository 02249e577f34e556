"""Points where the host waits for the card per training step: the
program's `gvrt.host_syncs` counter over the steps of the traced
stretch."""

from portbench import program_record as pr


def read(run):
    return pr.count_per_unit("gvrt.step", "gvrt.host_syncs")
