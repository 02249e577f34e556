"""Points where the host waits for the card per frame: the program's
`gvrt.host_syncs` counter over the frames of the traced stretch."""

from portbench import program_record as pr


def read(run):
    return pr.count_per_unit("gvrt.frame", "gvrt.host_syncs")
