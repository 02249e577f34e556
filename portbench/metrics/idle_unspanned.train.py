"""The share of the device's idle time over the traced stretch during
which no `gvrt.` range inside a step is open (%): idle time that no
layer of the program owns (`program_record.idle_unspanned`)."""

from portbench import program_record as pr


def read(run):
    return pr.idle_unspanned(run.window.device)
