"""The gather of the parameter rows into chunks per frame (ms, device):
the kernels launched inside the `gvrt.gather` ranges, over the frames of
the traced stretch (`program_record.launched_ms_per_unit`)."""

from portbench import program_record as pr


def read(run):
    return pr.launched_ms_per_unit(run.window.device, "gvrt.frame",
                                   ["gvrt.gather"])
