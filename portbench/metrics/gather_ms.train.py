"""The gather and its backward (the K3 or K4 reduce) per training step
(ms, device): the kernels launched inside the `gvrt.gather` and
`gvrt.gather.bwd` ranges, recomputed gathers included, over the steps of
the traced stretch (`program_record.launched_ms_per_unit`)."""

from portbench import program_record as pr


def read(run):
    return pr.launched_ms_per_unit(run.window.device, "gvrt.step",
                                   ["gvrt.gather", "gvrt.gather.bwd"])
