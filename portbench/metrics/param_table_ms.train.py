"""The parameter table both ways per training step (ms, device): the
kernels launched inside the `gvrt.param_table` ranges (`activate_leaves`,
`param_rows`, `rows64_from_model`) and the `gvrt.param_table.bwd` ranges
(`rows64_from_model`'s hand-derived backward, or autograd's from the rows
to the leaves), over the steps of the traced stretch
(`program_record.launched_ms_per_unit`)."""

from portbench import program_record as pr


def read(run):
    return pr.launched_ms_per_unit(run.window.device, "gvrt.step",
                                   ["gvrt.param_table",
                                    "gvrt.param_table.bwd"])
