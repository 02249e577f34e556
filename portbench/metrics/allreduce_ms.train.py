"""The gradient all-reduce per training step (ms, device): the kernels,
copies and fills launched inside the `gvrt.allreduce` ranges (the
bucket's packing, the collective, its division and the copy back), over
the steps of the traced stretch (`program_record.launched_ms_per_unit`).
The collective's time includes its wait for the slowest rank.  None
where the program's record has no `gvrt.allreduce` span."""

from portbench import program_record as pr


def read(run):
    rec = pr.record()
    if rec is None or "gvrt.allreduce" not in rec["spans"]:
        return None
    return pr.launched_ms_per_unit(run.window.device, "gvrt.step",
                                   ["gvrt.allreduce"])
