"""The posed rays both ways per pose step (ms, device): the kernels,
copies and fills launched inside the `gvrt.pose.rays` ranges (the two
3x3 products, the normalisation, the clip and SH-basis rows of the
moved camera) and the `gvrt.pose.rays.bwd` ranges (their backward to
the two deltas), over the steps of the traced stretch
(`program_record.launched_ms_per_unit`).  None where the program's
record has no `gvrt.pose.rays` span."""

from portbench import program_record as pr


def read(run):
    rec = pr.record()
    if rec is None or "gvrt.pose.rays" not in rec["spans"]:
        return None
    return pr.launched_ms_per_unit(run.window.device, "gvrt.step",
                                   ["gvrt.pose.rays", "gvrt.pose.rays.bwd"])
