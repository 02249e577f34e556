"""The mesh trace per combined frame (ms, device): the kernels, copies
and fills launched inside the `gvrt.mesh.trace` ranges (`closest_hit`,
the primary rays) and the `gvrt.mesh.shadow` ranges (`occluded`, the
shadow rays), over the frames of the traced stretch
(`program_record.launched_ms_per_unit`).  None where the program's record
has no `gvrt.mesh.trace` span."""

from portbench import program_record as pr


def read(run):
    rec = pr.record()
    if rec is None or "gvrt.mesh.trace" not in rec["spans"]:
        return None
    return pr.launched_ms_per_unit(run.window.device, "gvrt.frame",
                                   ["gvrt.mesh.trace", "gvrt.mesh.shadow"])
