"""The mesh pass per combined frame (ms, device): the kernels, copies and
fills launched inside the `gvrt.mesh` ranges (the closest hits, the
shadow rays, the surface attributes and the shading), over the frames of
the traced stretch (`program_record.launched_ms_per_unit`).  None where
the program's record has no `gvrt.mesh` span."""

from portbench import program_record as pr


def read(run):
    rec = pr.record()
    if rec is None or "gvrt.mesh" not in rec["spans"]:
        return None
    return pr.launched_ms_per_unit(run.window.device, "gvrt.frame",
                                   ["gvrt.mesh"])
