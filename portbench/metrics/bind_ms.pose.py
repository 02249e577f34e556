"""The pose bind per pose step (ms, host clock): the `gvrt.bind` span
(`bind_pose`: the NDC targets and the target's tiles on the host, the
plan and the binning at the perturbed base pose) over the steps of the
traced stretch, so a camera's set-up spread over its steps.  None
without a device trace (the record fills only while the profiler
records) or where the record has no `gvrt.pose.rays` span (a program
without the pose step's spans)."""

from portbench import program_record as pr


def read(run):
    rec = pr.record()
    if run.window.device is None or rec is None \
            or "gvrt.pose.rays" not in rec["spans"]:
        return None
    return pr.host_ms_per_unit("gvrt.step", "gvrt.bind")
