"""NumPy's camera rays per training step (ms, host clock): the
`gvrt.rays.numpy` span over the steps of the traced stretch; 0 where
the stretch makes no rays (camera batches made at set-up)."""

from portbench import program_record as pr


def read(run):
    return pr.host_ms_per_unit("gvrt.step", "gvrt.rays.numpy")
