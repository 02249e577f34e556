"""NumPy's share of the camera rays per frame (ms, host clock): the
`gvrt.rays.numpy` span (`Camera.rays` inside `tile_rays`) over the frames
of the traced stretch."""

from portbench import program_record as pr


def read(run):
    return pr.host_ms_per_unit("gvrt.frame", "gvrt.rays.numpy")
