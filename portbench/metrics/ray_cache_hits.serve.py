"""The share of `TiledRenderer`'s ray lookups that its cache served (%):
`gvrt.rays.cache_hit` over `cache_hit` + `gvrt.rays.built` in the
traced stretch."""

from portbench import program_record as pr


def read(run):
    rec = pr.record()
    if rec is None:
        return None
    hit = rec["counts"].get("gvrt.rays.cache_hit", 0)
    built = rec["counts"].get("gvrt.rays.built", 0)
    return 100.0 * hit / (hit + built) if hit + built else None
