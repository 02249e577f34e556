"""The gradient all-reduce's share of its roofline (%): the least time of
one step's bucket against the least NCCL all-reduce kernel of the traced
stretch.

The least time is the larger of two bounds on one rank: the link, (n - 1)
/ n of the bucket's bytes (`gvrt.allreduce.bytes` a step) over one
direction of the H100 SXM's NVLink, 450 GB/s, which every rank must at
least receive whatever the algorithm (NVLink SHARP included); and HBM,
the bucket read once and written once at 3.35 TB/s.  n is `gvrt.ranks` a
step.  None where the record lacks the counters or the trace has no
all-reduce kernel (one rank, the CPU, a program without the counters).
On slower links the share only reads lower."""

from portbench import program_record as pr
from portbench.counts import PEAK_BYTES_PER_S

#: one direction of an H100 SXM's NVLink (18 links x 25 GB/s)
LINK_BYTES_PER_S = 450e9
KERNEL = "AllReduce"


def bound_ms(nbytes: float, ranks: float) -> float:
    link = (ranks - 1.0) / ranks * nbytes / LINK_BYTES_PER_S
    hbm = 2.0 * nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(link, hbm)


def read(run):
    nbytes = pr.count_per_unit("gvrt.step", "gvrt.allreduce.bytes")
    ranks = pr.count_per_unit("gvrt.step", "gvrt.ranks")
    dt = run.window.device
    if not nbytes or not ranks or ranks < 2 or dt is None:
        return None
    times = [d for _, d, n in dt.kernels if n.startswith("nccl")
             and KERNEL in n]
    if not times:
        return None
    return 100.0 * bound_ms(nbytes, ranks) / (min(times) / 1e3)
