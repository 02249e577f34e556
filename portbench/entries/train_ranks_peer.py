"""One peer rank (1 and up) of the `train_ranks` entry, started by rank 0's
session with the run's spec as one JSON argument (configuration, traffic
mix, seed, rank, world size, devices, rendezvous and store port):

    python3 portbench/entries/train_ranks_peer.py '<spec>'

It prints nothing on standard output (rank 0's result line is there) and
exits 0 once rank 0 has released it, or with status 5 once rank 0 has
gone (`train_ranks.peer`).
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(spec: str) -> int:
    sys.path.insert(0, ROOT)
    import gvrt_tpu_torch as gt
    from portbench import harness
    return harness.load_entry("train_ranks").peer(gt, json.loads(spec))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
