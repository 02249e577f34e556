"""The benchmark's own tests: on the CPU at small sizes, and on the card
where marked `cuda`.  Run from the repository root:

    python -m pytest portbench/tests -q -p no:cacheprovider
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (a CUDA kernel has no CPU "
                   "mode); skips without one")
