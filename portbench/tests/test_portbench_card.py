"""On the card, at the cells' own sizes: the program's numbers within
their limits and the bfloat16 control's outside them, one seed each.
Run there from the repository root (tests/conftest.py imports JAX, which
the card's machine lacks, so pass only this directory):

    python -m pytest portbench/tests/test_portbench_card.py -q \
        -p no:cacheprovider
"""

import pytest
import torch

from portbench_small import failing

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the port's kernels are CUDA")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("workload", ("synth300k.serve_orbit",
                                      "synth300k.train_views"))
def test_control_fails_at_full_size(card, workload):
    import gvrt_tpu_torch as gt
    from portbench import harness
    cell = harness.load_cell(workload)
    _, _, readings = harness.measure(gt, cell, 3300000001, 1.0, False, card,
                                     control=True)
    assert failing(cell, readings["prog"]) == []
    assert failing(cell, readings["ctrl"]) != []
