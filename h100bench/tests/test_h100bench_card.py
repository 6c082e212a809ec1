"""On the card, at each cell's own size: the control comes out not
correct under the cell's limits. Marked ``cuda``: it skips where PyTorch
sees no CUDA device. Run it on the card with

    python -m pytest h100bench/tests -m cuda
"""

import time

import pytest
import torch

from h100bench import control, harness

pytestmark = pytest.mark.cuda
MAN = harness.manifest()


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name", [w["name"] for w in MAN["workloads"]])
def test_control_fails_at_the_cell_size(card, name):
    r = control.readings(name, "control", 20261018, 3.0, card,
                         time.perf_counter())
    lim = harness.limits(name)
    assert any(r[k] > lim[k] for k in r if k in lim), r
    torch.cuda.empty_cache()
