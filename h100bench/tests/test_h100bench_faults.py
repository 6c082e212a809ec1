"""Each fault a cell can have, planted under the timed path of a tiny run
on the CPU, makes the run's ``correct`` false; the sound run is correct.
The control's readings stand well above the sound program's."""

import pytest
import torch

from h100bench import control, harness
from h100bench.tests.conftest import TINY_SEED

CPU = torch.device("cpu")


def _run(tiny, name, what=None, overrides=None):
    bench, man = tiny
    kind = harness.traffic(harness.workload(man, name)["traffic"], bench)["kind"]
    faults = control.fault_hooks(what, kind) if what else None
    return harness.run_cell(name, TINY_SEED, 0.0, False, CPU, 0.0, man,
                            faults=faults, overrides=overrides, bench=bench)


@pytest.mark.parametrize("name,what", [
    ("zh-generate-b4096", None), ("zh-generate-b4096", "token"),
    ("zh-generate-b4096", "half"), ("en-generate-b2048", "token"),
    ("zh-train-b256", None), ("zh-train-b256", "half"),
    ("zh-train-b256", "unchanged"),
])
def test_fault_fails_the_check(tiny, name, what):
    rec = _run(tiny, name, what)
    assert rec.correct == (what is None), rec.checks


def test_generate_control_reads_far_above_the_program(tiny):
    sound = _run(tiny, "zh-generate-b4096").checks["margin"]["value"]
    low = _run(tiny, "zh-generate-b4096", overrides=control.LOWER)
    assert low.checks["margin"]["value"] >= 3 * sound
    assert not low.correct


def test_train_control_reads_far_above_the_program(tiny):
    bench, man = tiny
    sound = _run(tiny, "zh-train-b256").checks
    low = control.readings("zh-train-b256", "control", TINY_SEED, 0.0, CPU, 0.0,
                           man, bench)
    assert all(low[k] >= 3 * sound[k]["value"] for k in ("loss", "grad"))
