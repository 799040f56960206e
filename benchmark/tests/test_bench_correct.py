"""The comparison that decides ``correct``, driven through the rest of a
run on the CPU at a small size (the harness's look for a card skipped),
against the committed limits: the program passes; the control in its
place, and each fault planted in the timed path (``benchmark/faults.py``),
come out not correct.

The size is ``tests/small.py``'s. The card's readings, at the cells' own
sizes, from which the limits were set, are in PERF.md."""

import time

import pytest
import torch

from benchmark import calibrate, faults, harness
from benchmark.tests import small

WORKLOADS = ("int8_batch64", "bf16_batch64")
SEEDS = (1, 2)


@pytest.fixture(autouse=True)
def few_threads():
    keep = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(keep)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small.copy(tmp_path_factory.mktemp("bench"))


def run(root, workload, system=None, seed=SEEDS[0]):
    return harness.run_cell(harness.find_cell(workload, root), seed, 0.05, False, "cpu", time.perf_counter(),
                            system=system, root=root)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", WORKLOADS)
def test_program_correct_control_not(root, workload, seed):
    assert run(root, workload, seed=seed)["correct"]
    assert not run(root, workload, calibrate.control, seed=seed)["correct"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("workload", WORKLOADS)
def test_faults(root, workload, fault):
    with faults.planted(fault):
        assert not run(root, workload)["correct"]


def test_lost_output(root):
    """An output that never comes, or comes misshapen, is not correct."""
    from benchmark import serving

    class Short:
        def __init__(self, pred):
            self.pred = pred

        def predict_dual_frames(self, frames, base, size):
            return self.pred.predict_dual_frames(frames, base, size)[:-1]

    result = run(root, "int8_batch64", lambda *a: Short(serving.serving_system(*a)))
    assert not result["correct"]
    assert result["compared"]["worst_frame_rmse_mm"]["value"] == float("inf")
