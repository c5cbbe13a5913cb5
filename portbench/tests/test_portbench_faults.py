"""A run at a small size on the CPU, the harness's look for a card
skipped: correct as the program stands, and not correct with each fault
the cell can have planted underneath the timed path."""
from __future__ import annotations

import pytest
import torch

from portbench import faults, run
from portbench.tests.conftest import small_cell

CASES = ([("ndtnet-seg.train-graph", f) for f in (None,) + faults.TRAIN_FAULTS]
         + [("ndtnetpp-seg.train", f) for f in (None,) + faults.TRAIN_FAULTS]
         + [("ndtnet-seg.serve", f) for f in (None,) + faults.SERVE_FAULTS]
         + [("ndtnet-seg.train-streaming", f)
            for f in (None,) + faults.TRAIN_FAULTS + faults.STREAMING_FAULTS])


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_makes_the_run_not_correct(name, fault):
    cell = small_cell(name)
    kind = cell.driver.kind
    cpu = torch.device("cpu")
    if fault is None:
        result, rows = run.run_cell(cell, 2**31 + 17, 0.3, 0, cpu)
        assert result["correct"], rows
    else:
        with faults.plant(fault, kind):
            result, rows = run.run_cell(cell, 2**31 + 17, 0.3, 0, cpu)
        assert not result["correct"], rows
    assert set(result) == {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert list(result)[-1] == "checks"
