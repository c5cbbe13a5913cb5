"""On the card (marked ``cuda``; skipped without one, decided inside the
test): at the published widths and a cut batch, the program's run is
correct and the control, the reference in the program's place with TF32
matmuls, is not.

    python -m pytest --noconftest portbench/tests/test_portbench_cuda.py -q
"""
from __future__ import annotations

import pytest
import torch

from portbench import calibrate, spec

SEED = 2**31 + 99
CUT = {"ndtnet-seg.train-graph": {"batch": 4, "split": 16},
       "ndtnet-seg.train-streaming": {"batch": 4, "split": 16},
       "ndtnetpp-seg.train": {"batch": 2, "split": 8},
       "ndtnet-seg.serve": {"clouds_per_request": 8, "pool": 2, "sample": 2,
                            "sample_from": 4}}


def card_cell(name):
    cell = spec.Cell(name)
    cell.traffic = {**cell.traffic, **CUT[name]}
    return cell


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CUT))
def test_program_correct_and_control_not(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cell, dev = card_cell(name), torch.device("cuda", 0)
    program = calibrate.reading(cell, SEED, 1.0, dev)
    control = calibrate.reading(cell, SEED, 1.0, dev, control=True)
    assert program["correct"], program
    assert not control["correct"], control
