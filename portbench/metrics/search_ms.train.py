"""The voxel-size search of the step's preprocessing (``ndtpu.ndt.search``:
the cloud limits, the probe, the rounds and their sorts), the card's ms a
train step."""
from portbench.spans import program_ms


def read(run):
    return program_ms(("ndtpu.ndt.search",), "ndtpu.step")
