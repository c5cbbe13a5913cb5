"""The neighbour KL of the step's preprocessing (``ndtpu.ndt.kl``), the
card's ms a train step."""
from portbench.spans import program_ms


def read(run):
    return program_ms(("ndtpu.ndt.kl",), "ndtpu.step")
