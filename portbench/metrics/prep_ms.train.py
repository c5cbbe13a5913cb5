"""The step's NDT preprocessing (``ndtpu.prep``, both resolutions in
NDT-Net++), the card's ms a train step."""
from portbench.spans import program_ms


def read(run):
    return program_ms(("ndtpu.prep",), "ndtpu.step")
