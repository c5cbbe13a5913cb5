"""The step's Adam update (``ndtpu.optimizer``), the card's ms a
train step."""
from portbench.spans import program_ms


def read(run):
    return program_ms(("ndtpu.optimizer",), "ndtpu.step")
