"""The classification head (``ndtpu.head``: the max-pool over the rows
and the three head layers, inside ``ndtpu.forward``), the card's ms a
train step."""
from portbench.spans import program_ms


def read(run):
    return program_ms(("ndtpu.head",), "ndtpu.step")
