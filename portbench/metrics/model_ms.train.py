"""The step's forward with its loss (``ndtpu.forward``) and backward
(``ndtpu.backward``), the card's ms a train step."""
from portbench.spans import program_ms


def read(run):
    return program_ms(("ndtpu.forward", "ndtpu.backward"), "ndtpu.step")
