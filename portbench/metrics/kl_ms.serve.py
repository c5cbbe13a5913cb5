"""The neighbour KL of the request's preprocessing (``ndtpu.ndt.kl``),
the card's ms a request."""
from portbench.spans import program_ms


def read(run):
    return program_ms(("ndtpu.ndt.kl",), "ndtpu.request")
