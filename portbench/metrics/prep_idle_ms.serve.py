"""The card's idle ms a request while the host is inside the
preprocessing (``ndtpu.prep``): its host events in the device trace
against the trace's idle gaps."""
from portbench.spans import idle_ms


def read(run):
    return idle_ms(run.trace, "ndtpu.prep", "ndtpu.request")
