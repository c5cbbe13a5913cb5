"""The program's spans (``ndtpu_torch/utils/profiling.py::span``) as the
per-layer metrics read them, each a time per train step or request:

- ``program_ms``: the card's time inside spans of given names, from the
  program's own records (``spans()``): their total over the traced block
  over the number of root spans (``ndtpu.step`` or ``ndtpu.request``).
  In a graph cell the records are the captured step's, as the traced
  epoch's last replay timed them: one root.
- ``idle_ms``: the card's idle time while the host is inside a span,
  from the device trace: the host events of that name against the
  trace's idle gaps, over the number of root host events.

Both return None where there is nothing to read, as in a program that
has no spans.
"""
from __future__ import annotations

import numpy as np


def program_ms(names, root):
    from ndtpu_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    recs = spans()
    roots = sum(r.name == root for r in recs)
    ms = [r.ms for r in recs if r.name in names]
    if not roots or not ms or None in ms:
        return None
    return sum(ms) / roots


def idle_ms(trace, name, root):
    if trace is None or not trace.gaps:
        return None
    inside = [(s, e) for n, s, e in trace.host if n == name]
    roots = sum(n == root for n, _, _ in trace.host)
    if not inside or not roots:
        return None
    gs, ge = (np.array(x, dtype=np.int64) for x in zip(*trace.gaps))
    idle = sum(int(np.clip(np.minimum(ge, e) - np.maximum(gs, s), 0, None).sum())
               for s, e in inside)
    return idle / 1e6 / roots
