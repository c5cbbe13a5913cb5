"""Timing shared by the port's measurement scripts.

On the card each run of the timed function lies between two CUDA events
(so a run's time includes any wait of the card for the host, as a
stage's own host syncs); on the CPU the host's clock times each run.
A measurement is ``calls`` loops of ``runs`` runs after one warm-up run,
the card synchronised between loops; it reports the median of all runs
and the spread of the loops' medians. A number taken on the CPU is the
CPU's, never the card's: every line names its device.
"""
from __future__ import annotations

import statistics
import time

import torch


def device_name(device: torch.device) -> str:
    """The card's name, or "cpu"."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def measure(fn, device: torch.device, runs: int = 20, calls: int = 3):
    """Time ``fn()``: one warm-up run, then ``calls`` loops of ``runs``
    runs. Returns {"ms": the median run, "call_ms": [each loop's median],
    "runs": runs * calls}."""
    if runs < 1 or calls < 1:
        raise ValueError(f"runs and calls must be >= 1: {runs}, {calls}")
    cuda = device.type == "cuda"
    fn()
    if cuda:
        torch.cuda.synchronize(device)
    per_call = []
    for _ in range(calls):
        times = []
        if cuda:
            events = [(torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
                      for _ in range(runs)]
            for start, end in events:
                start.record()
                fn()
                end.record()
            torch.cuda.synchronize(device)
            times = [start.elapsed_time(end) for start, end in events]
        else:
            for _ in range(runs):
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
        per_call.append(times)
    flat = [t for ts in per_call for t in ts]
    return {"ms": statistics.median(flat),
            "call_ms": [statistics.median(ts) for ts in per_call],
            "runs": len(flat)}


def add_timing_flags(parser, inner: int = 20, iters: int = 3):
    """The JAX scripts' --inner (timed runs a call) and --iters (calls),
    and --device."""
    parser.add_argument("--inner", type=int, default=inner,
                        help="timed runs in each call (default %(default)s)")
    parser.add_argument("--iters", type=int, default=iters,
                        help="calls, each of --inner runs (default %(default)s)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
