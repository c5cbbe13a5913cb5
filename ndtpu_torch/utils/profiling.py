"""Profiling hooks (port of ``ndtpu/utils/profiling.py``).

The reference's only instrumentation is wall-clock deltas around
downsample and prune (its tools/viz.py:100-107, 119-129). These are the
card's counterparts of the JAX helpers: a ``torch.profiler`` trace, and a
timer that waits for the card before it stops the clock.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str = "build/ndtpu_torch_trace"):
    """Profile the block's CPU activity, and the card's where there is one,
    with ``torch.profiler``; on exit write the trace as Chrome trace JSON
    (``trace.json``, for chrome://tracing or Perfetto) into ``log_dir``.
    Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def wait(target):
    """Block until the card has computed ``target``, a tensor or a nest of
    tensors (lists, tuples, dicts): ``torch.cuda.synchronize`` on each
    card that holds one of them. A value on the CPU is ready already."""
    for dev in {t.device for t in _tensors(target) if t.is_cuda}:
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def timed(label: str = "", sync=None):
    """Wall-clock timer of the block. The card runs behind the host, so
    before the clock stops it waits for ``sync`` (``wait``): a tensor or a
    nest of tensors, or a callable of none resolved at exit (for values
    made inside the block). Yields a dict that holds ``seconds`` after the
    block, and prints the time and rate when ``label`` is given."""
    t0 = time.perf_counter()
    box = {}
    try:
        yield box
    finally:
        wait(sync() if callable(sync) else sync)
        box["seconds"] = time.perf_counter() - t0
        if label:
            print(f"[timed] {label}: {box['seconds']:.4f}s "
                  f"({1.0 / box['seconds']:.2f} Hz)")
