"""Profiling hooks (port of ``ndtpu/utils/profiling.py``) and the
program's spans.

The reference's only instrumentation is wall-clock deltas around
downsample and prune (its tools/viz.py:100-107, 119-129). These are the
card's counterparts of the JAX helpers: a ``torch.profiler`` trace, and a
timer that waits for the card before it stops the clock.

``span(name)`` marks a stage of the program where it happens (the
request, the train step, the preprocessing and its search, moments, KL
and emit, the forward, the backward, the optimizer, the epoch, the next
batch's load). It has three forms:

- off (no ``torch.profiler`` session, no graph being captured on this
  thread): a shared null context after two flag checks; nothing in torch
  is called;
- under a profiler: ``torch.profiler.record_function(name)``, so the span
  is a host event in the same trace as the card's activity, on its
  clock, plus a timing ``torch.cuda.Event`` pair on the current stream;
- while ``capturing()`` (``train/loop.py::EpochScan`` captures its step):
  an external timing event pair, two event-record nodes of the graph, so
  every replay times its stages with no host code.

``spans()`` reads the records (one synchronisation), ``reset()`` clears
them. ``profile_trace`` writes the Chrome trace, spans included.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time

import torch

ROOTS = ("ndtpu.request", "ndtpu.step")  # the spans that own the ones inside
_NULL = contextlib.nullcontext()
_profiler = torch.autograd.profiler  # its _is_profiler_enabled, read per call


class _Thread(threading.local):
    graph = None  # the records of the graph this thread captures, or None
    stack = ()  # the spans open on this thread, innermost last


_tls = _Thread()
_records = []  # eager spans recorded since reset()
_graphs = []  # the records of each graph replayed since reset()
_ids = itertools.count()


class Span:
    """One span's record: its ``name`` and ``id``, the id of its
    ``parent`` (None at the top), the id of its ``root`` (the innermost
    ``ndtpu.request`` or ``ndtpu.step`` around it, itself included; None
    outside any), its start and end events, and, filled by ``spans()``,
    ``ms``: the card's milliseconds between them (None without a card)."""

    __slots__ = ("name", "id", "parent", "root", "start", "end", "ms")

    def __init__(self, name, parent):
        self.name, self.id = name, next(_ids)
        self.parent = None if parent is None else parent.id
        self.root = (self.id if name in ROOTS else
                     None if parent is None else parent.root)
        self.start = self.end = self.ms = None


def _event(external):
    """A timing event recorded on the current stream; None where the card
    has not been used."""
    if not torch.cuda.is_initialized():
        return None
    e = torch.cuda.Event(enable_timing=True, external=external)
    e.record()
    return e


@contextlib.contextmanager
def _recorded(name, records, external):
    rec = Span(name, _tls.stack[-1] if _tls.stack else None)
    records.append(rec)
    _tls.stack += (rec,)
    try:
        rec.start = _event(external)
        yield
        rec.end = _event(external)
    finally:
        _tls.stack = _tls.stack[:-1]


@contextlib.contextmanager
def _eager(name):
    with torch.profiler.record_function(name):
        with _recorded(name, _records, False):
            yield


def span(name: str):
    """A context that marks a stage of the program: off, a null context;
    under a profiler, a host event in its trace and a timed event pair;
    while ``capturing()``, two event-record nodes of the graph."""
    if _tls.graph is None:
        if not _profiler._is_profiler_enabled:
            return _NULL
        return _eager(name)
    return _recorded(name, _tls.graph, True)


@contextlib.contextmanager
def capturing():
    """Around a CUDA graph's capture on this thread: each span inside
    records an external event pair, nodes of the graph, and its record
    lands in the list this yields, which the graph keeps; after a replay,
    ``replayed(list)`` lets ``spans()`` read it."""
    saved = _tls.graph, _tls.stack
    _tls.graph, _tls.stack = [], ()
    try:
        yield _tls.graph
    finally:
        _tls.graph, _tls.stack = saved


def replayed(records):
    """Mark a captured graph's span records (``capturing()``'s list) as
    replayed, so ``spans()`` returns them."""
    if not any(g is records for g in _graphs):
        _graphs.append(records)


def spans():
    """The spans since ``reset()``: those recorded under a profiler, then
    those of each graph replayed since, as its last replay timed them.
    Synchronises once, then fills each record's ``ms``."""
    recs = _records + [r for g in _graphs for r in g]
    if any(r.start is not None for r in recs):
        torch.cuda.synchronize()
    for r in recs:
        r.ms = (None if r.start is None or r.end is None
                else r.start.elapsed_time(r.end))
    return recs


def reset():
    """Forget the spans recorded and the graphs replayed so far."""
    _records.clear()
    _graphs.clear()


@contextlib.contextmanager
def profile_trace(log_dir: str = "build/ndtpu_torch_trace"):
    """Profile the block's CPU activity, and the card's where there is one,
    with ``torch.profiler``; on exit write the trace as Chrome trace JSON
    (``trace.json``, for chrome://tracing or Perfetto) into ``log_dir``;
    the program's spans are host events in it. Yields the profiler."""
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
