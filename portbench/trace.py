"""The device trace of a short traced block: ``torch.profiler`` (CUPTI)
over the block, reduced to what the per-layer metrics and the result's
``breakdown`` read: the traced window's length, the union of device
activity in it (kernels, copies and sets; user annotations left out),
the device time by operation name, the longest idle gaps named by what
the host was doing when each began, and one kernel's launches and time.
"""
from __future__ import annotations

import numpy as np
import torch

WINDOW = "portbench.window"


def _events(prof):
    """(name, is_device, start_ns, end_ns) of every event of the
    profiler's Kineto results."""
    results = prof.profiler.kineto_results
    if results is None:
        raise RuntimeError("the profiler returned no Kineto results")
    out = []
    for e in results.events():
        if e.is_user_annotation() and e.device_type() != torch.autograd.DeviceType.CPU:
            continue
        dev = e.device_type() == torch.autograd.DeviceType.CUDA
        out.append((e.name(), dev, e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def _clean(name: str) -> str:
    return "".join(c if c.isalnum() or c in "_.-" else "_" for c in name)[:64]


class Trace:
    """The reduced trace of one traced block."""

    def __init__(self, events):
        win = [(s, e) for n, d, s, e in events if not d and n == WINDOW]
        self.start, self.end = (win[0] if win else
                                (min(e[2] for e in events), max(e[3] for e in events)))
        self.window_s = (self.end - self.start) / 1e9
        dev = [(n, max(s, self.start), min(e, self.end)) for n, d, s, e in events
               if d and e > self.start and s < self.end]
        self.device = dev
        self.host = [(n, s, e) for n, d, s, e in events if not d and n != WINDOW]
        spans = sorted((s, e) for _, s, e in dev)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.busy_s = sum(e - s for s, e in merged) / 1e9
        edges = [self.start] + [x for m in merged for x in m] + [self.end]
        self.gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                     if edges[i + 1] > edges[i]]

    def device_ops(self, top=10):
        by = {}
        for n, s, e in self.device:
            k = _clean(n)
            by[k] = by.get(k, 0) + (e - s)
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda x: -x[1])[:top]]

    def idle_gaps(self, top=10):
        """The longest idle gaps, each named by the shortest host event
        that covers its start."""
        if not self.host:
            return []
        hs = np.array([h[1] for h in self.host])
        he = np.array([h[2] for h in self.host])
        out = []
        for s, e in sorted(self.gaps, key=lambda g: g[0] - g[1])[:top]:
            cover = np.nonzero((hs <= s) & (he >= s))[0]
            name = (_clean(self.host[cover[np.argmin(he[cover] - hs[cover])]][0])
                    if len(cover) else "none")
            out.append([name, (e - s) / 1e9])
        return out

    def kernel(self, part: str):
        """(launches, mean seconds) of device operations whose name holds
        ``part``; (0, None) if none ran."""
        d = [(e - s) for n, s, e in self.device if part in n]
        return (len(d), sum(d) / len(d) / 1e9) if d else (0, None)


def traced(block):
    """Run ``block()`` under the profiler, the card synchronised before
    and after; returns its Trace."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            block()
            torch.cuda.synchronize()
    return Trace(_events(prof))
