"""The reduction of a profiler trace: the events of a CPU profile read
through the one path the harness has, and the window, busy time, gaps
and kernel statistics of a trace built by hand."""
from __future__ import annotations

import torch

from portbench import trace


def test_events_of_a_cpu_profile():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            torch.ones(64).sum()
    events = trace._events(prof)
    window = [e for e in events if e[0] == trace.WINDOW]
    assert len(window) == 1 and not window[0][1] and window[0][3] > window[0][2]
    assert any(e[0].startswith("aten::") for e in events)
    assert all(not dev for _, dev, _, _ in events)


def test_trace_by_hand():
    ms = 1_000_000
    events = [(trace.WINDOW, False, 0, 10 * ms), ("step", False, 0, 9 * ms),
              ("load", False, 6 * ms, 8 * ms),
              ("segment_moments_kernel<29>", True, 1 * ms, 3 * ms),
              ("gemm", True, 2 * ms, 4 * ms), ("segment_moments_kernel<29>", True, 8 * ms, 9 * ms),
              ("late", True, 9 * ms, 12 * ms)]
    tr = trace.Trace(events)
    assert tr.window_s == 0.01
    assert abs(tr.busy_s - 0.005) < 1e-12          # [1, 4] + [8, 10], clipped to the window
    assert tr.kernel("segment_moments_kernel") == (2, 0.0015)
    assert tr.kernel("absent") == (0, None)
    gaps = tr.idle_gaps()
    assert gaps[0] == ["step", 0.004] and gaps[1] == ["step", 0.001]
    assert tr.device_ops()[0] == ["segment_moments_kernel_29_", 0.003]
