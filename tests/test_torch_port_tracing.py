"""The program's spans (``ndtpu_torch/utils/profiling.py::span``) at small
sizes on the CPU, and one captured step's on the card.

Off, a request and a train step record nothing and enter no
``record_function``. Under ``torch.profiler`` the serving pipeline and
each ``make_*_step`` emit their spans with the right parents and one
root a request or step; their outputs and parameters equal those of the
same call with the profiler off, bit for bit. The epoch scan and the
device prefetcher emit theirs. The benchmark's readers of the spans each
have a ``BENCHMARK.json`` entry and read what they should. This file
imports neither jax nor ``ndtpu``, so on the card it runs as

    python -m pytest --noconftest tests/test_torch_port_tracing.py -q
"""
import json
import pathlib
import types

import numpy as np
import pytest
import torch

from ndtpu_torch.data.loader import batch_iterator, prefetch_to_device
from ndtpu_torch.data.synthetic import example_cloud
from ndtpu_torch.models import (
    NDTNetClassification,
    NDTNetPPSegmentation,
    PointNetSegmentation,
)
from ndtpu_torch.serve import SegmentationPipeline
from ndtpu_torch.train import loop
from ndtpu_torch.train.state import create_train_state
from ndtpu_torch.utils import profiling

ROOT = pathlib.Path(__file__).resolve().parent.parent
B, N, C, F, M, COARSE = 2, 1024, 4, 32, 16, 8
ACTS = [torch.profiler.ProfilerActivity.CPU]
NDT = [("ndtpu.ndt.search", "ndtpu.prep"), ("ndtpu.ndt.moments", "ndtpu.prep"),
       ("ndtpu.ndt.kl", "ndtpu.prep"), ("ndtpu.ndt.emit", "ndtpu.prep")]
PREP = [("ndtpu.prep", "ndtpu.step")] + NDT
UPDATE = [("ndtpu.backward", "ndtpu.step"), ("ndtpu.optimizer", "ndtpu.step")]
# each step's spans in order, as (name, its parent's name)
STEP_SPANS = {
    "seg": [("ndtpu.step", None)] + PREP + [("ndtpu.forward", "ndtpu.step")] + UPDATE,
    "cls": ([("ndtpu.step", None)] + PREP + [("ndtpu.forward", "ndtpu.step"),
                                              ("ndtpu.head", "ndtpu.forward")] + UPDATE),
    "multiscale": ([("ndtpu.step", None)] + PREP + PREP
                   + [("ndtpu.forward", "ndtpu.step"),
                      ("ndtpu.ndt.emit", "ndtpu.forward")] + UPDATE),
    "pointnet": [("ndtpu.step", None), ("ndtpu.forward", "ndtpu.step")] + UPDATE,
}
REQUEST_SPANS = ([("ndtpu.request", None), ("ndtpu.h2d", "ndtpu.request"),
                  ("ndtpu.prep", "ndtpu.request")] + NDT
                 + [("ndtpu.model", "ndtpu.request")])


@pytest.fixture(autouse=True)
def fresh_records():
    profiling.reset()
    yield
    profiling.reset()


def clouds():
    pts = torch.from_numpy(example_cloud(B, N))
    return pts, (pts[..., 0] > 0).long() + 1


def train_setup(kind):
    """(state, step, args) of a ``make_*_step`` at small sizes on the CPU."""
    pts, tags = clouds()
    sched = loop.make_lr_schedule(1e-3, 2)
    if kind == "seg":
        step, _ = loop.make_ndt_seg_step(M, C)
        state = create_train_state(C, F, sched, device="cpu")
        return state, step, (pts, tags)
    if kind == "cls":
        step, _ = loop.make_classification_step(M, C)
        state = create_train_state(C, F, sched, device="cpu",
                                   model=NDTNetClassification)
        return state, step, (pts, torch.eye(C)[[1, 2]])
    if kind == "multiscale":
        step, _ = loop.make_multiscale_seg_step(M, COARSE, C)
        state = create_train_state(C, F, sched, device="cpu",
                                   model=NDTNetPPSegmentation, fine_res=M,
                                   coarse_res=COARSE)
        return state, step, (pts, tags)
    step, _ = loop.make_pointnet_seg_step(C)
    state = create_train_state(C, F, sched, device="cpu",
                               model=PointNetSegmentation)
    return state, step, (pts[:, :256], tags[:, :256])


def tree(recs):
    """[(name, the parent's name)] of the records, in order."""
    by_id = {r.id: r.name for r in recs}
    return [(r.name, by_id.get(r.parent)) for r in recs]


def profiled(fn):
    with torch.profiler.profile(activities=ACTS):
        out = fn()
    return out, profiling.spans()


def test_off_records_nothing_and_enters_no_record_function(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function entered with the profiler off")

    # the program's spans enter it as torch.profiler's (torch's optimizer
    # enters its own, torch.autograd.profiler's, with a check of its own)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.span("ndtpu.step") is profiling.span("ndtpu.prep")
    pipe = SegmentationPipeline(M, C, F, search="fast", device="cpu")
    pipe(clouds()[0])
    for kind in STEP_SPANS:
        state, step, args = train_setup(kind)
        step(state, *args)
    data = [(np.zeros((3,), np.float32),) for _ in range(4)]
    list(prefetch_to_device(batch_iterator(data, 2, shuffle=False), "cpu"))
    assert profiling.spans() == []


def test_request_spans_nest_under_one_root():
    pipe = SegmentationPipeline(M, C, F, search="fast", device="cpu")
    pts = clouds()[0]
    want = pipe(pts)
    got, recs = profiled(lambda: pipe(pts))
    assert tree(recs) == REQUEST_SPANS
    assert {r.root for r in recs} == {recs[0].id}
    assert all(r.ms is None for r in recs)  # no card: no device time
    for a, b in zip(got[:2], want[:2]):
        assert torch.equal(a, b)
    profiling.reset()
    _, recs = profiled(lambda: [pipe(pts) for _ in range(2)])
    roots = [r for r in recs if r.name == "ndtpu.request"]
    assert len(roots) == 2 and len({r.root for r in recs}) == 2


@pytest.mark.parametrize("kind", list(STEP_SPANS))
def test_step_spans_nest_under_one_root(kind):
    """Each step's spans, NDT-Net++'s two preprocessings and the prune
    inside its forward (``ndtpu.ndt.emit`` under ``ndtpu.forward``)
    included; two steps give two roots."""
    state, step, args = train_setup(kind)
    _, recs = profiled(lambda: step(state, *args))
    assert tree(recs) == STEP_SPANS[kind]
    assert {r.root for r in recs} == {recs[0].id}
    profiling.reset()
    _, recs = profiled(lambda: [step(state, *args) for _ in range(2)])
    steps = [r for r in recs if r.name == "ndtpu.step"]
    assert len(steps) == 2 and {r.root for r in recs} == {r.id for r in steps}


@pytest.mark.parametrize("kind", list(STEP_SPANS))
def test_step_is_bit_identical_with_the_profiler_on(kind):
    state_off, step, args = train_setup(kind)
    state_on = train_setup(kind)[0]
    for _ in range(2):
        _, m_off = step(state_off, *args)
        (_, m_on), _ = profiled(lambda: step(state_on, *args))
        assert torch.equal(m_on["loss"], m_off["loss"])
    for a, b in zip(state_on.model.state_dict().values(),
                    state_off.model.state_dict().values()):
        assert torch.equal(a, b)


def test_classification_head_span():
    """A classification step under the profiler has one ``ndtpu.head``
    host event, inside its ``ndtpu.forward``; with the profiler off the
    step records no span."""
    state, step, args = train_setup("cls")
    step(state, *args)
    assert profiling.spans() == []
    with torch.profiler.profile(activities=ACTS) as prof:
        step(state, *args)
    events = {}
    for e in prof.events():
        events.setdefault(e.name, []).append(e.time_range)
    (head,), (fwd,) = events["ndtpu.head"], events["ndtpu.forward"]
    assert fwd.start <= head.start and head.end <= fwd.end


def test_epoch_scan_and_prefetch_emit_their_spans():
    """On the CPU the epoch scan is a loop of eager steps inside one
    ``ndtpu.epoch``; each batch the prefetcher makes is an
    ``ndtpu.data`` span (one more for the fetch that ends the data)."""
    state, step, (pts, tags) = train_setup("seg")
    scan = loop.make_epoch_scan(step)
    order = torch.tensor([[0, 1], [1, 0]])
    _, recs = profiled(lambda: scan(state, order, pts, tags))
    epoch = recs[0]
    assert (epoch.name, epoch.parent, epoch.root) == ("ndtpu.epoch", None, None)
    steps = [r for r in recs if r.name == "ndtpu.step"]
    assert len(steps) == 2 and all(r.parent == epoch.id for r in steps)
    assert tree(recs) == [("ndtpu.epoch", None)] + [
        (n, p or "ndtpu.epoch") for n, p in STEP_SPANS["seg"]] * 2
    profiling.reset()
    data = [(np.full((3,), i, np.float32),) for i in range(6)]
    got, recs = profiled(lambda: list(prefetch_to_device(
        batch_iterator(data, 2, shuffle=False), "cpu")))
    assert [int(b[0][0, 0]) for b in got] == [0, 2, 4]
    assert [(r.name, r.parent, r.root) for r in recs] == [("ndtpu.data", None, None)] * 4


def test_profile_trace_exports_the_spans(tmp_path):
    pipe = SegmentationPipeline(M, C, F, search="fast", device="cpu")
    with profiling.profile_trace(str(tmp_path)):
        pipe(clouds()[0])
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {n for n, _ in REQUEST_SPANS} <= names


NEW_METRICS = {
    "prep_ms.train": (("ndtpu.prep",), "ndtpu.step"),
    "model_ms.train": (("ndtpu.forward", "ndtpu.backward"), "ndtpu.step"),
    "optimizer_ms.train": (("ndtpu.optimizer",), "ndtpu.step"),
    "search_ms.train": (("ndtpu.ndt.search",), "ndtpu.step"),
    "kl_ms.train": (("ndtpu.ndt.kl",), "ndtpu.step"),
    "head_ms.train": (("ndtpu.head",), "ndtpu.step"),
    "search_ms.serve": (("ndtpu.ndt.search",), "ndtpu.request"),
    "kl_ms.serve": (("ndtpu.ndt.kl",), "ndtpu.request"),
    "prep_idle_ms.train": (("ndtpu.prep",), "ndtpu.step"),
    "prep_idle_ms.serve": (("ndtpu.prep",), "ndtpu.request"),
}


def test_every_span_metric_has_its_entry():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    files = {p.stem for p in (ROOT / "portbench" / "metrics").glob("*.py")}
    for name in NEW_METRICS:
        assert name in files and name in entries, name
        m = entries[name]
        want = "device_trace" if name.startswith("prep_idle") else "program_span"
        assert m["source"] == want and m["better"] == "lower"
        assert m["unit"] == ("ms/step" if name.endswith(".train") else "ms/request")
        assert m["moves"] == ("train_clouds_per_s" if name.endswith(".train")
                              else "serve_clouds_per_s")


def fake(name, root, ms):
    return types.SimpleNamespace(name=name, root=root, ms=ms)


@pytest.mark.parametrize("name", list(NEW_METRICS))
def test_span_readers(name, monkeypatch):
    """Each reader: its spans' total per root span, from the program's
    records or the trace's host events against its idle gaps; None where
    the program has no spans (an older program) or nothing to read."""
    from portbench import spec, trace

    read = spec.found("metrics", name).read
    names, root = NEW_METRICS[name]
    ms = 1_000_000
    if name.startswith("prep_idle"):
        # two roots; the preprocessing at [1, 4] and [6, 8] ms; the card
        # busy at [0, 2] and [3, 7]: idle [2, 3] and [7, 8] inside it
        events = [(trace.WINDOW, False, 0, 10 * ms), (root, False, 0, 5 * ms),
                  (root, False, 5 * ms, 10 * ms), ("ndtpu.prep", False, ms, 4 * ms),
                  ("ndtpu.prep", False, 6 * ms, 8 * ms), ("k", True, 0, 2 * ms),
                  ("k", True, 3 * ms, 7 * ms), ("k", True, 9 * ms, 10 * ms)]
        assert read(types.SimpleNamespace(trace=trace.Trace(events))) == 1.0
        assert read(types.SimpleNamespace(trace=None)) is None
        events = [e for e in events if e[0] != "ndtpu.prep"]
        assert read(types.SimpleNamespace(trace=trace.Trace(events))) is None
        return
    recs = [fake(root, 0, 10.0), fake(root, 1, 12.0)]
    recs += [fake(n, r, 1.5 + i) for r in (0, 1) for i, n in enumerate(names)]
    recs += [fake("ndtpu.epoch", None, 30.0), fake("ndtpu.other", 0, 4.0)]
    monkeypatch.setattr(profiling, "spans", lambda: recs)
    want = sum(1.5 + i for i in range(len(names)))
    assert read(None) == pytest.approx(want)
    monkeypatch.setattr(profiling, "spans", lambda: recs[:2])
    assert read(None) is None
    monkeypatch.delattr(profiling, "spans")
    assert read(None) is None


@pytest.mark.cuda
def test_captured_step_spans_time_each_replay():
    """A train step captured into the epoch's CUDA graph: its spans are
    the graph's event-record nodes, read after a replay with no profiler
    running; each reads a positive time, and the step's direct children
    together take no longer than the step."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA graph has no CPU mode)")
    dev = torch.device("cuda")
    pts = torch.from_numpy(example_cloud(4, 4096)).to(dev)
    tags = (pts[..., 0] > 0).long() + 1
    step, _ = loop.make_ndt_seg_step(64, C)
    state = create_train_state(C, F, loop.make_lr_schedule(1e-3, 2), device=dev)
    scan = loop.make_epoch_scan(step)
    order = torch.tensor([[0, 1], [2, 3]], device=dev)
    scan(state, order, pts, tags)
    recs = profiling.spans()
    assert tree(recs) == STEP_SPANS["seg"]
    assert all(r.ms is not None and r.ms > 0 for r in recs)
    top = recs[0]
    children = sum(r.ms for r in recs if r.parent == top.id)
    assert children <= top.ms + 1e-3
