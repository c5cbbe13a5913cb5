"""One client in a closed loop over the family's serving pipeline
(``serve.py::SegmentationPipeline``): each request a batch of clouds from
a pool of pinned host batches made at set-up, its latency from the call
to its outputs on the card. The judge gets a sample of the window's
requests drawn from the seed, and the last."""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import inputs, program


class Driver:
    kind = "serve"

    def __init__(self, cell, seed, device):
        cfg, traffic = cell.cfg, cell.traffic
        self.cfg, self.traffic, self.family = cfg, traffic, cell.family
        self.seed, self.device = seed, device
        self.batch = traffic["clouds_per_request"]
        t0 = time.perf_counter()
        self.weights = inputs.weights(self.family.param_specs(cfg), seed, device)
        pool = traffic["pool"]
        pts, _ = inputs.clouds(seed, pool * self.batch, cfg["n_points"],
                               cfg["n_classes"], device)
        self.pool = [pts[i * self.batch:(i + 1) * self.batch].cpu()
                     for i in range(pool)]
        if device.type == "cuda":
            self.pool = [p.pin_memory() for p in self.pool]
        del pts
        t1 = time.perf_counter()
        self.pipe = self.family.pipeline(cfg, self.weights, device)
        program.sync(device)
        self.phases = {"inputs": t1 - t0, "program": time.perf_counter() - t1}
        rng = inputs.host_rng(seed, 3)
        self.sample_at = set(rng.choice(traffic["sample_from"], traffic["sample"],
                                        replace=False).tolist())
        self.kept, self.served = {}, 0

    def setup(self):
        for i in range(self.traffic["warmup_requests"]):
            self.pipe(self.pool[i % len(self.pool)])
        program.sync(self.device)

    def request(self, i):
        with torch.profiler.record_function("portbench.request"):
            out = self.pipe(self.pool[i % len(self.pool)])
            program.sync(self.device)
        return out

    def window(self, seconds, requests=None):
        lat, i, last, t0 = [], 0, None, time.perf_counter()
        while (time.perf_counter() - t0 < seconds) if requests is None else i < requests:
            t = time.perf_counter()
            out = self.request(self.served + i)
            lat.append(time.perf_counter() - t)
            slot = (self.served + i) % len(self.pool)
            if requests is None and i in self.sample_at:
                self.kept[i] = (slot, out)
            last = (i, (slot, out))
            i += 1
        elapsed = time.perf_counter() - t0
        if requests is None:
            self.kept[last[0]] = last[1]
        bad = sum(not bool(torch.isfinite(o[0]).all()) for _, o in self.kept.values())
        self.served += i
        return {"elapsed": elapsed, "steps": i, "attempted": i, "failed": bad,
                "e2e": {"serve_clouds_per_s": i * self.batch / elapsed,
                        "serve_p95_ms": float(np.percentile(np.array(lat) * 1e3, 95))}}

    def traced_block(self):
        self.window(0.0, self.traffic["trace_requests"])

    def syncs(self):
        return program.count_syncs(lambda: self.pipe(self.pool[0]))

    def stage_ms(self):
        """(preprocessing ms, model ms) of one request's batch: CUDA events
        around the pipeline's preprocessing call and its model call, the
        median of 5."""
        pts = self.pool[0].to(self.device)
        prep, model = [], []
        for _ in range(6):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            out = program.preprocess(self.cfg, self.cfg["serve_nds"], pts)
            ev[1].record()
            with torch.no_grad():
                self.pipe.model(out["points"], out["covs"], return_logits=True)
            ev[2].record()
            program.sync(self.device)
            prep.append(ev[0].elapsed_time(ev[1]))
            model.append(ev[1].elapsed_time(ev[2]))
        return float(np.median(prep[1:])), float(np.median(model[1:]))

    def evidence(self):
        sample = [{"slot": slot, "logits": out[0], "mask": out[1],
                   "state": program.state_fields(out[2])}
                  for _, (slot, out) in sorted(self.kept.items())]
        return {"kind": "serve", "sample": sample, "pool": self.pool}

    def release(self):
        self.pipe = None
