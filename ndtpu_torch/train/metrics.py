"""Metrics logging (port of ``ndtpu/train/metrics.py``): one JSON line per
``log`` call on stdout, on rank 0 only, plus an optional wandb shim that
falls back to stdout when wandb is absent or offline."""
from __future__ import annotations

import json
import sys
import time
from typing import Optional

import torch.distributed as dist


def is_rank_zero() -> bool:
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


class MetricLogger:
    def __init__(self, use_wandb: bool = False, project: str = "ndnet",
                 run_name: Optional[str] = None, config: Optional[dict] = None):
        self._wandb = None
        self._t0 = time.time()
        if use_wandb and is_rank_zero():
            try:
                import wandb

                wandb.init(project=project, name=run_name, config=config or {})
                self._wandb = wandb
            except Exception as e:  # wandb absent or offline
                print(f"[metrics] wandb unavailable ({e}); logging to stdout",
                      file=sys.stderr)

    def log(self, metrics: dict, step: Optional[int] = None):
        if not is_rank_zero():
            return
        payload = {k: float(v) for k, v in metrics.items()}
        if step is not None:
            payload["step"] = step
        payload["t"] = round(time.time() - self._t0, 3)
        print(json.dumps(payload), flush=True)
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def finish(self):
        if self._wandb is not None:
            self._wandb.finish()
