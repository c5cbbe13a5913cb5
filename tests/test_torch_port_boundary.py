"""The port's package boundary and device rules.

``ndtpu_torch`` imports torch and numpy, never jax, flax or ``ndtpu``
(importing any ``ndtpu`` module runs ndtpu/__init__.py, which imports
jax), nor the JAX side's scripts, tools, bench.py or __graft_entry__.py
(the port keeps its own copy of anything it needs from them). Its entry points default to the card and raise where there is none,
unless the caller asks for the CPU. chip_smoke.py and kernel_ab.py follow
the same rules.
"""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "ndtpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ndtpu", "scripts", "tools",
             "bench", "__graft_entry__")
SCRIPTS = ("collectives", "kernel_micro", "model_timing", "parity_sweep",
           "prep_micro", "probe_seed_validate", "seed_hit_rate", "stage_timing")


def port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "kernel_ab.py"]


def test_port_sources_import_no_jax():
    for path in port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_importing_every_port_module_loads_no_jax():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).replace(".__init__", "")
        for p in PORT.rglob("*.py")
    )
    # the measurement scripts are port modules too: importing one runs
    # nothing (its main is under the __main__ check)
    assert {f"ndtpu_torch.scripts.{s}" for s in SCRIPTS} <= set(modules)
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(len(bad), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout == "0 []\n", proc.stdout  # no module printed


def test_entry_points_raise_without_a_card(monkeypatch):
    from ndtpu_torch.core.ndt import empty_state
    from ndtpu_torch.models import NDTNetSegmentation
    from ndtpu_torch.parallel.mesh import make_group
    from ndtpu_torch.scripts import (collectives, kernel_micro, model_timing,
                                     prep_micro, probe_seed_validate,
                                     seed_hit_rate, stage_timing)
    from ndtpu_torch.serve import SegmentationPipeline, dryrun_multichip, entry
    from ndtpu_torch.utils.device import resolve_device

    from ndtpu_torch.tools.train import main as train_main
    from ndtpu_torch.train.config import TrainConfig
    from ndtpu_torch.train.loop import make_lr_schedule
    from ndtpu_torch.train.state import create_train_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (entry, lambda: SegmentationPipeline(32, 4, 32),
                 lambda: NDTNetSegmentation(num_classes=4, feature_dim=32),
                 lambda: empty_state(16), resolve_device, make_group,
                 lambda: create_train_state(4, 32, make_lr_schedule(1e-3, 1)),
                 lambda: TrainConfig.from_args(["--device", "cuda"]),
                 lambda: train_main(["--epochs", "1", "--n_samples", "64"]),
                 lambda: dryrun_multichip(1),
                 *[lambda m=m: m.main([]) for m in (
                     collectives, kernel_micro, model_timing, prep_micro,
                     probe_seed_validate, seed_hit_rate, stage_timing)]):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert resolve_device("cpu").type == "cpu"


def test_chip_smoke_fails_without_a_card():
    """Here there is no card: the script must exit non-zero and print no
    result line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
