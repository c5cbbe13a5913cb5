"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration (its ``file``) and the code of its model family
(``portbench/families/<family>.py``, the configuration's ``family``), its
traffic (``portbench/traffic/<traffic>.json``) and the driver that runs
it (``portbench/drivers/<driver>.py``, the traffic's ``driver``), its
limits (``portbench/limits/<cell>.json``) and the readers of its
per-layer metrics (``portbench/metrics/<metric>.py``). A new cell, mix,
configuration, family, driver or metric is new files and entries only;
a name with no file raises.
"""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ndtpu")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _read(path: Path) -> dict:
    return json.loads(path.read_text())


_LOADED = {}


def found(kind: str, name: str, root: Path = ROOT):
    """The module ``portbench/<kind>/<name>.py`` under ``root``, loaded
    from its file once; a name with no such file raises ValueError."""
    path = root / "portbench" / kind / f"{name}.py"
    if not NAME.match(name) or not path.is_file():
        known = sorted(p.stem for p in path.parent.glob("*.py"))
        raise ValueError(f"no {kind} file for {name!r} (known: {', '.join(known)})")
    key = str(path)
    if key not in _LOADED:
        spec = importlib.util.spec_from_file_location(
            f"portbench_{kind}_{name}".replace(".", "_").replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[key] = mod
    return _LOADED[key]


class Cell:
    """One entry of ``workloads`` with everything it names."""

    def __init__(self, name: str, root: Path = ROOT):
        bench = benchmark(root)
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.entry = cells[name]
        self.name = name
        self.here = root / "portbench"
        self.chips = self.entry["chips"]
        configs = {c["name"]: c for c in bench["configs"]}
        self.cfg = _read(root / configs[self.entry["config"]]["file"])
        self.traffic = _read(self.here / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = _read(self.here / "limits" / f"{name}.json")
        self.family = found("families", self.cfg["family"], root)
        self.driver = found("drivers", self.traffic["driver"], root).Driver
        self.root = root

        def mine(m):
            return name in m.get("workloads", [name])

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if mine(m) and m["moves"] in reported]

    def reader(self, metric: str):
        """The ``read(run)`` function of a per-layer metric's file."""
        return found("metrics", metric, self.root).read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (the part before the first
    dot, compared whole) is JAX's, its libraries' or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
