"""No module that a run or the reference loads has the top-level name of
JAX, its libraries or the JAX package (the part before the first dot,
compared whole: ``ndtpu_torch`` is not ``ndtpu``), and the reference
loads nothing of the program."""
from __future__ import annotations

import subprocess
import sys

from portbench import spec

PROBE = ("import sys, {mods}; from portbench.spec import forbidden_modules; "
         "print(forbidden_modules()); "
         "print(sorted({{m.split('.')[0] for m in sys.modules}}))")


def _loaded(mods):
    out = subprocess.run([sys.executable, "-c", PROBE.format(mods=mods)],
                         capture_output=True, text=True, cwd=spec.ROOT, check=True)
    forbidden, tops = out.stdout.strip().splitlines()[-2:]
    return eval(forbidden), eval(tops)


def test_run_loads_no_jax_nor_the_jax_package():
    forbidden, tops = _loaded("portbench.run, portbench.drivers, portbench.judge, "
                              "portbench.calibrate, ndtpu_torch.train.loop, ndtpu_torch.serve")
    assert forbidden == []
    assert "ndtpu_torch" in tops


def test_reference_loads_nothing_of_the_program():
    forbidden, tops = _loaded("portbench.reference.ndt, portbench.reference.models")
    assert forbidden == []
    assert "ndtpu_torch" not in tops


def test_forbidden_names_are_whole_top_levels():
    import types

    saved = dict(sys.modules)
    try:
        sys.modules["ndtpu_torch_x"] = types.ModuleType("ndtpu_torch_x")
        assert "ndtpu" not in spec.forbidden_modules()
        sys.modules["ndtpu.core"] = types.ModuleType("ndtpu.core")
        assert "ndtpu" in spec.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
