"""Import the torch reference's model files without its native library
(port of ``ndtpu/interop/reference_loader.py``; pure Python, its own copy).

The reference models (``<reference>/ndnet/models/*.py``) import
``ndnet.preprocessing.ndt_legacy`` at module scope, which loads the
reference's C library with ``ctypes`` (ndt_legacy.py:28); that library
exists only in the reference's Docker image. This loader stubs that import
so the model code (pure torch) can be used for weight migration and the
parity experiment (``tools/parity_train.py``).

The default location is ``reference/ndnet/models`` under the repository's
root (a checkout of the reference placed there); ``models_dir`` names
another. Without the reference code the loader raises
``FileNotFoundError`` naming the path it looked in.
"""
from __future__ import annotations

import importlib.util
import os
import sys
import types

DEFAULT_REF = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "reference", "ndnet", "models")

# Minimal source patches that make the reference's multiscale module
# constructible and callable, each reversing one latent bug without
# touching a working code path:
#   1. ndtnetpp.py:44-53: a dead duplicate ``forward`` (docstring only,
#      returns None) overrides ResidualConnection's real forward; the
#      duplicate is renamed so the real one binds (_patch_duplicate_forward).
#   2. ndtnetpp.py:143: the ``super().__init()`` typo makes
#      ndnetClassification unconstructible.
_SOURCE_PATCHES = {
    "ndtnetpp": [
        # (old, new, expected occurrence count of old)
        ("super().__init()", "super().__init__()", 1),
    ],
}


def _patch_duplicate_forward(src: str) -> str:
    """Rename the second ``def forward`` of ResidualConnection (the dead
    duplicate, ndtnetpp.py:44-53) so the first, real one binds."""
    sig = "def forward(self, x: torch.Tensor) -> torch.Tensor:"
    first = src.index(sig)
    second = src.index(sig, first + 1)
    return src[:second] + src[second:].replace(
        sig, "def _dead_duplicate_forward(self, x):", 1
    )


def _stub_packages(models_dir: str):
    """Register ``ndnet``, ``ndnet.preprocessing`` (with a stub
    ``ndt_legacy``) and ``ndnet.models`` so the model files import."""
    root = os.path.dirname(os.path.dirname(models_dir))
    pkg = types.ModuleType("ndnet")
    pkg.__path__ = [os.path.join(root, "ndnet")]
    pre = types.ModuleType("ndnet.preprocessing")
    pre.__path__ = [os.path.join(root, "ndnet", "preprocessing")]
    legacy = types.ModuleType("ndnet.preprocessing.ndt_legacy")
    legacy.NDT_Sampler = object
    models = types.ModuleType("ndnet.models")
    models.__path__ = [models_dir]
    sys.modules.update({"ndnet": pkg, "ndnet.preprocessing": pre,
                        "ndnet.preprocessing.ndt_legacy": legacy,
                        "ndnet.models": models})


def load_reference_module(name: str, models_dir: str = DEFAULT_REF,
                          patched: bool = False):
    """Import the reference model module ``name`` (e.g. "ndtnet") from
    ``models_dir`` with the ndt_legacy import stubbed. Returns the module.

    ``patched=True`` applies the minimal bug patches (_SOURCE_PATCHES and
    _patch_duplicate_forward) so the otherwise unconstructible reference
    classes (the multiscale family) can be instantiated for weight
    interop; the patched module is registered under a name of its own and
    never shadows the verbatim import."""
    models_dir = os.path.abspath(models_dir)
    path = os.path.join(models_dir, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"reference model file {path} not found: the reference's "
            "ndnet/models directory is not at this path (pass models_dir)")
    if "ndnet" not in sys.modules:
        _stub_packages(models_dir)
    full = f"ndnet.models.{name}" + ("__patched" if patched else "")
    if full in sys.modules:
        return sys.modules[full]
    if patched:
        with open(path) as fh:
            src = fh.read()
        if name == "ndtnetpp":
            src = _patch_duplicate_forward(src)
        for old, new, count in _SOURCE_PATCHES.get(name, ()):
            if src.count(old) != count:
                raise ValueError(f"{path}: expected {count} of {old!r}")
            src = src.replace(old, new)
        mod = types.ModuleType(full)
        mod.__file__ = path
        mod.__package__ = "ndnet.models"
        sys.modules[full] = mod
        exec(compile(src, path, "exec"), mod.__dict__)
        return mod
    spec = importlib.util.spec_from_file_location(full, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[full] = mod
    spec.loader.exec_module(mod)
    return mod
