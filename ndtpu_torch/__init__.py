"""ndtpu_torch: the PyTorch/CUDA port of ndtpu for NVIDIA Hopper.

Same module layout and names as ``ndtpu`` (core/voxel, core/moments,
core/kl, core/ndt, preprocessing/batch, models/*), written for PyTorch:
``vmap`` becomes an explicit leading batch dimension, the Pallas kernel on
the serving path (the segment-moments reduction) becomes a hand-written
CUDA kernel under ``csrc/``, built at first use (ops/_build.py).

This package imports torch and numpy only: never jax, flax or ``ndtpu``
(importing any ``ndtpu`` module runs ``ndtpu/__init__.py``, which imports
jax). Entry points default to ``device="cuda"`` and raise when no card is
present unless the caller asks for ``"cpu"``.
"""
from ndtpu_torch.core.ndt import NDTSampler
from ndtpu_torch.utils.device import resolve_device

__all__ = ["NDTSampler", "resolve_device"]
