"""Device selection for the port's entry points (counterpart of
``ndtpu/utils/platform.py``).

The port runs on the card. An entry point asked for ``"cuda"`` (the
default everywhere) on a machine without one raises instead of carrying on
quietly on the CPU; the CPU is used only when the caller names it, as the
tests do.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return ``torch.device(device)``; raise if it is CUDA and no CUDA
    device is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ndtpu_torch: device 'cuda' requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def capturing() -> bool:
    """True while the current CUDA stream is being captured into a graph
    (False without a card)."""
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())
