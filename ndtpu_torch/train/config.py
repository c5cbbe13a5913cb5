"""The trainers' config (port of ``ndtpu/train/config.py``): the same flag
names and defaults, the same ``from_args`` (``--flag/--no-flag`` for
bools, default overrides for another trainer's defaults), plus
``--device`` (default ``cuda``; the tests ask for ``cpu``).

A flag the port cannot honour makes ``validate()`` raise; none is
ignored quietly. ``--compute_dtype`` / ``--param_dtype`` take float32,
bfloat16, float16 or float64 (the NDT preprocessing stays float32);
``--device_cache`` keeps each split on the device and, with
``--epoch_scan`` (the default), runs each epoch as a CUDA graph of its
step (``train/loop.py::make_epoch_scan``). ``--coordinator host:port
--num_processes P --process_id i`` make the trainer rank i of a data
group of P processes (``parallel/mesh.py::init_distributed``);
``--data_axis`` names that group, as it names the JAX mesh's data axis,
and has no other effect in the port.
``steps_per_epoch`` is read by no trainer, here or in the JAX package
(the trainers derive it from the dataset).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ndtpu_torch.utils.device import resolve_device


# the floating types that both jnp.dtype and torch name, by jnp.dtype's names
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "float64": torch.float64}


def resolve_dtype(name: str, flag: str = "dtype") -> torch.dtype:
    """The torch type of a ``--compute_dtype`` / ``--param_dtype`` name;
    ValueError for any other name."""
    if name not in DTYPES:
        raise ValueError(f"{flag} must be one of {', '.join(DTYPES)}, "
                         f"got {name!r}")
    return DTYPES[name]


@dataclasses.dataclass
class TrainConfig:
    # reference flags (tools/train.py:99-112)
    task: str = "segmentation"
    n_desired_nds: int = 2080
    n_samples: int = 70000
    train_path: Optional[str] = None
    val_path: Optional[str] = None
    test_path: Optional[str] = None
    out_path: str = "out"
    epochs: int = 200
    save_every: int = 2
    batch_size: int = 16
    learning_rate: float = 0.034
    n_classes: int = 28
    feature_dim: int = 768

    # the multiscale trainer's coarse ND count (n_desired_nds is its fine)
    n_desired_nds1: int = 4080

    # halve the rate every lr_decay_epochs epochs
    lr_decay_epochs: int = 20
    lr_decay_rate: float = 0.5

    resume: Optional[str] = None          # checkpoint dir to resume from
    wandb: bool = False
    wandb_project: str = "ndnet"
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    use_pallas: str = "auto"
    # voxel-size search: probe, fast, reference or grid (see core/ndt.py)
    search: str = "probe"
    # ground truth as [B, N] int32 class tags instead of one-hot [B, N, C+1]
    int_labels: bool = True
    # search each sample's voxel size once, then train with it fixed
    streaming: bool = False
    data_axis: str = "data"
    seed: int = 0
    synthetic_length: int = 32            # clouds per synthetic split
    cache_dataset: bool = True            # keep fetched samples in host RAM
    device_cache: bool = False
    epoch_scan: bool = True
    steps_per_epoch: Optional[int] = None

    coordinator: Optional[str] = None
    num_processes: int = 1
    process_id: int = 0

    # the port's own: the card unless the caller asks for the CPU
    device: str = "cuda"

    def validate(self):
        if self.search not in ("fast", "probe", "reference", "grid"):
            raise ValueError(
                f"--search must be fast|probe|reference|grid, got {self.search!r}"
            )
        for flag in ("compute_dtype", "param_dtype"):
            resolve_dtype(getattr(self, flag), f"--{flag}")
        if self.use_pallas != "auto":
            raise NotImplementedError(
                "--use_pallas: the tensors' device picks the route (the CUDA "
                "kernel on the card); only 'auto' is accepted")
        resolve_device(self.device)
        return self

    @property
    def dtypes(self) -> dict:
        """The model's ``dtype`` and ``param_dtype`` keywords, as torch
        types."""
        return {"dtype": resolve_dtype(self.compute_dtype),
                "param_dtype": resolve_dtype(self.param_dtype)}

    @classmethod
    def from_args(cls, argv=None, **default_overrides):
        """argparse overlay with the reference's flag names and defaults;
        ``default_overrides`` replace dataclass defaults (the multiscale
        trainer's n_desired_nds, batch_size, feature_dim) and stay
        overridable on the command line."""
        import argparse
        import typing

        hints = typing.get_type_hints(cls)

        def base_type(t):
            args = [a for a in typing.get_args(t) if a is not type(None)]
            return args[0] if args else t

        parser = argparse.ArgumentParser()
        for f in dataclasses.fields(cls):
            default = default_overrides.get(f.name, f.default)
            t = base_type(hints[f.name])
            if t is bool:
                parser.add_argument(
                    f"--{f.name}", action=argparse.BooleanOptionalAction,
                    default=default,
                )
            elif t in (int, float, str):
                parser.add_argument(f"--{f.name}", type=t, default=default)
            else:
                parser.add_argument(f"--{f.name}", type=str, default=default)
        ns = parser.parse_args(argv)
        return cls(**vars(ns)).validate()
