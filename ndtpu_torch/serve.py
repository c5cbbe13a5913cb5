"""Serving path: NDT preprocessing then NDTNetSegmentation, on the card.

The port's counterpart of ``__graft_entry__.entry`` and of the inference
half of bench.py's ``build_pipeline``: a batch of raw clouds in, per-ND
logits out. On CUDA the preprocessing runs the segment-moments kernel once
per batch.
"""
from __future__ import annotations

import torch

from ndtpu_torch.data.synthetic import example_cloud
from ndtpu_torch.models.ndtnet import NDTNetSegmentation
from ndtpu_torch.preprocessing.batch import ndt_preprocessing_with_state
from ndtpu_torch.utils.device import resolve_device


def init_random_(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Random weights from a seed, drawn on the CPU so every device gets
    the same model: each Linear weight ~ N(0, 1/fan_in) and zero bias (the
    scale of flax's default lecun_normal), BatchNorm at identity."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Linear):
                w = torch.randn(m.weight.shape, generator=g)
                m.weight.copy_(w / m.in_features**0.5)
                m.bias.zero_()
    return model


class SegmentationPipeline:
    """Preprocess a batch of clouds to ``n_desired`` NDs, then segment.

    ``search`` is the voxel-size search of ndt_downsample ("probe" is the
    serving default). ``dtype`` is the model's compute type (bench.py's
    ``build_pipeline(dtype=...)``: bfloat16 runs the model's matmuls on the
    tensor cores); the parameters and the NDT preprocessing stay float32.
    Weights are random from ``seed``; load trained ones with
    ``ndtpu_torch.interop.jax_weights.load_jax_variables(pipeline.model,
    variables)``.
    """

    def __init__(self, n_desired: int = 1000, num_classes: int = 28,
                 feature_dim: int = 768, search: str = "probe",
                 device="cuda", seed: int = 0, dtype=torch.float32):
        self.device = resolve_device(device)
        self.n_desired = n_desired
        self.num_classes = num_classes
        self.search = search
        model = NDTNetSegmentation(num_classes=num_classes,
                                   feature_dim=feature_dim, device=self.device,
                                   dtype=dtype)
        self.model = init_random_(model, seed).eval()

    @torch.no_grad()
    def __call__(self, points):
        """points [B, N, 3] -> (logits [B, n_desired, num_classes + 1] in
        the compute type, out_mask [B, n_desired], NDTResult)."""
        points = torch.as_tensor(points, dtype=torch.float32,
                                 device=self.device)
        pcl, covs, _, mask, state = ndt_preprocessing_with_state(
            self.n_desired, points, None, self.num_classes, search=self.search,
        )
        return self.model(pcl, covs, return_logits=True), mask, state


def entry(canonical: bool = False, device="cuda"):
    """Returns (fn, example_args) with fn(points) -> logits.

    The small shape is B=2, N=4096, M=256, C=8, feature_dim 128; the
    canonical one B=16, N=70000, M=1000, C=28, feature_dim 768. As in the
    JAX entry, the card runs the probe search and the CPU the reference
    bisection."""
    dev = resolve_device(device)
    if canonical:
        b, n, m, c, f = 16, 70000, 1000, 28, 768
    else:
        b, n, m, c, f = 2, 4096, 256, 8, 128
    pipe = SegmentationPipeline(
        m, c, f, search="probe" if dev.type == "cuda" else "reference",
        device=dev,
    )

    def forward(points):
        return pipe(points)[0]

    return forward, (torch.as_tensor(example_cloud(b, n), device=dev),)
