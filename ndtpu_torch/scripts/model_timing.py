"""Stage times of the NDTNetSegmentation forward (port of
``scripts/model_timing.py``).

    python -m ndtpu_torch.scripts.model_timing --variants flat,fold
    python -m ndtpu_torch.scripts.model_timing --variants flat,fold --dtype bf16
    python -m ndtpu_torch.scripts.model_timing --device cpu --batch_size 2 \\
        --n_desired_nds 64 --feature_dim 32 --n_classes 4 --inner 2 --iters 1

Stand-alone stage programs with the shapes and layers of
``models/ndtnet.py``, in inference mode (BatchNorm on its running
statistics), random weights from seed 0 (``init_random_``), inputs from
``numpy.random.default_rng(0)``:

  tnet3    TNet(3) on [B, M, 3]
  tnet64   TNet(64) on [B, M, 64]
  backbone Dense 12->64 + BN, 64->128 + BN, 128->F + BN on [B, M, 12]
  head     the segmentation head on [B, M, 64 + F]: 3 x (Dense + BN +
           ReLU) 512, 256, 128, then Dense(C + 1)
  full     the NDTNetSegmentation forward to logits

Variants (``--variants``):
  flat     backbone and head on rows flattened to [B*M, F]
  fold     backbone and head with the inference BatchNorm folded into the
           Dense weights (W' = W a, b' = b a + beta - mu a with a =
           gamma / sqrt(var + eps)): the same function as a plain matmul
           stack, so fold against not is what BatchNorm costs
``--dtype bf16`` computes every stage in bfloat16 (parameters float32,
as the JAX script's ``dtype=jnp.bfloat16``). Matmuls in float32 run in
full float32 (TF32 off).

Prints ``{"metric": "model_stage_ms", "dtype": ..., <stage>: ms, ...}``
with the shape and the device; times are medians of ``--inner`` runs x
``--iters`` calls (``_timing.py``).
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch
from torch import nn

from ndtpu_torch.models.dense import Dense, dense_norm, layers
from ndtpu_torch.models.ndtnet import NDTNetSegmentation
from ndtpu_torch.models.tnet import TNet
from ndtpu_torch.scripts._timing import add_timing_flags, device_name, measure
from ndtpu_torch.serve import init_random_
from ndtpu_torch.utils.device import resolve_device

STAGES = ("tnet3", "tnet64", "backbone", "head", "full")


class DenseBNStack(nn.Module):
    """Dense + BatchNorm (+ ReLU) a layer, then an optional last Dense:
    the backbone's and the head's building block (ndtnet.py:62-70,
    :120-123)."""

    def __init__(self, in_dim, feats, relu=False, final_dense=0, dtype=None):
        super().__init__()
        dense, norm = layers(dtype, torch.float32)
        dims = (in_dim,) + tuple(feats)
        self.dense = nn.ModuleList(dense(i, o) for i, o in zip(dims, feats))
        self.norm = nn.ModuleList(norm(f) for f in feats)
        self.relu = relu
        self.final = dense(dims[-1], final_dense) if final_dense else None

    def forward(self, x):
        for d, bn in zip(self.dense, self.norm):
            x = dense_norm(d, bn, x, self.relu)
        return x if self.final is None else self.final(x)


class FoldedStack(nn.Module):
    """``DenseBNStack`` in inference mode with each BatchNorm folded into
    the Dense before it: a plain Dense (+ ReLU) stack."""

    def __init__(self, stack: DenseBNStack):
        super().__init__()
        self.relu = stack.relu
        self.dense = nn.ModuleList()
        with torch.no_grad():
            for d, bn in zip(stack.dense, stack.norm):
                a = bn.weight / torch.sqrt(bn.running_var + bn.eps)
                f = Dense(d.in_features, d.out_features, d.compute_dtype)
                f.to(d.weight.device)
                f.weight.copy_(d.weight * a[:, None])
                f.bias.copy_((d.bias - bn.running_mean) * a + bn.bias)
                self.dense.append(f)
        self.final = stack.final

    def forward(self, x):
        for d in self.dense:
            x = d(x)
            if self.relu:
                x = torch.relu(x)
        return x if self.final is None else self.final(x)


def main(argv=None):
    """Time the stages and variants as the flags say; prints and returns
    the JSON line's dict."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--n_desired_nds", type=int, default=1000)
    p.add_argument("--n_classes", type=int, default=28)
    p.add_argument("--feature_dim", type=int, default=768)
    p.add_argument("--dtype", type=str, default="f32", choices=["f32", "bf16"])
    p.add_argument("--stages", type=str, default=",".join(STAGES))
    p.add_argument("--variants", type=str, default="",
                   help="comma-separated subset of flat,fold")
    add_timing_flags(p, inner=64)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    b, m, c, f = (args.batch_size, args.n_desired_nds, args.n_classes,
                  args.feature_dim)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    rng = np.random.default_rng(0)
    stages = [s for s in args.stages.split(",") if s]
    variants = set(args.variants.split(",")) - {""}
    bad = (set(stages) - set(STAGES)) | (variants - {"flat", "fold"})
    if bad:
        p.error(f"unknown stage(s) or variant(s): {sorted(bad)}")

    def normal(shape, dt=dtype):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
            device=dev, dtype=dt)

    def timed(module, *inputs):
        module = init_random_(module.to(dev), 0).eval()
        return time_eval(module, *inputs)

    def time_eval(module, *inputs):
        @torch.no_grad()
        def run():
            return module(*inputs)

        return measure(run, dev, args.inner, args.iters)["ms"]

    def backbone(shape):
        return DenseBNStack(12, (64, 128, f), dtype=dtype), normal(shape)

    def head(shape):
        return (DenseBNStack(64 + f, (512, 256, 128), relu=True,
                             final_dense=c + 1, dtype=dtype), normal(shape))

    results = {}
    for stage in stages:
        if stage == "tnet3":
            t = timed(TNet(3, dtype), normal((b, m, 3)))
        elif stage == "tnet64":
            t = timed(TNet(64, dtype), normal((b, m, 64)))
        elif stage == "backbone":
            t = timed(*backbone((b, m, 12)))
        elif stage == "head":
            t = timed(*head((b, m, 64 + f)))
        else:
            model = NDTNetSegmentation(num_classes=c, feature_dim=f,
                                       device=dev, dtype=dtype)
            pcl, covs = normal((b, m, 3), torch.float32), normal(
                (b, m, 9), torch.float32)
            t = timed(_Logits(model), pcl, covs)
        results[stage] = t
        print(f"[model] {stage}: {t:.4f} ms/batch", file=sys.stderr)
    if "flat" in variants:
        results["backbone_flat"] = timed(*backbone((b * m, 12)))
        results["head_flat"] = timed(*head((b * m, 64 + f)))
    if "fold" in variants:
        for name, (stack, x) in (("backbone", backbone((b, m, 12))),
                                 ("head", head((b, m, 64 + f)))):
            stack = init_random_(stack.to(dev), 0).eval()
            results[f"{name}_fold"] = time_eval(FoldedStack(stack), x)
    for v in sorted(variants):
        print(f"[model] {v}: backbone {results[f'backbone_{v}']:.4f} ms, "
              f"head {results[f'head_{v}']:.4f} ms", file=sys.stderr)
    out = {"metric": "model_stage_ms", "dtype": args.dtype, **results,
           "batch": b, "n_desired_nds": m, "n_classes": c, "feature_dim": f,
           "runs": args.inner * args.iters, "device": device_name(dev)}
    print(json.dumps(out))
    return out


class _Logits(nn.Module):
    """The segmentation model's forward to logits."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, pcl, covs):
        return self.model(pcl, covs, return_logits=True)


if __name__ == "__main__":
    main(sys.argv[1:])
