"""Micro-benchmarks of the KL stage's parts and of the payload sorts
(port of ``scripts/kernel_micro.py``, its ``kl_*`` and ``sort*`` modes).

    python -m ndtpu_torch.scripts.kernel_micro --mode kl_full
    python -m ndtpu_torch.scripts.kernel_micro --mode sort7
    python -m ndtpu_torch.scripts.kernel_micro --device cpu --mode kl_sorts \\
        --batch 2 --n 4096 --k 64 --k_max 64 --inner 2 --iters 1

The inputs are built from ``numpy.random.default_rng(0)`` with the JAX
script's calls in its order (features [B, n, f], sorted dense segment
ranks [B, n] over k, then the mode's own), so a seed gives its data.

The KL stage at the canonical K-row scale (``core/kl.py``; ``--k_max``
rows, 91 % occupied voxels of a 40^3 grid, lexicographically sorted,
moments and counts as the JAX script draws them):

  kl_full     the port's ``neighbor_min_kl``
  kl_sorts    its two re-sorts, by (z, x | y) and (y, x | z): one stable
              sort of the packed int64 key each, with the indices
  kl_evals    the six directional ``gaussian_kl`` calls on shifted rows
  kl_gathers  the per-axis segment gathers (the identity and two
              permutations)
  kl_scatter  the six inverse-permutation scatter-sets back to segment
              order

The payload sorts over [B, n] (``sortN``): an N-operand stable sort with
min(2, N) keys, the rest riding as payload, as the port sorts (one sort
of the packed key, then a gather a payload column).

The JAX script's segment-sum (``pallas``, ``xla``, ``none``) and moment
kernel modes are not ported (``kernel_ab.py`` and ``chip_smoke.py`` time
K1-K3 against their plain versions), nor its TPU probe kernels.

Prints ``{"metric": "kernel_micro_ms", "mode": ..., "ms_per_batch": ...}``
with the JAX script's keys (``raw_ms_per_batch`` equals ``ms_per_batch``
and ``rtt_ms`` is 0: nothing is subtracted) and the device; times are
medians of ``--inner`` runs x ``--iters`` calls (``_timing.py``).
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ndtpu_torch.core.kl import _pack_pair, gaussian_kl, neighbor_min_kl
from ndtpu_torch.scripts._timing import add_timing_flags, device_name, measure
from ndtpu_torch.utils.device import resolve_device

MODES = ("kl_full", "kl_sorts", "kl_evals", "kl_gathers", "kl_scatter",
         "sort1", "sort2", "sort7")


def kl_inputs(rng, batch: int, k: int, device):
    """The KL stage's inputs as the JAX script draws them: (zyx [B, K, 3]
    int32 sorted with INT32_MAX padding, means [B, K, 3], covs [B, K, 3,
    3], counts [B, K] int32, lens [B, 3], two permutations of K)."""
    kv = int(k * 0.91)
    g = 40
    imax = np.iinfo(np.int32).max
    zyx = np.full((batch, k, 3), imax, np.int32)
    means = np.zeros((batch, k, 3), np.float32)
    covs = np.zeros((batch, k, 3, 3), np.float32)
    counts = np.zeros((batch, k), np.int32)
    for b in range(batch):
        lin = np.sort(rng.choice(g * g * g, size=kv, replace=False))
        z, rem = lin // (g * g), lin % (g * g)
        y, x = rem // g, rem % g
        zyx[b, :kv] = np.stack([z, y, x], axis=1)
        means[b, :kv] = (np.stack([x, y, z], axis=1) + 0.5
                         + rng.normal(scale=0.1, size=(kv, 3)))
        a = rng.normal(scale=0.3, size=(kv, 3, 3)).astype(np.float32)
        covs[b, :kv] = a @ a.transpose(0, 2, 1) + 0.05 * np.eye(3)
        counts[b, :kv] = rng.integers(2, 60, size=kv)
    perms = [rng.permutation(k).astype(np.int64) for _ in range(2)]
    lens = np.tile(np.array([g, g, g], np.int32), (batch, 1))
    t = [torch.from_numpy(a).to(device)
         for a in (zyx, means, covs, counts, lens)]
    return (*t, [torch.from_numpy(p).to(device) for p in perms])


def kl_fn(mode: str, zyx, means, covs, counts, lens, perms):
    """The ``kl_*`` mode's function of no arguments."""
    k = means.shape[1]
    if mode == "kl_full":
        return lambda: neighbor_min_kl(means, covs, counts, zyx, lens)
    if mode == "kl_sorts":
        z, y, x = zyx.long().unbind(-1)
        lx = lens[:, 0:1].long()

        def sorts():
            out = []
            for major, minor in ((_pack_pair(z, x, lx), y),
                                 (_pack_pair(y, x, lx), z)):
                out.append(torch.sort((major << 32) | minor, dim=-1,
                                      stable=True))
            return out
        return sorts
    if mode == "kl_evals":
        def evals():
            tot = torch.zeros(means.shape[0], k - 3, device=means.device)
            for shift in (1, 2, 3):  # 3 axes x 2 directions
                ka, _ = gaussian_kl(means[:, :-shift], covs[:, :-shift],
                                    means[:, shift:], covs[:, shift:])
                kb, _ = gaussian_kl(means[:, shift:], covs[:, shift:],
                                    means[:, :-shift], covs[:, :-shift])
                tot += (torch.nan_to_num(ka[:, :k - 3])
                        + torch.nan_to_num(kb[:, :k - 3]))
            return tot
        return evals
    if mode == "kl_gathers":
        idx = [torch.arange(k, device=means.device), *perms]

        def gathers():
            tot = torch.zeros(means.shape[0], device=means.device)
            for p in idx:
                a, b = p[:-1], p[1:]
                tot += (means[:, a].sum((1, 2)) + means[:, b].sum((1, 2))
                        + covs[:, a].sum((1, 2, 3)) + covs[:, b].sum((1, 2, 3))
                        + counts[:, a].sum(1) + counts[:, b].sum(1))
            return tot
        return gathers

    def scatter():  # kl_scatter
        tot = torch.zeros(means.shape[0], device=means.device)
        for p in perms:
            for col in range(3):
                out = torch.full((means.shape[0], k), float("inf"),
                                 device=means.device)
                out[:, p] = means[:, :, col]
                tot += torch.where(torch.isfinite(out), out, 0.0).sum(1)
        return tot
    return scatter


def sort_fn(n_ops: int, keys, seg, feats):
    """An ``n_ops``-operand stable sort of [keys, seg, feats...] over the
    last axis with min(2, n_ops) keys: one sort of the key (packed
    keys << 32 | seg for two keys), then a gather of each payload column.
    Returns the sorted first operand's first column, as the JAX mode."""
    payload = [feats[..., i % feats.shape[-1]].contiguous()
               for i in range(max(0, n_ops - 2))]

    def run():
        if n_ops == 1:
            return torch.sort(keys, dim=-1, stable=True).values[:, :1]
        packed = (keys.long() << 32) | seg.long()
        skey, order = torch.sort(packed, dim=-1, stable=True)
        for p in payload:
            torch.gather(p, -1, order)
        return (skey >> 32)[:, :1]
    return run


def main(argv=None):
    """Time the mode as the flags say; prints and returns the JSON
    line's dict."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--n", type=int, default=70000)
    p.add_argument("--f", type=int, default=42)
    p.add_argument("--k", type=int, default=1209)
    p.add_argument("--mode", type=str, default="kl_full", choices=MODES)
    p.add_argument("--k_max", type=int, default=1208,
                   help="padded K of the kl_* modes (max_segments(1000))")
    add_timing_flags(p, inner=32)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    feats = rng.normal(size=(args.batch, args.n, args.f)).astype(np.float32)
    seg = np.sort(rng.integers(0, args.k, size=(args.batch, args.n)), axis=1)
    for b in range(args.batch):  # dense ranks 0..distinct-1
        _, seg[b] = np.unique(seg[b], return_inverse=True)
    seg = seg.astype(np.int32)

    if args.mode.startswith("kl"):
        fn = kl_fn(args.mode, *kl_inputs(rng, args.batch, args.k_max, dev))
    else:
        keys = rng.integers(0, 1 << 20, size=(args.batch, args.n)).astype(np.int32)
        fn = sort_fn(int(args.mode[4:]), torch.from_numpy(keys).to(dev),
                     torch.from_numpy(seg).to(dev),
                     torch.from_numpy(feats).to(dev))
    t = measure(fn, dev, args.inner, args.iters)
    out = {"metric": "kernel_micro_ms", "mode": args.mode, "block": "default",
           "ms_per_batch": t["ms"], "raw_ms_per_batch": t["ms"],
           "rtt_ms": 0.0, "call_ms": t["call_ms"], "batch": args.batch,
           "n": args.n, "k_max": args.k_max, "runs": t["runs"],
           "device": device_name(dev)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
