"""Micro-benchmarks of the segment reductions, K1's cost structure, the
KL stage's parts and the payload sorts (port of ``scripts/kernel_micro.py``,
every one of its modes).

    python -m ndtpu_torch.scripts.kernel_micro --mode moments_noflop --slots 29
    python -m ndtpu_torch.scripts.kernel_micro --mode kl_full
    python -m ndtpu_torch.scripts.kernel_micro --device cpu --mode kl_payload \\
        --batch 2 --n 4096 --k 64 --k_max 64 --inner 2 --iters 1

The inputs are built from ``numpy.random.default_rng(0)`` with the JAX
script's calls in its order (features [B, n, f], sorted dense segment
ranks [B, n] over k, then the mode's own), so a seed gives its data.

The segment sum of the features [B, n, f] by the ranks into [B, k, f]:

  pallas      K2, ``ops/segment_moments.py::segment_sum_sorted``
  xla         the library's scatter-add (``Tensor.index_add_`` along the
              segment axis), what ``jax.ops.segment_sum`` computes
  none        the perturbation floor, ``sum(f, 1)[:, None] * 0``

K1's cost structure at K1's launch plan (the JAX script's probe trio), on
the port's layout: [B, n] columns with each cloud's own dense ids, as
``core/ndt.py::_build_state`` feeds K1 (the JAX mode flattens them with
per-cloud id offsets and pads them to its block). The columns are drawn
as the JAX script draws them (xt, yt, zt normal from
``default_rng(2)``, v ones, cls zeros, ``--n_tags`` tag columns xt * 0.5);
``--slots`` class slots:

  moments         K1, ``ops/segment_moments.py::fused_moments_sorted``
  moments_noflop  P2, ``ops/moment_probes.py::moments_noflop``: K1's
                  streaming and row build, each column's total into 8 rows
  moments_empty   P1, ``ops/moment_probes.py::moments_empty``: K1's launch
                  whose body only zeroes the output

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
  kl_payload  the payload rewrite (``kl_payload``): the two re-sorts with
              the 10 moment and count columns riding as one gathered
              payload, the adjacent-row ``gaussian_kl`` pair on each, the
              inverse scatter-sets and the free +-x axis

The payload sorts over [B, n] (``sortN``, N in 1, 2, 4, 5, 7): an
N-operand stable sort with min(2, N) keys, the rest riding as payload, as
the port sorts (one sort of the packed key, then a gather a payload
column).

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

from ndtpu_torch.core.kl import (
    _pack_pair,
    _pair_minmax,
    _sym,
    gaussian_kl,
    neighbor_min_kl,
)
from ndtpu_torch.ops import moment_probes
from ndtpu_torch.ops import segment_moments as sm
from ndtpu_torch.scripts._timing import add_timing_flags, device_name, measure
from ndtpu_torch.utils.device import resolve_device

# the JAX script's choices, in its order
MODES = ("pallas", "xla", "none", "sort1", "sort2", "sort4", "sort5", "sort7",
         "moments", "moments_noflop", "moments_empty", "kl_full", "kl_sorts",
         "kl_evals", "kl_gathers", "kl_scatter", "kl_payload")
MOMENT_KERNELS = {"moments": sm.fused_moments_sorted,
                  "moments_noflop": moment_probes.moments_noflop,
                  "moments_empty": moment_probes.moments_empty}


def segment_inputs(batch: int, n: int, f: int, k: int):
    """The JAX script's first draws from ``default_rng(0)``: (the generator,
    features [B, n, f] f32 normal, sorted dense segment ranks [B, n] int32
    of values drawn from [0, k))."""
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(batch, n, f)).astype(np.float32)
    seg = np.sort(rng.integers(0, k, size=(batch, n)), axis=1)
    for b in range(batch):  # dense ranks 0..distinct-1
        _, seg[b] = np.unique(seg[b], return_inverse=True)
    return rng, feats, seg.astype(np.int32)


def xla_segment_sum(feats, seg, k: int):
    """``jax.ops.segment_sum`` of [B, n, f] rows by [B, n] ids into
    [B, k, f] (ids outside [0, k) dropped): one ``index_add_`` along the
    segment axis of the flat [B k + 1, f] table, row B k taking the
    dropped ids."""
    b, n, f = feats.shape
    flat = seg.long() + k * torch.arange(b, device=seg.device)[:, None]
    flat = torch.where((seg >= 0) & (seg < k), flat, b * k)
    out = torch.zeros(b * k + 1, f, dtype=feats.dtype, device=feats.device)
    out.index_add_(0, flat.reshape(-1), feats.reshape(b * n, f))
    return out[:b * k].reshape(b, k, f)


def probe_inputs(seg, n_tags: int, device):
    """K1's columns as the JAX script's moments modes draw them, [B, n]
    each: xt, yt, zt normal from ``default_rng(2)``, v ones, cls zeros,
    the ranks ``seg`` and ``n_tags`` columns xt * 0.5."""
    rng = np.random.default_rng(2)
    xt, yt, zt = (torch.from_numpy(rng.normal(size=seg.shape).astype(
        np.float32)).to(device) for _ in range(3))
    v = torch.ones(seg.shape, dtype=torch.float32, device=device)
    cls = torch.zeros(seg.shape, dtype=torch.int32, device=device)
    tags = [xt * 0.5 for _ in range(n_tags)]
    return dict(xt=xt, yt=yt, zt=zt, v=v, cls=cls,
                seg=torch.from_numpy(seg).to(device), tags=tags)


def moment_fn(mode: str, x, k: int, slots: int):
    """The ``moments*`` mode's function of no arguments on ``probe_inputs``
    ``x``: its kernel into [B, k, 13 + slots + T]."""
    kernel = MOMENT_KERNELS[mode]
    return lambda: kernel(x["xt"], x["yt"], x["zt"], x["v"], x["cls"],
                          x["seg"], k, slots, tags=x["tags"])


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


def kl_payload(zyx, means, covs, counts, lens):
    """The KL stage as the payload rewrite of the JAX script's
    ``kl_payload`` mode lays it out, with the adjacency masks that make it
    the stage: the K rows re-sorted by (z, x | y) and by (y, x | z), each by
    one stable sort of the packed int64 key, the 10 payload columns (means,
    the 6 covariance entries, counts) riding as one gather; the adjacent-row
    ``gaussian_kl`` pair of each order; the scatter-sets back to segment
    order; the free +-x axis on the rows as they are. Returns the per-axis
    [(min, max) of +-x, +-y, +-z], each [B, K]; the minimum of the mins and
    the maximum of the maxes are ``neighbor_min_kl``'s."""
    z, y, x = zyx.long().unbind(-1)
    lx, ly = lens[:, 0:1].long(), lens[:, 1:2].long()
    c6 = torch.stack([covs[..., 0, 0], covs[..., 0, 1], covs[..., 0, 2],
                      covs[..., 1, 1], covs[..., 1, 2], covs[..., 2, 2]], -1)
    payload = torch.cat([means, c6, counts.float()[..., None]], -1)
    axes = [_pair_minmax(_pack_pair(z, y, ly), x, means, covs, counts)]
    for major, minor in ((_pack_pair(z, x, lx), y), (_pack_pair(y, x, lx), z)):
        key, order = torch.sort((major << 32) | minor, dim=-1, stable=True)
        p = torch.gather(payload, -2, order[..., None].expand_as(payload))
        mn, mx = _pair_minmax(key >> 32, key & 0xFFFFFFFF, p[..., :3],
                              _sym(p[..., 3:9]), p[..., 9])
        axes.append((torch.empty_like(mn).scatter_(-1, order, mn),
                     torch.empty_like(mx).scatter_(-1, order, mx)))
    return axes


def kl_fn(mode: str, zyx, means, covs, counts, lens, perms):
    """The ``kl_*`` mode's function of no arguments."""
    k = means.shape[1]
    if mode == "kl_payload":
        return lambda: kl_payload(zyx, means, covs, counts, lens)
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
    p.add_argument("--slots", type=int, default=1,
                   help="class slots of the moments* modes")
    p.add_argument("--k_max", type=int, default=1208,
                   help="padded K of the kl_* modes (max_segments(1000))")
    p.add_argument("--n_tags", type=int, default=3,
                   help="tag columns of the moments* modes")
    add_timing_flags(p, inner=32)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    rng, feats, seg = segment_inputs(args.batch, args.n, args.f, args.k)
    if args.mode.startswith("kl"):
        fn = kl_fn(args.mode, *kl_inputs(rng, args.batch, args.k_max, dev))
    elif args.mode.startswith("sort"):
        keys = rng.integers(0, 1 << 20, size=(args.batch, args.n)).astype(np.int32)
        fn = sort_fn(int(args.mode[4:]), torch.from_numpy(keys).to(dev),
                     torch.from_numpy(seg).to(dev),
                     torch.from_numpy(feats).to(dev))
    elif args.mode.startswith("moments"):
        fn = moment_fn(args.mode, probe_inputs(seg, args.n_tags, dev), args.k,
                       args.slots)
    else:
        f_d, seg_d = torch.from_numpy(feats).to(dev), torch.from_numpy(seg).to(dev)
        fn = {"pallas": lambda: sm.segment_sum_sorted(f_d, seg_d, args.k),
              "xla": lambda: xla_segment_sum(f_d, seg_d, args.k),
              "none": lambda: torch.sum(f_d, 1)[:, None, :] * 0.0}[args.mode]
    t = measure(fn, dev, args.inner, args.iters)
    out = {"metric": "kernel_micro_ms", "mode": args.mode, "block": "default",
           "ms_per_batch": t["ms"], "raw_ms_per_batch": t["ms"],
           "rtt_ms": 0.0, "call_ms": t["call_ms"], "batch": args.batch,
           "n": args.n, "f": args.f, "k": args.k, "k_max": args.k_max,
           "slots": args.slots, "n_tags": args.n_tags, "runs": t["runs"],
           "device": device_name(dev)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
