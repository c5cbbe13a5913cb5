"""Micro-benchmark of the moment stage's prep: everything between the
accepted payload sort and the moment kernel (port of
``scripts/prep_micro.py``, every one of its modes).

    python -m ndtpu_torch.scripts.prep_micro --mode prep_full
    python -m ndtpu_torch.scripts.prep_micro --mode cumsum_matmul --blk 512
    python -m ndtpu_torch.scripts.prep_micro --device cpu --batch 2 \\
        --n 4096 --k 64 --inner 2 --iters 1

At [--batch, --n] (16 x 70000) with --k (1256) sorted segments, about 2 %
of the points an INT32_MAX-padded tail, pair-mode keys zy = z len_y + y
(a 40^3 grid, voxel size 0.35, offset -7), inputs drawn from
``numpy.random.default_rng(0)`` as the JAX script draws them:

  prep_full      key decode, boundary flags, the segment-id cumsum, the
                 centre shifts, validity and the tag columns
  prep_matmul    the same, the cumsum as the blocked matmul below
  prep_nocumsum  the same with the segment ids given (elementwise only)
  cumsum         ``torch.cumsum`` over the [B, N] int32 boundary flags
  cumsum_matmul  the blocked cumsum over the [B, N] f32 boundary flags:
                 [B, nb, --blk] @ the upper-triangular ones [blk, blk]
                 (``torch.matmul`` in f32, TF32 off; the JAX script leaves
                 it to XLA, outside any Pallas kernel) plus an exclusive
                 scan of the block sums; exact for totals < 2^24

Prints ``{"metric": "prep_micro_ms", "mode": ..., "ms_per_batch": ...}``
with the JAX script's keys (``blk`` the matmul block; nothing is
subtracted, so ``below_floor`` is false, ``raw_ms_per_batch`` equals
``ms_per_batch`` and ``rtt_ms`` is 0) and the device; times are medians
of ``--inner`` runs x ``--iters`` calls (``_timing.py``).
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ndtpu_torch.scripts._timing import add_timing_flags, device_name, measure
from ndtpu_torch.utils.device import resolve_device

MODES = ("prep_full", "prep_matmul", "prep_nocumsum", "cumsum",
         "cumsum_matmul")
_INT_MAX = np.iinfo(np.int32).max


def upper_ones(blk: int, device):
    """The [blk, blk] f32 upper-triangular ones U[i, j] = (i <= j)."""
    return torch.triu(torch.ones(blk, blk, device=device))


def matmul_cumsum(flags, upper):
    """Inclusive cumsum of [B, N] f32 0/1 flags along N as a blocked
    matmul: the padded flags as [B, nb, blk] blocks times ``upper_ones(blk)``
    give each block's inclusive sums; the exclusive scan of the block sums
    is added. Exact in f32 for totals < 2^24 where the product runs in f32
    (TF32 off on the card)."""
    b, n = flags.shape
    blk = upper.shape[0]
    nb = -(-n // blk)
    blocks = torch.nn.functional.pad(flags, (0, nb * blk - n)).view(b, nb, blk)
    within = torch.matmul(blocks, upper)
    sums = within[..., -1]
    carry = torch.cumsum(sums, dim=-1) - sums
    return (within + carry[..., None]).view(b, nb * blk)[:, :n]


def segment_ids(zy, xk, k, seg_pre=None, upper=None):
    """(validity, boundary flags, segment ids) of sorted [B, N] pair keys
    (zy, x): the ids from ``torch.cumsum`` of the flags, from
    ``matmul_cumsum`` with ``upper``, or ``seg_pre`` as given; ids of the
    invalid tail and >= k are k."""
    valid = zy != _INT_MAX
    new_seg = torch.ones_like(valid)
    new_seg[:, 1:] = (zy[:, 1:] != zy[:, :-1]) | (xk[:, 1:] != xk[:, :-1])
    new_seg &= valid
    if seg_pre is not None:
        seg = seg_pre
    elif upper is None:
        seg = torch.cumsum(new_seg, dim=-1, dtype=torch.int32) - 1
    else:
        seg = matmul_cumsum(new_seg.float(), upper).int() - 1
    return valid, new_seg, torch.where(valid & (seg < k) & (seg >= 0), seg, k)


def prep(zy, xk, px, py, pz, vs, off, ln, k, seg_pre=None, upper=None):
    """The prep of sorted [B, N] pair keys (zy, x) and coordinates: the
    sum of its outputs. ``seg_pre`` given: the segment ids are taken, not
    cumsummed; ``upper`` given: cumsummed by ``matmul_cumsum``."""
    valid, new_seg, seg = segment_ids(zy, xk, k, seg_pre, upper)
    ly = ln[:, 1:2]
    z = torch.where(valid, zy // ly, _INT_MAX)
    y = torch.where(valid, zy % ly, _INT_MAX)

    def centre(c, axis):
        return ((torch.where(valid, c, 0).float() + 0.5) * vs[:, None]
                + off[:, axis:axis + 1])

    xt = torch.where(valid, px - centre(xk, 0), 0.0)
    yt = torch.where(valid, py - centre(y, 1), 0.0)
    zt = torch.where(valid, pz - centre(z, 2), 0.0)
    tags = sum(torch.where(new_seg, c, 0).float() for c in (z, y, xk))
    return (xt.sum() + yt.sum() + zt.sum() + valid.float().sum()
            + tags.sum() + seg.sum().float())


def main(argv=None):
    """Time the mode as the flags say; prints and returns the JSON
    line's dict."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--n", type=int, default=70000)
    p.add_argument("--k", type=int, default=1256)
    p.add_argument("--mode", default="prep_full", choices=MODES)
    p.add_argument("--blk", type=int, default=512,
                   help="block length of the matmul cumsum")
    add_timing_flags(p, inner=32)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False  # the matmul cumsum in f32

    rng = np.random.default_rng(0)
    b, n, k = args.batch, args.n, args.k
    len_x = 40
    seg_np = np.sort(rng.integers(0, k, size=(b, n)), axis=1)
    tail = np.arange(n)[None, :] >= int(n * 0.98)
    zy = np.where(tail, _INT_MAX, (seg_np // len_x).astype(np.int32))
    xk = np.where(tail, _INT_MAX, (seg_np % len_x).astype(np.int32))
    pts = rng.normal(size=(3, b, n)).astype(np.float32) * 5.0

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    if args.mode == "cumsum":
        flags = np.pad(seg_np[:, 1:] != seg_np[:, :-1], ((0, 0), (1, 0)))
        flags = put(flags.astype(np.int32))

        def fn():
            return torch.cumsum(flags, dim=1, dtype=torch.int32).sum()
    elif args.mode == "cumsum_matmul":
        flags = np.pad(seg_np[:, 1:] != seg_np[:, :-1], ((0, 0), (1, 0)))
        flags = put(flags.astype(np.float32))

        upper = upper_ones(args.blk, dev)

        def fn():
            return matmul_cumsum(flags, upper).sum()
    else:
        args_ = (put(zy.astype(np.int32)), put(xk.astype(np.int32)),
                 put(pts[0]), put(pts[1]), put(pts[2]),
                 torch.full((b,), 0.35, device=dev),
                 torch.full((b, 3), -7.0, device=dev),
                 torch.full((b, 3), len_x, dtype=torch.int32, device=dev))
        seg_pre = (put(seg_np.astype(np.int32))
                   if args.mode == "prep_nocumsum" else None)
        upper = (upper_ones(args.blk, dev) if args.mode == "prep_matmul"
                 else None)

        def fn():
            return prep(*args_, k, seg_pre, upper)
    t = measure(fn, dev, args.inner, args.iters)
    out = {"metric": "prep_micro_ms", "mode": args.mode, "blk": args.blk,
           "ms_per_batch": t["ms"], "below_floor": False,
           "raw_ms_per_batch": t["ms"], "rtt_ms": 0.0,
           "call_ms": t["call_ms"], "batch": b, "n": n, "k": k,
           "runs": t["runs"], "device": device_name(dev)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
