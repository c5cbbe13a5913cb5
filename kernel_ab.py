#!/usr/bin/env python3
"""Time two builds of the port's segment kernels in turns on one NVIDIA card.

    python3 kernel_ab.py --parent PATH/segment_moments.cu [--out FILE.json]

Builds ndtpu_torch/csrc/segment_moments.cu ("new") and the source at
``--parent`` ("parent": that file of an earlier commit, unpacked with
``git archive`` into a directory that .gitignore lists) with nvcc and
``-Xptxas -v`` (it prints their register and spill lines), binds both
libraries' C entries and times them on the same inputs, in turns parent,
new, new, parent, under chip_smoke.time_ms's dirty L2 flush (writing
256 MB) and under a clean one (reading them):

- K2 (ndtpu_segment_sum) at the giant oracle ([1048576, 14] -> [2504, 14],
  the sorted giant cloud's moment columns), at the canonical batch with 28
  class slots ([16, 70000, 41] -> [16, 1209, 41]) and at F = 32 (random
  columns on the giant oracle's ids), each beside a read floor (torch.sum
  over the bytes its bound counts) under both flushes;
- K1 (ndtpu_segment_moments) at the canonical batch and the giant moment
  pass, K3 (ndtpu_segment_tags) at the giant pair keys.

Each new K2 output is held within twice segment_sum_error_bound of the
float64 plain version; the largest difference between the two builds'
outputs is printed for every input. Run from the repository root; needs
one card. Writes the numbers to ``--out`` as JSON.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from ndtpu_torch.data.synthetic import giant_cloud, make_batch
from ndtpu_torch.ops import _build
from ndtpu_torch.ops import segment_moments as sm
from ndtpu_torch.parallel import mesh
from ndtpu_torch.parallel import point_sharded as ps

ORDER = ("parent", "new", "new", "parent")


def build(src: Path, name: str, *flags: str):
    out = _build.BUILD_DIR.parent / "kernel_ab" / f"{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    log = _build.compile_source(src, out, *flags)
    return ctypes.CDLL(str(out)), log


def checked(err):
    if err != 0:
        raise RuntimeError(f"kernel launch failed: CUDA error {err}")


def k2_call(lib, feats, seg, k):
    fn = sm.bind(lib, "ndtpu_segment_sum")
    n, f = feats.shape[-2:]
    out = torch.empty(tuple(seg.shape[:-1]) + (k, f), device="cuda")

    def call():
        checked(fn(seg.data_ptr(), feats.data_ptr(), seg.numel() // n, n, f, k,
                   out.data_ptr(), torch.cuda.current_stream().cuda_stream))
        return out
    return call


def k1_call(lib, x):
    fn = sm.bind(lib, "ndtpu_segment_moments")
    seg, tags, slots, k = x["seg"], x["tags"], x["slots"], x["k"]
    n = seg.shape[-1]
    out = torch.empty(tuple(seg.shape[:-1]) + (k, 13 + slots + len(tags)),
                      device="cuda")
    ptrs = (ctypes.c_void_p * max(1, len(tags)))(*[t.data_ptr() for t in tags])

    def call():
        checked(fn(seg.data_ptr(), x["xt"].data_ptr(), x["yt"].data_ptr(),
                   x["zt"].data_ptr(), x["v"].data_ptr(),
                   x["cls"].data_ptr() if slots else None, ptrs, len(tags),
                   seg.numel() // n, n, k, slots, out.data_ptr(),
                   torch.cuda.current_stream().cuda_stream))
        return out
    return call


def k3_call(lib, seg, tags, k):
    fn = sm.bind(lib, "ndtpu_segment_tags")
    out = torch.empty((k, len(tags)), device="cuda")
    ptrs = (ctypes.c_void_p * len(tags))(*[t.data_ptr() for t in tags])

    def call():
        checked(fn(seg.data_ptr(), ptrs, len(tags), seg.shape[0], k,
                   out.data_ptr(), torch.cuda.current_stream().cuda_stream))
        return out
    return call


def inputs():
    """(label, kernel, args, moved bytes or None) at the real shapes."""
    real = cs.canonical_inputs(torch.from_numpy(make_batch(cs.B, cs.N, seed=0)).cuda())
    points = torch.from_numpy(giant_cloud(cs.GIANT_N, seed=0)).cuda()
    group = mesh.make_group("cuda")
    try:
        state = ps.make_point_sharded_downsample(cs.GIANT_M, group=group,
                                                 search="probe")(points)[4]
    finally:
        mesh.release_group()
    oracle, mseg = cs.giant_oracle_inputs(points, state)
    batch, bseg, bk = cs.batch_sum_inputs(real)
    wide = torch.from_numpy(np.random.default_rng(32).normal(
        size=(cs.GIANT_N, 32)).astype(np.float32)).cuda()
    tseg, tags = cs.giant_pair_inputs(points, state)

    def moved(feats, seg, k):
        kept = int((seg < k).sum())
        clouds = seg.numel() // seg.shape[-1]
        return cs.bound(kept, 4 * feats.shape[-1],
                        4 * clouds * k * feats.shape[-1], 0)[2]

    return [
        ("K2 giant oracle F=14", "k2", (oracle, mseg, cs.GIANT_K),
         moved(oracle, mseg, cs.GIANT_K)),
        ("K2 canonical batch F=41", "k2", (batch, bseg, bk), moved(batch, bseg, bk)),
        ("K2 giant ids F=32", "k2", (wide, mseg, cs.GIANT_K),
         moved(wide, mseg, cs.GIANT_K)),
        ("K1 canonical batch", "k1", (real,), None),
        ("K1 giant moment pass", "k1", (cs.giant_k1_inputs(points, state),), None),
        ("K3 giant pair keys", "k3", (tseg, tags, cs.GIANT_K), None),
    ]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    new_src = Path(_build.__file__).resolve().parent.parent / "csrc" / sm.SOURCE
    libs, ptxas = {}, {}
    for name, src in (("parent", args.parent), ("new", new_src)):
        libs[name], log = build(src, name, "-Xptxas", "-v")
        ptxas[name] = [line.strip() for line in log.splitlines()
                       if "Compiling entry" in line or "registers" in line
                       or "spill" in line]
        print(f"{name} ptxas:\n" + "\n".join(ptxas[name]))
    makers = {"k1": k1_call, "k2": k2_call, "k3": k3_call}
    results = []
    for label, kind, xs, nbytes in inputs():
        calls = {v: makers[kind](lib, *xs) for v, lib in libs.items()}
        outs = {v: calls[v]().clone() for v in libs}
        torch.cuda.synchronize()
        diff = float((outs["new"] - outs["parent"]).abs().max())
        if kind == "k2":
            feats, seg, k = xs
            ref64 = sm.segment_sum_sorted_plain(feats.double(), seg, k)
            bound = sm.segment_sum_error_bound(feats, seg, k)
            if not bool(((outs["new"].double() - ref64).abs() <= 2 * bound).all()):
                raise AssertionError(f"{label}: new build beyond its f32 bound")
        row = {"label": label, "max_diff_new_vs_parent": diff}
        for flush, clean in (("dirty", False), ("clean", True)):
            row[flush] = [cs.time_ms(calls[v], clean=clean) for v in ORDER]
            if nbytes:
                buf = torch.ones(nbytes // 4, device="cuda")
                row[f"read_floor_{flush}"] = cs.time_ms(buf.sum, clean=clean)
                del buf
        print(f"{label}: " + "; ".join(
            f"{flush} " + " / ".join(f"{t:.4f}" for t in row[flush])
            + (f" (read floor {row[f'read_floor_{flush}']:.4f})" if nbytes else "")
            for flush in ("dirty", "clean")) + f" ms {'/'.join(ORDER)}; "
            f"max |new - parent| {diff:.3e}")
        results.append(row)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "ptxas": ptxas,
                                        "results": results}, indent=1))
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
