"""Full evaluations a cold search spends, seeded by the subsampled
occupancy probe against the exact count (port of
``scripts/probe_seed_validate.py``).

    python -m ndtpu_torch.scripts.probe_seed_validate
    python -m ndtpu_torch.scripts.probe_seed_validate --device cpu \\
        --clouds 4 --n_samples 4096 --n_desired_nds 256

The fast search's evaluation 0 counts the cloud's occupied voxels at the
geometric-mean seed with a full sort; the probe replaces that count with
an estimate from every f-th point (``--factors``) and steers the same
secant trajectory, whose later full evaluations still decide acceptance.
The figure of merit is the number of full evaluations until a count lands
in [n, 1.2 n]: the exact-seeded trajectory (its evaluation 0 included)
against the probe-seeded one. Estimators: ``pair`` (two subsample
depths), ``chao`` (Chao1 from the subsample's singleton and doubleton
voxels, the search's ``"probe"``), ``max`` of the two.

``trajectory`` is the JAX script's replay of the fast search's steering
(numpy only, its own copy); the counts come from the port's
``_count_occupied`` on the card or the CPU, one cloud at a time (the
card gives the CPU's integers). Distributions as ``seed_hit_rate``.

Prints one JSON line with the JAX script's keys (per distribution the
exact mean and, per factor, the probe's mean, its saving and the
estimator's relative error), each cloud's evaluation counts, and the
device.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ndtpu_torch.core import ndt as nd
from ndtpu_torch.scripts._timing import device_name
from ndtpu_torch.scripts.seed_hit_rate import clamped_seed, distributions
from ndtpu_torch.utils.device import resolve_device

MAX_EVALS = 16  # MAX_GUESS_ITERATIONS + 1, as the fused search


def trajectory(count_fn, s0, c0_hat, M, upper, target, lo0, hi0):
    """Replay the fast search's steering with evaluation 0 replaced by
    (s0, c0_hat) (exact when c0_hat is the exact count). Returns (the
    number of FULL evaluations spent until in-band acceptance, whether it
    was accepted)."""
    def ingest(guess, count, lo, hi, best_g, best_c):
        hit = M <= count <= upper
        if count >= M and count < best_c:
            best_g, best_c = guess, count
        if count > upper:
            lo = guess
        elif count < M:
            hi = guess
        return hit, lo, hi, best_g, best_c

    # evaluation 0 steers only: its count may be approximate
    hit0, lo, hi, best_g, best_c = ingest(s0, c0_hat, lo0, hi0,
                                          0.0, float("inf"))
    pg, pc = 0.0, 0.0
    guess, countf = s0, float(c0_hat)
    full_evals = 0
    for it in range(1, MAX_EVALS + 1):
        # secant step in log-log space
        dlog_c = np.log(max(countf, 1.0) / max(pc, 1.0)) if pc > 0 else 0.0
        dlog_g = np.log(pg / guess) if pg > 0 else 0.0
        usable = pg > 0 and abs(dlog_g) > 1e-6 and abs(dlog_c) > 1e-6
        alpha = np.clip(dlog_c / dlog_g, 0.5, 4.0) if usable else 2.0
        ratio = max(countf, 1.0) / target
        secant = guess * ratio ** (1.0 / alpha)
        nxt = secant if lo < secant < hi else lo + (hi - lo) / 2.0
        c = count_fn(nxt)
        full_evals += 1
        hit, lo, hi, best_g, best_c = ingest(nxt, c, lo, hi, best_g, best_c)
        pg, pc, guess, countf = guess, countf, nxt, float(c)
        if hit:
            return full_evals, True
    return full_evals, False


def estimates(cloud, s0: float, mins, maxs, f: int, c0: int):
    """The probe's estimates of the occupied count at ``s0`` from every
    f-th point of ``cloud`` [1, N, 3]: {"pair", "chao", "max"}."""
    def count(sub):
        px, py, pz = (sub[..., a].contiguous() for a in range(3))
        mask = torch.ones(px.shape, dtype=torch.bool, device=px.device)
        size = torch.full((1,), s0, dtype=torch.float32, device=px.device)
        return nd._count_occupied(px, py, pz, mask, size, mins, maxs)

    d_full = int(count(cloud[:, ::f])[0])
    d_half = int(count(cloud[:, ::2 * f])[0])
    su = np.clip(d_full / max(d_half, 1) - 1.0, 0.0, 0.95)
    d_pair = d_full / max(1.0 - su * su, 1e-3)
    # Chao1 from the subsample's occupancy (singletons f1, doubletons f2)
    sub = cloud[:, ::f]
    px, py, pz = (sub[..., a].contiguous() for a in range(3))
    key, _, _ = nd._voxel_keys(
        px, py, pz, torch.ones(px.shape, dtype=torch.bool, device=px.device),
        torch.full((1,), s0, dtype=torch.float32, device=px.device),
        mins, maxs)
    _, counts = np.unique(key.cpu().numpy(), return_counts=True)
    f1, f2 = int((counts == 1).sum()), int((counts == 2).sum())
    d_chao = d_full + (f1 * (f1 - 1)) / (2.0 * (f2 + 1))
    return {"pair": d_pair, "chao": d_chao, "max": max(d_pair, d_chao)}


def run_dist(clouds, n_desired: int, factors, estimator: str, device):
    """The exact- and probe-seeded evaluation counts of each cloud
    [C, N, 3] of one distribution. Returns the JSON entry."""
    upper = int(n_desired * (1.0 + nd.DOWNSAMPLE_UPPER_THRESHOLD))
    target = n_desired * (1.0 + nd.DOWNSAMPLE_UPPER_THRESHOLD / 2.0)
    exact, probed = [], {f: [] for f in factors}
    err = {f: [] for f in factors}
    for c in clouds:
        cloud = torch.from_numpy(c).to(device)[None]
        px, py, pz = (cloud[..., a].contiguous() for a in range(3))
        mask = torch.ones(px.shape, dtype=torch.bool, device=device)
        mins, maxs = nd._limits(px, py, pz, mask)
        env = nd._min_packable_voxel_size(mins, maxs)
        s0 = float(clamped_seed(n_desired, mins, maxs, env)[0])
        lo0 = max(nd.MIN_VOXEL_GUESS, float(env[0]))
        hi0 = max(nd.MAX_VOXEL_GUESS, lo0)

        def count_fn(s):
            size = torch.full((1,), s, dtype=torch.float32, device=device)
            return int(nd._count_occupied(px, py, pz, mask, size, mins,
                                          maxs)[0])

        c0 = count_fn(s0)
        evals, _ = trajectory(count_fn, s0, c0, n_desired, upper, target,
                              lo0, hi0)
        exact.append(1 + evals)  # evaluation 0 was a full sort too
        for f in factors:
            d_hat = estimates(cloud, s0, mins, maxs, f, c0)[estimator]
            err[f].append(d_hat / max(c0, 1) - 1.0)
            probed[f].append(trajectory(count_fn, s0, d_hat, n_desired,
                                        upper, target, lo0, hi0)[0])
    out = {"exact_full_evals_mean": float(np.mean(exact)),
           "exact_full_evals": exact}
    for f in factors:
        errs = np.array(err[f])
        out[f"probe_1_{f}"] = {
            "full_evals_mean": float(np.mean(probed[f])),
            "saved_vs_exact": float(np.mean(exact) - np.mean(probed[f])),
            "estimator_rel_err_mean": float(errs.mean()),
            "estimator_rel_err_sd": float(errs.std()),
            "full_evals": probed[f],
        }
    return out


def main(argv=None):
    """Count the evaluations as the flags say; prints and returns the
    JSON line's dict."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--n_desired_nds", type=int, default=1000)
    p.add_argument("--n_samples", type=int, default=70000)
    p.add_argument("--clouds", type=int, default=16)
    p.add_argument("--factors", default="4,8,16")
    p.add_argument("--estimator", default="chao",
                   choices=["pair", "chao", "max"])
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    factors = [int(f) for f in args.factors.split(",")]
    results = {}
    for name, clouds in distributions(args.clouds, args.n_samples):
        r = run_dist(clouds, args.n_desired_nds, factors, args.estimator, dev)
        results[name] = r
        print(f"[probe] {name}: exact {r['exact_full_evals_mean']:.2f} full "
              "sorts; " + "; ".join(
                  f"1/{f}: {r[f'probe_1_{f}']['full_evals_mean']:.2f}"
                  for f in factors), file=sys.stderr, flush=True)
    results["device"] = device_name(dev)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
