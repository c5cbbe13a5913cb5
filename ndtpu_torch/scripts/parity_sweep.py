"""Resumable multi-seed runner of the parity experiment (port of
``scripts/parity_sweep.py``).

    python -m ndtpu_torch.scripts.parity_sweep --device cpu \\
        --tasks classification --seeds 0,1,2

Runs ``python -m ndtpu_torch.tools.parity_train`` once a (task, seed)
with the fixed protocol (classification: 60 epochs, 128 train / 64 test;
segmentation: 30 epochs, 64 train / 32 test; both at n_desired_nds 1000,
Adam 1e-3, the reference's init carried into the port), each writing one
JSON into ``--outdir``: a (task, seed) whose JSON exists is skipped, so
an interrupted sweep resumes where it stopped. Then it aggregates each
task into ``<outdir>/parity_<task>.json``: mean and standard error per
side, and over the seed pairs an exact two-sided sign test and a paired
t test. The reference's model code must be where
``interop/reference_loader.py`` looks for it (parity_train raises
otherwise).
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import math
import os
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PROTOCOL = {
    "classification": ["--epochs", "60", "--train_size", "128",
                       "--test_size", "64", "--n_desired_nds", "1000"],
    "segmentation": ["--task", "segmentation", "--epochs", "30",
                     "--train_size", "64", "--test_size", "32",
                     "--n_desired_nds", "1000"],
}
SIDES = ("ndtpu_torch", "torch_reference")


def run_parity(argv):
    """One parity_train run with ``argv`` in a process of its own (the
    sweep's --jobs run side by side). Raises if it fails."""
    r = subprocess.run([sys.executable, "-m", "ndtpu_torch.tools.parity_train",
                        *argv], cwd=REPO, capture_output=True, text=True)
    if r.returncode != 0:
        print(r.stdout[-2000:], file=sys.stderr)
        print(r.stderr[-4000:], file=sys.stderr)
        raise RuntimeError(f"parity_train {' '.join(argv)} failed")


def run_seed(task, seed, outdir, eval_every, device, wide_test_size=0,
             save_finals=False):
    """The (task, seed) run's JSON path, running it unless it exists."""
    out = os.path.join(outdir, f"{task}_{seed}.json")
    if os.path.exists(out):
        print(f"[sweep] {task} seed {seed}: exists, skipping", flush=True)
        return out
    # a pid-unique temporary file: concurrent sweeps never share one
    tmp = f"{out}.tmp{os.getpid()}"
    argv = [*PROTOCOL[task], "--seed", str(seed), "--eval_every",
            str(eval_every), "--device", device, "--out", tmp]
    if wide_test_size:
        argv += ["--wide_test_size", str(wide_test_size)]
    if save_finals:
        fdir = os.path.join(outdir, "finals")
        os.makedirs(fdir, exist_ok=True)
        argv += ["--save_finals", os.path.join(fdir, f"{task}_{seed}")]
    t0 = time.time()
    print(f"[sweep] {task} seed {seed}: running ...", flush=True)
    run_parity(argv)
    os.rename(tmp, out)
    with open(out) as f:
        d = json.load(f)
    print(f"[sweep] {task} seed {seed}: ndtpu_torch "
          f"{d['ndtpu_torch']['test_accuracy']:.4f} torch "
          f"{d['torch_reference']['test_accuracy']:.4f} "
          f"({time.time() - t0:.0f}s)", flush=True)
    return out


def sign_test_p(wins, losses):
    """Exact two-sided binomial sign test (ties dropped)."""
    n = wins + losses
    if n == 0:
        return 1.0
    k = min(wins, losses)
    tail = sum(math.comb(n, i) for i in range(k + 1)) / 2.0 ** n
    return min(1.0, 2.0 * tail)


def paired_stats(j, t):
    """Mean and standard error per side, the exact sign test and a paired
    t test over the seed pairs (the port's accuracies ``j``, the
    reference's ``t``)."""
    n = len(j)
    mean_j, mean_t = sum(j) / n, sum(t) / n

    def sd(xs, m):
        return math.sqrt(sum((x - m) ** 2 for x in xs) / max(n - 1, 1))

    diffs = [a - b for a, b in zip(j, t)]
    mean_d = sum(diffs) / n
    sd_d = sd(diffs, mean_d)
    wins = sum(d > 0 for d in diffs)
    losses = sum(d < 0 for d in diffs)
    t_stat = mean_d / (sd_d / math.sqrt(n)) if sd_d > 0 else 0.0
    try:
        from scipy import stats as _st
        t_p = float(2.0 * _st.t.sf(abs(t_stat), n - 1))
    except ImportError:
        t_p = math.erfc(abs(t_stat) / math.sqrt(2.0))  # normal approximation
    return {
        "mean": {"ndtpu_torch": mean_j, "torch": mean_t},
        "stderr": {"ndtpu_torch": sd(j, mean_j) / math.sqrt(n),
                   "torch": sd(t, mean_t) / math.sqrt(n)},
        "paired_diff": {"mean": mean_d, "stderr": sd_d / math.sqrt(n)},
        "sign_test": {"ndtpu_torch_wins": wins, "torch_wins": losses,
                      "two_sided_p": sign_test_p(wins, losses)},
        "paired_t_test": {"t": t_stat, "two_sided_p": t_p},
    }


def aggregate(task, outdir):
    """Aggregate the task's seed JSONs in ``outdir`` into
    ``<outdir>/parity_<task>.json``. Returns the result (None without
    seeds)."""
    seeds, wide_n = {}, 0
    for fn in sorted(os.listdir(outdir)):
        if not (fn.startswith(task + "_") and fn.endswith(".json")):
            continue
        with open(os.path.join(outdir, fn)) as f:
            d = json.load(f)
        seed = fn[len(task) + 1:-5]
        seeds[seed] = {f"{side}_test_accuracy": d[side]["test_accuracy"]
                       for side in SIDES}
        wide = [d[side].get("test_accuracy_wide") for side in SIDES]
        if None not in wide:
            for side, w in zip(SIDES, wide):
                seeds[seed][f"{side}_test_accuracy_wide"] = w
            wide_n = max(wide_n, d.get("wide_test_size", 0))
    if not seeds:
        return None
    j = [v["ndtpu_torch_test_accuracy"] for v in seeds.values()]
    t = [v["torch_reference_test_accuracy"] for v in seeds.values()]
    stats = paired_stats(j, t)
    result = {"task": task,
              "protocol": "python -m ndtpu_torch.tools.parity_train "
                          + " ".join(PROTOCOL[task]),
              "n_seeds": len(j), "seeds": seeds, **stats}
    pairs = [(v["ndtpu_torch_test_accuracy_wide"],
              v["torch_reference_test_accuracy_wide"])
             for v in seeds.values() if "ndtpu_torch_test_accuracy_wide" in v]
    if pairs:
        jw, tw = zip(*pairs)
        result["wide"] = {"test_size": wide_n, "n_seeds": len(jw),
                          **paired_stats(list(jw), list(tw))}
    with open(os.path.join(outdir, f"parity_{task}.json"), "w") as f:
        json.dump(result, f, indent=1)
        f.write("\n")
    print(f"[sweep] {task}: n={len(j)} ndtpu_torch "
          f"{stats['mean']['ndtpu_torch']:.4f}+-"
          f"{stats['stderr']['ndtpu_torch']:.4f} torch "
          f"{stats['mean']['torch']:.4f}+-{stats['stderr']['torch']:.4f} "
          f"diff {stats['paired_diff']['mean']:+.4f}+-"
          f"{stats['paired_diff']['stderr']:.4f} sign-test "
          f"p={stats['sign_test']['two_sided_p']:.3f}", flush=True)
    return result


def main(argv=None):
    """Run and aggregate the sweep as the flags say. Returns {task:
    aggregate}."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--tasks", default="segmentation,classification")
    ap.add_argument("--seeds", default="0,1,2,3,4,5,6,7,8,9")
    ap.add_argument("--outdir", default=os.path.join(REPO, "build",
                                                     "parity_sweep"))
    ap.add_argument("--eval_every", type=int, default=5)
    ap.add_argument("--jobs", type=int, default=1,
                    help="(task, seed) runs side by side")
    ap.add_argument("--wide_test_size", type=int, default=0,
                    help="forwarded to parity_train: the final model also "
                         "evaluated on this many test clouds")
    ap.add_argument("--save_finals", action="store_true",
                    help="both sides' final weights per seed under "
                         "<outdir>/finals/")
    ap.add_argument("--aggregate_only", action="store_true")
    ap.add_argument("--device", type=str, default="cuda",
                    help="the port side's device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)
    tasks = args.tasks.split(",")
    unknown = set(tasks) - set(PROTOCOL)
    if unknown:
        ap.error(f"unknown task(s) {sorted(unknown)}")
    seeds = [int(s) for s in args.seeds.split(",")]
    if not args.aggregate_only:
        lock = threading.Lock()

        def one(ts):
            task, seed = ts
            run_seed(task, seed, args.outdir, args.eval_every, args.device,
                     args.wide_test_size, args.save_finals)
            with lock:
                aggregate(task, args.outdir)

        work = [(task, seed) for task in tasks for seed in seeds]
        with cf.ThreadPoolExecutor(max_workers=max(1, args.jobs)) as ex:
            for _ in ex.map(one, work):
                pass
    return {task: aggregate(task, args.outdir) for task in tasks}


if __name__ == "__main__":
    main(sys.argv[1:])
