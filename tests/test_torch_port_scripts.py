"""The port's measurement scripts (``python -m ndtpu_torch.scripts.<name>``)
against the JAX repository's ``scripts/*.py``, on the CPU at small sizes.

- Each timing script (stage_timing, model_timing, kernel_micro,
  prep_micro) prints one JSON line with the JAX script's keys and finite
  times on ``--device cpu``; the cumulative stages compute the
  downsample's own KL, and a folded BatchNorm stack the unfolded one's
  outputs.
- seed_hit_rate and probe_seed_validate count what the JAX scripts count
  on the same 4 clouds of 4096 points -> 256 NDs: the hit rates, the mean
  evaluations and the estimators' errors of their JSON lines, and each
  cloud's evaluations through the JAX script's own ``trajectory``.
- collectives at two gloo ranks: the gradient all-reduce moves the
  parameter bytes of JAX's model, the step makes the 66 all-reduces and
  nothing else, the converged point-sharded downsample counts every
  point.
- parity_sweep's sign test and paired statistics equal JAX's on fixed
  inputs; a sweep against the stand-in reference module of
  tests/test_torch_port_parity_tool.py runs only the seed without a JSON
  and aggregates both.
"""
import contextlib
import io
import json
import math
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndtpu.models import NDTNetSegmentation as JaxSegmentation
from ndtpu_torch.core import ndt as nd
from ndtpu_torch.data.synthetic import make_batch
from ndtpu_torch.scripts import (
    collectives,
    kernel_micro,
    model_timing,
    parity_sweep,
    prep_micro,
    probe_seed_validate,
    seed_hit_rate,
    stage_timing,
)
from ndtpu_torch.tools import parity_train

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
import scripts.parity_sweep as jax_sweep  # noqa: E402
import scripts.probe_seed_validate as jax_probe  # noqa: E402
import scripts.seed_hit_rate as jax_seed  # noqa: E402

# the stand-in reference module, beside this file
sys.path.insert(0, str(ROOT / "tests"))
from test_torch_port_parity_tool import REF  # noqa: E402

FAST = ["--device", "cpu", "--inner", "2", "--iters", "1"]


def finite(*values):
    return all(isinstance(v, (int, float)) and math.isfinite(v) for v in values)


# ---- the timing scripts ----

@pytest.mark.parametrize("argv,keys", [
    (["--batch_size", "2", "--n_samples", "2048", "--n_desired_nds", "64"],
     stage_timing.STAGES),
    (["--giant", "--n_samples", "8192", "--n_desired_nds", "128"],
     stage_timing.STAGES),
], ids=["batch", "giant"])
def test_stage_timing_prints_the_jax_keys(argv, keys, capsys):
    out = stage_timing.main(argv + FAST)
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line == out and line["metric"] == "stage_ms_cumulative"
    assert finite(*(line[k] for k in keys)) and line["device"] == "cpu"


def test_stage_prefixes_are_the_downsample():
    """The kl prefix's min and max KL are the downsample's state's (the
    unfused search visits the fused one's sizes)."""
    pts = torch.from_numpy(make_batch(2, 2048, seed=3))
    mn, mx = stage_timing.batch_prefix("kl", pts, 64, 29)
    state = nd.ndt_downsample(pts, 64, num_class_slots=29, search="fast")[4]
    assert torch.equal(mn, state.min_kl) and torch.equal(mx, state.max_kl)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_model_timing_prints_the_jax_keys(dtype, capsys):
    out = model_timing.main(["--batch_size", "2", "--n_desired_nds", "64",
                             "--feature_dim", "32", "--n_classes", "4",
                             "--variants", "flat,fold", "--dtype", dtype]
                            + FAST)
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line == out and line["metric"] == "model_stage_ms"
    assert line["dtype"] == dtype
    keys = model_timing.STAGES + ("backbone_flat", "head_flat",
                                  "backbone_fold", "head_fold")
    assert finite(*(line[k] for k in keys))


def test_folded_stack_is_the_inference_stack():
    torch.manual_seed(0)
    stack = model_timing.DenseBNStack(12, (64, 128, 32), relu=True,
                                      final_dense=5)
    with torch.no_grad():
        for bn in stack.norm:
            bn.running_mean.normal_()
            bn.running_var.uniform_(0.5, 2.0)
            bn.weight.uniform_(0.5, 2.0)
            bn.bias.normal_()
    stack.eval()
    x = torch.randn(2, 40, 12)
    with torch.no_grad():
        torch.testing.assert_close(model_timing.FoldedStack(stack)(x), stack(x),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", kernel_micro.MODES)
def test_kernel_micro_prints_the_jax_keys(mode, capsys):
    out = kernel_micro.main(["--mode", mode, "--batch", "2", "--n", "4096",
                             "--k", "64", "--k_max", "64"] + FAST)
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line == out and line["metric"] == "kernel_micro_ms"
    assert {"mode", "block", "ms_per_batch", "raw_ms_per_batch",
            "rtt_ms"} <= set(line) and line["mode"] == mode
    assert finite(line["ms_per_batch"], line["raw_ms_per_batch"],
                  line["rtt_ms"])


def test_kernel_micro_kl_parts_cover_the_stage():
    """The kl_sorts mode's orders sort its keys, and kl_evals, kl_gathers
    and kl_scatter run on the drawn inputs: finite, but for the
    evaluations that reach the padding rows (zero covariances, an
    undefined KL, which ``nan_to_num`` takes to the largest float and
    the sum of two to inf, as in JAX)."""
    rng = np.random.default_rng(0)
    inputs = kernel_micro.kl_inputs(rng, 2, 64, "cpu")
    zyx, means, covs, counts, lens, perms = inputs
    for (vals, order) in kernel_micro.kl_fn("kl_sorts", *inputs)():
        assert bool((vals[:, 1:] >= vals[:, :-1]).all())
        assert sorted(order[0].tolist()) == list(range(64))
    for mode in ("kl_gathers", "kl_scatter"):
        assert torch.isfinite(kernel_micro.kl_fn(mode, *inputs)()).all()
    valid = int(64 * 0.91)  # the drawn occupied rows
    evals = kernel_micro.kl_fn("kl_evals", *inputs)()
    assert torch.isfinite(evals[:, :valid - 3]).all()
    mn, _ = kernel_micro.kl_fn("kl_full", *inputs)()
    assert bool(torch.isfinite(mn).any())


@pytest.mark.parametrize("mode", prep_micro.MODES)
def test_prep_micro_prints_the_jax_keys(mode, capsys):
    out = prep_micro.main(["--mode", mode, "--batch", "2", "--n", "4096",
                           "--k", "64"] + FAST)
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line == out and line["metric"] == "prep_micro_ms"
    assert {"mode", "blk", "ms_per_batch", "below_floor", "raw_ms_per_batch",
            "rtt_ms"} <= set(line) and line["below_floor"] is False
    assert finite(line["ms_per_batch"], line["raw_ms_per_batch"])


def test_prep_with_given_ids_is_the_prep():
    """prep_nocumsum's given ids are the ids prep_full's cumsum makes."""
    rng = np.random.default_rng(4)
    seg = np.sort(rng.integers(0, 50, (2, 600)), axis=1)
    zy, xk = torch.from_numpy(seg // 40), torch.from_numpy(seg % 40)
    pts = [torch.from_numpy(rng.normal(size=(2, 600)).astype(np.float32))
           for _ in range(3)]
    dense = torch.from_numpy(np.stack([np.unique(r, return_inverse=True)[1]
                                       for r in seg]))
    common = (zy, xk, *pts, torch.full((2,), 0.35), torch.full((2, 3), -7.0),
              torch.full((2, 3), 40, dtype=torch.int32), 64)
    assert torch.equal(prep_micro.prep(*common), prep_micro.prep(*common, dense))


# ---- the counting scripts against the JAX scripts ----

SEED_ARGS = ["--clouds", "4", "--n_samples", "4096", "--n_desired_nds", "256"]


def jax_main(module, argv, monkeypatch):
    """A JAX script's main with ``argv``; returns its JSON line."""
    monkeypatch.setattr(sys, "argv", [module.__file__, *argv])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        module.main()
    return json.loads(buf.getvalue().splitlines()[-1])


def test_seed_hit_rate_counts_as_the_jax_script(monkeypatch, capsys):
    """The hit rates (with 4 clouds: the hit counts) of every distribution,
    cold and warm. The seeds come from log/exp of the extents and the
    searches' steps from log/pow; torch and XLA may round these an ulp
    apart (ROADMAP.md, how to compare), which moves a count only for a
    point on a cell's boundary. None is on these clouds: the rates are
    equal."""
    want = jax_main(jax_seed, SEED_ARGS, monkeypatch)
    got = seed_hit_rate.main(["--device", "cpu", *SEED_ARGS])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == got
    keys = [k for k in want if k != "metric"]
    assert len(keys) == 6
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    for k in keys:
        assert np.mean(got["hits"][k]) == got[k]


def test_probe_seed_validate_counts_as_the_jax_script(monkeypatch):
    """The exact- and probe-seeded evaluation means and the estimators'
    errors (JAX rounds them to 4 digits) of every distribution; each
    cloud's evaluations also through the JAX script's ``trajectory`` on
    the port's counts."""
    want = jax_main(jax_probe, SEED_ARGS, monkeypatch)
    got = probe_seed_validate.main(["--device", "cpu", *SEED_ARGS])
    for dist in ("bench", "clustered", "random"):
        w, g = want[dist], got[dist]
        assert g["exact_full_evals_mean"] == w["exact_full_evals_mean"]
        for f in (4, 8, 16):
            wf, gf = w[f"probe_1_{f}"], g[f"probe_1_{f}"]
            assert gf["full_evals_mean"] == wf["full_evals_mean"], (dist, f)
            assert gf["saved_vs_exact"] == wf["saved_vs_exact"]
            for k in ("estimator_rel_err_mean", "estimator_rel_err_sd"):
                assert round(gf[k], 4) == pytest.approx(wf[k], abs=1e-12)

    clouds = dict(seed_hit_rate.distributions(4, 4096))["random"]
    m, upper, target = 256, int(256 * 1.2), 256 * 1.1
    for c, exact in zip(clouds, got["random"]["exact_full_evals"]):
        cloud = torch.from_numpy(c)[None]
        px, py, pz = (cloud[..., a].contiguous() for a in range(3))
        mask = torch.ones(px.shape, dtype=torch.bool)
        mins, maxs = nd._limits(px, py, pz, mask)
        env = nd._min_packable_voxel_size(mins, maxs)
        s0 = float(seed_hit_rate.clamped_seed(m, mins, maxs, env)[0])
        lo0 = max(nd.MIN_VOXEL_GUESS, float(env[0]))

        def count(s):
            return int(nd._count_occupied(px, py, pz, mask,
                                          torch.tensor([s]), mins, maxs)[0])

        args = (count, s0, count(s0), m, upper, target, lo0,
                max(nd.MAX_VOXEL_GUESS, lo0))
        assert jax_probe.trajectory(*args) == probe_seed_validate.trajectory(*args)
        assert 1 + jax_probe.trajectory(*args)[0] == exact


# ---- collectives ----

def test_collectives_at_two_gloo_ranks():
    b, m, c, f = 4, 32, 4, 32
    dp, ps = collectives.main([
        "--device", "cpu", "--processes", "2", "--batch_size", str(b),
        "--n_samples", "512", "--n_desired_nds", str(m), "--n_classes", str(c),
        "--feature_dim", str(f), "--giant_points", "4096", "--giant_nds",
        "256"])
    variables = JaxSegmentation(num_classes=c, feature_dim=f).init(
        jax.random.PRNGKey(0), jnp.zeros((b, m, 3)), jnp.zeros((b, m, 9)),
        train=False)
    jax_bytes = sum(x.size * x.dtype.itemsize
                    for x in jax.tree_util.tree_leaves(variables["params"]))
    assert dp["devices"] == 2 and set(dp["collectives"]) == {"all_reduce"}
    assert dp["param_bytes"] == dp["gradient_allreduce_bytes"] == jax_bytes
    assert dp["collectives"]["all_reduce"]["count"] == 66
    assert ps["converged"] and ps["counts_sum"] == ps["points"] == 4096
    assert set(ps["collectives"]) == {"all_gather", "all_reduce"}


# ---- parity_sweep ----

def test_parity_sweep_statistics_equal_jax():
    for wins, losses in ((0, 0), (7, 2), (3, 3), (9, 0), (1, 10)):
        assert parity_sweep.sign_test_p(wins, losses) == jax_sweep.sign_test_p(
            wins, losses)
    j = [0.81, 0.79, 0.84, 0.80, 0.83, 0.78, 0.82]
    t = [0.80, 0.80, 0.82, 0.77, 0.83, 0.75, 0.80]
    want, got = jax_sweep.paired_stats(j, t), parity_sweep.paired_stats(j, t)
    rename = {"ndtpu": "ndtpu_torch", "ndtpu_wins": "ndtpu_torch_wins"}
    for group, fields in want.items():
        for k, v in fields.items():
            assert got[group][rename.get(k, k)] == v, (group, k)


def test_parity_sweep_resumes_on_the_stand_in(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(parity_train.reference_loader, "load_reference_module",
                        lambda name, *a, **k: REF)
    monkeypatch.setitem(parity_sweep.PROTOCOL, "segmentation", [
        "--task", "segmentation", "--epochs", "1", "--train_size", "4",
        "--test_size", "4", "--n_samples", "512", "--n_desired_nds", "32",
        "--n_classes", "4", "--feature_dim", "16", "--batch_size", "4"])
    ran = []

    def in_process(argv):
        ran.append(argv[argv.index("--seed") + 1])
        with contextlib.redirect_stdout(io.StringIO()):
            parity_train.main(argv)

    monkeypatch.setattr(parity_sweep, "run_parity", in_process)
    done = {"ndtpu_torch": {"test_accuracy": 0.5},
            "torch_reference": {"test_accuracy": 0.25}}
    (tmp_path / "segmentation_1.json").write_text(json.dumps(done))
    result = parity_sweep.main([
        "--tasks", "segmentation", "--seeds", "0,1", "--outdir",
        str(tmp_path), "--eval_every", "0", "--device", "cpu"])["segmentation"]
    assert ran == ["0"]
    assert "segmentation seed 1: exists, skipping" in capsys.readouterr().out
    seed0 = json.loads((tmp_path / "segmentation_0.json").read_text())
    assert result["n_seeds"] == 2 and result["seeds"]["1"] == {
        "ndtpu_torch_test_accuracy": 0.5, "torch_reference_test_accuracy": 0.25}
    j = [seed0["ndtpu_torch"]["test_accuracy"], 0.5]
    t = [seed0["torch_reference"]["test_accuracy"], 0.25]
    assert result["mean"] == parity_sweep.paired_stats(j, t)["mean"]
    assert json.loads((tmp_path / "parity_segmentation.json").read_text()) == result
