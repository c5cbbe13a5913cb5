"""The port's multi-device dry run (``ndtpu_torch.serve.dryrun_multichip``)
against the JAX entry's arithmetic (``__graft_entry__.dryrun_multichip``).

- Two gloo ranks (spawned processes) on the CPU pass the entry's three
  checks with JAX's ``PRNGKey(0)`` weights: the data-parallel loss equals
  the port's single-process loss within the entry's 1e-5 + 1e-5 |loss|,
  and JAX's single-device ``make_ndt_seg_step(12, 4)`` loss on the same
  batch within rtol 1e-9 (equal, on these inputs). The entry holds its
  float64 steps to the JAX bound; its float32 steps, as users train, to
  the bound or the rounding band it measures, whichever is larger (the
  single-process float32 loss's largest move when the weights move by a
  relative 1e-7: the TNets' BatchNorms over the clouds' FC rows amplify
  rounding, serve.py). So JAX's step runs with its model in float64 too
  (under ``jax.enable_x64``), from the same float32 weights widened; its preprocessing runs op by op in float32
  before the jitted step body, since under ``jit`` XLA's FMAs can flip a
  2- or 3-point voxel's KL and so the kept NDs (ROADMAP.md, faults). The
  point-sharded occupied voxels and counts equal a numpy count of the
  cloud's distinct voxel cells at size 1.0.
- One rank on the CPU passes the same checks; its float32 band is
  measured (nonzero) and holds the float32 gap.
- ``run_ranks`` returns results larger than its pipe's buffer.
- A rank that fails fails the call; more ranks than cards raises; without
  a card the entry raises.
"""
import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from __graft_entry__ import _example_cloud
from ndtpu.models import NDTNetSegmentation as JaxSegmentation
from ndtpu.train import loop as jloop
from ndtpu.train.state import TrainState as JaxTrainState
from ndtpu_torch.data.synthetic import example_cloud
from ndtpu_torch.parallel.mesh import run_ranks
from ndtpu_torch.serve import dryrun_multichip

B, N, M, C, F = 4, 128, 12, 4, 32  # the entry's shapes at two ranks


def jax_variables(feature_dim=F):
    """JAX's ``PRNGKey(0)`` variables of the entry's model (its init
    jitted), as numpy."""
    model = JaxSegmentation(num_classes=C, feature_dim=feature_dim)
    v = jax.jit(lambda key: model.init(key, jnp.zeros((B, M, 3)),
                                       jnp.zeros((B, M, 9)), train=False))(
        jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, dict(v))


def jax_single_step_loss(variables, pts, gt, monkeypatch):
    """JAX's single-device ``make_ndt_seg_step(M, C)`` on the whole batch
    with its model in float64 from ``variables`` widened: its jitted step
    body on the preprocessing's outputs, the preprocessing
    (``_make_prep``'s function, float32) run op by op before it."""
    prep = jloop._make_prep(M, C, False, "fast", None, "data")
    with jax.disable_jit():
        pre = prep(jnp.asarray(pts), jnp.asarray(gt))
    monkeypatch.setattr(jloop, "_make_prep", lambda *a: lambda given, _: given)
    with jax.enable_x64(True):
        wide = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                      variables)
        model = JaxSegmentation(num_classes=C, feature_dim=F,
                                dtype=jnp.float64, param_dtype=jnp.float64)
        tx = optax.adam(1e-3)
        state = JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=wide["params"],
            batch_stats=wide["batch_stats"], opt_state=tx.init(wide["params"]),
            tx=tx, apply_fn=model.apply)
        step, _ = jloop.make_ndt_seg_step(M, C)
        return float(step(state, pre, None)[1]["loss"])


def assert_entry_checks(got):
    """The entry's two loss checks, read from what it returns."""
    tol = 1e-5 + 1e-5 * abs(got["single_loss"])
    assert abs(got["loss"] - got["single_loss"]) <= tol
    assert got["band_f32"] > 0 and np.isfinite(got["band_f32"])
    assert abs(got["loss_f32"] - got["single_loss_f32"]) <= max(
        tol, got["band_f32"])


def test_dryrun_on_two_gloo_ranks_matches_jax(monkeypatch):
    pts = _example_cloud(B, N)
    np.testing.assert_array_equal(example_cloud(B, N), pts)
    gt = np.eye(C + 1, dtype=np.float32)[(pts[..., 0] > 0).astype(np.int64) + 1]
    variables = jax_variables()
    # the ranks are processes: JAX's step runs here while they do
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(dryrun_multichip, 2, device="cpu",
                            variables=variables)
        want = jax_single_step_loss(variables, pts, gt, monkeypatch)
        got = ranks.result(timeout=600)

    assert_entry_checks(got)
    np.testing.assert_allclose(got["loss"], want, rtol=1e-9)
    assert np.isfinite(got["multiscale_loss"])
    assert got["counts_sum"] == N
    assert got["launches"] == [{"fused_moments_sorted": 0,
                                "segment_tags_sorted": 0}] * 2  # no card

    # cloud 0's distinct voxel cells at size 1.0 (voxel.c's grid: cells
    # from the minimum, the last one closed)
    flat = pts[0]
    lo, hi = flat.min(0), flat.max(0)
    lens = np.maximum(np.ceil(hi - lo), 1).astype(np.int64)
    cells = np.clip(np.floor(flat - lo).astype(np.int64), 0, lens - 1)
    assert got["num_valid"] == len(np.unique(cells, axis=0))


def test_dryrun_on_one_rank_holds_float32_to_its_rounding_band(capsys):
    got = dryrun_multichip(1, device="cpu")
    assert_entry_checks(got)
    assert got["counts_sum"] == N and np.isfinite(got["multiscale_loss"])
    lines = capsys.readouterr().out.splitlines()
    assert "rounding band" in lines[-2]
    assert lines[-1] == (f"dryrun_multichip(1): loss={got['loss_f32']:.4f}, "
                         f"multiscale loss={got['multiscale_loss']:.4f}, "
                         f"point-sharded voxels={got['num_valid']} ok")


def big_result(rank, n, init_method):
    """A rank's result larger than a pipe's buffer (64 KiB on Linux)."""
    return np.full(1 << 16, rank, np.float64)


def test_run_ranks_returns_results_larger_than_a_pipe():
    got = run_ranks(big_result, 2)
    assert [r.nbytes for r in got] == [1 << 19] * 2
    assert [int(r[0]) for r in got] == [0, 1]


def test_a_failing_rank_fails_the_dryrun():
    """Rank 0 cannot load weights of the wrong width: the call raises, and
    rank 1, waiting for it, is ended."""
    wrong = jax_variables(2 * F)
    with pytest.raises(Exception, match="process 0|shape|size"):
        dryrun_multichip(2, device="cpu", variables=wrong)


def test_dryrun_refuses_more_ranks_than_cards(monkeypatch):
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun_multichip(1)  # no card here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="need 2 cards, have 1"):
        dryrun_multichip(2)
    with pytest.raises(ValueError, match="n_devices"):
        dryrun_multichip(0, device="cpu")
