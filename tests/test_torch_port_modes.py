"""The JAX package's bit-identical A/B modes in the port, on the CPU.

- ``NDTPU_KL_MODE`` ("payload", the default, or "gather") and
  ``NDTPU_KL_INV`` ("scatter", the default, or "argsort"; read by the
  gather mode only, as in JAX): the port's ``neighbor_min_kl`` under
  each pair against JAX's under the same pair, on the inputs of
  tests/test_kl.py (its inverse-permutation and payload-vs-gather cases:
  a rank-one covariance and counts of 1, the <= 1-sample gating). Torch's
  einsum rounds in another order than JAX's, so port and JAX agree as in
  tests/test_torch_port_kl.py: the inf pattern and signs exactly, finite
  values to rtol 1e-5 (measured: 3.8e-6 at most). Within each package
  every mode equals its default bit for bit.
- ``NDTPU_EMIT`` ("gather", the default, or "payload"): the port's
  ``_emit`` in payload mode equals its gather mode bit for bit on JAX
  states, for the ascending and the legacy_c prune.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndtpu.core import kl as jk
from ndtpu.core import ndt as jn
from ndtpu_torch.core import kl as tk
from ndtpu_torch.core import ndt as tn

MODES = [("payload", "scatter"), ("payload", "argsort"), ("gather", "scatter"),
         ("gather", "argsort")]


def random_spd(rng):
    a = rng.normal(size=(3, 3))
    return a @ a.T + 0.5 * np.eye(3)


def grid_case(seed, lens, occupancy, extra, min_count, rank_one=False):
    """tests/test_kl.py's draws: occupied cells of a (x, y, z) = lens
    grid, INT32_MAX padding rows, random SPD covariances (row 2 rank one
    if asked), counts from min_count."""
    rng = np.random.default_rng(seed)
    big = np.iinfo(np.int32).max
    cells = np.array([(z, y, x) for z in range(lens[2]) for y in range(lens[1])
                      for x in range(lens[0])], np.int32)
    occ = cells[rng.random(len(cells)) < occupancy]
    kk = len(occ)
    k = kk + extra
    zyx = np.full((k, 3), big, np.int32)
    zyx[:kk] = occ
    means = rng.normal(size=(k, 3)).astype(np.float32)
    covs = np.stack([random_spd(rng) * 0.1 for _ in range(k)]).astype(np.float32)
    if rank_one:
        covs[2] = np.outer([1.0, 2.0, 0.5], [1.0, 2.0, 0.5]).astype(np.float32)
    counts = np.zeros(k, np.int32)
    counts[:kk] = rng.integers(min_count, 20, size=kk)
    return means, covs, counts, zyx, np.asarray(lens, np.int32)


CASES = {
    "inverse_modes": lambda: grid_case(11, (4, 3, 3), 0.6, 2, 2),
    "payload_vs_gather": lambda: grid_case(29, (5, 4, 3), 0.55, 3, 1,
                                           rank_one=True),
}


def set_modes(monkeypatch, mode, inv):
    monkeypatch.setenv("NDTPU_KL_MODE", mode)
    monkeypatch.setenv("NDTPU_KL_INV", inv)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mode,inv", MODES)
def test_neighbor_min_kl_mode_matches_jax_and_the_default(monkeypatch, case,
                                                          mode, inv):
    args = CASES[case]()
    port_args = [torch.from_numpy(a)[None] for a in args]
    monkeypatch.delenv("NDTPU_KL_MODE", raising=False)
    monkeypatch.delenv("NDTPU_KL_INV", raising=False)
    base = tk.neighbor_min_kl(*port_args)
    jbase = jk.neighbor_min_kl(*map(jnp.asarray, args))
    set_modes(monkeypatch, mode, inv)
    assert (tk.kl_mode(), tk.inv_mode()) == (mode, inv)
    got = tk.neighbor_min_kl(*port_args)
    ref = jk.neighbor_min_kl(*map(jnp.asarray, args))
    for g, b, r, jb in zip(got, base, ref, jbase):
        assert torch.equal(g, b)  # the port's mode == its default
        np.testing.assert_array_equal(np.asarray(r), np.asarray(jb))  # JAX's
        g, r = g[0].numpy(), np.asarray(r)
        np.testing.assert_array_equal(np.isinf(g), np.isinf(r))
        np.testing.assert_array_equal(np.sign(g), np.sign(r))
        fin = np.isfinite(r)
        np.testing.assert_allclose(g[fin], r[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("value,mode,inv", [
    ("payload", "payload", "scatter"), ("gather", "gather", "scatter"),
    ("anything", "gather", "scatter"), ("", "gather", "scatter")])
def test_kl_mode_reads_the_variable_as_jax(monkeypatch, value, mode, inv):
    """JAX's tests: exactly "payload" selects payload, anything else
    gather; exactly "scatter" selects scatter, anything else argsort."""
    monkeypatch.setenv("NDTPU_KL_MODE", value)
    monkeypatch.setenv("NDTPU_KL_INV", "scatter" if inv == "scatter" else "x")
    assert (tk.kl_mode(), tk.inv_mode()) == (mode, inv)
    monkeypatch.setenv("NDTPU_KL_INV", "argsort")
    assert tk.inv_mode() == "argsort"


def test_gather_modes_on_a_batch_equal_the_payload_mode(monkeypatch):
    """Three clouds of different occupancy in one [B, K] call."""
    cases = [grid_case(40 + i, (5, 4, 3), 0.5, 2, 1, rank_one=i == 0)
             for i in range(3)]
    k = min(len(c[0]) for c in cases)
    batch = [torch.from_numpy(np.stack([c[i][:k] if i < 4 else c[i]
                                        for c in cases])) for i in range(5)]
    monkeypatch.delenv("NDTPU_KL_MODE", raising=False)
    base = tk.neighbor_min_kl(*batch)
    for inv in ("scatter", "argsort"):
        set_modes(monkeypatch, "gather", inv)
        for g, b in zip(tk.neighbor_min_kl(*batch), base):
            assert torch.equal(g, b)


def clustered(n_centers, per, extent, scale, seed):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-extent, extent, size=(n_centers, 3))
    pts = c[:, None, :] + rng.normal(scale=scale, size=(n_centers, per, 3))
    return pts.reshape(-1, 3).astype(np.float32)


def port_state(js):
    """A single-cloud JAX NDTResult as the port's [1, ...] NDTResult."""
    return tn.NDTResult(**{
        f.name: torch.from_numpy(np.array(getattr(js, f.name)))[None]
        for f in dataclasses.fields(tn.NDTResult)
    })


@pytest.mark.parametrize("prune_order", ["ascending", "legacy_c"])
@pytest.mark.parametrize("tagged", [False, True])
def test_payload_emit_equals_the_gather_emit_on_jax_states(monkeypatch,
                                                           prune_order,
                                                           tagged):
    """The port's emit in both modes on a JAX state (an untagged one, and
    one with 5 class slots), pruned to fewer NDs than it holds and to
    more: equal bit for bit, and equal to JAX's gather emit."""
    pts = clustered(24, 40, 8.0, 0.3, 9)
    kw = {}
    if tagged:
        kw = dict(classes=jnp.asarray(np.arange(len(pts)) % 5, jnp.int32),
                  num_class_slots=5)
    out = jn.ndt_downsample(jnp.asarray(pts), 48, prune_order=prune_order,
                            **kw)
    state = port_state(out[4])
    for n_out in (48, 30, 200):
        monkeypatch.delenv("NDTPU_EMIT", raising=False)
        gather = tn._emit(state, n_out, prune_order)
        monkeypatch.setenv("NDTPU_EMIT", "payload")
        payload = tn._emit(state, n_out, prune_order)
        for g, p in zip(gather, payload):
            assert g.dtype == p.dtype and torch.equal(g, p)
    for e, r in zip(tn._emit(state, 48, prune_order), out[:4]):  # payload
        np.testing.assert_array_equal(e[0].numpy(), np.asarray(r))
