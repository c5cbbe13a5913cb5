"""The port's multi-process data parallelism on the CPU, against the JAX
package's global-batch arithmetic.

Two real gloo processes (``ndtpu_torch.parallel.mesh.make_data_group`` over a
FileStore in ``tmp_path``) each hold half of a global batch:

- BatchNorm's global statistics against JAX's ``BatchNorm`` on the whole
  batch (train mode, the same parameters): the output and the running
  statistics to rtol / atol 1e-6, the gradients of x, weight and bias to
  rtol 1e-5 (atol 1e-6); without a group the module computes the
  single-process expressions bit for bit.
- One segmentation DP step (B 4 split 2 + 2, N 2048, M 64, 4 classes,
  feature_dim 32) against JAX's segmentation step on the whole batch on
  one device, the weights carried across by ``load_jax_train_state``:
  loss and accuracy within 1e-5, running statistics within rtol 1e-5
  (atol 1e-6), Adam's first moments within 1e-5 where the gradient is not
  noise (``test_torch_port_train.signal``). The model computes in float64
  on both sides (the preprocessing stays float32): in float32 the
  single-process port itself lies up to 3.4e-3 (running statistics) and
  3.4e-2 (first moments) from JAX's jitted step on these clouds, the
  BatchNorms over the TNets' four FC rows amplifying rounding, so float32
  would hide a wrong reduction below its noise. The uneven case keeps 64
  NDs in three clouds and 41 in the fourth, so the mean of the ranks'
  masked means would be wrong. Reference search, clouds without a 2- or
  3-point voxel (asserted), as the single-process tests compare whole
  steps.
- The float32 DP step's collectives, counted at ``torch.distributed``:
  all-reduces only (broadcasts at the state's creation), their bytes within
  ``[param_bytes, 1.15 param_bytes + 4096]`` (tests/test_collectives.py);
  the preprocessing issues none.
- ``batch_iterator``'s per-process slices against the JAX loader's, the
  sharded ``DeviceCachedDataset``'s block and ``sharded_batch``.

Each worker creates and destroys its group. The trainers' two-process
runs are in tests/test_torch_port_dp_cli.py.
"""
import os
import pathlib
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ndtpu.data.loader import batch_iterator as jax_batch_iterator
from ndtpu.models import NDTNetSegmentation as JaxSegmentation
from ndtpu.models.norm import BatchNorm as JaxBatchNorm
from ndtpu.preprocessing.batch import ndt_preprocessing_with_state as jax_prep
from ndtpu.train import loop as jloop
from ndtpu.train.state import create_train_state as jax_create_train_state
from ndtpu_torch.data.loader import batch_iterator, epoch_order
from ndtpu_torch.data.synthetic import random_cloud
from ndtpu_torch.interop.jax_weights import _pairs
from ndtpu_torch.models.norm import BatchNorm
from ndtpu_torch.parallel import mesh
from ndtpu_torch.tools._common import make_dataset
from ndtpu_torch.train.config import TrainConfig

ROOT = pathlib.Path(__file__).resolve().parent.parent
B, N, M, C, F = 4, 2048, 64, 4, 32
LR = 1e-3

# One worker script for every two-rank test: it joins the group, runs the
# job named in its input pickle on its half of the inputs and pickles what
# the test compares.
WORKER = r"""
import pickle
import sys

import numpy as np
import torch

from ndtpu_torch.parallel import mesh
from ndtpu_torch.parallel.collectives import Collectives

init, rank, src, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
job = pickle.load(open(src, "rb"))
mesh.make_data_group("cpu", init_method=init, world_size=2, rank=rank)


def bn(job):
    from ndtpu_torch.models.norm import BatchNorm
    from ndtpu_torch.parallel.collectives import all_reduce_gradients

    x, cot = (torch.from_numpy(a[rank::2]) for a in (job["x"], job["cot"]))
    bn = BatchNorm(x.shape[-1]).train()
    with torch.no_grad():
        for name, v in job["params"].items():
            getattr(bn, name).copy_(torch.from_numpy(v))
    x.requires_grad_()
    y = bn(x)
    (y * cot).sum().backward()
    all_reduce_gradients(bn.parameters())
    return {"y": y.detach().numpy(), "x_grad": x.grad.numpy(),
            **{f"{n}_grad": p.grad.numpy() for n, p in bn.named_parameters()},
            **{n: b.numpy() for n, b in bn.named_buffers()}}


def step(job):
    from ndtpu_torch.interop.jax_weights import load_jax_train_state
    from ndtpu_torch.train import loop
    from ndtpu_torch.train.state import create_train_state

    pts, labels = (torch.from_numpy(a[rank::2]) for a in job["batch"])
    step_fn, _ = loop.make_ndt_seg_step(job["M"], job["C"], "reference")
    f64 = dict(dtype=torch.float64, param_dtype=torch.float64)
    state = create_train_state(job["C"], job["F"],
                               loop.make_lr_schedule(job["lr"], 2),
                               device="cpu", **f64)
    load_jax_train_state(state, job["jax_state"])
    state, m = step_fn(state, pts, labels)
    names = {id(p): n for n, p in state.model.named_parameters()}
    # the collectives of the float32 step, from a fresh state
    with Collectives() as create:
        state32 = create_train_state(job["C"], job["F"], lambda _: job["lr"],
                                     device="cpu")
    prep = loop._make_prep(job["M"], job["C"], "reference")
    with Collectives() as prep_calls:
        prep(pts, labels)
    with Collectives() as calls:
        step_fn(state32, pts, labels)
    return {"metrics": {k: float(v) for k, v in m.items()},
            "state": {k: v.numpy() for k, v in state.model.state_dict().items()},
            "exp_avg": {names[id(p)]: s["exp_avg"].numpy()
                        for p, s in state.optimizer.state.items()},
            "param_bytes": sum(p.numel() * p.element_size()
                               for p in state32.model.parameters()),
            "create_calls": create.log, "prep_calls": prep_calls.log,
            "calls": calls.log}


def epoch(job):
    from ndtpu_torch.data.loader import (DeviceCachedDataset, batch_iterator,
                                         sharded_batch)
    from ndtpu_torch.tools._common import make_dataset

    ds = make_dataset(4, 256, synthetic_length=job["n"], seed=0,
                      int_labels=True)
    cached = DeviceCachedDataset(ds, "cpu", sharding=mesh.data_group())
    order = torch.from_numpy(job["order"])
    refused = []
    for make in (lambda: DeviceCachedDataset(ds, "cpu"),
                 lambda: DeviceCachedDataset(
                     make_dataset(4, 64, synthetic_length=7), "cpu",
                     sharding=mesh.data_group()),
                 lambda: next(cached.loader(2))):
        try:
            make()
        except ValueError as e:
            refused.append(str(e))
    return {"len": len(cached), "block": [a.numpy() for a in cached.arrays],
            "refused": refused,
            "batches": [[a.numpy() for a in sharded_batch(
                cached.arrays, row, mesh.data_group())] for row in order],
            "loader": [list(b) for b in batch_iterator(
                ds, job["b"], True, job["seed"], rank, 2)]}


try:
    result = {"bn": bn, "step": step, "epoch": epoch}[job["job"]](job)
finally:
    mesh.release_group()
pickle.dump(result, open(out, "wb"))
"""


def run_ranks(tmp_path, job):
    """Run WORKER's ``job`` (a dict, pickled) on two gloo ranks; returns
    their results, rank 0's first."""
    src = tmp_path / "job.pkl"
    src.write_bytes(pickle.dumps(job))
    # two threads a rank: the ranks and the tests' other workers share cores
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, f"file://{tmp_path / 'store'}",
         str(rank), str(src), str(tmp_path / f"r{rank}.pkl")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in (0, 1)]
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, out
    return [pickle.loads((tmp_path / f"r{rank}.pkl").read_bytes())
            for rank in (0, 1)]


def interleave(halves):
    """The global batch from rank 0's and rank 1's strided halves."""
    a, b = halves
    out = np.empty((a.shape[0] + b.shape[0],) + a.shape[1:], a.dtype)
    out[0::2], out[1::2] = a, b
    return out


def plain(tree):
    """A pytree as nested dicts and lists of numpy arrays (named tuples by
    their fields), so that a worker unpickles it without jax."""
    if hasattr(tree, "_fields"):
        return {f: plain(getattr(tree, f)) for f in tree._fields}
    if hasattr(tree, "items"):
        return {k: plain(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [plain(v) for v in tree]
    return np.asarray(tree)


# ---- BatchNorm ----

@pytest.mark.parametrize("shape", [(4, 40, 8), (6, 16)])
def test_batchnorm_global_statistics_on_two_ranks_match_jax(tmp_path, shape):
    """Each rank holds half of the rows (a [B, M, C] batch, or the [B, C]
    rows of a TNet's FC norm) against JAX's BatchNorm on the whole batch:
    the output, the running mean and var to rtol / atol 1e-6; the
    gradients of x, and of weight and bias summed over the ranks, to rtol
    1e-5 (atol 1e-6)."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
    cot = rng.normal(size=shape).astype(np.float32)
    c = shape[-1]
    params = {"weight": rng.uniform(0.5, 2, c).astype(np.float32),
              "bias": rng.normal(size=c).astype(np.float32),
              "running_mean": rng.normal(size=c).astype(np.float32),
              "running_var": rng.uniform(0.5, 2, c).astype(np.float32)}
    jbn = JaxBatchNorm(use_running_average=False)
    stats = {"mean": jnp.asarray(params["running_mean"]),
             "var": jnp.asarray(params["running_var"])}

    def f(p, xx):
        y, mut = jbn.apply({"params": p, "batch_stats": stats}, xx,
                           mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, mut["batch_stats"])

    jp = {"scale": jnp.asarray(params["weight"]),
          "bias": jnp.asarray(params["bias"])}
    (_, (y_ref, new)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    r0, r1 = run_ranks(tmp_path, {"job": "bn", "x": x, "cot": cot,
                                  "params": params})
    tight = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(interleave([r0["y"], r1["y"]]),
                               np.asarray(y_ref), **tight)
    for r in (r0, r1):
        np.testing.assert_allclose(r["running_mean"], np.asarray(new["mean"]),
                                   **tight)
        np.testing.assert_allclose(r["running_var"], np.asarray(new["var"]),
                                   **tight)
        np.testing.assert_allclose(r["weight_grad"], np.asarray(gp["scale"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["bias_grad"], np.asarray(gp["bias"]),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(interleave([r0["x_grad"], r1["x_grad"]]),
                               np.asarray(gx), rtol=1e-5, atol=1e-6)


def test_batchnorm_without_a_group_is_the_single_process_module():
    """No group: the train-mode output and running statistics are the
    single-process expressions bit for bit (``xf.mean`` over the rows, the
    two-pass variance clamped at 0, the Python n / (n - 1)); on a one-rank
    group the global form gives the same to 1e-6."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy((rng.normal(size=(3, 20, 6)) * 2 - 1).astype(np.float32))
    bn = BatchNorm(6).train()
    y = bn(x)
    mean = x.mean((0, 1))
    var = torch.maximum((x - mean).square().mean((0, 1)), torch.zeros(6))
    assert torch.equal(y, (x - mean) / torch.sqrt(var + 1e-5) * 1.0 + 0.0)
    assert torch.equal(bn.running_mean, 0.9 * torch.zeros(6) + 0.1 * mean)
    assert torch.equal(bn.running_var,
                       0.9 * torch.ones(6) + 0.1 * (var * (60 / 59)))
    mesh.make_data_group("cpu")
    try:
        bn1 = BatchNorm(6).train()
        y1 = bn1(x)
    finally:
        mesh.release_group()
    torch.testing.assert_close(y1, y, rtol=1e-6, atol=1e-6)
    for name, buf in bn.named_buffers():
        torch.testing.assert_close(getattr(bn1, name), buf, rtol=1e-6, atol=1e-6)


def test_a_point_group_is_not_a_data_group():
    """The point-sharded path's group (``make_group``) leaves the training
    arithmetic alone: no data group, and a PointNet train step (train-mode
    BatchNorm, the loss, the update) issues no collective and gives the
    metrics and state of the step without a group bit for bit. Only
    ``make_data_group`` makes the data group, and ``release_group`` forgets
    it."""
    from ndtpu_torch.models import PointNetSegmentation
    from ndtpu_torch.parallel.collectives import Collectives
    from ndtpu_torch.train.loop import make_pointnet_seg_step
    from ndtpu_torch.train.state import create_train_state

    rng = np.random.default_rng(7)
    pts = torch.from_numpy(rng.normal(size=(2, 64, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, C + 1, (2, 64)).astype(np.int32))
    step, _ = make_pointnet_seg_step(C)

    def run():
        state = create_train_state(C, F, lambda _: LR, device="cpu",
                                   model=PointNetSegmentation)
        with Collectives() as calls:
            state, m = step(state, pts, labels)
        return calls.log, m, state.model.state_dict()

    _, m_ref, s_ref = run()
    mesh.make_group("cpu")
    try:
        assert (mesh.data_group(), mesh.data_rank(), mesh.data_size()) == (
            None, 0, 1)
        calls, m, s = run()
    finally:
        mesh.release_group()
    assert calls == []
    assert {k: float(v) for k, v in m.items()} == {
        k: float(v) for k, v in m_ref.items()}
    for k, v in s_ref.items():
        assert torch.equal(s[k], v), k
    group = mesh.make_data_group("cpu")
    try:
        assert mesh.data_group() is group and mesh.data_size() == 1
    finally:
        mesh.release_group()
    assert mesh.data_group() is None


# ---- one DP step against JAX's step on the whole batch ----

def uneven_cloud(seed):
    """40 tight clusters (spread 1e-4) of about 51 points each: no voxel
    size gives M occupied voxels, so the search ends unconverged and the
    cloud keeps fewer than M NDs (41 for seed 0)."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-10, 10, size=(40, 3))
    pts = centres[np.arange(N) % 40] + rng.normal(scale=1e-4, size=(N, 3))
    return pts.astype(np.float32)


def step_batch(uneven):
    """[B, N, 3] clouds and int labels in 1..4 by the signs of x and y:
    uniform clouds (random_cloud), the last one replaced by
    ``uneven_cloud`` in the uneven case. Asserts no 2- or 3-point voxel
    and, in the uneven case, that the clouds keep different ND counts.
    Returns (points, labels, kept NDs a cloud)."""
    pts = np.stack([random_cloud(N, 10.0, seed=s) for s in range(B)])
    if uneven:
        pts[-1] = uneven_cloud(0)
    labels = (1 + (pts[..., 0] > 0) + 2 * (pts[..., 1] > 0)).astype(np.int32)
    out = jax_prep(M, jnp.asarray(pts), jnp.asarray(labels), C, False,
                   "reference")
    counts = np.asarray(out[4].counts)
    assert not ((counts == 2) | (counts == 3)).any()
    kept = np.asarray(out[3]).sum(-1)
    assert (len(set(kept.tolist())) > 1) == uneven, kept
    return pts, labels, kept


def jax_float64_step(pts, labels):
    """JAX's segmentation step on the whole batch with a float64 model:
    the preprocessing of ``make_ndt_seg_step`` (float32, reference search)
    op by op, then its loss_fn, gradient and ``optax.adam`` update under
    ``jax.enable_x64`` (the reference search's loop does not trace under
    x64). Op by op the preprocessing is the port's bit for bit; under
    ``jit`` XLA contracts the covariance finalisation into FMAs, which
    moves the inputs by up to 1e-6 and the running statistics after the
    model by up to 1e-4 (ROADMAP.md, faults). The weights are float32 ones
    widened, so the weight bridge carries them exactly. Returns (the state before the step as numpy,
    loss, accuracy, the new batch_stats and Adam's first moments as
    numpy)."""
    js = jax_create_train_state(
        JaxSegmentation(num_classes=C, feature_dim=F),
        optax.adam(jloop.make_lr_schedule(LR, 2)), jax.random.PRNGKey(0),
        jnp.zeros((B, M, 3)), jnp.zeros((B, M, 9)), init_kwargs={"train": False})
    with jax.disable_jit():
        pcl, covs, gt, mask, _ = jax_prep(M, jnp.asarray(pts),
                                          jnp.asarray(labels), C, False,
                                          "reference")
    with jax.enable_x64(True):
        wide = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                      (js.params, js.batch_stats))
        params, stats = wide
        model = JaxSegmentation(num_classes=C, feature_dim=F,
                                dtype=jnp.float64, param_dtype=jnp.float64)
        tx = optax.adam(jloop.make_lr_schedule(LR, 2))
        opt_state = tx.init(params)
        before = {"params": plain(params), "batch_stats": plain(stats),
                  "opt_state": plain(opt_state), "step": np.asarray(0)}

        def loss_fn(p):
            logits, mut = model.apply(
                {"params": p, "batch_stats": stats}, pcl, covs, train=True,
                return_logits=True, mutable=["batch_stats"])
            return jloop.cross_entropy_loss(logits, gt, mask), (logits, mut)

        (loss, (logits, mut)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params)
        opt_state = tx.update(grads, opt_state, params)[1]
        return (before, float(loss), float(jloop.accuracy(logits, gt, mask)),
                plain(mut["batch_stats"]), plain(opt_state[0].mu))


@pytest.fixture(scope="module", params=[False, True], ids=["even", "uneven"])
def dp_step(request, tmp_path_factory):
    """JAX's float64 step on the whole batch (``jax_float64_step``) and the
    port's float64 DP step on two ranks from the same state (lr 1e-3)."""
    pts, labels, kept = step_batch(request.param)
    before, loss, acc, stats, mu = jax_float64_step(pts, labels)
    ranks = run_ranks(tmp_path_factory.mktemp("dp_step"), {
        "job": "step", "batch": (pts, labels), "jax_state": before,
        "M": M, "C": C, "F": F, "lr": LR})
    return (loss, acc, stats, mu), ranks, kept


def test_dp_step_on_two_ranks_matches_jax_whole_batch(dp_step):
    """Loss and accuracy within 1e-5 of JAX's on the whole batch, on both
    ranks; every rank's parameters and buffers equal; the running
    statistics within rtol 1e-5 (atol 1e-6); Adam's first moments (0.1 of
    the global gradient) within 1e-5 of optax's where the gradient is not
    noise."""
    from test_torch_port_train import signal

    (loss, acc, stats, mu), (r0, r1), kept = dp_step
    for r in (r0, r1):
        assert abs(r["metrics"]["loss"] - loss) <= 1e-5 * abs(loss)
        assert abs(r["metrics"]["accuracy"] - acc) <= 1e-5
    for k, v in r0["state"].items():
        np.testing.assert_array_equal(r1["state"][k], v, err_msg=k)
    model = _port_model()
    names = {id(t): n for n, t in model.state_dict(keep_vars=True).items()}
    buffers = [(names[id(t)], a) for t, a in _pairs(model, mu, stats)
               if not isinstance(t, torch.nn.Parameter)]
    assert len(buffers) == 2 * 16
    for name, a in buffers:
        np.testing.assert_allclose(r0["state"][name], a, rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    leaves = [(names[id(t)], a) for t, a in _pairs(model, mu, None)]
    gmax = max(np.abs(a).max() for _, a in leaves)
    compared = 0
    for name, a in leaves:
        keep = signal(a, gmax)
        if keep.any():
            np.testing.assert_allclose(r0["exp_avg"][name][keep], a[keep],
                                       rtol=0, atol=1e-5, err_msg=name)
            compared += 1
    assert compared > len(leaves) // 2
    print(f"kept NDs a cloud {kept.tolist()}; loss {r0['metrics']['loss']:.12f} "
          f"(JAX {loss:.12f})")


def _port_model():
    from ndtpu_torch.models import NDTNetSegmentation

    return NDTNetSegmentation(num_classes=C, feature_dim=F, device="cpu")


def test_dp_step_collectives_are_all_reduces_of_about_the_parameters(dp_step):
    """tests/test_collectives.py:60-73 at torch.distributed: the step's
    collectives are all-reduces only, whose bytes lie in [param_bytes,
    1.15 param_bytes + 4096] (the gradients once, in one flat buffer per
    type, plus BatchNorm's statistics and the metrics); the state's
    creation broadcasts (rank 0's state); the preprocessing issues
    none."""
    for r in dp_step[1]:
        assert {c.op for c in r["calls"]} == {"all_reduce"}
        moved = sum(c.nbytes for c in r["calls"])
        assert r["param_bytes"] <= moved <= 1.15 * r["param_bytes"] + 4096
        grads = [c for c in r["calls"] if c.nbytes >= r["param_bytes"]]
        assert [c.nbytes for c in grads] == [r["param_bytes"]]
        assert {c.op for c in r["create_calls"]} == {"broadcast"}
        assert r["prep_calls"] == []


# ---- the loader, the sharded dataset ----

@pytest.mark.parametrize("num_processes", [2, 4])
def test_batch_iterator_slices_match_jax(num_processes):
    """Every process's batches against the JAX loader's for the same global
    batch size and seed: the strided slices of one shuffled order, the
    partial last global batch dropped (9 clouds, batch 4: 2 batches)."""
    ds = make_dataset(C, 200, synthetic_length=9, seed=2, int_labels=True)
    for pid in range(num_processes):
        got = list(batch_iterator(ds, 4, True, 5, pid, num_processes))
        want = list(jax_batch_iterator(ds, 4, True, 5, process_id=pid,
                                       num_processes=num_processes))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert len(g[0]) == 4 // num_processes
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="divide"):
        next(batch_iterator(ds, 3, num_processes=2))


def test_sharded_dataset_blocks_and_batches(tmp_path):
    """Two ranks: each DeviceCachedDataset holds its contiguous block of 8
    clouds (global row i is dataset index i) and ``len`` is 8; each global
    batch of a shuffled order, assembled by ``sharded_batch``, is bit for
    bit the rank's ``batch_iterator`` slice. Refused with a ValueError: an
    unsharded dataset under two ranks, a length that does not divide by
    the process count, the host-order ``loader`` of a sharded dataset."""
    n, b, seed = 8, 4, 3
    order = epoch_order(n, True, seed).reshape(n // b, b)
    r = run_ranks(tmp_path, {"job": "epoch", "n": n, "b": b, "seed": seed,
                             "order": order})
    ds = make_dataset(C, 256, synthetic_length=n, seed=0, int_labels=True)
    for rank, res in enumerate(r):
        assert res["len"] == n
        for k, block in enumerate(res["block"]):
            np.testing.assert_array_equal(
                block, np.stack([ds[i][k] for i in range(rank * 4, rank * 4 + 4)]))
        assert len(res["batches"]) == len(res["loader"]) == n // b
        for got, want in zip(res["batches"], res["loader"]):
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))
        assert len(res["refused"]) == 3
        assert "needs the data group" in res["refused"][0]
        assert "must divide by process count 2" in res["refused"][1]
        assert "epoch scan" in res["refused"][2]


# ---- config ----

@pytest.mark.parametrize("flag,field,value", [
    (["--coordinator", "localhost:1234"], "coordinator", "localhost:1234"),
    (["--num_processes", "2", "--process_id", "1"], "num_processes", 2),
    (["--data_axis", "batch"], "data_axis", "batch"),
    (["--compute_dtype", "float64", "--param_dtype", "float64"],
     "param_dtype", "float64"),
])
def test_config_accepts_the_multi_host_flags_and_float64(flag, field, value):
    """The JAX config's multi-host flags and float64 types: taken as the
    JAX config takes them."""
    from ndtpu.train.config import TrainConfig as JaxTrainConfig

    cfg = TrainConfig.from_args(["--device", "cpu"] + flag)
    assert getattr(cfg, field) == value
    assert {k: v for k, v in vars(cfg).items() if k != "device"} == vars(
        JaxTrainConfig.from_args(flag))
    if "float64" in flag:
        assert cfg.dtypes == {"dtype": torch.float64,
                              "param_dtype": torch.float64}
