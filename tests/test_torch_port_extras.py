"""The trainer extras of the port on the CPU against the JAX package:
bfloat16 compute and parameters for every model, a bfloat16 train step,
the sync-free searches, the sync-free step, the epoch scan, the
device-resident dataset, the trainer CLI with ``--device_cache``, bfloat16
checkpoints and the weight bridge into bfloat16 parameters.

Inputs come from numpy seeds at a small size (B 4-8, N <= 2048, M <= 32,
feature_dim 32). bfloat16 keeps 8 significant bits: the two frameworks
round the same expressions at different places (their GEMMs sum in
another order, XLA fuses and contracts float32 steps), so bfloat16 outputs
are held to a share of the output's largest entry, each limit set just
above the largest gap measured on these inputs (in brackets):
BF16_EVAL_TOL in eval mode (bfloat16 parameters 2e-3 [1.45e-3, PointNet
segmentation; 0 for the other five models], float32 parameters 2.5e-2
[2.13e-2]) and BF16_TRAIN_TOL in train mode (8e-2 [5.77e-2]), where the
BatchNorms over the B rows of the TNets' FC layers divide by a spread
that a bfloat16 rounding moves (both frameworks' logits lie 9-42 % of
their largest entry from the same model in float64); the running
statistics to BF16_STATS_TOL, relative and absolute (5e-2 [3.65e-2]).
These limits fail the port's known departures from flax: the input
transform's einsum in bfloat16 instead of float32 moves the eval logits
by 4.9e-3 to 3.4e-2 with bfloat16 parameters, BatchNorm statistics in
bfloat16 move the train logits by 0.15 to 0.61.
"""
import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ndtpu import models as jm
from ndtpu.data.loader import batch_iterator as jax_batch_iterator
from ndtpu.models import norm as jnorm
from ndtpu.train import loop as jloop
from ndtpu.train.state import create_train_state as jax_create_train_state
from ndtpu_torch import models as tm
from ndtpu_torch.core import ndt as tn
from ndtpu_torch.data.loader import DeviceCachedDataset, batch_iterator
from ndtpu_torch.data.synthetic import example_cloud
from ndtpu_torch.interop.jax_weights import _pairs, load_jax_train_state, load_jax_variables
from ndtpu_torch.models.norm import BatchNorm
from ndtpu_torch.tools._common import make_dataset
from ndtpu_torch.train import loop
from ndtpu_torch.train.config import TrainConfig
from ndtpu_torch.train.state import (
    create_train_state,
    restore_checkpoint,
    save_checkpoint,
)

from test_torch_port_multiscale import COARSE, FINE, jax_inputs, port_inputs
from test_torch_port_sampler import outlier_cloud

ROOT = pathlib.Path(__file__).resolve().parent.parent
B, N, M, C, F = 4, 1024, 16, 4, 32
BF16_EVAL_TOL = {"bfloat16": 2e-3, "float32": 2.5e-2}  # by param_dtype
BF16_TRAIN_TOL = 8e-2
BF16_STATS_TOL = 5e-2
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---- (a, i) every model in bfloat16 against flax, the weight bridge ----

def model_case(name, param_dtype):
    """(flax module, port module on the CPU, JAX inputs, port inputs) of a
    model family at the small size, compute bfloat16, parameters in
    ``param_dtype``."""
    jdt, tdt = DT[param_dtype]
    kw = dict(dtype=jnp.bfloat16, param_dtype=jdt)
    pkw = dict(dtype=torch.bfloat16, param_dtype=tdt, device="cpu")
    rng = np.random.default_rng(3)
    if name.startswith("ndtnetpp"):
        jargs = jax_inputs(1)
        targs = port_inputs(jargs)
        size = dict(num_classes=C, fine_res=FINE, coarse_res=COARSE,
                    feature_dim=F)
        jcls, tcls = {"ndtnetpp_seg": (jm.NDTNetPPSegmentation,
                                       tm.NDTNetPPSegmentation),
                      "ndtnetpp_cls": (jm.NDTNetPPClassification,
                                       tm.NDTNetPPClassification)}[name]
        return jcls(**size, **kw), tcls(**size, **pkw), jargs, targs
    pts = rng.normal(size=(B, 2 * M, 3)).astype(np.float32)
    covs = (0.1 * rng.normal(size=(B, 2 * M, 9))).astype(np.float32)
    arrays = (pts,) if name.startswith("pointnet") else (pts, covs)
    jcls, tcls = {
        "ndtnet_seg": (jm.NDTNetSegmentation, tm.NDTNetSegmentation),
        "ndtnet_cls": (jm.NDTNetClassification, tm.NDTNetClassification),
        "pointnet_seg": (jm.PointNetSegmentation, tm.PointNetSegmentation),
        "pointnet_cls": (jm.PointNetClassification, tm.PointNetClassification),
    }[name]
    return (jcls(num_classes=C, feature_dim=F, **kw),
            tcls(num_classes=C, feature_dim=F, **pkw),
            tuple(jnp.asarray(a) for a in arrays),
            tuple(torch.from_numpy(a) for a in arrays))


MODELS = ["ndtnet_seg", "ndtnet_cls", "ndtnetpp_seg", "ndtnetpp_cls",
          "pointnet_seg", "pointnet_cls"]


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", MODELS)
def test_bf16_models_match_flax(name, param_dtype, mode):
    """Compute bfloat16, parameters float32 or bfloat16: the port's model,
    filled from the flax variables by the weight bridge (bfloat16 leaves
    into bfloat16 parameters as they are), gives flax's logits within
    BF16_EVAL_TOL (eval) or BF16_TRAIN_TOL (train) of their largest entry,
    in bfloat16; every parameter and
    running statistic is in ``param_dtype``, as every flax leaf is (as
    tests/test_models.py::test_bfloat16_compute_dtype asserts); train mode
    moves the running statistics as flax does (float32 sums, stored in
    ``param_dtype``) within BF16_STATS_TOL."""
    jmod, tmod, jargs, targs = model_case(name, param_dtype)
    v = jmod.init(jax.random.PRNGKey(0), *jargs)
    leaves = jax.tree_util.tree_leaves(v)
    assert {leaf.dtype for leaf in leaves} == {jnp.dtype(param_dtype)}
    load_jax_variables(tmod, np_tree(v))
    assert {t.dtype for t in tmod.state_dict().values()} == {
        DT[param_dtype][1]}
    train = mode == "train"
    if train:
        ref, mut = jmod.apply(v, *jargs, train=True, return_logits=True,
                              mutable=["batch_stats"])
    else:
        ref = jmod.apply(v, *jargs, return_logits=True)
    with torch.no_grad():
        out = tmod.train(train)(*targs, return_logits=True)
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    r, o = np.asarray(ref, np.float32), out.float().numpy()
    assert np.isfinite(o).all()
    gap = np.abs(o - r).max() / np.abs(r).max()
    assert gap <= (BF16_TRAIN_TOL if train else BF16_EVAL_TOL[param_dtype]), gap
    if train:
        stats = np_tree(mut["batch_stats"])
        for t, a in _pairs(tmod, np_tree(v["params"]), stats):
            if not isinstance(t, torch.nn.Parameter):
                assert t.dtype == DT[param_dtype][1]
                np.testing.assert_allclose(t.float().numpy(),
                                           np.asarray(a, np.float32),
                                           rtol=BF16_STATS_TOL,
                                           atol=BF16_STATS_TOL)


@pytest.mark.parametrize("shape", [(2, 40, 8), (6, 8)])
def test_bf16_batchnorm_matches_flax(shape):
    """BatchNorm on bfloat16 input: statistics and normalisation in
    float32 (norm.py:46), the output cast to bfloat16, bfloat16 running
    statistics updated in float32 then cast; train and eval."""
    x = np.random.default_rng(5).normal(2.0, 3.0, size=shape).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    mod = jnorm.BatchNorm(use_running_average=False, dtype=jnp.bfloat16,
                          param_dtype=jnp.bfloat16)
    v = mod.init(jax.random.PRNGKey(0), xb)
    y, mut = mod.apply(v, xb, mutable=["batch_stats"])
    bn = BatchNorm(shape[-1], dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    with torch.no_grad():
        out = bn.train()(xt)
        out_eval = bn.eval()(xt)
    assert out.dtype == torch.bfloat16 and y.dtype == jnp.bfloat16
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(y, np.float32))
    for t, k in ((bn.running_mean, "mean"), (bn.running_var, "var")):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            t.float().numpy(), np.asarray(mut["batch_stats"][k], np.float32))
    ev = jnorm.BatchNorm(use_running_average=True, dtype=jnp.bfloat16,
                         param_dtype=jnp.bfloat16).apply(
        {"params": v["params"], "batch_stats": mut["batch_stats"]}, xb)
    np.testing.assert_array_equal(out_eval.float().numpy(),
                                  np.asarray(ev, np.float32))


def test_weight_bridge_refuses_to_change_a_leaf_type():
    """A float32 leaf does not fill a bfloat16 parameter, nor a bfloat16
    leaf a float32 one: the bridge widens or rounds nothing."""
    v = np_tree(jm.TNet(in_dim=3).init(jax.random.PRNGKey(0),
                                      jnp.zeros((2, 8, 3))))
    with pytest.raises(TypeError, match="float32 leaf"):
        load_jax_variables(tm.TNet(3, param_dtype=torch.bfloat16), v)
    v16 = jax.tree_util.tree_map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), v)
    with pytest.raises(TypeError, match="bfloat16 leaf"):
        load_jax_variables(tm.TNet(3), v16)
    load_jax_variables(tm.TNet(3, param_dtype=torch.bfloat16), v16)


# ---- (b) a bfloat16 train step against JAX's ----

def bf16_states(lr):
    """The JAX train state of NDTNetSegmentation in bfloat16 (compute and
    parameters, Adam's moments bfloat16 as optax keeps them) and the port's
    state carried from it (load_jax_train_state)."""
    model = jm.NDTNetSegmentation(num_classes=C, feature_dim=F,
                                  dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
    js = jax_create_train_state(
        model, optax.adam(jloop.make_lr_schedule(lr, 2)), jax.random.PRNGKey(0),
        jnp.zeros((B, M, 3)), jnp.zeros((B, M, 9)), init_kwargs={"train": False})
    state = create_train_state(C, F, loop.make_lr_schedule(lr, 2), device="cpu",
                               dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    return js, load_jax_train_state(state, np_tree(js))


def test_bf16_train_step_matches_jax():
    """One bfloat16 segmentation step (reference search, int labels) of
    both frameworks from the same weights: the loss within 2e-2; Adam's
    moments and the parameters stay bfloat16; and where the two gradients
    agree in sign and are not bfloat16 noise (|g| >= 5e-2 of the leaf's
    largest in both; leaves whose largest is below 1e-3 of the model's,
    the biases in front of a BatchNorm, skipped), the parameters moved by Adam's first update, lr *
    sign(g), to within one bfloat16 ulp of the parameter plus 3 % of lr
    (the update's own roundings: about five bfloat16 operations, in other
    orders in torch's Adam and optax's)."""
    from test_torch_port_train import clouds, flat_grads, prep_numpy, step_grads

    pts, labels = clouds(5)
    prep_numpy(pts, labels)
    lr = 1e-2
    js, state = bf16_states(lr)
    step_j, _ = jloop.make_ndt_seg_step(M, C, False, "reference")
    js1, m_ref = step_j(js, jnp.asarray(pts), jnp.asarray(labels))
    step, _ = loop.make_ndt_seg_step(M, C, "reference")
    state, m = step(state, torch.from_numpy(pts), torch.from_numpy(labels))
    assert m["loss"].dtype == torch.float32
    np.testing.assert_allclose(float(m["loss"]), float(m_ref["loss"]), rtol=2e-2)
    assert all(v.dtype == torch.bfloat16 for s in state.optimizer.state.values()
               for k, v in s.items() if k != "step")
    grads = step_grads(js, pts, labels)
    new = np_tree(js1.params)
    gmax = max(np.abs(g.astype(np.float32)).max()
               for _, _, g in flat_grads(state.model, grads))
    compared = 0
    for (name, p, g), (_, _, a) in zip(flat_grads(state.model, grads),
                                       flat_grads(state.model, new)):
        assert p.dtype == torch.bfloat16 and a.dtype.name == "bfloat16"
        ours = p.grad.float().numpy()
        g = g.astype(np.float32)
        if np.abs(g).max() < 1e-3 * gmax:
            continue  # a bias in front of a BatchNorm: noise
        keep = ((np.sign(ours) == np.sign(g))
                & (np.abs(g) >= 5e-2 * np.abs(g).max())
                & (np.abs(ours) >= 5e-2 * np.abs(ours).max()))
        got, want = p.detach().float().numpy()[keep], a.astype(np.float32)[keep]
        tol = np.abs(want) * 2.0**-7 + 0.03 * lr
        assert (np.abs(got - want) <= tol).all(), name
        compared += int(keep.sum())
    total = sum(p.numel() for p in state.model.parameters())
    assert compared > total // 10, (compared, total)


# ---- (c) the sync-free searches, bit for bit ----

def search_batch():
    """Three example_cloud clouds and the sampler tests' outlier cloud (a
    dense 1 m cube and one point 4 km away on every axis, N 4097), int
    tags in 0..C: packed keys cannot converge the outlier cloud, so the
    eager search stops early on the others and runs on for it."""
    n = 4097
    pts = np.concatenate([example_cloud(3, n, seed=4), outlier_cloud()[None]])
    labels = np.random.default_rng(6).integers(0, C + 1, pts.shape[:2])
    return torch.from_numpy(pts), torch.from_numpy(labels.astype(np.int32))


def assert_identical(a, b, label):
    """Outputs of two ndt_downsample calls equal bit for bit (NaN where
    NaN)."""
    for x, y in zip(a[:4], b[:4]):
        assert torch.equal(x, y), label
    for name in tn.NDTResult.__dataclass_fields__:
        x, y = getattr(a[4], name), getattr(b[4], name)
        assert torch.equal(torch.isnan(x), torch.isnan(y)), (label, name)
        assert torch.equal(torch.nan_to_num(x), torch.nan_to_num(y)), (label, name)


@pytest.mark.parametrize("key_mode", ["packed", "pair"])
@pytest.mark.parametrize("search", ["probe", "fast", "reference", "grid"])
def test_sync_free_search_is_bit_identical(search, key_mode):
    """Inside _fixed_rounds() every search runs its fixed maximum of rounds
    over the whole batch (15 further evaluations, or 5 grid rounds),
    keeping each finished cloud's carry with torch.where: the downsample
    (tagged, 64 NDs) equals the eager one, which gathers the unfinished
    clouds by torch.nonzero, bit for bit."""
    pts, labels = search_batch()
    kw = dict(classes=labels, num_class_slots=C + 1, search=search,
              key_mode=key_mode)
    eager = tn.ndt_downsample(pts, 64, **kw)
    with tn._fixed_rounds():
        fixed = tn.ndt_downsample(pts, 64, **kw)
    assert_identical(eager, fixed, (search, key_mode))
    converged = eager[4].converged.tolist()
    assert converged[:3] == [True] * 3
    if key_mode == "packed" and search != "grid":
        assert converged[3] is False  # the search ran to its maximum


def test_sync_free_unfused_secant_search_is_bit_identical():
    """The point-sharded path's unfused secant search
    (``_search_voxel_size_fast``) and the C bisection with a count_fn: the
    same sizes and flags eager and inside _fixed_rounds()."""
    pts, _ = search_batch()
    px, py, pz = (pts[..., a].contiguous() for a in range(3))
    mask = torch.ones(px.shape, dtype=torch.bool)
    mins, maxs = tn._limits(px, py, pz, mask)
    count = tn._point_count(px, py, pz, mask)
    env = tn._min_packable_voxel_size(mins, maxs)
    for run in (lambda: tn._search_voxel_size_fast(64, mins, maxs, count, env),
                lambda: tn._search_voxel_size(64, mins, maxs, env, count)):
        eager = run()
        with tn._fixed_rounds():
            fixed = run()
        for x, y in zip(eager, fixed):
            assert torch.equal(x, y)


# ---- (d) the sync-free step cannot sync ----

class NoSync(TorchDispatchMode):
    """Raises on every op that reads a device value on the host or sizes
    its output by the data: _local_scalar_dense (item, bool, int),
    nonzero, masked_select, unique*, and indexing by a boolean mask
    (nonzero inside). Ops run while ``allowed`` is set pass."""

    BANNED = ("aten._local_scalar_dense", "aten.nonzero", "aten.masked_select",
              "aten.unique", "aten._unique", "aten.bincount",
              "aten.repeat_interleave")

    def __init__(self):
        super().__init__()
        self.allowed = False
        self.seen = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        if not self.allowed:
            self.seen += 1
            if name.startswith(self.BANNED):
                raise AssertionError(f"sync op {func}")
            if name.startswith("aten.index") and any(
                    isinstance(t, torch.Tensor) and t.dtype == torch.bool
                    for a in args if isinstance(a, (list, tuple)) for t in a):
                raise AssertionError(f"boolean index {func}")
        return func(*args, **(kwargs or {}))


def no_sync_run(state, fn):
    """fn() under NoSync; the CPU optimizer's update is let through: on
    the CPU torch's Adam reads its step counter with .item(), while a
    graph's optimizer is capturable (counters on the card,
    ``make_capturable``), which the card checks by capturing and by
    replaying under sync debug mode "error"."""
    mode = NoSync()
    hooks = [state.optimizer.register_step_pre_hook(
                 lambda *_: setattr(mode, "allowed", True)),
             state.optimizer.register_step_post_hook(
                 lambda *_: setattr(mode, "allowed", False))]
    try:
        with mode:
            out = fn()
    finally:
        for h in hooks:
            h.remove()
    assert mode.seen > 100
    return out


@pytest.mark.parametrize("kind", ["segmentation", "streaming", "classification",
                                  "bf16"])
def test_sync_free_step_makes_no_sync_op(kind):
    """The segmentation (probe search, tagged), streaming and
    classification train and eval steps, and the bfloat16 segmentation
    step, inside _fixed_rounds() as make_epoch_scan runs them, issue no op
    that syncs: none of NoSync's ops from the batch to the metrics. The
    same steps run eagerly do (the search's torch.nonzero), which shows
    the check sees them."""
    from test_torch_port_train import clouds

    pts, labels = (torch.from_numpy(a) for a in clouds(5))
    sched = loop.make_lr_schedule(1e-3, 2)
    if kind == "classification":
        state = create_train_state(C, F, sched, device="cpu",
                                   model=tm.NDTNetClassification)
        gt = torch.eye(C)[torch.arange(B) % C]
        step, eval_step = loop.make_classification_step(M, C, "probe")
        batch = (pts, gt)
    else:
        dt = torch.bfloat16 if kind == "bf16" else None
        state = create_train_state(C, F, sched, device="cpu", dtype=dt)
        step, eval_step = loop.make_ndt_seg_step(M, C, "probe")
        batch = (pts, labels)
        if kind == "streaming":
            from ndtpu_torch.preprocessing.batch import ndt_preprocessing_with_state

            batch += (ndt_preprocessing_with_state(
                M, pts, None, C, search="probe")[4].voxel_size,)
    with tn._fixed_rounds():
        _, m = no_sync_run(state, lambda: step(state, *batch))
        e = no_sync_run(state, lambda: eval_step(state, *batch))
    assert all(torch.isfinite(v) for v in (*m.values(), *e.values()))
    if kind != "streaming":
        with pytest.raises(AssertionError, match="sync op"):
            no_sync_run(state, lambda: step(state, *batch))


# ---- (e, f) the epoch scan and the device-resident dataset ----

class Samples:
    """An indexable dataset of given per-sample arrays."""

    def __init__(self, *arrays):
        self.arrays = arrays

    def __len__(self):
        return len(self.arrays[0])

    def __getitem__(self, i):
        return tuple(a[i] for a in self.arrays)


def scan_data():
    """8 clouds (two clouds() batches of 4, no 2- or 3-point voxel at M)
    and their int labels."""
    from test_torch_port_train import clouds, prep_numpy

    batches = [clouds(k) for k in (5, 6)]
    for b in batches:
        prep_numpy(*b)
    return tuple(np.concatenate(a) for a in zip(*batches))


def test_epoch_scan_matches_jax_epoch_scan():
    """run_epoch_scan(make_epoch_scan(step)) over a DeviceCachedDataset
    against the JAX package's over its own, from the same weights and
    the same shuffled order (seed 3), 2 steps of 4 (reference search, int
    labels): the mean loss within 1e-5, the last loss within 1e-6 and
    every parameter within 1e-6, JAX's own tolerances for its scan against
    its loop (tests/test_train.py). The rate is 1e-7, below those
    tolerances: a gradient that is f32 noise turns Adam's first update
    into +-lr in either direction in either framework (see
    tests/test_torch_port_train.py)."""
    from ndtpu.data.loader import DeviceCachedDataset as JaxDeviceCachedDataset
    from test_torch_port_train import jax_state, port_state

    data = Samples(*scan_data())
    lr = 1e-7
    js = jax_state(lr=lr)
    state = port_state(js, lr=lr)
    step_j, _ = jloop.make_ndt_seg_step(M, C, False, "reference")
    js, ref = jloop.run_epoch_scan(jloop.make_epoch_scan(step_j), js,
                                   JaxDeviceCachedDataset(data), B, seed=3)
    step, _ = loop.make_ndt_seg_step(M, C, "reference")
    state, got = loop.run_epoch_scan(loop.make_epoch_scan(step), state,
                                     DeviceCachedDataset(data, "cpu"), B, seed=3)
    assert sorted(got) == sorted(ref)
    assert abs(got["mean_loss"] - ref["mean_loss"]) < 1e-5
    assert abs(got["last_loss"] - ref["last_loss"]) < 1e-6
    assert abs(got["mean_accuracy"] - ref["mean_accuracy"]) <= 1 / (B * M)
    assert state.step == int(js.step) == 2
    for t, a in _pairs(state.model, np_tree(js.params), None):
        np.testing.assert_allclose(t.detach().numpy(), a, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("streaming", [False, True])
def test_epoch_scan_equals_the_per_step_loop(streaming):
    """The port's epoch scan (train, then eval) against its per-step loop
    (run_epoch over DeviceCachedDataset.loader) with the same order, at lr
    1e-2 and the probe search (streaming: the searched sizes as the
    dataset's third array): JAX's tolerances (tests/test_train.py), met
    here bit for bit, as the sync-free search gives the eager one's
    outputs."""
    from ndtpu_torch.tools.train import run_epoch

    data = scan_data()
    if streaming:
        from ndtpu_torch.preprocessing.batch import ndt_preprocessing_with_state

        sizes = ndt_preprocessing_with_state(
            M, torch.from_numpy(data[0]), None, C, search="probe")[4].voxel_size
        data += (sizes.numpy(),)
    ds = DeviceCachedDataset(Samples(*data), "cpu")
    assert [tuple(a.shape) for a in ds.arrays][-1] == ((8,) if streaming else (8, N))
    sched = loop.make_lr_schedule(1e-2, 2)
    step, eval_step = loop.make_ndt_seg_step(M, C, "probe")
    loop_state = create_train_state(C, F, sched, device="cpu")
    loop_state, want = run_epoch(step, loop_state, ds.loader(B, True, 7), True)
    want_eval = run_epoch(eval_step, loop_state, ds.loader(B, False), False)[1]
    scan_state = create_train_state(C, F, sched, device="cpu")
    scan_state, got = loop.run_epoch_scan(loop.make_epoch_scan(step), scan_state,
                                          ds, B, shuffle=True, seed=7)
    got_eval = loop.run_epoch_scan(loop.make_epoch_scan(eval_step, train=False),
                                   scan_state, ds, B, shuffle=False)[1]
    assert scan_state.step == loop_state.step == 2
    for k in want:
        assert abs(got[k] - want[k]) < (1e-5 if k.startswith("mean") else 1e-6)
        assert abs(got_eval[k] - want_eval[k]) < 1e-5
    for a, b in zip(loop_state.model.state_dict().values(),
                    scan_state.model.state_dict().values()):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("shuffle", [False, True])
def test_device_cached_loader_matches_batch_iterator(shuffle):
    """DeviceCachedDataset.loader gives the JAX batch_iterator's batches
    (and the port's) in order, a last partial batch dropped, on the
    dataset's device; arrays[k] stacks sample field k."""
    ds = make_dataset(C, 300, synthetic_length=7, seed=2, int_labels=True)
    cached = DeviceCachedDataset(ds, "cpu")
    assert len(cached) == 7 and cached.arrays[1].dtype == torch.int32
    got = list(cached.loader(3, shuffle=shuffle, seed=4))
    want = list(jax_batch_iterator(ds, 3, shuffle=shuffle, seed=4))
    ours = list(batch_iterator(ds, 3, shuffle=shuffle, seed=4))
    assert len(got) == len(want) == len(ours) == 2
    for g, w, o in zip(got, want, ours):
        for a, b, c in zip(g, w, o):
            np.testing.assert_array_equal(a.numpy(), b)
            np.testing.assert_array_equal(a.numpy(), c)
    from ndtpu_torch.parallel import mesh

    group = mesh.make_data_group("cpu")
    try:  # a sharded dataset is read only by the epoch scan
        with pytest.raises(ValueError, match="epoch scan"):
            next(DeviceCachedDataset(ds, "cpu", sharding=group).loader(3))
    finally:
        mesh.release_group()


# ---- (g) the trainer CLI with --device_cache; config ----

def cli(args, tmp_path):
    from test_torch_port_train import run_trainer

    return run_trainer(["--epochs", "1", "--device_cache"] + args, tmp_path)


def train_logs(logs):
    return [{k: v for k, v in log.items()
             if k not in ("t", "epoch_seconds", "clouds_per_s")} for log in logs]


@pytest.mark.parametrize("args", [
    [], ["--streaming"], ["--compute_dtype", "bfloat16", "--param_dtype",
                          "bfloat16"],
    ["--task", "classification"],
])
def test_trainer_cli_device_cache_with_resume(args, tmp_path):
    """python -m ndtpu_torch.tools.train --device cpu --device_cache (the
    epoch scan on by default): an epoch with val and test evals and a
    checkpoint, every logged value finite; --resume continues at step 2.
    With --no-epoch_scan (the per-step loop over the device-resident
    dataset) the same run logs the same metrics."""
    out, logs = cli(args, tmp_path)
    assert len(logs) == 3 and all(np.isfinite(v) for log in logs
                                  for v in log.values())
    _, per_step = cli(args + ["--no-epoch_scan"], tmp_path)
    assert train_logs(per_step) == train_logs(logs)
    ckpt = out.split("saved checkpoint to ")[1].split()[0]
    out, logs = cli(args + ["--resume", ckpt], tmp_path)
    assert f"resumed from {ckpt} at step 2" in out
    assert all(np.isfinite(v) for log in logs for v in log.values())


def test_config_dtypes_and_refusals():
    """--compute_dtype / --param_dtype take jnp.dtype's names of the
    floating types torch has, and nothing else; the multiscale and
    PointNet trainers refuse --device_cache (the JAX ones ignore it)."""
    from ndtpu_torch.tools import train_multiscale, train_pointnet

    cfg = TrainConfig.from_args(["--device", "cpu", "--compute_dtype",
                                 "bfloat16", "--no-epoch_scan"])
    assert cfg.dtypes == {"dtype": torch.bfloat16, "param_dtype": torch.float32}
    assert cfg.epoch_scan is False
    assert TrainConfig.from_args(["--device", "cpu", "--param_dtype", "float16"]
                                 ).dtypes["param_dtype"] == torch.float16
    assert TrainConfig.from_args(["--device", "cpu", "--compute_dtype",
                                  "float64"]).dtypes["dtype"] == torch.float64
    for bad in ("bf16", "complex64", "int32"):
        with pytest.raises(ValueError, match="--compute_dtype"):
            TrainConfig.from_args(["--device", "cpu", "--compute_dtype", bad])
    for main in (train_multiscale.main, train_pointnet.main):
        with pytest.raises(SystemExit, match="--device_cache"):
            main(["--device", "cpu", "--device_cache"])


# ---- (h) bfloat16 checkpoints ----

def test_bf16_checkpoint_round_trip(tmp_path):
    """A bfloat16 state (compute and parameters) saves and restores
    bfloat16 tensors, bit for bit: weights, BatchNorm buffers, Adam's
    moments; the resumed step equals the run that never stopped."""
    from test_torch_port_train import clouds

    pts, labels = (torch.from_numpy(a) for a in clouds(9))
    step, _ = loop.make_ndt_seg_step(M, C, "fast")
    kw = dict(device="cpu", dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    sched = loop.make_lr_schedule(1e-2, 2)
    straight = create_train_state(C, F, sched, **kw)
    for _ in range(2):
        straight, _ = step(straight, pts, labels)
    first = create_train_state(C, F, sched, **kw)
    first, _ = step(first, pts, labels)
    path = save_checkpoint(first, str(tmp_path / "ckpt"))
    resumed = restore_checkpoint(create_train_state(C, F, sched, seed=9, **kw),
                                 path)
    for a, b in zip(first.model.state_dict().values(),
                    resumed.model.state_dict().values()):
        assert a.dtype == b.dtype == torch.bfloat16 and torch.equal(a, b)
    moments = [v for s in resumed.optimizer.state.values()
               for k, v in s.items() if k != "step"]
    assert moments and all(v.dtype == torch.bfloat16 for v in moments)
    resumed, _ = step(resumed, pts, labels)
    for a, b in zip(straight.model.state_dict().values(),
                    resumed.model.state_dict().values()):
        assert torch.equal(a, b)


def test_restore_settles_a_capturable_optimizer_on_the_cpu(tmp_path):
    """A checkpoint written by a graph's capturable optimizer (its rate a
    tensor, capturable on: ``make_capturable``) restores into a CPU state
    as the plain optimizer: the rate a number, capturable off, Adam's
    counters on the
    CPU (place_adam_steps, the one place that settles them)."""
    from test_torch_port_train import clouds

    pts, labels = (torch.from_numpy(a) for a in clouds(9))
    sched = loop.make_lr_schedule(1e-2, 2)
    state, _ = loop.make_ndt_seg_step(M, C, "fast")[0](
        create_train_state(C, F, sched, device="cpu"), pts, labels)
    path = save_checkpoint(state, str(tmp_path / "ckpt"))
    tree = torch.load(f"{path}/state.pt", weights_only=True)
    for group in tree["optimizer"]["param_groups"]:
        group["lr"], group["capturable"] = torch.tensor(0.5), True
    torch.save(tree, f"{path}/state.pt")
    resumed = restore_checkpoint(create_train_state(C, F, sched, device="cpu"),
                                 path)
    for group in resumed.optimizer.param_groups:
        assert group["capturable"] is False and isinstance(group["lr"], float)
    assert all(s["step"].device.type == "cpu" and float(s["step"]) == 1
               for s in resumed.optimizer.state.values())
