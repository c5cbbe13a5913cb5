"""The port's tools (``python -m ndtpu_torch.tools.<name>``) against the
JAX package's, each run in process through its ``main(argv)`` with
``--device cpu`` on the same inputs as the JAX side, made from a seed.

- stream: the JAX tool's CLI checks (frame counts, PLYs, modes), then at
  the voxel size JAX's stream accepted on frame 0 the port's fixed-size
  frames keep JAX's NDs (integers exact, floats at tests/test_golden.py's
  tolerances); the host-side band monitor re-searches after a drifted
  frame.
- viz: the reference search's state equal to JAX's (voxel_size exact),
  then the port's emit and prune on the JAX state equal to JAX's. XLA's
  FMAs under ``jit`` can flip a 2- or 3-point voxel's KL (ROADMAP.md,
  faults), so the emitted NDs are compared on the JAX state.
- seg_viz: the port's ``segment`` with JAX's weights (load_jax_variables)
  predicts JAX's classes, JAX run op by op (``jax.disable_jit``).
- point_histogram: JAX's summary line, and a PNG.
- hyperparameter_search: the fallback's trials equal JAX's for a seed;
  the optuna branch runs through a stub module.
- export: a port checkpoint exported, loaded into a reference-layout
  stand-in and mapped back through torch_weights gives the same outputs.
- parity_train: tests/test_torch_port_parity_tool.py.
- the utils: print_matrix's text, timed and profile_trace.
"""
import argparse
import dataclasses
import functools
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndtpu.core import ndt as jn
from ndtpu.data.ply import write_ply as jax_write_ply
from ndtpu.utils import logging as jax_logging
from ndtpu_torch.core import ndt as tn
from ndtpu_torch.data.ply import read_ply
from ndtpu_torch.interop import load_jax_variables
from ndtpu_torch.models import NDTNetSegmentation, PointNetClassification
from ndtpu_torch.tools import (
    export,
    hyperparameter_search,
    parity_train,
    point_histogram,
    seg_viz,
    stream,
    viz,
)
from ndtpu_torch.tools._common import paint_classes
from ndtpu_torch.train.loop import make_lr_schedule
from ndtpu_torch.train.state import create_train_state, save_checkpoint
from ndtpu_torch.utils import logging as port_logging
from ndtpu_torch.utils.profiling import profile_trace, timed

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the JAX tools are scripts: tools/ for their `import _common`, the root
# for their `from tools... import`
for _p in (str(ROOT / "tools"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)
import tools.hyperparameter_search as jax_hps  # noqa: E402
import tools.point_histogram as jax_histogram  # noqa: E402
import tools.stream as jax_stream  # noqa: E402

# the reference-layout stand-in of a port model, beside this file
sys.path.insert(0, str(ROOT / "tests"))
from test_torch_port_interop import mirror  # noqa: E402

TOOLS = (stream, viz, seg_viz, point_histogram, hyperparameter_search, export,
         parity_train)


def port_state(js):
    """A single-cloud JAX NDTResult as the port's [1, ...] NDTResult."""
    return tn.NDTResult(**{
        f.name: torch.from_numpy(np.array(getattr(js, f.name)))[None]
        for f in dataclasses.fields(tn.NDTResult)
    })


INT_STATE = ("num_valid", "counts", "zyx", "lens", "class_hist", "converged")


def assert_same_state(st, js):
    """The port's state of one cloud against JAX's: the voxel size and the
    integers exact, means to rtol 1e-6 and covariances to rtol 1e-5 (the
    FMA note of tests/test_torch_port_ndt.py)."""
    vs = float(js.voxel_size)
    assert float(st.voxel_size[0]) == vs
    for name in INT_STATE:
        np.testing.assert_array_equal(getattr(st, name)[0].numpy(),
                                      np.asarray(getattr(js, name)),
                                      err_msg=name)
    np.testing.assert_allclose(st.means[0].numpy(), np.asarray(js.means),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(st.covs[0].numpy(), np.asarray(js.covs),
                               rtol=1e-5, atol=1e-6 * max(1.0, vs * vs))


def assert_same_nds(got, ref):
    """Emitted NDs of one cloud: the mask and labels exact, points to rtol
    1e-6 and covariances to rtol 1e-5 (tests/test_golden.py), with the
    state's atol for the FMA (assert_same_state)."""
    pcl, covs, labels, mask = (t[0].numpy() for t in got[:4])
    jp, jc, jl, jm = (np.asarray(t) for t in ref[:4])
    vs = float(ref[4].voxel_size)
    np.testing.assert_array_equal(mask, jm)
    np.testing.assert_array_equal(labels, jl)
    np.testing.assert_allclose(pcl, jp, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(covs, jc, rtol=1e-5,
                               atol=1e-6 * max(1.0, vs * vs))


# ---- stream ----

def test_stream_synthetic_frames_equal_jax():
    for a, b in zip(stream.synthetic_stream(3, 1000, seed=4),
                    jax_stream.synthetic_stream(3, 1000, seed=4)):
        np.testing.assert_array_equal(a, b)


def test_stream_cli_and_fixed_frames_keep_jax_nds(tmp_path, capsys):
    """The JAX tool's CLI test (tests/test_tools_cli.py:70-92) on the port,
    then the fixed-size frames at JAX's frame-0 size against JAX's."""
    out = tmp_path / "frames"
    stats, frames = stream.main([
        "--device", "cpu", "--n_frames", "6", "--n_points", "2048",
        "--n_desired_nds", "48", "--n_classes", "4", "--research_every", "3",
        "--out_dir", str(out)])
    captured = capsys.readouterr()
    assert json.loads(captured.out.strip().splitlines()[-1]) == stats
    assert (stats["frames"], stats["searched_frames"],
            stats["fixed_frames"]) == (6, 2, 4)
    assert stats["steady_hz"] > 0
    assert len(list(out.glob("frame_*.ply"))) == 6
    assert "warm" in captured.err and "search" in captured.err
    assert [f["mode"] for f in frames] == ["search", "warm", "warm"] * 2
    assert all(f["in_band"] for f in frames)

    # the size JAX's stream accepts on frame 0 (its jitted probe search),
    # then every frame at that size, as --mode fixed runs them
    clouds = list(stream.synthetic_stream(6, 2048))
    size = jax.jit(lambda p: jn.ndt_downsample(p, 48, search="probe"))(
        jnp.asarray(clouds[0]))[4].voxel_size
    fixed = jax.jit(lambda p, s: jn.ndt_downsample(p, 48, fixed_voxel_size=s))
    for pts in clouds[1:]:
        ref = fixed(jnp.asarray(pts), size)
        (got, mode) = stream.downsample_frame(
            torch.from_numpy(pts)[None], 48, "fixed",
            torch.tensor([float(size)]), "probe")
        assert mode == "fixed"
        assert_same_state(got[4], ref[4])
        assert_same_nds(got, ref)


def write_frames(path, clouds):
    path.mkdir()
    for i, pts in enumerate(clouds):
        jax_write_ply(str(path / f"{i:03d}.ply"), pts)
    return str(path)


def test_stream_fixed_mode_re_searches_after_a_drifted_frame(tmp_path,
                                                             capsys):
    """--mode fixed with --frames_path and a checkpoint's model: a frame
    three times as wide leaves the band at the fixed size, and the next
    frame searches anew; the PLYs' colours are the model's classes."""
    clouds = list(stream.synthetic_stream(5, 2048, seed=1))
    clouds[2] = clouds[2] * 3.0
    frames_dir = write_frames(tmp_path / "in", clouds)
    state = create_train_state(3, 16, make_lr_schedule(1e-3, 1), seed=2,
                               device="cpu")
    ckpt = save_checkpoint(state, str(tmp_path / "ckpt"))
    out = tmp_path / "out"
    stats, frames = stream.main([
        "--device", "cpu", "--frames_path", frames_dir, "--n_desired_nds",
        "32", "--mode", "fixed", "--checkpoint", ckpt, "--out_dir",
        str(out)])
    err = capsys.readouterr().err
    assert "3 classes, feature_dim 16" in err
    assert [f["mode"] for f in frames] == [
        "search", "fixed", "fixed", "search", "fixed"]
    assert [f["in_band"] for f in frames] == [True, True, False, True, True]
    assert "OUT-OF-BAND -> re-search" in err
    assert (stats["searched_frames"], stats["fixed_frames"]) == (2, 3)
    # frame 3 (searched): its PLY holds the kept NDs coloured by the
    # model's argmax
    (pcl, covs, _, mask, _), mode = stream.downsample_frame(
        torch.from_numpy(clouds[3])[None], 32, "fixed", None, "probe")
    assert mode == "search"
    pred = stream.classify(state.model.eval(), pcl, covs)
    keep = mask[0].numpy()
    lines = (out / "frame_0003.ply").read_text().splitlines()
    rows = np.loadtxt(lines[lines.index("end_header") + 1:], ndmin=2)
    np.testing.assert_allclose(rows[:, :3], pcl[0].numpy()[keep], rtol=1e-7)
    np.testing.assert_array_equal(
        rows[:, 3:], (paint_classes(pred[keep]) * 255).astype(np.uint16))


# ---- viz ----

def test_viz_matches_jax_state_emit_and_prune(tmp_path, capsys):
    result = viz.main(["--device", "cpu", "--n_points", "2000", "--target",
                       "32", "--target1", "16", "--n_classes", "28",
                       "--repeats", "1", "--out_dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "Hz" in out  # the reference's timing protocol (viz.py:106)
    assert (tmp_path / "downsampled.ply").exists()
    assert (tmp_path / "pruned.ply").exists()

    from ndtpu.data.synthetic import random_cloud as jax_random_cloud
    from ndtpu_torch.data.synthetic import random_cloud

    points = random_cloud(2000, seed=0)
    np.testing.assert_array_equal(points, jax_random_cloud(2000, seed=0))
    ref = jn.ndt_downsample(jnp.asarray(points), 32, None,
                            jnp.zeros((2000,), jnp.int32), num_class_slots=29)
    js = ref[4]
    assert_same_state(result["downsampled"][4], js)
    emitted = tn._emit(port_state(js), 32)
    for e, r in zip(emitted, ref[:4]):
        np.testing.assert_array_equal(e[0].numpy(), np.asarray(r))
    pruned = tn.ndt_prune(port_state(js), 16)
    for e, r in zip(pruned, jn.ndt_prune(js, 16)):
        np.testing.assert_array_equal(e[0].numpy(), np.asarray(r))
    assert int(result["pruned"][3].sum()) == 16


# ---- seg_viz ----

def seeded_flax_variables(jmodel, m, seed):
    """Variables of a flax NDT-Net model drawn with numpy from ``seed``
    (N(0, 0.3); running variances in [0.5, 1.5)), shaped by
    ``jax.eval_shape`` of its init, which compiles nothing."""
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, m, 3)), jnp.zeros((1, m, 9)),
        train=False))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if jax.tree_util.keystr(path).endswith("['var']"):
            return (rng.random(leaf.shape) + 0.5).astype(np.float32)
        return rng.normal(scale=0.3, size=leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def test_seg_viz_segment_predicts_jax_classes(tmp_path, capsys):
    from ndtpu.models import NDTNetSegmentation as JaxSeg
    from ndtpu.preprocessing.batch import ndt_preprocessing_with_state
    from ndtpu_torch.tools._common import make_dataset

    n_classes, feature_dim, m = 6, 32, 24
    points, _ = make_dataset(n_classes, 256, None)[0]
    jmodel = JaxSeg(num_classes=n_classes, feature_dim=feature_dim)
    variables = seeded_flax_variables(jmodel, m, seed=3)
    with jax.disable_jit():
        pcl, covs, _, mask, _ = ndt_preprocessing_with_state(
            m, jnp.asarray(points)[None], None, n_classes)
    logp = jax.jit(lambda v, p, c: jmodel.apply(v, p, c, train=False))(
        variables, pcl, covs)
    want = np.asarray(jnp.argmax(logp, axis=-1))[0]
    kept = np.asarray(mask)[0]

    model = load_jax_variables(
        NDTNetSegmentation(num_classes=n_classes, feature_dim=feature_dim,
                           device="cpu"), variables).eval()
    got_pcl, pred, got_kept = seg_viz.segment(points, model, m, n_classes)
    np.testing.assert_array_equal(got_kept, kept)
    np.testing.assert_allclose(got_pcl, np.asarray(pcl)[0], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(pred[kept], want[kept])

    out = tmp_path / "seg.ply"
    seg_viz.main(["--device", "cpu", "--n_samples", "256", "--n_desired_nds",
                  str(m), "--n_classes", str(n_classes), "--feature_dim",
                  str(feature_dim), "--out", str(out)])
    assert f"({m} NDs)" in capsys.readouterr().out
    pts, classes = read_ply(str(out))
    assert pts.shape == (m, 3) and classes.shape == (m,)


# ---- point_histogram ----

def test_point_histogram_prints_jax_line(tmp_path, capsys, monkeypatch):
    d = tmp_path / "plys"
    d.mkdir()
    for i in range(3):
        jax_write_ply(str(d / f"{i}.ply"),
                      np.random.default_rng(i).normal(size=(50 + i, 3)))
    monkeypatch.setattr(sys, "argv", ["point_histogram.py", "--path", str(d),
                                      "--out", str(tmp_path / "jax.png")])
    jax_histogram.main()
    want = capsys.readouterr().out.splitlines()[0]
    out = tmp_path / "hist.png"
    counts = point_histogram.main(["--path", str(d), "--out", str(out)])
    got = capsys.readouterr().out.splitlines()
    assert got[0] == want and "3 files" in want
    assert list(counts) == [50, 51, 52]
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


# ---- hyperparameter_search ----

HPS_ARGS = ["--n_trials", "2", "--epochs", "1", "--n_samples", "256",
            "--n_desired_nds", "16", "--n_classes", "4", "--feature_dim",
            "32", "--seed", "5"]


def recording(factory, trials):
    """objective_factory wrapped so each trial's parameters are kept."""
    def wrapped(args):
        objective = factory(args)

        def record(name, batch_size, lr):
            trials.append((str(name), batch_size, lr))
            return objective(name, batch_size, lr)

        return record

    return wrapped


def test_hyperparameter_search_fallback_draws_jax_trials(monkeypatch, capsys):
    jax_trials, port_trials = [], []
    monkeypatch.setattr(jax_hps, "objective_factory", lambda args: (
        lambda name, b, lr: jax_trials.append((str(name), b, lr)) or 1.0))
    monkeypatch.setattr(sys, "argv", ["hyperparameter_search.py", *HPS_ARGS])
    jax_hps.main()
    monkeypatch.setattr(hyperparameter_search, "objective_factory",
                        recording(hyperparameter_search.objective_factory,
                                  port_trials))
    loss, params = hyperparameter_search.main(["--device", "cpu", *HPS_ARGS])
    captured = capsys.readouterr()
    assert "random search" in captured.err
    assert port_trials == jax_trials and len(port_trials) == 2
    assert np.isfinite(loss) and "best:" in captured.out
    assert (str(params["optimizer"]), params["batch_size"],
            params["learning_rate"]) in port_trials
    with pytest.raises(NotImplementedError, match="--use_pallas"):
        hyperparameter_search.main(["--device", "cpu", "--no_pallas"])


OPTUNA_STUB = '''
"""Minimal optuna stand-in: random suggest + sequential study (enough to
drive tools/hyperparameter_search.py's real optuna branch)."""
import random


class _Trial:
    def __init__(self, rng):
        self._rng = rng
        self.params = {}

    def suggest_categorical(self, name, choices):
        v = self._rng.choice(choices)
        self.params[name] = v
        return v

    def suggest_int(self, name, lo, hi):
        v = self._rng.randint(lo, hi)
        self.params[name] = v
        return v

    def suggest_float(self, name, lo, hi, log=False):
        import math
        if log:
            v = math.exp(self._rng.uniform(math.log(lo), math.log(hi)))
        else:
            v = self._rng.uniform(lo, hi)
        self.params[name] = v
        return v


class _Study:
    def __init__(self):
        self.best_value = float("inf")
        self.best_params = None

    def optimize(self, objective, n_trials):
        rng = random.Random(0)
        for _ in range(n_trials):
            trial = _Trial(rng)
            value = objective(trial)
            if value < self.best_value:
                self.best_value = value
                self.best_params = trial.params


def create_study(direction="minimize"):
    return _Study()
'''


def test_hyperparameter_search_optuna_branch(tmp_path, monkeypatch, capsys):
    """The optuna branch (the reference's :29-31 space) through the stub
    of tests/test_tools_cli.py."""
    (tmp_path / "optuna.py").write_text(OPTUNA_STUB)
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.delitem(sys.modules, "optuna", raising=False)
    try:
        value, params = hyperparameter_search.main(["--device", "cpu",
                                                    *HPS_ARGS])
    finally:
        sys.modules.pop("optuna", None)
    captured = capsys.readouterr()
    assert "best:" in captured.out
    assert "random search" not in captured.err
    assert np.isfinite(value)
    assert set(params) == {"optimizer", "batch_size", "learning_rate"}



# the objective held to JAX's: 4 clouds of 512 points, so one epoch at batch
# size 2 is two steps
HPS_LOSS_ARGS = ["--n_samples", "512", "--n_desired_nds", "32",
                 "--n_classes", "4", "--feature_dim", "32", "--epochs", "1"]


@pytest.mark.parametrize("optimizer,lr", [("Adam", 1e-3), ("SGD", 3e-2)])
def test_hyperparameter_objective_matches_jax_from_its_weights(
        monkeypatch, optimizer, lr):
    """One trial's ``last_loss`` (an epoch of two steps at batch size 2)
    from JAX's ``PRNGKey(0)`` weights against JAX's objective on the same
    synthetic set, within rtol 1e-6.

    JAX's objective runs as it is (its optimizer, mesh, loader,
    ``run_epoch`` and jitted step body) with its ``NDTNetSegmentation`` in
    float64 (dtype and param_dtype, under ``jax.enable_x64``), its
    ``create_train_state``'s init jitted, and one change: each step's
    preprocessing (``_make_prep``'s function, float32,
    x64 off) runs op by op before the jitted step, which receives its
    outputs in place of the clouds. Under ``jit`` XLA's FMAs can flip a 2-
    or 3-point voxel's KL and so the kept NDs (ROADMAP.md, faults). The
    port's objective gets JAX's variables through ``init``
    (``load_jax_variables`` into the model cast to float64).

    The tolerance: the two frameworks' float32 preprocessing agrees to the
    last ulps of the covariances (tests/test_golden.py's rtol 1e-6 and
    1e-5), which moves the float64 loss after an SGD step by 2.4e-8 relative
    (Adam's first update, lr * g / (|g| + eps), hides it: 7e-12). 1e-6 still catches a wrong optimizer, rate or loss: the step
    moves the loss by more than 1e-3."""
    from ndtpu.models import NDTNetSegmentation as JaxSegmentation
    from ndtpu.train import loop as jloop
    from ndtpu.train.state import TrainState as JaxTrainState
    from ndtpu_torch.tools import _common

    recorded = {}

    def recording_cts(model, tx, rng, *inputs, init_kwargs=None):
        """JAX's create_train_state with its init jitted (op by op it
        takes seconds), keeping the variables for the port."""
        variables = jax.jit(lambda key: model.init(
            key, *inputs, **(init_kwargs or {})))(rng)
        recorded["variables"] = jax.tree_util.tree_map(np.asarray,
                                                       dict(variables))
        return JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=variables["params"],
            batch_stats=variables["batch_stats"],
            opt_state=tx.init(variables["params"]), tx=tx,
            apply_fn=model.apply)

    jax_make_prep, jax_make_step = jloop._make_prep, jloop.make_ndt_seg_step

    def make_step_prep_op_by_op(n, c, use_pallas, search, mesh, axis):
        prep = jax_make_prep(n, c, use_pallas, search, None, axis)
        step, _ = jax_make_step(n, c, use_pallas, search, mesh, axis)

        def stepped(state, points, gt):
            with jax.enable_x64(False), jax.disable_jit():
                pre = prep(points, gt)
            return step(state, pre, None)

        return stepped, None

    monkeypatch.setattr(jax_hps, "create_train_state", recording_cts)
    monkeypatch.setattr(jax_hps, "NDTNetSegmentation", functools.partial(
        JaxSegmentation, dtype=jnp.float64, param_dtype=jnp.float64))
    # the jitted step's prep hands on what it is given: the op-by-op outputs
    monkeypatch.setattr(jloop, "_make_prep", lambda *a: lambda pre, _: pre)
    monkeypatch.setattr(jax_hps, "make_ndt_seg_step", make_step_prep_op_by_op)
    monkeypatch.setattr(jax_hps, "make_dataset", functools.partial(
        jax_hps.make_dataset, synthetic_length=4))
    monkeypatch.setattr(hyperparameter_search, "make_dataset",
                        functools.partial(_common.make_dataset,
                                          synthetic_length=4))
    jax_args = argparse.Namespace(
        train_path=None, search="fast", use_pallas=False,
        **{a[2:]: int(v) for a, v in zip(HPS_LOSS_ARGS[::2],
                                         HPS_LOSS_ARGS[1::2])})
    with jax.enable_x64(True):
        want = jax_hps.objective_factory(jax_args)(optimizer, 2, lr)
    port_args = argparse.Namespace(device="cpu", **vars(jax_args))
    got = hyperparameter_search.objective_factory(
        port_args, init=lambda m: load_jax_variables(
            m.double(), recorded["variables"]))(optimizer, 2, lr)
    assert np.isfinite(want)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # the default init is unchanged: seed 0's weights, another loss
    default = hyperparameter_search.objective_factory(port_args)(
        optimizer, 2, lr)
    assert np.isfinite(default) and default != got

# ---- export ----

@pytest.mark.parametrize("arch,task,model_cls", [
    ("ndtnet", "segmentation", NDTNetSegmentation),
    ("pointnet", "classification", PointNetClassification),
])
def test_export_round_trip_gives_equal_outputs(tmp_path, capsys, arch, task,
                                               model_cls):
    from ndtpu_torch.interop import torch_weights

    state = create_train_state(5, 16, make_lr_schedule(1e-3, 1), seed=7,
                               device="cpu", model=model_cls)
    state.step = 3
    ckpt = save_checkpoint(state, str(tmp_path / "ckpt"))
    out = tmp_path / "out" / "model.pt"
    export.main(["--device", "cpu", "--checkpoint", ckpt, "--arch", arch,
                 "--task", task, "--n_classes", "5", "--feature_dim", "16",
                 "--out", str(out)])
    assert "from step 3" in capsys.readouterr().out
    tree = torch.load(str(out), weights_only=True)
    backbone = torch.load(str(tmp_path / "out" / "model_backbone.pt"),
                          weights_only=True)
    # the files load into the reference layout as they are
    mirror(state.model).load_state_dict(tree)
    mirror(state.model.feature_extractor).load_state_dict(backbone)
    fresh = model_cls(num_classes=5, feature_dim=16, device="cpu")
    getattr(torch_weights, f"map_{arch}_{task}")(tree, fresh)
    rng = np.random.default_rng(8)
    pts = torch.from_numpy(rng.normal(size=(2, 20, 3)).astype(np.float32))
    args = (pts,) if arch == "pointnet" else (
        pts, torch.from_numpy(rng.normal(size=(2, 20, 9)).astype(np.float32)))
    with torch.no_grad():
        assert torch.equal(fresh.eval()(*args), state.model.eval()(*args))


# ---- every tool ----

@pytest.mark.parametrize("tool", TOOLS, ids=lambda t: t.__name__)
def test_tool_help(tool, capsys):
    with pytest.raises(SystemExit) as exit_:
        tool.main(["--help"])
    assert exit_.value.code == 0
    assert "usage" in capsys.readouterr().out


def test_tools_raise_without_a_card(monkeypatch, tmp_path):
    """On the card by default: without one a tool raises, never carries on
    on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        (stream, ["--n_frames", "1", "--n_points", "512"]),
        (viz, ["--n_points", "512", "--out_dir", str(tmp_path)]),
        (seg_viz, ["--n_samples", "256", "--out", str(tmp_path / "s.ply")]),
        (hyperparameter_search, ["--n_trials", "1"]),
        (export, ["--checkpoint", str(tmp_path), "--n_classes", "4", "--out",
                  str(tmp_path / "e.pt")]),
        (parity_train, ["--train_size", "4"]),
    ]
    for tool, argv in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            tool.main(argv)


# ---- utils ----

def test_print_matrix_and_logger_text(capsys):
    m = np.arange(6, dtype=np.float32).reshape(2, 3) / 3
    jax_logging.print_matrix(m.reshape(-1), 2, 3, file=sys.stdout)
    want = capsys.readouterr().out
    port_logging.print_matrix(torch.from_numpy(m).reshape(-1), 2, 3)
    assert capsys.readouterr().out == want == (
        "0.000000 0.333333 0.666667\n1.000000 1.333333 1.666667\n")
    logger = port_logging.get_logger()
    assert logger.name == "ndtpu_torch" and len(logger.handlers) == 1
    assert port_logging.get_logger() is logger and len(logger.handlers) == 1


def test_timed_and_profile_trace(tmp_path, capsys):
    x = torch.arange(1000.0)
    with profile_trace(str(tmp_path / "trace")):
        with timed("sum", sync=lambda: y) as t:
            y = (x * 2).sum()
    assert t["seconds"] > 0 and float(y) == 999000.0
    assert "[timed] sum:" in capsys.readouterr().out
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]
