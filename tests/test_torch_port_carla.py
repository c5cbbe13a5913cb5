"""The port's CARLA data path against the JAX package: write_ply,
count_ply_points, the native PLY reader against the numpy one, CarlaSeg,
CarlaNDTSeg, the colour maps, make_dataset with a path and the NDT
segmentation trainer on PLY trees (--train_path/--val_path/--test_path).

PLY files are written by the tests into tmp_path; nothing is downloaded.
CarlaSeg draws from one numpy generator, so its items are compared bit
for bit. CarlaNDTSeg's FPS is compared exactly on a tree whose points are
exact in f32 arithmetic (integers times 1/4), and its NDT ground truth
against the JAX pipeline run op by op (``jax.disable_jit``): under ``jit``
XLA's FMAs can flip the KL of a 2- or 3-point voxel (ROADMAP.md, faults).
"""
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ndtpu.core.ndt import ndt_downsample as jax_downsample
from ndtpu.data import carla as jax_carla
from ndtpu.data import ply as jax_ply
from ndtpu.ops.fps import farthest_point_sampling as jax_fps
from ndtpu_torch.data import carla, ply
from ndtpu_torch.native import io as native
from ndtpu_torch.tools._common import IntLabels, make_dataset

ROOT = pathlib.Path(__file__).resolve().parent.parent


def ply_tree(root, n_files=3, n_points=300, n_classes=5, seed=0, exact=False):
    """A directory of PLY clouds with a class column in [0, n_classes]:
    normal points times 5, or with ``exact`` integers in [-64, 64) / 4."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    for i in range(n_files):
        if exact:
            pts = rng.integers(-64, 64, size=(n_points, 3)) / 4.0
        else:
            pts = rng.normal(size=(n_points, 3)) * 5
        classes = rng.integers(0, n_classes + 1, n_points)
        ply.write_ply(str(root / f"{i:03d}.ply"), pts, classes=classes)
    return str(root)


# ---- PLY ----

@pytest.mark.parametrize("colors,classes", [
    (None, None), ("float", None), ("int", "classes"), (None, "classes"),
])
def test_write_ply_bytes_equal_jax(tmp_path, colors, classes):
    """The same file, byte for byte: header, %.8g coordinates, colours as
    [0, 1] floats or [0, 255] ints, the class column."""
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(50, 3)) * 123.456
    kw = {}
    if colors == "float":
        kw["colors"] = rng.random((50, 3))
    elif colors == "int":
        kw["colors"] = rng.integers(0, 256, (50, 3))
    if classes:
        kw["classes"] = rng.integers(0, 29, 50)
    a = ply.write_ply(str(tmp_path / "port" / "a.ply"), pts, **kw)
    b = jax_ply.write_ply(str(tmp_path / "jax" / "a.ply"), pts, **kw)
    assert pathlib.Path(a).read_bytes() == pathlib.Path(b).read_bytes()


def test_count_ply_points_with_and_without_element_vertex(tmp_path):
    """The header's vertex count; for a header without ``element vertex``
    the body's lines, as the JAX function counts them."""
    path = ply.write_ply(str(tmp_path / "a.ply"), np.zeros((17, 3)))
    assert ply.count_ply_points(path) == jax_ply.count_ply_points(path) == 17
    bare = tmp_path / "b.ply"
    bare.write_bytes(b"ply\nformat ascii 1.0\nproperty double x\n"
                     b"end_header\n" + b"1 2 3\n" * 9)
    assert ply.count_ply_points(str(bare)) == jax_ply.count_ply_points(str(bare)) == 9
    with open(bare, "rb") as f:
        assert ply._parse_header(f) == (len(b"ply\nformat ascii 1.0\n"
                                            b"property double x\nend_header\n"), -1)


@pytest.mark.parametrize("rows,classes,crlf", [
    (300, True, False), (300, False, False), (9000, True, False),
    (9000, True, True),
])
def test_native_reader_equals_numpy_bitwise(tmp_path, rows, classes, crlf):
    """The native reader (built with g++ into build/ndtpu_torch/) against
    the numpy path, bit for bit, on files written by write_ply (%.8g) and
    with CRLF line ends; 9000 rows take its multi-threaded path. Both equal
    the JAX reader's."""
    rng = np.random.default_rng(rows)
    pts = rng.normal(size=(rows, 3)) * 1000
    cls = rng.integers(0, 29, rows) if classes else None
    path = ply.write_ply(str(tmp_path / "a.ply"), pts, classes=cls)
    if crlf:
        data = pathlib.Path(path).read_bytes().replace(b"\n", b"\r\n")
        pathlib.Path(path).write_bytes(data)
    got = ply.read_ply(path)
    want = ply.read_ply(path, use_native=False)
    for a, b, ref in zip(got, want, jax_ply.read_ply(path, use_native=False)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        np.testing.assert_array_equal(a, ref)
    assert got[0].shape == (rows, 3)
    lib = native.library()
    assert pathlib.Path(lib._name).parent.name == "ndtpu_torch"


def test_native_reader_raises(tmp_path):
    """No quiet fallback: a header error as the numpy path's ValueError, a
    body shorter than its header's count and a missing file as OSError."""
    (tmp_path / "bad.ply").write_text("ply\nformat ascii 1.0\n")
    with pytest.raises(ValueError, match="unterminated"):
        ply.read_ply(str(tmp_path / "bad.ply"))
    short = tmp_path / "short.ply"
    short.write_text("ply\nformat ascii 1.0\nelement vertex 5\nend_header\n"
                     "1 2 3\n4 5 6\n")
    with pytest.raises(OSError, match="fewer"):
        ply.read_ply(str(short))
    assert ply.read_ply(str(short), use_native=False)[0].shape == (2, 3)
    with pytest.raises(OSError):
        ply.read_ply(str(tmp_path / "missing.ply"))


# ---- datasets ----

def test_color_maps_match_jax():
    for color in ([1.0, 0.5, 0.0], [0.2, 0.4, 0.6], [0.0, 0.0, 1.0]):
        tag = carla.color_to_class(np.array(color))
        assert tag == jax_carla.color_to_class(np.array(color))
        np.testing.assert_array_equal(carla.class_to_color(tag),
                                      jax_carla.class_to_color(tag))
    assert carla.class_to_color(0xFF7F00).dtype == np.float32


def test_carla_seg_items_are_bitwise_the_jax_package(tmp_path):
    """Two passes over the tree (the generator carries on between them),
    against the JAX dataset's items; the class bound and the index bound
    raise as in the JAX dataset; make_dataset with a path gives CarlaSeg
    seeded 0 (and its int labels)."""
    path = ply_tree(tmp_path / "t", n_points=200)
    ours = carla.CarlaSeg(5, 64, path, seed=3)
    ref = jax_carla.CarlaSeg(5, 64, path, seed=3)
    assert len(ours) == len(ref) == 3
    for i in (0, 1, 2, 1, 0):
        for a, b in zip(ours[i], ref[i]):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    with pytest.raises(IndexError):
        ours[3]
    with pytest.raises(ValueError, match="out of bounds"):
        carla.CarlaSeg(4, 64, path)[0]
    with pytest.raises(FileNotFoundError):
        carla.CarlaSeg(5, 64, str(tmp_path / "nothing"))
    ds = make_dataset(5, 64, path, seed=9)
    assert isinstance(ds, carla.CarlaSeg)
    ref = jax_carla.CarlaSeg(5, 64, path)
    for a, b in zip(ds[1], ref[1]):
        np.testing.assert_array_equal(a, b)
    tags = make_dataset(5, 64, path, int_labels=True)
    assert isinstance(tags, IntLabels)
    ref = jax_carla.CarlaSeg(5, 64, path)
    np.testing.assert_array_equal(tags[2][1], np.argmax(ref[2][1], -1))


def test_carla_ndt_seg_items_match_jax(tmp_path):
    """FPS points exact on an exact-arithmetic tree; the one-hot of the
    kept NDs' labels against the JAX pipeline op by op (FPS, then the
    tagged reference downsample); the shapes differ as in the reference
    (FPS points, ND ground truth)."""
    path = ply_tree(tmp_path / "t", n_files=2, n_points=600, exact=True)
    ds = carla.CarlaNDTSeg(5, 160, 24, path, device="cpu")
    ref = jax_carla.CarlaNDTSeg(5, 160, 24, path)
    for i in range(2):
        pts, gt = ds[i]
        assert pts.shape == (160, 3) and gt.shape == (24, 6)
        assert pts.dtype == gt.dtype == np.float32
        want_pts, _ = ref[i]
        np.testing.assert_array_equal(pts, want_pts)
        points, classes = jax_ply.read_ply(os.path.join(path, f"00{i}.ply"))
        with jax.disable_jit():
            idx = np.asarray(jax_fps(jnp.asarray(points, jnp.float32), 160))
            labels = np.asarray(jax_downsample(
                jnp.asarray(points[idx].astype(np.float32)), 24, None,
                jnp.asarray(classes[idx].astype(np.int32)),
                num_class_slots=6)[2])
        np.testing.assert_array_equal(pts, points[idx].astype(np.float32))
        np.testing.assert_array_equal(gt, np.eye(6, dtype=np.float32)[labels])


# ---- the trainer ----

def test_ndt_trainer_cli_on_ply_trees_with_resume(tmp_path):
    """python -m ndtpu_torch.tools.train --device cpu with --train_path,
    --val_path and --test_path on CarlaSeg trees and --search grid: an
    epoch of 2 steps, val and test evals, a checkpoint; --resume
    continues at step 2."""
    paths = [ply_tree(tmp_path / split, n_files=4, n_points=700, n_classes=4,
                      seed=seed) for seed, split in enumerate(("tr", "va", "te"))]
    env = dict(os.environ, PYTHONPATH=str(ROOT))

    def run(args):
        proc = subprocess.run(
            [sys.executable, "-m", "ndtpu_torch.tools.train", "--device", "cpu",
             "--epochs", "1", "--batch_size", "2", "--n_samples", "512",
             "--n_desired_nds", "32", "--n_classes", "4", "--feature_dim",
             "16", "--save_every", "1", "--search", "grid", "--out_path",
             str(tmp_path / "out"), "--train_path", paths[0], "--val_path",
             paths[1], "--test_path", paths[2]] + args,
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        return proc.stdout, [json.loads(line) for line in proc.stdout.splitlines()
                             if line.startswith("{")]

    out, logs = run([])
    assert [sorted(k for k in log if k.endswith("mean_loss")) for log in logs] == [
        ["train_mean_loss"], ["val_mean_loss"], ["test_mean_loss"]]
    assert all(np.isfinite(v) for log in logs for v in log.values())
    ckpt = out.split("saved checkpoint to ")[1].split()[0]
    out, logs = run(["--resume", ckpt])
    assert f"resumed from {ckpt} at step 2" in out
    assert all(np.isfinite(v) for log in logs for v in log.values())
