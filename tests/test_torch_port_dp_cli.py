"""The port's trainers as two real gloo processes on the CPU against one
process with the same global batch (the port's counterpart of
tests/test_multihost.py).

Each trainer runs as ``python -m ndtpu_torch.tools.<trainer> --device cpu
--coordinator localhost:<port> --num_processes 2 --process_id i``: every
process follows the same global batch schedule and loads its half of
each batch, and the steps compute the global batch's loss, BatchNorm
statistics and gradients. At lr 0 the whole step still runs (the
preprocessing, the forward, the loss, the gradients and their
all-reduce, the BatchNorm running statistics) and only the update is
zero, so the epoch metrics of two processes must equal one process's to
f32 reduction-order noise: rtol 1e-5 on the losses, atol 1e-6 on the
accuracies (tests/test_multihost.py:222-235). Rank 1 logs and prints
nothing. The float64 update path and the device-resident epoch are in
tests/test_torch_port_dp_epoch.py.
"""
import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

COMMON = ["--device", "cpu", "--epochs", "1", "--batch_size", "4",
          "--n_samples", "256", "--n_classes", "4", "--feature_dim", "32",
          "--synthetic_length", "16", "--save_every", "1000", "--no-wandb",
          "--learning_rate", "0.0"]

CASES = {
    "segmentation": ("train", ["--n_desired_nds", "32"]),
    "classification": ("train", ["--task", "classification",
                                 "--n_desired_nds", "32", "--n_classes", "8"]),
    "multiscale": ("train_multiscale", ["--n_desired_nds", "32",
                                        "--n_desired_nds1", "16"]),
    "pointnet": ("train_pointnet", ["--n_samples", "128"]),
}


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def command(trainer, flags, out):
    return [sys.executable, "-m", f"ndtpu_torch.tools.{trainer}", *flags,
            "--out_path", str(out)]


def metrics(stdout):
    """The JSON metric lines merged into one {key: value}."""
    merged = {}
    for line in stdout.splitlines():
        if line.startswith("{"):
            merged.update(json.loads(line))
    assert "val_mean_loss" in merged, stdout
    return merged


def wait(procs):
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))
    return outs


def env():
    """Two threads a process: the two ranks and the tests' other workers
    share the machine's cores."""
    return dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")


def two_processes(trainer, flags, tmp_path, tag, check=True):
    """The trainer as ranks 0 and 1 of a gloo group; returns rank 0's
    metrics or, without ``check``, each rank's (exit code, stdout,
    stderr)."""
    port = free_port()
    procs = [subprocess.Popen(
        command(trainer, [*flags, "--coordinator", f"localhost:{port}",
                          "--num_processes", "2", "--process_id", str(rank)],
                tmp_path / f"{tag}{rank}"),
        cwd=ROOT, env=env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in (0, 1)]
    outs = wait(procs)
    if not check:
        return outs
    for rc, out, err in outs:
        assert rc == 0, out + err[-3000:]
    assert outs[1][1] == "", outs[1][1]  # rank 1 prints nothing
    assert "Done." in outs[0][1]
    return metrics(outs[0][1])


def one_process(trainer, flags, tmp_path, tag):
    proc = subprocess.run(command(trainer, flags, tmp_path / tag), cwd=ROOT,
                          env=env(), capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    return metrics(proc.stdout)


@pytest.mark.parametrize("case", list(CASES))
def test_two_processes_match_one_process_at_lr_0(tmp_path, case):
    """Each trainer (the NDT trainer for segmentation and classification,
    the multiscale and the PointNet trainers): the train, val (and test)
    losses of 2 processes within rtol 1e-5 of 1 process's, the
    accuracies within 1e-6."""
    trainer, flags = CASES[case]
    flags = COMMON + flags
    m2 = two_processes(trainer, flags, tmp_path, "d")
    m1 = one_process(trainer, flags, tmp_path, "s")
    assert {k for k in m1 if "mean" in k} == {k for k in m2 if "mean" in k}
    for k, v in m1.items():
        if k.endswith("_loss"):
            np.testing.assert_allclose(m2[k], v, rtol=1e-5, err_msg=k)
        elif k.endswith("_accuracy"):
            np.testing.assert_allclose(m2[k], v, atol=1e-6, err_msg=k)
