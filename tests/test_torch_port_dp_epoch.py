"""The NDT trainer's update path and its device-resident epoch as two
real gloo processes on the CPU (the port's counterpart of
tests/test_multihost.py:106-178 and :264-284); the helpers and the lr 0
runs of every trainer are in tests/test_torch_port_dp_cli.py.
"""
import numpy as np

from test_torch_port_dp_cli import COMMON, one_process, two_processes


def test_two_processes_match_one_process_float64_at_lr_1e_3(tmp_path):
    """2 epochs of real Adam steps at lr 1e-3 with float64 compute and
    parameters: the gradient all-reduce and the replicated update keep
    2 processes within rtol 1e-6 of 1 process (train and val losses) and
    the val accuracy within 1e-6; and learning happened."""
    flags = list(COMMON) + ["--n_desired_nds", "32", "--compute_dtype",
                            "float64", "--param_dtype", "float64"]
    flags[flags.index("--epochs") + 1] = "2"
    flags[flags.index("--learning_rate") + 1] = "1e-3"
    m2 = two_processes("train", flags, tmp_path, "x")
    m1 = one_process("train", flags, tmp_path, "xs")
    for k in ("train_mean_loss", "val_mean_loss"):
        np.testing.assert_allclose(m2[k], m1[k], rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(m2["val_mean_accuracy"],
                               m1["val_mean_accuracy"], atol=1e-6)
    assert m1["train_mean_loss"] != m1["val_mean_loss"]


def test_two_process_epoch_scan_matches_the_two_process_loader(tmp_path):
    """--device_cache with two processes: each holds its block of every
    split (a sharded DeviceCachedDataset) and the epoch scan (the
    sync-free loop on the CPU) assembles each rank's slice of the global
    batches; its metrics equal the two-process per-step loader's at lr 0
    (rtol 1e-5, the test accuracy within 1e-6; tests/test_multihost.py:
    264-284)."""
    flags = COMMON + ["--n_desired_nds", "32"]
    m_scan = two_processes("train", flags + ["--device_cache"], tmp_path, "c")
    m_step = two_processes("train", flags, tmp_path, "p")
    for k in ("train_mean_loss", "val_mean_loss", "test_mean_loss"):
        np.testing.assert_allclose(m_scan[k], m_step[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(m_scan["test_mean_accuracy"],
                               m_step["test_mean_accuracy"], atol=1e-6)


def test_two_process_device_cache_needs_the_epoch_scan(tmp_path):
    """Multi-process --device_cache --no-epoch_scan exits with the JAX
    trainer's message (tools/train.py:232-238) on both ranks."""
    outs = two_processes("train", COMMON + ["--device_cache", "--no-epoch_scan"],
                         tmp_path, "n", check=False)
    for rc, out, err in outs:
        assert rc != 0
        assert "multi-process --device_cache requires --epoch_scan" in err
