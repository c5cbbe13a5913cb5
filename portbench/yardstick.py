"""The benchmark's arithmetic: the card's published peaks, the models'
operations from their shapes, and K1's bytes.

Kept here, beside the benchmark, so that a change to the program cannot
change how it is measured; each model family's ``forward_flops``
(``portbench/families/``) sums the counts below over its layers. Peaks: NVIDIA H100 SXM data sheet, dense
rates; the port computes in float32 with TF32 off, outside the tensor
cores.
"""
from __future__ import annotations

PEAK_F32_FLOPS = 67e12       # float32, CUDA cores
PEAK_BYTES_PER_S = 3.35e12   # HBM3


def dense_macs(rows: int, i: int, o: int) -> int:
    return rows * i * o


def tnet_macs(b: int, n: int, d: int) -> int:
    """A T-Net over [B, N, d]: three pointwise layers, the pooled FCs."""
    return (dense_macs(b * n, d, 64) + dense_macs(b * n, 64, 128)
            + dense_macs(b * n, 128, 1024) + dense_macs(b, 1024, 512)
            + dense_macs(b, 512, 256) + dense_macs(b, 256, d * d))


def ndtnet_macs(b: int, n: int, f: int, extra: int = 0) -> int:
    """The NDT-Net backbone over [B, N] NDs: T-Net(3), the input
    transform of the points (3 x 3) and covariances (3 x 3 x 3), conv1,
    T-Net(64), the feature transform (64 x 64), conv2, conv3 (to f)."""
    rows = b * n
    return (tnet_macs(b, n, 3) + rows * (9 + 27)
            + dense_macs(rows, 12 + extra, 64) + tnet_macs(b, n, 64)
            + rows * 64 * 64 + dense_macs(rows, 64, 128)
            + dense_macs(rows, 128, f))


def seg_head_macs(rows: int, i: int, n_classes: int) -> int:
    return (dense_macs(rows, i, 512) + dense_macs(rows, 512, 256)
            + dense_macs(rows, 256, 128) + dense_macs(rows, 128, n_classes + 1))


def k1_bytes(points: int, clouds: int, segments: int, slots: int,
             tags: int = 3) -> int:
    """K1's least traffic: each kept point's staged columns read once
    (segment id, the three shifted coordinates, validity, the tags, and
    the class when there are class slots; 4 bytes each) and the
    [clouds, segments, 13 + slots + tags] float32 rows written once."""
    cols_in = 5 + tags + (1 if slots else 0)
    return 4 * points * cols_in + 4 * clouds * segments * (13 + slots + tags)


def k1_bound_s(points: int, clouds: int, segments: int, slots: int,
               tags: int = 3) -> float:
    """K1's least time: its bytes at the memory rate, or its operations
    (16 + tags + slots a point) at the float32 rate, whichever is
    larger."""
    t_bytes = k1_bytes(points, clouds, segments, slots, tags) / PEAK_BYTES_PER_S
    t_ops = points * (16 + tags + slots) / PEAK_F32_FLOPS
    return max(t_bytes, t_ops)
