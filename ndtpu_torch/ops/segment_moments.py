"""Fused NDT segment-moment reduction: CUDA kernel, plain version, wrapper.

Port of ``ndtpu/ops/pallas/segment_moments.py::fused_moments_sorted`` (the
TPU kernel ``_moments_kernel``). The kernel is
``ndtpu_torch/csrc/segment_moments.cu``; its header says how it is laid out
and what bounds it on an H100. ``fused_moments_sorted`` launches it for
CUDA tensors and runs ``fused_moments_sorted_plain`` only for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ndtpu_torch.ops import _build

SOURCE = "segment_moments.cu"
MAX_TAGS = 8  # NDTPU_MAX_TAGS in the source
N_MOMENTS = 13


def segment_sum_sorted_plain(feats, seg_ids, num_segments: int):
    """Sum ``feats`` [..., N, F] by ``seg_ids`` [..., N] into
    [..., num_segments, F]; ids outside [0, num_segments) are dropped.
    Plain PyTorch (``index_add_``), one call for all leading dims."""
    lead = feats.shape[:-2]
    n, f = feats.shape[-2:]
    feats = feats.reshape(-1, n, f)
    seg = seg_ids.reshape(-1, n).long()
    b = feats.shape[0]
    rows = num_segments + 1  # row num_segments collects the dropped ids
    seg = torch.where((seg >= 0) & (seg < num_segments), seg, num_segments)
    ids = seg + torch.arange(b, device=seg.device)[:, None] * rows
    out = torch.zeros(b * rows, f, dtype=feats.dtype, device=feats.device)
    out.index_add_(0, ids.reshape(-1), feats.reshape(b * n, f))
    return out.reshape(lead + (rows, f))[..., :num_segments, :]


def moment_columns(xt, yt, zt, v, cls, slots: int, tags=()):
    """The materialised feature columns [..., N, 13 + slots + T] of
    ndtpu/core/moments.py:118-130, in that order."""
    cols = [
        v, xt, yt, zt,
        xt * xt, xt * yt, xt * zt,
        yt * xt, yt * yt, yt * zt,
        zt * xt, zt * yt, zt * zt,
    ]
    cols += [v * (cls == c) for c in range(slots)]
    cols += list(tags)
    return torch.stack(cols, dim=-1)


def fused_moments_sorted_plain(xt, yt, zt, v, cls, seg_ids, num_segments: int,
                               slots: int, tags=None):
    """Plain PyTorch version of the kernel: the materialised columns, then
    a segment sum into [..., num_segments, 13 + slots + T]."""
    feats = moment_columns(xt, yt, zt, v, cls, slots, tuple(tags or ()))
    return segment_sum_sorted_plain(feats, seg_ids, num_segments)


def fused_moments_error_bound(xt, yt, zt, v, cls, seg_ids, num_segments: int,
                              slots: int, tags=None):
    """Bound on the kernel's f32 rounding error, per output entry (f64).

    In the kernel a lane adds ceil(L/32) terms of its segment (L rows) in
    order and a 5-level tree adds the lanes, so to first order
    |kernel - exact| <= (ceil(L/32) + 6) * 2**-24 * sum|terms| (the +1
    covers the rounding of the products themselves)."""
    tags = tuple(t.double() for t in tags or ())
    cols = moment_columns(xt.double(), yt.double(), zt.double(), v.double(),
                          cls, slots, tags)
    mag = segment_sum_sorted_plain(cols.abs(), seg_ids, num_segments)
    rows = segment_sum_sorted_plain(torch.ones_like(cols[..., :1]), seg_ids,
                                    num_segments)
    return (torch.ceil(rows / 32) + 6) * 2.0**-24 * mag


@functools.cache
def _kernel():
    """Build (at first use) and bind the kernel's C entry point."""
    fn = _build.load(SOURCE).ndtpu_segment_moments
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 6                  # seg, xt, yt, zt, v, cls
        + [ctypes.POINTER(ctypes.c_void_p)]    # tag column pointers
        + [ctypes.c_int] * 5                   # n_tags, batch, n, K, slots
        + [ctypes.c_void_p, ctypes.c_void_p]   # out, stream
    )
    return fn


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _launch(xt, yt, zt, v, cls, seg_ids, num_segments, slots, tags):
    n = seg_ids.shape[-1]
    batch = seg_ids.numel() // max(n, 1)
    out = torch.empty(tuple(seg_ids.shape[:-1])
                      + (num_segments, N_MOMENTS + slots + len(tags)),
                      dtype=torch.float32, device=seg_ids.device)
    tag_ptrs = (ctypes.c_void_p * max(1, len(tags)))(
        *[t.data_ptr() for t in tags]
    )
    stream = torch.cuda.current_stream(seg_ids.device).cuda_stream
    err = _kernel()(
        seg_ids.data_ptr(), xt.data_ptr(), yt.data_ptr(), zt.data_ptr(),
        v.data_ptr(), cls.data_ptr() if slots else None, tag_ptrs,
        len(tags), batch, n, num_segments, slots, out.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"segment_moments kernel launch failed: CUDA error {err}")
    fused_moments_sorted.launches += 1
    return out


def fused_moments_sorted(xt, yt, zt, v, cls, seg_ids, num_segments: int,
                         slots: int, tags=None):
    """NDT Gaussian-moment accumulation from compact inputs.

    xt/yt/zt: [..., N] f32 voxel-center-shifted coordinates, pre-masked
    (invalid rows zero). v: [..., N] f32 validity (0 or 1). cls: [..., N]
    int32 class tags, or None when ``slots == 0``. seg_ids: [..., N] int32
    dense sorted ranks (non-decreasing, unit steps; ids >= num_segments
    dropped). tags: optional sequence of [..., N] f32 columns with at most
    one nonzero per segment. Returns [..., num_segments, 13 + slots + T]
    f32 rows [count, sum x~ (3), sum x~x~^T (9), class histogram (slots),
    tag values]. One kernel launch for all leading dims on CUDA tensors;
    the plain version on CPU tensors.
    """
    tags = tuple(tags) if tags else ()
    shape = tuple(seg_ids.shape)
    dev = seg_ids.device
    if seg_ids.dim() not in (1, 2):
        raise ValueError(f"seg_ids must be [N] or [B, N], got {shape}")
    if len(tags) > MAX_TAGS:
        raise ValueError(f"at most {MAX_TAGS} tag columns, got {len(tags)}")
    if slots < 0:
        raise ValueError("slots must be >= 0")
    if slots and cls is None:
        raise ValueError("cls is required when slots > 0")
    _check("seg_ids", seg_ids, torch.int32, shape, dev)
    for name, t in (("xt", xt), ("yt", yt), ("zt", zt), ("v", v)):
        _check(name, t, torch.float32, shape, dev)
    if slots:
        _check("cls", cls, torch.int32, shape, dev)
    for i, t in enumerate(tags):
        _check(f"tags[{i}]", t, torch.float32, shape, dev)
    if dev.type == "cpu":
        return fused_moments_sorted_plain(xt, yt, zt, v, cls, seg_ids,
                                          num_segments, slots, tags)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _launch(xt, yt, zt, v, cls, seg_ids, num_segments, slots, tags)


fused_moments_sorted.launches = 0
