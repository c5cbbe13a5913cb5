"""Sorted segment reductions: CUDA kernels, plain versions, wrappers.

Ports of the three Pallas kernels of
``ndtpu/ops/pallas/segment_moments.py``:

- ``fused_moments_sorted`` (TPU kernel ``_moments_kernel``, K1): the NDT
  Gaussian moments from compact per-point columns;
- ``segment_tags_sorted`` (``_tags_kernel``, K3): sparse per-segment tag
  columns, the point-sharded distinct-voxel tables;
- ``segment_sum_sorted`` (``_kernel``, K2): the generic sorted segment sum.

The kernels are ``ndtpu_torch/csrc/segment_moments.cu``; its comments say
how each is laid out and what bounds it on an H100. K1 and K3 stream
chunks of points through shared memory; ``range_plan`` mirrors how the
source sizes their launch. Each wrapper checks its inputs, launches its
kernel on the current stream for CUDA tensors (counting the launch in its
``launches`` attribute) and runs its plain version only for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ndtpu_torch.ops import _build

SOURCE = "segment_moments.cu"
MAX_TAGS = 8  # NDTPU_MAX_TAGS in the source
SUM_BLOCK = 256  # kBlock in the source: threads per segment of the sum kernel
N_MOMENTS = 13
# the chunk kernels (K1, K3); the names in the source are in brackets
RANGE_WARPS = 4                       # warps per block (kRangeWarps)
RANGE_THREADS = 32 * RANGE_WARPS
STAGE_BYTES = 32 * 1024               # a stage's columns, at most (kStageBytes)
MIN_TILE, MAX_TILE = 256, 1024        # points per tile (kMinTile, kMaxTile)
MIN_CHUNK, CHUNK_STEP = 512, 256      # points per block (kMinChunk, kChunkStep)
TARGET_BLOCKS = 384                   # (kTargetBlocks)


def range_plan(batch: int, n: int, n_cols: int, slots: int = 0):
    """The launch of a chunk kernel, as ``range_plan`` in the source
    computes it: (points per block, points per tile, blocks, dynamic
    shared memory bytes).

    The chunk is the batch's points over TARGET_BLOCKS (about 3 blocks
    for each of the card's 132 SMs), rounded up to a multiple of CHUNK_STEP,
    at least MIN_CHUNK; the tile the largest power of two from MIN_TILE to
    MAX_TILE whose ``n_cols`` staged columns fit STAGE_BYTES. Shared
    memory holds two stages of ``n_cols`` columns of tile + 8 floats, each
    warp's per-lane class histogram (``slots`` columns of 32) and a tile's
    run starts."""
    per_block = -(-batch * n // TARGET_BLOCKS)
    chunk = max(MIN_CHUNK, -(-per_block // CHUNK_STEP) * CHUNK_STEP)
    tile = MAX_TILE
    while tile > MIN_TILE and n_cols * tile * 4 > STAGE_BYTES:
        tile //= 2
    smem = 4 * (2 * n_cols * (tile + 8) + RANGE_WARPS * slots * 32) + 4 * tile
    return chunk, tile, batch * -(-n // chunk), smem


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

    The kernel's order (the note at the top of the source): one warp sums a
    run; its lane l adds, in index order, the points whose offset from the
    run's first point is l modulo 32, whatever chunks or tiles they fall
    in, so it adds at most m = ceil(L/32) terms of a run of L rows; a fixed
    5-level combine (warp_reduce_scatter) then adds the lanes. A recursive
    sum of m terms errs by at most (m - 1) u sum|terms| to first order
    (u = 2**-24); the combine adds 5 roundings on every term's path and the
    products xx, xy, ... are rounded once more: (m + 5) u sum|terms|. The
    bound takes (ceil(L/32) + 6) u sum|terms|, one term of slack, and is 0
    for an empty row."""
    tags = tuple(t.double() for t in tags or ())
    cols = moment_columns(xt.double(), yt.double(), zt.double(), v.double(),
                          cls, slots, tags)
    mag = segment_sum_sorted_plain(cols.abs(), seg_ids, num_segments)
    rows = segment_sum_sorted_plain(torch.ones_like(cols[..., :1]), seg_ids,
                                    num_segments)
    return (torch.ceil(rows / 32) + 6) * 2.0**-24 * mag


def segment_tags_sorted_plain(seg_ids, tags, num_segments: int):
    """Plain version of the tags kernel: [N] ids, T [N] columns ->
    [num_segments, T] sums (ids outside [0, num_segments) dropped)."""
    return segment_sum_sorted_plain(torch.stack(tuple(tags), dim=-1), seg_ids,
                                    num_segments)


def segment_tags_error_bound(seg_ids, tags, num_segments: int):
    """Bound on the tags kernel's f32 rounding error, per output entry
    (f64). Its order is K1's (``fused_moments_error_bound``) without the
    products: (ceil(L/32) + 5) * 2**-24 * sum|terms| for a run of L rows,
    one term of slack, 0 for an empty row. Under the callers' precondition (at most one
    nonzero in a run) every sum is exact and the error is 0."""
    cols = torch.stack([t.double().abs() for t in tags], dim=-1)
    mag = segment_sum_sorted_plain(cols, seg_ids, num_segments)
    rows = segment_sum_sorted_plain(torch.ones_like(cols[..., :1]), seg_ids,
                                    num_segments)
    return (torch.ceil(rows / 32) + 5) * 2.0**-24 * mag


def segment_sum_error_bound(feats, seg_ids, num_segments: int):
    """Bound on the sum kernel's f32 rounding error, per output entry (f64).

    In a tile of w columns (tiles of 32) the kernel's block of SUM_BLOCK
    threads sums g = SUM_BLOCK // w row groups of ceil(L / g) terms each,
    in order, then adds the g partial sums, so to first order
    |kernel - exact| <= (ceil(L / g) + g) * 2**-24 * sum|terms| for a
    segment of L rows; the bound adds one more term for slack."""
    f = feats.shape[-1]
    width = torch.tensor([min(32, f - 32 * (c // 32)) for c in range(f)],
                         dtype=torch.float64, device=feats.device)
    groups = torch.floor(SUM_BLOCK / width)
    mag = segment_sum_sorted_plain(feats.double().abs(), seg_ids, num_segments)
    rows = segment_sum_sorted_plain(
        torch.ones_like(feats[..., :1], dtype=torch.float64), seg_ids,
        num_segments)
    return (torch.ceil(rows / groups) + groups + 1) * 2.0**-24 * mag


def _bind(name, argtypes):
    fn = getattr(_build.load(SOURCE), name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


@functools.cache
def _kernel():
    """Build (at first use) and bind the moments kernel's C entry point."""
    return _bind("ndtpu_segment_moments",
                 [ctypes.c_void_p] * 6                  # seg, xt, yt, zt, v, cls
                 + [ctypes.POINTER(ctypes.c_void_p)]    # tag column pointers
                 + [ctypes.c_int] * 5                   # n_tags, batch, n, K, slots
                 + [ctypes.c_void_p, ctypes.c_void_p])  # out, stream


@functools.cache
def _tags_kernel():
    return _bind("ndtpu_segment_tags",
                 [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]  # seg, tags
                 + [ctypes.c_int] * 3                   # n_tags, n, K
                 + [ctypes.c_void_p, ctypes.c_void_p])  # out, stream


@functools.cache
def _plan_entry():
    return _bind("ndtpu_range_plan", [ctypes.c_int] * 4
                 + [ctypes.POINTER(ctypes.c_longlong)])


def kernel_range_plan(batch: int, n: int, n_cols: int, slots: int = 0):
    """``range_plan`` as the built source computes it (needs nvcc): the
    card's tests hold the Python mirror against it."""
    out = (ctypes.c_longlong * 4)()
    _plan_entry()(batch, n, n_cols, slots, out)
    return tuple(out)


@functools.cache
def _sum_kernel():
    return _bind("ndtpu_segment_sum",
                 [ctypes.c_void_p, ctypes.c_void_p]     # seg, feats
                 + [ctypes.c_int] * 4                   # batch, n, F, K
                 + [ctypes.c_void_p, ctypes.c_void_p])  # out, stream


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


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
    batch = math.prod(seg_ids.shape[:-1])
    shape = (tuple(seg_ids.shape[:-1])
             + (num_segments, N_MOMENTS + slots + len(tags)))
    if n * batch * num_segments == 0:  # nothing to sum: no launch
        return torch.zeros(shape, dtype=torch.float32, device=seg_ids.device)
    out = torch.empty(shape, dtype=torch.float32, device=seg_ids.device)
    tag_ptrs = (ctypes.c_void_p * max(1, len(tags)))(
        *[t.data_ptr() for t in tags]
    )
    stream = torch.cuda.current_stream(seg_ids.device).cuda_stream
    err = _kernel()(
        seg_ids.data_ptr(), xt.data_ptr(), yt.data_ptr(), zt.data_ptr(),
        v.data_ptr(), cls.data_ptr() if slots else None, tag_ptrs,
        len(tags), batch, n, num_segments, slots, out.data_ptr(), stream,
    )
    _raise_on(err, "segment_moments")
    fused_moments_sorted.launches += 1
    return out


def fused_moments_sorted(xt, yt, zt, v, cls, seg_ids, num_segments: int,
                         slots: int, tags=None):
    """NDT Gaussian-moment accumulation from compact inputs.

    xt/yt/zt: [..., N] f32 voxel-center-shifted coordinates, pre-masked
    (invalid rows zero). v: [..., N] f32 validity (0 or 1). cls: [..., N]
    int32 class tags, or None when ``slots == 0``. seg_ids: [..., N] int32
    sorted segment ranks (non-decreasing, gaps allowed; ids >= num_segments
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


def _device_of(seg_ids):
    dev = seg_ids.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def segment_tags_sorted(seg_ids, tags, num_segments: int):
    """Sparse per-segment tag columns by sorted segment rank.

    seg_ids: [N] int32, non-decreasing (dense ranks; ids >= num_segments
    dropped). tags: 1..8 [N] f32 columns with at most one nonzero per
    segment (then every sum is exact). Returns [num_segments, T] f32. One
    kernel launch on CUDA tensors; the plain version on CPU tensors."""
    tags = tuple(tags)
    if seg_ids.dim() != 1:
        raise ValueError(f"seg_ids must be [N], got {tuple(seg_ids.shape)}")
    if not 1 <= len(tags) <= MAX_TAGS:
        raise ValueError(f"1 to {MAX_TAGS} tag columns, got {len(tags)}")
    if num_segments < 0:
        raise ValueError("num_segments must be >= 0")
    shape, dev = tuple(seg_ids.shape), _device_of(seg_ids)
    _check("seg_ids", seg_ids, torch.int32, shape, dev)
    for i, t in enumerate(tags):
        _check(f"tags[{i}]", t, torch.float32, shape, dev)
    if dev.type == "cpu":
        return segment_tags_sorted_plain(seg_ids, tags, num_segments)
    if shape[0] * num_segments == 0:  # nothing to sum: no launch
        return torch.zeros((num_segments, len(tags)), dtype=torch.float32,
                           device=dev)
    out = torch.empty((num_segments, len(tags)), dtype=torch.float32,
                      device=dev)
    ptrs = (ctypes.c_void_p * len(tags))(*[t.data_ptr() for t in tags])
    err = _tags_kernel()(seg_ids.data_ptr(), ptrs, len(tags), shape[0],
                         num_segments, out.data_ptr(),
                         torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "segment_tags")
    segment_tags_sorted.launches += 1
    return out


segment_tags_sorted.launches = 0


def segment_sum_sorted(feats, seg_ids, num_segments: int):
    """Segment sum of ``feats`` [..., N, F] f32 by sorted segment rank
    ``seg_ids`` [..., N] int32 (non-decreasing per leading index; ids >=
    num_segments dropped) into [..., num_segments, F]. One kernel launch
    for all leading dims on CUDA tensors, in a fixed summation order (see
    ``segment_sum_error_bound``); the plain version on CPU tensors."""
    if feats.dim() < 2 or feats.dim() != seg_ids.dim() + 1:
        raise ValueError(f"feats [..., N, F] and seg_ids [..., N], got "
                         f"{tuple(feats.shape)} and {tuple(seg_ids.shape)}")
    if feats.shape[-1] < 1:
        raise ValueError("feats needs at least one column")
    if num_segments < 0:
        raise ValueError("num_segments must be >= 0")
    shape, dev = tuple(seg_ids.shape), _device_of(seg_ids)
    _check("seg_ids", seg_ids, torch.int32, shape, dev)
    _check("feats", feats, torch.float32, shape + (feats.shape[-1],), dev)
    if dev.type == "cpu":
        return segment_sum_sorted_plain(feats, seg_ids, num_segments)
    n, f = feats.shape[-2:]
    batch = math.prod(shape[:-1])
    out_shape = shape[:-1] + (num_segments, f)
    if n * batch * num_segments == 0:  # nothing to sum: no launch
        return torch.zeros(out_shape, dtype=torch.float32, device=dev)
    out = torch.empty(out_shape, dtype=torch.float32, device=dev)
    err = _sum_kernel()(seg_ids.data_ptr(), feats.data_ptr(), batch, n, f,
                        num_segments, out.data_ptr(),
                        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "segment_sum")
    segment_sum_sorted.launches += 1
    return out


segment_sum_sorted.launches = 0
