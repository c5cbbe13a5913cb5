"""Sorted segment reductions: CUDA kernels, plain versions, wrappers.

Ports of the three Pallas kernels of
``ndtpu/ops/pallas/segment_moments.py``:

- ``fused_moments_sorted`` (TPU kernel ``_moments_kernel``, K1): the NDT
  Gaussian moments from compact per-point columns;
- ``segment_tags_sorted`` (``_tags_kernel``, K3): sparse per-segment tag
  columns, the point-sharded distinct-voxel tables;
- ``segment_sum_sorted`` (``_kernel``, K2): the generic sorted segment sum.

The kernels are ``ndtpu_torch/csrc/segment_moments.cu``; its comments say
how each is laid out and what bounds it on an H100. All three stream
chunks of points through shared memory; ``range_plan`` and ``sum_plan``
mirror how the source sizes their launch. Each wrapper checks its inputs,
launches its kernel on the current stream for CUDA tensors (counting the
launch in its ``launches`` attribute) and runs its plain version only
for CPU tensors. K1's wrapper counts a call captured into a CUDA graph,
which launches nothing, in ``captured`` instead: each replay of that
graph launches the kernel without calling the wrapper.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ndtpu_torch.ops import _build

SOURCE = "segment_moments.cu"
MAX_TAGS = 8  # NDTPU_MAX_TAGS in the source
N_MOMENTS = 13
# the chunk kernels; the names in the source are in brackets
RANGE_WARPS = 4                       # warps per block (kRangeWarps)
RANGE_THREADS = 32 * RANGE_WARPS
STAGE_BYTES = 32 * 1024               # a stage's columns, at most (kStageBytes)
MIN_TILE, MAX_TILE = 256, 1024        # points per tile (kMinTile, kMaxTile)
MIN_CHUNK, CHUNK_STEP = 512, 256      # points per block (kMinChunk, kChunkStep)
SMS = 132                             # an H100 SXM's (kSMs)
BLOCKS_PER_SM = 3                     # the most the plan keeps resident (kBlocksPerSM)
SMEM_PER_SM = 228 * 1024              # an SM's shared memory (kSmemPerSM)
SMEM_RESERVED = 1024                  # what the card keeps per block (kSmemReserved)
MAX_SMEM = 227 * 1024                 # a block's dynamic shared memory (kMaxSmem)
GROUP_WIDTH = 32                      # K2: columns of a column group (kGroupWidth)


def range_plan(batch: int, n: int, n_cols: int, slots: int = 0,
               carry: int = 0, groups: int = 1):
    """The launch of a chunk kernel, as ``range_plan`` in the source
    computes it: (points per block, points per tile, blocks, dynamic
    shared memory bytes).

    The tile is the largest power of two from MIN_TILE to MAX_TILE whose
    ``n_cols`` staged columns fit STAGE_BYTES. Shared memory holds two
    stages of ``n_cols`` columns of tile + 8 floats, each warp's per-lane
    class histogram (``slots`` columns of 32), K2's carry (two buffers of
    ``carry`` columns of 32) and a tile's run starts. The grid has a block
    per chunk of every cloud and column group (``groups``, K2 only), one
    wave of the blocks the card keeps resident (BLOCKS_PER_SM on each SM,
    fewer where their shared memory does not fit): each cloud and group
    gets an equal share, the chunk is a cloud's points over its share,
    rounded up to a multiple of CHUNK_STEP, at least MIN_CHUNK.
    """
    tile = MAX_TILE
    while tile > MIN_TILE and n_cols * tile * 4 > STAGE_BYTES:
        tile //= 2
    smem = (4 * (2 * n_cols * (tile + 8)
                 + 32 * (RANGE_WARPS * slots + 2 * carry)) + 4 * tile)
    fit = SMEM_PER_SM // (smem + SMEM_RESERVED)
    resident = SMS * max(1, min(BLOCKS_PER_SM, fit))
    share = max(1, resident // (batch * groups))
    per_chunk = -(-n // share)
    chunk = max(MIN_CHUNK, -(-per_chunk // CHUNK_STEP) * CHUNK_STEP)
    return chunk, tile, batch * groups * -(-n // chunk), smem


def staged_columns(slots: int, n_tags: int) -> int:
    """The columns K1 stages (``moment_columns`` in the source): seg, xt,
    yt, zt, v, the tags, and cls when there are class slots."""
    return 5 + n_tags + (1 if slots else 0)


def unit_pitch(width: int):
    """Floats a staged row of ``width`` floats takes in 16-byte units: 4 x
    an odd number of units, at least those of the row after a lead of up
    to 3 floats (``unit_pitch`` in the source)."""
    return 4 * (((width + 6) >> 2) | 1)


def sum_plan(batch: int, n: int, f: int):
    """K2's launch, as ``sum_plan`` in the source computes it: the
    ``range_plan`` of its staged columns (the ids and ``pitch`` floats a
    row), then (width, pitch, groups): the columns a block sums, the floats
    between staged rows, the column groups of the grid.

    Whole rows (width F) where two stages of them fit a block at the
    smallest tile, else groups of GROUP_WIDTH columns. Whole rows of
    F % 4 != 0 floats keep pitch F, the contiguous span they are (lanes
    reading one column of 32 consecutive rows meet at most 2-way bank
    conflicts); any other layout stages each row in the 16-byte units that
    hold it, at a pitch of an odd number of units (``unit_pitch``: at most
    4-way conflicts; pitch 32 would put all 32 lanes on one bank)."""
    width, pitch, groups = f, (f if f % 4 else unit_pitch(f)), 1
    plan = range_plan(batch, n, 1 + pitch, carry=width)
    if plan[3] > MAX_SMEM:
        width, groups = GROUP_WIDTH, -(-f // GROUP_WIDTH)
        pitch = unit_pitch(width)
        plan = range_plan(batch, n, 1 + pitch, carry=width, groups=groups)
    return plan + (width, pitch, groups)


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
    (f64): its order is the sum kernel's (``segment_sum_error_bound``).
    Under the callers' precondition (at most one nonzero in a run) every
    sum is exact and the error is 0."""
    return segment_sum_error_bound(torch.stack(tuple(tags), dim=-1), seg_ids,
                                   num_segments)


def segment_sum_error_bound(feats, seg_ids, num_segments: int):
    """Bound on the sum kernel's (and the tags kernel's) f32 rounding
    error, per output entry (f64).

    Their order is K1's (``fused_moments_error_bound``) without the
    products: lane l of a run's warp adds the rows at offset l modulo 32
    from the run's first row, in index order, at most m = ceil(L/32) terms
    for a run of L rows, whatever the tiles, column groups or passes; a
    fixed 5-level combine then adds the lanes. To first order that errs by
    at most (m - 1 + 5) u sum|terms| (u = 2**-24); the bound takes
    (ceil(L/32) + 5) u sum|terms|, one term of slack, and is 0 for an
    empty row."""
    mag = segment_sum_sorted_plain(feats.double().abs(), seg_ids, num_segments)
    rows = segment_sum_sorted_plain(
        torch.ones_like(feats[..., :1], dtype=torch.float64), seg_ids,
        num_segments)
    return (torch.ceil(rows / 32) + 5) * 2.0**-24 * mag


_PTR, _INT, _OUT = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)
# the source's C entries and their arguments
ENTRIES = {
    "ndtpu_segment_moments": [_PTR] * 6               # seg, xt, yt, zt, v, cls
    + [ctypes.POINTER(_PTR)]                          # tag column pointers
    + [_INT] * 5                                      # n_tags, batch, n, K, slots
    + [_PTR, _PTR],                                   # out, stream
    # K1's cost probes (ops/moment_probes.py): K1's arguments, and P2's
    # [blocks, F] scratch and its rows before out
    "ndtpu_moments_empty": [_PTR] * 6 + [ctypes.POINTER(_PTR)] + [_INT] * 5
    + [_PTR, _PTR],
    "ndtpu_moments_noflop": [_PTR] * 6 + [ctypes.POINTER(_PTR)] + [_INT] * 5
    + [_PTR, ctypes.c_longlong, _PTR, _PTR],
    "ndtpu_segment_tags": [_PTR, ctypes.POINTER(_PTR)]  # seg, tags
    + [_INT] * 3 + [_PTR, _PTR],                      # n_tags, n, K; out, stream
    "ndtpu_segment_sum": [_PTR, _PTR]                 # seg, feats
    + [_INT] * 4 + [_PTR, _PTR],                      # batch, n, F, K; out, stream
    "ndtpu_range_plan": [_INT] * 4 + [_OUT],
    "ndtpu_sum_plan": [_INT] * 3 + [_OUT],
}


def bind(lib, name):
    """Entry ``name`` of a library built from the source, typed."""
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = ENTRIES[name]
    return fn


@functools.cache
def _entry(name):
    """Build the source (at first use) and bind its entry ``name``."""
    return bind(_build.load(SOURCE), name)


def kernel_range_plan(batch: int, n: int, n_cols: int, slots: int = 0):
    """``range_plan`` as the built source computes it for K1 and K3 (needs
    nvcc): the card's tests hold the Python mirror against it."""
    out = (ctypes.c_longlong * 4)()
    _entry("ndtpu_range_plan")(batch, n, n_cols, slots, out)
    return tuple(out)


def kernel_sum_plan(batch: int, n: int, f: int):
    """``sum_plan`` as the built source computes it (needs nvcc)."""
    out = (ctypes.c_longlong * 7)()
    _entry("ndtpu_sum_plan")(batch, n, f, out)
    return tuple(out)


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


def check_moment_inputs(xt, yt, zt, v, cls, seg_ids, slots: int, tags):
    """K1's input checks (``fused_moments_sorted``'s docstring): the
    shapes, types, device and contiguity of every column. Returns the
    device."""
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
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def column_pointers(xt, yt, zt, v, cls, seg_ids, slots: int, tags):
    """K1's entry's first seven arguments: seg, xt, yt, zt, v, cls (None
    without slots) and the array of tag column pointers. Under CUDA graph
    capture (train/loop.py::make_epoch_scan) these pointers are copied into
    the captured launch: every replay reads the same addresses, which the
    graph's private memory pool keeps for it."""
    tag_ptrs = (ctypes.c_void_p * max(1, len(tags)))(
        *[t.data_ptr() for t in tags]
    )
    return (seg_ids.data_ptr(), xt.data_ptr(), yt.data_ptr(), zt.data_ptr(),
            v.data_ptr(), cls.data_ptr() if slots else None, tag_ptrs)


def _launch(xt, yt, zt, v, cls, seg_ids, num_segments, slots, tags):
    n = seg_ids.shape[-1]
    batch = math.prod(seg_ids.shape[:-1])
    shape = (tuple(seg_ids.shape[:-1])
             + (num_segments, N_MOMENTS + slots + len(tags)))
    if n * batch * num_segments == 0:  # nothing to sum: no launch
        return torch.zeros(shape, dtype=torch.float32, device=seg_ids.device)
    out = torch.empty(shape, dtype=torch.float32, device=seg_ids.device)
    stream = torch.cuda.current_stream(seg_ids.device).cuda_stream
    err = _entry("ndtpu_segment_moments")(
        *column_pointers(xt, yt, zt, v, cls, seg_ids, slots, tags),
        len(tags), batch, n, num_segments, slots, out.data_ptr(), stream,
    )
    _raise_on(err, "segment_moments")
    if torch.cuda.is_current_stream_capturing():  # each replay launches it
        fused_moments_sorted.captured += 1
    else:
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
    dev = check_moment_inputs(xt, yt, zt, v, cls, seg_ids, slots, tags)
    if dev.type == "cpu":
        return fused_moments_sorted_plain(xt, yt, zt, v, cls, seg_ids,
                                          num_segments, slots, tags)
    return _launch(xt, yt, zt, v, cls, seg_ids, num_segments, slots, tags)


fused_moments_sorted.launches = 0
fused_moments_sorted.captured = 0


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
    err = _entry("ndtpu_segment_tags")(
        seg_ids.data_ptr(), ptrs, len(tags), shape[0], num_segments,
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
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
    err = _entry("ndtpu_segment_sum")(
        seg_ids.data_ptr(), feats.data_ptr(), batch, n, f, num_segments,
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "segment_sum")
    segment_sum_sorted.launches += 1
    return out


segment_sum_sorted.launches = 0
