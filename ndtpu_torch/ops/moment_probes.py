"""K1's cost probes: CUDA kernels, plain versions, wrappers.

Ports of the two probe bodies that the JAX repository's
``scripts/kernel_micro.py`` launches at K1's production grid through
``probe_call`` (:133-145), beside K1 itself (its ``moments`` mode):

- ``moments_empty`` (P1, ``empty_body`` :147): the launch and grid
  floor. K1's launch whose body only zeroes the output, as the TPU body
  zeroes it at grid step 0: it reads nothing.
- ``moments_noflop`` (P2, ``noflop_body`` :154): K1's streaming and K1's
  row build without the segmented reduce: every column staged through
  shared memory as K1 stages it, each point's 13 + slots + T feature
  values built as K1 builds them, and each column's total over the points
  with id >= 0 written into rows 0-7 of the flat [B K, F] output; every
  other row is 0.

With K1 (``segment_moments.fused_moments_sorted``) on the same inputs they
split K1's time into the floor (P1), the streaming and row build (P2 - P1)
and the segmented reduce with the class histograms (K1 - P2). Both kernels
are in ``ndtpu_torch/csrc/segment_moments.cu`` and launch with K1's plan
(``segment_moments.range_plan`` of K1's staged columns and slots). They
take K1's arguments and checks (``fused_moments_sorted``) and at most
MAX_SLOTS class slots. Each wrapper launches its kernel on the
current stream for CUDA tensors, counting the launch in its ``launches``
attribute, and runs its plain version only for CPU tensors.
"""
from __future__ import annotations

import math

import torch

from ndtpu_torch.ops import segment_moments as sm

MAX_SLOTS = 32  # P2's class columns in registers (kProbeMaxSlots)
PROBE_ROWS = 8  # the TPU body's strip of output rows (_SUBLANE)


def _layout(seg_ids, num_segments: int, slots: int, tags):
    """(batch, n, output shape [..., num_segments, F]) of K1's inputs."""
    f = sm.N_MOMENTS + slots + len(tags)
    return (math.prod(seg_ids.shape[:-1]), seg_ids.shape[-1],
            tuple(seg_ids.shape[:-1]) + (num_segments, f))


def _plan(batch: int, n: int, slots: int, tags):
    """K1's launch plan for these inputs (``segment_moments.range_plan`` of
    its staged columns)."""
    return sm.range_plan(batch, n, sm.staged_columns(slots, len(tags)), slots)


def moments_empty_plain(xt, yt, zt, v, cls, seg_ids, num_segments: int,
                        slots: int, tags=None):
    """P1's plain version: ``torch.zeros`` of K1's output shape."""
    shape = _layout(seg_ids, num_segments, slots, tuple(tags or ()))[2]
    return torch.zeros(shape, dtype=torch.float32, device=seg_ids.device)


def _column_totals(cols, seg_ids):
    """Each column's total over the points with id >= 0: [F]."""
    keep = (seg_ids >= 0).to(cols.dtype)
    return (cols * keep[..., None]).reshape(-1, cols.shape[-1]).sum(0)


def _in_strip(totals, shape):
    """``totals`` [F] in rows 0-7 of the flat [rows, F] of ``shape``, 0
    elsewhere."""
    out = torch.zeros(shape, dtype=totals.dtype, device=totals.device)
    flat = out.view(-1, shape[-1])
    flat[:PROBE_ROWS] = totals
    return out


def moments_noflop_plain(xt, yt, zt, v, cls, seg_ids, num_segments: int,
                         slots: int, tags=None):
    """P2's plain version: K1's materialised columns
    (``segment_moments.moment_columns``), each column's total over the
    points with id >= 0, broadcast into rows 0-7 of the flat output, in
    the inputs' type."""
    tags = tuple(tags or ())
    cols = sm.moment_columns(xt, yt, zt, v, cls, slots, tags)
    shape = _layout(seg_ids, num_segments, slots, tags)[2]
    return _in_strip(_column_totals(cols, seg_ids), shape)


def moments_noflop_error_bound(xt, yt, zt, v, cls, seg_ids, num_segments: int,
                               slots: int, tags=None):
    """Bound on P2's f32 rounding error, per output entry (f64).

    The kernel's order: a thread adds the points g, g + 128, ... of its
    block's chunk in index order (at most ceil(chunk / 128) terms), a
    fixed 5-level butterfly adds a warp's lanes, the 4 warps are added in
    turn, and the second pass adds the blocks' partials in block order.
    Every term's path thus meets at most m = ceil(chunk / 128) + 5 + 4 +
    blocks roundings, and the products once more: to first order the
    error is within (m + 1) u sum|terms| (u = 2**-24), with the chunk and
    the blocks of K1's plan (``segment_moments.range_plan``)."""
    tags = tuple(tags or ())
    batch, n, shape = _layout(seg_ids, num_segments, slots, tags)
    chunk, _, blocks, _ = _plan(batch, n, slots, tags)
    depth = -(-chunk // sm.RANGE_THREADS) + 5 + sm.RANGE_WARPS + blocks + 1
    cols = sm.moment_columns(xt.double(), yt.double(), zt.double(), v.double(),
                             cls, slots, tuple(t.double() for t in tags))
    return _in_strip(depth * 2.0**-24 * _column_totals(cols.abs(), seg_ids),
                     shape)


def _prepare(xt, yt, zt, v, cls, seg_ids, slots, tags):
    """K1's input checks and P2's slot cap: (tags as a tuple, device)."""
    tags = tuple(tags) if tags else ()
    dev = sm.check_moment_inputs(xt, yt, zt, v, cls, seg_ids, slots, tags)
    if slots > MAX_SLOTS:
        raise ValueError(f"at most {MAX_SLOTS} class slots, got {slots}")
    return tags, dev


def moments_empty(xt, yt, zt, v, cls, seg_ids, num_segments: int, slots: int,
                  tags=None):
    """P1 on K1's inputs (``fused_moments_sorted``'s arguments): zeros of
    K1's output shape, written by one launch of K1's plan whose body only
    zeroes the output, on CUDA tensors; the plain version on CPU
    tensors."""
    tags, dev = _prepare(xt, yt, zt, v, cls, seg_ids, slots, tags)
    if dev.type == "cpu":
        return moments_empty_plain(xt, yt, zt, v, cls, seg_ids, num_segments,
                                   slots, tags)
    batch, n, shape = _layout(seg_ids, num_segments, slots, tags)
    if n * batch * num_segments == 0:  # nothing to launch
        return torch.zeros(shape, dtype=torch.float32, device=dev)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    err = sm._entry("ndtpu_moments_empty")(
        *sm.column_pointers(xt, yt, zt, v, cls, seg_ids, slots, tags),
        len(tags), batch, n, num_segments, slots, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    sm._raise_on(err, "moments_empty")
    moments_empty.launches += 1
    return out


moments_empty.launches = 0


def moments_noflop(xt, yt, zt, v, cls, seg_ids, num_segments: int, slots: int,
                   tags=None):
    """P2 on K1's inputs (``fused_moments_sorted``'s arguments, at most
    MAX_SLOTS class slots): [..., num_segments, 13 + slots + T] f32 whose
    flat rows 0-7 each hold every column's total over the points with id
    >= 0, all other rows 0. Two launches on CUDA tensors (the streaming
    kernel into a [blocks, F] scratch, then the fixed-order pass that sums
    the blocks and writes the output); the plain version on CPU tensors."""
    tags, dev = _prepare(xt, yt, zt, v, cls, seg_ids, slots, tags)
    if dev.type == "cpu":
        return moments_noflop_plain(xt, yt, zt, v, cls, seg_ids, num_segments,
                                    slots, tags)
    batch, n, shape = _layout(seg_ids, num_segments, slots, tags)
    if n * batch * num_segments == 0:  # nothing to sum: no launch
        return torch.zeros(shape, dtype=torch.float32, device=dev)
    blocks = _plan(batch, n, slots, tags)[2]
    partial = torch.empty((blocks, shape[-1]), dtype=torch.float32, device=dev)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    err = sm._entry("ndtpu_moments_noflop")(
        *sm.column_pointers(xt, yt, zt, v, cls, seg_ids, slots, tags),
        len(tags), batch, n, num_segments, slots, partial.data_ptr(), blocks,
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    sm._raise_on(err, "moments_noflop")
    moments_noflop.launches += 1
    return out


moments_noflop.launches = 0
