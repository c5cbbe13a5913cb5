"""The NDT downsampling pipeline for a batch of clouds (port of
``ndtpu/core/ndt.py``).

Steps, as in the JAX package (reference ``core_legacy/src/ndt.c:119-222``):
cloud limits; the voxel-size search (the C bisection, the seeded log-log
secant search fused with the key + payload sort, optionally seeded by the
subsampled Chao1 probe, or the grid search of G candidates a round); the
per-voxel moments (one launch of the segment-moments kernel for the whole
batch); the 6-neighbour KL; the prune to ``n_desired`` (ascending, or the
C core's ``legacy_c`` order) and the compaction. ``NDTSampler`` wraps one
cloud in the reference sampler's host API.

What changes against the JAX package:
- ``vmap`` is an explicit leading batch dimension. Every function takes
  ``[B, N]`` structure-of-arrays tensors and per-cloud ``[B]`` scalars.
- The batched ``while_loop`` of the searches is a Python loop over rounds.
  A finished cloud's carry stays frozen, as under ``vmap``. Eagerly, a
  round gathers the clouds still searching (``torch.nonzero``) and the
  loop stops when none is left, one host sync per round. Inside
  ``_fixed_rounds()`` (which ``train/loop.py::make_epoch_scan`` enters
  for its warm-up steps and its capture), every round evaluates every
  cloud up to
  the search's fixed maximum and keeps each finished cloud's carry with
  ``torch.where``: no host sync, the same outputs bit for bit
  (``_Rounds``).
- Voxel keys are int64 ``(z * len_y + y) * len_x + x``. A masked point
  gets ``KEY_PAD`` (2**62), above every valid key, so the sort order
  equals the JAX int32 order (``INT32_MAX`` padding). Inside the (zy, x)
  pair envelope (len_z * len_y < 2**31, every axis < 2**24) that key is
  below 2**55, exact, and orders points as the JAX ``(zy, x)`` pair does.
  So ``key_mode="pair"`` differs from ``"packed"`` only in the lower clamp
  of the voxel size (``_min_pair_packable_voxel_size`` against
  ``_min_packable_voxel_size``), and one sorted key serves both.
- ``lax.sort`` (stable, multi-operand) is ``torch.sort(stable=True)`` of
  the key followed by a gather of the payload.
- The emit reads ``NDTPU_EMIT`` at each call as the JAX package does:
  "gather" (the default) gathers the kept rows by the compaction's
  permutation; any other value selects "payload", where the rows' means,
  6 unique covariance entries and labels ride the compaction sort as one
  payload. Both give the same outputs bit for bit.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading

import numpy as np
import torch

from ndtpu_torch.core import voxel as vx
from ndtpu_torch.core.kl import INT32_MAX, neighbor_min_kl
from ndtpu_torch.core.moments import finalize_moments, segment_moments_soa
from ndtpu_torch.utils.device import resolve_device
from ndtpu_torch.utils.profiling import span

# Reference constants, ndt.h:38-43.
DOWNSAMPLE_UPPER_THRESHOLD = 0.2
MIN_VOXEL_GUESS = 0.01
MAX_VOXEL_GUESS = 30.0
MAX_GUESS_ITERATIONS = 15
PROBE_FACTOR = 4  # cold-probe subsample stride

# grid-cell budget of the packed key (see the JAX module): every admitted
# grid has < 2**31 - 1024 cells
_GRID_CELL_BUDGET = float(2**31 - 1024)
KEY_PAD = 2**62
_BIG_COUNT = 2**31 - 1  # "no fallback size seen yet"
_fixed = threading.local()  # .depth > 0 inside _fixed_rounds(), per thread


@contextlib.contextmanager
def _fixed_rounds():
    """Within (on this thread): every voxel-size search runs its fixed
    maximum of rounds over the whole batch, with no host sync
    (``_Rounds``)."""
    _fixed.depth = getattr(_fixed, "depth", 0) + 1
    try:
        yield
    finally:
        _fixed.depth -= 1


def _sync_free() -> bool:
    return getattr(_fixed, "depth", 0) > 0


class _Rounds:
    """Which clouds a search round evaluates, and how its results land.

    Eager: the clouds not yet done, gathered by ``torch.nonzero`` (the
    round's host sync); ``start`` is False once none is left; results are
    scattered back into those clouds' rows. Sync-free (``_fixed_rounds()``):
    every cloud every round, ``take`` returning the
    carry itself; results land, in new tensors, where the cloud was not
    done when the round started, by ``torch.where``. Each cloud's
    arithmetic is the same either way, so the outputs are bit-identical.
    """

    def __init__(self):
        self.sync_free = _sync_free()
        self.sel = slice(None)  # the clouds of the round, for count_fn

    def start(self, done) -> bool:
        if self.sync_free:
            self.active = ~done
            return True
        self.sel = torch.nonzero(~done).squeeze(-1)  # the round's host sync
        return self.sel.numel() > 0

    def take(self, *ts):
        """The round's rows of each [B, ...] tensor."""
        return ts if self.sync_free else tuple(t[self.sel] for t in ts)

    def merge(self, old, new):
        """``old`` with the round's rows taken from ``new``: in place
        eagerly (``take`` gave copies), a new tensor sync-free (``take``
        gave the carry itself, which the round may still read)."""
        if self.sync_free:
            act = self.active.reshape(self.active.shape + (1,) * (new.dim() - 1))
            return torch.where(act, new, old)
        old[self.sel] = new
        return old


@dataclasses.dataclass
class NDTResult:
    """Post-downsample sampler state; every field has a leading batch dim
    B and K = max_segments(n_desired) segment rows."""

    means: torch.Tensor       # [B, K, 3] f32
    covs: torch.Tensor        # [B, K, 3, 3] f32
    counts: torch.Tensor      # [B, K] i32, 0 = empty slot
    class_hist: torch.Tensor  # [B, K, C+1] i32 ([B, K, 1] = counts, untagged)
    zyx: torch.Tensor         # [B, K, 3] i32 (z, y, x) sorted; pad INT32_MAX
    min_kl: torch.Tensor      # [B, K] f32, inf = no valid neighbour pair
    max_kl: torch.Tensor      # [B, K] f32, -inf = no valid pair
    lens: torch.Tensor        # [B, 3] i32 grid dims (x, y, z)
    offsets: torch.Tensor     # [B, 3] f32
    voxel_size: torch.Tensor  # [B] f32
    num_valid: torch.Tensor   # [B] i32 occupied voxels, clipped to K
    converged: torch.Tensor   # [B] bool, the search hit the band

    @property
    def max_nds(self) -> int:
        return self.means.shape[-2]


def max_segments(n_desired: int) -> int:
    """Static capacity: the search band tops out at 1.2 n (ndt.h:38)."""
    return int(n_desired * (1.0 + DOWNSAMPLE_UPPER_THRESHOLD)) + 8


def empty_state(n_desired: int, num_class_slots: int = 1, batch: int = 1,
                device="cuda") -> NDTResult:
    """Zero-filled NDTResult with the shapes and dtypes that
    ``ndt_downsample`` returns for ``batch`` clouds."""
    dev = resolve_device(device)
    k = max_segments(n_desired)
    c = num_class_slots if num_class_slots > 1 else 1

    def z(shape, dtype=torch.float32):
        return torch.zeros((batch,) + shape, dtype=dtype, device=dev)

    return NDTResult(
        means=z((k, 3)), covs=z((k, 3, 3)), counts=z((k,), torch.int32),
        class_hist=z((k, c), torch.int32), zyx=z((k, 3), torch.int32),
        min_kl=z((k,)), max_kl=z((k,)), lens=z((3,), torch.int32),
        offsets=z((3,)), voxel_size=z(()), num_valid=z((), torch.int32),
        converged=z((), torch.bool),
    )


def _f32(x, like):
    """x as an f32 tensor on like's device. A Python number is filled in
    on the device: copying it from the host would stall the host."""
    if isinstance(x, torch.Tensor):
        return x.to(device=like.device, dtype=torch.float32)
    return torch.full((), float(x), dtype=torch.float32, device=like.device)


def _min_axis_exact_size(d):
    """Smallest voxel size keeping every axis grid length < 2**24, so a
    voxel coordinate is exact as an f32 tag column."""
    return d.amax(-1) / _f32(2.0**24 - 2.0, d)


def _min_packable_voxel_size(mins, maxs):
    """Smallest voxel size whose grid linearises into one key under the
    cell budget (term-wise bound of prod(d_i/s + 1), see the JAX module).
    [B, 3] -> [B]. torch has no cbrt: the cube root is taken in float64
    and rounded to f32, so it may differ from ``jnp.cbrt`` in the last
    ulp."""
    d = torch.clamp(maxs - mins, min=0.0)
    dx, dy, dz = d.unbind(-1)
    b4 = _f32(_GRID_CELL_BUDGET / 4.0, d)
    s3 = torch.pow((dx * dy * dz / b4).double(), 1.0 / 3.0).float()
    s2 = torch.sqrt((dx * dy + dx * dz + dy * dz) / b4)
    s1 = (dx + dy + dz) / b4
    return torch.maximum(torch.maximum(torch.maximum(s3, s2), s1),
                         _min_axis_exact_size(d))


def _min_pair_packable_voxel_size(mins, maxs):
    """Smallest voxel size for the (zy, x) key pair: len_z * len_y < 2**31
    and every axis < 2**24. [B, 3] -> [B]."""
    d = torch.clamp(maxs - mins, min=0.0)
    dy, dz = d[..., 1], d[..., 2]
    b3 = _f32(_GRID_CELL_BUDGET / 3.0, d)
    s2 = torch.sqrt(dz * dy / b3)
    s1 = (dz + dy) / b3
    return torch.maximum(torch.maximum(s2, s1), _min_axis_exact_size(d))


def _limits(px, py, pz, mask):
    """Masked per-axis min/max of [B, N] coordinates -> ([B, 3], [B, 3])."""
    big = torch.finfo(torch.float32).max
    lo = [torch.where(mask, p, big).amin(-1) for p in (px, py, pz)]
    hi = [torch.where(mask, p, -big).amax(-1) for p in (px, py, pz)]
    return torch.stack(lo, -1), torch.stack(hi, -1)


def _voxel_keys(px, py, pz, mask, voxel_size, mins, maxs):
    """Per-point int64 voxel key (z * len_y + y) * len_x + x, the
    reference's x-fastest linearisation; KEY_PAD for masked points.
    voxel_size [...] (one per cloud, or per cloud and candidate), mins and
    maxs [..., 3] and the coordinates [..., N] broadcast against it.
    Returns (key [..., N], lens [..., 3] i32, offsets)."""
    lens, offsets = vx.estimate_voxel_grid(mins, maxs, voxel_size)
    s = voxel_size[..., None]

    def coord(p, a):
        return vx.metric_to_voxel_axis(p, s, lens[..., a:a + 1],
                                       offsets[..., a:a + 1])

    x, y, z = coord(px, 0), coord(py, 1), coord(pz, 2)
    ln = lens.long()
    key = torch.where(mask, (z * ln[..., 1:2] + y) * ln[..., 0:1] + x,
                      KEY_PAD)
    return key, lens, offsets


def _run_starts(skey):
    """True where a sorted key row starts a new run."""
    new = torch.ones_like(skey, dtype=torch.bool)
    new[:, 1:] = skey[:, 1:] != skey[:, :-1]
    return new


def _count_runs(skey):
    """Distinct valid keys of sorted rows [B, N] -> [B] int64."""
    return ((skey != KEY_PAD) & _run_starts(skey)).sum(-1)


def _count_occupied(px, py, pz, mask, voxel_size, mins, maxs):
    """Number of distinct occupied voxels per cloud at ``voxel_size``. The
    int64 key packs (zy, x) exactly for every grid inside the pair
    envelope, so this is also the JAX package's ``_count_occupied_pair``."""
    key, _, _ = _voxel_keys(px, py, pz, mask, voxel_size, mins, maxs)
    return _count_runs(torch.sort(key, dim=-1).values)


def _ingest(guess, count, lo, hi, best_g, best_c, n_desired, upper):
    """One evaluation's bookkeeping, shared by the searches: in band
    [n, 1.2 n]? Too many voxels raise lo, too few lower hi; the smallest
    count >= n seen is the fallback. Returns (hit, lo, hi, best_g,
    best_c)."""
    too_many = count.float() > upper
    too_few = count < n_desired
    better = (count >= n_desired) & (count < best_c)
    return (~too_many & ~too_few,
            torch.where(too_many, guess, lo),
            torch.where(too_few, guess, hi),
            torch.where(better, guess, best_g),
            torch.where(better, count, best_c))


def _secant_step(g, cf, pg, pc, lo, hi, target):
    """The next size of the secant searches from this evaluation (size g,
    count cf) and the previous one (pg, pc; pg = 0 when none): the
    log-log step to the band's centre with the occupancy exponent measured
    from the two (the surface prior 2 when no usable pair exists), or the
    bracket's midpoint where the step leaves (lo, hi)."""
    dlog_c = torch.log(torch.clamp(cf, min=1.0) / torch.clamp(pc, min=1.0))
    dlog_g = torch.log(torch.where(pg > 0, pg, 1.0) / g)
    usable = (pg > 0) & (dlog_g.abs() > 1e-6) & (dlog_c.abs() > 1e-6)
    alpha = torch.where(usable, dlog_c / dlog_g, 2.0).clamp(0.5, 4.0)
    secant = g * torch.pow(torch.clamp(cf, min=1.0) / target, 1.0 / alpha)
    inside = (secant > lo) & (secant < hi)
    return torch.where(inside, secant, lo + (hi - lo) / 2.0)


def _point_count(px, py, pz, mask):
    """The searches' ``count_fn`` over a batch of clouds [B, N]: the
    occupied counts [B'] of the clouds ``idx`` at sizes [B']."""
    def count(idx, size, mins, maxs):
        return _count_occupied(px[idx], py[idx], pz[idx], mask[idx], size,
                               mins, maxs)
    return count


def _search_voxel_size(n_desired, mins, maxs, lo_min, count_fn):
    """The C bisection (ndt.c:136-187), batched: start at (MAX-MIN)/2,
    shrink [lo, hi] until the count lands in [n, 1.2n] or 15 counts pass;
    an unconverged cloud keeps the smallest count >= n seen. The lower
    bound is clamped to ``lo_min`` [B], the envelope where counts are
    exact. ``count_fn(idx, size, mins, maxs)`` gives the occupied counts
    [B'] of the clouds ``idx`` evaluated (an index tensor, or a slice of
    all), at their sizes, mins and maxs (``_point_count``, or the
    point-sharded path's collective count). Returns (voxel_size [B] f32,
    converged [B] bool)."""
    b = mins.shape[0]
    upper = _f32(n_desired * (1.0 + DOWNSAMPLE_UPPER_THRESHOLD), mins)
    lo = torch.clamp(lo_min, min=MIN_VOXEL_GUESS)
    hi = torch.clamp(lo, min=MAX_VOXEL_GUESS)
    guess = torch.clamp(lo, min=(MAX_VOXEL_GUESS - MIN_VOXEL_GUESS) / 2.0)
    done = torch.zeros(b, dtype=torch.bool, device=mins.device)
    best_g = torch.zeros_like(lo)
    best_c = torch.full((b,), _BIG_COUNT, dtype=torch.int64,
                        device=mins.device)
    rounds = _Rounds()
    for _ in range(MAX_GUESS_ITERATIONS):
        if not rounds.start(done):
            break
        g, mn, mx, l, h, bg, bc = rounds.take(guess, mins, maxs, lo, hi,
                                              best_g, best_c)
        count = count_fn(rounds.sel, g, mn, mx)
        hit, l, h, bg, bc = _ingest(g, count, l, h, bg, bc, n_desired, upper)
        lo, hi, best_g, best_c, guess, done = (rounds.merge(*p) for p in (
            (lo, l), (hi, h), (best_g, bg), (best_c, bc),
            (guess, torch.where(hit, g, l + (h - l) / 2.0)), (done, hit)))
    have_best = best_c < _BIG_COUNT
    final = torch.where(done, guess, torch.where(have_best, best_g, guess))
    return final, done


def _search_voxel_size_fast(n_desired, mins, maxs, count_fn, lo_min=None):
    """The seeded log-log secant search without the payload sort (the JAX
    package's unfused ``_search_voxel_size_fast``), batched. Evaluation 0
    is at the geometric-mean seed, each later one at ``_secant_step``.
    At most MAX_GUESS_ITERATIONS evaluations; an unconverged cloud returns
    the smallest-count-above-n size seen, else its next guess. Unlike
    ``_search_and_sort_fast`` (the same steps) no evaluation is forced to
    the fallback size. ``count_fn`` as for ``_search_voxel_size``;
    ``lo_min`` [B] optionally raises the lower bound. Returns
    (voxel_size [B] f32, converged [B] bool)."""
    upper = _f32(n_desired * (1.0 + DOWNSAMPLE_UPPER_THRESHOLD), mins)
    target = _f32(n_desired * (1.0 + DOWNSAMPLE_UPPER_THRESHOLD / 2.0), mins)
    size0, _, _ = vx.estimate_voxel_size(n_desired, mins, maxs)
    lo = torch.full_like(size0, MIN_VOXEL_GUESS)
    if lo_min is not None:
        lo = torch.maximum(lo, lo_min)
    hi = torch.clamp(lo, min=MAX_VOXEL_GUESS)
    guess = torch.minimum(torch.maximum(torch.nan_to_num(size0, nan=1.0), lo),
                          hi)
    done = torch.zeros_like(guess, dtype=torch.bool)
    best_g = torch.zeros_like(guess)
    best_c = torch.full(guess.shape, _BIG_COUNT, dtype=torch.int64,
                        device=guess.device)
    prev_g = torch.zeros_like(guess)
    prev_c = torch.zeros_like(guess)
    rounds = _Rounds()
    for _ in range(MAX_GUESS_ITERATIONS):
        if not rounds.start(done):
            break
        g, pg, pc, mn, mx, l, h, bg, bc = rounds.take(
            guess, prev_g, prev_c, mins, maxs, lo, hi, best_g, best_c)
        count = count_fn(rounds.sel, g, mn, mx)
        cf = count.float()
        hit, l, h, bg, bc = _ingest(g, count, l, h, bg, bc, n_desired, upper)
        nxt = _secant_step(g, cf, pg, pc, l, h, target)
        best_g, best_c, lo, hi, done, prev_g, prev_c, guess = (
            rounds.merge(*p) for p in (
                (best_g, bg), (best_c, bc), (lo, l), (hi, h), (done, hit),
                (prev_g, g), (prev_c, cf), (guess, torch.where(hit, g, nxt))))
    have_best = best_c < _BIG_COUNT
    final = torch.where(done, guess, torch.where(have_best, best_g, guess))
    return final, done


def _probe_seed_size(px, py, pz, mask, n_desired, mins, maxs, lo_min):
    """Cold-start probe: the occupancy of every PROBE_FACTOR-th point at
    the geometric-mean seed, Chao1-corrected, fed to the alpha = 2 secant
    step. Steering only: the returned size [B] seeds the fast search,
    whose exact counts still decide acceptance."""
    s0, _, _ = vx.estimate_voxel_size(n_desired, mins, maxs)
    lo0 = torch.clamp(lo_min, min=MIN_VOXEL_GUESS)
    hi0 = torch.clamp(lo0, min=MAX_VOXEL_GUESS)
    s0 = torch.minimum(torch.maximum(torch.nan_to_num(s0, nan=1.0), lo0), hi0)
    s_eval = torch.maximum(s0, _min_packable_voxel_size(mins, maxs))
    f = PROBE_FACTOR
    key, _, _ = _voxel_keys(px[:, ::f], py[:, ::f], pz[:, ::f], mask[:, ::f],
                            s_eval, mins, maxs)
    key = torch.sort(key, dim=-1).values
    valid = key != KEY_PAD
    new = _run_starts(key)
    start = valid & new
    # a run has length 1 iff the next position starts a run too (the pad
    # tail's first position counts as a start; the end pads True)
    ones = torch.ones_like(new[:, :2])
    nxt1 = torch.cat([new[:, 1:], ones[:, :1]], -1)
    nxt2 = torch.cat([new[:, 2:], ones], -1)
    d = start.sum(-1).float()
    f1 = (start & nxt1).sum(-1).float()
    f2 = (start & ~nxt1 & nxt2).sum(-1).float()
    d_hat = d + f1 * (f1 - 1.0) / (2.0 * (f2 + 1.0))
    target = _f32(n_desired * (1.0 + DOWNSAMPLE_UPPER_THRESHOLD / 2.0), px)
    step = s_eval * torch.sqrt(torch.clamp(d_hat, min=1.0) / target)
    return torch.minimum(torch.maximum(torch.nan_to_num(step, nan=1.0), lo0),
                         hi0)


def _count_occupied_multi(px, py, pz, mask, sizes, mins, maxs):
    """Occupied-voxel counts of each cloud [B] at G candidate sizes
    ``sizes`` [B, G], from one sort of the [B, G, N] keys. Returns [B, G]
    int64."""
    key, _, _ = _voxel_keys(px[:, None], py[:, None], pz[:, None],
                            mask[:, None], sizes, mins[:, None], maxs[:, None])
    b, g, n = key.shape
    skey = torch.sort(key.reshape(b * g, n), dim=-1).values
    return _count_runs(skey).reshape(b, g)


def _search_voxel_size_grid(px, py, pz, mask, n_desired, mins, maxs, lo_min,
                            g: int = 6, max_rounds: int = 5):
    """The grid-refinement search, batched: each round counts g
    log-spaced candidates inside each cloud's bracket with one sort
    (``_count_occupied_multi``), accepts the candidate in the band [n,
    1.2 n] whose count lies nearest 1.1 n, else shrinks the bracket to the
    gap between the largest too-fine and the smallest too-coarse size.
    An unconverged cloud returns the smallest-count-above-n size seen, else
    its bracket's geometric middle. At most ``max_rounds`` rounds; a
    finished cloud's carry is frozen, as under ``vmap``; eagerly the loop
    stops early when every cloud is done, which costs one host sync per
    round (none after the last), and sync-free (``_fixed_rounds()``) it
    runs all ``max_rounds``, with the same outputs. The lower bound is
    clamped to ``lo_min`` [B], the key mode's envelope. Returns
    (voxel_size [B] f32, converged [B] bool)."""
    upper = _f32(n_desired * (1.0 + DOWNSAMPLE_UPPER_THRESHOLD), px)
    target = _f32(n_desired * (1.0 + DOWNSAMPLE_UPPER_THRESHOLD / 2.0), px)
    lo = torch.clamp(lo_min, min=MIN_VOXEL_GUESS)
    llo, lhi = torch.log(lo), torch.log(torch.clamp(lo, min=MAX_VOXEL_GUESS))
    done = torch.zeros_like(llo, dtype=torch.bool)
    acc = torch.zeros_like(llo)
    best_g = torch.zeros_like(llo)
    best_c = torch.full(llo.shape, _BIG_COUNT, dtype=torch.int64,
                        device=llo.device)
    fracs = torch.arange(1, g + 1, dtype=torch.float32,
                         device=llo.device) / float(g + 1)
    sync_free = _sync_free()
    for r in range(max_rounds):
        lsizes = llo[:, None] + (lhi - llo)[:, None] * fracs     # [B, G]
        sizes = torch.exp(lsizes)
        counts = _count_occupied_multi(px, py, pz, mask, sizes, mins, maxs)
        countsf = counts.float()
        in_band = (counts >= n_desired) & (countsf <= upper)
        hit = in_band.any(-1)
        pick = torch.where(in_band, (countsf - target).abs(),
                           float("inf")).argmin(-1, keepdim=True)
        # counts fall (weakly) with the size: the new bracket is the gap
        # between the largest too-fine and the smallest too-coarse size
        new_llo = torch.where(countsf > upper, lsizes, llo[:, None]).amax(-1)
        new_lhi = torch.where(counts < n_desired, lsizes,
                              lhi[:, None]).amin(-1)
        new_lhi = torch.maximum(new_lhi, new_llo)
        # fallback: the smallest count still >= n seen
        cand = torch.where(counts >= n_desired, counts, _BIG_COUNT)
        cand_c = cand.amin(-1)
        cand_g = sizes.gather(-1, cand.argmin(-1, keepdim=True))[:, 0]
        active = ~done
        better = active & (cand_c < best_c)
        best_c = torch.where(better, cand_c, best_c)
        best_g = torch.where(better, cand_g, best_g)
        acc = torch.where(active & hit, sizes.gather(-1, pick)[:, 0], acc)
        llo = torch.where(active, new_llo, llo)
        lhi = torch.where(active, new_lhi, lhi)
        done = done | hit
        if (r + 1 < max_rounds and not sync_free
                and bool(done.all())):  # the round's host sync
            break
    mid = torch.exp((llo + lhi) * 0.5)
    final = torch.where(done, acc,
                        torch.where(best_c < _BIG_COUNT, best_g, mid))
    return final, done


def _sort_payload_at(px, py, pz, mask, classes, size, mins, maxs, tagged):
    """One stable voxel-key sort at ``size`` [B] with the coordinates (and
    the class tags, when tagged) as payload. Returns the sorted columns
    [key, px, py, pz(, cls)], each [B, N]: duplicate keys keep their input
    order, so the downstream sums have a fixed order."""
    key, _, _ = _voxel_keys(px, py, pz, mask, size, mins, maxs)
    skey, order = torch.sort(key, dim=-1, stable=True)
    payload = (px, py, pz) + ((classes,) if tagged else ())
    return [skey] + [torch.gather(p, -1, order) for p in payload]


def _search_and_sort_fast(px, py, pz, mask, classes, n_desired, mins, maxs,
                          lo_min, tagged, size0_override=None):
    """The seeded log-log secant search, each evaluation being the payload
    sort the moment build consumes (so the accepted evaluation's sort is
    the build's sort). Evaluation 0 is at the geometric-mean seed, or at
    ``size0_override`` [B] (the probe's or a warm start's size). At most
    MAX_GUESS_ITERATIONS further evaluations; the last one is forced to
    the best fallback size (smallest count >= n seen) so the carried sort
    matches the returned size on unconverged clouds. The lower bound is
    clamped to ``lo_min`` [B], the key mode's envelope.

    Returns (voxel_size [B], converged [B], sorted columns)."""
    upper = _f32(n_desired * (1.0 + DOWNSAMPLE_UPPER_THRESHOLD), px)
    target = _f32(n_desired * (1.0 + DOWNSAMPLE_UPPER_THRESHOLD / 2.0), px)
    b = px.shape[0]
    if size0_override is not None:
        size0 = _f32(size0_override, px).expand(b).clone()
    else:
        size0, _, _ = vx.estimate_voxel_size(n_desired, mins, maxs)
    lo = torch.clamp(lo_min, min=MIN_VOXEL_GUESS)
    hi = torch.clamp(lo, min=MAX_VOXEL_GUESS)
    size0 = torch.minimum(torch.maximum(torch.nan_to_num(size0, nan=1.0), lo),
                          hi)

    cols = _sort_payload_at(px, py, pz, mask, classes, size0, mins, maxs,
                            tagged)
    count = _count_runs(cols[0])
    accepted, lo, hi, best_g, best_c = _ingest(
        size0, count, lo, hi, torch.zeros_like(size0),
        torch.full_like(count, _BIG_COUNT), n_desired, upper,
    )
    guess = size0
    prev_g = torch.zeros_like(size0)
    prev_c = torch.zeros_like(size0)
    countf = count.float()

    rounds = _Rounds()
    for it in range(1, MAX_GUESS_ITERATIONS + 1):
        if not rounds.start(accepted):
            break
        g, l, h, bg, bc, pg, pc, cf = rounds.take(
            guess, lo, hi, best_g, best_c, prev_g, prev_c, countf)
        nxt = _secant_step(g, cf, pg, pc, l, h, target)
        if it >= MAX_GUESS_ITERATIONS:
            nxt = torch.where(bc < _BIG_COUNT, bg, nxt)
        sub = _sort_payload_at(*rounds.take(px, py, pz, mask, classes), nxt,
                               *rounds.take(mins, maxs), tagged)
        cnt = _count_runs(sub[0])
        hit, l, h, bg, bc = _ingest(nxt, cnt, l, h, bg, bc, n_desired, upper)
        accepted, guess, lo, hi, best_g, best_c, prev_g, prev_c, countf = (
            rounds.merge(*p) for p in (
                (accepted, hit), (guess, nxt), (lo, l), (hi, h), (best_g, bg),
                (best_c, bc), (prev_g, g), (prev_c, cf),
                (countf, cnt.float())))
        cols = [rounds.merge(c, new) for c, new in zip(cols, sub)]
    return guess, accepted, cols


def _moment_inputs(cols, voxel_size, lens, offsets, k_max, tagged):
    """The segment-moments kernel's inputs from the sorted columns.

    Returns a dict: xt, yt, zt (voxel-centre-shifted coordinates, zero on
    masked rows), v (validity), seg (dense sorted segment rank, k_max for
    masked points and segments beyond k_max), cls (tags, or None), tags
    (the per-segment voxel coords z, y, x masked to each segment's first
    row, so each segment's sum is the coordinate itself, exactly), and
    total (distinct occupied voxels per cloud)."""
    key, pxs, pys, pzs = cols[:4]
    valid = key != KEY_PAD
    ln = lens.long()
    lx, lxy = ln[:, 0:1], ln[:, 0:1] * ln[:, 1:2]
    rem = key % lxy
    z, y, x = key // lxy, rem // lx, rem % lx

    new_seg = _run_starts(key) & valid
    seg = torch.cumsum(new_seg, dim=-1) - 1
    total = seg[:, -1] + 1
    seg = torch.where(valid & (seg < k_max) & (seg >= 0), seg, k_max)

    s = voxel_size[:, None]

    def shifted(p, c, a):
        centre = vx.voxel_to_metric_axis(torch.where(valid, c, 0), s,
                                         offsets[:, a:a + 1])
        return torch.where(valid, p - centre, 0.0)

    return {
        "xt": shifted(pxs, x, 0), "yt": shifted(pys, y, 1),
        "zt": shifted(pzs, z, 2), "v": valid.float(),
        "seg": seg.to(torch.int32), "cls": cols[4] if tagged else None,
        "tags": tuple(torch.where(new_seg, c, 0).float() for c in (z, y, x)),
        "total": total,
    }


def _build_state(px, py, pz, mask, classes, num_class_slots, voxel_size,
                 converged, mins, maxs, k_max, presorted=None):
    """Sort by voxel key (unless the search's sort is given), reduce the
    moments, compute the neighbour KLs."""
    with span("ndtpu.ndt.moments"):
        lens, offsets = vx.estimate_voxel_grid(mins, maxs, voxel_size)
        tagged = num_class_slots > 1
        cols = presorted
        if cols is None:
            cols = _sort_payload_at(px, py, pz, mask, classes, voxel_size,
                                    mins, maxs, tagged)
        inp = _moment_inputs(cols, voxel_size, lens, offsets, k_max, tagged)
        mom = segment_moments_soa(
            inp["xt"], inp["yt"], inp["zt"], inp["v"], inp["seg"], k_max,
            classes=inp["cls"],
            num_class_slots=num_class_slots if tagged else 0,
            tags=inp["tags"],
        )
        counts = mom["counts"]
        class_hist = mom["class_hist"] if tagged else counts[..., None]
        occupied = counts > 0
        seg_zyx = torch.where(occupied[..., None],
                              torch.round(mom["tag_sums"]).to(torch.int32),
                              INT32_MAX)
        seg_centres = vx.voxel_to_metric_space(
            torch.where(occupied[..., None], seg_zyx.flip(-1), 0),
            voxel_size[:, None], offsets[:, None, :],
        )
        means, covs = finalize_moments(counts, mom["sum_shift"],
                                       mom["sum_outer"], seg_centres)
    with span("ndtpu.ndt.kl"):
        min_kl, max_kl = neighbor_min_kl(means, covs, counts, seg_zyx, lens)
    return NDTResult(
        means=means, covs=covs, counts=counts, class_hist=class_hist,
        zyx=seg_zyx, min_kl=min_kl, max_kl=max_kl, lens=lens,
        offsets=offsets, voxel_size=voxel_size,
        num_valid=torch.clamp(inp["total"], max=k_max).to(torch.int32),
        converged=converged,
    )


def _emit(state: NDTResult, n_out: int, prune_order: str = "ascending"):
    """Prune to n_out NDs and compact (ndt.c:28-117). ``prune_order``
    "ascending" removes the least divergent segments first (by min pair
    KL, the documented intent); "legacy_c" the C core's actual order, the
    most divergent first (by max pair KL). A stable sort keeps voxel order
    among ties; empty segments and segments without a finite key go last.

    Returns (points [B, n_out, 3], covs [B, n_out, 9], labels [B, n_out]
    i32, out_mask [B, n_out] bool); rows beyond the kept count are zero."""
    k = state.max_nds
    b = state.counts.shape[0]
    to_remove = torch.clamp(state.num_valid - n_out, min=0).long()
    occupied = state.counts > 0
    if prune_order == "legacy_c":
        key = torch.where(occupied & torch.isfinite(state.max_kl),
                          -state.max_kl, float("inf"))
    elif prune_order == "ascending":
        key = torch.where(occupied, state.min_kl, float("inf"))
    else:
        raise ValueError(
            f"prune_order must be ascending or legacy_c: {prune_order!r}")
    # sort 1: stable ascending prune key; row i of the order has rank i
    seg_by_kl = torch.sort(key, dim=-1, stable=True).indices
    ar = torch.arange(k, device=key.device)
    kept_s = (ar[None] >= to_remove[:, None]) & torch.gather(occupied, -1,
                                                             seg_by_kl)
    if os.environ.get("NDTPU_EMIT", "gather") != "gather":
        return _emit_payload(state, n_out, seg_by_kl, kept_s)
    # sort 2: compaction in ascending segment (voxel-index) order; the
    # keys are unique
    comp_key = torch.where(kept_s, seg_by_kl, k + seg_by_kl)
    order = torch.sort(comp_key, dim=-1).indices
    perm = torch.gather(seg_by_kl, -1, order)[:, :n_out]
    out_mask = torch.gather(kept_s, -1, order)[:, :n_out]

    def rows(t):
        t = t.reshape(b, k, -1)
        return torch.gather(t, 1, perm[..., None].expand(-1, -1, t.shape[-1]))

    m = out_mask[..., None]
    pcl = torch.where(m, rows(state.means), 0.0)
    covs = torch.where(m, rows(state.covs), 0.0)
    labels = torch.where(out_mask,
                         rows(state.class_hist).argmax(-1).to(torch.int32), 0)
    return pcl, covs, labels, out_mask


def _emit_payload(state: NDTResult, n_out: int, seg_by_kl, kept_s):
    """The payload emit (ndtpu/core/ndt.py:913-936, NDTPU_EMIT=payload):
    the kept flags scattered back to segment order, the compaction key in
    segment order, one sort, and the means, the 6 unique covariance
    entries and the argmax labels of all K rows as one stacked payload
    gathered by the sort's indices (labels < 2**24 ride exactly as f32);
    the covariances rebuilt symmetric from the upper entries."""
    k = state.max_nds
    kept_seg = torch.zeros_like(kept_s).scatter_(-1, seg_by_kl, kept_s)
    ar = torch.arange(k, device=kept_s.device)
    comp_key, order = torch.sort(torch.where(kept_seg, ar, k + ar), dim=-1)
    m, c = state.means, state.covs
    payload = torch.stack(
        [m[..., 0], m[..., 1], m[..., 2],
         c[..., 0, 0], c[..., 0, 1], c[..., 0, 2],
         c[..., 1, 1], c[..., 1, 2], c[..., 2, 2],
         state.class_hist.argmax(-1).to(m.dtype)], -1)  # [B, K, 10]
    cols = torch.gather(payload, 1, order[:, :n_out, None].expand(-1, -1, 10))
    out_mask = comp_key[:, :n_out] < k
    mk = out_mask[..., None]
    pcl = torch.where(mk, cols[..., 0:3], 0.0)
    c0, c1, c2, c3, c4, c5 = cols[..., 3:9].unbind(-1)
    covs = torch.where(mk, torch.stack([c0, c1, c2, c1, c3, c4, c2, c4, c5], -1),
                       0.0)
    labels = torch.where(out_mask, cols[..., 9].to(torch.int32), 0)
    return pcl, covs, labels, out_mask


def _envelope(mins, maxs, key_mode):
    """The smallest voxel size [B] whose keys are exact in ``key_mode``."""
    if key_mode == "pair":
        return _min_pair_packable_voxel_size(mins, maxs)
    if key_mode == "packed":
        return _min_packable_voxel_size(mins, maxs)
    raise ValueError(f"key_mode must be packed or pair: {key_mode!r}")


def _search(px, py, pz, mask, classes, n_desired, mins, maxs, tagged, search,
            fixed_voxel_size, warm_start_size, key_mode="packed"):
    """Pick each cloud's voxel size. Returns (voxel_size [B], converged
    [B], the sorted columns at that size or None)."""
    envelope = _envelope(mins, maxs, key_mode)
    if fixed_voxel_size is not None:
        # clamp into the key envelope; a binding clamp is not converged
        requested = _f32(fixed_voxel_size, px).expand(px.shape[0])
        voxel_size = torch.maximum(requested, envelope)
        return voxel_size, voxel_size <= requested, None
    if search == "grid":
        voxel_size, converged = _search_voxel_size_grid(
            px, py, pz, mask, n_desired, mins, maxs, lo_min=envelope)
        return voxel_size, converged, None
    if search in ("fast", "probe"):
        override = warm_start_size
        if search == "probe" and warm_start_size is None:
            override = _probe_seed_size(px, py, pz, mask, n_desired, mins,
                                        maxs, lo_min=envelope)
        return _search_and_sort_fast(
            px, py, pz, mask, classes, n_desired, mins, maxs,
            lo_min=envelope, tagged=tagged, size0_override=override,
        )
    if search != "reference":
        raise ValueError(
            f"search must be reference, fast, probe or grid: {search!r}")
    # exact C trajectory with the pair count, then clamped into the build
    # envelope; a binding clamp is reported as unconverged
    voxel_size, converged = _search_voxel_size(
        n_desired, mins, maxs, _min_pair_packable_voxel_size(mins, maxs),
        _point_count(px, py, pz, mask),
    )
    clamped = torch.maximum(voxel_size, envelope)
    return clamped, converged & (clamped <= voxel_size), None


def ndt_downsample(points, n_desired: int, mask=None, classes=None,
                   num_class_slots: int = 1, prune_order: str = "ascending",
                   search: str = "reference", fixed_voxel_size=None,
                   key_mode: str = "packed", warm_start_size=None):
    """Full NDT downsample of a batch of clouds (ndt.c:119-222).

    Args:
      points: [B, N, 3] float.
      n_desired: target ND count per cloud.
      mask: optional [B, N] bool validity (padding rows False).
      classes: optional [B, N] int class tags in [0, num_class_slots).
      num_class_slots: n_classes + 1 in reference terms; 1 = untagged.
      prune_order: "ascending" (the documented intent) or "legacy_c" (the
        C core's most-divergent-first order).
      search: "reference" (the exact C bisection), "fast" (seeded secant
        fused with the payload sort), "probe" ("fast" seeded by the Chao1
        probe) or "grid" (6 log-spaced candidates a round, one sort each).
      fixed_voxel_size: optional scalar or [B]; skips the search.
      key_mode: "packed" clamps voxel sizes to the < 2**31-cell grid
        envelope and reports ``converged=False`` where that clamp kept a
        cloud from the band (a dense cluster with a km-scale outlier);
        "pair" clamps to the (zy, x) pair envelope (len_z * len_y <
        2**31), where such clouds converge.
      warm_start_size: optional scalar or [B]; seeds "fast"/"probe".

    Returns (pcl [B, n, 3], covs [B, n, 9], labels [B, n] i32,
    out_mask [B, n] bool, state: NDTResult).
    """
    if points.dim() != 3 or points.shape[-1] != 3:
        raise ValueError(f"points must be [B, N, 3], got {tuple(points.shape)}")
    points = points.to(torch.float32)
    b, n, _ = points.shape
    if mask is None:
        mask = torch.ones((b, n), dtype=torch.bool, device=points.device)
    if classes is None:
        classes = torch.zeros((b, n), dtype=torch.int32, device=points.device)
    classes = classes.to(torch.int32)
    k_max = max_segments(n_desired)
    px, py, pz = (points[..., a].contiguous() for a in range(3))
    with span("ndtpu.ndt.search"):
        mins, maxs = _limits(px, py, pz, mask)
        voxel_size, converged, presorted = _search(
            px, py, pz, mask, classes, n_desired, mins, maxs,
            num_class_slots > 1, search, fixed_voxel_size, warm_start_size,
            key_mode,
        )
    state = _build_state(px, py, pz, mask, classes, num_class_slots,
                         voxel_size, converged, mins, maxs, k_max,
                         presorted=presorted)
    with span("ndtpu.ndt.emit"):
        pcl, covs, labels, out_mask = _emit(state, n_desired, prune_order)
    return pcl, covs, labels, out_mask, state


def ndt_prune(state: NDTResult, n_out: int, prune_order: str = "ascending"):
    """Second-stage prune to a coarser resolution: the removed set is a
    prefix of the same ranking, so this is the emit with a larger
    to_remove."""
    with span("ndtpu.ndt.emit"):
        return _emit(state, n_out, prune_order)


class NDTSampler:
    """Host-side wrapper of one cloud with the reference sampler's API
    (``NDT_Sampler.{downsample, prune, cleanup}``, ndt_legacy.py:45-240):
    numpy in, numpy out (points and covariances float64, labels uint16),
    the NDTResult kept between ``downsample`` and ``prune``. Runs on
    ``device``, the card unless the caller asks for the CPU, with the
    reference search and the ascending prune."""

    def __init__(self, point_cloud, classes=None, num_classes: int = 0,
                 device="cuda"):
        dev = resolve_device(device)
        pts = np.asarray(point_cloud, dtype=np.float32)
        self._points = torch.from_numpy(pts).to(dev)[None]
        self._classes = None
        if classes is not None:
            cls = np.asarray(classes, dtype=np.int32)
            self._classes = torch.from_numpy(cls).to(dev)[None]
        self._num_class_slots = int(num_classes) + 1
        self._state = None

    @staticmethod
    def _host(pcl, covs, labels):
        return (pcl[0].cpu().numpy().astype(np.float64),
                covs[0].cpu().numpy().astype(np.float64),
                labels[0].cpu().numpy().astype(np.uint16))

    def downsample(self, num_desired_nds: int):
        pcl, covs, labels, _, state = ndt_downsample(
            self._points, int(num_desired_nds), None, self._classes,
            num_class_slots=self._num_class_slots)
        self._state = state
        return self._host(pcl, covs, labels)

    def prune(self, num_desired_nds: int):
        if self._state is None:
            raise RuntimeError("call downsample() before prune()")
        if int(num_desired_nds) > int(self._state.num_valid[0]):
            # the reference's prune_nds errors when the target exceeds the
            # valid count (ndt.c:36-39)
            raise ValueError(
                "Number of desired normal distributions is greater than the "
                "number of valid distributions!"
            )
        pcl, covs, labels, _ = ndt_prune(self._state, int(num_desired_nds))
        return self._host(pcl, covs, labels)

    def cleanup(self):
        """Drops the state; there is no native memory to free."""
        self._state = None
