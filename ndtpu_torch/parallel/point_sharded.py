"""Exact point-sharded NDT downsample of one giant cloud (port of
``ndtpu/parallel/point_sharded.py``).

The point axis of one cloud is split over the ranks of a process group
(``parallel/mesh.py``). Per-voxel moments (n, sum x~, sum x~x~^T) are
associative, so each rank reduces its own points against a shared table of
occupied voxels and one ``all_reduce`` makes the result exact. The voxel
size search counts occupied voxels the same way: each rank finds the
distinct voxel keys of its points, the ranks all-gather these tables and
merge them, bounded by the static k_max. The ND set after the reduction is
small and replicated, so the KL, the prune and the compaction are the
single-cloud functions of ``core/`` with a batch of one.

What changes against the JAX package:
- ``shard_map`` over a ``points`` mesh axis becomes one call per rank:
  every rank passes its own shard of points, mask and classes, and calls
  the same collectives (a single rank too). ``all_gather`` and ``psum``
  are ``torch.distributed.all_gather`` (list form, which NCCL and gloo
  both take) and ``all_reduce(SUM)``; the global limits are local
  min/max plus one ``all_reduce(MIN)`` of [mins, -maxs].
- The (zy, x) pair key of the occupancy count is one int64 key
  ``zy * len_x + x`` under a plain sort (0 <= x < len_x, so the order is
  the two-key lexicographic order of ``lax.sort``); zy and x are
  recovered from it.
- Every distinct-run table, the merge of the gathered tables included,
  goes through ``segment_tags_sorted`` (the CUDA kernel K3 on the card),
  called with ``num_segments = k_max``: the run beyond k_max and the
  masked points, which the JAX code collects in a row k_max and slices
  away, are dropped without being read.
- The searches are the port's batched Python loops with a batch of one:
  deciding whether the count landed in band costs one host sync per
  evaluation.

Outputs follow the JAX contract: ``pcl [n, 3]``, ``covs [n, 9]``,
``labels [n]``, ``out_mask [n]``, replicated on every rank, and the state
as the port's ``NDTResult`` with a leading batch dim of 1.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ndtpu_torch.core import ndt as nd
from ndtpu_torch.core import voxel as vx
from ndtpu_torch.core.kl import INT32_MAX, neighbor_min_kl
from ndtpu_torch.core.moments import finalize_moments, segment_moments_soa
from ndtpu_torch.ops.segment_moments import segment_tags_sorted

_I64_MAX = torch.iinfo(torch.int64).max  # sorts after every packed pair key


def _all_gather(t, group):
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.stack(parts)


def _coords(px, py, pz, voxel_size, lens, offsets):
    return tuple(vx.metric_to_voxel_axis(p, voxel_size, lens[a], offsets[a])
                 for a, p in enumerate((px, py, pz)))


def _keys_soa(px, py, pz, mask, voxel_size, lens, offsets):
    """Packed voxel key (z * len_y + y) * len_x + x per point, int64,
    INT32_MAX on masked points. Inside the packable envelope (the
    downsample clamps the accepted size into it before the moment pass)
    every valid key is below INT32_MAX, so the order is the JAX int32
    key's."""
    x, y, z = _coords(px, py, pz, voxel_size, lens, offsets)
    ln = lens.long()
    return torch.where(mask, (z * ln[1] + y) * ln[0] + x, INT32_MAX)


def _keys_pair(px, py, pz, mask, voxel_size, lens, offsets):
    """(zy, x) key pair per point, int64, INT32_MAX on masked points:
    exact also below the packable envelope, so the reference search
    visits the C core's bisection sequence unclamped."""
    x, y, z = _coords(px, py, pz, voxel_size, lens, offsets)
    zy = torch.where(mask, z * lens[1].long() + y, INT32_MAX)
    return zy, torch.where(mask, x, INT32_MAX)


def _pair_key(zy, x, x_span):
    """One int64 key with the lexicographic order of (zy, x), for
    0 <= x < x_span; a padded zy (INT32_MAX) sorts last."""
    return torch.where(zy == INT32_MAX, _I64_MAX, zy * x_span + x)


def _split12(c, new):
    """12-bit hi/lo split of a non-negative integer column below 2**31,
    kept on segment-start rows only: each chunk is exact in f32 and each
    segment receives exactly one contribution, so a segment sum returns
    it bit-exactly."""
    hi = torch.where(new, c >> 12, 0).float()
    lo = torch.where(new, c & 0xFFF, 0).float()
    return hi, lo


def _join12(hi, lo):
    return ((torch.round(hi).to(torch.int32) << 12)
            | torch.round(lo).to(torch.int32))


def _table_inputs(cols, k_max):
    """The tags kernel's inputs for the distinct-run table of sorted key
    columns: (seg [n] int32 dense run ranks, k_max beyond the table and on
    padding; tags, two 12-bit-split columns per key column; count [] of
    distinct valid rows, unclipped)."""
    neq = cols[0][1:] != cols[0][:-1]
    for c in cols[1:]:
        neq |= c[1:] != c[:-1]
    valid = cols[0] != INT32_MAX
    new = torch.cat([valid[:1], neq & valid[1:]])
    seg = torch.cumsum(new, 0) - 1
    seg = torch.where(valid & (seg >= 0) & (seg < k_max), seg, k_max)
    tags = []
    for c in cols:
        tags += _split12(c, new)
    return seg.to(torch.int32), tags, new.sum()


def _distinct_sorted_cols(cols, k_max):
    """Distinct-run table of sorted key columns (lexicographic, first
    column primary; rows whose first column is INT32_MAX are padding).
    Returns (cols' [k_max] int32 each, padded with INT32_MAX; count [] of
    distinct valid rows, unclipped). The table is a segment reduction of
    12-bit-split tag columns (one K3 launch)."""
    seg, tags, count = _table_inputs(cols, k_max)
    acc = segment_tags_sorted(seg, tags, k_max)
    ok = torch.arange(k_max, device=seg.device) < torch.clamp(count, max=k_max)
    out = tuple(
        torch.where(ok, _join12(acc[:, 2 * i], acc[:, 2 * i + 1]), INT32_MAX)
        for i in range(len(cols))
    )
    return out, count


def _distinct_sorted(key, k_max):
    """Distinct sorted packed keys, padded to k_max with INT32_MAX. The
    input must be sorted. Returns (tkey [k_max] int32, count [])."""
    (tkey,), count = _distinct_sorted_cols((key,), k_max)
    return tkey, count


def _merge_tables(tkey, k_max):
    """Merge the gathered per-rank tables [D, k_max] into one sorted
    distinct table. Returns (tkey [k_max] int32, count [])."""
    return _distinct_sorted(torch.sort(tkey.reshape(-1)).values, k_max)


def _table_zyx(tkey, lens):
    """Packed-key table back to [k_max, 3] int32 (z, y, x) rows, padding
    INT32_MAX."""
    valid = tkey != INT32_MAX
    t = tkey.long()
    lx, lxy = lens[0].long(), lens[0].long() * lens[1].long()
    rem = t % lxy
    zyx = [t // lxy, rem // lx, rem % lx]
    return torch.stack([torch.where(valid, c, INT32_MAX) for c in zyx],
                       dim=1).to(torch.int32)


def _columns(points):
    return tuple(points[:, a].contiguous() for a in range(3))


def global_limits(points, mask, group=None):
    """Per-axis min/max of the whole sharded cloud: each rank's masked
    min/max, then one all_reduce(MIN) of [mins, -maxs]. Returns (mins,
    maxs), each [1, 3] (a batch of one cloud), replicated."""
    px, py, pz = _columns(points)
    mins, maxs = nd._limits(px[None], py[None], pz[None], mask[None])
    both = torch.cat([mins, -maxs], dim=-1)
    dist.all_reduce(both, op=dist.ReduceOp.MIN, group=group)
    return both[:, :3], -both[:, 3:]


def _moment_inputs(points, mask, voxel_size, lens, offsets, k_max: int,
                   classes=None):
    """This rank's inputs of the moment kernel: its points sorted by voxel
    key, shifted to their voxel centres (xt, yt, zt [n] f32, zero where
    masked), validity v, dense local ranks seg [n] int32 (k_max beyond the
    table and on masked points), classes cls [n] int32, and the rank's
    distinct keys as two sparse 12-bit-split tag columns."""
    n = points.shape[0]
    if classes is None:
        classes = torch.zeros(n, dtype=torch.int32, device=points.device)
    voxel_size = voxel_size.reshape(())
    px, py, pz = _columns(points)
    key0 = _keys_soa(px, py, pz, mask, voxel_size, lens, offsets)

    # rank-local payload sort; the stable sort keeps duplicate keys in
    # input order, so the moment sums have a fixed order
    key, order = torch.sort(key0, stable=True)
    valid = key != INT32_MAX

    # local dense ranks from the sorted runs
    new = torch.cat([valid[:1], (key[1:] != key[:-1]) & valid[1:]])
    lseg = torch.cumsum(new, 0) - 1
    lseg = torch.where(valid & (lseg >= 0) & (lseg < k_max), lseg, k_max)

    lx, lxy = lens[0].long(), lens[0].long() * lens[1].long()
    rem = key % lxy
    zyx = [torch.where(valid, c, 0) for c in (key // lxy, rem // lx, rem % lx)]

    def shifted(p, c, axis):
        centre = vx.voxel_to_metric_axis(c, voxel_size, offsets[axis])
        return torch.where(valid, p[order] - centre, 0.0)

    return {"xt": shifted(px, zyx[2], 0), "yt": shifted(py, zyx[1], 1),
            "zt": shifted(pz, zyx[0], 2), "v": valid.float(),
            "seg": lseg.to(torch.int32),
            "cls": classes.to(torch.int32)[order], "tags": _split12(key, new)}


def sharded_segment_moments(group, points, mask, voxel_size, lens, offsets,
                            k_max: int, num_class_slots: int = 1,
                            classes=None):
    """Global per-voxel moments of a point-sharded cloud.

    group: the process group the points are sharded over (None = the
    default group). points [n, 3] f32, mask [n] bool, classes [n] int:
    this rank's shard. voxel_size [] or [1], lens [3] int32, offsets [3]:
    the grid (replicated). k_max: the table capacity.

    Returns a dict, replicated on every rank: table [k_max, 3] (z, y, x)
    sorted, padding INT32_MAX; counts [k_max] int32; sum_shift
    [k_max, 3]; sum_outer [k_max, 3, 3]; class_hist [k_max, slots] int32;
    num_valid [] int32 (occupied voxels, clipped to k_max).
    """
    x = _moment_inputs(points, mask, voxel_size, lens, offsets, k_max,
                       classes)
    lmom = segment_moments_soa(
        x["xt"], x["yt"], x["zt"], x["v"], x["seg"], k_max, classes=x["cls"],
        num_class_slots=num_class_slots, tags=x["tags"],
    )
    ltkey = torch.where(
        lmom["counts"] > 0,
        _join12(lmom["tag_sums"][:, 0], lmom["tag_sums"][:, 1]), INT32_MAX,
    )
    tkey, num_valid = _merge_tables(_all_gather(ltkey, group), k_max)
    lacc = torch.cat([
        lmom["counts"].float()[:, None], lmom["sum_shift"],
        lmom["sum_outer"].reshape(k_max, 9), lmom["class_hist"].float(),
    ], dim=1)

    # local rank -> global table row: k_max queries, not n. Each kept row
    # gets at most one contribution, so index_add_ is exact in any order.
    gidx = torch.searchsorted(tkey, ltkey)
    found = (tkey[gidx.clamp(0, k_max - 1)] == ltkey) & (ltkey != INT32_MAX)
    gidx = torch.where(found, gidx, k_max)
    acc = torch.zeros((k_max + 1, lacc.shape[1]), dtype=torch.float32,
                      device=lacc.device)
    acc = acc.index_add_(0, gidx, lacc)[:k_max]
    dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)  # exact

    return {
        "table": _table_zyx(tkey, lens),
        "counts": torch.round(acc[:, 0]).to(torch.int32),
        "sum_shift": acc[:, 1:4],
        "sum_outer": acc[:, 4:13].reshape(k_max, 3, 3),
        "class_hist": torch.round(acc[:, 13:]).to(torch.int32),
        "num_valid": torch.clamp(num_valid, max=k_max).to(torch.int32),
    }


def _sorted_pair_cols(points, mask, voxel_size, lens, offsets):
    """This rank's (zy, x) voxel keys, sorted lexicographically (one sort
    of the packed int64 key), INT32_MAX on masked points."""
    px, py, pz = _columns(points)
    zy, x = _keys_pair(px, py, pz, mask, voxel_size.reshape(()), lens,
                       offsets)
    lx = lens[0].long()
    key = torch.sort(_pair_key(zy, x, lx)).values
    pad = key == _I64_MAX
    return (torch.where(pad, INT32_MAX, key // lx),
            torch.where(pad, INT32_MAX, key % lx))


def sharded_count_occupied(group, points, mask, voxel_size, lens, offsets,
                           k_max: int):
    """Occupied voxels of the whole point-sharded cloud at a grid (the
    search objective), clipped to k_max. Arguments as for
    ``sharded_segment_moments``. Returns [] int64, replicated."""
    (ltzy, ltx), _ = _distinct_sorted_cols(
        _sorted_pair_cols(points, mask, voxel_size, lens, offsets), k_max)
    gathered = _all_gather(torch.stack([ltzy, ltx]), group)  # [D, 2, k_max]
    mzy, mx = gathered[:, 0].reshape(-1).long(), gathered[:, 1].reshape(-1).long()
    mkey = torch.sort(_pair_key(mzy, mx, 2**32)).values
    new = torch.cat([mkey[:1] != _I64_MAX,
                     (mkey[1:] != mkey[:-1]) & (mkey[1:] != _I64_MAX)])
    return torch.clamp(new.sum(), max=k_max)


def search_voxel_size(group, points, mask, mins, maxs, n_desired, k_max,
                      search):
    """The voxel-size search with the collective count. Returns
    (voxel_size [1], converged [1]), replicated."""
    def count_fn(idx, guess, mins_, maxs_):  # idx: the one cloud, [1]
        lens, offsets = vx.estimate_voxel_grid(mins_, maxs_, guess)
        return sharded_count_occupied(group, points, mask, guess, lens[0],
                                      offsets[0], k_max).reshape(1)

    if search in ("fast", "probe"):
        return nd._search_voxel_size_fast(n_desired, mins, maxs, count_fn)
    # the C bisection from [MIN_VOXEL_GUESS, MAX_VOXEL_GUESS], unclamped
    return nd._search_voxel_size(n_desired, mins, maxs,
                                 torch.zeros_like(mins[:, 0]), count_fn)


def accepted_grid(voxel_size, converged, mins, maxs):
    """The searched size clamped into the packed key's envelope, which the
    moment pass needs; a binding clamp coarsens the grid and is reported
    as not converged. Returns (voxel_size [1], converged [1], lens [1, 3],
    offsets [1, 3])."""
    clamped = torch.maximum(voxel_size, nd._min_packable_voxel_size(mins, maxs))
    lens, offsets = vx.estimate_voxel_grid(mins, maxs, clamped)
    return clamped, converged & (clamped <= voxel_size), lens, offsets


def state_from_moments(mom, voxel_size, lens, offsets, converged):
    """Finalised moments and neighbour KLs as an NDTResult with a batch of
    one. voxel_size [1], lens/offsets [1, 3], converged [1]."""
    counts, table = mom["counts"][None], mom["table"][None]
    occupied = (counts > 0)[..., None]
    centres = vx.voxel_to_metric_space(
        torch.where(occupied, table.flip(-1), 0), voxel_size[:, None],
        offsets[:, None, :],
    )
    means, covs = finalize_moments(counts, mom["sum_shift"][None],
                                   mom["sum_outer"][None], centres)
    min_kl, max_kl = neighbor_min_kl(means, covs, counts, table, lens)
    return nd.NDTResult(
        means=means, covs=covs, counts=counts,
        class_hist=mom["class_hist"][None], zyx=table, min_kl=min_kl,
        max_kl=max_kl, lens=lens, offsets=offsets, voxel_size=voxel_size,
        num_valid=mom["num_valid"].reshape(1), converged=converged,
    )


def make_point_sharded_downsample(n_desired: int, num_class_slots: int = 1,
                                  group=None, search: str = "reference"):
    """Full NDT downsample of one giant cloud sharded over the ranks of
    ``group`` (None = the default group): the voxel-size search with
    collective counts, the point-sharded moment reduction, then KL, prune
    and compaction on the replicated ND set.

    search: "reference" follows the C bisection trajectory; "fast" is the
    seeded secant search (``_search_voxel_size_fast``) with the collective
    count; "probe" is an alias of "fast" (at giant-cloud occupancies the
    seed's count is exact and the subsampled estimator is not used).

    Returns fn(points [n, 3], mask [n] = all, classes [n] = 0), each
    rank's own shard on the group's device, -> (pcl [n_desired, 3], covs
    [n_desired, 9], labels [n_desired] int32, out_mask [n_desired] bool,
    state: NDTResult with batch 1), replicated on every rank.
    """
    if search not in ("reference", "fast", "probe"):
        raise ValueError(f"search must be reference, fast or probe: {search!r}")
    k_max = nd.max_segments(n_desired)

    def downsample(points, mask=None, classes=None):
        points = points.to(torch.float32)
        n = points.shape[0]
        if mask is None:
            mask = torch.ones(n, dtype=torch.bool, device=points.device)
        if classes is None:
            classes = torch.zeros(n, dtype=torch.int32, device=points.device)
        mins, maxs = global_limits(points, mask, group)
        voxel_size, converged = search_voxel_size(
            group, points, mask, mins, maxs, n_desired, k_max, search)
        voxel_size, converged, lens, offsets = accepted_grid(
            voxel_size, converged, mins, maxs)
        mom = sharded_segment_moments(group, points, mask, voxel_size,
                                      lens[0], offsets[0], k_max,
                                      num_class_slots, classes)
        state = state_from_moments(mom, voxel_size, lens, offsets, converged)
        pcl, covs, labels, out_mask = nd._emit(state, n_desired)
        return pcl[0], covs[0], labels[0], out_mask[0], state

    return downsample
