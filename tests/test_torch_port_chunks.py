"""The chunk kernels' launch plan and error bounds, on the CPU.

K1 (``fused_moments_sorted``), K2 (``segment_sum_sorted``) and K3
(``segment_tags_sorted``) run one block per chunk of a cloud's points on
the card (K2 also per column group where whole rows do not fit). What the
wrapper computes in Python is checked here at the serving, giant and
extreme shapes: the plans (``range_plan``, ``sum_plan``, mirrored from the
source) fit the card, the source's ownership rule (``chunk_segments``
below) gives every segment one block and K2's column groups every
(segment, column) one block, and the f32 error bounds the card tests use
hold for an emulation of the kernels' summation order. The kernels
themselves run in tests/test_torch_port_cuda.py.
"""
import numpy as np
import pytest
import torch

from ndtpu_torch.ops import segment_moments as sm


MAX_BLOCKS = 2**31 - 1  # the grid's x limit
MAX_GROUPS = 65535      # the grid's y limit
MAX_SMEM = 227 * 1024   # shared memory a block may use on an H100


def chunk_segments(seg_ids, num_segments: int, chunk: int):
    """The segments each block of a chunk kernel owns, for one cloud's
    sorted ids [N]: [blocks, 2] rows [s_lo, s_hi), from the ids before its
    chunk and at its end, as ``reduce_chunk`` in the source reads them.
    Block j owns the segments whose first point (or, for an empty segment,
    the point where it would start) lies in [j * chunk, (j + 1) * chunk)."""
    n = seg_ids.shape[-1]
    ends = torch.arange(chunk, n, chunk)
    lo = torch.clamp(seg_ids[ends - 1].long() + 1, 0, num_segments)
    zero = torch.zeros(1, dtype=torch.long)
    k = torch.full((1,), num_segments, dtype=torch.long)
    return torch.stack([torch.cat([zero, lo]), torch.cat([lo, k])], dim=1)


@pytest.mark.parametrize("batch,n,n_cols,slots,f", [
    (16, 70000, sm.staged_columns(0, 3), 0, None),        # the canonical request
    (1, 1 << 20, sm.staged_columns(1, 2), 1, None),       # the giant moment pass
    (1, 1 << 20, 1 + 4, 0, None),               # the giant pair keys (K3)
    (16, 70000, sm.staged_columns(29, 8), 29, None),      # the trainers' slots, 8 tags
    (1, 1, sm.staged_columns(29, 8), 29, None),
    (4096, 1 << 19, sm.staged_columns(0, 0), 0, None),    # 2**31 points
    # K2: the giant oracle, the canonical batch with 28 and 29 class slots,
    # one column, the widest whole rows, column groups
    (1, 1 << 20, None, 0, 14), (16, 70000, None, 0, 41),
    (16, 70000, None, 0, 42), (1000, 2000, None, 0, 1),
    (16, 70000, None, 0, 32), (1, 1 << 20, None, 0, 95),
    (1, 1 << 20, None, 0, 96), (4, 50000, None, 0, 1024),
    (1, 1 << 20, None, 0, 88), (1, 1 << 20, None, 0, 92),
])
def test_range_plan_fits_the_card(batch, n, n_cols, slots, f):
    if f is None:
        chunk, tile, blocks, smem = sm.range_plan(batch, n, n_cols, slots)
        groups = 1
    else:
        chunk, tile, blocks, smem, width, pitch, groups = sm.sum_plan(batch, n, f)
        n_cols = 1 + pitch                             # the ids and a row
        assert groups == -(-f // width) <= MAX_GROUPS
        assert (groups == 1) == (width == f) == (f <= (95 if f % 4 else 88))
        # lanes reading one column of 32 consecutive staged rows: at most
        # 2-way bank conflicts in a contiguous span (F % 4 != 0), 4-way in
        # rows of whole 16-byte units
        if pitch == f:
            assert f % 4 and groups == 1 and np.gcd(pitch, 32) <= 2
        else:
            assert pitch % 8 == 4 and pitch >= 4 * ((width + 6) // 4)
        assert smem == sm.range_plan(batch, n, n_cols, carry=width,
                                     groups=groups)[3]
    assert smem <= MAX_SMEM
    assert 1 <= blocks // groups <= MAX_BLOCKS
    assert blocks == batch * -(-n // chunk) * groups  # every point in a chunk
    assert chunk >= sm.MIN_CHUNK and chunk % sm.CHUNK_STEP == 0
    assert sm.MIN_TILE <= tile <= sm.MAX_TILE and tile % sm.RANGE_THREADS == 0
    assert n_cols * tile * 4 <= sm.STAGE_BYTES or tile == sm.MIN_TILE


def ids_of(layout, n, k, rng):
    """Sorted ids over k segments; ids >= k dropped."""
    if layout == "ranks":                  # dense ranks, short dropped tail
        steps = np.zeros(n, np.int64)
        steps[rng.choice(n - 1, size=k - 1, replace=False) + 1] = 1
        ids = np.cumsum(steps)
        ids[-7:] = k
    elif layout == "gaps":                 # gaps, then a long dropped tail
        ids = np.concatenate([np.sort(rng.integers(0, k // 2, n // 3)),
                              np.full(n - n // 3, k + 1)])
    elif layout == "singletons":
        ids = np.arange(n)
    elif layout == "one":
        ids = np.zeros(n, np.int64)
    else:                                  # "long": runs longer than chunks
        ids = np.repeat(np.arange(n // 1700 + 1), 1700)[:n]
    return torch.from_numpy(ids.astype(np.int32))


@pytest.mark.parametrize("layout,n,k,chunk", [
    ("ranks", 70000, 1209, 3072), ("gaps", 20000, 3000, 512),
    ("singletons", 5000, 4000, 512), ("one", 1 << 20, 1, 2816),
    ("long", 100000, 40, 768), ("ranks", 3000, 3000, 512),
])
def test_chunk_segments_cover_every_segment_once(layout, n, k, chunk):
    ids = ids_of(layout, n, k, np.random.default_rng(n + k))
    owned = chunk_segments(ids, k, chunk)
    assert owned.shape == (-(-n // chunk), 2)
    # consecutive ranges from 0 to k: each segment has one block
    assert int(owned[0, 0]) == 0 and int(owned[-1, 1]) == k
    assert torch.equal(owned[1:, 0], owned[:-1, 1])
    assert bool((owned[:, 1] >= owned[:, 0]).all())
    # the block owns exactly the segments that start in its chunk (an
    # empty one where it would start), the last block those after the end
    start = torch.searchsorted(ids.long(), torch.arange(k))
    block = torch.clamp(start // chunk, max=owned.shape[0] - 1)
    for j in range(owned.shape[0]):
        mine = torch.nonzero(block == j).flatten()
        assert torch.equal(mine, torch.arange(int(owned[j, 0]), int(owned[j, 1])))


def lane_order_sum(x):
    """The kernels' f32 order for one run (ops/segment_moments.py, the
    note in the source): lane l adds x[l], x[l + 32], ... in order; the
    lanes are combined by warp_reduce_scatter with S = 32 slots, of which
    slot 0 is this value."""
    lanes = np.zeros((32, 32), np.float32)           # [lane][slot]
    for lane in range(32):
        acc = np.float32(0)
        for v in x[lane::32]:
            acc = np.float32(acc + v)
        lanes[lane, 0] = acc
    w = 16
    while w >= 1:
        nxt = lanes.copy()
        for lane in range(32):
            upper = bool(lane & w)
            for i in range(w):
                send = lanes[lane ^ w, i + w] if not (lane ^ w) & w else lanes[lane ^ w, i]
                keep = lanes[lane, i + w] if upper else lanes[lane, i]
                nxt[lane, i] = np.float32(keep + send)
        lanes = nxt
        w //= 2
    return float(lanes[0, 0])                        # lane 0 holds slot 0


def group_columns(f):
    """K2's blocks of one chunk, by column group: [groups, 2] rows [c0,
    c1), as segment_sum_kernel reads blockIdx.y and sum_plan's width."""
    width, groups = sm.sum_plan(1, 1, f)[4::2]
    c0 = torch.arange(groups) * width
    return torch.stack([c0, torch.clamp(c0 + width, max=f)], dim=1)


@pytest.mark.parametrize("f,layout,n,k", [
    (14, "ranks", 20000, 300), (41, "long", 30000, 20), (1, "singletons", 3000, 3000),
    (96, "gaps", 20000, 3000), (256, "ranks", 9000, 200), (1000, "one", 4000, 1),
])
def test_column_groups_cover_every_entry_once(f, layout, n, k):
    ids = ids_of(layout, n, k, np.random.default_rng(f))
    chunk = sm.sum_plan(1, n, f)[0]
    hits = torch.zeros(k, f, dtype=torch.long)
    for s_lo, s_hi in chunk_segments(ids, k, chunk).tolist():
        for c0, c1 in group_columns(f).tolist():
            hits[s_lo:s_hi, c0:c1] += 1
    assert bool((hits == 1).all())


def lane_order_sum(x):
    """The kernels' f32 order for one run (ops/segment_moments.py, the
    note in the source): lane l adds x[l], x[l + 32], ... in order; the
    lanes are combined by warp_reduce_scatter with S = 32 slots, of which
    slot 0 is this value."""
    lanes = np.zeros((32, 32), np.float32)           # [lane][slot]
    for lane in range(32):
        acc = np.float32(0)
        for v in x[lane::32]:
            acc = np.float32(acc + v)
        lanes[lane, 0] = acc
    w = 16
    while w >= 1:
        nxt = lanes.copy()
        for lane in range(32):
            upper = bool(lane & w)
            for i in range(w):
                send = lanes[lane ^ w, i + w] if not (lane ^ w) & w else lanes[lane ^ w, i]
                keep = lanes[lane, i + w] if upper else lanes[lane, i]
                nxt[lane, i] = np.float32(keep + send)
        lanes = nxt
        w //= 2
    return float(lanes[0, 0])                        # lane 0 holds slot 0


@pytest.mark.parametrize("length", [1, 31, 33, 256, 1025, 1782])
def test_error_bounds_hold_for_the_kernels_order(length):
    rng = np.random.default_rng(length)
    x = (rng.normal(size=length) * 1e3).astype(np.float32)
    xt = torch.from_numpy(x)
    zero = torch.zeros_like(xt)
    seg = torch.zeros(length, dtype=torch.int32)
    # K1's column "x" of one run, K3's one tag column, K2's one feature
    k1 = sm.fused_moments_error_bound(xt, zero, zero, torch.ones_like(xt), None,
                                      seg, 2, 0)
    k3 = sm.segment_tags_error_bound(seg, [xt], 2)
    k2 = sm.segment_sum_error_bound(xt[:, None], seg, 2)
    exact = float(np.sum(x.astype(np.float64)))
    err = abs(lane_order_sum(x) - exact)
    assert err <= float(k1[0, 1]) and err <= float(k3[0, 0])
    assert err <= float(k2[0, 0])
    for bound in (k1, k2, k3):
        assert bool(torch.isfinite(bound).all())
        # empty rows (segment 1 has no point) have no error
        assert float(bound[1].abs().max()) == 0


def test_error_bounds_grow_with_the_run():
    ones = torch.ones(4096)
    seg = torch.cat([torch.zeros(64), torch.ones(4032)]).to(torch.int32)
    k1 = sm.fused_moments_error_bound(ones, ones, ones, ones, None, seg, 2, 0)
    k2 = sm.segment_sum_error_bound(torch.ones(4096, 3), seg, 2)
    k3 = sm.segment_tags_error_bound(seg, [ones], 2)
    # per unit of sum|terms|, the longer run's bound is the larger
    assert bool((k1[1] / 4032 > k1[0] / 64).all())
    assert bool((k2[1] / 4032 > k2[0] / 64).all())
    assert float(k3[1, 0]) / 4032 > float(k3[0, 0]) / 64
