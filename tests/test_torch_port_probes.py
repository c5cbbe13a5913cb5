"""K1's cost probes and the measurement modes of the segment reductions, on
the CPU at small sizes, against the JAX repository's scripts.

- P1 (``moment_probes.moments_empty``) and P2 (``moments_noflop``) run
  their plain versions here; they are held against the two TPU probe
  bodies of ``scripts/kernel_micro.py`` (``empty_body``, ``noflop_body``,
  copied below: they are closures inside its ``main``), run through
  ``pl.pallas_call(..., interpret=True)`` at the script's block
  configuration on its flat, offset, padded layout. K1's ``moments`` mode
  (the port's [B, N] layout) is held against the script's ``moments`` mode
  (``_moments_kernel`` through the same call) the same way.
- ``kernel_micro.kl_payload``'s per-axis minima and maxima agree with
  the JAX script's ``kl_payload`` computation (copied below) and give
  ``neighbor_min_kl``'s; ``xla_segment_sum`` (``index_add_``) is the
  plain segment sum.
- ``prep_micro``'s blocked matmul cumsum equals ``torch.cumsum``, and its
  prep's segment ids equal the cumsum prep's.

The interpret runs use B 2 x N 512, the smallest grid with two blocks
(block_n 512 at N 512). Their inputs are multiples of 1/16 of size at
most 2, so every product and every sum of these sizes is exact in f32:
the sums do not depend on the order, and the rows compare at rtol 1e-6.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ndtpu.ops.pallas import segment_moments as jsm
from ndtpu_torch.core.kl import neighbor_min_kl
from ndtpu_torch.ops import moment_probes as mp
from ndtpu_torch.ops import segment_moments as sm
from ndtpu_torch.scripts import kernel_micro, prep_micro

B, N, K, N_TAGS = 2, 512, 64, 3
SLOTS = (0, 1, 29)


def dyadic_inputs(slots, seed=0):
    """[B, N] probe inputs from numpy: dense sorted ranks over K, xt, yt,
    zt multiples of 1/16 in [-2, 2], v 0/1, classes in [0, slots), and
    N_TAGS tag columns xt * 0.5 (the JAX script's)."""
    rng = np.random.default_rng(seed)
    seg = np.sort(rng.integers(0, K, (B, N)), axis=1)
    for b in range(B):
        _, seg[b] = np.unique(seg[b], return_inverse=True)
    xt, yt, zt = (rng.integers(-32, 33, (B, N)).astype(np.float32) / 16
                  for _ in range(3))
    v = (rng.random((B, N)) > 0.2).astype(np.float32)
    cls = rng.integers(0, max(slots, 1), (B, N)).astype(np.int32)
    return dict(xt=xt, yt=yt, zt=zt, v=v, cls=cls, seg=seg.astype(np.int32),
                tags=[xt * 0.5 for _ in range(N_TAGS)])


def port(fn, x, slots):
    """``fn`` (a probe, K1 or a plain version) on x as torch tensors."""
    t = {k: torch.from_numpy(x[k]) for k in ("xt", "yt", "zt", "v", "cls",
                                             "seg")}
    return fn(t["xt"], t["yt"], t["zt"], t["v"], t["cls"], t["seg"], K, slots,
              tags=[torch.from_numpy(a) for a in x["tags"]]).numpy()


def jax_probe(mode, x, slots):
    """The JAX script's moments* mode on x: its layout (flat [B n_p] with
    each cloud's ids offset by ``rows`` and padded with _BIG), its
    ``probe_call`` and its bodies, interpreted. Returns (out [B rows, F],
    rows)."""
    block_n, sub_n = jsm._block_config(None, N)
    rows = jsm._round_up(max(K, sub_n + jsm._SUBLANE), jsm._SUBLANE)
    n_p = -(-N // block_n) * block_n
    seg_p = np.full((B, n_p), jsm._BIG, np.int32)
    seg_p[:, :N] = x["seg"] + np.arange(B)[:, None] * rows

    def flat(a, dtype=np.float32):
        out = np.zeros((B, n_p), dtype)
        out[:, :N] = a
        return jnp.asarray(out.reshape(B * n_p))

    ops = [jnp.asarray(seg_p.reshape(B * n_p)), flat(x["xt"]), flat(x["yt"]),
           flat(x["zt"]), flat(x["v"]), flat(x["cls"], np.int32),
           *[flat(t) for t in x["tags"]]]
    n_tags = len(x["tags"])
    f_out = 13 + slots + n_tags
    grid = (B * n_p // block_n,)
    assert grid == (2,)

    # scripts/kernel_micro.py:147-188, as they stand there (args.slots is
    # slots)
    def empty_body(*refs):
        out_ref = refs[-1]

        @pl.when(pl.program_id(0) == 0)
        def _():
            out_ref[:] = jnp.zeros_like(out_ref)

    def noflop_body(*refs):
        seg_ref, xt_ref, yt_ref, zt_ref, v_ref, cls_ref = refs[:6]
        tag_refs = refs[6:-1]
        out_ref = refs[-1]

        @pl.when(pl.program_id(0) == 0)
        def _():
            out_ref[:] = jnp.zeros_like(out_ref)

        for j in range(block_n // sub_n):
            sl = pl.ds(j * sub_n, sub_n)
            segv = seg_ref[0, 0, sl]
            xtv = xt_ref[0, 0, sl]
            ytv = yt_ref[0, 0, sl]
            ztv = zt_ref[0, 0, sl]
            vv = v_ref[0, 0, sl]
            clsv = cls_ref[0, 0, sl]
            xx, xy, xz = xtv * xtv, xtv * ytv, xtv * ztv
            yy, yz, zz = ytv * ytv, ytv * ztv, ztv * ztv
            row_list = [vv, xtv, ytv, ztv, xx, xy, xz, xy, yy, yz,
                        xz, yz, zz]
            for c in range(slots):
                row_list.append(vv * (clsv == c).astype(jnp.float32))
            for tr in tag_refs:
                row_list.append(tr[0, 0, sl])
            feats = jnp.stack(row_list, axis=0)  # [F, sub_n]
            red = jnp.sum(
                feats * (segv[None, :] >= 0), axis=1
            )  # [F], touches every element
            out_ref[pl.ds(0, jsm._SUBLANE), :] += jnp.broadcast_to(
                red[None, :], (jsm._SUBLANE, f_out)
            )

    body = {"moments_empty": empty_body, "moments_noflop": noflop_body,
            "moments": functools.partial(
                jsm._moments_kernel, block_n=block_n, sub_n=sub_n,
                rows=B * rows, slots=slots, n_tags=n_tags,
                bf16x3=False)}[mode]
    call = pl.pallas_call(
        body, grid=grid,
        in_specs=[pl.BlockSpec((1, 1, block_n), lambda i: (i, 0, 0))
                  for _ in ops],
        out_specs=pl.BlockSpec((B * rows, f_out), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((B * rows, f_out), jnp.float32),
        interpret=True,
    )
    out = call(*[a.reshape(grid[0], 1, block_n) for a in ops])
    return np.asarray(out), rows


@pytest.mark.parametrize("slots", SLOTS)
def test_noflop_plain_matches_the_tpu_noflop_body(slots):
    """P2's plain version: rows 0-7 of the flat output each hold every
    column's total, as the TPU body's 8-row strip does (rtol 1e-6), and
    every other row is exactly 0 in both."""
    x = dyadic_inputs(slots)
    want, _ = jax_probe("moments_noflop", x, slots)
    got = port(mp.moments_noflop, x, slots)  # the plain version on the CPU
    assert got.shape == (B, K, 13 + slots + N_TAGS)
    flat = got.reshape(B * K, -1)
    np.testing.assert_allclose(flat[:8], want[:8], rtol=1e-6, atol=0)
    assert not flat[8:].any() and not want[8:].any()
    assert np.all(flat[:8] == flat[0])
    # the strip sums every point: the count column is sum(v)
    assert flat[0, 0] == x["v"].sum()


@pytest.mark.parametrize("slots", SLOTS)
def test_empty_plain_matches_the_tpu_empty_body(slots):
    """P1's plain version: zeros of K1's output shape; the TPU body's
    output is zeros of its [B rows, F] (rows >= K: the JAX layout pads each
    cloud's rows to its window)."""
    x = dyadic_inputs(slots)
    want, rows = jax_probe("moments_empty", x, slots)
    got = port(mp.moments_empty, x, slots)
    assert got.shape == (B, K, 13 + slots + N_TAGS)
    assert want.shape == (B * rows, got.shape[-1]) and rows >= K
    assert not got.any() and not want.any()


@pytest.mark.parametrize("slots", SLOTS)
def test_moments_mode_matches_the_tpu_moments_probe(slots):
    """The moments mode on the port's layout ([B, N], each cloud's own
    ids) gives the JAX mode's rows (flat, cloud b at rows b * rows ...);
    rtol 1e-6."""
    x = dyadic_inputs(slots)
    want, rows = jax_probe("moments", x, slots)
    got = port(sm.fused_moments_sorted, x, slots)
    np.testing.assert_allclose(got, want.reshape(B, rows, -1)[:, :K],
                               rtol=1e-6, atol=0)


def test_noflop_error_bound_covers_the_f32_plain_version():
    """P2's f32 summation bound (K1's plan's chunk and blocks) holds the f32
    plain version to the float64 one on normal inputs, and is 0 off the
    strip."""
    rng = np.random.default_rng(5)
    seg = np.sort(rng.integers(0, 300, (3, 20000)), axis=1).astype(np.int32)
    x = kernel_micro.probe_inputs(seg, N_TAGS, "cpu")
    x["cls"] = torch.from_numpy(rng.integers(0, 29, seg.shape).astype(np.int32))
    args = (x["cls"], x["seg"], 300, 29)
    cols = [x[k] for k in ("xt", "yt", "zt", "v")]
    got = mp.moments_noflop_plain(*cols, *args, tags=x["tags"])
    ref = mp.moments_noflop_plain(*[c.double() for c in cols], *args,
                                  tags=[t.double() for t in x["tags"]])
    bound = mp.moments_noflop_error_bound(*cols, *args, tags=x["tags"])
    assert bool(((got.double() - ref).abs() <= bound).all())
    assert not bound.reshape(-1, bound.shape[-1])[8:].any()
    assert bool((bound.reshape(-1, bound.shape[-1])[:8] > 0).all())


def test_probe_wrappers_check_their_inputs():
    x = dyadic_inputs(29)
    t = {k: torch.from_numpy(x[k]) for k in ("xt", "yt", "zt", "v", "cls",
                                             "seg")}
    cols = (t["xt"], t["yt"], t["zt"], t["v"])
    for probe in (mp.moments_empty, mp.moments_noflop):
        with pytest.raises(ValueError, match="class slots"):
            probe(*cols, torch.zeros_like(t["cls"]), t["seg"], K,
                  mp.MAX_SLOTS + 1)
        with pytest.raises(ValueError, match="cls is required"):
            probe(*cols, None, t["seg"], K, 1)
        with pytest.raises(TypeError):
            probe(*cols, t["cls"], t["seg"].long(), K, 1)


# ---- the script modes ----

def test_kl_payload_axes_give_neighbor_min_kl():
    """kl_payload's per-axis minima and maxima, reduced over the axes, are
    neighbor_min_kl's (kl_full) bit for bit on the JAX script's draws."""
    inputs = kernel_micro.kl_inputs(np.random.default_rng(0), 2, 64, "cpu")
    zyx, means, covs, counts, lens, _ = inputs
    (mn_x, mx_x), (mn_y, mx_y), (mn_z, mx_z) = kernel_micro.kl_payload(
        zyx, means, covs, counts, lens)
    mn, mx = neighbor_min_kl(means, covs, counts, zyx, lens)
    assert torch.equal(torch.minimum(torch.minimum(mn_x, mn_y), mn_z), mn)
    assert torch.equal(torch.maximum(torch.maximum(mx_x, mx_y), mx_z), mx)
    assert bool(torch.isfinite(mn).any())
    got = kernel_micro.kl_fn("kl_payload", *inputs)()
    assert all(torch.equal(a, b) for pair, want in zip(
        got, ((mn_x, mx_x), (mn_y, mx_y), (mn_z, mx_z)))
        for a, b in zip(pair, want))


def jax_kl_payload(zyx, means, covs, counts, lens):
    """The JAX script's ``kl_payload`` closure (scripts/kernel_micro.py:
    316-356) run on each cloud in turn, as it stands there but for the
    lines marked "kept", which keep what it computes: per re-sort (by
    (z, x | y), then (y, x | z)) each segment's KL to its successor (o1)
    and to its predecessor (o2) in that order, scattered back to segment
    order, and for the +-x axis the same (ka and kb on the rows as they
    are). ``f``, the script's anti-CSE carry, is 0 here. Returns per cloud
    [(to successor, to predecessor) of +-x, +-y, +-z], numpy [K] each."""
    from ndtpu.core.kl import _pack_pair, gaussian_kl
    K = means.shape[1]
    lens_d = jnp.asarray(lens[0])
    kept = []

    def one(zyx_row, m, c, cnt):
        z, y, x = zyx_row[:, 0], zyx_row[:, 1], zyx_row[:, 2]
        idx = jnp.arange(K, dtype=jnp.int32)
        c6 = (c[:, 0, 0], c[:, 0, 1], c[:, 0, 2],
              c[:, 1, 1], c[:, 1, 2], c[:, 2, 2])
        payload = (idx, m[:, 0], m[:, 1], m[:, 2], *c6,
                   cnt.astype(jnp.float32))
        tot = jnp.float32(0.0)
        for maj, mi in ((_pack_pair(z, x, lens_d[0]), y),
                        (_pack_pair(y, x, lens_d[0]), z)):
            cols = jax.lax.sort((maj, mi) + payload,
                                num_keys=2)
            ms = jnp.stack(cols[3:6], axis=1)
            cv = cols[6:12]
            cs = jnp.stack(
                [jnp.stack([cv[0], cv[1], cv[2]], -1),
                 jnp.stack([cv[1], cv[3], cv[4]], -1),
                 jnp.stack([cv[2], cv[4], cv[5]], -1)], -2)
            ka, _ = gaussian_kl(ms[:-1], cs[:-1],
                                ms[1:], cs[1:])
            kb, _ = gaussian_kl(ms[1:], cs[1:],
                                ms[:-1], cs[:-1])
            perm = cols[2]
            mn = jnp.concatenate([ka, jnp.zeros((1,))])
            mx = jnp.concatenate([jnp.zeros((1,)), kb])
            o1 = jnp.full((K,), jnp.inf).at[perm].set(mn)
            o2 = jnp.full((K,), -jnp.inf).at[perm].set(mx)
            kept.append((np.asarray(o1), np.asarray(o2)))  # kept
            tot += jnp.sum(jnp.where(jnp.isfinite(o1), o1, 0.0)
                           + jnp.where(jnp.isfinite(o2), o2,
                                       0.0))
        # the free +-x axis: shifted evals, no sort
        ka, _ = gaussian_kl(m[:-1], c[:-1], m[1:], c[1:])
        kb, _ = gaussian_kl(m[1:], c[1:], m[:-1], c[:-1])
        kept.insert(-2, (np.append(np.asarray(ka), 0.0),  # kept
                         np.insert(np.asarray(kb), 0, 0.0)))
        return (tot + jnp.sum(jnp.nan_to_num(ka))
                + jnp.sum(jnp.nan_to_num(kb)))

    out = []
    for b in range(means.shape[0]):
        kept.clear()
        one(*(jnp.asarray(a[b]) for a in (zyx, means, covs, counts)))
        out.append(list(kept))
    return out


def neighbour_min_max(zyx, counts, to_next, to_prev, axis):
    """Each segment's (min, max) KL over its grid neighbours along
    ``axis`` (2 = x, 1 = y, 0 = z in zyx) from the KLs to its successor
    and predecessor in that axis's order, with the stage's masks: the
    neighbour occupies the next (previous) cell, both hold more than one
    sample, the KL is finite. (+inf, -inf) where no pair is valid."""
    cells = {tuple(r): i for i, r in enumerate(zyx)
             if r[0] != np.iinfo(np.int32).max}
    step = np.zeros(3, np.int64)
    step[axis] = 1
    mn = np.full(len(zyx), np.inf, np.float32)
    mx = np.full(len(zyx), -np.inf, np.float32)
    for cell, s in cells.items():
        for sign, kl in ((1, to_next[s]), (-1, to_prev[s])):
            t = cells.get(tuple(np.asarray(cell) + sign * step))
            if (t is None or counts[s] <= 1 or counts[t] <= 1
                    or not np.isfinite(kl)):
                continue
            mn[s], mx[s] = min(mn[s], kl), max(mx[s], kl)
    return mn, mx


@pytest.mark.parametrize("k", [64, 1208])
def test_kl_payload_axes_match_the_tpu_kl_payload(k):
    """kl_payload's per-axis minima and maxima against the JAX script's
    kl_payload computation on the same draws (``kl_inputs``; K 64, and the
    script's --k_max 1208): each segment's KLs to its successor and
    predecessor from the JAX closure, masked to grid neighbours as the
    stage masks them, give the port's per-axis (min, max): the same
    entries without a valid pair, and the rest within rtol 1e-5, atol
    1e-5, the tolerance at which tests/test_torch_port_kl.py holds the
    two frameworks' gaussian_kl (their last bits differ)."""
    inputs = kernel_micro.kl_inputs(np.random.default_rng(0), 2, k, "cpu")
    zyx, means, covs, counts, lens = (a.numpy() for a in inputs[:5])
    got = kernel_micro.kl_payload(*inputs[:5])
    want = jax_kl_payload(zyx, means, covs, counts, lens)
    pairs = 0
    for b in range(2):
        for (mn, mx), (to_next, to_prev), axis in zip(got, want[b],
                                                       (2, 1, 0)):
            ref_mn, ref_mx = neighbour_min_max(zyx[b], counts[b], to_next,
                                               to_prev, axis)
            for port, ref in ((mn[b].numpy(), ref_mn), (mx[b].numpy(), ref_mx)):
                np.testing.assert_array_equal(np.isfinite(port),
                                              np.isfinite(ref))
                fin = np.isfinite(ref)
                np.testing.assert_allclose(port[fin], ref[fin], rtol=1e-5,
                                           atol=1e-5)
            np.testing.assert_array_equal(mn[b].numpy()[~np.isfinite(ref_mn)],
                                          ref_mn[~np.isfinite(ref_mn)])
            pairs += int(np.isfinite(ref_mn).sum())
    assert pairs > 0


def test_xla_mode_is_the_plain_segment_sum():
    """The xla mode's index_add_ against segment_sum_sorted_plain on the
    script's draws (B 2, n 4096, f 42, k 64), rtol 1e-5; an id past k is
    dropped by both."""
    _, feats, seg = kernel_micro.segment_inputs(2, 4096, 42, 64)
    seg[:, -5:] = 64
    f, s = torch.from_numpy(feats), torch.from_numpy(seg)
    got = kernel_micro.xla_segment_sum(f, s, 64)
    want = sm.segment_sum_sorted_plain(f, s, 64)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("blk", [512, 300])
def test_matmul_cumsum_is_the_cumsum(blk):
    """The blocked matmul cumsum equals torch.cumsum on 0/1 flags [2, 4096],
    with a block that divides N and one that does not."""
    flags = torch.from_numpy(
        (np.random.default_rng(blk).random((2, 4096)) < 0.3).astype(np.float32))
    got = prep_micro.matmul_cumsum(flags, prep_micro.upper_ones(blk, "cpu"))
    assert torch.equal(got, torch.cumsum(flags, dim=1))


def test_prep_matmul_ids_are_prep_full_ids():
    """prep_matmul's segment ids (the blocked matmul cumsum) are
    prep_full's (torch.cumsum) on sorted pair keys with an INT32_MAX
    tail."""
    rng = np.random.default_rng(6)
    seg = np.sort(rng.integers(0, 200, (2, 4096)), axis=1)
    tail = np.arange(4096)[None, :] >= 4000
    zy = torch.from_numpy(np.where(tail, prep_micro._INT_MAX, seg // 40))
    xk = torch.from_numpy(np.where(tail, prep_micro._INT_MAX, seg % 40))
    full = prep_micro.segment_ids(zy, xk, 150)
    matmul = prep_micro.segment_ids(zy, xk, 150,
                                    upper=prep_micro.upper_ones(512, "cpu"))
    for a, b in zip(full, matmul):
        assert torch.equal(a, b)
    assert int(full[2].max()) == 150 and int(full[2].min()) == 0
