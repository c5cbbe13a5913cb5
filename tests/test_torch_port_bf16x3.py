"""The TPU kernels' bf16x3 branch (NDTPU_PALLAS_PRECISION=bf16x3) in the
port, on the CPU, against the JAX package.

- ``split_bf16x3`` equals JAX's ``astype(bfloat16)`` split, jitted, bit
  for bit (NaN equal to NaN: near f32's maximum hi overflows to inf in
  both and mid is -inf or NaN in both), wherever x and its residuals are normal
  f32 or zero: XLA on the CPU flushes subnormal ones, the port keeps them.
- The plain versions against the TPU kernel bodies with ``bf16x3=True``
  (``_kernel``, ``_moments_kernel``), run through ``pl.pallas_call(...,
  interpret=True)`` at two grid steps of 512 points (sub-blocks of 128):
  every entry within ``bf16x3_error_bound`` of the float64 sum and within
  twice it of JAX; K1's count, class and (sparse) tag columns equal JAX's
  bit for bit, the fold being JAX's.
- The slice: the port's ``ndt_downsample(search="probe")`` against JAX's
  ``ndt_downsample(use_pallas=True)`` with the variable set on both
  sides, compared as tests/test_torch_port_ndt.py compares them (state,
  then the port's emit on the JAX state). JAX reads the variable while it
  traces, so the fixture clears the kernel factories' caches and JAX's
  before and after.
- Unset or any other value: both wrappers give the f32 outputs.
"""
import functools
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ndtpu.core import ndt as jn
from ndtpu.ops.pallas import segment_moments as jsm
from ndtpu_torch.core import ndt as tn
from ndtpu_torch.ops import segment_moments as sm

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from test_torch_port_ndt import assert_same_downsample, clusters  # noqa: E402

BLOCK_N, SUB_N = 512, 128  # two grid steps of four sub-blocks at N 1024


def clear_jax_caches():
    jsm._make_fn.cache_clear()
    jsm._make_moments_fn.cache_clear()
    jax.clear_caches()


@pytest.fixture
def bf16x3(monkeypatch):
    """NDTPU_PALLAS_PRECISION=bf16x3 on both sides, JAX's traces cleared
    before and after."""
    clear_jax_caches()
    monkeypatch.setenv(sm.PRECISION_VAR, "bf16x3")
    yield
    monkeypatch.delenv(sm.PRECISION_VAR)
    clear_jax_caches()


def jax_split(x):
    @jax.jit
    def split(a):
        hi = a.astype(jnp.bfloat16)
        r1 = a - hi.astype(jnp.float32)
        mid = r1.astype(jnp.bfloat16)
        lo = (r1 - mid.astype(jnp.float32)).astype(jnp.bfloat16)
        return tuple(c.astype(jnp.float32) for c in (hi, mid, lo))
    return [np.asarray(c) for c in split(jnp.asarray(x))]


def split_cases():
    """Normals (x 1e3), negatives, denormals, zeros, values on and next to
    the bf16 rounding ties (of x and of the residuals), f32's extremes."""
    rng = np.random.default_rng(0)
    normal = rng.normal(size=4096).astype(np.float32) * np.float32(1e3)
    bits = rng.integers(0, 1 << 31, size=2048, dtype=np.int64).astype(np.uint32)
    tie_bits = (bits & np.uint32(0xFFFF0000)) | np.uint32(0x8000)
    near = np.concatenate([tie_bits, tie_bits + np.uint32(1),
                           tie_bits - np.uint32(1),
                           (bits & np.uint32(0xFFFFFF00)) | np.uint32(0x80)])
    ties = near.view(np.float32)
    ties = ties[np.isfinite(ties)]
    denormal = (rng.integers(1, 1 << 23, size=512).astype(np.uint32)
                .view(np.float32))
    extremes = np.array([0.0, -0.0, 1.0, -1.0, np.finfo(np.float32).tiny,
                         np.finfo(np.float32).max, -np.finfo(np.float32).max,
                         np.float32(3.3e38), np.inf, -np.inf], np.float32)
    return np.concatenate([normal, -np.abs(normal), ties, -ties, denormal,
                           -denormal, extremes]).astype(np.float32)


# inf - inf at f32's extremes (in both packages)
@pytest.mark.filterwarnings("ignore:invalid value:RuntimeWarning")
def test_split_equals_jax_bit_for_bit():
    """Equal bit for bit wherever x and both residuals are zero or normal
    f32. XLA on the CPU flushes subnormal operands and results of the
    residual subtractions to zero, where the port (torch here, the kernel
    without fast math on the card) keeps them: on those values (|x| <
    2**-102) hi is still equal bit for bit, and both splits give back x to
    within 2**-125."""
    x = split_cases()
    got = [c.numpy() for c in sm.split_bf16x3(torch.from_numpy(x))]
    ref = jax_split(x)
    tiny = np.finfo(np.float32).tiny
    r1 = x - got[0]
    r2 = r1 - got[1]
    sub = np.zeros(x.shape, bool)
    for a in (x, r1, r2):
        sub |= (a != 0) & (np.abs(a) < tiny)
    assert np.all(np.abs(x[sub]) < 2.0**-102)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g[~sub].view(np.uint32)[~np.isnan(g[~sub])],
                                      r[~sub].view(np.uint32)[~np.isnan(g[~sub])])
        np.testing.assert_array_equal(g[~sub], r[~sub])  # NaN equal to NaN
    np.testing.assert_array_equal(got[0].view(np.uint32), ref[0].view(np.uint32))
    for chunks in (got, ref):
        back = ((chunks[0] + chunks[1]) + chunks[2])[sub].astype(np.float64)
        assert np.all(np.abs(back - x[sub]) <= 2.0**-125)
    big = np.abs(x) >= np.finfo(np.float32).max
    hi, mid, lo = got
    fin = np.isfinite(x) & (np.abs(x) < 3e38)
    back = ((hi + mid) + lo)[fin].astype(np.float64)
    # within u |x|, and bf16's subnormal spacing 2**-133 near zero
    assert np.all(np.abs(back - x[fin]) <= 2.0**-24 * np.abs(x[fin]) + 2.0**-133)
    assert np.isinf(hi[big]).all() and not np.isfinite(mid[big]).any()


def dense_ranks(rng, n, k):
    seg = np.zeros(n, np.int32)
    seg[rng.choice(n - 1, size=k - 1, replace=False) + 1] = 1
    return np.cumsum(seg).astype(np.int32)


def jax_k2(feats, seg, k):
    """_kernel(bf16x3=True) over one cloud's [N, F] rows, interpret mode."""
    n, f = feats.shape
    rows = -(-max(k, SUB_N + jsm._SUBLANE) // 8) * 8
    grid = (n // BLOCK_N,)
    call = pl.pallas_call(
        functools.partial(jsm._kernel, block_n=BLOCK_N, sub_n=SUB_N,
                          rows=rows, bf16x3=True),
        grid=grid,
        in_specs=[pl.BlockSpec((1, 1, BLOCK_N), lambda i: (i, 0, 0)),
                  pl.BlockSpec((BLOCK_N, f), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((rows, f), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((rows, f), jnp.float32),
        interpret=True,
    )
    out = call(jnp.asarray(seg).reshape(grid[0], 1, BLOCK_N), jnp.asarray(feats))
    return np.asarray(out)[:k]


def test_segment_sum_bf16x3_plain_matches_the_tpu_kernel():
    rng = np.random.default_rng(1)
    n, f, k = 1024, 42, 100
    seg = dense_ranks(rng, n, k)
    feats = (rng.normal(size=(n, f)) * np.exp(rng.normal(size=(n, f)))
             ).astype(np.float32)
    want = jax_k2(feats, seg, k)
    ft, st = torch.from_numpy(feats), torch.from_numpy(seg)
    got = sm.segment_sum_sorted_bf16x3_plain(ft, st, k)
    exact = sm.segment_sum_sorted_plain(ft.double(), st, k)
    bound = sm.bf16x3_error_bound(ft, st, k)
    assert bool(((got.double() - exact).abs() <= bound).all())
    assert np.all(np.abs(want - exact.numpy()) <= bound.numpy())
    assert np.all(np.abs(got.numpy() - want) <= 2 * bound.numpy())
    assert not torch.equal(got, sm.segment_sum_sorted_plain(ft, st, k))


def k1_inputs(rng, n, k, slots, n_tags):
    """One cloud's K1 columns: dense ranks, the last 40 points dropped (id
    k), masked coordinates, classes, tags nonzero (normal x 1e3, not
    integers) on each segment's first row."""
    seg = dense_ranks(rng, n, k)
    seg[-40:] = k
    v = (rng.random(n) > 0.1).astype(np.float32)
    xt, yt, zt = ((rng.normal(size=n) * v).astype(np.float32) for _ in range(3))
    cls = rng.integers(0, max(slots, 1), n).astype(np.int32)
    first = np.ones(n, bool)
    first[1:] = seg[1:] != seg[:-1]
    tags = [np.where(first, rng.normal(size=n) * 1e3, 0).astype(np.float32)
            for _ in range(n_tags)]
    return xt, yt, zt, v, cls, seg, tags


def jax_k1(xt, yt, zt, v, cls, seg, tags, k, slots):
    """_moments_kernel(bf16x3=True), interpret mode (ids >= k as the JAX
    wrapper passes them: _BIG)."""
    n = seg.shape[0]
    rows = -(-max(k, SUB_N + jsm._SUBLANE) // 8) * 8
    f = 13 + slots + len(tags)
    grid = (n // BLOCK_N,)
    seg = np.where(seg >= k, int(jsm._BIG), seg).astype(np.int32)
    ops = [seg, xt, yt, zt, v, cls, *tags]
    call = pl.pallas_call(
        functools.partial(jsm._moments_kernel, block_n=BLOCK_N, sub_n=SUB_N,
                          rows=rows, slots=slots, n_tags=len(tags),
                          bf16x3=True),
        grid=grid,
        in_specs=[pl.BlockSpec((1, 1, BLOCK_N), lambda i: (i, 0, 0))
                  for _ in ops],
        out_specs=pl.BlockSpec((rows, f), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((rows, f), jnp.float32),
        interpret=True,
    )
    out = call(*[jnp.asarray(a).reshape(grid[0], 1, BLOCK_N) for a in ops])
    return np.asarray(out)[:k]


@pytest.mark.parametrize("slots", [0, 1, 29])
@pytest.mark.parametrize("n_tags", [0, 3])
def test_fused_moments_bf16x3_plain_matches_the_tpu_kernel(slots, n_tags):
    rng = np.random.default_rng(10 * slots + n_tags)
    n, k = 1024, 100
    xt, yt, zt, v, cls, seg, tags = k1_inputs(rng, n, k, slots, n_tags)
    want = jax_k1(xt, yt, zt, v, cls, seg, tags, k, slots)
    t = [torch.from_numpy(a) for a in (xt, yt, zt, v, cls, seg)]
    tt = [torch.from_numpy(a) for a in tags]
    args = (*t[:4], t[4] if slots else None, t[5], k, slots)
    got = sm.fused_moments_sorted_bf16x3_plain(*args, tags=tt)
    exact = sm.fused_moments_sorted_plain(
        *(a.double() for a in t[:4]), args[4], t[5], k, slots,
        tags=[a.double() for a in tt])
    bound = sm.fused_moments_bf16x3_error_bound(*args, tags=tt)
    assert got.shape == want.shape == (k, 13 + slots + n_tags)
    assert bool(((got.double() - exact).abs() <= bound).all())
    assert np.all(np.abs(got.numpy() - want) <= 2 * bound.numpy())
    exact_cols = [0] + list(range(13, 13 + slots + n_tags))
    np.testing.assert_array_equal(got.numpy()[:, exact_cols],
                                  want[:, exact_cols])
    # the mirrored products are the same sums
    g = got.numpy()
    for a, b in ((5, 7), (6, 10), (9, 11)):
        np.testing.assert_array_equal(g[:, a], g[:, b])


@pytest.mark.parametrize("value", [None, "f32", "bf16", "BF16X3", "bf16x3 "])
def test_f32_unless_exactly_bf16x3(monkeypatch, value):
    """Unset or any other value than "bf16x3": both wrappers give the f32
    outputs (the parent's CPU path, the plain f32 version) bit for bit;
    "bf16x3" gives the bf16x3 plain versions."""
    rng = np.random.default_rng(3)
    xt, yt, zt, v, cls, seg, tags = k1_inputs(rng, 2048, 150, 29, 3)
    t = [torch.from_numpy(a) for a in (xt, yt, zt, v, cls, seg)]
    tt = [torch.from_numpy(a) for a in tags]
    feats = torch.from_numpy(rng.normal(size=(2, 2048, 14)).astype(np.float32))
    seg2 = torch.stack([t[5], t[5]])
    if value is None:
        monkeypatch.delenv(sm.PRECISION_VAR, raising=False)
    else:
        monkeypatch.setenv(sm.PRECISION_VAR, value)
    assert sm.precision() == "f32"
    assert torch.equal(sm.fused_moments_sorted(*t, 150, 29, tags=tt),
                       sm.fused_moments_sorted_plain(*t, 150, 29, tags=tt))
    assert torch.equal(sm.segment_sum_sorted(feats, seg2, 150),
                       sm.segment_sum_sorted_plain(feats, seg2, 150))
    monkeypatch.setenv(sm.PRECISION_VAR, "bf16x3")
    assert sm.precision() == "bf16x3"
    assert torch.equal(sm.fused_moments_sorted(*t, 150, 29, tags=tt),
                       sm.fused_moments_sorted_bf16x3_plain(*t, 150, 29,
                                                            tags=tt))
    assert torch.equal(sm.segment_sum_sorted(feats, seg2, 150),
                       sm.segment_sum_sorted_bf16x3_plain(feats, seg2, 150))


def test_downsample_under_bf16x3_matches_jax(bf16x3):
    """B 2, N 4096 -> 256: the port's probe search in band, JAX's accepted
    sizes to rtol 1e-5, then both at JAX's sizes (fixed_voxel_size)
    compared as tests/test_torch_port_ndt.py compares them."""
    batch = clusters(2, 64, 64, 10.0, 0.3, 12)
    n = 256
    pts = torch.from_numpy(batch)
    out = tn.ndt_downsample(pts, n, search="probe")
    st = out[4]
    assert bool(st.converged.all())
    assert bool(((st.num_valid >= n) & (st.num_valid <= int(1.2 * n))).all())
    assert bool((out[3].sum(-1) == n).all())
    sizes = np.asarray(jax.vmap(
        lambda p: jn.ndt_downsample(p, n, search="probe",
                                    use_pallas=True)[4].voxel_size
    )(jnp.asarray(batch)))
    np.testing.assert_allclose(st.voxel_size.numpy(), sizes, rtol=1e-5)
    got = tn.ndt_downsample(pts, n, fixed_voxel_size=torch.tensor(sizes))
    for b in range(2):
        ref = jn.ndt_downsample(jnp.asarray(batch[b]), n, use_pallas=True,
                                fixed_voxel_size=jnp.float32(sizes[b]))
        assert_same_downsample(got, ref, b)
