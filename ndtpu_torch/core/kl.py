"""Closed-form Gaussian KL divergence on batched 3x3 covariances (port of
``ndtpu/core/kl.py``).

The divergence keeps the reference's determinant-ratio sign
(kullback_leibler.c:115, ``+ ln(det p / det q)``) and the JAX package's
scale-aware singularity mask ``|det| > rel_eps * (tr/3)^3``.
``neighbor_min_kl`` has the JAX package's two modes, read at each call
as it reads them (ndtpu/core/kl.py:86-106):

- ``NDTPU_KL_MODE``: "payload" (the default) re-sorts the K segment rows
  by (z, x | y) and (y, x | z) with their moments riding along, so every
  6-neighbour pair is two adjacent rows of one sorted order; any other
  value selects "gather", the composition the payload mode replaced:
  the two re-sorts carry only the segment ids, and each axis gathers the
  moments of its pairs (18 segment gathers).
- ``NDTPU_KL_INV`` (gather mode only, as in JAX): "scatter" (the default)
  takes each axis back to segment order with one scatter-set; any other
  value selects "argsort", the inverse permutation by ``argsort`` and a
  gather.

All modes give the same outputs bit for bit (the mirrored covariance
entries are bit-equal). All functions take a leading batch dimension.
"""
from __future__ import annotations

import os

import torch

INT32_MAX = 2**31 - 1


def det3(m):
    """Analytic determinant of [..., 3, 3]."""
    return (
        m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
        - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
        + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0])
    )


def adjugate3(m):
    """Analytic adjugate of [..., 3, 3]; inverse = adj / det."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    return torch.stack(
        [
            torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], dim=-1),
            torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], dim=-1),
            torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], dim=-1),
        ],
        dim=-2,
    )


def gaussian_kl(mu_p, cov_p, mu_q, cov_q, rel_eps: float = 1e-6):
    """Reference-formula KL(p, q) for batched Gaussians.

    Returns (kl [...], defined [...]); kl is +inf where undefined (either
    covariance singular by the scale-aware test, a non-positive det ratio,
    or a non-finite result). Sample-count gating is the caller's job."""
    det_p = det3(cov_p)
    det_q = det3(cov_q)
    tr_p = torch.diagonal(cov_p, dim1=-2, dim2=-1).sum(-1) / 3.0
    tr_q = torch.diagonal(cov_q, dim1=-2, dim2=-1).sum(-1) / 3.0
    defined = (det_p.abs() > rel_eps * tr_p**3) & (det_q.abs() > rel_eps * tr_q**3)
    safe_det_q = torch.where(det_q != 0.0, det_q, torch.ones_like(det_q))

    q_inv = adjugate3(cov_q) / safe_det_q[..., None, None]
    diff = mu_q - mu_p
    quad = torch.einsum("...i,...ij,...j->...", diff, q_inv, diff)
    trace = torch.einsum("...ij,...ji->...", q_inv, cov_p)
    ratio = det_p / safe_det_q
    log_ratio = torch.log(torch.where(ratio > 0, ratio, torch.ones_like(ratio)))
    defined = defined & (ratio > 0)
    kl = 0.5 * (quad + trace + log_ratio - 3.0)
    defined = defined & torch.isfinite(kl)
    return torch.where(defined, kl, torch.full_like(kl, float("inf"))), defined


def _pack_pair(a, b, b_span):
    """(a, b) -> a * b_span + b, keeping INT32_MAX padding. int64."""
    return torch.where(a == INT32_MAX, INT32_MAX, a * b_span + b)


def kl_mode() -> str:
    """"payload" when NDTPU_KL_MODE is unset or "payload", else "gather"."""
    return ("payload" if os.environ.get("NDTPU_KL_MODE", "payload") == "payload"
            else "gather")


def inv_mode() -> str:
    """"scatter" when NDTPU_KL_INV is unset or "scatter", else "argsort"."""
    return ("scatter" if os.environ.get("NDTPU_KL_INV", "scatter") == "scatter"
            else "argsort")


def _adjacent(major, minor):
    """Rows i and i+1 of one sorted layout are grid neighbours: their
    majors match (and are not padding) and the minors differ by one."""
    return ((major[..., :-1] == major[..., 1:])
            & (major[..., :-1] != INT32_MAX)
            & (minor[..., 1:] == minor[..., :-1] + 1))


def _minmax(ok, m_a, c_a, m_b, c_b):
    """Per-row (min, max) of the directional KLs of pairs (a, b) = rows
    (i, i+1) where ``ok``: row i sees pair i forward and pair i-1
    backward."""
    kl_ab, def_ab = gaussian_kl(m_a, c_a, m_b, c_b)
    kl_ba, def_ba = gaussian_kl(m_b, c_b, m_a, c_a)
    inf = torch.full_like(kl_ab[..., :1], float("inf"))
    fwd = torch.where(ok & def_ab, kl_ab, float("inf"))
    bwd = torch.where(ok & def_ba, kl_ba, float("inf"))
    mn = torch.minimum(torch.cat([fwd, inf], -1), torch.cat([inf, bwd], -1))
    fwd = torch.where(ok & def_ab, kl_ab, float("-inf"))
    bwd = torch.where(ok & def_ba, kl_ba, float("-inf"))
    mx = torch.maximum(torch.cat([fwd, -inf], -1), torch.cat([-inf, bwd], -1))
    return mn, mx


def _pair_minmax(major, minor, m, c, cnt):
    """Directional KLs between adjacent rows of one sorted layout, with
    the rows' moments m, c and counts cnt in that layout. Returns per-row
    (min, max) over the row's two possible pairs."""
    ok = _adjacent(major, minor) & (cnt[..., :-1] > 1) & (cnt[..., 1:] > 1)
    return _minmax(ok, m[..., :-1, :], c[..., :-1, :, :], m[..., 1:, :],
                   c[..., 1:, :, :])


def _sym(c6):
    """6 unique covariance columns [..., 6] -> [..., 3, 3]. Slices, not a
    list index: a list index is copied to the card and stalls the host."""
    c = c6.unbind(-1)
    return torch.stack([c[0], c[1], c[2], c[1], c[3], c[4], c[2], c[4], c[5]],
                       -1).reshape(c6.shape[:-1] + (3, 3))


def neighbor_min_kl(means, covs, counts, zyx, lens):
    """Per-segment minimum and maximum KL to the 6-connected occupied
    neighbours (kullback_leibler.c:129-202 plus the prune's ordering).

    means [B, K, 3], covs [B, K, 3, 3], counts [B, K] int, zyx [B, K, 3]
    int (z, y, x) sorted lexicographically per cloud with INT32_MAX
    padding, lens [B, 3] grid dims (x, y, z). Returns (min_kl, max_kl)
    [B, K] f32, +inf / -inf where a segment has no valid pair.

    Each re-sort is one stable ``torch.sort`` of an int64 key
    ``major << 32 | minor`` (both parts in [0, INT32_MAX]) followed by a
    gather of the payload: the same order as the JAX two-key stable
    ``lax.sort``, padding ties kept in input order (the gather mode's
    three-key sort, whose third key is the input position, gives the
    same order). ``kl_mode`` and ``inv_mode`` pick the composition.
    """
    k = means.shape[-2]
    if k < 2:
        shape = means.shape[:-1]
        return (torch.full(shape, float("inf"), device=means.device),
                torch.full(shape, float("-inf"), device=means.device))
    zyx = zyx.long()
    lens = lens.long()
    z, y, x = zyx[..., 0], zyx[..., 1], zyx[..., 2]
    lx, ly = lens[..., 0:1], lens[..., 1:2]
    if kl_mode() == "gather":
        return _neighbor_min_kl_gather(means, covs, counts, z, y, x, lx, ly,
                                       inv_mode())
    c6 = torch.stack([covs[..., 0, 0], covs[..., 0, 1], covs[..., 0, 2],
                      covs[..., 1, 1], covs[..., 1, 2], covs[..., 2, 2]], -1)
    payload = torch.cat([means, c6], dim=-1)  # [B, K, 9]

    # +-x: rows are already in (z, y, x) order
    mn_x, mx_x = _pair_minmax(_pack_pair(z, y, ly), x, means, covs, counts)

    def resorted(major, minor):
        order = torch.sort((major << 32) | minor, dim=-1, stable=True).indices
        p = torch.gather(payload, -2, order[..., None].expand_as(payload))
        mn, mx = _pair_minmax(
            torch.gather(major, -1, order), torch.gather(minor, -1, order),
            p[..., :3], _sym(p[..., 3:]), torch.gather(counts, -1, order),
        )
        # back to segment order: order is a permutation, one scatter-set each
        return (torch.empty_like(mn).scatter_(-1, order, mn),
                torch.empty_like(mx).scatter_(-1, order, mx))

    mn_y, mx_y = resorted(_pack_pair(z, x, lx), y)
    mn_z, mx_z = resorted(_pack_pair(y, x, lx), z)
    min_kl = torch.minimum(torch.minimum(mn_x, mn_y), mn_z)
    max_kl = torch.maximum(torch.maximum(mx_x, mx_y), mx_z)
    return min_kl, max_kl


def _neighbor_min_kl_gather(means, covs, counts, z, y, x, lx, ly, inverse):
    """The gather mode (ndtpu/core/kl.py:155-209): the two re-sorts carry
    only the segment ids (the permutation), each axis gathers its pairs'
    moments and counts by segment id and takes its minima and maxima back
    to segment order by ``inverse`` ("scatter": a scatter-set; "argsort":
    ``argsort`` of the permutation and a gather). The +-x axis runs on the
    identity permutation, as in JAX."""
    idx = torch.arange(means.shape[-2], device=means.device).expand(
        counts.shape).contiguous()

    def rows(t, i):
        shape = i.shape + t.shape[i.dim():]
        return torch.gather(t, i.dim() - 1,
                            i.reshape(i.shape + (1,) * (t.dim() - i.dim()))
                            .expand(shape))

    def axis_contrib(major, minor, perm):
        a, b = perm[..., :-1], perm[..., 1:]
        ok = (_adjacent(major, minor) & (rows(counts, a) > 1)
              & (rows(counts, b) > 1))
        mn, mx = _minmax(ok, rows(means, a), rows(covs, a), rows(means, b),
                         rows(covs, b))
        if inverse == "scatter":
            return (torch.full_like(mn, float("inf")).scatter_(-1, perm, mn),
                    torch.full_like(mx, float("-inf")).scatter_(-1, perm, mx))
        inv = torch.argsort(perm, dim=-1)
        return torch.gather(mn, -1, inv), torch.gather(mx, -1, inv)

    def resorted(major, minor):
        perm = torch.sort((major << 32) | minor, dim=-1, stable=True).indices
        return axis_contrib(torch.gather(major, -1, perm),
                            torch.gather(minor, -1, perm), perm)

    mn_x, mx_x = axis_contrib(_pack_pair(z, y, ly), x, idx)
    mn_y, mx_y = resorted(_pack_pair(z, x, lx), y)
    mn_z, mx_z = resorted(_pack_pair(y, x, lx), z)
    min_kl = torch.minimum(torch.minimum(mn_x, mn_y), mn_z)
    max_kl = torch.maximum(torch.maximum(mx_x, mx_y), mx_z)
    return min_kl, max_kl
