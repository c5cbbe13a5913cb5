"""The NDT preprocessing in plain PyTorch: the benchmark's reference.

A frozen, trimmed copy of the port's plain path (the voxel-size search
that the trainers and the serving pipeline run, ``search="probe"``, or a
fixed voxel size; packed keys; the ascending prune; the payload KL) with
no kernel, no host sync and nothing imported from the program. The
search runs every cloud through every round and freezes a finished
cloud's carry, as the program does inside its fixed rounds, so the
accepted voxel size is the program's bit for bit on the same device: the
counts it compares are exact integers and every float expression of the
search is written as the program writes it. The per-voxel sums are
accumulated in float64 and rounded once to float32; the program's
kernel sums in float32 in its own order, so the moments agree to float32
rounding and the KLs near the prune's cut may order differently.

Every function takes a leading batch dimension B; all points are valid.
"""
from __future__ import annotations

import torch

UPPER = 0.2                      # the search band [n, 1.2 n]
MIN_GUESS, MAX_GUESS = 0.01, 30.0
ROUNDS = 15
PROBE_FACTOR = 4
CELL_BUDGET = float(2**31 - 1024)
KEY_PAD = 2**62
BIG_COUNT = 2**31 - 1
INT32_MAX = 2**31 - 1
INT_CLAMP = float(2**62)


def max_segments(n_desired: int) -> int:
    return int(n_desired * (1.0 + UPPER)) + 8


def _f32(x, like):
    return torch.full((), float(x), dtype=torch.float32, device=like.device)


def _to_int(x, dtype=torch.int64):
    return x.clamp(-INT_CLAMP, INT_CLAMP).to(dtype)


def estimate_voxel_size(n, mins, maxs):
    dims = maxs - mins
    logs = torch.log(dims)
    log_n = torch.full((), float(n), dtype=dims.dtype, device=dims.device).log()
    return torch.exp((logs[..., 0] + logs[..., 1] + logs[..., 2] - log_n) / 3.0)


def grid(mins, maxs, size):
    """(lens [B, 3] int32, offsets [B, 3]) of the grid at ``size`` [B]."""
    lens = torch.clamp(torch.ceil((maxs - mins) / size[..., None]), min=1.0)
    return _to_int(lens, torch.int32), mins


def min_packable_size(mins, maxs):
    """The smallest voxel size whose grid has fewer cells than the packed
    key's budget and every axis under 2**24 cells."""
    d = torch.clamp(maxs - mins, min=0.0)
    dx, dy, dz = d.unbind(-1)
    b4 = _f32(CELL_BUDGET / 4.0, d)
    s3 = torch.pow((dx * dy * dz / b4).double(), 1.0 / 3.0).float()
    s2 = torch.sqrt((dx * dy + dx * dz + dy * dz) / b4)
    s1 = (dx + dy + dz) / b4
    exact = d.amax(-1) / _f32(2.0**24 - 2.0, d)
    return torch.maximum(torch.maximum(torch.maximum(s3, s2), s1), exact)


def voxel_coords(px, py, pz, size, mins, maxs):
    """(x, y, z) int64 voxel coordinates of every point, clamped into the
    grid, and the grid's (lens, offsets)."""
    lens, offsets = grid(mins, maxs, size)
    s = size[..., None]

    def coord(p, a):
        raw = _to_int(torch.floor((p - offsets[..., a:a + 1]) / s))
        return torch.minimum(raw.clamp(min=0), lens[..., a:a + 1].long() - 1)

    return coord(px, 0), coord(py, 1), coord(pz, 2), lens, offsets


def voxel_keys(px, py, pz, size, mins, maxs):
    """int64 key (z * len_y + y) * len_x + x of every point at ``size``."""
    x, y, z, lens, _ = voxel_coords(px, py, pz, size, mins, maxs)
    ln = lens.long()
    return (z * ln[..., 1:2] + y) * ln[..., 0:1] + x


def run_starts(skey):
    new = torch.ones_like(skey, dtype=torch.bool)
    new[:, 1:] = skey[:, 1:] != skey[:, :-1]
    return new


def count_occupied(px, py, pz, size, mins, maxs):
    skey = torch.sort(voxel_keys(px, py, pz, size, mins, maxs), dim=-1).values
    return ((skey != KEY_PAD) & run_starts(skey)).sum(-1)


def ingest(guess, count, lo, hi, best_g, best_c, n, upper):
    too_many = count.float() > upper
    too_few = count < n
    better = (count >= n) & (count < best_c)
    return (~too_many & ~too_few, torch.where(too_many, guess, lo),
            torch.where(too_few, guess, hi), torch.where(better, guess, best_g),
            torch.where(better, count, best_c))


def secant_step(g, cf, pg, pc, lo, hi, target):
    dlog_c = torch.log(torch.clamp(cf, min=1.0) / torch.clamp(pc, min=1.0))
    dlog_g = torch.log(torch.where(pg > 0, pg, 1.0) / g)
    usable = (pg > 0) & (dlog_g.abs() > 1e-6) & (dlog_c.abs() > 1e-6)
    alpha = torch.where(usable, dlog_c / dlog_g, 2.0).clamp(0.5, 4.0)
    secant = g * torch.pow(torch.clamp(cf, min=1.0) / target, 1.0 / alpha)
    inside = (secant > lo) & (secant < hi)
    return torch.where(inside, secant, lo + (hi - lo) / 2.0)


def probe_seed(px, py, pz, n, mins, maxs, lo_min):
    """The cold-start size: the Chao1-corrected occupancy of every 4th
    point at the geometric-mean size, one alpha = 2 secant step."""
    s0 = estimate_voxel_size(n, mins, maxs)
    lo0 = torch.clamp(lo_min, min=MIN_GUESS)
    hi0 = torch.clamp(lo0, min=MAX_GUESS)
    s0 = torch.minimum(torch.maximum(torch.nan_to_num(s0, nan=1.0), lo0), hi0)
    s_eval = torch.maximum(s0, min_packable_size(mins, maxs))
    f = PROBE_FACTOR
    key = torch.sort(voxel_keys(px[:, ::f], py[:, ::f], pz[:, ::f], s_eval,
                                mins, maxs), dim=-1).values
    new = run_starts(key)
    start = (key != KEY_PAD) & new
    ones = torch.ones_like(new[:, :2])
    nxt1 = torch.cat([new[:, 1:], ones[:, :1]], -1)
    nxt2 = torch.cat([new[:, 2:], ones], -1)
    d = start.sum(-1).float()
    f1 = (start & nxt1).sum(-1).float()
    f2 = (start & ~nxt1 & nxt2).sum(-1).float()
    d_hat = d + f1 * (f1 - 1.0) / (2.0 * (f2 + 1.0))
    target = _f32(n * (1.0 + UPPER / 2.0), px)
    step = s_eval * torch.sqrt(torch.clamp(d_hat, min=1.0) / target)
    return torch.minimum(torch.maximum(torch.nan_to_num(step, nan=1.0), lo0),
                         hi0)


def search(px, py, pz, n, mins, maxs, lo_min):
    """The seeded secant search from the probe's size: (voxel size [B],
    converged [B]). The last round is forced to the fallback size (the
    smallest count >= n seen) where a cloud has one."""
    upper = _f32(n * (1.0 + UPPER), px)
    target = _f32(n * (1.0 + UPPER / 2.0), px)
    lo = torch.clamp(lo_min, min=MIN_GUESS)
    hi = torch.clamp(lo, min=MAX_GUESS)
    size0 = probe_seed(px, py, pz, n, mins, maxs, lo_min)
    size0 = torch.minimum(torch.maximum(torch.nan_to_num(size0, nan=1.0), lo),
                          hi)
    count = count_occupied(px, py, pz, size0, mins, maxs)
    done, lo, hi, best_g, best_c = ingest(
        size0, count, lo, hi, torch.zeros_like(size0),
        torch.full_like(count, BIG_COUNT), n, upper)
    guess, countf = size0, count.float()
    prev_g, prev_c = torch.zeros_like(size0), torch.zeros_like(size0)
    for it in range(1, ROUNDS + 1):
        active = ~done
        nxt = secant_step(guess, countf, prev_g, prev_c, lo, hi, target)
        if it >= ROUNDS:
            nxt = torch.where(best_c < BIG_COUNT, best_g, nxt)
        cnt = count_occupied(px, py, pz, nxt, mins, maxs)
        hit, l, h, bg, bc = ingest(nxt, cnt, lo, hi, best_g, best_c, n, upper)
        new = {"done": hit, "guess": nxt, "lo": l, "hi": h, "best_g": bg,
               "best_c": bc, "prev_g": guess, "prev_c": countf,
               "countf": cnt.float()}
        old = {"done": done, "guess": guess, "lo": lo, "hi": hi,
               "best_g": best_g, "best_c": best_c, "prev_g": prev_g,
               "prev_c": prev_c, "countf": countf}
        kept = {k: torch.where(active, new[k], old[k]) for k in new}
        done, guess, lo, hi = kept["done"], kept["guess"], kept["lo"], kept["hi"]
        best_g, best_c = kept["best_g"], kept["best_c"]
        prev_g, prev_c, countf = kept["prev_g"], kept["prev_c"], kept["countf"]
    return guess, done


def det3(m):
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]))


def adjugate3(m):
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    return torch.stack([
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], dim=-1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], dim=-1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], dim=-1),
    ], dim=-2)


def gaussian_kl(mu_p, cov_p, mu_q, cov_q, rel_eps: float = 1e-6):
    """KL(p, q) of 3-D Gaussians, +inf where either covariance is singular
    by the scale-aware test |det| > rel_eps (tr/3)^3, the determinant
    ratio is not positive, or the result is not finite."""
    det_p, det_q = det3(cov_p), det3(cov_q)
    tr_p = torch.diagonal(cov_p, dim1=-2, dim2=-1).sum(-1) / 3.0
    tr_q = torch.diagonal(cov_q, dim1=-2, dim2=-1).sum(-1) / 3.0
    defined = (det_p.abs() > rel_eps * tr_p**3) & (det_q.abs() > rel_eps * tr_q**3)
    safe = torch.where(det_q != 0.0, det_q, torch.ones_like(det_q))
    q_inv = adjugate3(cov_q) / safe[..., None, None]
    diff = mu_q - mu_p
    quad = torch.einsum("...i,...ij,...j->...", diff, q_inv, diff)
    trace = torch.einsum("...ij,...ji->...", q_inv, cov_p)
    ratio = det_p / safe
    log_ratio = torch.log(torch.where(ratio > 0, ratio, torch.ones_like(ratio)))
    kl = 0.5 * (quad + trace + log_ratio - 3.0)
    defined = defined & (ratio > 0) & torch.isfinite(kl)
    return torch.where(defined, kl, torch.full_like(kl, float("inf"))), defined


def _pair_min(major, minor, means, covs, counts):
    """Each row's least KL over its pairs with the adjacent rows of one
    sorted layout that are grid neighbours (both counts > 1)."""
    ok = ((major[..., :-1] == major[..., 1:]) & (major[..., :-1] != INT32_MAX)
          & (minor[..., 1:] == minor[..., :-1] + 1)
          & (counts[..., :-1] > 1) & (counts[..., 1:] > 1))
    ma, ca, mb, cb = means[..., :-1, :], covs[..., :-1, :, :], means[..., 1:, :], covs[..., 1:, :, :]
    kl_ab, def_ab = gaussian_kl(ma, ca, mb, cb)
    kl_ba, def_ba = gaussian_kl(mb, cb, ma, ca)
    inf = torch.full_like(kl_ab[..., :1], float("inf"))
    fwd = torch.where(ok & def_ab, kl_ab, float("inf"))
    bwd = torch.where(ok & def_ba, kl_ba, float("inf"))
    return torch.minimum(torch.cat([fwd, inf], -1), torch.cat([inf, bwd], -1))


def neighbor_min_kl(means, covs, counts, zyx, lens):
    """[B, K] least KL of each voxel to its 6-connected occupied
    neighbours (+inf where it has none): the rows are in (z, y, x) order,
    so the x pairs are adjacent; re-sorting by (z, x | y) and (y, x | z)
    makes the y and the z pairs adjacent."""
    zyx, lens = zyx.long(), lens.long()
    z, y, x = zyx[..., 0], zyx[..., 1], zyx[..., 2]
    lx, ly = lens[..., 0:1], lens[..., 1:2]

    def pack(a, b, span):
        return torch.where(a == INT32_MAX, INT32_MAX, a * span + b)

    best = _pair_min(pack(z, y, ly), x, means, covs, counts)
    for major, minor in ((pack(z, x, lx), y), (pack(y, x, lx), z)):
        order = torch.sort((major << 32) | minor, dim=-1, stable=True).indices

        def g(t):
            idx = order.reshape(order.shape + (1,) * (t.dim() - 2))
            return torch.gather(t, 1, idx.expand(order.shape + t.shape[2:]))

        mn = _pair_min(g(major), g(minor), g(means), g(covs), g(counts))
        best = torch.minimum(best, torch.empty_like(mn).scatter_(-1, order, mn))
    return best


def build_state(points, cls, slots, size, mins, maxs, k, columns=torch.float32):
    """Sort at ``size``, the per-voxel moments and neighbour KLs: a dict
    of [B, K] rows in voxel-key order (means, covs, counts, class_hist,
    zyx, min_kl) and [B] num_valid. ``columns``: the type each point's
    shifted coordinates and products are held in before the sums (the
    control's bfloat16)."""
    px, py, pz = (points[..., a].contiguous() for a in range(3))
    x, y, z, lens, offsets = voxel_coords(px, py, pz, size, mins, maxs)
    ln = lens.long()
    key = (z * ln[..., 1:2] + y) * ln[..., 0:1] + x
    key, order = torch.sort(key, dim=-1, stable=True)
    px, py, pz, x, y, z = (torch.gather(t, -1, order) for t in (px, py, pz, x, y, z))
    seg = torch.cumsum(run_starts(key), dim=-1) - 1
    total = seg[:, -1] + 1
    seg = torch.where(seg < k, seg, k)
    s = size[:, None]
    centre = [(c.to(torch.float32) + 0.5) * s + offsets[:, a:a + 1]
              for a, c in enumerate((x, y, z))]
    d = [p - c for p, c in zip((px, py, pz), centre)]
    cols = [torch.ones_like(d[0])] + d + [d[i] * d[j] for i in range(3) for j in range(3)]
    cols = [c.to(columns).float() for c in cols]
    if slots:
        cls = torch.gather(cls.long(), -1, order)
        cols += [(cls == c).to(torch.float32) for c in range(slots)]
    cols += [c.to(torch.float32) for c in (z, y, x)]  # each voxel's own coords
    feats = torch.stack(cols, -1).double()
    b, n, f = feats.shape
    ids = (seg + torch.arange(b, device=seg.device)[:, None] * (k + 1)).reshape(-1)
    acc = torch.zeros(b * (k + 1), f, dtype=torch.float64, device=feats.device)
    acc.index_add_(0, ids, feats.reshape(-1, f))
    acc = acc.reshape(b, k + 1, f)[:, :k]
    counts = acc[..., 0].round().to(torch.int32)
    occupied = counts > 0
    nd = torch.clamp(acc[..., :1], min=1.0)
    zyx_f = acc[..., -3:] / nd                   # exact: one coordinate a voxel
    zyx = torch.where(occupied[..., None], zyx_f.round().to(torch.int32), INT32_MAX)
    acc = acc.float()
    seg_centre = ((torch.where(occupied[..., None], zyx, 0).flip(-1).float() + 0.5)
                  * size[:, None, None] + offsets[:, None, :])
    n1 = torch.clamp(counts, min=1).float()[..., None]
    mean_shift = acc[..., 1:4] / n1
    mean = torch.where(occupied[..., None], seg_centre + mean_shift, 0.0)
    cov = (acc[..., 4:13].reshape(b, k, 3, 3) / n1[..., None]
           - mean_shift[..., :, None] * mean_shift[..., None, :])
    cov = torch.where(occupied[..., None, None], cov, 0.0)
    mean, cov = torch.nan_to_num(mean), torch.nan_to_num(cov)
    hist = (acc[..., 13:13 + slots].round().to(torch.int32) if slots
            else counts[..., None])
    return {"means": mean, "covs": cov, "counts": counts, "class_hist": hist,
            "zyx": zyx, "min_kl": neighbor_min_kl(mean, cov, counts, zyx, lens),
            "num_valid": torch.clamp(total, max=k).to(torch.int32),
            "voxel_size": size}


def emit(state, n_out):
    """Prune to ``n_out`` NDs, least divergent first (a stable sort, empty
    voxels last), and compact in voxel order: (points [B, n_out, 3], covs
    [B, n_out, 9], labels [B, n_out], mask [B, n_out])."""
    counts = state["counts"]
    b, k = counts.shape
    to_remove = torch.clamp(state["num_valid"] - n_out, min=0).long()
    occupied = counts > 0
    by_kl = torch.sort(torch.where(occupied, state["min_kl"], float("inf")),
                       dim=-1, stable=True).indices
    ar = torch.arange(k, device=counts.device)
    kept = (ar[None] >= to_remove[:, None]) & torch.gather(occupied, -1, by_kl)
    order = torch.sort(torch.where(kept, by_kl, k + by_kl), dim=-1).indices
    perm = torch.gather(by_kl, -1, order)[:, :n_out]
    mask = torch.gather(kept, -1, order)[:, :n_out]

    def rows(t):
        t = t.reshape(b, k, -1)
        return torch.gather(t, 1, perm[..., None].expand(-1, -1, t.shape[-1]))

    m = mask[..., None]
    labels = torch.where(mask, rows(state["class_hist"]).argmax(-1), 0)
    return (torch.where(m, rows(state["means"]), 0.0),
            torch.where(m, rows(state["covs"]), 0.0), labels, mask)


def limits(points):
    return points.amin(dim=-2), points.amax(dim=-2)


def searched_size(points, n_desired):
    """[B] the voxel size the search accepts for each cloud of [B, N, 3]
    (the counts it compares do not depend on tags)."""
    points = points.to(torch.float32)
    px, py, pz = (points[..., a].contiguous() for a in range(3))
    mins, maxs = limits(points)
    return search(px, py, pz, n_desired, mins, maxs, min_packable_size(mins, maxs))[0]


def downsample(points, n_desired, tags=None, n_classes=0, voxel_size=None,
               columns=torch.float32):
    """The NDT state of a batch [B, N, 3] at the searched voxel size, or
    at ``voxel_size`` [B] clamped into the packed-key envelope. ``tags``
    [B, N] int class tags (None: untagged); ``columns`` as
    ``build_state``."""
    points = points.to(torch.float32)
    mins, maxs = limits(points)
    if voxel_size is None:
        size = searched_size(points, n_desired)
    else:
        size = torch.maximum(voxel_size.to(torch.float32), min_packable_size(mins, maxs))
    slots = n_classes + 1 if tags is not None else 0
    if tags is None:
        tags = torch.zeros(points.shape[:2], dtype=torch.int32, device=points.device)
    return build_state(points, tags, slots, size, mins, maxs,
                       max_segments(n_desired), columns)


def model_inputs(state, n_out, n_classes):
    """The model's inputs from a state: (points, covs [.., 9], one-hot
    [B, n_out, C + 1], mask), non-finite values scrubbed to 0."""
    pcl, covs, labels, mask = emit(state, n_out)
    onehot = ((labels[..., None] == torch.arange(n_classes + 1, device=labels.device))
              & mask[..., None]).to(torch.float32)
    return (torch.nan_to_num(pcl, nan=0.0, posinf=0.0, neginf=0.0),
            torch.nan_to_num(covs, nan=0.0, posinf=0.0, neginf=0.0), onehot, mask)
