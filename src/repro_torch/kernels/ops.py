"""Public wrappers around the kernels: each lookup kernel call followed by
its epilogue, the K7 distance matrix, the K6 histogram and the K5
least-squares fit (counterpart of ``repro.kernels.ops``).

The epilogues are plain torch ops: the seam verification that re-searches
the rare window misses, the tombstone hit test and the two-tier live-rank
arithmetic.  All inputs are f32 key space: ``keys``/``delta_keys`` the f32
copies of the tiers, queries converted to f32 by the caller.
"""
from __future__ import annotations

import torch

from . import lookup as _lookup

# Seam-fix accounting: calls verified and window misses re-searched.  Each
# verification reads its miss count to the host once.
SEAM = {"calls": 0, "misses": 0}


def reset_seam() -> None:
    SEAM["calls"] = 0
    SEAM["misses"] = 0


def _seam_fix(r, kf, qf, seam_budget: int = 1024, right: bool = False):
    """Seam verification in f32 key space.  Valid positions satisfy the
    left-boundary invariant kf[r-1] < q <= kf[r] (``right``: kf[r-1] <= q
    < kf[r]); the rest -- boundary queries outside their leaf's window,
    or sentinel windows deeper than the clamped depth -- are replaced by
    ``searchsorted``.  Up to ``seam_budget`` misses are re-searched alone;
    past it the whole batch is re-searched (same result, fewer launches)."""
    n = kf.shape[0]
    rc = r.clamp(0, n - 1).long()
    prev = kf[(r - 1).clamp(0, n - 1).long()]
    if right:
        valid = ((r == 0) | (prev <= qf)) & ((r == n) | (kf[rc] > qf))
    else:
        valid = ((r == 0) | (prev < qf)) & ((r == n) | (kf[rc] >= qf))
    bad = ~valid
    n_bad = int(bad.sum())
    SEAM["calls"] += 1
    SEAM["misses"] += n_bad
    if n_bad == 0:
        return r
    if n_bad <= min(seam_budget, qf.shape[0]):
        idx = torch.nonzero(bad).squeeze(1)
        r = r.clone()
        r[idx] = torch.searchsorted(kf, qf[idx], right=right).to(r.dtype)
        return r
    full = torch.searchsorted(kf, qf, right=right).to(r.dtype)
    return torch.where(valid, r, full)


def index_lookup(queries, root, mat, vec, keys, *, n_leaves: int,
                 root_kind: str = "linear", leaf_kind: str = "linear",
                 iters: int | None = None, seam_budget: int = 1024,
                 rows=None, fence=None):
    """Static serving lookup (K1 + seam fix): left boundaries of f32
    ``queries`` in the f32 ``keys``.  ``iters`` None derives the clamped
    depth from the bound rows of ``vec``; ``rows`` and ``fence`` the
    index's cached leaf rows and key fence."""
    if iters is None:
        iters = _lookup.search_iters(vec[1, :n_leaves], vec[2, :n_leaves],
                                     keys.shape[0])
    r = _lookup.lookup(queries, root, mat, vec, keys, n_leaves=n_leaves,
                       iters=iters, root_kind=root_kind, leaf_kind=leaf_kind,
                       rows=rows, fence=fence)
    return _seam_fix(r, keys, queries, seam_budget)


def rmrt_lookup(queries, mat, vec, keys, *, fanout: int, depth: int,
                kind: str = "linear", iters: int | None = None,
                seam_budget: int = 1024, rows=None, fence=None):
    """RMRT serving lookup (K4 + seam fix) over ``pack_rmrt`` tables.
    ``iters`` None derives the clamped depth from the bound rows of
    ``vec`` (internal nodes carry zero-width rows; sentinel windows of
    empty leaves are excluded, as for the RMI); ``rows`` and ``fence`` the
    RMRT's cached node rows and key fence."""
    if iters is None:
        iters = _lookup.search_iters(vec[1], vec[2], keys.shape[0])
    r = _lookup.rmrt_lookup(queries, mat, vec, keys, fanout=fanout,
                            depth=depth, kind=kind, iters=iters, rows=rows,
                            fence=fence)
    return _seam_fix(r, keys, queries, seam_budget)


def ksdist_matrix(tgt_hists, pool_a, pool_ps):
    """(L, P) Algorithm-2 distance matrix, targets x pool (K7)."""
    from .ksdist import ksdist
    return ksdist(tgt_hists, pool_a, pool_ps)


def histogram(keys, m: int, lo, hi):
    """Streaming m-bin relative-frequency histogram of unsorted keys (K6):
    (m,) f32, right-closed bins over [lo, hi]."""
    from .hist import hist
    return hist(keys, m, lo, hi)


def standardize(v):
    """(f64 (v - mean) / std, mean, std) with the population std of
    ``jnp.std`` (``correction=0``), floored at 1e-30: the coordinates of
    :func:`segment_linfit`'s first K5 pass."""
    v64 = v.to(torch.float64)
    mu = v64.mean()
    sd = v64.std(correction=0).clamp(min=1e-30)
    return (v64 - mu) / sd, mu, sd


def segment_linfit(x, y, buckets, n_buckets: int):
    """Per-bucket least-squares (slope, intercept) of y on x: (n_buckets, 2)
    f64, from two K5 passes.  Pass 1 sums globally standardised f32
    coordinates for the per-bucket means; the inputs are then centred per
    bucket in f64 (a bucket's own dynamic range is small, so pass 2's f32
    moments are exact enough) and pass 2 sums the centred cross moments.
    Global standardisation alone would cancel catastrophically when buckets
    are narrow slices of the key range."""
    from .linfit import linfit_sums
    f64 = torch.float64
    xn, mu_x, sd_x = standardize(x)
    yn, mu_y, sd_y = standardize(y)
    s1 = linfit_sums(xn.to(torch.float32), yn.to(torch.float32), buckets,
                     n_buckets)
    n = s1[:, 0].to(f64)
    nn = n.clamp(min=1.0)
    bmu_x = s1[:, 1].to(f64) / nn            # in standardised coordinates
    bmu_y = s1[:, 2].to(f64) / nn
    # JAX's gather: a negative id counts from the end, then ids clamp into
    # range (such keys add nothing to the sums either way).
    b = torch.where(buckets < 0, buckets + n_buckets, buckets) \
        .clamp(0, max(n_buckets - 1, 0)).long()
    s2 = linfit_sums((xn - bmu_x[b]).to(torch.float32),
                     (yn - bmu_y[b]).to(torch.float32), buckets, n_buckets)
    sxy, sxx = s2[:, 3].to(f64), s2[:, 4].to(f64)
    a_s = torch.where(sxx > 1e-20, sxy / sxx, torch.zeros_like(sxy))
    a = a_s * sd_y / sd_x
    b0 = (bmu_y * sd_y + mu_y) - a * (bmu_x * sd_x + mu_x)
    return torch.stack([a, torch.where(n > 0, b0, torch.zeros_like(b0))], 1)


def _edge_pad(psum, n: int):
    """Pad a prefix-sum vector to length ``n`` by repeating its last entry."""
    extra = n - psum.shape[0]
    if extra <= 0:
        return psum
    return torch.cat([psum, psum[-1:].expand(extra)])


def dynamic_index_lookup(queries, root, mat, vec, keys, base_psum,
                         delta_keys, delta_psum, *, n_leaves: int,
                         route_n: int, iters: int, root_kind: str = "linear",
                         leaf_kind: str = "linear", seam_budget: int = 1024,
                         rows=None):
    """Two-tier serving find: K2, then the seam fix of the base positions
    and the tombstone / live-rank algebra.  ``delta_keys`` is the sorted
    +inf-padded f32 delta tier; ``*_psum`` the exclusive tombstone prefix
    sums (length n + 1); ``rows`` the index's cached leaf rows.  Returns
    (found, rank, base_pos, delta_pos): ``found`` iff a live copy of q is
    in either tier, ``rank`` the live keys < q over both tiers."""
    df = _lookup.pad_delta(delta_keys)
    pos, dpos = _lookup.dynamic_lookup(queries, root, mat, vec, keys, df,
                                       n_leaves=n_leaves, route_n=route_n,
                                       iters=iters, root_kind=root_kind,
                                       leaf_kind=leaf_kind, rows=rows)
    # The delta probe ran at full depth, so only the base needs the seam
    # pass.  A hit is a live entry in the equal-key run [left, right).
    pos = _seam_fix(pos, keys, queries, seam_budget)
    bhi = torch.searchsorted(keys, queries, right=True).to(torch.int32)
    base_hit = (bhi - pos) > (base_psum[bhi.long()] - base_psum[pos.long()])
    dhi = torch.searchsorted(df, queries, right=True).to(torch.int32)
    dpsum = _edge_pad(delta_psum, df.shape[0] + 1)
    delta_hit = (dhi - dpos) > (dpsum[dhi.long()] - dpsum[dpos.long()])
    rank = (pos - base_psum[pos.long()]) + (dpos - dpsum[dpos.long()])
    return base_hit | delta_hit, rank, pos, dpos


def dynamic_find(queries, root, mat, vec, keys, base_psum, delta_keys,
                 delta_psum, **kw):
    """(found, rank) of :func:`dynamic_index_lookup`."""
    found, rank, _, _ = dynamic_index_lookup(queries, root, mat, vec, keys,
                                             base_psum, delta_keys,
                                             delta_psum, **kw)
    return found, rank


def range_lookup(q_lo, q_hi, root, mat, vec, keys, base_psum, delta_keys,
                 delta_psum, *, n_leaves: int, route_n: int, iters: int,
                 root_kind: str = "linear", leaf_kind: str = "linear",
                 seam_budget: int = 1024):
    """Two-tier range answer (K3 + epilogue): (rank_lo, rank_hi) live ranks
    of the inclusive ranges [q_lo, q_hi] -- rank_lo counts live keys <
    q_lo, rank_hi live keys <= q_hi, clamped to rank_lo so degenerate
    ranges come back empty."""
    df = _lookup.pad_delta(delta_keys)
    blo, bhi, dlo, dhi = _lookup.dynamic_range(
        q_lo, q_hi, root, mat, vec, keys, df, n_leaves=n_leaves,
        route_n=route_n, iters=iters, root_kind=root_kind,
        leaf_kind=leaf_kind)
    blo = _seam_fix(blo, keys, q_lo, seam_budget)
    bhi = _seam_fix(bhi, keys, q_hi, seam_budget, right=True)
    dpsum = _edge_pad(delta_psum, df.shape[0] + 1)
    rank_lo = (blo - base_psum[blo.long()]) + (dlo - dpsum[dlo.long()])
    rank_hi = (bhi - base_psum[bhi.long()]) + (dhi - dpsum[dhi.long()])
    return rank_lo, torch.maximum(rank_hi, rank_lo)
