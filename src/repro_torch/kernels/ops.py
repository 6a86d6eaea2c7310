"""Public wrappers around the kernels: each lookup kernel call followed by
its epilogue, the K7 distance matrix, the K6 histogram and the K5
least-squares fit (counterpart of ``repro.kernels.ops``).

The epilogues are plain torch ops: the seam verification that re-searches
the rare window misses, the tombstone hit test and the two-tier live-rank
arithmetic.  All inputs are f32 key space: ``keys``/``delta_keys`` the f32
copies of the tiers, queries converted to f32 by the caller.

Each epilogue is written once, over (S, n) stacks of tiers: the
shard-stacked forms (``sharded_*``) pass S indexes' tiers and each query's
shard id, the single-index forms their tiers as a stack of one row.  A
dense search (a seam miss, the end of a duplicate run) is confined to the
query's own row (:func:`_row_search`, a batched searchsorted of the rows),
since the flattened stack is not sorted across the +inf padding of its
rows.  The shard ids must lie in [0, S): they index the stacks.
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


# Every epilogue works on (S, n) stacks of tiers, each query tagged with its
# row ``rid``; a single index is the stack of one row, ``rid`` None.
def _row_search(stack, rid, qf, right=False):
    """Left boundaries of ``qf`` in row ``rid`` of the (S, n) ``stack``, or
    right ones (``right`` True, or a mask of the queries that ask for them):
    one batched ``torch.searchsorted`` of the rows, each given its own
    queries, laid out (S, m) with +inf padding (m the most queries a row
    has: one host read).  Positions within the row, int32; NaN past the
    row's end, where the reference's search places it."""
    S, n = stack.shape
    if rid is None:
        find = lambda side: torch.searchsorted(stack[0], qf, right=side)
    else:
        r = rid.long()
        order = torch.argsort(r, stable=True)
        rs = r[order]
        start = torch.searchsorted(rs, torch.arange(S, device=r.device))
        slot = torch.arange(r.shape[0], device=r.device) - start[rs]
        m = int(slot.max()) + 1 if r.numel() else 0
        vals = torch.full((S, m), torch.inf, dtype=stack.dtype,
                          device=stack.device)
        vals[rs, slot] = qf[order]

        def find(side):
            pos = torch.empty_like(r)
            pos[order] = torch.searchsorted(stack, vals, right=side)[rs, slot]
            return pos
    if isinstance(right, bool):
        pos = find(right)
    else:
        pos = torch.where(right, find(True), find(False))
    return torch.where(torch.isnan(qf), n, pos).to(torch.int32)


def _at(stack, rid, pos):
    """``stack[rid, pos]``."""
    p = pos.long()
    if rid is not None:
        p = p + rid.long() * stack.shape[1]
    return stack.reshape(-1)[p]


def _seam_fix(r, kf, rid, qf, right=None):
    """Seam verification in f32 key space, within each query's row of the
    (S, n) stack ``kf``.  Valid positions satisfy the left-boundary
    invariant kf[r-1] < q <= kf[r], or where the mask ``right`` is set the
    right-boundary one kf[r-1] <= q < kf[r]; the rest -- boundary queries
    outside their leaf's window, or sentinel windows deeper than the
    clamped depth -- are re-searched in their own row.  One host read of
    the miss count."""
    n = kf.shape[1]
    prev = _at(kf, rid, (r - 1).clamp(0, n - 1))
    cur = _at(kf, rid, r.clamp(0, n - 1))
    lo_ok, hi_ok = prev < qf, cur >= qf
    if right is not None:
        lo_ok = lo_ok | (right & (prev == qf))
        hi_ok = hi_ok & ~(right & (cur == qf))
    valid = ((r == 0) | lo_ok) & ((r == n) | hi_ok)
    bad = torch.nonzero(~valid).squeeze(1)
    SEAM["calls"] += 1
    SEAM["misses"] += bad.numel()
    if bad.numel() == 0:
        return r
    r = r.clone()
    r[bad] = _row_search(kf, None if rid is None else rid[bad], qf[bad],
                         False if right is None else right[bad])
    return r


def _run_end(stack, rid, qf, pos):
    """Right boundaries of ``qf`` in their rows from the exact left
    boundaries ``pos``; NaN past the row's end.  One row: a searchsorted of
    the batch.  A stack: one step past a member key, and a row search only
    for runs of two or more equal keys (one host read of their count, where
    a search of the whole batch would lay it out by row)."""
    if rid is None:
        return _row_search(stack, None, qf, right=True)
    n = stack.shape[1]
    hit = lambda p: (p < n) & (_at(stack, rid, p.clamp(max=n - 1)) == qf)
    r = pos + hit(pos).to(pos.dtype)
    runs = torch.nonzero(hit(r)).squeeze(1)
    if runs.numel():
        r[runs] = _row_search(stack, rid[runs], qf[runs], right=True)
    return torch.where(torch.isnan(qf), n, r)


def _two_tier_find(kf, bpsum, dkf, dpsum, rid, qf, pos, dpos):
    """(found, rank) of the exact left boundaries ``pos`` / ``dpos`` in the
    two tiers: ``found`` iff a live entry is in q's equal-key run of either
    tier, ``rank`` the live keys < q over both."""
    bhi = _run_end(kf, rid, qf, pos)
    dhi = _run_end(dkf, rid, qf, dpos)
    bp = lambda p: _at(bpsum, rid, p)
    dp = lambda p: _at(dpsum, rid, p)
    base_hit = (bhi - pos) > (bp(bhi) - bp(pos))
    delta_hit = (dhi - dpos) > (dp(dhi) - dp(dpos))
    return base_hit | delta_hit, (pos - bp(pos)) + (dpos - dp(dpos))


def _two_tier_range(kf, bpsum, dpsum, rid, q_lo, q_hi, blo, bhi, dlo, dhi):
    """(rank_lo, rank_hi) of K3's positions: the base ones seam-fixed in
    one pass over both ends (the delta probe ran at full depth), rank_hi
    clamped to rank_lo."""
    Q = q_lo.shape[0]
    q = torch.cat([q_lo, q_hi])
    b = _seam_fix(torch.cat([blo, bhi]), kf,
                  None if rid is None else torch.cat([rid, rid]), q,
                  torch.arange(2 * Q, device=q.device) >= Q)
    blo, bhi = b[:Q], b[Q:]
    bp = lambda p: _at(bpsum, rid, p)
    dp = lambda p: _at(dpsum, rid, p)
    rank_lo = (blo - bp(blo)) + (dlo - dp(dlo))
    rank_hi = (bhi - bp(bhi)) + (dhi - dp(dhi))
    return rank_lo, torch.maximum(rank_hi, rank_lo)


def index_lookup(queries, root, mat, vec, keys, *, n_leaves: int,
                 root_kind: str = "linear", leaf_kind: str = "linear",
                 iters: int | None = None, rows=None, fence=None):
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
    return _seam_fix(r, keys[None], None, queries)


def rmrt_lookup(queries, mat, vec, keys, *, fanout: int, depth: int,
                kind: str = "linear", iters: int | None = None,
                rows=None, fence=None):
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
    return _seam_fix(r, keys[None], None, queries)


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
                         leaf_kind: str = "linear", rows=None):
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
    pos = _seam_fix(pos, keys[None], None, queries)
    dpsum = _edge_pad(delta_psum, df.shape[0] + 1)
    found, rank = _two_tier_find(keys[None], base_psum[None], df[None],
                                 dpsum[None], None, queries, pos, dpos)
    return found, rank, pos, dpos


def dynamic_find(queries, root, mat, vec, keys, base_psum, delta_keys,
                 delta_psum, **kw):
    """(found, rank) of :func:`dynamic_index_lookup`."""
    found, rank, _, _ = dynamic_index_lookup(queries, root, mat, vec, keys,
                                             base_psum, delta_keys,
                                             delta_psum, **kw)
    return found, rank


def range_lookup(q_lo, q_hi, root, mat, vec, keys, base_psum, delta_keys,
                 delta_psum, *, n_leaves: int, route_n: int, iters: int,
                 root_kind: str = "linear", leaf_kind: str = "linear"):
    """Two-tier range answer (K3 + epilogue): (rank_lo, rank_hi) live ranks
    of the inclusive ranges [q_lo, q_hi] -- rank_lo counts live keys <
    q_lo, rank_hi live keys <= q_hi, clamped to rank_lo so degenerate
    ranges come back empty."""
    df = _lookup.pad_delta(delta_keys)
    pos = _lookup.dynamic_range(
        q_lo, q_hi, root, mat, vec, keys, df, n_leaves=n_leaves,
        route_n=route_n, iters=iters, root_kind=root_kind,
        leaf_kind=leaf_kind)
    dpsum = _edge_pad(delta_psum, df.shape[0] + 1)
    return _two_tier_range(keys[None], base_psum[None], dpsum[None], None,
                           q_lo, q_hi, *pos)


# ---------------------------------------------------------------------------
# Shard-stacked forms: the same epilogues, ``shard`` the row ids.
# ---------------------------------------------------------------------------
def sharded_index_lookup(queries, shard, roots, mats, vecs, keys, *,
                         n_leaves: int, iters: int, rows=None, fences=None,
                         tabs=None):
    """Shard-stacked static lookup (K1 + seam fix): the left boundary of
    each f32 query in its shard's row of the (S, n) f32 ``keys``."""
    r = _lookup.sharded_lookup(queries, shard, roots, mats, vecs, keys,
                               n_leaves=n_leaves, iters=iters, rows=rows,
                               fences=fences, tabs=tabs)
    return _seam_fix(r, keys, shard, queries)


def sharded_dynamic_find(queries, shard, roots, mats, vecs, keys, base_psum,
                         delta_keys, delta_psum, *, n_leaves: int,
                         route_n: int, iters: int, root_kind: str = "linear",
                         leaf_kind: str = "linear", rows=None, tabs=None):
    """Shard-stacked two-tier find (K2 + epilogue): (found, rank) of each
    query within its shard -- ``rank`` the shard's live keys < q.  The
    stacks: f32 ``keys`` (S, n) and ``delta_keys`` (S, nd) (nd a multiple
    of 128, +inf padded), tombstone prefix sums (S, n + 1) and
    (S, nd + 1)."""
    pos, dpos = _lookup.sharded_dynamic_lookup(
        queries, shard, roots, mats, vecs, keys, delta_keys,
        n_leaves=n_leaves, route_n=route_n, iters=iters,
        root_kind=root_kind, leaf_kind=leaf_kind, rows=rows, tabs=tabs)
    pos = _seam_fix(pos, keys, shard, queries)
    return _two_tier_find(keys, base_psum, delta_keys, delta_psum, shard,
                          queries, pos, dpos)


def sharded_range_lookup(q_lo, q_hi, shard, roots, mats, vecs, keys,
                         base_psum, delta_keys, delta_psum, *,
                         n_leaves: int, route_n: int, iters: int,
                         root_kind: str = "linear",
                         leaf_kind: str = "linear", tabs=None):
    """Shard-stacked two-tier range answer (K3 + epilogue): (rank_lo,
    rank_hi) within each pair's shard, rank_hi clamped to rank_lo."""
    pos = _lookup.sharded_dynamic_range(
        q_lo, q_hi, shard, roots, mats, vecs, keys, delta_keys,
        n_leaves=n_leaves, route_n=route_n, iters=iters,
        root_kind=root_kind, leaf_kind=leaf_kind, tabs=tabs)
    return _two_tier_range(keys, base_psum, delta_psum, shard, q_lo, q_hi,
                           *pos)
