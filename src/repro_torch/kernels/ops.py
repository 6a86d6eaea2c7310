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

# Seam-fix accounting: stacks verified and window misses re-searched.  One
# verification step reads the miss counts of all its stacks to the host
# once.
SEAM = {"calls": 0, "misses": 0}


def reset_seam() -> None:
    SEAM["calls"] = 0
    SEAM["misses"] = 0


def _reads(ts: list) -> list:
    """Host values of the device scalars ``ts`` (perhaps on several
    devices): one host read for all of them."""
    if len(ts) == 1:
        # sync: ok(the one host read of a step's scalars, one of them)
        return [ts[0].item()]
    if not ts:
        return []
    dev = ts[0].device
    # sync: ok(the one host read of a step's scalars, all positions')
    return torch.stack([t.to(dev) for t in ts]).tolist()


# Every epilogue works on (S, n) stacks of tiers, each query tagged with its
# row ``rid``; a single index is the stack of one row, ``rid`` None.  The
# epilogues take a list of items, each a stack with its queries (the
# positions of a mesh, each on its own device), and read to the host once
# a step for all of them.
def _row_search(stack, rid, qf, right=False):
    """:func:`_row_searches` of one item."""
    return _row_searches([(stack, rid, qf, right)])[0]


def _row_searches(items: list) -> list:
    """Left boundaries of each item's ``qf`` in its rows ``rid`` of its
    (S, n) ``stack``, or right ones (``right`` True, or a mask of the
    queries that ask for them): one batched ``torch.searchsorted`` of an
    item's rows, each given its own queries, laid out (S, m) with +inf
    padding (m the most queries a row has: one host read for all items).
    Positions within the row, int32; NaN past the row's end, where the
    reference's search places it."""
    lays = []
    for stack, rid, _, _ in items:
        if rid is None or not rid.numel():
            lays.append(None)
            continue
        r = rid.long()
        order = torch.argsort(r, stable=True)
        rs = r[order]
        start = torch.searchsorted(
            rs, torch.arange(stack.shape[0], device=r.device))
        slot = torch.arange(r.shape[0], device=r.device) - start[rs]
        lays.append((r, order, rs, slot))
    widths = iter(_reads([lay[3].max() for lay in lays if lay is not None]))
    out = []
    for (stack, rid, qf, right), lay in zip(items, lays, strict=True):
        S, n = stack.shape
        if rid is None:
            find = lambda side, st=stack, q=qf: torch.searchsorted(
                st[0], q, right=side)
        elif lay is None:
            find = lambda side, r=rid: torch.empty_like(r, dtype=torch.int64)
        else:
            r, order, rs, slot = lay
            vals = torch.full((S, next(widths) + 1), torch.inf,
                              dtype=stack.dtype, device=stack.device)
            vals[rs, slot] = qf[order]

            def find(side, st=stack, vals=vals, r=r, order=order, rs=rs,
                     slot=slot):
                pos = torch.empty_like(r)
                pos[order] = torch.searchsorted(st, vals,
                                                right=side)[rs, slot]
                return pos
        if isinstance(right, bool):
            pos = find(right)
        else:
            pos = torch.where(right, find(True), find(False))
        out.append(torch.where(torch.isnan(qf), n, pos).to(torch.int32))
    return out


def _at(stack, rid, pos):
    """``stack[rid, pos]``."""
    p = pos.long()
    if rid is not None:
        p = p + rid.long() * stack.shape[1]
    return stack.reshape(-1)[p]


def _nonzeros(masks: list) -> list:
    """The set positions of each mask (None where it has none), the masks
    perhaps on several devices: one host read of all their counts (then a
    ``nonzero_static`` each, which reads nothing), or for a single mask
    the read of its own ``nonzero``."""
    if len(masks) == 1:
        # sync: ok(a single mask's own nonzero: the step's one read)
        nz = torch.nonzero(masks[0]).squeeze(1)
        return [nz if nz.numel() else None]
    counts = _reads([m.sum() for m in masks])
    return [torch.nonzero_static(m, size=c).squeeze(1) if c else None
            for m, c in zip(masks, counts, strict=True)]


def _seam_fix(items: list) -> list:
    """Seam verification in f32 key space of each item ``(r, kf, rid, qf,
    right)``: positions ``r`` of the queries ``qf``, each within its row
    ``rid`` of the (S, n) stack ``kf``.  Valid positions satisfy the
    left-boundary invariant kf[r-1] < q <= kf[r], or where the mask
    ``right`` (None: nowhere) is set the right-boundary one kf[r-1] <= q <
    kf[r]; the rest -- boundary queries outside their leaf's window, or
    sentinel windows deeper than the clamped depth -- are re-searched in
    their own row.  The items may lie on several devices (the positions of
    a mesh): one host read of all their miss counts, and one of the
    re-searches' layouts.  Returns the fixed positions of each item."""
    bads = []
    for r, kf, rid, qf, right in items:
        n = kf.shape[1]
        prev = _at(kf, rid, (r - 1).clamp(0, n - 1))
        cur = _at(kf, rid, r.clamp(0, n - 1))
        lo_ok, hi_ok = prev < qf, cur >= qf
        if right is not None:
            lo_ok = lo_ok | (right & (prev == qf))
            hi_ok = hi_ok & ~(right & (cur == qf))
        bads.append(~(((r == 0) | lo_ok) & ((r == n) | hi_ok)))
    fixes = []
    for i, bad in enumerate(_nonzeros(bads)):
        SEAM["calls"] += 1
        if bad is not None:
            SEAM["misses"] += bad.numel()
            fixes.append((i, bad))
    out = [r for r, *_ in items]
    found = _row_searches([
        (items[i][1], None if items[i][2] is None else items[i][2][bad],
         items[i][3][bad], False if items[i][4] is None else items[i][4][bad])
        for i, bad in fixes])
    for (i, bad), pos in zip(fixes, found, strict=True):
        out[i] = out[i].clone()
        out[i][bad] = pos
    return out


def _run_end(items: list) -> list:
    """Right boundaries of each item's queries ``(stack, rid, qf, pos)`` in
    their rows from the exact left boundaries ``pos``; NaN past the row's
    end.  One row (``rid`` None): a searchsorted of the batch.  A stack:
    one step past a member key, and a row search only for runs of two or
    more equal keys (one host read of their counts over all items, and one
    of the searches' layouts, where a search of the whole batch would lay
    it out by row)."""
    out = [None] * len(items)
    stacked, masks = [], []
    for i, (stack, rid, qf, pos) in enumerate(items):
        if rid is None:
            out[i] = _row_search(stack, None, qf, right=True)
            continue
        n = stack.shape[1]
        hit = lambda p: (p < n) & (_at(stack, rid, p.clamp(max=n - 1)) == qf)
        out[i] = pos + hit(pos).to(pos.dtype)
        stacked.append(i)
        masks.append(hit(out[i]))
    runs = [(i, nz) for i, nz in zip(stacked, _nonzeros(masks), strict=True)
            if nz is not None]
    found = _row_searches([(items[i][0], items[i][1][nz], items[i][2][nz],
                            True) for i, nz in runs])
    for (i, nz), p in zip(runs, found, strict=True):
        out[i][nz] = p
    for i in stacked:
        out[i] = torch.where(torch.isnan(items[i][2]), items[i][0].shape[1],
                             out[i])
    return out


def _two_tier_find(items: list) -> list:
    """(found, rank) of each item ``(kf, bpsum, dkf, dpsum, rid, qf, pos,
    dpos)``, from the exact left boundaries ``pos`` / ``dpos`` in the two
    tiers: ``found`` iff a live entry is in q's equal-key run of either
    tier, ``rank`` the live keys < q over both."""
    bhis = _run_end([(kf, rid, qf, pos)
                     for kf, _, _, _, rid, qf, pos, _ in items])
    dhis = _run_end([(dkf, rid, qf, dpos)
                     for _, _, dkf, _, rid, qf, _, dpos in items])
    out = []
    for (_, bpsum, _, dpsum, rid, _, pos, dpos), bhi, dhi in zip(
            items, bhis, dhis, strict=True):
        bp = lambda p: _at(bpsum, rid, p)
        dp = lambda p: _at(dpsum, rid, p)
        base_hit = (bhi - pos) > (bp(bhi) - bp(pos))
        delta_hit = (dhi - dpos) > (dp(dhi) - dp(dpos))
        out.append((base_hit | delta_hit,
                    (pos - bp(pos)) + (dpos - dp(dpos))))
    return out


def _two_tier_range(items: list) -> list:
    """(rank_lo, rank_hi) of each item ``(kf, bpsum, dpsum, rid, q_lo, q_hi,
    blo, bhi, dlo, dhi)`` of K3's positions: the base ones seam-fixed in
    one pass over both ends (the delta probe ran at full depth), rank_hi
    clamped to rank_lo."""
    fix = []
    for kf, _, _, rid, q_lo, q_hi, blo, bhi, _, _ in items:
        Q = q_lo.shape[0]
        fix.append((torch.cat([blo, bhi]), kf,
                    None if rid is None else torch.cat([rid, rid]),
                    torch.cat([q_lo, q_hi]),
                    torch.arange(2 * Q, device=q_lo.device) >= Q))
    out = []
    for (_, bpsum, dpsum, rid, q_lo, _, _, _, dlo, dhi), b in zip(
            items, _seam_fix(fix), strict=True):
        Q = q_lo.shape[0]
        blo, bhi = b[:Q], b[Q:]
        bp = lambda p: _at(bpsum, rid, p)
        dp = lambda p: _at(dpsum, rid, p)
        rank_lo = (blo - bp(blo)) + (dlo - dp(dlo))
        rank_hi = (bhi - bp(bhi)) + (dhi - dp(dhi))
        out.append((rank_lo, torch.maximum(rank_hi, rank_lo)))
    return out


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
    return _seam_fix([(r, keys[None], None, queries, None)])[0]


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
    return _seam_fix([(r, keys[None], None, queries, None)])[0]


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
    (pos,) = _seam_fix([(pos, keys[None], None, queries, None)])
    dpsum = _edge_pad(delta_psum, df.shape[0] + 1)
    ((found, rank),) = _two_tier_find([(keys[None], base_psum[None],
                                        df[None], dpsum[None], None, queries,
                                        pos, dpos)])
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
    return _two_tier_range([(keys[None], base_psum[None], dpsum[None], None,
                             q_lo, q_hi, *pos)])[0]


# ---------------------------------------------------------------------------
# Shard-stacked forms: the same epilogues, ``shard`` the row ids.  Each
# ``*_all`` form takes several calls -- ``(args, keywords)`` of its single
# form, each call's tensors on their own device (the positions of a mesh,
# ``core.distributed``) -- launches every call's kernel before the first
# host read, and then reads once a step of the epilogue for all of them.
# ---------------------------------------------------------------------------
def sharded_index_lookup(queries, shard, roots, mats, vecs, keys, *,
                         n_leaves: int, iters: int, rows=None, fences=None,
                         tabs=None):
    """Shard-stacked static lookup (K1 + seam fix): the left boundary of
    each f32 query in its shard's row of the (S, n) f32 ``keys``."""
    return sharded_index_lookup_all([(
        (queries, shard, roots, mats, vecs, keys),
        dict(n_leaves=n_leaves, iters=iters, rows=rows, fences=fences,
             tabs=tabs))])[0]


def sharded_index_lookup_all(calls: list) -> list:
    """:func:`sharded_index_lookup` of each call."""
    rs = [_lookup.sharded_lookup(*a, **kw) for a, kw in calls]
    return _seam_fix([(r, a[5], a[1], a[0], None)
                      for r, (a, _) in zip(rs, calls, strict=True)])


def sharded_dynamic_find(queries, shard, roots, mats, vecs, keys, base_psum,
                         delta_keys, delta_psum, *, n_leaves: int,
                         route_n: int, iters: int, root_kind: str = "linear",
                         leaf_kind: str = "linear", rows=None, tabs=None):
    """Shard-stacked two-tier find (K2 + epilogue): (found, rank) of each
    query within its shard -- ``rank`` the shard's live keys < q.  The
    stacks: f32 ``keys`` (S, n) and ``delta_keys`` (S, nd) (nd a multiple
    of 128, +inf padded), tombstone prefix sums (S, n + 1) and
    (S, nd + 1)."""
    return sharded_dynamic_find_all([(
        (queries, shard, roots, mats, vecs, keys, base_psum, delta_keys,
         delta_psum),
        dict(n_leaves=n_leaves, route_n=route_n, iters=iters,
             root_kind=root_kind, leaf_kind=leaf_kind, rows=rows,
             tabs=tabs))])[0]


def sharded_dynamic_find_all(calls: list) -> list:
    """:func:`sharded_dynamic_find` of each call."""
    pos = []
    for (q, shard, roots, mats, vecs, keys, _, dkeys, _), kw in calls:
        pos.append(_lookup.sharded_dynamic_lookup(
            q, shard, roots, mats, vecs, keys, dkeys, **kw))
    fixed = _seam_fix([(p, a[5], a[1], a[0], None)
                       for (p, _), (a, _) in zip(pos, calls, strict=True)])
    return _two_tier_find([
        (keys, bpsum, dkeys, dpsum, shard, q, p, dp)
        for ((q, shard, _, _, _, keys, bpsum, dkeys, dpsum), _), p, (_, dp)
        in zip(calls, fixed, pos, strict=True)])


def sharded_range_lookup(q_lo, q_hi, shard, roots, mats, vecs, keys,
                         base_psum, delta_keys, delta_psum, *,
                         n_leaves: int, route_n: int, iters: int,
                         root_kind: str = "linear",
                         leaf_kind: str = "linear", tabs=None):
    """Shard-stacked two-tier range answer (K3 + epilogue): (rank_lo,
    rank_hi) within each pair's shard, rank_hi clamped to rank_lo."""
    return sharded_range_lookup_all([(
        (q_lo, q_hi, shard, roots, mats, vecs, keys, base_psum, delta_keys,
         delta_psum),
        dict(n_leaves=n_leaves, route_n=route_n, iters=iters,
             root_kind=root_kind, leaf_kind=leaf_kind, tabs=tabs))])[0]


def sharded_range_lookup_all(calls: list) -> list:
    """:func:`sharded_range_lookup` of each call."""
    pos = []
    for (q_lo, q_hi, shard, roots, mats, vecs, keys, _, dkeys, _), kw \
            in calls:
        pos.append(_lookup.sharded_dynamic_range(
            q_lo, q_hi, shard, roots, mats, vecs, keys, dkeys, **kw))
    return _two_tier_range([
        (keys, bpsum, dpsum, shard, q_lo, q_hi, *p)
        for ((q_lo, q_hi, shard, _, _, _, keys, bpsum, _, dpsum), _), p
        in zip(calls, pos, strict=True)])
