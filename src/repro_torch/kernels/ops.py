"""Serving wrappers around the kernels: each lookup kernel call followed by
its epilogue, and the K7 distance matrix (counterpart of
``repro.kernels.ops``).

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
                 iters: int | None = None, seam_budget: int = 1024):
    """Static serving lookup (K1 + seam fix): left boundaries of f32
    ``queries`` in the f32 ``keys``.  ``iters`` None derives the clamped
    depth from the bound rows of ``vec``."""
    if iters is None:
        iters = _lookup.search_iters(vec[1, :n_leaves], vec[2, :n_leaves],
                                     keys.shape[0])
    r = _lookup.lookup(queries, root, mat, vec, keys, n_leaves=n_leaves,
                       iters=iters, root_kind=root_kind, leaf_kind=leaf_kind)
    return _seam_fix(r, keys, queries, seam_budget)


def rmrt_lookup(queries, mat, vec, keys, *, fanout: int, depth: int,
                kind: str = "linear", iters: int | None = None,
                seam_budget: int = 1024):
    """RMRT serving lookup (K4 + seam fix) over ``pack_rmrt`` tables.
    ``iters`` None derives the clamped depth from the bound rows of
    ``vec`` (internal nodes carry zero-width rows; sentinel windows of
    empty leaves are excluded, as for the RMI)."""
    if iters is None:
        iters = _lookup.search_iters(vec[1], vec[2], keys.shape[0])
    r = _lookup.rmrt_lookup(queries, mat, vec, keys, fanout=fanout,
                            depth=depth, kind=kind, iters=iters)
    return _seam_fix(r, keys, queries, seam_budget)


def ksdist_matrix(tgt_hists, pool_a, pool_ps):
    """(L, P) Algorithm-2 distance matrix, targets x pool (K7)."""
    from .ksdist import ksdist
    return ksdist(tgt_hists, pool_a, pool_ps)


def _edge_pad(psum, n: int):
    """Pad a prefix-sum vector to length ``n`` by repeating its last entry."""
    extra = n - psum.shape[0]
    if extra <= 0:
        return psum
    return torch.cat([psum, psum[-1:].expand(extra)])


def dynamic_index_lookup(queries, root, mat, vec, keys, base_psum,
                         delta_keys, delta_psum, *, n_leaves: int,
                         route_n: int, iters: int, root_kind: str = "linear",
                         leaf_kind: str = "linear", seam_budget: int = 1024):
    """Two-tier serving find: K2, then the seam fix of the base positions
    and the tombstone / live-rank algebra.  ``delta_keys`` is the sorted
    +inf-padded f32 delta tier; ``*_psum`` the exclusive tombstone prefix
    sums (length n + 1).  Returns (found, rank, base_pos, delta_pos):
    ``found`` iff a live copy of q is in either tier, ``rank`` the live
    keys < q over both tiers."""
    df = _lookup.pad_delta(delta_keys)
    pos, dpos = _lookup.dynamic_lookup(queries, root, mat, vec, keys, df,
                                       n_leaves=n_leaves, route_n=route_n,
                                       iters=iters, root_kind=root_kind,
                                       leaf_kind=leaf_kind)
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
