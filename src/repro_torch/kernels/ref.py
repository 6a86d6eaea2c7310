"""Oracles (counterpart of ``repro.kernels.ref``): searchsorted truths for
the two-tier answers -- the same f32 tombstone / live-rank algebra as
``ops``, with exact boundaries in place of the kernel positions -- and the
eager oracles of the K5 and K6 kernels."""
from __future__ import annotations

import torch

from ..core.cdf import ceil_to_bin
from . import lookup as _lookup
from .ops import _edge_pad


def dynamic_find_ref(queries, keys, base_psum, delta_keys, delta_psum):
    """Truth for ``ops.dynamic_find``'s (found, rank) on f32 tiers."""
    kf = keys.to(torch.float32)
    qf = queries.to(torch.float32)
    pos = torch.searchsorted(kf, qf).to(torch.int32)
    bhi = torch.searchsorted(kf, qf, right=True).to(torch.int32)
    base_hit = (bhi - pos) > (base_psum[bhi.long()] - base_psum[pos.long()])
    df = _lookup.pad_delta(delta_keys)
    dpos = torch.searchsorted(df, qf).to(torch.int32)
    dhi = torch.searchsorted(df, qf, right=True).to(torch.int32)
    dpsum = _edge_pad(delta_psum, df.shape[0] + 1)
    delta_hit = (dhi - dpos) > (dpsum[dhi.long()] - dpsum[dpos.long()])
    rank = (pos - base_psum[pos.long()]) + (dpos - dpsum[dpos.long()])
    return base_hit | delta_hit, rank


def dynamic_range_find_ref(q_lo, q_hi, keys, base_psum, delta_keys,
                           delta_psum):
    """Truth for ``ops.range_lookup``'s (rank_lo, rank_hi) on f32 tiers."""
    kf = keys.to(torch.float32)
    qlf = q_lo.to(torch.float32)
    qhf = q_hi.to(torch.float32)
    blo = torch.searchsorted(kf, qlf).to(torch.int32)
    bhi = torch.searchsorted(kf, qhf, right=True).to(torch.int32)
    df = _lookup.pad_delta(delta_keys)
    dlo = torch.searchsorted(df, qlf).to(torch.int32)
    dhi = torch.searchsorted(df, qhf, right=True).to(torch.int32)
    dpsum = _edge_pad(delta_psum, df.shape[0] + 1)
    rank_lo = (blo - base_psum[blo.long()]) + (dlo - dpsum[dlo.long()])
    rank_hi = (bhi - base_psum[bhi.long()]) + (dhi - dpsum[dhi.long()])
    return rank_lo, torch.maximum(rank_hi, rank_lo)


def hist_ref(keys, m: int, lo, hi):
    """The reference's oracle for K6 (``repro.kernels.ref.hist_ref``): f32,
    right-closed bins, dividing by the span and by n where the kernel
    multiplies by reciprocals."""
    k = keys.to(torch.float32)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=k.device)
    x = (k - f32(lo)) / (f32(hi) - f32(lo))
    b = ceil_to_bin(torch.ceil(x * f32(float(m))), m)
    counts = torch.zeros((m,), dtype=torch.float32, device=k.device)
    counts.index_add_(0, b, torch.ones_like(k))
    return counts / f32(float(keys.shape[0]))


def linfit_sums_ref(x, y, buckets, n_buckets: int):
    """The reference's oracle for K5 (``repro.kernels.ref.linfit_sums_ref``):
    f32 segment sums; out-of-range buckets drop."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    ok = (buckets >= 0) & (buckets < n_buckets)
    idx = torch.where(ok, buckets, n_buckets).long()
    out = torch.zeros((n_buckets + 1, 5), dtype=torch.float32,
                      device=x.device)
    out.index_add_(0, idx, torch.stack([torch.ones_like(x), x, y, x * y,
                                        x * x], 1))
    return out[:n_buckets]
