"""searchsorted truths for the two-tier answers (counterpart of the
``dynamic_find_ref`` / ``dynamic_range_find_ref`` oracles of
``repro.kernels.ref``): the same f32 tombstone / live-rank algebra as
``ops``, with exact boundaries in place of the kernel positions."""
from __future__ import annotations

import torch

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
