"""K7: the batched Algorithm-2 histogram distance -- wrapper, plain PyTorch
version and launch counter (the CUDA kernel is ``csrc/ksdist.cu``).

    d[l, p] = max( max_k (A_S[p,k] - P_T[l,k]),  max_k (A_T[l,k] - P_S[p,k]) )

between L target histograms and a pool of P, with A = H + P the inclusive
and P the exclusive prefix tables.  The pool's tables come from
``core.reuse.pool_prefix_tables``; the targets' are computed here, by the
same prefix function (``core.cdf.prefix_sum``, XLA's order).  Subtraction
and max are exact, so kernel and plain version agree bit for bit with each
other and with the reference's ``ksdist_pallas`` / ``ksdist_ref``.
"""
from __future__ import annotations

import torch

from ..core.cdf import exclusive_prefix
from . import build

LAUNCHES = {"ksdist": 0}

_PLAIN_ROWS = 512           # target rows per broadcast of the plain version
_KERNEL_ROWS = 1 << 22      # grid.y limit of the kernel (65535 tiles of 64)


def reset_launches() -> None:
    LAUNCHES["ksdist"] = 0


def target_tables(tgt_hists: torch.Tensor):
    """(A_T, P_T) f32 tables of (L, m) target histograms."""
    ht = tgt_hists.to(torch.float32)
    pt = exclusive_prefix(ht)
    return ht + pt, pt


def distance_plain(ta, pt, pool_a, pool_ps) -> torch.Tensor:
    """Plain version of the kernel on prepared tables, (L, P) f32;
    ``_PLAIN_ROWS`` target rows at a time so the (rows, P, m) broadcast
    stays bounded."""
    L, P = ta.shape[0], pool_a.shape[0]
    out = torch.empty((L, P), dtype=torch.float32, device=ta.device)
    for s in range(0, L, _PLAIN_ROWS):
        e = min(s + _PLAIN_ROWS, L)
        up = (pool_a[None] - pt[s:e, None, :]).amax(2)
        dn = (ta[s:e, None, :] - pool_ps[None]).amax(2)
        out[s:e] = torch.maximum(up, dn)
    return out


def ksdist_plain(tgt_hists, pool_a, pool_ps) -> torch.Tensor:
    """Plain version of K7: (L, P) f32 distances."""
    ta, pt = target_tables(tgt_hists)
    return distance_plain(ta, pt, pool_a, pool_ps)


def ksdist(tgt_hists, pool_a, pool_ps) -> torch.Tensor:
    """K7 (replaces ``repro.kernels.ksdist.ksdist_pallas``): (L, P) f32
    Algorithm-2 distances of (L, m) target histograms against the pool's
    (P, m) f32 tables ``pool_a`` = H_S + P_S and ``pool_ps`` = P_S."""
    devs = {t.device for t in (tgt_hists, pool_a, pool_ps)}
    if len(devs) != 1:
        raise ValueError(f"ksdist inputs on several devices: {devs}")
    if tgt_hists.dim() != 2 or pool_a.dim() != 2 \
            or pool_a.shape != pool_ps.shape \
            or tgt_hists.shape[1] != pool_a.shape[1]:
        raise ValueError("ksdist takes (L, m) targets and (P, m) pool tables")
    for name, t in (("pool_a", pool_a), ("pool_ps", pool_ps)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"{name} must be contiguous float32")
    L, m = tgt_hists.shape
    P = pool_a.shape[0]
    if m < 1:
        raise ValueError("histograms need at least one bin")
    ta, pt = target_tables(tgt_hists)
    if next(iter(devs)).type != "cuda":
        return distance_plain(ta, pt, pool_a, pool_ps)
    ta, pt = ta.contiguous(), pt.contiguous()
    out = torch.empty((L, P), dtype=torch.float32, device=ta.device)
    if L == 0 or P == 0:
        return out
    lib = build.library("ksdist")
    stream = torch.cuda.current_stream(ta.device).cuda_stream
    for s in range(0, L, _KERNEL_ROWS):
        e = min(s + _KERNEL_ROWS, L)
        rc = lib.repro_ksdist(ta[s:e].data_ptr(), pt[s:e].data_ptr(), e - s,
                              pool_a.data_ptr(), pool_ps.data_ptr(), P, m,
                              out[s:e].data_ptr(), stream)
        build.check(rc, "ksdist")
        LAUNCHES["ksdist"] += 1
    return out
