"""K7: the batched Algorithm-2 histogram distance -- wrapper, plain PyTorch
version and launch counters (the CUDA kernels are ``csrc/ksdist.cu``).

    d[l, p] = max( max_k (A_S[p,k] - P_T[l,k]),  max_k (A_T[l,k] - P_S[p,k]) )

between L target histograms and a pool of P, with A = H + P the inclusive
and P the exclusive prefix tables.  The pool's tables come from
``core.reuse.pool_prefix_tables``; the targets' are computed here, by the
same prefix function (``core.cdf.prefix_sum``, XLA's order): on the card by
a table kernel, so that a call is two launches (tables, then distances)
with nothing computed on the host between them.  Subtraction and max are
exact, so kernel and plain version agree bit for bit with each other and
with the reference's ``ksdist_pallas`` / ``ksdist_ref``.
"""
from __future__ import annotations

import torch

from ..core.cdf import exclusive_prefix
from . import build

# "ksdist" counts distance launches, "ksdist_tables" target-table launches
LAUNCHES = {"ksdist": 0, "ksdist_tables": 0}

_PLAIN_ROWS = 512           # target rows per broadcast of the plain version


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def tables(tgt_hists: torch.Tensor):
    """The target tables (A_T, P_T) of ``target_tables``, bit for bit: on a
    CUDA tensor one launch of the table kernel (f32 or f64 histograms; any
    other type is cast to f32 first), else the plain version."""
    if tgt_hists.device.type != "cuda":
        return target_tables(tgt_hists)
    if tgt_hists.dim() != 2 or tgt_hists.shape[1] < 1:
        raise ValueError("tables takes (L, m) histograms with m >= 1")
    if tgt_hists.dtype not in (torch.float32, torch.float64):
        tgt_hists = tgt_hists.to(torch.float32)
    h = tgt_hists.contiguous()
    L, m = h.shape
    ta = torch.empty((L, m), dtype=torch.float32, device=h.device)
    pt = torch.empty((L, m), dtype=torch.float32, device=h.device)
    if L == 0:
        return ta, pt
    rc = build.library("ksdist").repro_ksdist_tables(
        h.data_ptr(), int(h.dtype == torch.float64), L, m, ta.data_ptr(),
        pt.data_ptr(), torch.cuda.current_stream(h.device).cuda_stream)
    build.check(rc, "ksdist_tables")
    LAUNCHES["ksdist_tables"] += 1
    return ta, pt


def distance(ta, pt, pool_a, pool_ps) -> torch.Tensor:
    """``distance_plain`` on prepared contiguous f32 tables: on CUDA
    tensors one launch of the distance kernel, else the plain version."""
    if ta.device.type != "cuda":
        return distance_plain(ta, pt, pool_a, pool_ps)
    for t in (ta, pt, pool_a, pool_ps):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError("distance takes contiguous float32 tables")
    L, m = ta.shape
    P = pool_a.shape[0]
    out = torch.empty((L, P), dtype=torch.float32, device=ta.device)
    if L == 0 or P == 0:
        return out
    rc = build.library("ksdist").repro_ksdist(
        ta.data_ptr(), pt.data_ptr(), L, pool_a.data_ptr(),
        pool_ps.data_ptr(), P, m, out.data_ptr(),
        torch.cuda.current_stream(ta.device).cuda_stream)
    build.check(rc, "ksdist")
    LAUNCHES["ksdist"] += 1
    return out


def ksdist(tgt_hists, pool_a, pool_ps) -> torch.Tensor:
    """K7 (replaces ``repro.kernels.ksdist.ksdist_pallas``): (L, P) f32
    Algorithm-2 distances of (L, m) target histograms against the pool's
    (P, m) f32 tables ``pool_a`` = H_S + P_S and ``pool_ps`` = P_S.  On the
    card two launches, the table kernel then the distance kernel (none
    when L or P is 0)."""
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
    if next(iter(devs)).type == "cuda" and (L == 0 or P == 0):
        return torch.empty((L, P), dtype=torch.float32,
                           device=tgt_hists.device)
    return distance(*tables(tgt_hists), pool_a, pool_ps)
