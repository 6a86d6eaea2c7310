"""Online drift monitoring and bound-checked pool hot-swaps (counterpart of
``repro.core.drift``): the paper's reuse (Algorithms 1 and 2) as a feature
of serving time.

Drift score.  A :class:`DriftState` rides on a ``DynamicRMI``: two raw-count
histograms over the build-time key domain [lo, hi] at resolution m --
``ref``, the accepted baseline (the build-time keys, later re-baselined
when ``flush_delta`` merges every buffered insert: ``ref += acc; acc = 0;
score = 0``), and ``acc``, every key inserted since (deletes are not
subtracted, as in the reference).  The score is the binned two-sample KS
statistic, the largest gap between the normalised CDFs of ``ref`` and
``ref + acc`` at the bin edges: zero at stationarity, monotone in the
shift and in the drifted mass.  Keys outside [lo, hi] clip into the edge
bins; non-finite keys drop.  Score and latch stay on the index's device.

Hysteresis.  ``drifted`` is a latch: it sets when the score exceeds
``thresh_hi``, clears when it falls below ``thresh_lo``, holds in between,
and clears on re-baseline.

Swap commit.  :func:`swap_leaves` is one pass over the (power-of-two
padded) leaf rows: the leaves' current histograms over both tiers
(searchsorted range counts), pool selection (``select_from_pool_batch``,
kernel K7 on a card), Lemma 3.2 adaptation, residual bounds of the
candidate models measured over the base tier, Lemma 4.1 budgets, and a
masked row write that commits a leaf only where the pool had an eligible
model, the fresh budget covers the inserts already buffered on the leaf,
and the new window fits under the current width cap -- so table contents
change, their shapes and the search depth do not.  The residual pass runs
over the whole base tier, as the reference's does: O(n) per call.

Numerics kept from the reference: the drift bins use XLA's integer
semantics (saturating conversion, wrapping ``- 1``: a finite key so far
below lo that the conversion saturates lands in the last bin); the two
prefix sums of the score run in XLA's cumsum order (``cdf.prefix_sum``),
since one ulp can flip the latch; the swap pass's bin edges are the fused
multiply-add XLA makes of them (``cdf.bin_edges``).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from . import models
from . import rmi as rmi_mod
from .adapt import DomainSpec, adapt_linear, adapt_mlp
from .bounds import insertion_budget
from .cdf import bin_edges, ceil_to_bin, prefix_sum
from .reuse import select_from_pool_batch

_F64 = torch.float64
_I32 = torch.int32
_TINY = torch.finfo(_F64).tiny


@dataclass
class DriftState:
    """One index's online drift monitor (module docstring)."""
    m: int                  # histogram resolution
    lo: float               # build-time key domain (host scalars)
    hi: float
    thresh_hi: float        # the latch sets above this score
    thresh_lo: float        # and clears below this one
    ref: torch.Tensor       # (m,) f64 raw counts: the accepted baseline
    acc: torch.Tensor       # (m,) f64 raw counts since the last rebaseline
    score: torch.Tensor     # () f64 KS score, on the device
    drifted: torch.Tensor   # () bool latch, on the device
    updates: int = 0        # batches accumulated
    rebaselines: int = 0    # merge events absorbed


def _raw_hist(keys: torch.Tensor, lo: float, hi: float, m: int):
    """(m,) f64 raw counts of ``keys`` in right-closed bins of [lo, hi];
    non-finite keys drop.  Counts are exact integers, so ``bincount``
    gives the reference's scatter-add without contending on a hot bin."""
    span = max(hi - lo, _TINY)
    b = ceil_to_bin(torch.ceil((keys - lo) / span * m), m)
    b = torch.where(torch.isfinite(keys), b, m)
    return torch.bincount(b, minlength=m + 1)[:m].to(_F64)


def _accumulate(state: DriftState, batch: torch.Tensor):
    """Fold one batch into ``acc`` and refresh (score, latch) on the
    device; nothing is read back."""
    acc = state.acc + _raw_hist(batch, state.lo, state.hi, state.m)
    ref_n = state.ref / state.ref.sum().clamp(min=1.0)
    cur = state.ref + acc
    cur_n = cur / cur.sum().clamp(min=1.0)
    score = (prefix_sum(ref_n) - prefix_sum(cur_n)).abs().max()
    drifted = (score > state.thresh_hi) | (
        (score >= state.thresh_lo) & state.drifted)
    return acc, score, drifted


def init_drift(sorted_keys: torch.Tensor, m: int = 64,
               thresh_hi: float = 0.15, thresh_lo: float = 0.05
               ) -> DriftState:
    """A monitor baselined on the build-time keys (on their device; the
    domain is read to the host once)."""
    if thresh_lo >= thresh_hi:
        raise ValueError("hysteresis needs thresh_lo < thresh_hi, got "
                         f"[{thresh_lo}, {thresh_hi}]")
    keys = sorted_keys.to(_F64)
    dev = keys.device
    if keys.shape[0] == 0:
        lo, hi = 0.0, 1.0
        ref = torch.zeros((m,), dtype=_F64, device=dev)
    else:
        lo, hi = float(keys[0]), float(keys[-1])
        if hi <= lo:
            hi = lo + 1.0
        ref = _raw_hist(keys, lo, hi, m)
    return DriftState(m=m, lo=lo, hi=hi, thresh_hi=thresh_hi,
                      thresh_lo=thresh_lo, ref=ref,
                      acc=torch.zeros((m,), dtype=_F64, device=dev),
                      score=torch.zeros((), dtype=_F64, device=dev),
                      drifted=torch.zeros((), dtype=torch.bool, device=dev))


def update_drift(state: DriftState, batch: torch.Tensor) -> DriftState:
    """Accumulate one insert batch (on the device, no host read)."""
    acc, score, drifted = _accumulate(state, batch.to(_F64))
    return replace(state, acc=acc, score=score, drifted=drifted,
                   updates=state.updates + 1)


def rebaseline(state: DriftState) -> DriftState:
    """Absorb ``acc`` into the baseline after a full merge: the models were
    just refitted on the merged data, so score and latch reset."""
    return replace(state, ref=state.ref + state.acc,
                   acc=torch.zeros_like(state.acc),
                   score=torch.zeros_like(state.score),
                   drifted=torch.zeros_like(state.drifted),
                   rebaselines=state.rebaselines + 1)


def state_row(state: DriftState | None, device=None) -> torch.Tensor:
    """(2,) f64 [score, drifted]; zeros without a monitor."""
    if state is None:
        return torch.zeros((2,), dtype=_F64, device=device)
    return torch.stack([state.score, state.drifted.to(_F64)])


# ---------------------------------------------------------------------------
# The swap pass.
# ---------------------------------------------------------------------------
def _range_counts(tier, edges, s, e):
    """(R, m) bin populations of the sorted run [s, e) of ``tier`` per row,
    split at the row's interior ``edges`` (right-closed)."""
    pos = torch.searchsorted(tier, edges.reshape(-1), right=True) \
        .reshape(edges.shape).to(_I32)
    pos = torch.minimum(torch.maximum(pos, s[:, None]), e[:, None])
    bounds = torch.cat([s[:, None], pos, e[:, None]], 1)
    return (bounds[:, 1:] - bounds[:, :-1]).to(_F64)


def _set_rows(full, rid, rows):
    """A copy of ``full`` with rows ``rid`` replaced (duplicate ids write
    identical values)."""
    out = full.clone()
    out[rid] = rows
    return out


def swap_leaves(base_keys, buckets, dk, dleaf, rid_p, leaves, err_lo, err_hi,
                leaf_sim, reused_mask, sel_a, sel_ps, p_params, p_domains,
                n_ins, win_cap: float, eps: float, *, leaf_kind: str, m: int,
                n_leaves: int):
    """One Algorithm-1 swap attempt for the leaf rows ``rid_p``
    (power-of-two padded by repeating a real id): current histograms over
    both sorted tiers -> pool selection -> Lemma 3.2 adaptation -> bounds
    measured over the base tier -> Lemma 4.1 budgets -> masked row commit.
    Needs a monotone (linear) root, so every leaf's keys are one
    searchsorted run of each tier.

    Returns the committed full tables and per-row diagnostics ``(leaves,
    err_lo, err_hi, sim, reused, commit, budget, width, dist)``; rows whose
    check fails keep their old values."""
    n, nd = base_keys.shape[0], dk.shape[0]
    rid = rid_p.to(_I32)
    bs = torch.searchsorted(buckets, rid).to(_I32)
    be = torch.searchsorted(buckets, rid, right=True).to(_I32)
    # Under the monotone root the routed-leaf table of the sorted delta
    # tier is non-decreasing; its -1 pads map past every leaf.
    dl = torch.where(dleaf >= 0, dleaf, n_leaves).to(_I32)
    ds = torch.searchsorted(dl, rid).to(_I32)
    de = torch.searchsorted(dl, rid, right=True).to(_I32)
    bcnt = (be - bs).to(_F64)
    dcnt = (de - ds).to(_F64)

    inf = torch.full(bcnt.shape, torch.inf, dtype=_F64, device=bcnt.device)
    at = lambda t, i, size: t[i.clamp(0, max(size - 1, 0)).long()]
    bk_lo = torch.where(bcnt > 0, at(base_keys, bs, n), inf)
    bk_hi = torch.where(bcnt > 0, at(base_keys, be - 1, n), -inf)
    dk_lo = torch.where(dcnt > 0, at(dk, ds, nd), inf)
    dk_hi = torch.where(dcnt > 0, at(dk, de - 1, nd), -inf)
    empty = (bcnt + dcnt) == 0
    kmin = torch.where(empty, 0.0, torch.minimum(bk_lo, dk_lo))
    kmax = torch.where(empty, 1.0, torch.maximum(bk_hi, dk_hi))
    span = (kmax - kmin).clamp(min=_TINY)

    edges = bin_edges(kmin, span, m)
    counts = _range_counts(base_keys, edges, bs, be) \
        + _range_counts(dk, edges, ds, de)
    hists = counts / counts.sum(1, keepdim=True).clamp(min=1.0)
    sel = select_from_pool_batch(sel_a, sel_ps, hists, eps)

    # Lemma 3.2 onto (the leaf's key span over both tiers -> its base
    # positions): a swapped model indexes the base tier only.
    pmin = bs.to(_F64)
    pmax = torch.maximum((be - 1).to(_F64), pmin)
    tgt = DomainSpec(x_start=kmin,
                     x_end=torch.where(kmax > kmin, kmax, kmin + 1.0),
                     y_start=pmin, y_end=torch.maximum(pmax, pmin + 1.0))
    idx = sel.index.long()
    adapt = adapt_linear if leaf_kind == "linear" else adapt_mlp
    cand_rows = adapt(models.take_rows(p_params, idx),
                      models.take_rows(p_domains, idx), tgt)

    # Bounds of the candidate tables over the base tier (capacity pads are
    # in the dump bucket and drop out).
    rl = rid.long()
    cand = type(leaves)(*(_set_rows(f, rl, r)
                          for f, r in zip(leaves, cand_rows, strict=True)))
    pred = rmi_mod._leaf_predict_all(leaf_kind, cand, base_keys, buckets)
    lo_all, hi_all = rmi_mod.segment_residual_bounds_sorted(pred, buckets,
                                                            n_leaves)
    del pred, cand
    nlo, nhi = lo_all[rl], hi_all[rl]
    new_w = torch.ceil(nhi) - torch.floor(nlo) + 3.0   # bounds.window_widths
    sim = 1.0 - sel.dist
    new_budget = insertion_budget(sim, eps, bcnt)

    commit = (sel.found & (bcnt > 1.0) & (new_budget >= n_ins)
              & (new_w <= win_cap))
    keep = lambda new, old: torch.where(
        commit.reshape(commit.shape + (1,) * (new.dim() - 1)), new, old)
    out_leaves = type(leaves)(*(
        _set_rows(f, rl, keep(r, f[rl]))
        for f, r in zip(leaves, cand_rows, strict=True)))
    out_lo = _set_rows(err_lo, rl, torch.where(commit, nlo, err_lo[rl]))
    out_hi = _set_rows(err_hi, rl, torch.where(commit, nhi, err_hi[rl]))
    out_sim = _set_rows(leaf_sim, rl, torch.where(commit, sim, leaf_sim[rl]))
    out_reused = _set_rows(reused_mask, rl, commit | reused_mask[rl])
    return (out_leaves, out_lo, out_hi, out_sim, out_reused, commit,
            new_budget, new_w, sel.dist)
