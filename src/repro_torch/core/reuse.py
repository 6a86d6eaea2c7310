"""Agile model reuse (paper Algorithm 1; counterpart of ``repro.core.reuse``).

The pool Q_MP is a stack of pre-trained models over synthetic datasets,
sorted by ascending error-bound width.  Algorithm 1 scans it in that order
for the first entry whose Algorithm-2 distance to the target is within
``1 - eps``; here the scan is one batched distance computation and a
masked argmin over ranks, which picks the same entry (the first eligible
entry in ascending-error order is the minimum-rank eligible entry).

For many targets at once (every RMI leaf, every RMRT level node) the
distances come from kernel K7 (``kernels.ksdist``) on CUDA tensors and
from its plain version on CPU tensors, chunked over targets so the (L, P)
matrix stays bounded.

The dtypes are the reference's: histograms f64, the selection tables and
distances f32 (``eps`` arrives as f32, so ``1 - eps`` is an f32 value, and
the guard ``_F32_GUARD`` is added in f32), the selected distance widened
to f64 at the end.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from . import cdf, models, synth
from .adapt import DomainSpec, adapt_linear, adapt_mlp, domain_of
from .bounds import reuse_err_bounds

_F32, _F64 = torch.float32, torch.float64
_I32_MAX = 2 ** 31 - 1

# Conservative slack added to the f32 distance so dist_h stays an upper
# bound of the exact KS distance despite the downcast (Eq. 3 safety).
_F32_GUARD = 1e-5
SELECT_CHUNK = 1 << 14      # targets per K7 launch in select_from_pool_batch


class PoolSelection(NamedTuple):
    found: torch.Tensor   # bool: any pool entry within 1 - eps?
    index: torch.Tensor   # int32: selected pool slot (min rank among eligible)
    dist: torch.Tensor    # f64: Algorithm-2 distance of the selected entry


def _threshold(eps) -> torch.Tensor:
    """``1 - eps`` computed in f32 from an f32 ``eps``."""
    return 1.0 - torch.tensor(np.float32(eps), dtype=_F32)


def _first_eligible(d: torch.Tensor, thr: torch.Tensor) -> PoolSelection:
    """Masked argmin over ranks along the last axis: the first entry with
    ``d <= thr`` (index 0 when none is eligible, as ``argmin`` of an
    all-max row gives)."""
    elig = d <= thr.to(d.device)
    P = d.shape[-1]
    rank = torch.arange(P, dtype=torch.int32, device=d.device)
    masked = torch.where(elig, rank, torch.full_like(rank, _I32_MAX))
    idx = masked.argmin(-1)
    return PoolSelection(found=elig.any(-1), index=idx.to(torch.int32),
                         dist=d.gather(-1, idx.unsqueeze(-1)).squeeze(-1)
                         .to(_F64))


def select_from_pool(pool_hists, err_width, target_hist, eps) -> PoolSelection:
    """Algorithm 1 selection with the f64 Algorithm-2 distances of
    ``core.cdf`` (``err_width`` is the pool's order and is not read)."""
    dists = cdf.hist_distance_pool(pool_hists, target_hist)
    return _first_eligible(dists, _threshold(eps))


def pool_prefix_tables(hists: torch.Tensor):
    """(sel_a, sel_ps) = (H_S + P_S, P_S) f32 tables of the pool."""
    h = hists.to(_F32)
    ps = cdf.exclusive_prefix(h)
    return (h + ps).contiguous(), ps.contiguous()


def select_from_pool_fused(sel_a, sel_ps, target_hist, eps) -> PoolSelection:
    """Selection for one target from the pool's f32 prefix tables."""
    sel = select_from_pool_batch(sel_a, sel_ps, target_hist[None, :], eps)
    return PoolSelection(*(a[0] for a in sel))


def select_from_pool_batch(sel_a, sel_ps, target_hists, eps) -> PoolSelection:
    """Selection for many targets (L, m): K7 distances ``SELECT_CHUNK``
    targets at a time, plus the guard, then the masked first-eligible
    argmin."""
    from ..kernels.ksdist import ksdist
    L = target_hists.shape[0]
    thr = _threshold(eps)
    parts = []
    for s in range(0, L, SELECT_CHUNK):
        d = ksdist(target_hists[s:s + SELECT_CHUNK], sel_a, sel_ps) \
            + _F32_GUARD
        parts.append(_first_eligible(d, thr))
        del d
    if not parts:
        dev = target_hists.device
        return PoolSelection(torch.zeros((0,), dtype=torch.bool, device=dev),
                             torch.zeros((0,), dtype=torch.int32, device=dev),
                             torch.zeros((0,), dtype=_F64, device=dev))
    return PoolSelection(*(torch.cat(a) for a in zip(*parts, strict=True)))


@dataclass
class AdaptedModel:
    """A model ready to index a target dataset (reused+adapted or fresh)."""
    kind: str
    params: models.LinearParams | models.MLPParams
    err_lo: torch.Tensor
    err_hi: torch.Tensor
    reused: bool
    dist: float

    def predict(self, keys: torch.Tensor) -> torch.Tensor:
        if self.kind == "linear":
            return models.linear_predict(self.params, keys)
        return models.mlp_predict(self.params, keys)


def _insert_row(stack: torch.Tensor, slot: int, item) -> torch.Tensor:
    item = torch.as_tensor(item, dtype=stack.dtype, device=stack.device)
    return torch.cat([stack[:slot], item[None], stack[slot:]])


@dataclass
class ModelPool:
    """Q_MP: stacked pre-trained models over synthetic datasets, sorted by
    ascending error-bound width; host-mutable (``enqueue``)."""
    eps: float
    m: int
    kind: str                       # "linear" | "mlp"
    hists: torch.Tensor             # (P, m) f64
    params: models.LinearParams | models.MLPParams   # stacked (P, ...)
    err_lo: torch.Tensor            # (P,) on the source (synthetic) data
    err_hi: torch.Tensor            # (P,)
    domains: DomainSpec             # stacked (P,) source domains
    sel_a: torch.Tensor | None = None   # (P, m) f32 H_S + P_S
    sel_ps: torch.Tensor | None = None  # (P, m) f32 P_S
    reuse_count: int = 0
    trained_count: int = 0
    # A replica (:meth:`replica`) names the pool it copies, and counts its
    # reuses and trainings there.
    primary: "ModelPool | None" = None
    _replicas: dict = field(default_factory=dict, repr=False)

    @property
    def size(self) -> int:
        return int(self.hists.shape[0])

    @property
    def owner(self) -> "ModelPool":
        """The pool that keeps the counts: the primary of a replica."""
        return self if self.primary is None else self.primary

    def replica(self, device) -> "ModelPool":
        """This pool on ``device``: itself when it lies there, else a copy
        of its tensors on ``device``, made once a device and kept (the
        reference replicates its pool over a mesh's devices; a sharded
        index's shards on another device read this copy).  A replica takes
        no ``enqueue``; an ``enqueue`` into the primary drops its replicas,
        so later ones copy the grown pool."""
        dev = torch.device(device)
        if dev == self.device:
            return self
        own = self.owner
        if dev not in own._replicas:
            if dev == own.device:
                return own
            # sync: ok(a pool copied once a device, kept in _replicas)
            mv = lambda t: None if t is None else t.to(dev)
            own._replicas[dev] = replace(
                own, hists=mv(own.hists),
                params=type(own.params)(*(mv(t) for t in own.params)),
                err_lo=mv(own.err_lo), err_hi=mv(own.err_hi),
                domains=DomainSpec(*(mv(t) for t in own.domains)),
                sel_a=mv(own.sel_a), sel_ps=mv(own.sel_ps), reuse_count=0,
                trained_count=0, primary=own, _replicas={})
        return own._replicas[dev]

    @property
    def device(self) -> torch.device:
        return self.hists.device

    def _refresh_tables(self) -> None:
        self.sel_a, self.sel_ps = pool_prefix_tables(self.hists)

    def tables(self):
        """(sel_a, sel_ps), built on first use."""
        if self.sel_a is None:
            self._refresh_tables()
        return self.sel_a, self.sel_ps

    # -- selection + adaptation ------------------------------------------
    def select(self, target_hist: torch.Tensor) -> PoolSelection:
        return select_from_pool_fused(*self.tables(), target_hist, self.eps)

    def adapt(self, sel: PoolSelection, tgt: DomainSpec, n_t,
              paper_bounds: bool = True,
              target_keys: torch.Tensor | None = None) -> AdaptedModel:
        """Adapt the selected pool model to the target domain (Lemma 3.2)
        with Theorem 3.3's bounds, or bounds measured on ``target_keys``."""
        i = sel.index.long()
        src = models.take_rows(self.domains, i)
        p = models.take_rows(self.params, i)
        adapted = (adapt_linear if self.kind == "linear" else adapt_mlp)(
            p, src, tgt)
        s_dy = (tgt.y_end - tgt.y_start) / (src.y_end - src.y_start)
        lo, hi = reuse_err_bounds(self.err_lo[i], self.err_hi[i], sel.dist,
                                  n_t, s_dy)
        if not paper_bounds or target_keys is not None:
            pred = (models.linear_predict if self.kind == "linear"
                    else models.mlp_predict)(adapted, target_keys)
            r = torch.arange(target_keys.shape[0], dtype=_F64,
                             device=target_keys.device) - pred
            lo, hi = r.min(), r.max()
        self.owner.reuse_count += 1
        return AdaptedModel(kind=self.kind, params=adapted, err_lo=lo,
                            err_hi=hi, reused=True, dist=float(sel.dist))

    # -- Algorithm 1 end to end ------------------------------------------
    def reuse_or_train(self, sorted_keys: torch.Tensor, *,
                       enqueue: bool = True, paper_bounds: bool = False,
                       train_steps: int = 400, seed: int = 0,
                       init: models.MLPParams | None = None) -> AdaptedModel:
        """Algorithm 1 for one sorted target dataset: reuse on a hit, else
        train fresh (from ``init``, or from ``seed``) and enqueue."""
        keys = sorted_keys.to(_F64)
        norm, lo_k, hi_k = cdf.normalize_keys(keys)
        th = cdf.histogram_sorted(norm, self.m, 0.0, 1.0)
        sel = self.select(th)
        tgt = domain_of(keys)
        n_t = torch.tensor(float(keys.shape[0]), dtype=_F64,
                           device=keys.device)
        if bool(sel.found):
            return self.adapt(sel, tgt, n_t, paper_bounds=paper_bounds,
                              target_keys=None if paper_bounds else keys)
        pos = torch.arange(keys.shape[0], dtype=_F64, device=keys.device)
        if self.kind == "linear":
            p = models.linear_fit(keys, pos)
            elo, ehi = models.linear_err_bounds(p, keys, pos)
        else:
            if init is None:
                g = torch.Generator(device=keys.device)
                g.manual_seed(seed)
                init = models.mlp_init(g)
            p = models.mlp_train(init, norm, pos, steps=train_steps)
            span = hi_k - lo_k
            p = models.MLPParams(w1=p.w1 / span, b1=p.b1 - p.w1 * lo_k / span,
                                 w2=p.w2, b2=p.b2)
            elo, ehi = models.mlp_err_bounds(p, keys, pos)
        self.owner.trained_count += 1
        fresh = AdaptedModel(kind=self.kind, params=p, err_lo=elo,
                             err_hi=ehi, reused=False, dist=0.0)
        if enqueue:
            self.enqueue(th, p, elo, ehi, tgt)
        return fresh

    def enqueue(self, hist, params, err_lo, err_hi, dom: DomainSpec) -> None:
        """Insert a freshly trained model, keeping ascending width order."""
        if self.primary is not None:
            raise ValueError("enqueue into the primary pool, not a replica")
        self._replicas = {}
        width = float(err_hi - err_lo)
        widths = (self.err_hi - self.err_lo).cpu().numpy()
        slot = int(np.searchsorted(widths, width))
        ins = lambda stack, item: _insert_row(stack, slot, item)
        self.hists = ins(self.hists, hist)
        self.params = type(self.params)(*(
            ins(s, i) for s, i in zip(self.params, params, strict=True)))
        self.err_lo = ins(self.err_lo, err_lo)
        self.err_hi = ins(self.err_hi, err_hi)
        self.domains = DomainSpec(*(
            ins(s, i) for s, i in zip(self.domains, dom, strict=True)))
        self._refresh_tables()


# ---------------------------------------------------------------------------
# Pool construction from the synthetic corpus.
# ---------------------------------------------------------------------------
def build_pool(sp: synth.SyntheticPool, kind: str = "mlp",
               train_steps: int = 400, seed: int = 0, m_sim: int = 64, *,
               device=None) -> ModelPool:
    """Pre-train the whole pool in one batched pass on ``device`` (CUDA
    unless ``device="cpu"``) and sort it by error width.  ``m_sim`` is the
    similarity-histogram resolution, decoupled from the generation grid.
    Synthetic keys live in [0, 1] with positions 0..ns-1."""
    dev = resolve_device(device)
    data = torch.as_tensor(sp.datasets, dtype=_F64, device=dev)
    P, ns = data.shape
    pos = torch.arange(ns, dtype=_F64, device=dev).expand(P, ns)
    if kind == "linear":
        params = models.linear_fit(data, pos)
        lo, hi = models.linear_err_bounds(params, data, pos)
    elif kind == "mlp":
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        params = models.train_pool(g, data, pos, steps=train_steps)
        lo, hi = models.mlp_err_bounds(params, data, pos)
    else:
        raise ValueError(kind)
    order = torch.argsort(hi - lo, stable=True)
    domains = DomainSpec(
        x_start=data[:, 0], x_end=data[:, -1],
        y_start=torch.zeros((P,), dtype=_F64, device=dev),
        y_end=torch.full((P,), float(ns - 1), dtype=_F64, device=dev))
    norm = (data - data[:, :1]) / (data[:, -1:] - data[:, :1])
    sim_hists = cdf.histogram_sorted(norm, m_sim, 0.0, 1.0)
    return ModelPool(
        eps=sp.eps, m=m_sim, kind=kind, hists=sim_hists[order],
        params=models.take_rows(params, order), err_lo=lo[order],
        err_hi=hi[order],
        domains=models.take_rows(domains, order))
