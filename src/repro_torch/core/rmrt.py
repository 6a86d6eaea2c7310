"""Recursive Model Reuse Tree (RMRT, paper §3; counterpart of
``repro.core.rmrt``).

A node holding more than N keys (``leaf_cap``) trains a model that
partitions its keys into B children (``fanout``), with agile model reuse
whenever a model is needed; a partition of at most N keys becomes a leaf
indexed by a reused or fresh model.  The tree is unbalanced by
construction -- dense regions get more levels -- which is the paper's
answer to skew.

The tree is built level-synchronously: every node of a level goes through
the batched machinery of the RMI layer (segment statistics, similarity
histograms, one pool selection for all nodes through kernel K7), and the
tree is stored as flat per-node arrays (child_base, is_leaf, bounds).
Each level after the first is padded to a power of two of internal nodes
times ``fanout`` slots, and keys that already settled into a finished leaf
are parked in one dummy tail slot.  Lookup is a fixed-depth masked descent
(kernel K4 on the kernel path).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from . import models
from .adapt import DomainSpec, adapt_linear, adapt_mlp
from .bounds import reuse_err_bounds
from .paths import resolve_path
from .reuse import ModelPool, select_from_pool_batch
from .rmi import (_batched_leaf_mlp, _leaf_predict_all, leaf_histograms,
                  leaf_stats, segment_linear_fit, segment_residual_bounds,
                  verified_search)

_F64 = torch.float64


@dataclass
class RMRTIndex:
    keys: torch.Tensor           # (n,) sorted f64
    kind: str                    # node model kind: "linear" | "mlp"
    params: models.LinearParams | models.MLPParams   # stacked (num_nodes, ...)
    is_leaf: torch.Tensor        # (num_nodes,) bool
    child_base: torch.Tensor     # (num_nodes,) int32: flat index of child 0
    y_start: torch.Tensor        # (num_nodes,) f64: position range for
    y_end: torch.Tensor          #   re-bucketing
    err_lo: torch.Tensor         # (num_nodes,) leaf bounds (0 for internal)
    err_hi: torch.Tensor
    node_sim: torch.Tensor       # (num_nodes,) build-time similarity
    reused_mask: torch.Tensor    # (num_nodes,) bool
    fanout: int
    leaf_cap: int
    depth: int
    _iters: int | None = None        # cached error-window search depth
    _packed: tuple | None = None     # ((mat, vec), node rows) kernel tables
    _f32_exact: bool | None = None   # keys round-trip through f32
    _kf32: tuple | None = None       # (f32 copy of keys, its key fence)

    @property
    def n(self) -> int:
        return int(self.keys.shape[0])

    @property
    def device(self) -> torch.device:
        return self.keys.device

    @property
    def search_iters(self) -> int:
        """Static search depth bounded by the widest live leaf window (§4)."""
        if self._iters is None:
            from ..kernels.lookup import search_iters
            self._iters = search_iters(self.err_lo, self.err_hi, self.n)
        return self._iters

    @property
    def num_nodes(self) -> int:
        return int(self.is_leaf.shape[0])

    @property
    def reuse_fraction(self) -> float:
        """Share of models taken from the pool (a mean as XLA computes it:
        the count times the reciprocal of the length)."""
        m = self.reused_mask
        return float(m.sum()) * (1.0 / max(m.shape[0], 1))

    def _key_space(self) -> tuple:
        if self._kf32 is None:
            from ..kernels.lookup import key_fence
            # tracelint: ok[f32-cast](the copy f32_exact compares)
            kf = self.keys.to(torch.float32)
            self._kf32 = (kf, key_fence(kf))
        return self._kf32

    @property
    def keys_f32(self) -> torch.Tensor:
        """The keys in the kernel's f32 key space (cached)."""
        return self._key_space()[0]

    @property
    def key_fence(self) -> torch.Tensor:
        """Every 64th key of ``keys_f32``, cached with it: the fence K4
        searches first (``kernels.lookup.key_fence``)."""
        return self._key_space()[1]

    @property
    def f32_exact(self) -> bool:
        """True when every key round-trips through f32 (kernel path
        precondition, as for ``RMIIndex``)."""
        if self._f32_exact is None:
            self._f32_exact = bool(
                (self.keys_f32.to(_F64) == self.keys).all())
        return self._f32_exact

    def _pack(self) -> tuple:
        if self._packed is None:
            from ..kernels.lookup import node_rows, pack_rmrt
            mat, vec = pack_rmrt(
                self.kind, self.params, self.is_leaf, self.child_base,
                self.y_start, self.y_end, self.err_lo, self.err_hi)
            self._packed = ((mat, vec), node_rows(mat, vec, self.kind))
        return self._packed

    def packed_tables(self) -> tuple:
        """(mat, vec) node tables for kernel K4."""
        return self._pack()[0]

    def node_rows(self) -> torch.Tensor:
        """The node-major rows K4 reads, cached with the packed tables."""
        return self._pack()[1]


def _fit_level(keys, slots, n_slots, kind, pool, train_steps, seed,
               paper_bounds):
    """Fit (reuse or train) one model per slot: params, measured (or
    Theorem 3.3) bounds, sim, reused mask, count, pmin, pmax -- all
    (n_slots,) stacked."""
    dev = keys.device
    count, kmin, kmax, pmin, pmax = leaf_stats(keys, slots, n_slots)
    found = torch.zeros((n_slots,), dtype=torch.bool, device=dev)
    if pool is not None:
        sel_a, sel_ps = pool.tables()
        hists = leaf_histograms(keys, slots, n_slots, pool.m, kmin, kmax)
        sel = select_from_pool_batch(sel_a, sel_ps, hists, pool.eps)
        del hists
        found = sel.found & (count > 1)
        idx = sel.index.long()
        src = DomainSpec(*(a[idx] for a in pool.domains))
        tgt = DomainSpec(x_start=kmin,
                         x_end=torch.where(kmax > kmin, kmax, kmin + 1.0),
                         y_start=pmin, y_end=torch.maximum(pmax, pmin + 1.0))
        adapt = adapt_linear if pool.kind == "linear" else adapt_mlp
        adapted = adapt(models.take_rows(pool.params, idx), src, tgt)
        s_dy = (tgt.y_end - tgt.y_start) / (src.y_end - src.y_start)
        thm_lo, thm_hi = reuse_err_bounds(pool.err_lo[idx], pool.err_hi[idx],
                                          sel.dist, count, s_dy)

    if kind == "linear":
        fresh = segment_linear_fit(keys, slots, n_slots)
    else:
        fresh = _batched_leaf_mlp(keys, slots, n_slots, count, kmin, kmax,
                                  pmin, train_steps, seed,
                                  skip_mask=found if pool is not None
                                  else None)

    if pool is not None and pool.kind == kind:
        params = models.where_rows(found, adapted, fresh)
    else:
        params = fresh
        found = torch.zeros((n_slots,), dtype=torch.bool, device=dev)

    pred = _leaf_predict_all(kind, params, keys, slots)
    lo, hi = segment_residual_bounds(pred, slots, n_slots)
    del pred
    if pool is not None and paper_bounds:
        lo = torch.where(found, thm_lo, lo)
        hi = torch.where(found, thm_hi, hi)
    # Empty slots are reachable by out-of-distribution queries: give them a
    # sound full-array window.
    n = keys.shape[0]
    lo = torch.where(count > 0, lo, torch.full_like(lo, -float(n)))
    hi = torch.where(count > 0, hi, torch.full_like(hi, float(n)))
    sim = torch.where(found, 1.0 - sel.dist, torch.ones_like(sel.dist)) \
        if pool is not None else torch.ones((n_slots,), dtype=_F64,
                                            device=dev)
    return params, lo, hi, sim, found, count, pmin, pmax


def build_rmrt(keys, leaf_cap: int = 4096, fanout: int = 64,
               kind: str = "linear", pool: ModelPool | None = None,
               paper_bounds: bool = False, train_steps: int = 200,
               max_depth: int = 12, seed: int = 0, *,
               device=None) -> RMRTIndex:
    """Build an RMRT over sorted keys on ``device`` (CUDA unless
    ``device="cpu"``): ``leaf_cap`` is the paper's N, ``fanout`` its B."""
    dev = resolve_device(device)
    if kind not in ("linear", "mlp"):
        raise ValueError(f"model kind must be 'linear' or 'mlp': {kind!r}")
    keys = torch.as_tensor(keys, dtype=_F64, device=dev)
    n = keys.shape[0]

    parts = {k: [] for k in ("params", "leaf", "cbase", "ylo", "yhi", "elo",
                             "ehi", "sim", "reused")}
    slots = torch.zeros((n,), dtype=torch.int32, device=dev)
    n_slots, has_dummy = 1, False
    level_base = 0                  # flat index of the level's first node
    depth = 0
    for level in range(max_depth):
        depth = level + 1
        params, lo, hi, sim, found, count, pmin, pmax = _fit_level(
            keys, slots, n_slots, kind, pool, train_steps, seed + level,
            paper_bounds)
        real = n_slots - (1 if has_dummy else 0)
        count_np = count[:real].cpu().numpy()
        leaf_np = (count_np <= leaf_cap) | (level == max_depth - 1)
        internal = np.flatnonzero(~leaf_np)

        # The next level is laid out as fanout-sized groups in the order
        # of ``internal``.
        next_base = level_base + real
        cbase = np.full((real,), -1, np.int64)
        cbase[internal] = next_base + np.arange(internal.size) * fanout
        leaf_mask = torch.as_tensor(leaf_np, device=dev)
        zero = torch.zeros((), dtype=_F64, device=dev)
        parts["params"].append(models.take_rows(params, slice(0, real)))
        parts["leaf"].append(leaf_mask)
        parts["cbase"].append(torch.as_tensor(cbase, dtype=torch.int32,
                                              device=dev))
        parts["ylo"].append(pmin[:real])
        parts["yhi"].append(torch.maximum(pmax, pmin)[:real] + 1.0)
        parts["elo"].append(torch.where(leaf_mask, lo[:real], zero))
        parts["ehi"].append(torch.where(leaf_mask, hi[:real], zero))
        parts["sim"].append(sim[:real])
        parts["reused"].append(found[:real])
        if internal.size == 0:
            break

        # Route keys of internal nodes to their child slot; park the rest.
        from ..kernels.lookup import trunc_clip
        pred = _leaf_predict_all(kind, params, keys, slots)
        sl = slots.long()
        span = (torch.maximum(pmax, pmin) + 1.0 - pmin)[sl]
        child = trunc_clip((pred - pmin[sl]) * fanout / span, 0, fanout - 1)
        del pred, span
        remap = np.full((n_slots,), -1, np.int64)      # dummy stays -1
        remap[internal] = np.arange(internal.size)
        new_slots = torch.as_tensor(remap, device=dev)[sl] * fanout + child
        del sl, child
        pad = 1 << max(int(internal.size) - 1, 0).bit_length()
        n_next = pad * fanout
        slots = torch.where(new_slots >= 0, new_slots, n_next).to(torch.int32)
        del new_slots
        n_slots, has_dummy = n_next + 1, True
        level_base = next_base

    cat = torch.cat
    first = parts["params"][0]
    params = type(first)(*(cat([p[i] for p in parts["params"]])
                           for i in range(len(first))))
    return RMRTIndex(
        keys=keys, kind=kind, params=params, is_leaf=cat(parts["leaf"]),
        child_base=cat(parts["cbase"]), y_start=cat(parts["ylo"]),
        y_end=cat(parts["yhi"]), err_lo=cat(parts["elo"]),
        err_hi=cat(parts["ehi"]), node_sim=cat(parts["sim"]),
        reused_mask=cat(parts["reused"]), fanout=fanout, leaf_cap=leaf_cap,
        depth=depth)


# ---------------------------------------------------------------------------
# Lookup.
# ---------------------------------------------------------------------------
def lookup(index: RMRTIndex, queries, *, path: str = "auto",
           clamp_iters: bool = True) -> torch.Tensor:
    """Serving lookup.  ``path="kernel"`` is kernel K4 (the whole descent
    and the clamped search in one kernel, f32 key space) plus the seam
    fix; ``"jnp"`` the f64 masked descent below; ``"auto"`` as for
    ``rmi.lookup``."""
    q = torch.as_tensor(queries, dtype=_F64, device=index.device)
    if resolve_path(path, f32_exact=lambda: index.f32_exact,
                    device=index.device):
        from ..kernels import ops
        from ..kernels.lookup import full_iters
        iters = index.search_iters if clamp_iters else full_iters(index.n)
        mat, vec = index.packed_tables()
        return ops.rmrt_lookup(q.to(torch.float32), mat, vec, index.keys_f32,
                               fanout=index.fanout, depth=index.depth,
                               kind=index.kind, iters=iters,
                               rows=index.node_rows(),
                               fence=index.key_fence)
    return _rmrt_lookup(index, q,
                        index.search_iters if clamp_iters else None)


def _rmrt_lookup(index: RMRTIndex, queries, iters: int | None = None):
    """f64 masked fixed-depth descent (vectorized over queries), then the
    same verified bounded search as the RMI."""
    from ..kernels.lookup import clip_to_i32, trunc_clip
    n = index.n
    fan = index.fanout
    node = torch.zeros(queries.shape, dtype=torch.int64,
                       device=queries.device)
    for _ in range(index.depth):
        pred = _leaf_predict_all(index.kind, index.params, queries, node)
        span = index.y_end[node] - index.y_start[node]
        child = trunc_clip((pred - index.y_start[node]) * fan / span, 0,
                           fan - 1)
        nxt = index.child_base[node].long() + child
        node = torch.where(index.is_leaf[node], node, nxt)
    pred = _leaf_predict_all(index.kind, index.params, queries, node)
    lo = clip_to_i32(torch.floor(pred + index.err_lo[node]), 0.0,
                     float(n - 1))
    hi = clip_to_i32(torch.ceil(pred + index.err_hi[node]) + 1, 1.0,
                     float(n))
    return verified_search(index.keys, queries, lo, hi, iters=iters)
