"""Update handling (paper §4), two-tier and device-resident (counterpart
of ``repro.core.updates``).

The *base* tier is the sorted key array served by the RMI, +inf padded to
a power-of-two capacity.  Inserts live in one sorted *delta* tier (also
pow2 capacity, +inf padded) with a routed-leaf table; deletes are
tombstone bitmaps aligned to each tier, with exclusive prefix sums for the
rank arithmetic.

  insert_batch   sort the batch, route it through the root, gather-merge
                 it into the delta tier (tombstoned entries purged in the
                 same pass), bump the per-leaf Lemma 4.1 counters;
                 ``insert(key)`` is a batch of one.
  delete_batch   tombstone the leftmost live occurrence, delta tier first;
                 ``delete(key)`` is a batch of one.
  find           (found, rank): base window search + delta probe +
                 tombstone mask.  ``rank`` counts live keys < q across both
                 tiers.  On CUDA the search is kernel K2 (``kernels.ops``).
  find_range     (rank_lo, rank_hi) of inclusive ranges; kernel K3 on CUDA.
  rebuild        Lemma 4.1 budget exhaustion merges the affected leaves'
                 delta entries into the base and re-indexes those leaves
                 (Algorithm-1 pool reuse first, refit on a miss; by default
                 reuse runs for MLP leaves only); untouched leaves take an
                 exact intercept shift (linear, monotone root) or a sound
                 +-m widen (MLP root), and the clamped search depth is
                 recomputed from a per-leaf window-width vector.
  maybe_swap     drift-adaptive maintenance (``core.drift``): with
                 ``drift_bins`` an online KS score over the build-time CDF
                 drives a ``drift_hi``/``drift_lo`` hysteresis latch; while
                 it is set, leaves near their Lemma 4.1 budget take a
                 bound-checked Algorithm-1 pool hot-swap (masked row writes
                 into the leaf tables: shapes and search depth unchanged),
                 and leaves still over budget take the ordinary refit.  In
                 swap mode (``swap_on_drift=True``) ``insert_batch`` defers
                 every repair to this idle-window pass.

Routing is frozen at build time (``route_n``), so base merges never move
keys between leaves and insert-time routing matches find-time routing.
Duplicate keys are a multiset; ``delete`` removes one occurrence.

Where the reference relies on XLA's out-of-bounds conventions, this module
says so: ``bincount(length=)`` drops positions past the end (here they are
masked first), and ``.at[].set(mode="drop")`` drops out-of-bounds writes
(here they go to one extra slot that is sliced off).

``clone`` gives an independent handle over the same tensors;
``shrink_capacity`` steps a tier's capacity class back down;
``shed_suffix`` / ``shed_prefix`` cut an index at a key (the donor half of
the sharded index's migrations and reshards, ``core.distributed``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, fields, is_dataclass, replace

import numpy as np
import torch

from .. import resolve_device
from ..kernels.lookup import capacity_class, pad_capacity
from . import drift as drift_mod
from . import models
from . import rmi as rmi_mod
from .bounds import (clamped_depth, insertion_budget, insertion_headroom,
                     window_widths)
from .paths import resolve_path
from .reuse import ModelPool

_F64 = torch.float64
_I32 = torch.int32
_MIN_CAP = 128          # delta-tier floor: one 128-entry lane tile
_COMPACT_RATIO = 0.25   # default delta-tier dead fraction before compaction


def _capacity(n: int) -> int:
    return capacity_class(n, floor=_MIN_CAP)


def _empty(dtype, device):
    return torch.zeros((0,), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Tier primitives.
# ---------------------------------------------------------------------------
def _compact_sorted(keys, keep, payloads: tuple = (), fills: tuple = ()):
    """Drop ``~keep`` entries from a sorted array, backfilling +inf /
    ``fills``: a kept entry moves to its index minus the dropped count
    before it (one cumsum + scatter; order is preserved)."""
    cap = keys.shape[0]
    drop = (~keep).to(torch.int64)
    tgt = torch.arange(cap, device=keys.device) - torch.cumsum(drop, 0) + drop
    tgt = torch.where(keep, tgt, cap)      # dropped entries -> spare slot

    def scatter(src, fill):
        out = torch.full((cap + 1,), fill, dtype=src.dtype, device=src.device)
        out[tgt] = src
        return out[:cap]

    return scatter(keys, math.inf), tuple(
        scatter(p, f) for p, f in zip(payloads, fills, strict=True))


def _merge_sorted(ak, bk, cap_out: int, a_payloads: tuple = (),
                  b_payloads: tuple = (), fills: tuple = ()):
    """Gather-merge of two sorted, +inf-padded arrays (with payloads).

    The merged position of each ``bk`` entry is one searchsorted (ties:
    ``ak``'s equal run first); every output slot then resolves to a gather
    from ``bk`` (if a ``bk`` entry lands there) or ``ak``.  The output is
    re-padded / truncated to ``cap_out``; callers guarantee every finite
    entry fits."""
    na, nb = ak.shape[0], bk.shape[0]
    dev = ak.device
    if nb == 0:
        def ext(x, f):
            pad = torch.full((max(cap_out - na, 0),), f, dtype=x.dtype,
                             device=dev)
            return torch.cat([x, pad])[:cap_out]
        return ext(ak, math.inf), tuple(
            ext(pa, f) for pa, f in zip(a_payloads, fills, strict=True))
    posb = torch.arange(nb, device=dev) + torch.searchsorted(ak, bk,
                                                             right=True)
    posb = posb[posb < cap_out]            # positions past the end drop
    ind = torch.zeros((cap_out,), dtype=_I32, device=dev)
    ind[posb] = 1                          # posb is strictly increasing
    bl = torch.cumsum(ind, 0, dtype=_I32) - ind   # #b slots before i
    i = torch.arange(cap_out, dtype=_I32, device=dev)
    ai = (i - bl).clamp(0, na - 1).long()
    bi = bl.clamp(0, nb - 1).long()
    in_range = i < na + nb
    take_b = in_range & (ind > 0)
    del ind, bl, i
    out = torch.where(take_b, bk[bi], torch.where(in_range, ak[ai], math.inf))
    outp = tuple(
        torch.where(take_b, pb[bi], torch.where(in_range, pa[ai], f))
        for pa, pb, f in zip(a_payloads, b_payloads, fills, strict=True))
    return out, outp


def _merge_delta(dk, dleaf, ddead, new_k, new_leaf, cap_out: int):
    """Sorted merge of a routed, sorted batch into the delta tier, purging
    tombstoned entries first; the result is all live."""
    ck, (cl,) = _compact_sorted(dk, torch.isfinite(dk) & ~ddead, (dleaf,),
                                (-1,))
    allk, (alll,) = _merge_sorted(ck, new_k.to(_F64), cap_out, (cl,),
                                  (new_leaf.to(_I32),), (-1,))
    return allk, alll


def _merge_delta_clean(dk, dleaf, new_k, new_leaf, cap_out: int):
    """:func:`_merge_delta` for a tier without tombstones (no compaction)."""
    allk, (alll,) = _merge_sorted(dk, new_k.to(_F64), cap_out, (dleaf,),
                                  (new_leaf.to(_I32),), (-1,))
    return allk, alll


def _fill_delta(new_k, new_leaf, cap_out: int):
    """Insert into an empty delta tier: the sorted batch plus padding."""
    pad = cap_out - new_k.shape[0]
    dev = new_k.device
    return (torch.cat([new_k.to(_F64),
                       torch.full((pad,), math.inf, dtype=_F64, device=dev)]),
            torch.cat([new_leaf.to(_I32),
                       torch.full((pad,), -1, dtype=_I32, device=dev)]))


def _batch_counts_sorted(lv, n_leaves: int):
    """Per-leaf counts of a routed batch under the monotone root: run
    lengths of the non-decreasing leaf ids."""
    start, end = rmi_mod._bucket_bounds(lv, n_leaves)
    return end - start


def _moved_counts_sorted(dleaf, rmask):
    """Per-leaf live delta counts restricted to ``rmask`` leaves, for a
    tombstone-free tier under the monotone root."""
    L = rmask.shape[0]
    arr = torch.where(dleaf >= 0, dleaf, L)
    return torch.where(rmask, _batch_counts_sorted(arr, L), 0)


def _psum(dead):
    """Exclusive prefix sum of a tombstone bitmap, length n + 1, int32."""
    return torch.cat([torch.zeros((1,), dtype=_I32, device=dead.device),
                      torch.cumsum(dead.to(_I32), 0, dtype=_I32)])


def _delete(base_keys, base_dead, dk, ddead, q):
    """Mark one live occurrence of each query dead: delta tier first, base
    on a delta miss; absent keys are no-ops.  Within an equal-key run
    tombstones form a prefix, so the first live slot of a run is
    ``run_lo + #dead-in-run``.  Duplicates within one batch collapse to one
    removal.  Returns (base_dead, delta_dead, #base killed, #delta killed)."""
    def mark(keys, dead, skip):
        n = keys.shape[0]
        psum = _psum(dead)
        lo = torch.searchsorted(keys, q)
        hi = torch.searchsorted(keys, q, right=True)
        tgt = lo + (psum[hi] - psum[lo])
        hit = (tgt < hi) & ~skip
        out = torch.cat([dead, torch.zeros((1,), dtype=torch.bool,
                                           device=dead.device)])
        out[torch.where(hit, tgt, n)] = True      # misses -> spare slot
        return out[:n], hit

    new_ddead, dhit = mark(dk, ddead, torch.zeros(q.shape, dtype=torch.bool,
                                                  device=q.device))
    new_bdead, _ = mark(base_keys, base_dead, dhit)
    nb = new_bdead.sum() - base_dead.sum()
    ndel = new_ddead.sum() - ddead.sum()
    return new_bdead, new_ddead, nb, ndel


def _shed_suffix(keys, dead, cut: int, leaf=None):
    """Truncate a sorted +inf-padded tier at position ``cut``: entries
    [cut:] become +inf padding (leaf -1) with cleared tombstones; survivor
    positions are unchanged.  Returns (keys, dead, leaf, #tombstones
    dropped)."""
    keep = torch.arange(keys.shape[0], device=keys.device) < cut
    nd = dead & keep
    return (torch.where(keep, keys, math.inf), nd,
            None if leaf is None else torch.where(keep, leaf, -1),
            int(dead.sum()) - int(nd.sum()))


def _shed_prefix(keys, dead, cut: int, leaf=None):
    """Drop the first ``cut`` slots of a sorted +inf-padded tier and
    compact left (one gather; the tail is re-padded): survivor positions
    all shift down by exactly ``cut``.  Returns as :func:`_shed_suffix`."""
    n = keys.shape[0]
    src = torch.arange(n, device=keys.device) + cut
    ok = src < n
    srcc = src.clamp(0, n - 1)
    nd = torch.where(ok, dead[srcc], False)
    return (torch.where(ok, keys[srcc], math.inf), nd,
            None if leaf is None else torch.where(ok, leaf[srcc], -1),
            int(dead.sum()) - int(nd.sum()))


def two_tier_answer(base_keys, base_psum, dk, dpsum, q, lo, hi, iters: int):
    """The f64 two-tier find tail: verified base window search, then the
    tombstone mask and live rank.  Returns (found, rank, base_pos)."""
    pos = rmi_mod.verified_search(base_keys, q, lo, hi, iters=iters)
    bhi = torch.searchsorted(base_keys, q, right=True).to(_I32)
    base_hit = (bhi - pos) > (base_psum[bhi.long()] - base_psum[pos.long()])
    dpos = torch.searchsorted(dk, q).to(_I32)
    dhi = torch.searchsorted(dk, q, right=True).to(_I32)
    delta_hit = (dhi - dpos) > (dpsum[dhi.long()] - dpsum[dpos.long()])
    rank = (pos - base_psum[pos.long()]) + (dpos - dpsum[dpos.long()])
    return base_hit | delta_hit, rank, pos


def two_tier_range_answer(base_keys, base_psum, dk, dpsum, q_lo, q_hi, lo,
                          hi, iters: int):
    """The f64 two-tier range tail: rank_lo (live keys < q_lo, via q_lo's
    verified window search) and rank_hi (live keys <= q_hi), clamped so
    degenerate ranges come back empty.  ``lo``/``hi`` is q_lo's window."""
    blo = rmi_mod.verified_search(base_keys, q_lo, lo, hi, iters=iters)
    bhi = torch.searchsorted(base_keys, q_hi, right=True).to(_I32)
    dlo = torch.searchsorted(dk, q_lo).to(_I32)
    dhi = torch.searchsorted(dk, q_hi, right=True).to(_I32)
    rank_lo = (blo - base_psum[blo.long()]) + (dlo - dpsum[dlo.long()])
    rank_hi = (bhi - base_psum[bhi.long()]) + (dhi - dpsum[dhi.long()])
    return rank_lo, torch.maximum(rank_hi, rank_lo)


def _routed_window(idx: rmi_mod.RMIIndex, q, route_n: int):
    b = rmi_mod.root_buckets(idx.root_kind, idx.root, q, idx.n_leaves,
                             route_n)
    return rmi_mod.leaf_window(idx.leaf_kind, idx.leaves, idx.err_lo,
                               idx.err_hi, b, q, idx.n)


def _find(idx: rmi_mod.RMIIndex, base_psum, dk, dpsum, q, route_n: int):
    """f64 path of ``find``: route, window, two-tier answer."""
    lo, hi = _routed_window(idx, q, route_n)
    return two_tier_answer(idx.keys, base_psum, dk, dpsum, q, lo, hi,
                           idx.search_iters)


def _range_find(idx: rmi_mod.RMIIndex, base_psum, dk, dpsum, q_lo, q_hi,
                route_n: int):
    """f64 path of ``find_range``."""
    lo, hi = _routed_window(idx, q_lo, route_n)
    return two_tier_range_answer(idx.keys, base_psum, dk, dpsum, q_lo, q_hi,
                                 lo, hi, idx.search_iters)


def _routed_buckets(root_kind: str, root, keys, n_leaves: int, route_n: int):
    """Frozen-scale routing that sends +inf capacity padding to the dump
    bucket ``n_leaves`` (a saturating conversion would clip it into the
    last live leaf)."""
    b = rmi_mod.root_buckets(root_kind, root, keys, n_leaves, route_n)
    return torch.where(torch.isfinite(keys), b, n_leaves)


def _gather_moved(dk, dleaf, ddead, rmask):
    """Live delta entries routed to rebuilt leaves: (their sorted keys with
    +inf backfill, membership mask, per-leaf moved counts)."""
    L = rmask.shape[0]
    move = (dleaf >= 0) & ~ddead & rmask[dleaf.clamp(0, L - 1).long()]
    mk, _ = _compact_sorted(dk, move)
    mcnt = torch.bincount(torch.where(move, dleaf, L).long(),
                          minlength=L + 1)[:L]
    return mk, move, mcnt


def _compose_rebuild(old: rmi_mod.RMIIndex, fit: rmi_mod.LeafFit, rmask,
                     shift, widen: float, eps: float):
    """Post-rebuild leaf state: refit rows where ``rmask``; elsewhere the
    exact intercept shift (``b`` of a linear leaf, ``b2`` of an MLP) and
    the bounds widened by ``widen``; and the full Lemma 4.1 budget
    vector."""
    if old.leaf_kind == "linear":
        shifted = old.leaves._replace(b=old.leaves.b + shift)
    else:
        shifted = old.leaves._replace(b2=old.leaves.b2 + shift)
    leaves = models.where_rows(rmask, fit.leaves, shifted)
    return (leaves,
            torch.where(rmask, fit.err_lo, old.err_lo - widen),
            torch.where(rmask, fit.err_hi, old.err_hi + widen),
            torch.where(rmask, fit.reused, old.reused_mask),
            torch.where(rmask, fit.sim, old.leaf_sim),
            insertion_budget(fit.sim, eps, fit.count))


def _merge_base(base_keys, base_dead, moved, cap_out: int,
                has_dead: bool = True):
    """Sorted gather-merge of the moved delta entries into the base tier,
    re-padded to ``cap_out``; tombstone flags ride the same gather map."""
    if not has_dead:
        allk, _ = _merge_sorted(base_keys, moved, cap_out)
        return allk, torch.zeros((cap_out,), dtype=torch.bool,
                                 device=base_keys.device)
    allk, (dead,) = _merge_sorted(
        base_keys, moved, cap_out, (base_dead,),
        (torch.zeros(moved.shape, dtype=torch.bool, device=moved.device),),
        (False,))
    return allk, dead


def _to_host(x) -> np.ndarray:
    """A tensor or array as host numpy.  A CUDA tensor is copied; a CPU
    tensor is shared, which is safe: the index never writes a tensor it has
    published, it rebinds a new one."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _moved(x, dev: torch.device):
    """``x`` with every tensor in it copied to ``dev``: dataclasses and
    tuples walked, a pool swapped for its replica there."""
    if isinstance(x, torch.Tensor):
        # sync: ok(DynamicRMI.to, reached through the name .to: moves a shard)
        return x.to(dev)
    if isinstance(x, ModelPool):
        return x.replica(dev)
    if is_dataclass(x) and not isinstance(x, type):
        return replace(x, **{f.name: _moved(getattr(x, f.name), dev)
                             for f in fields(x)})
    if isinstance(x, tuple):
        items = [_moved(v, dev) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def _host_ints(x) -> np.ndarray:
    return _to_host(x).ravel()


# ---------------------------------------------------------------------------
# The dynamic index.
# ---------------------------------------------------------------------------
@dataclass
class DynamicRMI:
    """RMI base tier + sorted delta tier + Lemma 4.1 rebuild policy.

    Both tiers, the tombstone bitmaps and prefix sums live on the index's
    device; the host keeps the per-leaf counters (numpy) and the search
    depth bookkeeping."""
    index: rmi_mod.RMIIndex
    eps: float
    pool: ModelPool | None = None       # Algorithm-1 pool for rebuilds
    route_n: int = 0                    # frozen key->leaf routing scale
    # delta tier (pow2 capacity, +inf padded, sorted ascending)
    delta_keys: torch.Tensor = None     # (cap,) f64
    delta_leaf: torch.Tensor = None     # (cap,) int32 routed leaf, -1 pads
    delta_dead: torch.Tensor = None     # (cap,) bool
    delta_psum: torch.Tensor = None     # (cap+1,) int32
    delta_live: int = 0                 # live (finite & not dead) entries
    delta_dead_count: int = 0           # tombstoned delta entries
    # When the tier's dead fraction reaches this ratio, delete_batch purges
    # its tombstones in place (a delete-only workload has no merge to do
    # it).  None disables the trigger.
    compact_dead_ratio: float | None = _COMPACT_RATIO
    delta_compactions: int = 0
    # base tier bookkeeping (keys live inside ``index``, +inf padded)
    base_n: int = 0                     # finite base keys (incl tombstoned)
    base_dead: torch.Tensor = None      # (cap,) bool
    base_psum: torch.Tensor = None      # (cap+1,) int32
    base_dead_count: int = 0
    # Lemma 4.1 accounting (host)
    n_inserts: np.ndarray = None        # per leaf, since last rebuild
    budget: np.ndarray = None
    rebuilds: int = 0
    deleted: int = 0
    capacity_shrinks: int = 0           # tier capacity step-downs taken
    # Rebuild re-indexing policy: None runs Algorithm-1 pool selection only
    # where a refit needs training (MLP leaves); the closed-form linear
    # refit is optimal and earns the full Lemma 4.1 budget.  True forces
    # selection (Algorithm 1 verbatim), False disables it.
    reuse_on_rebuild: bool | None = None
    build_kwargs: dict = field(default_factory=dict)
    # Online drift monitor (``core.drift``; None = off) and hot swaps.
    drift: drift_mod.DriftState | None = None
    swap_on_drift: bool = False         # defer repairs to maybe_swap
    swaps_committed: int = 0            # leaves hot-swapped (bound held)
    swap_rejects: int = 0               # swap attempts that fell back
    _win: np.ndarray = None             # per-leaf window widths
    # maybe_swap's routing cache (keys tensor, slice length, base slice,
    # buckets): valid while the base keys tensor is the same object
    _swap_route: tuple | None = None
    _delta_f32: bool | None = None      # delta tier round-trips through f32
    _dkf32: torch.Tensor = None         # f32 copy of the delta tier
    _kroot: torch.Tensor = None         # packed root with route scale

    @classmethod
    def build(cls, keys, pool: ModelPool | None = None, eps: float = 0.9,
              reuse_on_rebuild: bool | None = None,
              compact_dead_ratio: float | None = _COMPACT_RATIO,
              drift_bins: int = 0, drift_hi: float = 0.15,
              drift_lo: float = 0.05, swap_on_drift: bool = False, *,
              device=None, **rmi_kwargs):
        """Build over sorted ``keys`` on ``device`` (CUDA unless
        ``device="cpu"``); ``rmi_kwargs`` go to ``rmi.build_rmi``.  The
        ``pool`` serves the build and every later rebuild.  ``drift_bins >
        0`` turns on the online drift monitor at that resolution with the
        [drift_lo, drift_hi] hysteresis band; ``swap_on_drift`` defers the
        repairs of budget-exhausted leaves to :meth:`maybe_swap`."""
        if pool is not None and pool.device.type != resolve_device(
                device).type:
            raise ValueError(f"the pool lies on {pool.device}, the index "
                             f"on {resolve_device(device)}")
        idx = rmi_mod.build_rmi(keys, pool=pool, device=device, **rmi_kwargs)
        dev = idx.device
        n = idx.n
        # Floor at 1 so an empty build keeps a well-defined key->leaf hash.
        route_n = max(n, 1)
        counts = torch.bincount(
            rmi_mod.root_buckets(idx.root_kind, idx.root, idx.keys,
                                 idx.n_leaves, route_n).long(),
            minlength=idx.n_leaves)
        budget = insertion_budget(idx.leaf_sim, eps, counts).cpu().numpy()
        drift = drift_mod.init_drift(idx.keys, m=drift_bins,
                                     thresh_hi=drift_hi,
                                     thresh_lo=drift_lo) \
            if drift_bins else None
        cap = _capacity(n)
        idx = replace(idx, keys=pad_capacity(idx.keys, cap), _f32_exact=None,
                      _packed=None, _kf32=None)
        d = cls(index=idx, eps=eps, pool=pool, route_n=route_n, base_n=n,
                reuse_on_rebuild=reuse_on_rebuild,
                compact_dead_ratio=compact_dead_ratio,
                drift=drift, swap_on_drift=swap_on_drift,
                delta_keys=torch.full((_MIN_CAP,), math.inf, dtype=_F64,
                                      device=dev),
                delta_leaf=torch.full((_MIN_CAP,), -1, dtype=_I32,
                                      device=dev),
                delta_dead=torch.zeros((_MIN_CAP,), dtype=torch.bool,
                                       device=dev),
                delta_psum=torch.zeros((_MIN_CAP + 1,), dtype=_I32,
                                       device=dev),
                base_dead=torch.zeros((cap,), dtype=torch.bool, device=dev),
                base_psum=torch.zeros((cap + 1,), dtype=_I32, device=dev),
                n_inserts=np.zeros(idx.n_leaves, np.int64),
                budget=budget, build_kwargs=rmi_kwargs)
        d._win = window_widths(idx.err_lo, idx.err_hi)
        idx._iters = clamped_depth(d._win, cap)
        return d

    @property
    def device(self) -> torch.device:
        return self.index.device

    def _as_keys(self, keys) -> torch.Tensor:
        # sync: ok(no copy for a batch on the device; a host one is uploaded)
        return torch.as_tensor(keys, dtype=_F64,
                               device=self.device).reshape(-1)

    def _delta_changed(self) -> None:
        self._delta_f32 = None
        self._dkf32 = None

    # -- mutation ----------------------------------------------------------
    def insert(self, key: float) -> None:
        """Insert one key: a one-element :meth:`insert_batch`."""
        self.insert_batch(np.asarray([key], np.float64))

    def insert_batch(self, keys) -> None:
        """Bulk insert: sort and route the batch, merge it into the delta
        tier, one host read of the per-leaf counts, batched rebuild of any
        leaves whose Lemma 4.1 budget is exhausted."""
        k = self._as_keys(keys)
        if k.shape[0] == 0:
            return
        idx = self.index
        k = torch.sort(k).values
        lv = rmi_mod.root_buckets(idx.root_kind, idx.root, k, idx.n_leaves,
                                  self.route_n)
        cap = max(self.delta_keys.shape[0],
                  _capacity(self.delta_live + k.shape[0]))
        if self.delta_live == 0 and self.delta_dead_count == 0:
            self.delta_keys, self.delta_leaf = _fill_delta(k, lv, cap)
        elif self.delta_dead_count == 0:
            self.delta_keys, self.delta_leaf = _merge_delta_clean(
                self.delta_keys, self.delta_leaf, k, lv, cap)
        else:
            self.delta_keys, self.delta_leaf = _merge_delta(
                self.delta_keys, self.delta_leaf, self.delta_dead, k, lv, cap)
            self.delta_dead_count = 0
        dev = self.device
        self.delta_dead = torch.zeros((cap,), dtype=torch.bool, device=dev)
        self.delta_psum = torch.zeros((cap + 1,), dtype=_I32, device=dev)
        self.delta_live += k.shape[0]
        self._delta_changed()
        if self.drift is not None:
            self.drift = drift_mod.update_drift(self.drift, k)
        cnt = _batch_counts_sorted(lv, idx.n_leaves) \
            if idx.root_kind == "linear" \
            else torch.bincount(lv.long(), minlength=idx.n_leaves)
        self.n_inserts += cnt.cpu().numpy()
        over = np.flatnonzero(self.n_inserts > self.budget)
        if over.size and self.swap_on_drift and self.drift is not None \
                and self.pool is not None:
            # Swap mode: the repair waits for the idle-window maintenance
            # pass (maybe_swap); answers stay exact meanwhile, since the
            # buffered keys are searched in the delta tier.
            return
        if over.size:
            self._rebuild_leaves(over)

    def delete(self, key: float) -> None:
        """Delete one occurrence of a key: a one-element
        :meth:`delete_batch`."""
        self.delete_batch(np.asarray([key], np.float64))

    def delete_batch(self, keys) -> None:
        """Tombstone the leftmost live occurrence of each key, in the delta
        tier first, else in the base tier.  Duplicate keys within one batch
        collapse to a single removal."""
        q = self._as_keys(keys)
        if q.shape[0] == 0:
            return
        self.base_dead, self.delta_dead, nb, ndel = _delete(
            self.index.keys, self.base_dead, self.delta_keys,
            self.delta_dead, q)
        self.base_psum = _psum(self.base_dead)
        nb, ndel = int(nb), int(ndel)
        self.delta_live -= ndel
        self.delta_dead_count += ndel
        self.base_dead_count += nb
        self.deleted += nb + ndel
        if (self.compact_dead_ratio is not None and self.delta_dead_count
                and self.delta_dead_count >= self.compact_dead_ratio
                * (self.delta_live + self.delta_dead_count)):
            self._compact_delta()
        else:
            self.delta_psum = _psum(self.delta_dead)

    def _compact_delta(self) -> None:
        """Purge tombstoned delta entries in place; live entries, their
        order and every live rank are unchanged."""
        cap = self.delta_keys.shape[0]
        dev = self.device
        self.delta_keys, self.delta_leaf = _merge_delta(
            self.delta_keys, self.delta_leaf, self.delta_dead,
            _empty(_F64, dev), _empty(_I32, dev), cap)
        self.delta_dead = torch.zeros((cap,), dtype=torch.bool, device=dev)
        self.delta_psum = torch.zeros((cap + 1,), dtype=_I32, device=dev)
        self.delta_dead_count = 0
        self.delta_compactions += 1
        self._delta_changed()

    # -- boundary-run migration primitives (sharded index) -----------------
    def _cut(self, keys, split: float) -> int:
        return int(torch.searchsorted(
            keys, torch.tensor([split], dtype=_F64, device=self.device),
            right=True))

    def shed_suffix(self, split: float) -> None:
        """Drop every entry with key > ``split`` from both tiers: the donor
        half of a migration to the right neighbour.  A suffix truncation
        moves no survivor, so the models, error bounds, packed tables,
        leaf rows and search depth stay valid; the f32 keys and their
        fence are recomputed.  ``split`` must end an equal-key run
        (callers snap it), so a duplicate run and its tombstone prefix
        move or stay whole."""
        cut_b = self._cut(self.index.keys, split)
        if cut_b < self.base_n:
            keys, dead, _, shed_dead = _shed_suffix(
                self.index.keys, self.base_dead, cut_b)
            self.index = replace(self.index, keys=keys, _kf32=None)
            self.base_dead = dead
            self.base_dead_count -= shed_dead
            self.base_psum = torch.zeros((keys.shape[0] + 1,), dtype=_I32,
                                         device=self.device) \
                if self.base_dead_count == 0 else _psum(dead)
            self.base_n = cut_b
        cut_d = self._cut(self.delta_keys, split)
        nf = self.delta_live + self.delta_dead_count
        if cut_d < nf:
            self.delta_keys, self.delta_dead, self.delta_leaf, sdead = \
                _shed_suffix(self.delta_keys, self.delta_dead, cut_d,
                             self.delta_leaf)
            self.delta_dead_count -= sdead
            self.delta_live -= (nf - cut_d) - sdead
            self.delta_psum = _psum(self.delta_dead)
            self._delta_changed()

    def shed_prefix(self, split: float) -> None:
        """Drop every entry with key <= ``split``: the donor half of a
        migration to the left neighbour.  Both tiers compact left and every
        leaf intercept shifts down by exactly the number of base entries
        removed (all removals lie left of every survivor, so the shift is
        exact for either leaf kind under any root); the error bounds and
        search depth stay, the packed tables and leaf rows are re-packed.
        Routing is untouched: the frozen root maps keys, not positions."""
        cut_b = self._cut(self.index.keys, split)
        if cut_b > 0:
            keys, dead, _, shed_dead = _shed_prefix(
                self.index.keys, self.base_dead, cut_b)
            lv = self.index.leaves
            leaves = lv._replace(b=lv.b - cut_b) \
                if self.index.leaf_kind == "linear" \
                else lv._replace(b2=lv.b2 - cut_b)
            # the packed root (``_kroot``) stays: roots are frozen
            self.index = replace(self.index, keys=keys, leaves=leaves,
                                 _packed=None, _kf32=None)
            self.base_dead = dead
            self.base_dead_count -= shed_dead
            self.base_psum = torch.zeros((keys.shape[0] + 1,), dtype=_I32,
                                         device=self.device) \
                if self.base_dead_count == 0 else _psum(dead)
            self.base_n -= cut_b
        cut_d = self._cut(self.delta_keys, split)
        if cut_d > 0:
            self.delta_keys, self.delta_dead, self.delta_leaf, sdead = \
                _shed_prefix(self.delta_keys, self.delta_dead, cut_d,
                             self.delta_leaf)
            self.delta_dead_count -= sdead
            self.delta_live -= cut_d - sdead
            self.delta_psum = _psum(self.delta_dead)
            self._delta_changed()

    def clone(self) -> "DynamicRMI":
        """An independent handle over the same tensors.  Mutating methods
        rebind tensor fields (no tensor the index has published is written
        in place) and mutate the host numpy counters in place, so a clone
        needs fresh host containers and a fresh ``RMIIndex`` wrapper (whose
        ``_iters`` a rebuild assigns), nothing deeper."""
        d = replace(self, index=replace(self.index),
                    n_inserts=self.n_inserts.copy(),
                    budget=self.budget.copy(),
                    build_kwargs=dict(self.build_kwargs))
        if self.drift is not None:
            # updates rebind a fresh DriftState, so a shallow copy fully
            # decouples the clones
            d.drift = replace(self.drift)
        d._win = self._win.copy()
        return d

    def to(self, device) -> "DynamicRMI":
        """This index on ``device``: itself when it lies there, else a
        handle with every tensor copied to ``device`` and its pool's
        replica there (``ModelPool.replica``), for a sharded index that
        places a shard on another mesh position.  The handle shares the
        host counters with this one, which it consumes."""
        dev = torch.device(device)
        return self if dev == self.device else _moved(self, dev)

    def shrink_capacity(self, hysteresis: int = 4) -> bool:
        """Step either tier's capacity class back down, the inverse of the
        grow-only policy of ``insert_batch`` / ``_rebuild_leaves``.  A tier
        shrinks only when its capacity is at least ``hysteresis`` times the
        smallest class that fits, and steps down to ``hysteresis // 2``
        times that class, so a shrink leaves a doubling of headroom and
        regrowing needs two.  Finite entries occupy each tier's prefix, so
        a shrink keeps a copy of the prefix: positions, models, error
        bounds, the packed tables and leaf rows stay; the f32 keys and
        their fence, cached with the keys, go; the clamped search depth is
        recomputed for the smaller capacity.  Returns True if a tier
        shrank."""
        hold = max(hysteresis // 2, 1)
        shrank = False
        idx = self.index
        cap_b = idx.keys.shape[0]
        want_b = _capacity(self.base_n) * hold
        if cap_b >= hysteresis * _capacity(self.base_n) and cap_b > want_b:
            # copies, so that the larger storage is freed
            self.base_dead = self.base_dead[:want_b].clone()
            self.base_psum = torch.zeros((want_b + 1,), dtype=_I32,
                                         device=self.device) \
                if self.base_dead_count == 0 else _psum(self.base_dead)
            self.index = replace(idx, keys=idx.keys[:want_b].clone(),
                                 _kf32=None)
            self.index._iters = clamped_depth(self._win, want_b)
            self.capacity_shrinks += 1
            shrank = True
        cap_d = self.delta_keys.shape[0]
        nf_d = self.delta_live + self.delta_dead_count
        want_d = _capacity(nf_d) * hold
        if cap_d >= hysteresis * _capacity(nf_d) and cap_d > want_d:
            self.delta_keys = self.delta_keys[:want_d].clone()
            self.delta_leaf = self.delta_leaf[:want_d].clone()
            self.delta_dead = self.delta_dead[:want_d].clone()
            self.delta_psum = torch.zeros((want_d + 1,), dtype=_I32,
                                          device=self.device) \
                if self.delta_dead_count == 0 else _psum(self.delta_dead)
            self._delta_changed()
            self.capacity_shrinks += 1
            shrank = True
        return shrank

    def flush_delta(self) -> None:
        """Merge every live delta entry into the base now, refitting only
        the leaves that hold delta entries."""
        if self.delta_live == 0:
            if self.delta_dead_count:
                self._compact_delta()
            return
        L = self.index.n_leaves
        livem = torch.isfinite(self.delta_keys) & ~self.delta_dead
        cnt = torch.bincount(torch.where(livem, self.delta_leaf, L).long(),
                             minlength=L + 1)[:L]
        lid = np.flatnonzero(cnt.cpu().numpy())
        if lid.size:
            self._rebuild_leaves(lid)
        # A full merge: every buffered insert is in the base tier and its
        # leaves were refitted, so the drift baseline absorbs them and the
        # latch clears (partial rebuilds do not rebaseline).
        if self.drift is not None:
            self.drift = drift_mod.rebaseline(self.drift)

    @property
    def insertion_headroom(self) -> float:
        """Aggregate Lemma 4.1 headroom over all leaves."""
        return insertion_headroom(self.budget, self.n_inserts)

    def packed_root(self, route_leaves: int | None = None) -> torch.Tensor:
        """Packed kernel root with the frozen routing scale folded in
        (``route_scale = route_leaves / route_n``), cached: the root model
        and ``route_n`` never change after build."""
        if self._kroot is None:
            from ..kernels import lookup as _lk
            scale = 1.0 if route_leaves is None \
                else route_leaves / self.route_n
            self._kroot = _lk.pack_root(self.index.root_kind,
                                        self.index.root, route_scale=scale)
        return self._kroot

    # -- rebuild -----------------------------------------------------------
    def _rebuild_leaves(self, leaf_ids) -> None:
        """Batched Lemma 4.1 rebuild: merge the leaves' delta entries into
        the base tier and refit them with measured bounds; untouched leaves
        get an exact intercept shift, depth and budgets update
        incrementally."""
        idx = self.index
        L = idx.n_leaves
        dev = self.device
        leaf_ids = np.asarray(leaf_ids, np.int64).ravel()
        self.rebuilds += int(leaf_ids.size)
        rmask_np = np.zeros(L, bool)
        rmask_np[leaf_ids] = True
        rmask = torch.as_tensor(rmask_np, device=dev)

        cap = self.delta_keys.shape[0]
        no_new = (_empty(_F64, dev), _empty(_I32, dev), cap)
        if self.delta_dead_count == 0 and idx.root_kind == "linear":
            # Monotone routing + no tombstones: per-leaf counts are run
            # lengths of the sorted routed-leaf table.
            mcnt = _moved_counts_sorted(self.delta_leaf, rmask).cpu().numpy()
            m = int(mcnt.sum())
            if m == self.delta_live:
                # Whole-tier merge: the sorted tier is the moved array.
                mk = self.delta_keys
                self.delta_keys = torch.full((cap,), math.inf, dtype=_F64,
                                             device=dev)
                self.delta_leaf = torch.full((cap,), -1, dtype=_I32,
                                             device=dev)
            else:
                mk, move, _ = _gather_moved(self.delta_keys, self.delta_leaf,
                                            self.delta_dead, rmask)
                self.delta_keys, self.delta_leaf = _merge_delta(
                    self.delta_keys, self.delta_leaf, move, *no_new)
        else:
            mk, move, mcnt_d = _gather_moved(self.delta_keys, self.delta_leaf,
                                             self.delta_dead, rmask)
            mcnt = mcnt_d.cpu().numpy()
            m = int(mcnt.sum())
            self.delta_keys, self.delta_leaf = _merge_delta(
                self.delta_keys, self.delta_leaf, self.delta_dead | move,
                *no_new)
            self.delta_dead_count = 0
        self.delta_dead = torch.zeros((cap,), dtype=torch.bool, device=dev)
        self.delta_psum = torch.zeros((cap + 1,), dtype=_I32, device=dev)
        self.delta_live -= m
        self._delta_changed()

        self.base_n += m
        cap_new = max(idx.n, _capacity(self.base_n))
        mp = min(_capacity(m), mk.shape[0])
        new_base, new_bdead = _merge_base(idx.keys, self.base_dead, mk[:mp],
                                          cap_new,
                                          has_dead=self.base_dead_count > 0)
        del mk

        # Refit over the merged base's finite prefix (sliced at a quantized
        # boundary); capacity pads route to the dump bucket.
        buckets = _routed_buckets(idx.root_kind, idx.root, new_base, L,
                                  self.route_n)
        sl = min(cap_new, -(-self.base_n // 8192) * 8192)
        want_reuse = self.reuse_on_rebuild \
            if self.reuse_on_rebuild is not None \
            else idx.leaf_kind != "linear"
        fit = rmi_mod.fit_leaves(
            new_base[:sl], buckets[:sl], L, kind=idx.leaf_kind,
            pool=self.pool if want_reuse else None,
            train_steps=self.build_kwargs.get("train_steps", 300),
            refit_mask=rmask, sorted_buckets=idx.root_kind == "linear")
        del buckets

        # A linear root is monotone: every base key right of a rebuilt leaf
        # shifts by exactly the number of keys merged left of it.  An MLP
        # root only bounds the shift by m, so its leaves widen instead.
        shift = torch.as_tensor(np.concatenate([[0.0], np.cumsum(mcnt)[:-1]]),
                                dtype=_F64, device=dev)
        widen = 0.0 if idx.root_kind == "linear" else float(m)
        leaves, err_lo, err_hi, reused, sim, budget = _compose_rebuild(
            idx, fit, rmask, shift, widen, self.eps)
        self.index = replace(
            idx, keys=new_base, leaves=leaves, err_lo=err_lo, err_hi=err_hi,
            reused_mask=reused, leaf_sim=sim,
            _iters=None, _packed=None, _f32_exact=None, _kf32=None)

        if widen:
            self._win[~rmask_np] += 2.0 * widen
        err_np = torch.stack([fit.err_lo, fit.err_hi]).cpu().numpy()
        self._win[leaf_ids] = window_widths(err_np[0, leaf_ids],
                                            err_np[1, leaf_ids])
        self.index._iters = clamped_depth(self._win, cap_new)

        self.base_dead = new_bdead
        self.base_psum = torch.zeros((cap_new + 1,), dtype=_I32, device=dev) \
            if self.base_dead_count == 0 else _psum(new_bdead)
        self.budget[leaf_ids] = budget.cpu().numpy()[leaf_ids]
        self.n_inserts[leaf_ids] = 0

    # -- drift-triggered hot swap ------------------------------------------
    def maybe_swap(self, leaf_ids=None) -> int:
        """Algorithm-1 pool hot-swaps of ``leaf_ids``, bound-checked and
        committed per leaf (``core.drift.swap_leaves``); returns the number
        of leaves swapped.  Without ``leaf_ids`` it is the idle-window
        maintenance pass: swaps for the leaves near their budget while the
        drift latch is set, then the ordinary refit of every leaf still
        over budget.  A no-op without a drift monitor, a pool of the
        leaves' kind, or a linear root."""
        idx = self.index
        if (self.drift is None or self.pool is None
                or self.pool.kind != idx.leaf_kind
                or idx.root_kind != "linear"):
            return 0
        if leaf_ids is None:
            swaps = 0
            if bool(self.drift.drifted):
                # At-risk leaves only (within a quarter budget of a merge):
                # swapping others would only shrink budgets, since a pool
                # model's sim is below a fresh fit's.
                at_risk = np.flatnonzero(
                    self.n_inserts >= np.maximum(self.budget * 0.25, 1.0))
                if at_risk.size:
                    swaps = self.maybe_swap(at_risk)
            over = np.flatnonzero(self.n_inserts > self.budget)
            if over.size:
                self._rebuild_leaves(over)
            return swaps
        leaf_ids = np.asarray(leaf_ids, np.int64).ravel()
        if leaf_ids.size == 0:
            return 0
        sel_a, sel_ps = self.pool.tables()
        rp = 1 << max(int(leaf_ids.size) - 1, 0).bit_length()
        pad_ids = np.concatenate(
            [leaf_ids, np.full(rp - leaf_ids.size, leaf_ids[0])])
        sl = min(idx.keys.shape[0], -(-self.base_n // 8192) * 8192)
        rc = self._swap_route
        if rc is None or rc[0] is not idx.keys or rc[1] != sl:
            base = idx.keys[:sl]
            rc = (idx.keys, sl, base,
                  _routed_buckets(idx.root_kind, idx.root, base,
                                  idx.n_leaves, self.route_n))
            self._swap_route = rc
        dev = self.device
        out = drift_mod.swap_leaves(
            rc[2], rc[3], self.delta_keys, self.delta_leaf,
            torch.as_tensor(pad_ids, dtype=_I32, device=dev), idx.leaves,
            idx.err_lo, idx.err_hi, idx.leaf_sim, idx.reused_mask, sel_a,
            sel_ps, self.pool.params, self.pool.domains,
            torch.as_tensor(self.n_inserts[pad_ids], dtype=_F64, device=dev),
            float(self._win.max()), self.eps, leaf_kind=idx.leaf_kind,
            m=self.pool.m, n_leaves=idx.n_leaves)
        leaves, err_lo, err_hi, sim, reused, commit, nbud, nw, _ = out
        # The maintenance path's one read of the verdicts.
        commit_np = commit.cpu().numpy()[:leaf_ids.size]
        nc = int(commit_np.sum())
        self.swap_rejects += int(leaf_ids.size) - nc
        if nc == 0:
            return 0
        # New leaf models: the packed kernel tables and the leaf rows cached
        # with them (both in _packed) go stale.  The keys are unchanged
        # (their f32 copy stays), and the commit gate keeps every window
        # under the width cap, so the search depth stays too.
        self.index = replace(idx, leaves=leaves, err_lo=err_lo,
                             err_hi=err_hi, leaf_sim=sim, reused_mask=reused,
                             _packed=None)
        cid = leaf_ids[commit_np]
        self.budget[cid] = nbud.cpu().numpy()[:leaf_ids.size][commit_np]
        self._win[cid] = nw.cpu().numpy()[:leaf_ids.size][commit_np]
        # The committed window covers the leaf's buffered inserts, so the
        # swap starts a fresh budget epoch.
        self.n_inserts[cid] = 0
        self.swaps_committed += nc
        self.pool.owner.reuse_count += nc
        return nc

    # -- queries -----------------------------------------------------------
    @property
    def delta_keys_f32(self) -> torch.Tensor:
        """The delta tier in the kernel's f32 key space (cached)."""
        if self._dkf32 is None:
            # tracelint: ok[f32-cast](the copy f32_exact compares)
            self._dkf32 = self.delta_keys.to(torch.float32)
        return self._dkf32

    @property
    def f32_exact(self) -> bool:
        """Both tiers round-trip through f32 (kernel-path precondition)."""
        if self._delta_f32 is None:
            # sync: ok(once after a delta write: cached in _delta_f32)
            self._delta_f32 = bool(
                (self.delta_keys_f32.to(_F64) == self.delta_keys).all())
        return self.index.f32_exact and self._delta_f32

    def _use_kernel(self, path: str) -> bool:
        return resolve_path(path, f32_exact=lambda: self.f32_exact,
                            device=self.device)

    def find(self, queries, *, path: str = "auto"):
        """(found, rank) per query: ``found`` iff a live copy exists in
        either tier, ``rank`` the live keys < q across both tiers.
        ``path`` as in ``core.paths``; the kernel path is K2."""
        idx = self.index
        q = self._as_keys(queries)
        if self._use_kernel(path):
            from ..kernels import ops
            root, mat, vec = idx.packed_tables()
            return ops.dynamic_find(
                q.to(torch.float32), root, mat, vec, idx.keys_f32,
                self.base_psum, self.delta_keys_f32, self.delta_psum,
                n_leaves=idx.n_leaves, route_n=self.route_n,
                iters=idx.search_iters, root_kind=idx.root_kind,
                leaf_kind=idx.leaf_kind, rows=idx.leaf_rows())
        found, rank, _ = _find(idx, self.base_psum, self.delta_keys,
                               self.delta_psum, q, self.route_n)
        return found, rank

    def find_range(self, q_lo, q_hi, *, path: str = "auto"):
        """(rank_lo, rank_hi) live ranks of the inclusive ranges
        [q_lo[i], q_hi[i]]: ``live_keys()[rank_lo:rank_hi]`` is exactly the
        range's content; degenerate ranges come back empty.  The kernel
        path is K3."""
        idx = self.index
        ql, qh = self._as_keys(q_lo), self._as_keys(q_hi)
        if self._use_kernel(path):
            from ..kernels import ops
            root, mat, vec = idx.packed_tables()
            return ops.range_lookup(
                ql.to(torch.float32), qh.to(torch.float32), root, mat, vec,
                idx.keys_f32, self.base_psum, self.delta_keys_f32,
                self.delta_psum, n_leaves=idx.n_leaves, route_n=self.route_n,
                iters=idx.search_iters, root_kind=idx.root_kind,
                leaf_kind=idx.leaf_kind)
        return _range_find(idx, self.base_psum, self.delta_keys,
                           self.delta_psum, ql, qh, self.route_n)

    def gather_range(self, rank_lo, rank_hi) -> list[np.ndarray]:
        """Per-range sorted live keys of :meth:`find_range` spans (host
        numpy; the live keys are materialized once and sliced)."""
        live = self.live_keys()
        lo, hi = _host_ints(rank_lo), _host_ints(rank_hi)
        return [live[int(a):int(b)] for a, b in zip(lo, hi, strict=True)]

    def live_keys_tensor(self) -> torch.Tensor:
        """Sorted live keys across both tiers, on the index's device."""
        bk = self.index.keys
        bk = bk[torch.isfinite(bk) & ~self.base_dead]
        dk = self.delta_keys
        dk = dk[torch.isfinite(dk) & ~self.delta_dead]
        return torch.sort(torch.cat([bk, dk])).values

    def live_keys(self) -> np.ndarray:
        """Sorted live keys across both tiers (host numpy; ``find``'s rank
        indexes into exactly this array)."""
        return self.live_keys_tensor().cpu().numpy()

    @property
    def total_buffered(self) -> int:
        return int(self.delta_live)

    @property
    def live_count(self) -> int:
        """Live keys across both tiers, from host counters."""
        return self.base_n - self.base_dead_count + self.delta_live

    @property
    def dead_fraction(self) -> float:
        """Tombstoned fraction of all stored (finite) entries."""
        stored = self.base_n + self.delta_live + self.delta_dead_count
        return (self.base_dead_count + self.delta_dead_count) / max(stored, 1)
