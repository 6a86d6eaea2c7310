"""Range-partitioned learned index with its shards stacked on one card
(counterpart of ``repro.core.distributed``).

An index over more keys than one host holds is range-partitioned across
shards.  The reference runs one shard a device under ``shard_map`` and
routes each query batch through an ``all_to_all`` exchange; here the
shards' tables are stacked on one card and the exchange becomes three
steps, so that every find, range or static lookup over all shards is one
launch of a shard-stacked kernel (``kernels.lookup.sharded_*``):

  route    ``dest = searchsorted(splits, q, side="left")`` (NaN routes to
           the last shard), then a stable grouping of the queries by
           ``dest``;
  answer   one launch over all grouped queries, each lane reading its
           shard's tables from a descriptor array (or, on the f64 path, one
           pass a shard);
  return   the answers scattered back to the queries' order.

``ShardMesh`` stands in for ``jax.sharding.Mesh``: it names the shard count
(``mesh.shape[axis]``) and carries no device; an index takes ``device=`` as
every entry point of the port does.

Partitioning invariants (shared by the static and dynamic index):
:func:`shard_bounds` is an equal-count split snapped to equal-key run
starts, so a run of duplicate keys is owned by one shard.  ``splits[s]`` is
the last key of shard s and every key of shard s+1 is strictly greater, so
``searchsorted(splits, q, side="left")`` sends every query or update for a
key to the one shard that can own it, and a global live rank is (live keys
in shards < dest) + (local rank).  Shards may be empty: an all-empty prefix
of shards has -inf splits; an empty shard answers rank ``offs[s]`` /
found False and re-absorbs load through rebalancing.

Queries that are not live -- +inf or NaN -- answer found False, rank 0 in
the dynamic index (the reference's exchange pads with +inf; the single-host
index reports found True for +inf), and rank ``valid[s] + s * cap`` in the
static lookup.  -inf is live and routes to shard 0.

``ShardedDynamicIndex`` keeps the reference's maintenance contract: each
shard is a ``core.updates.DynamicRMI``; mutations mark shards dirty; the
stacked state the finds read is rewritten row by row in place
(``index_copy_``), re-padded whole only when the global capacity class
changes; a (n_shards, 4) device counter table feeds the rebalance trigger,
one reduction and one host read a batch; skew migrates whole boundary runs
to a neighbour (the donor sheds in place, the run rides the receiver's
delta tier), delta-hot shards flush and dead-hot shards rebuild in place.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .. import resolve_device
from ..kernels import lookup as tlk
from ..kernels import ops
from . import drift as drift_mod
from . import models
from . import rmi as rmi_mod
from .paths import resolve_path
from .updates import DynamicRMI, _host_ints, _to_host, two_tier_answer, \
    two_tier_range_answer

_F64 = torch.float64
_I32 = torch.int32
_I64 = torch.int64


@dataclass(frozen=True)
class ShardMesh:
    """The shard count of a sharded index under a mesh axis name: the
    port's stand-in for ``jax.sharding.Mesh`` (``mesh.shape[axis]``)."""
    n_shards: int
    axis: str = "data"

    @property
    def shape(self) -> dict:
        return {self.axis: self.n_shards}


def _n_shards(mesh, axis: str) -> int:
    n = int(mesh.shape[axis])
    if n < 1:
        raise ValueError(f"a mesh of {n} shards")
    return n


# ---------------------------------------------------------------------------
# Partitioning.
# ---------------------------------------------------------------------------
def shard_bounds(keys, n_shards: int) -> np.ndarray:
    """Equal-count partition positions over sorted ``keys`` (numpy or a
    tensor), snapped to equal-key run *starts* so no duplicate run
    straddles a shard seam.  Returns (n_shards + 1,) non-decreasing
    positions b with b[0] = 0 and b[-1] = n; shard s owns keys[b[s]:b[s+1]]
    and b[s] == b[s+1] marks an empty shard."""
    n = int(keys.shape[0])
    cap = -(-n // n_shards) if n else 0
    b = np.minimum(np.arange(n_shards + 1, dtype=np.int64) * max(cap, 1), n)
    for s in range(1, n_shards):
        p = int(b[s])
        if 0 < p < n and float(keys[p - 1]) == float(keys[p]):
            b[s] = _left_of(keys, p)
    return np.maximum.accumulate(b)


def _left_of(keys, p: int) -> int:
    """Start of the equal-key run holding ``keys[p]``."""
    if isinstance(keys, torch.Tensor):
        return int(torch.searchsorted(keys, keys[p:p + 1]))
    return int(np.searchsorted(keys, keys[p], side="left"))


def _splits_from_bounds(keys, bounds: np.ndarray) -> np.ndarray:
    """(n_shards - 1,) split values: splits[s] = last key of shard s; -inf
    for the shards of an all-empty prefix, the previous split for a later
    empty shard."""
    return np.asarray([float(keys[bounds[s + 1] - 1]) if bounds[s + 1] > 0
                       else -np.inf for s in range(bounds.shape[0] - 2)],
                      np.float64)


def _route(splits: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Owning shard of each query; NaN routes to the last shard, as the
    reference's and numpy's searchsorted place it (stated here: the CUDA
    search need not place it there)."""
    d = torch.searchsorted(splits, q)
    return torch.where(torch.isnan(q), splits.shape[0], d).to(_I32)


def _member(first: torch.Tensor) -> torch.Tensor:
    """A member key of each shard, for non-live queries: its first key, or
    0.0 when the shard is empty."""
    return torch.where(torch.isfinite(first), first,
                       torch.zeros_like(first))


def _grouped(splits: torch.Tensor, member: torch.Tensor, q: torch.Tensor):
    """A batch routed and grouped by shard, as the shard-stacked kernels
    take it: (the owning shard of each query, the stable grouping order,
    the grouped shard ids, the grouped queries with the non-live ones --
    +inf and NaN -- replaced by their shard's ``member`` key, the grouped
    live mask)."""
    dest = _route(splits, q)
    order = torch.argsort(dest, stable=True)
    ds, qs = dest[order], q[order]
    live = qs < torch.inf
    return dest, order, ds, torch.where(live, qs, member[ds.long()]), live


def _row(params, s: int):
    """Row ``s`` of stacked model parameters."""
    return type(params)(*(f[s] for f in params))


def _stack_params(ps: list):
    return type(ps[0])(*(torch.stack(f) for f in zip(*ps, strict=True)))


def _segments(ds: torch.Tensor, n_shards: int) -> list:
    """[(shard, start, end)] of the non-empty runs of grouped shard ids
    (one host read of the counts)."""
    cnt = torch.bincount(ds.long(), minlength=n_shards).tolist()
    out, a = [], 0
    for s, c in enumerate(cnt):
        if c:
            out.append((s, a, a + c))
        a += c
    return out


def _scatter_back(order: torch.Tensor, *grouped):
    """Answers of grouped queries put back in the queries' order."""
    outs = []
    for g in grouped:
        o = torch.empty_like(g)
        o[order] = g
        outs.append(o)
    return outs


# ---------------------------------------------------------------------------
# The static sharded index.
# ---------------------------------------------------------------------------
@dataclass
class ShardedIndex:
    """Per-shard linear RMIs, stacked, and the split vector."""
    mesh: ShardMesh
    axis: str
    splits: torch.Tensor     # (n_shards - 1,) f64
    keys: torch.Tensor       # (n_shards, cap) f64, +inf padded
    valid: torch.Tensor      # (n_shards,) int64 real keys a shard
    root: models.LinearParams      # stacked (n_shards,)
    leaves: models.LinearParams    # stacked (n_shards, n_leaves)
    err_lo: torch.Tensor
    err_hi: torch.Tensor
    n_leaves: int
    search_iters: int | None = None
    # kernel tables, built on the first kernel-path lookup: packed
    # (roots, mats, vecs), f32 keys, leaf rows, fences, descriptors
    _packed: tuple | None = None
    _kf32: torch.Tensor = None
    _rows: torch.Tensor = None
    _fences: torch.Tensor = None
    _tabs: torch.Tensor = None
    _f32_exact: bool | None = None

    @property
    def n_shards(self) -> int:
        return int(self.keys.shape[0])

    @property
    def device(self) -> torch.device:
        return self.keys.device

    @property
    def keys_f32(self) -> torch.Tensor:
        if self._kf32 is None:
            self._kf32 = self.keys.to(torch.float32)
        return self._kf32

    @property
    def f32_exact(self) -> bool:
        """Every shard's keys round-trip through f32 (the kernel path's
        precondition)."""
        if self._f32_exact is None:
            self._f32_exact = bool(
                (self.keys_f32.to(_F64) == self.keys).all())
        return self._f32_exact

    def packed_tables(self) -> tuple:
        """(roots, mats, vecs) stacked packed kernel tables (cached)."""
        if self._packed is None:
            kr, km, kv = [], [], []
            for s in range(self.n_shards):
                kr.append(tlk.pack_root("linear", _row(self.root, s)))
                w1, b1, w2, b2 = rmi_mod._leaf_table_arrays(
                    "linear", _row(self.leaves, s), self.n_leaves)
                m, v = tlk.pack_leaves(w1, b1, w2, b2, self.err_lo[s],
                                       self.err_hi[s])
                km.append(m)
                kv.append(v)
            self._packed = (torch.stack(kr), torch.stack(km),
                            torch.stack(kv))
        return self._packed

    def kernel_tables(self) -> dict:
        """What the shard-stacked K1 reads, cached: the packed tables, the
        f32 keys, leaf rows, fences, and on CUDA the descriptors."""
        roots, mats, vecs = self.packed_tables()
        if self._rows is None:
            self._rows = tlk.stacked_leaf_rows(mats, vecs, "linear")
            self._fences = tlk.stacked_fences(self.keys_f32)
        if self._tabs is None and self.device.type == "cuda":
            self._tabs = tlk.shard_tables(
                roots, mats, vecs, self.keys_f32, n_leaves=self.n_leaves,
                iters=self.search_iters, rows=self._rows,
                fences=self._fences)
        return dict(roots=roots, mats=mats, vecs=vecs, keys=self.keys_f32,
                    rows=self._rows, fences=self._fences, tabs=self._tabs)


def build_sharded(keys, mesh, axis: str = "data", n_leaves: int = 1024,
                  pool=None, *, device=None) -> ShardedIndex:
    """Equal-count range partition snapped to duplicate-run boundaries; one
    linear RMI a shard (empty shards get the trivial zero-model build), on
    ``device`` (CUDA unless ``device="cpu"``)."""
    dev = resolve_device(device)
    n_shards = _n_shards(mesh, axis)
    keys = torch.as_tensor(keys, dtype=_F64, device=dev).reshape(-1)
    n = keys.shape[0]
    if n == 0:
        raise ValueError("build_sharded needs at least one key")
    bounds = shard_bounds(keys, n_shards)
    cap = max(int(np.diff(bounds).max()), 1)
    splits = torch.as_tensor(_splits_from_bounds(keys, bounds), device=dev)
    shards, valid, roots, leaves, elos, ehis = [], [], [], [], [], []
    for s in range(n_shards):
        part = keys[int(bounds[s]):int(bounds[s + 1])]
        idx = rmi_mod.build_rmi(part, n_leaves=n_leaves, kind="linear",
                                pool=pool, device=dev)
        shards.append(tlk.pad_capacity(part, cap))
        valid.append(part.shape[0])
        roots.append(idx.root)
        leaves.append(idx.leaves)
        elos.append(idx.err_lo)
        ehis.append(idx.err_hi)
    err_lo, err_hi = torch.stack(elos), torch.stack(ehis)
    return ShardedIndex(
        mesh=mesh, axis=axis, splits=splits, keys=torch.stack(shards),
        valid=torch.as_tensor(valid, dtype=_I64, device=dev),
        root=_stack_params(roots), leaves=_stack_params(leaves),
        err_lo=err_lo, err_hi=err_hi, n_leaves=n_leaves,
        search_iters=tlk.search_iters(err_lo, err_hi, cap))


def _cumcount(ids: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Occurrence rank of each element among equal ids (stable)."""
    n = ids.shape[0]
    order = torch.argsort(ids, stable=True)
    sorted_ids = ids[order]
    start = torch.searchsorted(
        sorted_ids, torch.arange(n_bins, dtype=ids.dtype, device=ids.device))
    out = torch.empty(n, dtype=_I64, device=ids.device)
    out[order] = torch.arange(n, device=ids.device) - start[sorted_ids.long()]
    return out


def _budget_mask(dest: torch.Tensor, n_shards: int,
                 capacity_factor: float) -> torch.Tensor:
    """Which queries the capacity-bucketed exchange answers: C slots for
    each (origin block, destination) pair, the origin block a query's block
    of Q / n_shards in the batch.  Queries past C - 1 in a pair all write
    its last slot, and the last of them in batch order is answered there
    (the reference's scatter: XLA:CPU applies a scatter's updates in
    order)."""
    Q = dest.shape[0]
    if Q % n_shards:
        raise ValueError(f"a batch of {Q} queries does not split into "
                         f"{n_shards} origin blocks")
    B = Q // n_shards
    C = max(int(B * capacity_factor / n_shards), 1)
    block = torch.arange(Q, device=dest.device) // max(B, 1)
    g = block * n_shards + dest.long()
    c = _cumcount(g, n_shards * n_shards)
    count = torch.bincount(g, minlength=n_shards * n_shards)
    return (c < C - 1) | (c == count[g] - 1)


def make_lookup_fn(index: ShardedIndex, *,
                   capacity_factor: float | None = None,
                   path: str = "auto"):
    """A lookup over all shards: q (Q,) -> global ranks (Q,) int32, a
    query's rank being its left boundary within its shard's padded row
    plus ``shard * cap`` (the reference's ``+ me * cap`` encoding), clamped
    to the shard's valid keys.

    ``capacity_factor``: C = max(int(B * factor / n_shards), 1) slots for
    each (origin block, destination) pair, B = Q / n_shards; queries past
    the budget answer -1 (the caller retries).  None answers every query.
    ``path`` as in ``core.paths``: the kernel path is one launch of the
    shard-stacked K1 (``kernels.ops.sharded_index_lookup``), the f64 path a
    verified window search a shard."""
    S, cap = index.keys.shape
    dev = index.device
    iters = index.search_iters
    use_kernel = resolve_path(path, f32_exact=lambda: index.f32_exact,
                              device=dev, what="sharded key space")
    tabs = index.kernel_tables() if use_kernel else None
    member = _member(index.keys[:, 0])

    def local_f64(s, q):
        b = rmi_mod.root_buckets("linear", _row(index.root, s), q,
                                 index.n_leaves, cap)
        lo, hi = rmi_mod.leaf_window("linear", _row(index.leaves, s),
                                     index.err_lo[s], index.err_hi[s], b, q,
                                     cap)
        return rmi_mod.verified_search(index.keys[s], q, lo, hi,
                                       iters=iters)

    def lookup(q_global) -> torch.Tensor:
        q = torch.as_tensor(q_global, dtype=_F64, device=dev).reshape(-1)
        dest, order, ds, qm, live = _grouped(index.splits, member, q)
        if use_kernel:
            r = ops.sharded_index_lookup(
                qm.to(torch.float32), ds, tabs["roots"], tabs["mats"],
                tabs["vecs"], tabs["keys"], n_leaves=index.n_leaves,
                iters=iters, rows=tabs["rows"], fences=tabs["fences"],
                tabs=tabs["tabs"])
        else:
            r = torch.empty(qm.shape, dtype=_I32, device=dev)
            for s, a, e in _segments(ds, S):
                r[a:e] = local_f64(s, qm[a:e])
        v = index.valid[ds.long()]
        rank = (torch.where(live, torch.minimum(r.long(), v), v)
                + ds.long() * cap).to(_I32)
        (out,) = _scatter_back(order, rank)
        if capacity_factor is not None:
            out = torch.where(_budget_mask(dest, S, capacity_factor), out,
                              -1)
        return out

    return lookup


# ---------------------------------------------------------------------------
# The sharded dynamic index.
# ---------------------------------------------------------------------------
def scatter_rows_(dst: torch.Tensor, idx: torch.Tensor,
                  rows: torch.Tensor) -> torch.Tensor:
    """``dst[idx] = rows`` in place (the counterpart of the reference's
    donated row scatter): the restack slice cache rewrites dirty rows of
    the stacked tensors without a copy of the whole stack.  Raises if the
    write did not land in ``dst``'s own storage."""
    ptr = dst.data_ptr()
    dst.index_copy_(0, idx, rows)
    if dst.data_ptr() != ptr:
        raise AssertionError("row restack reallocated the stacked tensor")
    return dst


def _offs(counts: torch.Tensor) -> torch.Tensor:
    """Per-shard global live-rank offsets from the counter table:
    offs[s] = live keys in shards < s."""
    live = counts[:, 0] - counts[:, 1] + counts[:, 2]
    return (torch.cumsum(live, 0) - live).to(_I32)


def _rebalance_trigger(counts: torch.Tensor, muted: torch.Tensor,
                       ratio: float, skew: float) -> torch.Tensor:
    """The rebalance trigger as one reduction over the counter table
    (columns base_n, base_dead, delta_live, delta_dead): (hot shard id or
    -1, skewed?, delta-hot?, dead-hot?) as one (4,) int64 tensor, so that
    the host policy reads it once."""
    livei = counts[:, 0] - counts[:, 1] + counts[:, 2]
    live = livei.to(_F64)
    dlive = counts[:, 2].to(_F64)
    deadf = (counts[:, 1] + counts[:, 3]).to(_F64)
    stored = (counts[:, 0] + counts[:, 2] + counts[:, 3]).to(_F64)
    delta_hot = dlive / live.clamp(min=1.0) > ratio
    dead_hot = deadf / stored.clamp(min=1.0) > ratio
    mean = (live.sum() / live.shape[0]).clamp(min=1.0)
    skewed = (live > skew * mean) & (livei != muted)
    trig = delta_hot | dead_hot | skewed
    hot = torch.argmax(torch.where(trig, live, torch.full_like(live, -1.0)))
    any_ = trig.any()
    return torch.stack([torch.where(any_, hot, -1),
                        (skewed[hot] & any_).to(_I64),
                        (delta_hot[hot] & any_).to(_I64),
                        (dead_hot[hot] & any_).to(_I64)])


def _pad_rows(a: torch.Tensor, c: int) -> torch.Tensor:
    return torch.cat([a, a.new_zeros((c - a.shape[0],))])


def _pad_psum(a: torch.Tensor, c: int) -> torch.Tensor:
    """Edge-pad a prefix-sum vector to ``c + 1`` entries."""
    return torch.cat([a, a[-1:].expand(c + 1 - a.shape[0])])


@dataclass
class ShardedDynamicIndex:
    """Range-partitioned two-tier dynamic index (module docstring: layout,
    slice cache and rebalance policy).  Mutations run a shard at a time
    (each shard a ``core.updates.DynamicRMI``); finds read the shards'
    slices stacked on the card, maintained O(touched shards) a mutation,
    and answer a batch with one launch."""
    mesh: ShardMesh
    axis: str
    splits: np.ndarray                  # (n_shards - 1,) host split values
    shards: list                        # per-shard DynamicRMI
    eps: float
    n_leaves: int
    pool: object = None
    # Rebalance policy (the reference's): a shard whose delta tier holds
    # more than ``rebalance_ratio`` of its live keys, whose dead fraction
    # crosses it, or whose live count exceeds ``rebalance_skew`` x the
    # mean triggers; None disables rebalancing.
    rebalance_ratio: float | None = 0.5
    rebalance_skew: float = 2.0
    # A migrated run rides the receiver's delta tier while it is at most
    # this multiple of the receiver's Lemma 4.1 insertion headroom, else
    # the receiver rebuilds once.
    migrate_headroom_factor: float = 4.0
    rebalances: int = 0
    migrations_incremental: int = 0     # delta-riding migrations
    migrations_full: int = 0            # receiver headroom-overflow rebuilds
    restack_full: int = 0               # cold stack assemblies
    restack_rows: int = 0               # dirty rows rewritten in place
    capacity_shrinks: int = 0           # tier capacity step-downs
    # Shards replaced by empty ones in a damaged restore
    # (``persist.restore_sharded(on_corrupt="quarantine")``)
    quarantined: list = field(default_factory=list)
    build_kwargs: dict = field(default_factory=dict)
    _stack: dict | None = None          # the stacked state finds read
    _dirty: set = field(default_factory=set)
    _counts: torch.Tensor = None        # (n_shards, 4) int64: base_n,
                                        # base_dead, delta_live, delta_dead
    # Skew triggers migration cannot resolve (one duplicate run above the
    # threshold) are muted at the live count they failed at (-1: armed).
    _muted: torch.Tensor = None         # (n_shards,) int64
    _drift: torch.Tensor = None         # (n_shards, 2) f64 [score, drifted]
    swaps_committed: int = 0
    # host mirrors: capacity classes and search depths a shard
    _bcaps: np.ndarray = None
    _dcaps: np.ndarray = None
    _iters_vec: np.ndarray = None

    @classmethod
    def build(cls, keys, mesh, axis: str = "data", n_leaves: int = 256,
              pool=None, eps: float = 0.9,
              rebalance_ratio: float | None = 0.5,
              rebalance_skew: float = 2.0, *, device=None, **rmi_kwargs):
        """Partition sorted ``keys`` with :func:`shard_bounds` and build
        one ``DynamicRMI`` a shard on ``device`` (CUDA unless
        ``device="cpu"``)."""
        rmi_kwargs.setdefault("kind", "linear")
        if rmi_kwargs.get("root_kind", "linear") != "linear":
            raise ValueError(
                "ShardedDynamicIndex requires a monotone (linear) root: "
                "split routing and run snapping assume key order")
        dev = resolve_device(device)
        keys = torch.as_tensor(keys, dtype=_F64, device=dev).reshape(-1)
        n_shards = _n_shards(mesh, axis)
        bounds = shard_bounds(keys, n_shards)
        shards = [DynamicRMI.build(
            keys[int(bounds[s]):int(bounds[s + 1])], pool=pool, eps=eps,
            n_leaves=n_leaves, device=dev, **rmi_kwargs)
            for s in range(n_shards)]
        idx = cls(mesh=mesh, axis=axis,
                  splits=_splits_from_bounds(keys, bounds), shards=shards,
                  eps=eps, n_leaves=n_leaves, pool=pool,
                  rebalance_ratio=rebalance_ratio,
                  rebalance_skew=rebalance_skew, build_kwargs=rmi_kwargs)
        idx._init_maintenance()
        return idx

    def _init_maintenance(self) -> None:
        """Seed the counter table, the mutes, the drift table and the host
        capacity/depth mirrors (the one full scan outside a cold restack)."""
        S, dev = self.n_shards, self.device
        self._bcaps = np.asarray(
            [d.index.keys.shape[0] for d in self.shards], np.int64)
        self._dcaps = np.asarray(
            [d.delta_keys.shape[0] for d in self.shards], np.int64)
        self._iters_vec = np.asarray(
            [d.index.search_iters for d in self.shards], np.int64)
        self._counts = torch.as_tensor(
            [self._count_row(d) for d in self.shards], dtype=_I64,
            device=dev)
        self._muted = torch.full((S,), -1, dtype=_I64, device=dev)
        self._drift = torch.stack([drift_mod.state_row(d.drift, dev)
                                   for d in self.shards])

    @staticmethod
    def _count_row(d: DynamicRMI) -> list:
        return [d.base_n, d.base_dead_count, d.delta_live,
                d.delta_dead_count]

    def _touch(self, ids) -> None:
        """Mark shards mutated: step their capacities down where they can,
        refresh their counter and drift rows and host mirrors, and add them
        to the dirty set the next restack consumes.  O(touched shards)."""
        ids = sorted({int(s) for s in ids})
        if not ids:
            return
        for s in ids:
            d = self.shards[s]
            # eager step-down: a cold restack is then a pure re-assembly of
            # the logical state (the warm/cold bit-exactness contract)
            if d.shrink_capacity():
                self.capacity_shrinks += 1
            self._bcaps[s] = d.index.keys.shape[0]
            self._dcaps[s] = d.delta_keys.shape[0]
            self._iters_vec[s] = d.index.search_iters
            self._dirty.add(s)
        # new tensors, not writes into the old ones: a snapshot may share
        # the old ones with its writer thread
        it = (torch.as_tensor(ids, dtype=_I64, device=self.device),)
        self._counts = self._counts.index_put(it, torch.as_tensor(
            [self._count_row(self.shards[s]) for s in ids], dtype=_I64,
            device=self.device))
        self._drift = self._drift.index_put(it, torch.stack(
            [drift_mod.state_row(self.shards[s].drift, self.device)
             for s in ids]))

    # -- shape / bookkeeping ----------------------------------------------
    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    @property
    def f32_exact(self) -> bool:
        """Every shard's tiers round-trip through f32 (the kernel path's
        precondition)."""
        return all(d.f32_exact for d in self.shards)

    @property
    def total_live(self) -> int:
        return int(self.live_counts().sum())

    def live_counts(self) -> np.ndarray:
        return np.asarray([d.live_count for d in self.shards], np.int64)

    def live_keys(self) -> np.ndarray:
        """Sorted live keys across every shard (host; ``find``'s global
        rank indexes exactly this array)."""
        return np.concatenate([d.live_keys() for d in self.shards])

    def live_keys_tensor(self) -> torch.Tensor:
        """:meth:`live_keys` on the index's device."""
        return torch.cat([d.live_keys_tensor() for d in self.shards])

    # -- mutation ----------------------------------------------------------
    def _route(self, keys: np.ndarray) -> np.ndarray:
        return np.searchsorted(self.splits, keys, side="left")

    def insert_batch(self, keys) -> None:
        """Route the batch by the split vector on the host, one merge a
        touched shard (each runs its own Lemma 4.1 accounting and
        rebuilds); only those shards' slices go stale."""
        keys = _to_host(keys).astype(np.float64).ravel()
        if keys.size == 0:
            return
        dest = self._route(keys)
        touched = np.unique(dest)
        for s in touched:
            self.shards[s].insert_batch(keys[dest == s])
        self._touch(touched)
        self._maybe_rebalance()

    def delete_batch(self, keys) -> None:
        """Routed tombstone deletes (duplicates within one batch collapse to
        one removal, as in ``DynamicRMI``)."""
        keys = _to_host(keys).astype(np.float64).ravel()
        if keys.size == 0:
            return
        dest = self._route(keys)
        touched = np.unique(dest)
        for s in touched:
            self.shards[s].delete_batch(keys[dest == s])
        self._touch(touched)
        self._maybe_rebalance()

    # -- rebalance ---------------------------------------------------------
    def _maybe_rebalance(self) -> None:
        """Skew resolves by migrating boundary runs between neighbours; a
        delta-hot shard flushes its tier into the base, a dead-hot shard
        rebuilds in place to purge its tombstones."""
        if self.rebalance_ratio is None or self.n_shards == 1:
            return
        hot, skew_d, delta_d, dead_d = _rebalance_trigger(
            self._counts, self._muted, float(self.rebalance_ratio),
            float(self.rebalance_skew)).tolist()
        if hot < 0:
            return
        if skew_d:
            nb = [s for s in (hot - 1, hot + 1) if 0 <= s < self.n_shards]
            lv = {s: self.shards[s].live_count for s in [*nb, hot]}
            if lv[hot] >= min(lv[s] for s in nb):
                src, dst = hot, min(nb, key=lambda s: lv[s])     # shed
            else:
                src, dst = max(nb, key=lambda s: lv[s]), hot     # absorb
            if self._migrate(src, dst):
                self.rebalances += 1
                self._mute([src, dst], -1)
                self._touch([src, dst])
                return
            if not (delta_d or dead_d):
                # unmovable skew (one giant duplicate run): mute it at
                # this live count
                self._mute([hot], lv[hot])
                return
        if dead_d:
            self._rebuild_shard(hot, self.shards[hot].live_keys())
        else:
            self.shards[hot].flush_delta()
        self.rebalances += 1
        self._touch([hot])

    def _mute(self, ids: list, value: int) -> None:
        self._muted = self._muted.index_put(
            (torch.as_tensor(ids, dtype=_I64, device=self.device),),
            torch.tensor(value, dtype=_I64, device=self.device))

    def _migrate(self, src: int, dst: int) -> bool:
        """Move about half the live-count excess of ``src`` to the adjacent
        ``dst`` as whole boundary runs and move the split between them: the
        donor sheds in place (``shed_suffix`` / ``shed_prefix``), the run
        rides the receiver's delta tier -- or, past the receiver's
        headroom, the receiver rebuilds once.  A cut that would move
        everything (one giant run) is skipped."""
        a = self.shards[src].live_keys()
        recv = self.shards[dst]
        m = int(a.size - recv.live_count) // 2
        if m <= 0 or a.size < 2:
            return False
        if dst == src + 1:
            c = int(np.searchsorted(a, a[a.size - m], side="left"))
            if c <= 0:
                return False
            moved, split_key = a[c:], float(a[c - 1])
            self.shards[src].shed_suffix(split_key)
            self.splits[src] = split_key
        else:
            c = int(np.searchsorted(a, a[m], side="left"))
            if c <= 0:
                return False
            moved, split_key = a[:c], float(a[c - 1])
            self.shards[src].shed_prefix(split_key)
            self.splits[dst] = split_key
        if moved.size <= self.migrate_headroom_factor * \
                recv.insertion_headroom:
            recv.insert_batch(moved)        # rides the delta tier
            self.migrations_incremental += 1
        else:
            live = recv.live_keys()
            merged = np.concatenate(
                [moved, live] if dst == src + 1 else [live, moved])
            self._rebuild_shard(dst, merged)
            self.migrations_full += 1
        return True

    def _rebuild_shard(self, s: int, keys: np.ndarray) -> None:
        self.shards[s] = DynamicRMI.build(
            torch.as_tensor(keys, dtype=_F64), pool=self.pool, eps=self.eps,
            n_leaves=self.n_leaves, device=self.device, **self.build_kwargs)

    # -- drift maintenance -------------------------------------------------
    def drift_scores(self) -> np.ndarray:
        """(n_shards, 2) [KS score, drifted latch] (one host read; zeros
        when monitoring is off)."""
        return self._drift.cpu().numpy()

    def maybe_swap(self) -> int:
        """Pool hot-swap pass over the drift-latched shards (and those with
        deferred over-budget refits); swapped shards go through the dirty
        rows.  Returns the number of leaves swapped across all shards."""
        if all(d.drift is None for d in self.shards):
            return 0
        latched = set(
            np.flatnonzero(self.drift_scores()[:, 1] > 0.0).tolist())
        total = 0
        for s, d in enumerate(self.shards):
            if d.drift is None:
                continue
            if s not in latched and not (d.n_inserts > d.budget).any():
                continue
            rb0 = d.rebuilds
            n = d.maybe_swap()
            if n or d.rebuilds != rb0:
                total += n
                self._touch([s])
        self.swaps_committed += total
        return total

    # -- serving: the per-shard slice cache --------------------------------
    _ROW_KEYS = ("route_n", "base", "bdead", "bpsum", "dk", "ddead",
                 "dpsum", "err_lo", "err_hi")

    def _slice_rows(self, s: int, bcap: int, dcap: int) -> dict:
        """One shard's slices, padded to the global capacity classes: the
        unit of incremental restacking."""
        d = self.shards[s]
        return dict(
            route_n=torch.tensor(d.route_n, dtype=_F64, device=self.device),
            base=tlk.pad_capacity(d.index.keys, bcap),
            bdead=_pad_rows(d.base_dead, bcap),
            bpsum=_pad_psum(d.base_psum, bcap),
            dk=tlk.pad_capacity(d.delta_keys, dcap),
            ddead=_pad_rows(d.delta_dead, dcap),
            dpsum=_pad_psum(d.delta_psum, dcap),
            err_lo=d.index.err_lo,
            err_hi=d.index.err_hi)

    def _shard_pack(self, s: int, bcap: int, dcap: int) -> dict:
        """One shard's kernel tables: the packed root with its frozen
        routing scale folded in (so every shard routes at ratio 1), the
        cached packed leaf tables (and leaf rows, MLP leaves), and the
        cached f32 tiers padded to the global capacities."""
        d = self.shards[s]
        _, mat, vec = d.index.packed_tables()
        p = dict(roots=d.packed_root(self.n_leaves), mats=mat, vecs=vec,
                 kf=tlk.pad_capacity(d.index.keys_f32, bcap),
                 dkf=tlk.pad_capacity(d.delta_keys_f32, dcap))
        if d.index.leaf_kind == "mlp":
            p["rows"] = d.index.leaf_rows()
        return p

    def _stacked(self) -> dict:
        """The stacked state finds read: dirty rows rewritten in place; a
        cold assembly only on first use or when the global capacity class
        changed."""
        bcap = int(self._bcaps.max())  # tracelint: ok[hot-sync](np mirror)
        dcap = int(self._dcaps.max())  # tracelint: ok[hot-sync](np mirror)
        st = self._stack
        if st is None or st["bcap"] != bcap or st["dcap"] != dcap:
            return self._restack_full(bcap, dcap)
        if self._dirty:
            self._restack_rows(st, sorted(self._dirty), bcap, dcap)
        return st

    def _restack_full(self, bcap: int, dcap: int) -> dict:
        """Cold assembly over every shard; shards that arrived oversized
        without passing through ``_touch`` (a restored or resharded index)
        step their capacities down first."""
        for s, d in enumerate(self.shards):
            if d.shrink_capacity():
                self.capacity_shrinks += 1
                self._bcaps[s] = d.index.keys.shape[0]
                self._dcaps[s] = d.delta_keys.shape[0]
                self._iters_vec[s] = d.index.search_iters
        bcap = int(self._bcaps.max())  # tracelint: ok[hot-sync](np mirror)
        dcap = int(self._dcaps.max())  # tracelint: ok[hot-sync](np mirror)
        self._stack = None              # free the old stack first
        rows = [self._slice_rows(s, bcap, dcap)
                for s in range(self.n_shards)]
        st = dict(
            bcap=bcap, dcap=dcap,
            splits=torch.as_tensor(self.splits, dtype=_F64,
                                   device=self.device),
            offs=_offs(self._counts),
            root=_stack_params([d.index.root for d in self.shards]),
            leaves=_stack_params([d.index.leaves for d in self.shards]),
            leaf_kind=self.shards[0].index.leaf_kind,
            iters=int(self._iters_vec.max()),  # tracelint: ok[hot-sync](np mirror)
            packed=None, tabs=None)
        for k in self._ROW_KEYS:
            st[k] = torch.stack([r[k] for r in rows])
            for r in rows:
                del r[k]
        self._stack = st
        self.restack_full += 1
        self._dirty.clear()
        return st

    def _restack_rows(self, st: dict, ids: list, bcap: int,
                      dcap: int) -> None:
        """Rewrite the dirty shards' rows of the stacked tensors in place:
        one row scatter a tensor, O(touched) slice work."""
        rows = [self._slice_rows(s, bcap, dcap) for s in ids]
        idx = torch.as_tensor(ids, dtype=_I64, device=self.device)
        for k in self._ROW_KEYS:
            scatter_rows_(st[k], idx, torch.stack([r[k] for r in rows]))
        for key in ("root", "leaves"):
            fresh = [getattr(self.shards[s].index, key) for s in ids]
            for t, *r in zip(st[key], *fresh, strict=True):
                scatter_rows_(t, idx, torch.stack(r))
        if st["packed"] is not None:
            packs = [self._shard_pack(s, bcap, dcap) for s in ids]
            for k, t in st["packed"].items():
                scatter_rows_(t, idx, torch.stack([p[k] for p in packs]))
        st["offs"] = _offs(self._counts)
        st["splits"] = torch.as_tensor(self.splits, dtype=_F64,
                                       device=self.device)
        st["iters"] = int(self._iters_vec.max())  # tracelint: ok[hot-sync](np mirror)
        st["tabs"] = None
        self.restack_rows += len(ids)
        self._dirty.clear()

    def _packed_stack(self, st: dict) -> dict:
        """The stacked kernel tables (built on the first kernel-path find,
        then maintained row by row by :meth:`_restack_rows`)."""
        if st["packed"] is None:
            packs = [self._shard_pack(s, st["bcap"], st["dcap"])
                     for s in range(self.n_shards)]
            st["packed"] = {k: torch.stack([p[k] for p in packs])
                            for k in packs[0]}
        return st["packed"]

    def _kernel_args(self, st: dict) -> tuple:
        """(stacked kernel tables, descriptors or None on the CPU, keyword
        arguments) of a shard-stacked K2/K3 call: every shard routes at
        ratio 1 (its scale is folded into its root) and searches at the
        stack's depth."""
        pk = self._packed_stack(st)
        kw = dict(n_leaves=self.n_leaves, route_n=self.n_leaves,
                  iters=st["iters"], leaf_kind=st["leaf_kind"])
        if st["tabs"] is None and self.device.type == "cuda":
            st["tabs"] = tlk.shard_tables(
                pk["roots"], pk["mats"], pk["vecs"], pk["kf"],
                n_leaves=self.n_leaves, route_n=self.n_leaves,
                iters=st["iters"], rows=pk.get("rows"),
                delta_keys=pk["dkf"])
        return pk, st["tabs"], kw

    def _f64_answer(self, st: dict, s: int, q: torch.Tensor, rng: bool):
        """Shard ``s``'s f64 answer (the reference's jnp body): route at
        the shard's frozen scale, window, two-tier tail over its padded
        rows at the stack's depth."""
        b = rmi_mod.root_buckets("linear", _row(st["root"], s), q,
                                 self.n_leaves, float(self.shards[s].route_n))
        lo, hi = rmi_mod.leaf_window(st["leaf_kind"], _row(st["leaves"], s),
                                     st["err_lo"][s], st["err_hi"][s], b, q,
                                     st["bcap"])
        args = (st["base"][s], st["bpsum"][s], st["dk"][s], st["dpsum"][s])
        if rng:
            return two_tier_range_answer(*args, q, q, lo, hi, st["iters"])
        found, rank, _ = two_tier_answer(*args, q, lo, hi, st["iters"])
        return found, rank

    def _grouped(self, st: dict, q: torch.Tensor):
        """:func:`_grouped` of a batch on the stack ``st``: what
        :meth:`_answer` gives the shard-stacked kernels."""
        return _grouped(st["splits"], _member(st["base"][:, 0]), q)

    def _answer(self, q: torch.Tensor, use_kernel: bool, rng: bool):
        """Route, answer on each query's shard, scatter back: (found, rank)
        or, with ``rng``, (rank_lo, rank_hi) of each endpoint as a point
        range, global ranks; non-live queries answer (False, 0) / (0, 0)."""
        st = self._stacked()
        _, order, ds, qm, live = self._grouped(st, q)
        if use_kernel:
            pk, tabs, kw = self._kernel_args(st)
            qf = qm.to(torch.float32)
            tables = (pk["roots"], pk["mats"], pk["vecs"], pk["kf"],
                      st["bpsum"], pk["dkf"], st["dpsum"])
            if rng:
                a, b = ops.sharded_range_lookup(qf, qf, ds, *tables,
                                                tabs=tabs, **kw)
            else:
                a, b = ops.sharded_dynamic_find(qf, ds, *tables,
                                                rows=pk.get("rows"),
                                                tabs=tabs, **kw)
        else:
            a = torch.zeros(qm.shape, dtype=torch.int32 if rng else torch.bool,
                            device=q.device)
            b = torch.zeros(qm.shape, dtype=_I32, device=q.device)
            for s, lo, hi in _segments(ds, self.n_shards):
                ra, rb = self._f64_answer(st, s, qm[lo:hi], rng)
                a[lo:hi], b[lo:hi] = ra, rb
        offs = st["offs"][ds.long()]
        zero = torch.zeros_like(offs)
        if rng:
            a = torch.where(live, a.to(_I32) + offs, zero)
        else:
            a = a & live
        b = torch.where(live, b.to(_I32) + offs, zero)
        return _scatter_back(order, a, b)

    def _use_kernel(self, path: str) -> bool:
        return resolve_path(path, f32_exact=lambda: self.f32_exact,
                            device=self.device, what="sharded key space")

    def _as_queries(self, q) -> torch.Tensor:
        return torch.as_tensor(q, dtype=_F64,
                               device=self.device).reshape(-1).contiguous()

    def find(self, queries, *, path: str = "auto"):
        """(found, global live rank) per query: each query routes to its
        shard by the split vector and is answered there -- on the kernel
        path by one launch of the shard-stacked K2 for the whole batch
        (``kernels.ops.sharded_dynamic_find``), on the f64 path by each
        shard's two-tier find -- with the shard's live offset added.
        ``path`` as in ``core.paths``."""
        q = self._as_queries(queries)
        return tuple(self._answer(q, self._use_kernel(path), rng=False))

    def find_range(self, q_lo, q_hi, *, path: str = "auto"):
        """(rank_lo, rank_hi) global live ranks of the inclusive ranges
        ``[q_lo[i], q_hi[i]]``: both endpoint arrays routed as one batch,
        each endpoint answered by its own shard with its left and right
        rank (one launch of the shard-stacked K3 on the kernel path);
        rank_lo comes from the lo endpoint's shard, rank_hi from the hi
        endpoint's, clamped to rank_lo so degenerate ranges come back
        empty.  ``live_keys()[rank_lo:rank_hi]`` is the range's content."""
        ql, qh = self._as_queries(q_lo), self._as_queries(q_hi)
        if ql.shape != qh.shape:
            raise ValueError("find_range endpoint arrays must pair up")
        Q = ql.shape[0]
        rl, rr = self._answer(torch.cat([ql, qh]), self._use_kernel(path),
                              rng=True)
        rank_lo = rl[:Q]
        return rank_lo, torch.maximum(rr[Q:], rank_lo)

    def gather_range(self, rank_lo, rank_hi) -> list[np.ndarray]:
        """Per-range sorted live keys of :meth:`find_range` spans (host
        numpy; the global live array is assembled once and sliced)."""
        live = self.live_keys()
        lo, hi = _host_ints(rank_lo), _host_ints(rank_hi)
        return [live[int(a):int(b)] for a, b in zip(lo, hi, strict=True)]
