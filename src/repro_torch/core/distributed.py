"""Range-partitioned learned index over the positions of a mesh
(counterpart of ``repro.core.distributed``).

An index over more keys than one card holds is range-partitioned across
shards, and the shards across the devices of a mesh.  ``ShardMesh(S,
devices=(d_0, ..., d_{D-1}))`` places shards p*S/D .. (p+1)*S/D - 1 on
``d_p``, stacked there; D = S is the reference's layout, one shard a
device, and ``devices=None`` stacks every shard on the one ``device=``.
One process drives every position, as the reference's single controller
does: it holds each shard's two-tier index and routes the updates and
migrations.  A query batch arrives on the home device ``d_0`` and goes
through :func:`_exchange`, the counterpart of the reference's
``_routed_exchange`` (an ``all_to_all`` out to the owners, the owners'
answers, the inverse ``all_to_all`` back):

  route    ``dest = searchsorted(splits, q, side="left")`` (NaN routes to
           the last shard), then a stable grouping of the queries by
           ``dest``: a position's shards are consecutive, so its queries
           are one slice of the grouped batch;
  out      one host read of the slices' lengths, each slice copied to its
           position's device;
  answer   one launch of a shard-stacked kernel (``kernels.lookup
           .sharded_*``) a position, each lane reading its shard's tables
           from a descriptor array (or, on the f64 path, one pass a
           shard); every position's launch is issued before the
           epilogue's first host read, and the epilogue reads once a step
           for all positions;
  back     the answers copied to the home device, the live offsets added
           there, and the answers scattered back to the queries' order.

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
shard is a ``core.updates.DynamicRMI`` on its position's device (a pool
replicated once a device); mutations mark shards dirty; the stacked state
the finds read is rewritten row by row in place (``index_copy_``), a
position's rows on its device, re-padded whole only when the global
capacity class changes (the class is global across positions, as in the
reference); a (n_shards, 4) counter table on the home device feeds the
rebalance trigger, one reduction and one host read a batch; skew migrates
whole boundary runs to a neighbour, across positions when they differ
(the donor sheds in place, the run rides the receiver's delta tier),
delta-hot shards flush and dead-hot shards rebuild in place.
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


def _position_device(device) -> torch.device:
    """A mesh position's device, resolved as an entry point resolves its
    ``device=`` (no fallback), a card always by its index."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        i = torch.cuda.current_device() if dev.index is None else dev.index
        if i >= torch.cuda.device_count():
            raise RuntimeError(
                f"a mesh position on cuda:{i}, and "
                f"{torch.cuda.device_count()} CUDA devices are visible")
        dev = torch.device("cuda", i)
    return dev


@dataclass(frozen=True)
class ShardMesh:
    """The shards of a sharded index and the devices that hold them: the
    port's stand-in for ``jax.sharding.Mesh`` (``mesh.shape[axis]`` is the
    shard count).

    ``devices`` names the device of each of D mesh positions, D dividing
    ``n_shards`` = S: position p holds shards p*S/D .. (p+1)*S/D - 1,
    stacked on ``devices[p]``, and ``devices[0]`` is the home device, where
    a caller's batches, the answers, the splits and the counter table
    live.  D = S is the reference's layout, one shard a device; D = 1 one
    stack.  ``devices=None`` stacks every shard on the entry point's
    ``device=``.  A mesh that mixes device types, or names a card that is
    not there, raises."""
    n_shards: int
    axis: str = "data"
    devices: tuple | None = None

    def __post_init__(self):
        if self.devices is None:
            return
        devs = tuple(_position_device(d) for d in self.devices)
        if not devs or self.n_shards % len(devs):
            raise ValueError(f"{len(devs)} mesh positions do not divide "
                             f"{self.n_shards} shards")
        if len({d.type for d in devs}) > 1:
            raise ValueError("a mesh mixes device types: "
                             f"{[str(d) for d in devs]}")
        object.__setattr__(self, "devices", devs)

    @property
    def shape(self) -> dict:
        return {self.axis: self.n_shards}

    def positions(self, device=None) -> tuple:
        """The device of each position: ``devices``, or with none named the
        one ``device`` (CUDA unless ``device="cpu"``).  A ``device`` that
        contradicts ``devices[0]`` raises."""
        if self.devices is None:
            return (resolve_device(device),)
        if device is not None and \
                _position_device(device) != self.devices[0]:
            raise ValueError(f"device={device} is not the mesh's home "
                             f"device {self.devices[0]}")
        return self.devices


def _n_shards(mesh, axis: str) -> int:
    n = int(mesh.shape[axis])
    if n < 1:
        raise ValueError(f"a mesh of {n} shards")
    return n


def _layout(positions: tuple, n_rows: int) -> list:
    """(device, first row, rows) of each position of a stack of ``n_rows``
    rows, cut into equal consecutive runs."""
    k = n_rows // len(positions)
    return [(dev, p * k, k) for p, dev in enumerate(positions)]


def _at_home(ts: list, home: torch.device) -> torch.Tensor:
    """The positions' pieces ``ts`` concatenated on the home device (the
    one piece itself when there is one)."""
    if len(ts) == 1:
        return ts[0]
    return torch.cat([t.to(home) for t in ts])


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


def _group(dest: torch.Tensor, member: torch.Tensor, q: torch.Tensor):
    """A batch grouped by its rows ``dest`` of a stack, as the
    shard-stacked kernels take it: (the stable grouping order, the grouped
    row ids, the grouped queries with the non-live ones -- +inf and NaN --
    replaced by their row's ``member`` key, the grouped live mask)."""
    order = torch.argsort(dest, stable=True)
    ds, qs = dest[order], q[order]
    live = qs < torch.inf
    return order, ds, torch.where(live, qs, member[ds.long()]), live


def _grouped(splits: torch.Tensor, member: torch.Tensor, q: torch.Tensor):
    """A batch routed and grouped by shard: (the owning shard of each
    query, then :func:`_group`'s order, shard ids, queries and live
    mask)."""
    dest = _route(splits, q)
    return (dest, *_group(dest, member, q))


def _row(params, s: int):
    """Row ``s`` of stacked model parameters."""
    return type(params)(*(f[s] for f in params))


def _stack_params(ps: list):
    return type(ps[0])(*(torch.stack(f) for f in zip(*ps, strict=True)))


def _scatter_back(order: torch.Tensor, *grouped):
    """Answers of grouped queries put back in the queries' order."""
    outs = []
    for g in grouped:
        o = torch.empty_like(g)
        o[order] = g
        outs.append(o)
    return outs


# The exchange's accounting: ``calls`` exchanges, ``answers`` position calls
# (one a position that holds queries), ``bytes`` copied between the home
# position and the others (the queries out, the answers back), counted as if
# every position were its own card.
EXCHANGE = {"calls": 0, "answers": 0, "bytes": 0}


def reset_exchange() -> None:
    for k in EXCHANGE:
        EXCHANGE[k] = 0


def _exchange(ds: torch.Tensor, qm: torch.Tensor, layout: list,
              dtypes: tuple, *, kernel=None, f64_row=None) -> tuple:
    """The routed exchange of a grouped batch (the counterpart of the
    reference's ``_routed_exchange``): ``ds`` the sorted row ids and ``qm``
    the queries, on the home device; ``layout`` the (device, first row,
    rows) of each mesh position.  A position's rows are consecutive, so its
    queries are one slice of the batch:

      1. one host read of the slices' lengths (none for one position on
         the kernel path);
      2. each slice copied to its position's device, its row ids made
         local to the position;
      3. one answer call a position: ``kernel`` = (an ``ops.*_all``
         function, ``call(i, f32 queries, local rows)`` giving position
         i's (arguments, keywords)), every position's launch issued before
         the epilogue's first host read; or on the f64 path
         ``f64_row(i, local row, queries)`` a row;
      4. the answers copied back into one tensor a dtype of ``dtypes``,
         in the batch's grouped order, on the home device."""
    home, Q = qm.device, qm.shape[0]
    EXCHANGE["calls"] += 1
    if kernel is not None and len(layout) == 1:
        cuts = [(0, 0, Q, None)]
    else:
        n_rows = layout[-1][1] + layout[-1][2]
        cnt = torch.bincount(ds.long(), minlength=n_rows).tolist()
        cuts, a = [], 0
        for i, (_, lo, n) in enumerate(layout):
            c = cnt[lo:lo + n]
            e = a + sum(c)
            if e > a:
                cuts.append((i, a, e, c))
            a = e
    EXCHANGE["answers"] += len(cuts)
    sent, calls, outs = [], [], []
    for i, a, e, c in cuts:
        dev, lo, _ = layout[i]
        if kernel is not None:
            q = qm[a:e].to(dev, torch.float32)
            rid = (ds[a:e] if lo == 0 else ds[a:e] - lo).to(dev)
            calls.append(kernel[1](i, q, rid))
            sent.append((q, rid))
            continue
        q = qm[a:e].to(dev)
        res = tuple(torch.empty(e - a, dtype=t, device=dev) for t in dtypes)
        b = 0
        for j, cj in enumerate(c):
            if cj:
                for r, v in zip(res, f64_row(i, j, q[b:b + cj]), strict=True):
                    r[b:b + cj] = v
            b += cj
        outs.append(res)
        sent.append((q,))
    if kernel is not None:
        outs = [o if isinstance(o, tuple) else (o,) for o in kernel[0](calls)]
    for (i, *_), moved, o in zip(cuts, sent, outs, strict=True):
        if i:
            EXCHANGE["bytes"] += sum(t.numel() * t.element_size()
                                     for t in (*moved, *o))
    if len(cuts) == 1 and cuts[0][1:3] == (0, Q):
        return tuple(t.to(home) for t in outs[0])
    res = tuple(torch.empty(Q, dtype=t, device=home) for t in dtypes)
    for (_, a, e, _), o in zip(cuts, outs, strict=True):
        for r, v in zip(res, o, strict=True):
            r[a:e] = v
    return res


# ---------------------------------------------------------------------------
# The static sharded index.
# ---------------------------------------------------------------------------
@dataclass
class ShardStack:
    """The shards of one mesh position, stacked on its device: the keys
    (k, cap) f64 +inf padded, the per-shard linear RMIs, and the kernel
    tables the shard-stacked K1 reads, built on the first kernel-path
    lookup."""
    keys: torch.Tensor       # (k, cap) f64, +inf padded
    root: models.LinearParams      # stacked (k,)
    leaves: models.LinearParams    # stacked (k, n_leaves)
    err_lo: torch.Tensor
    err_hi: torch.Tensor
    n_leaves: int
    search_iters: int | None = None
    # kernel tables: packed (roots, mats, vecs), f32 keys, leaf rows,
    # fences, descriptors
    _packed: tuple | None = None
    _kf32: torch.Tensor = None
    _rows: torch.Tensor = None
    _fences: torch.Tensor = None
    _tabs: torch.Tensor = None
    _f32_exact: bool | None = None

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
        if self._f32_exact is None:
            self._f32_exact = bool(
                (self.keys_f32.to(_F64) == self.keys).all())
        return self._f32_exact

    def packed_tables(self) -> tuple:
        """(roots, mats, vecs) stacked packed kernel tables (cached)."""
        if self._packed is None:
            kr, km, kv = [], [], []
            for s in range(self.keys.shape[0]):
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


@dataclass
class ShardedIndex:
    """Per-shard linear RMIs, one :class:`ShardStack` a mesh position, and
    the split vector and valid counts on the home device."""
    mesh: ShardMesh
    axis: str
    splits: torch.Tensor     # (n_shards - 1,) f64
    valid: torch.Tensor      # (n_shards,) int64 real keys a shard
    parts: list              # ShardStack a position
    n_leaves: int
    search_iters: int | None = None

    @classmethod
    def from_stack(cls, mesh, axis: str, splits, keys, valid, root, leaves,
                   err_lo, err_hi, n_leaves: int, search_iters,
                   positions: tuple) -> "ShardedIndex":
        """The index over whole (n_shards, ...) stacks, each position's
        rows copied to its device."""
        home = positions[0]
        parts = []
        for dev, lo, k in _layout(positions, keys.shape[0]):
            cut = lambda t: t[lo:lo + k].to(dev)
            parts.append(ShardStack(
                keys=cut(keys), root=type(root)(*map(cut, root)),
                leaves=type(leaves)(*map(cut, leaves)), err_lo=cut(err_lo),
                err_hi=cut(err_hi), n_leaves=n_leaves,
                search_iters=search_iters))
        return cls(mesh=mesh, axis=axis, splits=splits.to(home),
                   valid=valid.to(home), parts=parts, n_leaves=n_leaves,
                   search_iters=search_iters)

    @property
    def n_shards(self) -> int:
        return sum(p.keys.shape[0] for p in self.parts)

    @property
    def cap(self) -> int:
        return int(self.parts[0].keys.shape[1])

    @property
    def device(self) -> torch.device:
        """The home device."""
        return self.parts[0].device

    @property
    def positions(self) -> tuple:
        return tuple(p.device for p in self.parts)

    @property
    def keys(self) -> torch.Tensor:
        """The whole (n_shards, cap) key stack on the home device (a copy
        when the positions are several)."""
        return _at_home([p.keys for p in self.parts], self.device)

    @property
    def f32_exact(self) -> bool:
        """Every shard's keys round-trip through f32 (the kernel path's
        precondition)."""
        return all(p.f32_exact for p in self.parts)

    def kernel_tables(self) -> dict:
        """:meth:`ShardStack.kernel_tables` of a one-position index."""
        if len(self.parts) != 1:
            raise ValueError("an index over several positions has kernel "
                             "tables a position: parts[p].kernel_tables()")
        return self.parts[0].kernel_tables()


def build_sharded(keys, mesh, axis: str = "data", n_leaves: int = 1024,
                  pool=None, *, device=None) -> ShardedIndex:
    """Equal-count range partition snapped to duplicate-run boundaries; one
    linear RMI a shard (empty shards get the trivial zero-model build),
    each on its mesh position's device (with ``mesh.devices`` None, on
    ``device``: CUDA unless ``device="cpu"``)."""
    positions = mesh.positions(device)
    home = positions[0]
    n_shards = _n_shards(mesh, axis)
    keys = torch.as_tensor(keys, dtype=_F64,
                           device=home if len(positions) == 1 else None)
    keys = keys.reshape(-1)
    n = keys.shape[0]
    if n == 0:
        raise ValueError("build_sharded needs at least one key")
    bounds = shard_bounds(keys, n_shards)
    cap = max(int(np.diff(bounds).max()), 1)
    splits = torch.as_tensor(_splits_from_bounds(keys, bounds), device=home)
    parts, valid = [], []
    for dev, lo, k in _layout(positions, n_shards):
        shards, roots, leaves, elos, ehis = [], [], [], [], []
        for s in range(lo, lo + k):
            part = keys[int(bounds[s]):int(bounds[s + 1])].to(dev)
            idx = rmi_mod.build_rmi(
                part, n_leaves=n_leaves, kind="linear",
                pool=None if pool is None else pool.replica(dev), device=dev)
            shards.append(tlk.pad_capacity(part, cap))
            valid.append(part.shape[0])
            roots.append(idx.root)
            leaves.append(idx.leaves)
            elos.append(idx.err_lo)
            ehis.append(idx.err_hi)
        parts.append(ShardStack(
            keys=torch.stack(shards), root=_stack_params(roots),
            leaves=_stack_params(leaves), err_lo=torch.stack(elos),
            err_hi=torch.stack(ehis), n_leaves=n_leaves))
    iters = tlk.search_iters(_at_home([p.err_lo for p in parts], home),
                             _at_home([p.err_hi for p in parts], home), cap)
    for p in parts:
        p.search_iters = iters
    return ShardedIndex(
        mesh=mesh, axis=axis, splits=splits, parts=parts,
        valid=torch.as_tensor(valid, dtype=_I64, device=home),
        n_leaves=n_leaves, search_iters=iters)


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
    The budget is the reference's, whatever the positions: reckoned on the
    home device over the whole batch.  ``path`` as in ``core.paths``: the
    kernel path is one launch of the shard-stacked K1 a mesh position
    (``kernels.ops.sharded_index_lookup_all`` through :func:`_exchange`),
    the f64 path a verified window search a shard."""
    S, cap = index.n_shards, index.cap
    home = index.device
    iters = index.search_iters
    parts = index.parts
    layout = _layout(index.positions, S)
    use_kernel = resolve_path(path, f32_exact=lambda: index.f32_exact,
                              device=home, what="sharded key space")
    tabs = [p.kernel_tables() for p in parts] if use_kernel else None
    member = _at_home([_member(p.keys[:, 0]) for p in parts], home)

    def local_f64(i, j, q):
        p = parts[i]
        b = rmi_mod.root_buckets("linear", _row(p.root, j), q,
                                 index.n_leaves, cap)
        lo, hi = rmi_mod.leaf_window("linear", _row(p.leaves, j),
                                     p.err_lo[j], p.err_hi[j], b, q, cap)
        return (rmi_mod.verified_search(p.keys[j], q, lo, hi, iters=iters),)

    def call(i, qf, rid):
        t = tabs[i]
        return ((qf, rid, t["roots"], t["mats"], t["vecs"], t["keys"]),
                dict(n_leaves=index.n_leaves, iters=iters, rows=t["rows"],
                     fences=t["fences"], tabs=t["tabs"]))

    def lookup(q_global) -> torch.Tensor:
        q = torch.as_tensor(q_global, dtype=_F64, device=home).reshape(-1)
        dest, order, ds, qm, live = _grouped(index.splits, member, q)
        (r,) = _exchange(
            ds, qm, layout, (_I32,), f64_row=local_f64,
            kernel=(ops.sharded_index_lookup_all, call) if use_kernel
            else None)
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


def _row_f64_answer(st: dict, part: dict, r: int, q: torch.Tensor,
                    rng: bool, n_leaves: int, route_n: float):
    """Row ``r`` of the position ``part`` of the stack ``st``: its f64
    answer (the reference's jnp body): route at the row's scale ``route_n``
    over ``n_leaves`` leaves, window, two-tier tail over the row's padded
    tiers at the stack's depth."""
    b = rmi_mod.root_buckets("linear", _row(part["root"], r), q, n_leaves,
                             route_n)
    lo, hi = rmi_mod.leaf_window(st["leaf_kind"], _row(part["leaves"], r),
                                 part["err_lo"][r], part["err_hi"][r], b, q,
                                 st["bcap"])
    args = (part["base"][r], part["bpsum"][r], part["dk"][r],
            part["dpsum"][r])
    if rng:
        return two_tier_range_answer(*args, q, q, lo, hi, st["iters"])
    found, rank, _ = two_tier_answer(*args, q, lo, hi, st["iters"])
    return found, rank


def _answer_grouped(grouped, offs: torch.Tensor, layout: list, rng: bool,
                    kernel, f64_row):
    """Answers of a batch grouped by row (:func:`_group`) over a stack laid
    out on mesh positions (``layout``, as :func:`_exchange` takes it): one
    launch of the shard-stacked K2 (or, with ``rng``, K3) a position when
    ``kernel`` -- ``kernel(i)`` giving position i's (stacked tables, MLP
    leaf rows, descriptors, keywords) -- is given, else ``f64_row(i, local
    row, queries)`` a row; then each row's live offset ``offs[r]`` added
    on the home device and the answers put back in the batch's order:
    (found, rank), or (rank_lo, rank_hi) of each query as a point range.
    Non-live queries answer (False, 0) / (0, 0)."""
    order, ds, qm, live = grouped

    def call(i, qf, rid):
        tables, rows, tabs, kw = kernel(i)
        if rng:
            return (qf, qf, rid, *tables), dict(tabs=tabs, **kw)
        return (qf, rid, *tables), dict(rows=rows, tabs=tabs, **kw)

    multi = ops.sharded_range_lookup_all if rng \
        else ops.sharded_dynamic_find_all
    a, b = _exchange(ds, qm, layout, (_I32 if rng else torch.bool, _I32),
                     kernel=None if kernel is None else (multi, call),
                     f64_row=f64_row)
    off = offs[ds.long()]
    zero = torch.zeros_like(off)
    if rng:
        a = torch.where(live, a.to(_I32) + off, zero)
    else:
        a = a & live
    b = torch.where(live, b.to(_I32) + off, zero)
    return _scatter_back(order, a, b)


def _pad_rows(a: torch.Tensor, c: int) -> torch.Tensor:
    return torch.cat([a, a.new_zeros((c - a.shape[0],))])


def _pad_psum(a: torch.Tensor, c: int) -> torch.Tensor:
    """Edge-pad a prefix-sum vector to ``c + 1`` entries."""
    return torch.cat([a, a[-1:].expand(c + 1 - a.shape[0])])


@dataclass
class ShardedDynamicIndex:
    """Range-partitioned two-tier dynamic index (module docstring: layout,
    slice cache and rebalance policy).  Mutations run a shard at a time
    (each shard a ``core.updates.DynamicRMI`` on its mesh position's
    device); finds read the shards' slices stacked a position, maintained
    O(touched shards) a mutation, and answer a batch with one launch a
    position."""
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
    # Restack generations: ``_row_gen[s]`` is the generation of the restack
    # that last wrote row s of the stack (each restack one past the newest).
    # Rows are rewritten in place, so a reader of the stack
    # (``serve.frontend.TenantPack``) learns which rows changed from these,
    # not from the tensors' identity.
    _row_gen: np.ndarray = None

    @classmethod
    def build(cls, keys, mesh, axis: str = "data", n_leaves: int = 256,
              pool=None, eps: float = 0.9,
              rebalance_ratio: float | None = 0.5,
              rebalance_skew: float = 2.0, *, device=None, **rmi_kwargs):
        """Partition sorted ``keys`` with :func:`shard_bounds` and build
        one ``DynamicRMI`` a shard on its mesh position's device (with
        ``mesh.devices`` None, on ``device``: CUDA unless
        ``device="cpu"``)."""
        rmi_kwargs.setdefault("kind", "linear")
        if rmi_kwargs.get("root_kind", "linear") != "linear":
            raise ValueError(
                "ShardedDynamicIndex requires a monotone (linear) root: "
                "split routing and run snapping assume key order")
        positions = mesh.positions(device)
        keys = torch.as_tensor(
            keys, dtype=_F64,
            device=positions[0] if len(positions) == 1 else None).reshape(-1)
        n_shards = _n_shards(mesh, axis)
        bounds = shard_bounds(keys, n_shards)
        shards = []
        for dev, lo, k in _layout(positions, n_shards):
            shards += [DynamicRMI.build(
                keys[int(bounds[s]):int(bounds[s + 1])],
                pool=None if pool is None else pool.replica(dev), eps=eps,
                n_leaves=n_leaves, device=dev, **rmi_kwargs)
                for s in range(lo, lo + k)]
        idx = cls(mesh=mesh, axis=axis,
                  splits=_splits_from_bounds(keys, bounds), shards=shards,
                  eps=eps, n_leaves=n_leaves, pool=pool,
                  rebalance_ratio=rebalance_ratio,
                  rebalance_skew=rebalance_skew, build_kwargs=rmi_kwargs)
        idx._init_maintenance()
        return idx

    def _init_maintenance(self) -> None:
        """Seed the counter table, the mutes, the drift table and the host
        capacity/depth mirrors (the one full scan outside a cold restack),
        on the home device."""
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
        self._drift = torch.stack([self._drift_row(d) for d in self.shards])

    @staticmethod
    def _count_row(d: DynamicRMI) -> list:
        return [d.base_n, d.base_dead_count, d.delta_live,
                d.delta_dead_count]

    def _drift_row(self, d: DynamicRMI) -> torch.Tensor:
        """A shard's [score, drifted] row on the home device."""
        return drift_mod.state_row(d.drift, self.device).to(self.device)

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
            [self._drift_row(self.shards[s]) for s in ids]))

    # -- shape / placement / bookkeeping -------------------------------------
    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def positions(self) -> tuple:
        """The device of each mesh position (the home device first)."""
        return self.mesh.devices or (self.shards[0].device,)

    @property
    def device(self) -> torch.device:
        """The home device: batches, answers, the counter table, the mutes
        and the drift rows live there."""
        return self.positions[0]

    def shard_device(self, s: int) -> torch.device:
        """The device of shard ``s``: its mesh position's."""
        P = self.positions
        return P[s * len(P) // self.n_shards]

    def _pool_on(self, dev: torch.device):
        return None if self.pool is None else self.pool.replica(dev)

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
        """:meth:`live_keys` on the home device."""
        return torch.cat([d.live_keys_tensor().to(self.device)
                          for d in self.shards])

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
        everything (one giant run) is skipped.  The run crosses as host
        keys, so the two shards may sit on different positions' devices."""
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
        dev = self.shard_device(s)
        self.shards[s] = DynamicRMI.build(
            torch.as_tensor(keys, dtype=_F64), pool=self._pool_on(dev),
            eps=self.eps, n_leaves=self.n_leaves, device=dev,
            **self.build_kwargs)

    # -- drift maintenance -------------------------------------------------
    def drift_scores(self) -> np.ndarray:
        """(n_shards, 2) [KS score, drifted latch] (one host read; zeros
        when monitoring is off)."""
        return self._drift.cpu().numpy()

    def maybe_swap(self) -> int:
        """Pool hot-swap pass over the drift-latched shards (and those with
        deferred over-budget refits), each on its own device with its
        position's pool replica; swapped shards go through the dirty rows.
        Returns the number of leaves swapped across all shards."""
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
    # The stack is one dict of what every position shares -- capacity
    # classes, depth, and on the home device the splits, live offsets and
    # each shard's member key -- and ``parts``, one dict a position on its
    # device: its shards' rows of every stacked tensor, and its kernel
    # tables and descriptors.
    _ROW_KEYS = ("route_n", "base", "bdead", "bpsum", "dk", "ddead",
                 "dpsum", "err_lo", "err_hi")

    def _slice_rows(self, s: int, bcap: int, dcap: int) -> dict:
        """One shard's slices, padded to the global capacity classes: the
        unit of incremental restacking."""
        d = self.shards[s]
        return dict(
            route_n=torch.tensor(d.route_n, dtype=_F64, device=d.device),
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

    def _refresh_globals(self, st: dict) -> None:
        """The home device's share of the stack: splits, live offsets, each
        shard's member key (:func:`_member`)."""
        st["splits"] = torch.as_tensor(self.splits, dtype=_F64,
                                       device=self.device)
        st["offs"] = _offs(self._counts)
        st["member"] = _at_home([_member(p["base"][:, 0])
                                 for p in st["parts"]], self.device)

    def _restack_full(self, bcap: int, dcap: int) -> dict:
        """Cold assembly over every shard, a position at a time; shards
        that arrived oversized without passing through ``_touch`` (a
        restored or resharded index) step their capacities down first."""
        for s, d in enumerate(self.shards):
            if d.shrink_capacity():
                self.capacity_shrinks += 1
                self._bcaps[s] = d.index.keys.shape[0]
                self._dcaps[s] = d.delta_keys.shape[0]
                self._iters_vec[s] = d.index.search_iters
        bcap = int(self._bcaps.max())  # tracelint: ok[hot-sync](np mirror)
        dcap = int(self._dcaps.max())  # tracelint: ok[hot-sync](np mirror)
        self._stack = None              # free the old stack first
        st = dict(
            bcap=bcap, dcap=dcap,
            leaf_kind=self.shards[0].index.leaf_kind,
            iters=int(self._iters_vec.max()),  # tracelint: ok[hot-sync](np mirror)
            parts=[])
        for dev, lo, k in _layout(self.positions, self.n_shards):
            ids = range(lo, lo + k)
            rows = [self._slice_rows(s, bcap, dcap) for s in ids]
            part = dict(
                device=dev, lo=lo, n=k, packed=None, tabs=None,
                root=_stack_params([self.shards[s].index.root for s in ids]),
                leaves=_stack_params([self.shards[s].index.leaves
                                      for s in ids]))
            for key in self._ROW_KEYS:
                part[key] = torch.stack([r[key] for r in rows])
                for r in rows:
                    del r[key]
            st["parts"].append(part)
        self._refresh_globals(st)
        gen = 1 if self._row_gen is None else self._row_gen.max() + 1
        self._row_gen = np.full(self.n_shards, gen, np.int64)
        self._stack = st
        self.restack_full += 1
        self._dirty.clear()
        return st

    def _restack_rows(self, st: dict, ids: list, bcap: int,
                      dcap: int) -> None:
        """Rewrite the dirty shards' rows of their positions' stacked
        tensors in place: one row scatter a tensor a touched position,
        O(touched) slice work."""
        iters = int(self._iters_vec.max())  # tracelint: ok[hot-sync](np mirror)
        for part in st["parts"]:
            lo = part["lo"]
            mine = [s for s in ids if lo <= s < lo + part["n"]]
            if not mine:
                if iters != st["iters"]:
                    part["tabs"] = None
                continue
            rows = [self._slice_rows(s, bcap, dcap) for s in mine]
            idx = torch.as_tensor([s - lo for s in mine], dtype=_I64,
                                  device=part["device"])
            for k in self._ROW_KEYS:
                scatter_rows_(part[k], idx, torch.stack([r[k] for r in rows]))
            for key in ("root", "leaves"):
                fresh = [getattr(self.shards[s].index, key) for s in mine]
                for t, *r in zip(part[key], *fresh, strict=True):
                    scatter_rows_(t, idx, torch.stack(r))
            if part["packed"] is not None:
                packs = [self._shard_pack(s, bcap, dcap) for s in mine]
                for k, t in part["packed"].items():
                    scatter_rows_(t, idx, torch.stack([p[k] for p in packs]))
            part["tabs"] = None
        st["iters"] = iters
        self._refresh_globals(st)
        self._row_gen[ids] = self._row_gen.max() + 1
        self.restack_rows += len(ids)
        self._dirty.clear()

    def _packed_stack(self, st: dict) -> list:
        """Each position's stacked kernel tables (built on the first
        kernel-path find, then maintained row by row by
        :meth:`_restack_rows`)."""
        for part in st["parts"]:
            if part["packed"] is None:
                lo = part["lo"]
                packs = [self._shard_pack(s, st["bcap"], st["dcap"])
                         for s in range(lo, lo + part["n"])]
                part["packed"] = {k: torch.stack([p[k] for p in packs])
                                  for k in packs[0]}
        return [part["packed"] for part in st["parts"]]

    def _kernel_args(self, st: dict, part: dict) -> tuple:
        """(stacked kernel tables, descriptors or None on the CPU, keyword
        arguments) of a shard-stacked K2/K3 call on the position ``part``:
        every shard routes at ratio 1 (its scale is folded into its root)
        and searches at the stack's depth."""
        if part["packed"] is None:
            self._packed_stack(st)
        pk = part["packed"]
        kw = dict(n_leaves=self.n_leaves, route_n=self.n_leaves,
                  iters=st["iters"], leaf_kind=st["leaf_kind"])
        if part["tabs"] is None and part["device"].type == "cuda":
            part["tabs"] = tlk.shard_tables(
                pk["roots"], pk["mats"], pk["vecs"], pk["kf"],
                n_leaves=self.n_leaves, route_n=self.n_leaves,
                iters=st["iters"], rows=pk.get("rows"),
                delta_keys=pk["dkf"])
        return pk, part["tabs"], kw

    def _grouped(self, st: dict, q: torch.Tensor):
        """:func:`_grouped` of a batch on the stack ``st``: what
        :meth:`_answer` gives the shard-stacked kernels."""
        return _grouped(st["splits"], st["member"], q)

    def _answer(self, q: torch.Tensor, use_kernel: bool, rng: bool):
        """Route, answer on each query's shard, scatter back: (found, rank)
        or, with ``rng``, (rank_lo, rank_hi) of each endpoint as a point
        range, global ranks; non-live queries answer (False, 0) / (0, 0)."""
        st = self._stacked()
        parts = st["parts"]
        _, *grouped = self._grouped(st, q)

        def kernel(i):
            part = parts[i]
            pk, tabs, kw = self._kernel_args(st, part)
            return ((pk["roots"], pk["mats"], pk["vecs"], pk["kf"],
                     part["bpsum"], pk["dkf"], part["dpsum"]),
                    pk.get("rows"), tabs, kw)

        def f64_row(i, j, x):
            part = parts[i]
            return _row_f64_answer(
                st, part, j, x, rng, self.n_leaves,
                float(self.shards[part["lo"] + j].route_n))

        layout = [(p["device"], p["lo"], p["n"]) for p in parts]
        return _answer_grouped(grouped, st["offs"], layout, rng,
                               kernel if use_kernel else None, f64_row)

    def _use_kernel(self, path: str) -> bool:
        return resolve_path(path, f32_exact=lambda: self.f32_exact,
                            device=self.device, what="sharded key space")

    def _as_queries(self, q) -> torch.Tensor:
        return torch.as_tensor(q, dtype=_F64,
                               device=self.device).reshape(-1).contiguous()

    def find(self, queries, *, path: str = "auto"):
        """(found, global live rank) per query: each query routes to its
        shard by the split vector and is answered there -- on the kernel
        path by one launch of the shard-stacked K2 a mesh position
        (``kernels.ops.sharded_dynamic_find_all`` through
        :func:`_exchange`), on the f64 path by each shard's two-tier find
        -- with the shard's live offset added.  ``path`` as in
        ``core.paths``."""
        q = self._as_queries(queries)
        return tuple(self._answer(q, self._use_kernel(path), rng=False))

    def find_range(self, q_lo, q_hi, *, path: str = "auto"):
        """(rank_lo, rank_hi) global live ranks of the inclusive ranges
        ``[q_lo[i], q_hi[i]]``: both endpoint arrays routed as one batch,
        each endpoint answered by its own shard with its left and right
        rank (one launch of the shard-stacked K3 a position on the kernel
        path); rank_lo comes from the lo endpoint's shard, rank_hi from the
        hi endpoint's, clamped to rank_lo so degenerate ranges come back
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


# ---------------------------------------------------------------------------
# Tenant-stacked answers: several sharded indexes in one launch a position.
# ---------------------------------------------------------------------------
# Calls of the tenant-stacked find and range (the counterpart of the
# reference's trace counter ``TRACE_COUNTS``): the serve front-end makes
# one of each a batch, each one launch of the shard-stacked K2 / K3 a mesh
# position on the kernel path.
TENANT_CALLS = {"tenant_find": 0, "tenant_range": 0}


def tenant_row(t: int, s: int, n_tenants: int, k: int) -> int:
    """Row of (tenant ``t``, shard ``s``) in a tenant pack whose positions
    hold ``k`` shards each: position-major, so that a position's rows are
    consecutive (``s // k`` the position, ``t * k + s % k`` the row in
    it).  With one position, ``t * S + s``."""
    return (s // k) * (n_tenants * k) + t * k + s % k


def _tenant_grouped(pack: dict, qmat: torch.Tensor):
    """A (T, Q) query matrix routed to its rows of the tenant pack (query
    of tenant t, shard s: row :func:`tenant_row`) and grouped by row:
    :func:`_group`'s order, row ids, queries and live mask."""
    T, S = qmat.shape[0], pack["n_shards"]
    k = S // len(pack["parts"])
    dest = torch.searchsorted(pack["splits"], qmat)
    dest = torch.where(torch.isnan(qmat), S - 1, dest)
    t = torch.arange(T, device=qmat.device)[:, None]
    row = ((dest // k) * (T * k) + t * k + dest % k).reshape(-1).to(_I32)
    return _group(row, pack["member"], qmat.reshape(-1))


def _tenant_kernel_args(pack: dict, part: dict) -> tuple:
    """(stacked tables, MLP leaf rows, descriptors, keywords) of the
    shard-stacked K2 / K3 over the position ``part`` of a tenant pack:
    every row routes at ratio 1 over the pack's ``n_leaves`` and searches
    at the pack's depth."""
    L = pack["n_leaves"]
    return ((part["roots"], part["mats"], part["vecs"], part["kf"],
             part["bpsum"], part["dkf"], part["dpsum"]), part.get("rows"),
            part["tabs"], dict(n_leaves=L, route_n=L, iters=pack["iters"],
                               leaf_kind=pack["leaf_kind"]))


def tenant_stacked_answer(pack: dict, qmat: torch.Tensor, *,
                          use_kernel: bool, rng: bool):
    """Answer a (T, Q) f64 query matrix, row t for tenant t, over the
    tenant pack ``pack`` (``serve.frontend.TenantPack``: T tenants of S
    shards each as T x S rows, a mesh position's T x S / D rows stacked on
    its device): the counterpart of the reference's
    ``_tenant_stacked_find_fn`` (``rng`` False: (found, rank)) and
    ``_tenant_stacked_range_fn`` (``rng`` True: each query's (rank_lo,
    rank_hi) as a point range), both (T, Q).

    A query of tenant t routes by that tenant's split vector to its shard
    s and is answered on row :func:`tenant_row` of (t, s), its rank offset
    by that row's ``offs``, the tenant's live keys in shards < s.  On the
    kernel path the whole matrix is one launch of the shard-stacked K2 (or
    K3) a position (:func:`_exchange`), every row routed at ratio 1 with
    the pack's ``n_leaves`` (each tenant's routing scale folded into its
    packed roots, its leaf tables padded with its last live leaf) and
    searched at the pack's depth; on the f64 path each row's two-tier
    answer, routed at the row's ``route_n`` (the shard's frozen scale times
    ``n_leaves / L_t``, the reference's rescale).  Non-live queries (+inf,
    NaN) answer (False, 0) / (0, 0)."""
    T, Q = qmat.shape
    TENANT_CALLS["tenant_range" if rng else "tenant_find"] += 1
    parts = pack["parts"]

    def f64_row(i, j, x):
        part = parts[i]
        return _row_f64_answer(pack, part, j, x, rng, pack["n_leaves"],
                               float(pack["route_n"][part["lo"] + j]))

    layout = [(p["device"], p["lo"], p["n"]) for p in parts]
    a, b = _answer_grouped(
        _tenant_grouped(pack, qmat), pack["offs"], layout, rng,
        (lambda i: _tenant_kernel_args(pack, parts[i])) if use_kernel
        else None, f64_row)
    return a.reshape(T, Q), b.reshape(T, Q)
