"""Batched serving front-end for sharded dynamic indexes (counterpart of
``repro.serve.frontend``).

Pipeline::

    submit() -> request queue -> AdaptiveBatcher -> TenantPack.find -> scatter
                                     |                    |
                          coalesce up to the        one launch of the
                          latency budget (or        shard-stacked K2 over
                          the batch-size cap)       every tenant's shards,
                                                    padded to pow2 classes

* **Coalescing**: requests wait at most ``ServeConfig.latency_budget_s``
  from the *oldest* queued request; a batch also cuts early when the
  queued key count reaches ``max_batch``.
* **Capacity-class padding**: the live batch pads to
  ``kernels.lookup.capacity_class`` widths (pow2, 128 floor), as in the
  reference, whose jitted dispatch then never retraces.  The port traces
  nothing; the classes bound the shapes a batch can take (what a CUDA
  graph a class would need) and the pad work, which ``FrontendStats``
  counts.
* **Multi-tenant stacked dispatch**: N independent ``ShardedDynamicIndex``
  tenants on one mesh answer a batch in one call of
  ``core.distributed.tenant_stacked_answer``: one launch of the
  shard-stacked K2 (finds) and one of K3 (ranges) a mesh position, over
  the T x S / D rows of (tenant, shard) the position holds.  Tenants of different build sizes share the
  launch: tiers pad to the cross-tenant maximum capacity classes (+inf
  keys, edge-extended prefix sums), leaf tables pad to the widest tenant
  with the last live leaf replicated (``lookup.pad_packed_leaves``), and
  each tenant's routing scale rides its packed roots (kernel path) or the
  row's ``route_n`` (f64 path).  ``core.distributed.TENANT_CALLS`` counts
  the calls and ``kernels.lookup.LAUNCHES`` the launches.
* **Pipelined dispatch**: up to ``pipeline_depth`` batches are in flight
  before the oldest resolves, as in the reference.  In the port ``find``
  already reads to the host inside (the seam-miss count, the row counts of
  the f64 path), so a dispatched batch is mostly done when its call
  returns: the depth orders resolution, it overlaps little.
* **Find/update interleaving**: insert/delete requests coalesce into the
  same batches and apply *before* the batch's finds dispatch.  Each tenant
  rewrites its dirty shard rows in place; the pack learns which rows
  changed from the tenant's restack generations (``_row_gen``), since an
  in-place write keeps the tensors' identity, and rewrites those rows of
  its own stack in place.
* **Range requests** (``submit_range``): inclusive key ranges ``[lo, hi]``
  -> global live ranks ``(rank_lo, rank_hi)``, ``rank_hi`` clamped so
  degenerate ranges come back empty.  Ranges coalesce into the same
  batches as point finds but go on their own ``[lo | hi]`` matrix with
  its own capacity class.  Both endpoints count toward ``max_batch``.
* **Typed requests**: every submission surface funnels through
  ``submit(Request(tenant, kind, payload))``; payload validation (the kind
  filter, the finiteness check that protects the +inf-padded delta tier,
  range endpoint pairing) lives in the :class:`Request` constructor.
* **Idle-window drift maintenance**: when the queue drains after a batch,
  the dispatcher thread gives each tenant one pool hot-swap pass
  (``ShardedDynamicIndex.maybe_swap``), between batches.  A pass that
  raises is counted (``FrontendStats.maintain_failures``, the error kept
  in ``maintain_error``) and the loop serves on.

Threads: the dispatcher thread makes every torch call of a batch, on the
mesh's devices and their default streams; a batch is staged on the home
device, where its answers come back.  While the front-end runs it owns
its tenants: a caller that mutates or queries a tenant directly from
another thread races the dispatcher (updates go through the queue).  A
batch that fails fails its callers and never stops the loop.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core import distributed as dist_mod
from ..core.paths import resolve_path
from ..kernels import lookup as tlk
from ..kernels.lookup import capacity_class, pad_packed_leaves

_F64 = torch.float64


@dataclass
class ServeConfig:
    """Front-end knobs (see module docstring for the contract)."""
    latency_budget_s: float = 2e-3    # max coalesce wait from oldest request
    max_batch: int = 4096             # early-cut key-count cap per batch
    batch_floor: int = 128            # capacity-class floor for query rows
    pipeline_depth: int = 2           # batches in flight


REQUEST_KINDS = ("find", "range", "insert", "delete")


class Request:
    """One typed serving request, and the future its caller waits on.

    Validation lives here, for every submission surface:

      * ``kind`` must be one of ``find | range | insert | delete`` (an
        unknown kind would fall through the dispatcher's kind filters and
        leave its caller waiting forever);
      * keys coerce to f64 and must be finite, for every kind: a NaN or
        +-inf insert or delete would poison the sorted delta tier (+inf is
        its pad), and a non-finite find or range key would walk the rank
        algebra into the capacity padding;
      * a range's payload is the (2, n) ``[lo; hi]`` endpoint stack.
    """
    __slots__ = ("tenant", "kind", "keys", "arrival", "done_at", "found",
                 "rank", "rank_lo", "rank_hi", "error", "_event")

    def __init__(self, tenant: int, kind: str, keys,
                 arrival: float | None = None):
        if kind not in REQUEST_KINDS:
            raise ValueError(
                f"kind must be one of {REQUEST_KINDS}, got {kind!r}")
        try:
            keys = np.asarray(keys, np.float64)
        except ValueError as e:           # a ragged payload
            raise ValueError(f"{kind} payload is ragged: range endpoint "
                             "arrays must pair up") from e
        if kind == "range":
            if keys.ndim != 2 or keys.shape[0] != 2:
                raise ValueError(
                    "range payload must be the (2, n) [lo; hi] endpoint "
                    "stack: endpoint arrays must pair up")
        else:
            keys = np.atleast_1d(keys)
            if keys.ndim != 1:
                raise ValueError(f"{kind} payload must be a key vector, "
                                 f"got shape {keys.shape}")
        if not np.all(np.isfinite(keys)):
            raise ValueError(f"{kind} keys must be finite")
        self.tenant = int(tenant)
        self.kind = kind          # one of REQUEST_KINDS
        self.keys = keys          # (n,) keys; ranges carry (2, n) endpoints
        self.arrival = arrival    # stamped by submit() when None
        self.done_at = None       # completion time (front-end clock)
        self.found = None
        self.rank = None
        self.rank_lo = None
        self.rank_hi = None
        self.error = None
        self._event = threading.Event()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None):
        """Block until served.  Finds return ``(found, rank)`` numpy
        arrays, ranges ``(rank_lo, rank_hi)``; updates return ``None``
        once applied."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"request not served within {timeout}s")
        if self.error is not None:
            raise self.error
        if self.kind == "find":
            return self.found, self.rank
        if self.kind == "range":
            return self.rank_lo, self.rank_hi
        return None


class AdaptiveBatcher:
    """Pure coalescing policy, no threads, injectable clock.

    A batch becomes ready when the *oldest* pending request has waited the
    latency budget, or the queued key count reaches ``max_batch``.
    """

    def __init__(self, latency_budget_s: float, max_batch: int,
                 clock=time.monotonic):
        self.latency_budget_s = float(latency_budget_s)
        self.max_batch = int(max_batch)
        self.clock = clock
        self._pending: list[Request] = []
        self._n_keys = 0

    def __len__(self) -> int:
        return len(self._pending)

    def offer(self, req: Request) -> None:
        self._pending.append(req)
        self._n_keys += req.keys.size

    def deadline(self) -> float | None:
        """Absolute time the current batch must cut at (None when empty)."""
        if not self._pending:
            return None
        return self._pending[0].arrival + self.latency_budget_s

    def ready(self, now: float | None = None) -> bool:
        if not self._pending:
            return False
        if self._n_keys >= self.max_batch:
            return True
        return (self.clock() if now is None else now) >= self.deadline()

    def cut(self) -> list[Request]:
        batch, self._pending, self._n_keys = self._pending, [], 0
        return batch


def _put(dst: torch.Tensor, r: int, src: torch.Tensor, pad) -> None:
    """Row ``r`` of ``dst`` = ``src`` padded on its first axis to the row's
    width with ``pad``, or with its last entry when ``pad`` is None; in
    place."""
    w = src.shape[0]
    dst[r, :w] = src
    dst[r, w:] = src[-1] if pad is None else pad


class TenantPack:
    """N tenants' shards as one stack of T x S rows, padded to the
    cross-tenant capacity classes, and maintained incrementally: a batch
    rewrites in place only the rows whose tenant restacked them since the
    last batch, and re-assembles the pack cold only when a cross-tenant
    capacity class crosses a power of two.  The tenants share one mesh:
    each of its D positions holds the T x S / D rows of the shards it owns
    on its device (``core.distributed.tenant_row`` numbers them), and a
    batch is one stacked launch a position.

    Counters, as the reference counts them: ``pack_full`` cold assemblies,
    ``pack_rows`` tenants whose rows were rewritten (one a tenant a
    batch)."""

    def __init__(self, tenants: list, *, path: str = "auto"):
        if not tenants:
            raise ValueError("TenantPack needs at least one tenant")
        t0 = tenants[0]
        if any(t.mesh != t0.mesh or t.axis != t0.axis
               or t.positions != t0.positions for t in tenants):
            raise ValueError("tenants must share one mesh: its shard count, "
                             "axis and devices")
        kinds = {t.shards[0].index.leaf_kind for t in tenants}
        if len(kinds) != 1:
            raise ValueError(f"tenants must share one leaf kind: {kinds}")
        self.tenants = list(tenants)
        self.mesh, self.axis, self.device = t0.mesh, t0.axis, t0.device
        self.positions = t0.positions
        self.use_kernel = resolve_path(
            path, f32_exact=lambda: all(t.f32_exact for t in tenants),
            device=self.device, what="tenant key space")
        self.leaf_kind = kinds.pop()
        self.n_leaves = max(t.n_leaves for t in tenants)
        # common packed lane count: the widest tenant's 128-multiple
        self._lp = -(-self.n_leaves // 128) * 128
        T, S = self.n_tenants, self.n_shards
        k = S // len(self.positions)
        # each tenant's row of every shard, on the home device
        self._rows = torch.as_tensor(
            [[dist_mod.tenant_row(t, s, T, k) for s in range(S)]
             for t in range(T)], dtype=torch.int64, device=self.device)
        self._st: dict | None = None
        self._seen: list | None = None    # _row_gen copies at the last write
        self.pack_full = 0                # cold pack assemblies
        self.pack_rows = 0                # tenants' rows rewritten in place

    @property
    def n_tenants(self) -> int:
        return len(self.tenants)

    @property
    def n_shards(self) -> int:
        return self.tenants[0].n_shards

    # -- assembly ----------------------------------------------------------
    def _allocate(self, sts: list, bcap: int, dcap: int) -> dict:
        """Empty pack tensors for the geometry (bcap, dcap): the f64 path's
        or the kernel path's, not both; what every position shares on the
        home device, and each position's rows on its own."""
        T, S, L, home = self.n_tenants, self.n_shards, self.n_leaves, \
            self.device
        TS = T * S
        new = lambda shape, dtype, dev=home: torch.empty(shape, dtype=dtype,
                                                         device=dev)
        pk = dict(n_shards=S, n_leaves=L, leaf_kind=self.leaf_kind,
                  bcap=bcap, dcap=dcap, iters=None,
                  splits=new((T, S - 1), _F64),
                  offs=new((TS,), torch.int32),
                  member=new((TS,), _F64),
                  route_n=np.zeros(TS, np.float64), parts=[])
        for p, (dev, _, k) in enumerate(dist_mod._layout(self.positions,
                                                          S)):
            n = T * k
            part = dict(device=dev, lo=p * n, n=n, tabs=None,
                        bpsum=new((n, bcap + 1), torch.int32, dev),
                        dpsum=new((n, dcap + 1), torch.int32, dev))
            st0 = sts[0]["parts"][p]
            if self.use_kernel:
                p0 = st0["packed"]
                part.update(
                    roots=new((n,) + tuple(p0["roots"].shape[1:]),
                              torch.float32, dev),
                    mats=new((n, p0["mats"].shape[1], self._lp),
                             torch.float32, dev),
                    vecs=new((n, p0["vecs"].shape[1], self._lp),
                             torch.float32, dev),
                    kf=new((n, bcap), torch.float32, dev),
                    dkf=new((n, dcap), torch.float32, dev))
                if self.leaf_kind == "mlp":
                    w = tlk.leaf_rows(p0["mats"][0], p0["vecs"][0], "mlp") \
                        .shape[1:]
                    part["rows"] = new((n, self._lp) + tuple(w),
                                       torch.float32, dev)
            else:
                alloc = lambda f0, width: type(f0)(*(
                    new((n,) + ((width,) if width else ()) + tuple(
                        f.shape[2 if width else 1:]), f.dtype, dev)
                    for f in f0))
                part.update(root=alloc(st0["root"], None),
                            leaves=alloc(st0["leaves"], L),
                            err_lo=new((n, L), _F64, dev),
                            err_hi=new((n, L), _F64, dev),
                            base=new((n, bcap), _F64, dev),
                            dk=new((n, dcap), _F64, dev))
            pk["parts"].append(part)
        return pk

    def _write(self, i: int, ids, st: dict) -> None:
        """Rewrite tenant ``i``'s rows of its shards ``ids`` in the pack
        from its stack ``st``, in place, and its splits and offsets."""
        pk, S, L = self._st, self.n_shards, self.n_leaves
        t = self.tenants[i]
        lt = t.n_leaves
        k = S // len(pk["parts"])
        inf = float("inf")
        pk["splits"][i] = st["splits"]
        pk["offs"][self._rows[i]] = st["offs"]
        for s in ids:
            # sync: ok(shard ids are host numpy: np.arange or np.flatnonzero)
            s = int(s)
            p, j = divmod(s, k)
            r = dist_mod.tenant_row(i, s, self.n_tenants, k)
            part, src = pk["parts"][p], st["parts"][p]
            lr = r - part["lo"]
            pk["member"][r] = st["member"][s]
            # the reference's rescale: the frozen scale times L / L_t
            pk["route_n"][r] = np.float64(t.shards[s].route_n) * (
                np.float64(L) / np.float64(lt))
            _put(part["bpsum"], lr, src["bpsum"][j], None)
            _put(part["dpsum"], lr, src["dpsum"][j], None)
            if self.use_kernel:
                pp = src["packed"]
                part["roots"][lr] = pp["roots"][j]
                mat, vec = pad_packed_leaves(pp["mats"][j], pp["vecs"][j], lt,
                                             self._lp)
                part["mats"][lr], part["vecs"][lr] = mat, vec
                if "rows" in part:
                    part["rows"][lr] = tlk.leaf_rows(mat, vec,
                                                     self.leaf_kind)
                _put(part["kf"], lr, pp["kf"][j], inf)
                _put(part["dkf"], lr, pp["dkf"][j], inf)
            else:
                for dst, f in zip(part["root"], src["root"], strict=True):
                    dst[lr] = f[j]
                for dst, f in zip(part["leaves"], src["leaves"],
                                  strict=True):
                    _put(dst, lr, f[j], None)
                _put(part["err_lo"], lr, src["err_lo"][j], None)
                _put(part["err_hi"], lr, src["err_hi"][j], None)
                _put(part["base"], lr, src["base"][j], inf)
                _put(part["dk"], lr, src["dk"][j], inf)

    def _refresh(self) -> dict:
        sts = [t._stacked() for t in self.tenants]
        if self.use_kernel:
            for t, st in zip(self.tenants, sts, strict=True):
                t._packed_stack(st)
        bcap = max(st["bcap"] for st in sts)
        dcap = max(st["dcap"] for st in sts)
        full = self._st is None or (bcap, dcap) != (self._st["bcap"],
                                                    self._st["dcap"])
        # A tenant's restacks (rows or whole) give the rows they write a
        # new generation, so the rows whose generation moved are exactly
        # the ones to copy.
        stale = {i: np.arange(self.n_shards) if full else
                 # sync: ok(np mirror: the tenants' restack generations)
                 np.flatnonzero(t._row_gen != self._seen[i])
                 for i, t in enumerate(self.tenants)}
        stale = {i: ids for i, ids in stale.items() if ids.size}
        if self.use_kernel:
            for i in stale:
                if not self.tenants[i].f32_exact:
                    raise ValueError(
                        f"tenant {i}'s key space is no longer f32-exact: "
                        "the pack's kernel path would answer wrong")
        if full:
            self._st = None               # free the old pack first
            self._st = self._allocate(sts, bcap, dcap)
            self.pack_full += 1
        for i, ids in stale.items():
            self._write(i, ids, sts[i])
        if not full:
            self.pack_rows += len(stale)
        self._seen = [t._row_gen.copy() for t in self.tenants]
        iters = max(st["iters"] for st in sts)
        pk = self._st
        if iters != pk["iters"]:
            pk["iters"] = iters
            for part in pk["parts"]:
                part["tabs"] = None
        for part in pk["parts"] if self.use_kernel else ():
            if part["tabs"] is None and part["device"].type == "cuda":
                part["tabs"] = tlk.shard_tables(
                    part["roots"], part["mats"], part["vecs"], part["kf"],
                    n_leaves=self.n_leaves, route_n=self.n_leaves,
                    iters=iters, rows=part.get("rows"),
                    delta_keys=part["dkf"])
        return pk

    # -- dispatch ----------------------------------------------------------
    def _matrix(self, qmat) -> torch.Tensor:
        # sync: ok(the batch's query matrix uploaded, one copy a call)
        qmat = torch.as_tensor(qmat, dtype=_F64, device=self.device)
        if qmat.dim() != 2 or qmat.shape[0] != self.n_tenants:
            raise ValueError(f"bad query matrix {tuple(qmat.shape)}: want "
                             f"({self.n_tenants}, Q)")
        return qmat.contiguous()

    def find(self, qmat) -> tuple[torch.Tensor, torch.Tensor]:
        """One stacked find: ``qmat`` is (n_tenants, qcap) f64, row t the
        queries of tenant t (callers pad to ``capacity_class`` widths).
        Returns (found, rank) as (n_tenants, qcap) tensors on the mesh's
        home device, each tenant's global live ranks."""
        st = self._refresh()
        return dist_mod.tenant_stacked_answer(
            st, self._matrix(qmat), use_kernel=self.use_kernel, rng=False)

    def find_range(self, rmat) -> tuple[torch.Tensor, torch.Tensor]:
        """One stacked range call: ``rmat`` is (n_tenants, 2 * rcap) f64
        laid out [lo endpoints | hi endpoints] a row.  Returns (rank_lo,
        rank_hi) as (n_tenants, rcap) tensors, rank_hi clamped to
        rank_lo."""
        st = self._refresh()
        rmat = self._matrix(rmat)
        if rmat.shape[1] % 2:
            raise ValueError(f"bad range matrix {tuple(rmat.shape)}: want "
                             f"({self.n_tenants}, 2 * rcap)")
        rl, rr = dist_mod.tenant_stacked_answer(
            st, rmat, use_kernel=self.use_kernel, rng=True)
        rcap = rmat.shape[1] // 2
        rank_lo = rl[:, :rcap]
        return rank_lo, torch.maximum(rr[:, rcap:], rank_lo)


@dataclass
class FrontendStats:
    batches: int = 0              # stacked dispatches
    queries: int = 0              # live find keys served
    ranges: int = 0               # live range pairs served
    updates: int = 0              # insert/delete keys applied
    swaps: int = 0                # drift-maintenance pool hot-swaps
    padded_slots: int = 0         # pad lanes dispatched (wasted work)
    maintain_failures: int = 0    # idle-window passes that raised
    qcaps: set = field(default_factory=set)   # capacity classes seen

    @property
    def pad_fraction(self) -> float:
        tot = self.queries + 2 * self.ranges + self.padded_slots
        return self.padded_slots / tot if tot else 0.0


class _InFlight:
    __slots__ = ("found", "rank", "plan", "rank_lo", "rank_hi", "rplan")

    def __init__(self, found, rank, plan, rank_lo=None, rank_hi=None,
                 rplan=()):
        self.found, self.rank, self.plan = found, rank, plan
        self.rank_lo, self.rank_hi, self.rplan = rank_lo, rank_hi, rplan


class BatchingFrontend:
    """The serving loop: a dispatcher thread drains the request queue
    through the batcher into stacked dispatches (module docstring).  Use
    as a context manager, or ``start()``/``stop()`` explicitly."""

    def __init__(self, tenants: list, *, path: str = "auto",
                 config: ServeConfig | None = None, clock=time.monotonic):
        self.config = config or ServeConfig()
        self.pack = TenantPack(tenants, path=path)
        self.stats = FrontendStats()
        self.clock = clock
        self.batcher = AdaptiveBatcher(self.config.latency_budget_s,
                                       self.config.max_batch, clock)
        self._cond = threading.Condition()
        self._inflight: deque[_InFlight] = deque()
        self._stop = False
        self._thread: threading.Thread | None = None
        self.maintain_error: Exception | None = None   # the last one

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "BatchingFrontend":
        if self._thread is not None:
            raise RuntimeError("frontend already started")
        self._stop = False
        self._thread = threading.Thread(target=self._loop,
                                        name="serve-frontend", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    __enter__ = start

    def __exit__(self, *exc) -> None:
        self.stop()

    def warmup(self, batch_sizes=(1,)) -> None:
        """Run the stacked find AND range once for each capacity class the
        given live batch sizes land in (plus the floor), so that the pack
        is assembled, its descriptors built and the kernels loaded before
        traffic.  Call before opening the queue to traffic."""
        T, S = self.pack.n_tenants, self.pack.n_shards
        zeros = lambda w: torch.zeros((T, w), dtype=_F64,
                                      device=self.pack.device)
        for n in {capacity_class(int(n), self.config.batch_floor)
                  for n in batch_sizes} | {self.config.batch_floor}:
            qcap = max(n, S)
            found, _ = self.pack.find(zeros(qcap))
            rlo, _ = self.pack.find_range(zeros(2 * qcap))
            found.cpu()
            rlo.cpu()

    # -- submission --------------------------------------------------------
    def submit(self, request: Request) -> Request:
        """Enqueue one constructed :class:`Request` (payload validation
        already ran in its constructor): checks that the front-end runs
        and knows the tenant, stamps the arrival clock and offers the
        request to the coalescer.  The ``submit_*`` wrappers below all
        funnel through here."""
        if self._thread is None:
            raise RuntimeError("frontend not started")
        if not 0 <= request.tenant < self.pack.n_tenants:
            raise ValueError(f"unknown tenant {request.tenant}")
        if request.arrival is None:
            request.arrival = self.clock()
        with self._cond:
            self.batcher.offer(request)
            self._cond.notify_all()
        return request

    def submit_find(self, tenant: int, keys) -> Request:
        return self.submit(Request(tenant, "find", keys))

    def submit_range(self, tenant: int, lo_keys, hi_keys) -> Request:
        """Inclusive key ranges ``[lo, hi]`` -> ``(rank_lo, rank_hi)``
        global live ranks.  Both endpoint arrays count toward the batch key
        cap."""
        return self.submit(Request(tenant, "range", [
            np.atleast_1d(lo_keys), np.atleast_1d(hi_keys)]))

    def submit_insert(self, tenant: int, keys) -> Request:
        return self.submit(Request(tenant, "insert", keys))

    def submit_delete(self, tenant: int, keys) -> Request:
        return self.submit(Request(tenant, "delete", keys))

    def lookup(self, tenant: int, keys, timeout: float | None = 60.0):
        """Synchronous convenience: submit one find and wait."""
        return self.submit_find(tenant, keys).result(timeout)

    def scan(self, tenant: int, lo_keys, hi_keys,
             timeout: float | None = 60.0):
        """Synchronous convenience: submit one range request and wait."""
        return self.submit_range(tenant, lo_keys, hi_keys).result(timeout)

    # -- the serving loop --------------------------------------------------
    def _collect(self) -> list | None:
        """Block for the next batch: wait for a first request, then
        coalesce until the batcher's deadline (or size cap).  Returns None
        on shutdown with nothing pending."""
        with self._cond:
            while not len(self.batcher):
                if self._stop:
                    return None
                self._cond.wait(timeout=0.05)
            while not self._stop and not self.batcher.ready():
                dl = self.batcher.deadline()
                self._cond.wait(timeout=max(dl - self.clock(), 0.0))
            return self.batcher.cut()

    def _apply_updates(self, batch: list) -> None:
        """Mutations coalesced into this batch apply before its finds
        dispatch; a "range" request is a query, never a delete."""
        for req in batch:
            if req.kind in ("find", "range"):
                continue
            try:
                tenant = self.pack.tenants[req.tenant]
                if req.kind == "insert":
                    tenant.insert_batch(req.keys)
                else:
                    tenant.delete_batch(req.keys)
                self.stats.updates += req.keys.size
            except Exception as e:          # broad: fail the caller
                req.error = e
            req.done_at = self.clock()
            req._event.set()

    def _dispatch(self, batch: list) -> _InFlight | None:
        finds = [r for r in batch if r.kind == "find"]
        rngs = [r for r in batch if r.kind == "range"]
        if not finds and not rngs:
            return None
        T, S = self.pack.n_tenants, self.pack.n_shards
        found = rank = rlo = rhi = None
        plan, rplan = [], []            # (req, tenant, start, stop)
        self.stats.batches += 1
        if finds:
            counts = [0] * T
            for r in finds:
                t = r.tenant
                plan.append((r, t, counts[t], counts[t] + r.keys.size))
                counts[t] += r.keys.size
            qcap = max(capacity_class(max(counts), self.config.batch_floor),
                       S)
            qmat = np.zeros((T, qcap), np.float64)
            for r, t, a, b in plan:
                qmat[t, a:b] = r.keys
            live = sum(counts)
            self.stats.queries += live
            self.stats.padded_slots += qmat.size - live
            self.stats.qcaps.add(qcap)
            found, rank = self.pack.find(torch.from_numpy(qmat))
        if rngs:
            # Ranges ride their own [lo block | hi block] matrix with their
            # own capacity class: range traffic is usually far sparser than
            # point traffic.
            rcounts = [0] * T
            for r in rngs:
                t = r.tenant
                n = r.keys.shape[1]
                rplan.append((r, t, rcounts[t], rcounts[t] + n))
                rcounts[t] += n
            rcap = max(capacity_class(max(rcounts), self.config.batch_floor),
                       S)
            rmat = np.zeros((T, 2 * rcap), np.float64)
            for r, t, a, b in rplan:
                rmat[t, a:b] = r.keys[0]
                rmat[t, rcap + a:rcap + b] = r.keys[1]
            rlive = sum(rcounts)
            self.stats.ranges += rlive
            self.stats.padded_slots += rmat.size - 2 * rlive
            self.stats.qcaps.add(rcap)
            rlo, rhi = self.pack.find_range(torch.from_numpy(rmat))
        return _InFlight(found, rank, plan, rlo, rhi, rplan)

    def _resolve(self, inf: _InFlight) -> None:
        """The one host read of a batch's answers, scattered to its
        callers."""
        if inf.plan:
            # sync: ok(the host read of a batch's answers: found)
            found = inf.found.cpu().numpy()
            # sync: ok(the host read of a batch's answers: rank)
            rank = inf.rank.cpu().numpy()
            now = self.clock()
            for req, t, a, b in inf.plan:
                req.found = found[t, a:b]
                req.rank = rank[t, a:b]
                req.done_at = now
                req._event.set()
        if inf.rplan:
            # sync: ok(the host read of a batch's answers: rank_lo)
            rlo = inf.rank_lo.cpu().numpy()
            # sync: ok(the host read of a batch's answers: rank_hi)
            rhi = inf.rank_hi.cpu().numpy()
            now = self.clock()
            for req, t, a, b in inf.rplan:
                req.rank_lo = rlo[t, a:b]
                req.rank_hi = rhi[t, a:b]
                req.done_at = now
                req._event.set()

    def _fail(self, batch: list, err: Exception) -> None:
        for req in batch:
            if not req._event.is_set():
                req.error = err
                req.done_at = self.clock()
                req._event.set()

    def _maintain(self) -> None:
        """Idle-window drift maintenance, on the dispatcher thread between
        batches when the queue has drained: one pool hot-swap pass per
        tenant (``ShardedDynamicIndex.maybe_swap``: bound-checked leaf
        swaps on the drift-latched shards, and the deferred refits of
        over-budget leaves).  Swapped rows reach the pack through the
        tenant's restack generations.  Tenants without drift monitoring
        return at once."""
        for t in self.pack.tenants:
            self.stats.swaps += t.maybe_swap()

    def _loop(self) -> None:
        while True:
            batch = self._collect()
            if batch is None:
                break
            try:
                self._apply_updates(batch)
                inf = self._dispatch(batch)
            except Exception as e:          # broad: fail the batch
                self._fail(batch, e)
                continue
            if inf is not None:
                self._inflight.append(inf)
            while len(self._inflight) >= self.config.pipeline_depth or \
                    (self._inflight and not len(self.batcher)):
                self._resolve_or_fail(self._inflight.popleft())
            if not len(self.batcher):
                try:
                    self._maintain()
                except Exception as e:      # broad: keep serving
                    self.stats.maintain_failures += 1
                    self.maintain_error = e
        while self._inflight:
            self._resolve_or_fail(self._inflight.popleft())

    def _resolve_or_fail(self, inf: _InFlight) -> None:
        try:
            self._resolve(inf)
        except Exception as e:              # broad: fail the batch
            self._fail([p[0] for p in (*inf.plan, *inf.rplan)], e)
