"""Paged KV cache with a learned page table (a port of
``repro.serve.kvcache``: ``PagedKVCache``, ``learned_page_table`` and
``DynamicPageTable``).

vLLM-style paging: the logical KV sequence of each request is scattered
over fixed-size physical pages; a page table maps (request, logical_block)
-> physical page.  The pool is managed on the host (allocation is control
plane); the page array lives on the device.  The learned tables index the
sorted packed keys ``(request << 22) | block``:

* ``learned_page_table``: a static RMI over a snapshot of the table,
  answering through ``core.rmi.lookup``;
* ``DynamicPageTable``: the two-tier dynamic index (``core.updates
  .DynamicRMI``, or ``core.distributed.ShardedDynamicIndex`` with
  ``mesh=``), which allocations and releases mutate through its batched
  insert and delete, answering through its ``find``.

With ``path="auto"`` on the card a lookup takes the kernels while the key
space is f32-exact -- packed keys below 2^24, i.e. requests 0-3: K1 for
the static table, K2 (or the shard-stacked K2) for the dynamic one.  From
request 4 on the packed keys do not round-trip through f32, and the
lookups take the exact f64 path; ``path="kernel"`` raises there.  The
layout is the reference's, kept so that both packages pack the same keys.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .. import resolve_device
from ..core import rmi as rmi_mod
from ..core.paths import resolve_path

# Packed block-key layout: key = (request_id << _BLOCK_BITS) | logical_block.
_BLOCK_BITS = 22


@dataclass
class PagedKVCache:
    n_pages: int
    page_size: int
    n_kv_heads: int
    head_dim: int
    n_layers: int
    dtype: torch.dtype = torch.bfloat16
    device: object = None
    kv: torch.Tensor = None              # (L, 2, n_pages, page, H, dh)
    free: list = None
    table: dict = field(default_factory=dict)   # (req, block) -> page

    def __post_init__(self):
        if self.kv is None:
            self.kv = torch.zeros(
                (self.n_layers, 2, self.n_pages, self.page_size,
                 self.n_kv_heads, self.head_dim), dtype=self.dtype,
                device=resolve_device(self.device))
        if self.free is None:
            self.free = list(range(self.n_pages))

    # -- control plane -----------------------------------------------------
    def allocate(self, req: int, logical_block: int) -> int:
        if not self.free:
            raise MemoryError("KV page pool exhausted")
        page = self.free.pop()
        self.table[(req, logical_block)] = page
        return page

    def allocate_batch(self, req: int, logical_blocks) -> np.ndarray:
        """Pops len(blocks) pages in one slice (a request's prefill
        blocks at once)."""
        blocks = list(logical_blocks)
        if not blocks:
            return np.empty((0,), np.int32)
        if len(self.free) < len(blocks):
            raise MemoryError("KV page pool exhausted")
        pages = self.free[-len(blocks):][::-1]
        del self.free[-len(blocks):]
        self.table.update(((req, b), p) for b, p in zip(blocks, pages,
                                                        strict=True))
        return np.asarray(pages, np.int32)

    def release(self, req: int) -> None:
        for key in [k for k in self.table if k[0] == req]:
            self.free.append(self.table.pop(key))

    def pages_for(self, req: int, n_blocks: int) -> np.ndarray:
        return np.asarray([self.table[(req, b)] for b in range(n_blocks)],
                          np.int32)

    # -- data plane ----------------------------------------------------------
    def write(self, layer: int, req_pages, pos_in_page: int,
              k: torch.Tensor, v: torch.Tensor) -> None:
        """Write one token's K/V for a batch of requests, in place."""
        pages = torch.as_tensor(np.asarray(req_pages), dtype=torch.long,
                                device=self.kv.device)
        self.kv[layer, 0, pages, pos_in_page] = k
        self.kv[layer, 1, pages, pos_in_page] = v

    def gather(self, layer: int, pages) -> tuple:
        """(k, v) of shape (n_blocks, page, H, dh) for one request."""
        p = torch.as_tensor(np.asarray(pages), dtype=torch.long,
                            device=self.kv.device)
        return self.kv[layer, 0, p], self.kv[layer, 1, p]


def learned_page_table(table: dict, *, path: str = "auto", device=None):
    """A learned index over the page table's packed key space, on
    ``device`` (CUDA unless ``device="cpu"``).

    Returns (lookup_fn, keys, pages): lookup_fn(query_keys) -> page ids
    through ``core.rmi.lookup`` with the error-window-clamped search depth.
    ``path="kernel"`` raises when the key space is not f32-exact (packed
    keys from request 4 on do not round-trip through f32)."""
    dev = resolve_device(device)
    items = sorted(table.items())
    keys = torch.tensor([float((r << _BLOCK_BITS) | b) for (r, b), _ in items],
                        dtype=torch.float64, device=dev)
    pages = torch.tensor([p for _, p in items], dtype=torch.int32, device=dev)
    idx = rmi_mod.build_rmi(keys, n_leaves=max(len(items) // 64, 1),
                            kind="linear", device=dev)
    kernel = resolve_path(path, f32_exact=lambda: idx.f32_exact, device=dev,
                          what="page-table key space")

    def lookup(query_keys) -> torch.Tensor:
        pos = rmi_mod.lookup(idx, query_keys,
                             path="kernel" if kernel else "jnp")
        return pages[pos.clamp(0, pages.shape[0] - 1).long()]

    return lookup, keys, pages


def _pack_keys(req: int, blocks) -> np.ndarray:
    return np.asarray([(req << _BLOCK_BITS) | int(b) for b in blocks],
                      np.float64)


@dataclass
class DynamicPageTable:
    """Learned page table served by the two-tier dynamic index: block
    allocation and release mutate the index through the batched
    insert/delete of ``core.updates.DynamicRMI`` (or of the sharded index)
    instead of rebuilding a static RMI, so the serving control plane runs
    the paper's §4 update path.

    The host array ``_pages`` is ordered by live key, which is exactly what
    ``find``'s rank indexes: a page lookup is one find (base window search
    + delta probe + tombstone mask) plus a gather."""
    cache: PagedKVCache
    dyn: object = None                   # DynamicRMI or ShardedDynamicIndex
    _keys: np.ndarray = None             # sorted live block keys
    _pages: np.ndarray = None            # aligned physical page ids

    @classmethod
    def build(cls, cache: PagedKVCache, mesh=None, axis: str = "data",
              **rmi_kwargs):
        """Bootstrap over the cache's current (non-empty) table; later
        allocations ride the delta tier until Lemma 4.1 triggers rebuilds.
        With ``mesh`` (a ``core.distributed.ShardMesh``) the table rides
        the sharded dynamic index: the same batched insert/delete/find,
        the block keys range-partitioned over the shards (and over the
        mesh's devices when it names them; lookups answer on its home
        device).  ``rmi_kwargs``
        go to the index's build (``device=``: CUDA unless ``"cpu"``)."""
        items = sorted(cache.table.items())
        if not items:
            raise ValueError("DynamicPageTable.build needs a primed cache")
        keys = np.asarray([float((r << _BLOCK_BITS) | b)
                           for (r, b), _ in items])
        pages = np.asarray([p for _, p in items], np.int32)
        rmi_kwargs.setdefault("n_leaves", max(len(items) // 64, 1))
        if mesh is not None:
            from ..core.distributed import ShardedDynamicIndex
            dyn = ShardedDynamicIndex.build(keys, mesh, axis=axis,
                                            **rmi_kwargs)
        else:
            from ..core.updates import DynamicRMI
            dyn = DynamicRMI.build(keys, **rmi_kwargs)
        return cls(cache=cache, dyn=dyn, _keys=keys, _pages=pages)

    def allocate(self, req: int, logical_blocks) -> np.ndarray:
        """Allocate pages for a request's blocks: one pool pop, one batched
        index insert, one vectorized merge of the page mapping."""
        pages = self.cache.allocate_batch(req, logical_blocks)
        kn = _pack_keys(req, logical_blocks)
        order = np.argsort(kn)
        kn, pages_sorted = kn[order], pages[order]
        self.dyn.insert_batch(kn)
        pos = np.searchsorted(self._keys, kn)
        self._keys = np.insert(self._keys, pos, kn)
        self._pages = np.insert(self._pages, pos, pages_sorted)
        return pages

    def release(self, req: int) -> None:
        """Release a request: one batched tombstone delete over its keys."""
        blocks = [b for (r, b) in self.cache.table if r == req]
        self.cache.release(req)
        if not blocks:
            return
        kn = _pack_keys(req, sorted(blocks))
        self.dyn.delete_batch(kn)
        live = (self._keys.astype(np.int64) >> _BLOCK_BITS) != req
        self._keys = self._keys[live]
        self._pages = self._pages[live]

    def lookup(self, query_keys) -> tuple[np.ndarray, np.ndarray]:
        """(found, page) per packed block key through the index's find
        (host numpy)."""
        found, rank = self.dyn.find(torch.as_tensor(
            np.asarray(query_keys, np.float64), device=self.dyn.device))
        found = found.cpu().numpy()
        if self._pages.size == 0:       # everything released
            return found, np.zeros(found.shape, np.int32)
        rank = np.clip(rank.cpu().numpy(), 0, self._pages.size - 1)
        return found, self._pages[rank]

    def maintenance_stats(self) -> dict:
        """Index-maintenance counters for the serving control plane:
        rebuild and compaction counts on a single-host table; with the
        sharded index, rebalances by kind and the restack accounting
        (``restack_rows`` grows with the touched shards of each allocate
        or release, ``restack_full`` only on capacity-class changes)."""
        d = self.dyn
        if hasattr(d, "shards"):        # ShardedDynamicIndex
            return dict(
                sharded=True,
                live=int(d.total_live),
                rebalances=int(d.rebalances),
                migrations_incremental=int(d.migrations_incremental),
                migrations_full=int(d.migrations_full),
                restack_full=int(d.restack_full),
                restack_rows=int(d.restack_rows),
                rebuilds=int(sum(s.rebuilds for s in d.shards)),
            )
        return dict(
            sharded=False,
            live=int(d.live_count),
            rebuilds=int(d.rebuilds),
            delta_compactions=int(d.delta_compactions),
            buffered=int(d.total_buffered),
        )
