"""Paged KV cache with a learned page table (a port of
``repro.serve.kvcache``: ``PagedKVCache`` and ``learned_page_table``).

vLLM-style paging: the logical KV sequence of each request is scattered
over fixed-size physical pages; a page table maps (request, logical_block)
-> physical page.  The pool is managed on the host (allocation is control
plane); the page array lives on the device.  The learned table indexes the
sorted packed keys ``(request << 22) | block`` with the paper's RMI and
answers through ``core.rmi.lookup``: with ``path="auto"`` on the card and an
f32-exact key space (packed keys below 2^24, i.e. requests 0-3) that is
kernel K1.  ``DynamicPageTable`` waits for ROADMAP queue 1 item 12.
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
