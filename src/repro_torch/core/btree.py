"""Array-based static B+tree baseline (counterpart of ``repro.core.btree``;
the paper's competitor #1, STX-like).

Implicit layout: level l holds the separator keys of its nodes
contiguously; a lookup descends with one fanout-wide compare per level,
vectorized over the queries.  The build is one bottom-up pass on the
device, which is why the paper finds the B+tree's build time unbeatable.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import resolve_device

_F64 = torch.float64


@dataclass
class BTreeIndex:
    keys: torch.Tensor          # (n,) sorted f64 leaf level
    levels: list                # (n_l,) f64 separator tensors, root last
    fanout: int

    @property
    def n(self) -> int:
        return int(self.keys.shape[0])

    @property
    def height(self) -> int:
        return len(self.levels)

    @property
    def device(self) -> torch.device:
        return self.keys.device


def build_btree(keys, fanout: int = 16, *, device=None) -> BTreeIndex:
    """Bottom-up bulk load on ``device`` (CUDA unless ``device="cpu"``):
    level l+1 holds every fanout-th key of level l (each node's max)."""
    keys = torch.as_tensor(keys, dtype=_F64, device=resolve_device(device))
    levels = []
    cur = keys
    while cur.shape[0] > fanout:
        cur = cur[fanout - 1::fanout].contiguous()
        levels.append(cur)
    return BTreeIndex(keys=keys, levels=levels, fanout=fanout)


def lookup(index: BTreeIndex, queries) -> torch.Tensor:
    """Left-boundary rank of each query (first key >= q), int32, clipped
    to [0, n] (the semantics of ``rmi.lookup``)."""
    q = torch.as_tensor(queries, dtype=_F64, device=index.device)
    return _btree_lookup(index.keys, index.levels, index.fanout, q)


def _below(level: torch.Tensor, node: torch.Tensor, fanout: int,
           q: torch.Tensor) -> torch.Tensor:
    """Child rank of each query under ``node``: the node's separators
    [node*fanout, node*fanout + fanout) that lie below it (slots past the
    level's end count as not below)."""
    m = level.shape[0]
    cand = node[:, None] * fanout + torch.arange(fanout, device=q.device)
    below = (level[cand.clamp(0, m - 1)] < q[:, None]) & (cand < m)
    return node * fanout + below.sum(1)


def _btree_lookup(keys, levels: list, fanout: int, q):
    node = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    for lvl in reversed(levels):
        node = _below(lvl, node, fanout, q)
    return _below(keys, node, fanout, q).clamp(0, keys.shape[0]) \
        .to(torch.int32)
