"""IndexedDataset: sample key -> (shard, offset) resolution served by the
paper's agile-reuse learned index (counterpart of
``repro.data.indexed_dataset``).

Streaming corpora arrive as shards of sorted sample keys (document ids,
hash keys); resolving a sample key to its storage location is a learned
index lookup.  A new shard is indexed by reusing pool models (a histogram
and a selection instead of training), and appends and deletes ride the
dynamic index's batched §4 update path, where Lemma 4.1 decides which
leaf models rebuild.

Every shard's index lives on the pool's device (CUDA unless the pool was
built with ``device="cpu"``); on CUDA ``locate`` is kernel K2 and
``locate_range`` kernel K3, and each shard's pooled build selects its
leaves through K7.  The routing table and what the methods return are host
numpy, as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..core import reuse as reuse_mod
from ..core import synth
from ..core.bounds import _host
from ..core.updates import DynamicRMI, _host_ints


@dataclass
class ShardInfo:
    shard_id: int
    keys: np.ndarray              # sorted *live* sample keys (host)
    dyn: DynamicRMI               # two-tier dynamic index over the shard
    reuse_fraction: float

    @property
    def index(self):              # the underlying RMIIndex (base tier)
        return self.dyn.index


@dataclass
class IndexedDataset:
    """Sharded corpus with one learned index per shard + routing table."""
    pool: reuse_mod.ModelPool
    eps: float = 0.9
    n_leaves: int = 256
    shards: list = field(default_factory=list)
    boundaries: list = field(default_factory=list)   # max key per shard

    @classmethod
    def create(cls, eps: float = 0.9, kind: str = "linear",
               pool: reuse_mod.ModelPool | None = None, *, device=None,
               **kw):
        """A dataset served from ``pool``, or from a pool built here over
        ``synth.generate_pool(eps)`` on ``device`` (CUDA unless
        ``device="cpu"``)."""
        if pool is None:
            pool = reuse_mod.build_pool(synth.generate_pool(eps), kind=kind,
                                        device=device)
        return cls(pool=pool, eps=eps, **kw)

    @property
    def device(self) -> torch.device:
        return self.pool.device

    # -- ingest ------------------------------------------------------------
    def add_shard(self, keys) -> ShardInfo:
        """Index a new shard via agile model reuse (the paper's build
        path); the shard is served by a DynamicRMI so later appends and
        deletes ride the batched §4 update path instead of re-indexing."""
        k = torch.sort(torch.as_tensor(keys, dtype=torch.float64,
                                       device=self.device)).values
        dyn = DynamicRMI.build(k, pool=self.pool, eps=self.eps,
                               n_leaves=self.n_leaves, kind=self.pool.kind,
                               device=self.device)
        info = ShardInfo(shard_id=len(self.shards), keys=k.cpu().numpy(),
                         dyn=dyn, reuse_fraction=dyn.index.reuse_fraction)
        self.shards.append(info)
        self.boundaries.append(info.keys[-1])
        return info

    def append_to_shard(self, shard_id: int, keys) -> None:
        """Streaming ingest into an existing shard: one batched insert
        (Lemma 4.1 decides which leaf models rebuild).  Appended keys must
        stay below the next shard's boundary: shard routing is a
        searchsorted over the sorted boundary list, so an overreaching
        append would misroute every later query."""
        keys = _host(keys)
        if shard_id + 1 < len(self.boundaries) and keys.size and \
                keys.max() >= self.boundaries[shard_id + 1]:
            raise ValueError(
                f"append_to_shard({shard_id}): keys reach into shard "
                f"{shard_id + 1}'s range (>= {self.boundaries[shard_id + 1]})")
        info = self.shards[shard_id]
        info.dyn.insert_batch(keys)
        self._refresh(info)

    def delete_samples(self, shard_id: int, keys) -> None:
        """Batched tombstone delete of sample keys from a shard.  A fully
        drained shard keeps its old routing boundary (it answers
        found=False)."""
        info = self.shards[shard_id]
        info.dyn.delete_batch(_host(keys))
        self._refresh(info)

    def _refresh(self, info: ShardInfo) -> None:
        info.keys = info.dyn.live_keys()
        if info.keys.size:
            self.boundaries[info.shard_id] = info.keys[-1]

    # -- resolve -----------------------------------------------------------
    def locate(self, sample_keys) -> tuple[np.ndarray, np.ndarray]:
        """(shard_id, offset) per key, host int64.  Offsets are the dynamic
        find's two-tier live rank, so they stay exact under appended
        (delta-tier) and tombstoned samples."""
        q = _host(sample_keys)
        shard_of = np.searchsorted(np.asarray(self.boundaries), q,
                                   side="left")
        shard_of = np.clip(shard_of, 0, len(self.shards) - 1)
        offsets = np.empty(q.shape, np.int64)
        for sid in np.unique(shard_of):
            mask = shard_of == sid
            _, rank = self.shards[sid].dyn.find(q[mask])
            offsets[mask] = _host_ints(rank)
        return shard_of, offsets

    def locate_range(self, lo_keys, hi_keys) -> list[list[tuple]]:
        """Resolve inclusive key ranges ``[lo, hi]`` to their live sample
        keys: per input range, a list of (shard_id, keys) pieces in shard
        order.  Each touched shard answers one batched ``find_range``; a
        range spanning shard boundaries clamps its endpoints to each
        shard's live span (interior shards are taken whole; member keys
        keep every endpoint finite, so the +inf capacity padding never
        enters the rank algebra).  Tombstoned samples are excluded and
        degenerate ranges (lo > hi, wholly out of range) come back
        empty."""
        lo, hi = _host(lo_keys), _host(hi_keys)
        if lo.shape != hi.shape:
            raise ValueError("locate_range endpoint arrays must pair up")
        if not (np.all(np.isfinite(lo)) and np.all(np.isfinite(hi))):
            raise ValueError("range endpoints must be finite")
        bounds = np.asarray(self.boundaries)
        ns = len(self.shards)
        # A range touches every shard from lo's owner through hi's owner.
        s_lo = np.clip(np.searchsorted(bounds, lo, side="left"), 0, ns - 1)
        s_hi = np.clip(np.searchsorted(bounds, hi, side="left"), 0, ns - 1)
        s_hi = np.maximum(s_hi, s_lo)
        pieces: list[dict] = [dict() for _ in range(lo.shape[0])]
        for sid in range(ns):
            rid = np.flatnonzero((s_lo <= sid) & (sid <= s_hi))
            if rid.size == 0:
                continue
            dyn = self.shards[sid].dyn
            live = dyn.live_keys()
            if live.size == 0:
                continue
            ql = np.where(s_lo[rid] == sid, lo[rid], live[0])
            qh = np.where(s_hi[rid] == sid, hi[rid], live[-1])
            rl, rh = dyn.find_range(ql, qh)
            for r, a, b in zip(rid, _host_ints(rl), _host_ints(rh),
                               strict=True):
                pieces[r][sid] = live[int(a):int(b)]
        return [[(sid, piece[sid]) for sid in sorted(piece)
                 if piece[sid].size] for piece in pieces]

    @property
    def mean_reuse(self) -> float:
        return float(np.mean([s.reuse_fraction for s in self.shards])) \
            if self.shards else 0.0



def synthetic_token_stream(key: int, vocab: int, batch: int, seq: int):
    """Deterministic synthetic LM batches (zipf-ish unigram): the
    reference's generator (``numpy.random.default_rng(key)``, the same draws
    in the same order), so both packages yield equal arrays.  Yields host
    numpy ``(inputs, labels)``, each (batch, seq) int32, the labels the
    inputs shifted by one."""
    rng = np.random.default_rng(key)
    ranks = np.arange(1, vocab + 1)
    probs = 1.0 / ranks ** 1.1
    probs /= probs.sum()
    while True:
        toks = rng.choice(vocab, size=(batch, seq + 1), p=probs)
        yield toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)
