"""``repro_torch.api`` — the facade over the dynamic index (counterpart of
``repro.api``): the single-host ``core.updates.DynamicRMI``
(``mesh=None``) or the range-partitioned
``core.distributed.ShardedDynamicIndex`` (``mesh=ShardMesh(n)``, its shards
stacked on the one device).

  =============  ====================================================
  verb           backend call
  =============  ====================================================
  find           ``backend.find(q, path=...)`` -> (found, rank)
  find_range     ``backend.find_range(lo, hi, path=...)``
  insert         ``backend.insert_batch(keys)``
  delete         ``backend.delete_batch(keys)``
  gather         ``backend.live_keys()[ranks]``
  gather_range   ``backend.gather_range(rank_lo, rank_hi)``
  maybe_swap     ``backend.maybe_swap()`` (drift maintenance)
  drift_scores   ``core.drift.state_row(backend.drift)`` as a (1, 2) row
                 | ``backend.drift_scores()`` (n_shards, 2)
  snapshot       ``core.persist.snapshot_dynamic`` |
                 ``core.persist.snapshot_sharded``
  restore        ``core.persist.restore_dynamic`` |
                 ``core.persist.restore_sharded`` (reshards onto the
                 mesh's shard count)
  =============  ====================================================

``find``/``find_range`` return tensors on the index's device; ``gather``,
``gather_range`` and ``live_keys`` return host numpy, as in the reference.
``pool=`` (a ``core.reuse.ModelPool`` on the index's device) serves
Algorithm-1 reuse at build, on every rebuild of an MLP leaf and in the
drift hot-swaps (``drift_bins=``, ``swap_on_drift=``).  A snapshot is in
the reference's file format, so either package restores the other's.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np

from .core import drift as drift_mod
from .core import persist as persist_mod
from .core.distributed import ShardedDynamicIndex
from .core.updates import DynamicRMI, _host_ints

__all__ = ["Index", "build_index"]


def _as_store(src) -> persist_mod.SnapshotStore:
    if isinstance(src, persist_mod.SnapshotStore):
        return src
    return persist_mod.SnapshotStore(str(src))


@dataclass
class Index:
    """One dynamic learned index; every verb forwards to the backend."""
    backend: DynamicRMI | ShardedDynamicIndex

    @classmethod
    def build(cls, keys, *, mesh=None, axis: str = "data", pool=None,
              device=None, **kwargs) -> "Index":
        """Build over sorted ``keys`` on ``device`` (CUDA unless
        ``device="cpu"``).  ``mesh=None`` builds a ``DynamicRMI``; a
        ``core.distributed.ShardMesh`` a ``ShardedDynamicIndex`` over
        ``mesh.shape[axis]`` shards.  ``kwargs`` go to the backend's
        ``build`` (``n_leaves``, ``kind``, ``eps``, ``reuse_on_rebuild``,
        ``drift_bins``, ``drift_hi``, ``drift_lo``, ``swap_on_drift``,
        ...)."""
        if mesh is None:
            return cls(DynamicRMI.build(keys, pool=pool, device=device,
                                        **kwargs))
        return cls(ShardedDynamicIndex.build(keys, mesh, axis=axis,
                                             pool=pool, device=device,
                                             **kwargs))

    @property
    def sharded(self) -> bool:
        return isinstance(self.backend, ShardedDynamicIndex)

    # -- queries -----------------------------------------------------------
    def find(self, queries, *, path: str = "auto"):
        """(found, rank) tensors per query; rank is the leftmost live rank,
        indexing :meth:`gather`'s key order."""
        return self.backend.find(queries, path=path)

    def find_range(self, q_lo, q_hi, *, path: str = "auto"):
        """(rank_lo, rank_hi) live ranks of the inclusive ranges
        ``[q_lo[i], q_hi[i]]`` (degenerate ranges come back empty)."""
        return self.backend.find_range(q_lo, q_hi, path=path)

    # -- mutation ----------------------------------------------------------
    def insert(self, keys) -> None:
        self.backend.insert_batch(keys)

    def delete(self, keys) -> None:
        self.backend.delete_batch(keys)

    # -- materialization ---------------------------------------------------
    def gather(self, ranks) -> np.ndarray:
        """Keys at the given live ranks (what :meth:`find` returned)."""
        return self.backend.live_keys()[_host_ints(ranks).astype(np.int64)]

    def gather_range(self, rank_lo, rank_hi) -> list[np.ndarray]:
        """Per-range sorted live keys of :meth:`find_range` spans."""
        return self.backend.gather_range(rank_lo, rank_hi)

    def live_keys(self) -> np.ndarray:
        return self.backend.live_keys()

    @property
    def live_count(self) -> int:
        return int(self.backend.total_live if self.sharded
                   else self.backend.live_count)

    # -- drift maintenance -------------------------------------------------
    def maybe_swap(self) -> int:
        """One drift-maintenance pass: bound-checked pool hot-swaps while
        the drift latch is set, then the deferred refits (a no-op without
        ``drift_bins``).  Returns the number of leaves swapped."""
        return self.backend.maybe_swap()

    def drift_scores(self) -> np.ndarray:
        """(n_shards, 2) [KS score, drifted latch] rows (host numpy; one
        row single-host); all zero when drift monitoring is off."""
        if self.sharded:
            return self.backend.drift_scores()
        row = drift_mod.state_row(self.backend.drift, self.backend.device)
        return row.cpu().numpy()[None]

    # -- durability --------------------------------------------------------
    def snapshot(self, store, step: int = 0, *, blocking: bool = True,
                 include_pool: bool = True) -> None:
        """Write one checksummed, atomically committed snapshot into
        ``store`` (a ``core.persist.SnapshotStore`` or a directory path).
        The drift monitor's state rides the snapshot."""
        snap = persist_mod.snapshot_sharded if self.sharded \
            else persist_mod.snapshot_dynamic
        snap(_as_store(store), step, self.backend, blocking=blocking,
             include_pool=include_pool)

    @classmethod
    def restore(cls, store, *, mesh=None, axis: str = "data",
                step: int | None = None, device=None) -> "Index":
        """Restore from the newest verifiable snapshot in ``store`` (or
        exactly ``step``) onto ``device`` (CUDA unless ``device="cpu"``).
        ``mesh=None`` restores the single-host backend; a ``ShardMesh`` the
        sharded one, resharded onto its shard count."""
        st = _as_store(store)
        if mesh is None:
            backend, _ = persist_mod.restore_dynamic(st, step=step,
                                                     device=device)
        else:
            backend, _ = persist_mod.restore_sharded(st, mesh, axis,
                                                     step=step, device=device)
        return cls(backend)


def build_index(keys, **kwargs) -> Index:
    """Deprecated alias of :meth:`Index.build`."""
    warnings.warn("build_index() is deprecated; use Index.build()",
                  DeprecationWarning, stacklevel=2)
    return Index.build(keys, **kwargs)
