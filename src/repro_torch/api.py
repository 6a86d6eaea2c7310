"""``repro_torch.api`` — the facade over the dynamic index (counterpart of
``repro.api``), single host.

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
  =============  ====================================================

``find``/``find_range`` return tensors on the index's device; ``gather``,
``gather_range`` and ``live_keys`` return host numpy, as in the reference.
``pool=`` (a ``core.reuse.ModelPool`` on the index's device) serves
Algorithm-1 reuse at build, on every rebuild of an MLP leaf and in the
drift hot-swaps (``drift_bins=``, ``swap_on_drift=``).  Sharding
(``mesh=``) and snapshots are not ported yet and raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import not_ported
from .core import drift as drift_mod
from .core.updates import DynamicRMI, _host_ints

__all__ = ["Index"]


@dataclass
class Index:
    """One dynamic learned index; every verb forwards to the backend."""
    backend: DynamicRMI

    @classmethod
    def build(cls, keys, *, mesh=None, pool=None, device=None,
              **kwargs) -> "Index":
        """Build over sorted ``keys`` on ``device`` (CUDA unless
        ``device="cpu"``); ``kwargs`` go to ``DynamicRMI.build``
        (``n_leaves``, ``kind``, ``eps``, ``reuse_on_rebuild``,
        ``drift_bins``, ``drift_hi``, ``drift_lo``, ``swap_on_drift``,
        ...)."""
        if mesh is not None:
            raise not_ported("the sharded index (mesh=)", "11")
        return cls(DynamicRMI.build(keys, pool=pool, device=device, **kwargs))

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
        return int(self.backend.live_count)

    # -- drift maintenance -------------------------------------------------
    def maybe_swap(self) -> int:
        """One drift-maintenance pass: bound-checked pool hot-swaps while
        the drift latch is set, then the deferred refits (a no-op without
        ``drift_bins``).  Returns the number of leaves swapped."""
        return self.backend.maybe_swap()

    def drift_scores(self) -> np.ndarray:
        """(1, 2) [KS score, drifted latch] (host numpy); all zero when
        drift monitoring is off."""
        row = drift_mod.state_row(self.backend.drift, self.backend.device)
        return row.cpu().numpy()[None]

    # -- not yet ported ----------------------------------------------------
    def snapshot(self, store, step: int = 0, **kwargs) -> None:
        raise not_ported("snapshots", "10")

    @classmethod
    def restore(cls, store, **kwargs) -> "Index":
        raise not_ported("restore", "10")
