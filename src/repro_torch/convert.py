"""Carry an index's weights and state across into the port.

Both functions take a dict of numpy arrays and scalars, so any producer
(the reference package, a file) can hand its tables over without this
package importing it.  With the same arrays, both packages answer from
identical tables.

Static index (:func:`rmi_from_arrays`):
  ``keys`` (sorted, possibly +inf padded), ``root_a``, ``root_b``,
  ``leaf_a``, ``leaf_b``, ``err_lo``, ``err_hi``, ``reused``,
  ``leaf_sim``, ``n_leaves``, and optionally ``iters`` (the search depth;
  derived from the bounds when absent).

Dynamic index (:func:`dynamic_from_arrays`), in addition:
  ``route_n``, ``base_n``, ``base_dead``, ``delta_keys``, ``delta_leaf``,
  ``delta_dead``, ``n_inserts``, ``budget``, ``win`` (per-leaf window
  widths), optionally ``eps`` (default 0.9).  Tombstone prefix sums and
  the live/dead counters are recomputed.
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .core import models
from .core.rmi import RMIIndex
from .core.updates import DynamicRMI, _psum

_F64 = torch.float64


def rmi_from_arrays(arrays: dict, *, device=None) -> RMIIndex:
    """The port's ``RMIIndex`` over the given tables (linear/linear)."""
    dev = resolve_device(device)
    t = lambda k, dt=_F64: torch.as_tensor(np.array(arrays[k]), dtype=dt,
                                           device=dev)
    idx = RMIIndex(
        keys=t("keys"), root_kind="linear",
        root=models.LinearParams(a=t("root_a").reshape(()),
                                 b=t("root_b").reshape(())),
        leaf_kind="linear",
        leaves=models.LinearParams(a=t("leaf_a"), b=t("leaf_b")),
        err_lo=t("err_lo"), err_hi=t("err_hi"),
        n_leaves=int(arrays["n_leaves"]),
        reused_mask=t("reused", torch.bool), leaf_sim=t("leaf_sim"))
    if "iters" in arrays:
        idx._iters = int(arrays["iters"])
    return idx


def dynamic_from_arrays(arrays: dict, *, device=None) -> DynamicRMI:
    """The port's ``DynamicRMI`` over the given tiers and tables."""
    idx = rmi_from_arrays(arrays, device=device)
    dev = idx.device
    t = lambda k, dt: torch.as_tensor(np.array(arrays[k]), dtype=dt,
                                      device=dev)
    base_dead = t("base_dead", torch.bool)
    dk = t("delta_keys", _F64)
    ddead = t("delta_dead", torch.bool)
    return DynamicRMI(
        index=idx, eps=float(arrays.get("eps", 0.9)),
        route_n=int(arrays["route_n"]),
        delta_keys=dk, delta_leaf=t("delta_leaf", torch.int32),
        delta_dead=ddead, delta_psum=_psum(ddead),
        delta_live=int((torch.isfinite(dk) & ~ddead).sum()),
        delta_dead_count=int(ddead.sum()),
        base_n=int(arrays["base_n"]), base_dead=base_dead,
        base_psum=_psum(base_dead), base_dead_count=int(base_dead.sum()),
        n_inserts=np.array(arrays["n_inserts"], np.int64),
        budget=np.array(arrays["budget"], np.float64),
        _win=np.array(arrays["win"], np.float64))
