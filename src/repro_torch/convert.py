"""Carry an index's weights and state -- or a model pool -- across into the
port.

Every function takes a dict of numpy arrays and scalars, so any producer
(the reference package, a file) can hand its tables over without this
package importing it.  With the same arrays, both packages answer from
identical tables.

Model parameters (``_params``): ``<prefix>_a``/``<prefix>_b`` for a linear
model, ``<prefix>_w1``/``_b1``/``_w2``/``_b2`` for the 1x4 MLP, with the
kind under ``<prefix>_kind`` (default "linear").

Static index (:func:`rmi_from_arrays`):
  ``keys`` (sorted, possibly +inf padded), root params under ``root``,
  leaf params under ``leaf``, ``err_lo``, ``err_hi``, ``reused``,
  ``leaf_sim``, ``n_leaves``, and optionally ``iters`` (the search depth;
  derived from the bounds when absent).

Dynamic index (:func:`dynamic_from_arrays`), in addition:
  ``route_n``, ``base_n``, ``base_dead``, ``delta_keys``, ``delta_leaf``,
  ``delta_dead``, ``n_inserts``, ``budget``, ``win`` (per-leaf window
  widths), optionally ``eps`` (default 0.9), ``reuse_on_rebuild``,
  ``swap_on_drift``, ``swaps_committed`` and ``swap_rejects``; the pool and
  the drift monitor are passed separately.  Tombstone prefix sums and the
  live/dead counters are recomputed.

Sharded dynamic index (:func:`sharded_from_arrays`):
  ``n_shards``, ``axis``, ``splits``, ``counts`` (the (n_shards, 4)
  counter table), ``muted``, ``eps``, ``n_leaves``, ``rebalance_ratio``,
  ``rebalance_skew``, ``migrate_headroom_factor``, ``build_kwargs``, the
  counters (``rebalances``, ``migrations_incremental``,
  ``migrations_full``, ``restack_full``, ``restack_rows``,
  ``capacity_shrinks``, ``swaps_committed``), ``quarantined``, and
  ``shards``: a list of each shard's :func:`dynamic_from_arrays` arrays
  (its drift monitor's arrays under ``drift`` when it has one); the pool
  is passed separately.

Static sharded index (:func:`sharded_index_from_arrays`):
  ``n_shards``, ``axis``, ``splits``, ``keys`` (n_shards, cap), ``valid``,
  ``root_a``/``root_b`` (n_shards,), ``leaf_a``/``leaf_b``,
  ``err_lo``/``err_hi`` (n_shards, n_leaves), ``n_leaves``, ``iters``.

Drift monitor (:func:`drift_from_arrays`):
  ``m``, ``lo``, ``hi``, ``thresh_hi``, ``thresh_lo``, ``ref``, ``acc``,
  ``score``, ``drifted``, ``updates``, ``rebaselines``.

Pool (:func:`pool_from_arrays`):
  ``eps``, ``m``, ``kind``, ``hists``, params under ``p``, ``err_lo``,
  ``err_hi``, ``x_start``, ``x_end``, ``y_start``, ``y_end``; the f32
  selection tables are recomputed with the pinned prefix order.

LM parameters (:func:`lm_params_from_arrays`): the reference's parameter
  tree as nested dicts of numpy arrays (a NamedTuple's fields by name,
  absent leaves left out), superblock leaves stacked on axis 0; bf16
  arrives as ``ml_dtypes.bfloat16`` and is carried across as its 16-bit
  words, never through f32.  AdamW state (:func:`adamw_state_from_arrays`):
  ``mu``, ``nu`` and ``master`` as such trees (f32), and ``step``.
  Decode caches (:func:`lm_caches_from_arrays`): the reference's
  ``init_cache`` tree, ``pos{i}`` -> K/V or a recurrent state's arrays.

RMRT (:func:`rmrt_from_arrays`):
  ``keys``, ``kind``, params under ``p``, ``is_leaf``, ``child_base``,
  ``y_start``, ``y_end``, ``err_lo``, ``err_hi``, ``node_sim``,
  ``reused``, ``fanout``, ``leaf_cap``, ``depth``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .core import models
from .core.adapt import DomainSpec
from .core.distributed import ShardedDynamicIndex, ShardedIndex, ShardMesh
from .core.drift import DriftState
from .core.reuse import ModelPool
from .core.rmi import RMIIndex
from .core.rmrt import RMRTIndex
from .core.updates import DynamicRMI, _psum

_F64 = torch.float64


def _tensor(arrays: dict, dev):
    return lambda k, dt=_F64: torch.as_tensor(np.array(arrays[k]), dtype=dt,
                                              device=dev)


def _params(arrays: dict, prefix: str, dev, scalar: bool = False):
    """(kind, params) stored under ``prefix``; ``scalar`` drops a leading
    axis of length one (a root stored as (1,) arrays)."""
    t = _tensor(arrays, dev)
    kind = str(arrays.get(f"{prefix}_kind", "linear"))
    fields = ("a", "b") if kind == "linear" else ("w1", "b1", "w2", "b2")
    vals = [t(f"{prefix}_{f}") for f in fields]
    if scalar and kind == "linear":
        vals = [v.reshape(()) for v in vals]
    cls = models.LinearParams if kind == "linear" else models.MLPParams
    return kind, cls(*vals)


def rmi_from_arrays(arrays: dict, *, device=None) -> RMIIndex:
    """The port's ``RMIIndex`` over the given tables (either model kind)."""
    dev = resolve_device(device)
    t = _tensor(arrays, dev)
    root_kind, root = _params(arrays, "root", dev, scalar=True)
    leaf_kind, leaves = _params(arrays, "leaf", dev)
    idx = RMIIndex(
        keys=t("keys"), root_kind=root_kind, root=root, leaf_kind=leaf_kind,
        leaves=leaves, err_lo=t("err_lo"), err_hi=t("err_hi"),
        n_leaves=int(arrays["n_leaves"]),
        reused_mask=t("reused", torch.bool), leaf_sim=t("leaf_sim"))
    if "iters" in arrays:
        idx._iters = int(arrays["iters"])
    return idx


def dynamic_from_arrays(arrays: dict, *, pool: ModelPool | None = None,
                        drift: DriftState | None = None,
                        device=None) -> DynamicRMI:
    """The port's ``DynamicRMI`` over the given tiers and tables, with an
    optional pool and drift monitor (on the same device)."""
    idx = rmi_from_arrays(arrays, device=device)
    dev = idx.device
    t = _tensor(arrays, dev)
    base_dead = t("base_dead", torch.bool)
    dk = t("delta_keys")
    ddead = t("delta_dead", torch.bool)
    return DynamicRMI(
        index=idx, eps=float(arrays.get("eps", 0.9)), pool=pool,
        route_n=int(arrays["route_n"]),
        delta_keys=dk, delta_leaf=t("delta_leaf", torch.int32),
        delta_dead=ddead, delta_psum=_psum(ddead),
        delta_live=int((torch.isfinite(dk) & ~ddead).sum()),
        delta_dead_count=int(ddead.sum()),
        base_n=int(arrays["base_n"]), base_dead=base_dead,
        base_psum=_psum(base_dead), base_dead_count=int(base_dead.sum()),
        n_inserts=np.array(arrays["n_inserts"], np.int64),
        budget=np.array(arrays["budget"], np.float64),
        reuse_on_rebuild=arrays.get("reuse_on_rebuild"),
        build_kwargs=dict(arrays.get("build_kwargs", {})),
        drift=drift, swap_on_drift=bool(arrays.get("swap_on_drift", False)),
        swaps_committed=int(arrays.get("swaps_committed", 0)),
        swap_rejects=int(arrays.get("swap_rejects", 0)),
        _win=np.array(arrays["win"], np.float64))


_SHARDED_COUNTERS = ("rebalances", "migrations_incremental",
                     "migrations_full", "restack_full", "restack_rows",
                     "capacity_shrinks", "swaps_committed")


def sharded_from_arrays(arrays: dict, *, pool: ModelPool | None = None,
                        device=None, mesh=None) -> ShardedDynamicIndex:
    """The port's ``ShardedDynamicIndex`` over the given shards, splits,
    counter table and mutes, with an optional pool (on the home device).
    ``mesh`` (a ``ShardMesh`` of the arrays' shard count) places the
    shards on its devices; without one, every shard lies on ``device``."""
    n = int(arrays["n_shards"])
    axis = str(arrays.get("axis", "data"))
    mesh = ShardMesh(n, axis) if mesh is None else mesh
    if int(mesh.shape[axis]) != n:
        raise ValueError(f"a mesh of {mesh.shape[axis]} shards for {n}")
    positions = mesh.positions(device)
    dev = positions[0]
    shards = []
    for s, a in enumerate(arrays["shards"]):
        sdev = positions[s * len(positions) // n]
        drift = drift_from_arrays(a["drift"], device=sdev) \
            if a.get("drift") is not None else None
        shards.append(dynamic_from_arrays(
            a, pool=None if pool is None else pool.replica(sdev),
            drift=drift, device=sdev))
    idx = ShardedDynamicIndex(
        mesh=mesh, axis=axis,
        splits=np.array(arrays["splits"], np.float64), shards=shards,
        eps=float(arrays["eps"]), n_leaves=int(arrays["n_leaves"]),
        pool=pool, rebalance_ratio=arrays.get("rebalance_ratio", 0.5),
        rebalance_skew=float(arrays.get("rebalance_skew", 2.0)),
        migrate_headroom_factor=float(
            arrays.get("migrate_headroom_factor", 4.0)),
        quarantined=list(arrays.get("quarantined", [])),
        build_kwargs=dict(arrays.get("build_kwargs", {})))
    for k in _SHARDED_COUNTERS:
        setattr(idx, k, int(arrays.get(k, 0)))
    idx._init_maintenance()
    idx._counts = torch.as_tensor(np.array(arrays["counts"], np.int64),
                                  device=dev)
    idx._muted = torch.as_tensor(np.array(arrays["muted"], np.int64),
                                 device=dev)
    return idx


def sharded_index_from_arrays(arrays: dict, *, device=None,
                              mesh=None) -> ShardedIndex:
    """The port's static ``ShardedIndex`` over the given stacked tables,
    each mesh position's rows on its device (``mesh`` as in
    :func:`sharded_from_arrays`)."""
    n = int(arrays["n_shards"])
    axis = str(arrays.get("axis", "data"))
    mesh = ShardMesh(n, axis) if mesh is None else mesh
    if int(mesh.shape[axis]) != n:
        raise ValueError(f"a mesh of {mesh.shape[axis]} shards for {n}")
    positions = mesh.positions(device)
    t = _tensor(arrays, positions[0])
    return ShardedIndex.from_stack(
        mesh, axis, splits=t("splits"), keys=t("keys"),
        valid=t("valid", torch.int64),
        root=models.LinearParams(a=t("root_a"), b=t("root_b")),
        leaves=models.LinearParams(a=t("leaf_a"), b=t("leaf_b")),
        err_lo=t("err_lo"), err_hi=t("err_hi"),
        n_leaves=int(arrays["n_leaves"]), search_iters=int(arrays["iters"]),
        positions=positions)


def drift_from_arrays(arrays: dict, *, device=None) -> DriftState:
    """The port's ``DriftState`` over the given histograms and latch."""
    dev = resolve_device(device)
    t = _tensor(arrays, dev)
    return DriftState(
        m=int(arrays["m"]), lo=float(arrays["lo"]), hi=float(arrays["hi"]),
        thresh_hi=float(arrays["thresh_hi"]),
        thresh_lo=float(arrays["thresh_lo"]), ref=t("ref"), acc=t("acc"),
        score=t("score"), drifted=t("drifted", torch.bool),
        updates=int(arrays.get("updates", 0)),
        rebaselines=int(arrays.get("rebaselines", 0)))


def pool_from_arrays(arrays: dict, *, device=None) -> ModelPool:
    """The port's ``ModelPool`` over the given stacked models; the f32
    selection tables are recomputed here."""
    dev = resolve_device(device)
    t = _tensor(arrays, dev)
    arrays = dict(arrays, p_kind=str(arrays["kind"]))
    kind, params = _params(arrays, "p", dev)
    pool = ModelPool(
        eps=float(arrays["eps"]), m=int(arrays["m"]), kind=kind,
        hists=t("hists"), params=params, err_lo=t("err_lo"),
        err_hi=t("err_hi"),
        domains=DomainSpec(t("x_start"), t("x_end"), t("y_start"),
                           t("y_end")))
    pool._refresh_tables()
    return pool


def rmrt_from_arrays(arrays: dict, *, device=None) -> RMRTIndex:
    """The port's ``RMRTIndex`` over the given flat node tables."""
    dev = resolve_device(device)
    t = _tensor(arrays, dev)
    arrays = dict(arrays, p_kind=str(arrays["kind"]))
    kind, params = _params(arrays, "p", dev)
    return RMRTIndex(
        keys=t("keys"), kind=kind, params=params,
        is_leaf=t("is_leaf", torch.bool),
        child_base=t("child_base", torch.int32), y_start=t("y_start"),
        y_end=t("y_end"), err_lo=t("err_lo"), err_hi=t("err_hi"),
        node_sim=t("node_sim"), reused_mask=t("reused", torch.bool),
        fanout=int(arrays["fanout"]), leaf_cap=int(arrays["leaf_cap"]),
        depth=int(arrays["depth"]))


def _lm_leaf(a, dev) -> torch.Tensor:
    """A numpy array as a tensor of the same dtype; bf16 through its
    16-bit words."""
    a = np.array(a)                     # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def lm_params_from_arrays(tree: dict, cfg, *, device=None, mesh=None,
                          fsdp: bool = False, share: bool = True) -> dict:
    """The port's LM parameter tree (``models.model``, MoE leaves included)
    from the reference's as numpy arrays, bit for bit; every leaf's shape
    is checked against ``build_tree(cfg)``.  With ``mesh`` (a
    ``ModelMesh``) the reference's GLOBAL tree (padded for tensor
    parallelism where ``cfg.tp_shard``) is carried to ``device`` (default
    the mesh's first position's) and cut onto the positions by
    ``serve.step.shard_tree``: a list of trees, one a position, under
    ``serve_param_specs`` (the weights gathered over ``data``: the serving
    steps' ``replicate_weights=True`` form), or with ``fsdp`` under
    ``param_specs`` (FSDP storage, training's and the serving steps'
    default; ``share`` as ``shard_tree``'s).  Any tree of the parameters' shapes carries across
    the same way, whatever its dtype: the compression residual (f32)."""
    if mesh is None:
        return _lm_tree(tree, cfg, resolve_device(device))
    from .models.model import param_specs
    from .serve.step import serve_param_specs, shard_tree
    dev = mesh.devices[0] if device is None else resolve_device(device)
    specs = param_specs(cfg) if fsdp else serve_param_specs(cfg)
    return shard_tree(_lm_tree(tree, cfg, dev, mesh), specs, mesh,
                      share=share)


def lm_caches_from_arrays(tree: dict, cfg, *, device=None, mesh=None,
                          batch_sharded: bool = True,
                          seq_shard: bool = False) -> dict:
    """The port's decode-state tree (``models.model.init_cache``'s: K/V and
    the recurrent states) from the reference's ``init_cache`` tree as
    numpy arrays, bit for bit; every leaf's shape and dtype is checked
    against ``cache_shapes(cfg, batch, max_seq)``, batch and max_seq read
    from the tree.  With ``mesh`` the tree is the reference's GLOBAL one
    (``init_cache(..., local=False)``), checked against ``cache_shapes(...,
    local=False)`` and cut onto the positions (``shard_tree``, a copy a
    position) by the serving steps' cache specs for ``batch_sharded`` and
    ``seq_shard``: a list of trees."""
    from .models import model as M
    dev = resolve_device(device) if mesh is None or device is not None \
        else mesh.devices[0]
    first = next(iter(next(iter(tree.values())).values()))
    batch = np.shape(first)[1]
    kv = [np.shape(v["k"])[2] for v in tree.values() if "k" in v]
    want = M.cache_shapes(cfg, batch, kv[0] if kv else 1,
                          local=mesh is None)
    if set(tree) != set(want):
        raise ValueError(f"cache positions {sorted(tree)}, the config "
                         f"wants {sorted(want)}")
    out = {}
    for pos, leaves in want.items():
        if set(tree[pos]) != set(leaves):
            raise ValueError(f"{pos}: leaves {sorted(tree[pos])}, the "
                             f"config wants {sorted(leaves)}")
        out[pos] = {}
        for name, (shape, dt) in leaves.items():
            t = _lm_leaf(tree[pos][name], dev)
            if tuple(t.shape) != shape or t.dtype != dt:
                raise ValueError(f"{pos}/{name}: {tuple(t.shape)} {t.dtype}, "
                                 f"the config wants {shape} {dt}")
            out[pos][name] = t
    if mesh is None:
        return out
    from .serve.step import _cache_specs, shard_tree
    return shard_tree(out, _cache_specs(cfg, mesh, batch_sharded=batch_sharded,
                                        seq_shard=seq_shard), mesh,
                      share=False)


def adamw_state_from_arrays(tree: dict, cfg, *, device=None, mesh=None,
                            share: bool = True):
    """The port's ``train.optimizer.AdamWState`` from the reference's
    ``AdamWState`` as numpy arrays: ``mu``, ``nu`` and ``master`` (f32
    trees shaped as the parameters, checked against ``build_tree(cfg)``)
    and ``step``, bit for bit.  With ``mesh``: the GLOBAL state cut onto
    its positions by ``optimizer.state_specs(param_specs(cfg))``, a list
    of states, one a position (``share`` as ``shard_tree``'s)."""
    from .train.optimizer import AdamWState
    dev = resolve_device(device) if mesh is None or device is not None \
        else mesh.devices[0]
    st = AdamWState(
        mu=_lm_tree(tree["mu"], cfg, dev, mesh),
        nu=_lm_tree(tree["nu"], cfg, dev, mesh),
        master=_lm_tree(tree["master"], cfg, dev, mesh),
        step=torch.tensor(int(np.asarray(tree["step"])), dtype=torch.int32,
                          device=dev))
    if mesh is None:
        return st
    from .models.model import param_specs
    from .serve.step import shard_tree
    from .train.optimizer import state_specs
    return shard_tree(st, state_specs(param_specs(cfg)), mesh, share=share)


def _lm_tree(tree: dict, cfg, dev, mesh=None) -> dict:
    from .models import model as M

    def carry(desc, node, stacked, path):
        if desc is None:
            return None
        if isinstance(desc, dict):
            return {k: carry(v, node[k], stacked, f"{path}/{k}")
                    for k, v in desc.items()}
        if isinstance(desc, M.Leaf):
            want = ((cfg.n_sb,) if stacked else ()) + desc.shape
            if tuple(np.shape(node)) != want:
                raise ValueError(f"{path}: shape {np.shape(node)}, the "
                                 f"config wants {want}")
            return _lm_leaf(node, dev)
        return type(desc)(*(carry(getattr(desc, f), node.get(f), stacked,
                                  f"{path}/{f}") for f in desc._fields))

    desc = M.build_tree(cfg, mesh)
    out = {k: carry(v, tree[k], False, k) for k, v in desc.items()
           if k != "sb"}
    out["sb"] = carry(desc["sb"], tree["sb"], True, "sb")
    return out
