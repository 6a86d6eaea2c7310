"""Parity helpers for the ``repro_torch`` tests: seeded numpy inputs, and
the exporter that reads a reference (JAX) index out as the numpy arrays
``repro_torch.convert`` takes.  Imports both packages, so it lives here
and in neither package."""
from __future__ import annotations

import numpy as np

DISTS = ("uniform", "lognormal", "zipf", "dup-heavy")


def gen_keys(rng, dist: str, size: int) -> np.ndarray:
    """Sorted, f32-exact f64 keys of exactly ``size`` entries (duplicate
    runs in the dup-heavy distribution)."""
    if dist == "uniform":
        raw = rng.uniform(0.001, 1e6, 2 * size)
    elif dist == "lognormal":
        raw = rng.lognormal(0, 1.2, 2 * size) * 1e3
    elif dist == "zipf":
        raw = rng.zipf(1.6, 2 * size).astype(np.float64) + rng.random(2 * size)
    else:
        raw = rng.choice(rng.uniform(0.1, 1e5, max(size // 64, 4)), 2 * size)
    u = np.unique(raw.astype(np.float32)).astype(np.float64)
    if u.size >= size:
        return np.sort(rng.choice(u, size, replace=False))
    return np.sort(np.resize(u, size))


def gen_queries(rng, keys: np.ndarray, q: int) -> np.ndarray:
    """f32-exact mix: members, midpoints of adjacent keys, fresh draws in
    range, out-of-range values and huge finite ones."""
    keys = keys[np.isfinite(keys)]
    lo, hi = float(keys[0]), float(keys[-1])
    n_mem = q // 2
    i = rng.integers(0, keys.size - 1, q // 4)
    mid = (keys[i] + keys[i + 1]) / 2
    fresh = rng.uniform(lo, hi, q - n_mem - mid.size - 6)
    edge = [lo - 1.0, hi + 1.0, lo, hi, 1e30, -1e30]
    out = np.concatenate([rng.choice(keys, n_mem), mid, fresh, edge])
    return out.astype(np.float32).astype(np.float64)


def export_params(prefix: str, kind: str, params) -> dict:
    """Model parameters (a NamedTuple of arrays) under ``prefix``."""
    out = {f"{prefix}_{f}": np.asarray(getattr(params, f))
           for f in params._fields}
    out[f"{prefix}_kind"] = kind
    return out


def export_rmi(idx) -> dict:
    """A reference ``RMIIndex`` (either model kind) as numpy arrays."""
    g = lambda a: np.asarray(a)
    return dict(keys=g(idx.keys), **export_params("root", idx.root_kind,
                                                  idx.root),
                **export_params("leaf", idx.leaf_kind, idx.leaves),
                err_lo=g(idx.err_lo), err_hi=g(idx.err_hi),
                reused=g(idx.reused_mask), leaf_sim=g(idx.leaf_sim),
                n_leaves=idx.n_leaves, iters=idx.search_iters)


def export_dynamic(d) -> dict:
    """A reference ``DynamicRMI`` as numpy arrays and scalars (its pool and
    drift monitor are carried across separately, by :func:`export_pool` and
    :func:`export_drift`)."""
    out = export_rmi(d.index)
    g = lambda a: np.asarray(a)
    out.update(route_n=d.route_n, base_n=d.base_n, base_dead=g(d.base_dead),
               delta_keys=g(d.delta_keys), delta_leaf=g(d.delta_leaf),
               delta_dead=g(d.delta_dead), n_inserts=d.n_inserts.copy(),
               budget=d.budget.copy(), win=d._win.copy(), eps=d.eps,
               reuse_on_rebuild=d.reuse_on_rebuild,
               build_kwargs=dict(d.build_kwargs),
               swap_on_drift=d.swap_on_drift,
               swaps_committed=d.swaps_committed,
               swap_rejects=d.swap_rejects)
    return out


def export_sharded(idx) -> dict:
    """A reference ``ShardedDynamicIndex`` as numpy arrays and scalars, as
    ``convert.sharded_from_arrays`` takes it (its pool separately)."""
    shards = []
    for d in idx.shards:
        a = export_dynamic(d)
        a["drift"] = export_drift(d.drift) if d.drift is not None else None
        shards.append(a)
    return dict(
        n_shards=idx.n_shards, axis=idx.axis,
        splits=np.asarray(idx.splits, np.float64).copy(),
        counts=np.asarray(idx._counts), muted=np.asarray(idx._muted),
        eps=idx.eps, n_leaves=idx.n_leaves,
        rebalance_ratio=idx.rebalance_ratio,
        rebalance_skew=idx.rebalance_skew,
        migrate_headroom_factor=idx.migrate_headroom_factor,
        build_kwargs=dict(idx.build_kwargs),
        quarantined=list(idx.quarantined), shards=shards,
        **{k: getattr(idx, k) for k in (
            "rebalances", "migrations_incremental", "migrations_full",
            "restack_full", "restack_rows", "capacity_shrinks",
            "swaps_committed")})


def export_sharded_index(si) -> dict:
    """A reference static ``ShardedIndex`` as numpy arrays and scalars."""
    g = lambda a: np.asarray(a)
    return dict(n_shards=si.n_shards, axis=si.axis, splits=g(si.splits),
                keys=g(si.keys), valid=g(si.valid), root_a=g(si.root.a),
                root_b=g(si.root.b), leaf_a=g(si.leaves.a),
                leaf_b=g(si.leaves.b), err_lo=g(si.err_lo),
                err_hi=g(si.err_hi), n_leaves=si.n_leaves,
                iters=si.search_iters)


def export_drift(st) -> dict:
    """A reference ``DriftState`` as numpy arrays and scalars."""
    g = lambda a: np.asarray(a)
    return dict(m=st.m, lo=st.lo, hi=st.hi, thresh_hi=st.thresh_hi,
                thresh_lo=st.thresh_lo, ref=g(st.ref), acc=g(st.acc),
                score=g(st.score), drifted=g(st.drifted),
                updates=st.updates, rebaselines=st.rebaselines)


def export_pool(pool) -> dict:
    """A reference ``ModelPool`` as numpy arrays and scalars."""
    g = lambda a: np.asarray(a)
    dom = pool.domains
    return dict(eps=pool.eps, m=pool.m, kind=pool.kind, hists=g(pool.hists),
                **export_params("p", pool.kind, pool.params),
                err_lo=g(pool.err_lo), err_hi=g(pool.err_hi),
                x_start=g(dom.x_start), x_end=g(dom.x_end),
                y_start=g(dom.y_start), y_end=g(dom.y_end))


def export_rmrt(t) -> dict:
    """A reference ``RMRTIndex`` as numpy arrays and scalars."""
    g = lambda a: np.asarray(a)
    return dict(keys=g(t.keys), kind=t.kind,
                **export_params("p", t.kind, t.params),
                is_leaf=g(t.is_leaf), child_base=g(t.child_base),
                y_start=g(t.y_start), y_end=g(t.y_end), err_lo=g(t.err_lo),
                err_hi=g(t.err_hi), node_sim=g(t.node_sim),
                reused=g(t.reused_mask), fanout=t.fanout,
                leaf_cap=t.leaf_cap, depth=t.depth)


def export_lm_params(params) -> dict:
    """A reference LM parameter tree as nested dicts of numpy arrays (a
    NamedTuple's fields by name, ``None`` leaves left out), as
    ``convert.lm_params_from_arrays`` takes it; bf16 stays
    ``ml_dtypes.bfloat16``."""
    if isinstance(params, dict):
        return {k: export_lm_params(v) for k, v in params.items()}
    if hasattr(params, "_fields"):
        return {f: export_lm_params(getattr(params, f))
                for f in params._fields if getattr(params, f) is not None}
    return np.asarray(params)
