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


def export_rmi(idx) -> dict:
    """A reference ``RMIIndex`` (linear/linear) as numpy arrays."""
    g = lambda a: np.asarray(a)
    return dict(keys=g(idx.keys), root_a=g(idx.root.a), root_b=g(idx.root.b),
                leaf_a=g(idx.leaves.a), leaf_b=g(idx.leaves.b),
                err_lo=g(idx.err_lo), err_hi=g(idx.err_hi),
                reused=g(idx.reused_mask), leaf_sim=g(idx.leaf_sim),
                n_leaves=idx.n_leaves, iters=idx.search_iters)


def export_dynamic(d) -> dict:
    """A reference ``DynamicRMI`` as numpy arrays and scalars."""
    out = export_rmi(d.index)
    g = lambda a: np.asarray(a)
    out.update(route_n=d.route_n, base_n=d.base_n, base_dead=g(d.base_dead),
               delta_keys=g(d.delta_keys), delta_leaf=g(d.delta_leaf),
               delta_dead=g(d.delta_dead), n_inserts=d.n_inserts.copy(),
               budget=d.budget.copy(), win=d._win.copy(), eps=d.eps)
    return out
