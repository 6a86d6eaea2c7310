"""Drift-adaptive serving in the port (``core.drift``, ``DynamicRMI``'s
drift wiring and ``maybe_swap``, the facade's verbs), held against the
reference at small sizes.

* Drift scores and latches: the same seeded batches through both packages'
  monitors -- stationary, shifted, then decaying through the hysteresis
  band -- give bit-identical scores, latches and histograms.
* Swaps: a reference index and its pool carried across
  (``convert.dynamic_from_arrays``, ``pool_from_arrays``,
  ``drift_from_arrays``), then the same shifted ingest and maintenance:
  the same leaves commit, with equal budgets, window widths, counters and
  reuse masks; f64 leaf parameters and error bounds within ``rtol=1e-9``
  (XLA contracts the adaptation's and the residual pass's ``a*x + b`` into
  FMAs inside the jit; the port does not, so the last bits differ).
  Finds and ranges after the swaps equal the reference's and a refit-only
  twin's bit for bit.
* The swap pass's bin edges are the FMA XLA makes of them, pinned on real
  leaves against the jitted expression.
* No "retrace" across commits: the search depth, the packed tables'
  shapes, the built kernel libraries and the launches per ``find`` stay.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import repro  # noqa: F401  (enables x64 for the reference)
import jax
import jax.numpy as jnp
from repro.core import drift as jdrift
from repro.core import reuse as jreuse
from repro.core import synth as jsynth
from repro.core.updates import DynamicRMI as JDynamicRMI
from torch_export import export_drift, export_dynamic, export_pool

from repro_torch.api import Index
from repro_torch.convert import (drift_from_arrays, dynamic_from_arrays,
                                 pool_from_arrays)
from repro_torch.core import cdf as tcdf
from repro_torch.core import drift as tdrift
from repro_torch.core import rmi as trmi
from repro_torch.core.updates import DynamicRMI as TDynamicRMI
from repro_torch.kernels import build as tbuild
from repro_torch.kernels import lookup as tlk

N_LEAVES = 64
EPS = 0.65
RTOL = 1e-9
DRIFT = dict(drift_bins=64, drift_hi=0.08, drift_lo=0.04)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _close(t, j, what=""):
    t, j = _np(t), _np(j)
    scale = max(float(np.abs(j[np.isfinite(j)]).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=RTOL * scale,
                               err_msg=what)


def _f32e(a) -> np.ndarray:
    return np.asarray(a, np.float64).astype(np.float32).astype(np.float64)


def _stationary(rng, n=600):
    return np.sort(_f32e(rng.lognormal(0.0, 0.5, n)))


def _shifted(rng, n=600):
    return np.sort(_f32e(rng.lognormal(1.5, 0.4, n)))


@pytest.fixture(scope="module")
def pools():
    j = jreuse.build_pool(jsynth.generate_pool(EPS, ns=256, seed=1),
                          kind="linear", m_sim=64)
    return j, export_pool(j)


@pytest.fixture(scope="module")
def base_keys():
    rng = np.random.default_rng(7)
    return np.unique(_f32e(rng.lognormal(0.0, 0.5, 8000)))


def _carried(pools, keys, **kw):
    """A reference index and the port's copy of it (pool and monitor
    carried across)."""
    j = JDynamicRMI.build(jnp.asarray(keys), pool=pools[0], eps=EPS,
                          n_leaves=N_LEAVES, **kw)
    drift = drift_from_arrays(export_drift(j.drift), device="cpu") \
        if j.drift is not None else None
    t = dynamic_from_arrays(export_dynamic(j),
                            pool=pool_from_arrays(pools[1], device="cpu"),
                            drift=drift, device="cpu")
    return j, t


def _same_drift(t, j, what):
    assert float(_np(t.score)) == float(j.score), what
    assert bool(_np(t.drifted)) == bool(j.drifted), what
    np.testing.assert_array_equal(_np(t.ref), np.asarray(j.ref), what)
    np.testing.assert_array_equal(_np(t.acc), np.asarray(j.acc), what)
    assert (t.updates, t.rebaselines) == (j.updates, j.rebaselines), what


# ---------------------------------------------------------------------------
# The monitor.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,hi,lo", [(64, 0.08, 0.04), (12, 0.15, 0.05)])
def test_drift_scores_match_reference(base_keys, m, hi, lo):
    """Stationary, shifted, then decaying batches: every score, latch and
    histogram bit for bit; the latch sets, holds in the band and clears."""
    j = jdrift.init_drift(jnp.asarray(base_keys), m=m, thresh_hi=hi,
                          thresh_lo=lo)
    t = tdrift.init_drift(torch.from_numpy(base_keys), m=m, thresh_hi=hi,
                          thresh_lo=lo)
    _same_drift(t, j, "init")
    rng = np.random.default_rng(1)
    odd = np.asarray([-1e30, -np.inf, np.inf, np.nan, 1e30,
                      base_keys[0] - 1.0, base_keys[-1] + 1.0, 0.0])
    batches = [_stationary(rng), np.concatenate([_stationary(rng), odd]),
               _stationary(rng)] + [_shifted(rng) for _ in range(6)]
    batches += [_stationary(rng, 2000) for _ in range(200)]
    latched = in_band = cleared = False
    for i, b in enumerate(batches):
        j = jdrift.update_drift(j, jnp.asarray(b))
        t = tdrift.update_drift(t, torch.from_numpy(b))
        _same_drift(t, j, f"batch {i}")
        s = float(j.score)
        latched |= bool(j.drifted)
        in_band |= latched and bool(j.drifted) and lo <= s < hi
        if latched and not bool(j.drifted):
            cleared = True
            break
    assert latched and in_band and cleared
    j, t = jdrift.rebaseline(j), tdrift.rebaseline(t)
    _same_drift(t, j, "rebaselined")
    assert float(_np(t.score)) == 0.0
    np.testing.assert_array_equal(_np(tdrift.state_row(t)),
                                  np.asarray(jdrift.state_row(j)))


def test_drift_state_carried_across(base_keys):
    j = jdrift.init_drift(jnp.asarray(base_keys), m=16)
    j = jdrift.update_drift(j, jnp.asarray(_shifted(np.random.default_rng(2))))
    t = drift_from_arrays(export_drift(j), device="cpu")
    _same_drift(t, j, "carried")
    np.testing.assert_array_equal(_np(tdrift.state_row(t)),
                                  np.asarray(jdrift.state_row(j)))
    np.testing.assert_array_equal(_np(tdrift.state_row(None)), [0.0, 0.0])
    with pytest.raises(ValueError, match="hysteresis"):
        tdrift.init_drift(torch.from_numpy(base_keys), thresh_hi=0.1,
                          thresh_lo=0.2)


# ---------------------------------------------------------------------------
# Swaps against the reference.
# ---------------------------------------------------------------------------
def _compare(t, j, rng, what, hi_scale=1.02):
    assert (t.swaps_committed, t.swap_rejects, t.rebuilds, t.base_n,
            t.delta_live) == (j.swaps_committed, j.swap_rejects, j.rebuilds,
                              j.base_n, j.delta_live), what
    assert t.index.search_iters == j.index.search_iters, what
    np.testing.assert_array_equal(t.n_inserts, j.n_inserts, what)
    np.testing.assert_array_equal(t.budget, j.budget, what)
    np.testing.assert_array_equal(t._win, j._win, what)
    np.testing.assert_array_equal(_np(t.index.reused_mask),
                                  np.asarray(j.index.reused_mask), what)
    for f in t.index.leaves._fields:
        _close(getattr(t.index.leaves, f), getattr(j.index.leaves, f),
               f"{what}: {f}")
    _close(t.index.err_lo, j.index.err_lo, f"{what}: err_lo")
    _close(t.index.err_hi, j.index.err_hi, f"{what}: err_hi")
    _close(t.index.leaf_sim, j.index.leaf_sim, f"{what}: sim")
    if j.drift is not None:
        _same_drift(t.drift, j.drift, what)
    live = j.live_keys()
    np.testing.assert_array_equal(t.live_keys(), live, what)
    q = np.concatenate([rng.choice(live, 300),
                        _f32e(rng.choice(live, 100) * (1 + 1e-3))])
    hi = _f32e(q * hi_scale)
    for path in ("jnp", "kernel"):
        for got, want in zip(t.find(q, path=path),
                             j.find(jnp.asarray(q), path=path), strict=True):
            np.testing.assert_array_equal(_np(got), np.asarray(want),
                                          f"{what} find {path}")
        for got, want in zip(t.find_range(q, hi, path=path),
                             j.find_range(jnp.asarray(q), jnp.asarray(hi),
                                          path=path), strict=True):
            np.testing.assert_array_equal(_np(got), np.asarray(want),
                                          f"{what} range {path}")


def test_swap_maintenance_matches_reference(pools, base_keys):
    """Swap mode under shifted ingest: the inserts defer every repair, the
    latch sets, and the maintenance pass commits the same leaves in both
    packages; the deferred refits and a flush follow alike."""
    j, t = _carried(pools, base_keys, swap_on_drift=True, **DRIFT)
    rng = np.random.default_rng(3)
    for i in range(4):
        b = _shifted(rng)
        j.insert_batch(jnp.asarray(b))
        t.insert_batch(b)
        _compare(t, j, rng, f"insert {i}")
    assert bool(_np(t.drift.drifted))
    assert t.rebuilds == 0 and (t.n_inserts > t.budget).any(), \
        "swap mode defers the repair of over-budget leaves"
    assert j.maybe_swap() == t.maybe_swap() > 0
    _compare(t, j, rng, "maintenance")
    assert t.pool.reuse_count == t.swaps_committed
    for i in range(3):
        b = _shifted(rng)
        j.insert_batch(jnp.asarray(b))
        t.insert_batch(b)
        assert j.maybe_swap() == t.maybe_swap()
        _compare(t, j, rng, f"round {i}")
    j.flush_delta()
    t.flush_delta()
    assert t.drift.rebaselines == 1
    _compare(t, j, rng, "flushed")


def test_explicit_swap_matches_reference(pools, base_keys):
    """``maybe_swap(leaf_ids)`` skips the latch gate; a non-power-of-two
    id list is padded by repeating its first id."""
    j, t = _carried(pools, base_keys, **DRIFT)
    rng = np.random.default_rng(4)
    b = _shifted(rng, 900)
    j.insert_batch(jnp.asarray(b))
    t.insert_batch(b)
    ids = np.unique(np.concatenate([np.flatnonzero(t.n_inserts > 0)[:6],
                                    [3, 17]]))
    if not ids.size & (ids.size - 1):
        ids = ids[1:]                  # exercise the power-of-two padding
    assert j.maybe_swap(ids) == t.maybe_swap(ids)
    assert t.swaps_committed + t.swap_rejects == ids.size
    _compare(t, j, rng, "explicit")


def test_swap_vs_refit_bit_exact_single_host(pools, base_keys):
    """The port of the reference's swap-vs-refit test: a swap-mode index
    and a refit-only twin answer every find and range alike, and so does
    the reference's swap-mode index."""
    tp = pool_from_arrays(pools[1], device="cpu")
    kw = dict(pool=tp, eps=EPS, n_leaves=N_LEAVES, device="cpu")
    d_swap = TDynamicRMI.build(base_keys, swap_on_drift=True, **DRIFT, **kw)
    d_refit = TDynamicRMI.build(base_keys, **kw)
    j = JDynamicRMI.build(jnp.asarray(base_keys), pool=pools[0], eps=EPS,
                          n_leaves=N_LEAVES, swap_on_drift=True, **DRIFT)
    rng = np.random.default_rng(3)
    for _ in range(4):
        b = _shifted(rng)
        for d in (d_swap, d_refit):
            d.insert_batch(b)
        j.insert_batch(jnp.asarray(b))
    assert bool(_np(d_swap.drift.drifted))
    d_swap.maybe_swap()
    j.maybe_swap()
    assert d_swap.swaps_committed == j.swaps_committed > 0
    live = d_swap.live_keys()
    np.testing.assert_array_equal(live, d_refit.live_keys())
    q = np.concatenate([live[::53], _f32e(live[::101] * (1 + 1e-3))])
    lo, hi = live[::201], _f32e(live[::201] * 1.02)
    for path in ("jnp", "kernel"):
        f1, r1 = d_swap.find(q, path=path)
        f2, r2 = d_refit.find(q, path=path)
        fj, rj = j.find(jnp.asarray(q), path=path)
        for a, b_, c in ((f1, f2, fj), (r1, r2, rj)):
            np.testing.assert_array_equal(_np(a), _np(b_))
            np.testing.assert_array_equal(_np(a), np.asarray(c))
        assert np.all(live[_np(r1)[:live[::53].size]] == live[::53])
        for a, b_, c in zip(d_swap.find_range(lo, hi, path=path),
                            d_refit.find_range(lo, hi, path=path),
                            j.find_range(jnp.asarray(lo), jnp.asarray(hi),
                                         path=path), strict=True):
            np.testing.assert_array_equal(_np(a), _np(b_))
            np.testing.assert_array_equal(_np(a), np.asarray(c))


def test_bound_violation_rejects_and_falls_back(pools, base_keys):
    """Pressure beyond any Lemma 4.1 budget: the bound check rejects every
    candidate and leaves the tables untouched; the refit clears it."""
    tp = pool_from_arrays(pools[1], device="cpu")
    d = TDynamicRMI.build(base_keys, pool=tp, eps=EPS, n_leaves=N_LEAVES,
                          swap_on_drift=True, device="cpu", **DRIFT)
    before = d.index.err_lo.clone()
    packed = d.index.packed_tables()
    ids = np.asarray([5, 9, 21])
    d.n_inserts[ids] = 10_000_000
    assert d.maybe_swap(ids) == 0
    assert d.swap_rejects >= ids.size and d.swaps_committed == 0
    assert torch.equal(d.index.err_lo, before)
    assert d.index.packed_tables() is packed
    rb0 = d.rebuilds
    d._rebuild_leaves(ids)
    assert d.rebuilds > rb0
    assert np.all(d.n_inserts[ids] == 0)
    live = d.live_keys()
    q = live[::97]
    f, r = d.find(q, path="jnp")
    assert bool(f.all())
    np.testing.assert_array_equal(live[_np(r)], q)


def test_maintenance_swap_gated_on_latch(pools, base_keys):
    tp = pool_from_arrays(pools[1], device="cpu")
    d = TDynamicRMI.build(base_keys, pool=tp, eps=EPS, n_leaves=N_LEAVES,
                          device="cpu", **DRIFT)
    d.insert_batch(_stationary(np.random.default_rng(4), 500))
    assert not bool(_np(d.drift.drifted))
    assert d.maybe_swap() == 0
    assert d.swaps_committed == 0 and d.swap_rejects == 0


def test_maybe_swap_needs_monitor_pool_and_linear_root(pools, base_keys):
    """No monitor, a pool of the other kind, or an MLP root: a no-op."""
    tp = pool_from_arrays(pools[1], device="cpu")
    kw = dict(eps=EPS, n_leaves=N_LEAVES, device="cpu")
    ids = np.arange(4)
    assert TDynamicRMI.build(base_keys, pool=tp, **kw).maybe_swap(ids) == 0
    assert TDynamicRMI.build(base_keys, **DRIFT, **kw).maybe_swap(ids) == 0
    d = TDynamicRMI.build(base_keys, pool=tp, root_kind="mlp",
                          train_steps=5, **DRIFT, **kw)
    assert d.maybe_swap(ids) == 0 and d.swap_rejects == 0


# ---------------------------------------------------------------------------
# The facade and the serving invariants.
# ---------------------------------------------------------------------------
def test_facade_maybe_swap_and_drift_scores(pools, base_keys):
    tp = pool_from_arrays(pools[1], device="cpu")
    plain = Index.build(base_keys, n_leaves=N_LEAVES, device="cpu")
    np.testing.assert_array_equal(plain.drift_scores(), [[0.0, 0.0]])
    assert plain.maybe_swap() == 0
    ix = Index.build(base_keys, pool=tp, eps=EPS, n_leaves=N_LEAVES,
                     swap_on_drift=True, device="cpu", **DRIFT)
    assert ix.backend.drift.m == 64 and ix.backend.swap_on_drift
    rng = np.random.default_rng(5)
    for _ in range(4):
        ix.insert(_shifted(rng))
    scores = ix.drift_scores()
    assert scores.shape == (1, 2) and scores.dtype == np.float64
    d = ix.backend
    assert scores[0, 0] == float(_np(d.drift.score)) > DRIFT["drift_hi"]
    assert scores[0, 1] == 1.0
    swapped = ix.maybe_swap()
    assert swapped == d.swaps_committed > 0
    assert not (d.n_inserts > d.budget).any(), "the deferred refits ran"
    live = ix.live_keys()
    q = np.concatenate([rng.choice(live, 200), _f32e(rng.uniform(
        live[0], live[-1], 200))])
    for path in ("kernel", "jnp"):
        found, rank = ix.find(q, path=path)
        np.testing.assert_array_equal(_np(rank), np.searchsorted(live, q))
        np.testing.assert_array_equal(
            _np(found), np.searchsorted(live, q, side="right") > _np(rank))


def test_swap_commit_keeps_depth_shapes_and_launches(pools, base_keys,
                                                     monkeypatch):
    """The port's counterpart of the reference's zero-retrace guard: across
    swap commits the search depth, the packed tables' shapes, the built
    kernel libraries and the kernel calls per ``find`` stay the same, and
    the packed tables are rebuilt from the committed rows (stale tables
    would serve the old leaves)."""
    tp = pool_from_arrays(pools[1], device="cpu")
    d = TDynamicRMI.build(base_keys, pool=tp, eps=EPS, n_leaves=N_LEAVES,
                          swap_on_drift=True, device="cpu", **DRIFT)
    calls = {"dynamic_lookup": 0, "build": 0}
    real = tlk.dynamic_lookup

    def counted(*a, **kw):
        calls["dynamic_lookup"] += 1
        return real(*a, **kw)

    def no_build(*a, **kw):
        calls["build"] += 1
        raise AssertionError("a kernel build ran")

    monkeypatch.setattr(tlk, "dynamic_lookup", counted)
    monkeypatch.setattr(tbuild, "build_all", no_build)
    libs = dict(tbuild._LIBS)
    rng = np.random.default_rng(6)
    for _ in range(4):
        d.insert_batch(_shifted(rng))
    q = _shifted(rng, 256)
    d.find(q, path="kernel")
    per_find = calls["dynamic_lookup"]
    iters, kf32 = d.index.search_iters, d.index.keys_f32
    old = d.index.packed_tables()
    shapes = [a.shape for a in old]
    win = d._win.max()
    assert d.maybe_swap(np.flatnonzero(d.n_inserts > 0)) > 0
    assert d.index._packed is None
    assert d.index.search_iters == iters and d._win.max() <= win
    assert d.index.keys_f32 is kf32 and d.index._f32_exact is not None
    new = d.index.packed_tables()
    assert [a.shape for a in new] == shapes
    assert not torch.equal(new[1], old[1]), "the tables took the new rows"
    fresh = trmi.RMIIndex(
        keys=d.index.keys, root_kind=d.index.root_kind, root=d.index.root,
        leaf_kind=d.index.leaf_kind, leaves=d.index.leaves,
        err_lo=d.index.err_lo, err_hi=d.index.err_hi,
        n_leaves=d.index.n_leaves, reused_mask=d.index.reused_mask,
        leaf_sim=d.index.leaf_sim).packed_tables()
    for a, b in zip(new, fresh, strict=True):
        assert torch.equal(a, b)
    calls["dynamic_lookup"] = 0
    found, rank = d.find(q, path="kernel")
    assert calls["dynamic_lookup"] == per_find
    assert calls["build"] == 0 and tbuild._LIBS == libs
    live = d.live_keys()
    np.testing.assert_array_equal(_np(rank), np.searchsorted(live, q))


def test_swap_bin_edges_are_xlas_fma(base_keys):
    """The swap pass's edges ``kmin + span * (j / m)`` on real leaves (keys
    that are not f32-exact, so the products round): the port's
    ``cdf.bin_edges`` equals the reference's jitted expression bit for bit,
    where the unfused form does not."""
    rng = np.random.default_rng(11)
    keys = np.sort(rng.lognormal(0.0, 0.5, 20_000))
    t = trmi.build_rmi(keys, n_leaves=N_LEAVES, device="cpu")
    b = trmi.root_buckets(t.root_kind, t.root, t.keys, N_LEAVES, t.n)
    _, kmin, kmax, _, _ = trmi.leaf_stats_sorted(t.keys, b, N_LEAVES)
    for m in (64, 12):
        @jax.jit
        def ref_edges(kmin, kmax):
            # core/drift.py swap_leaves_jit, the span and edge lines
            span = jnp.maximum(kmax - kmin, jnp.finfo(jnp.float64).tiny)
            frac = jnp.arange(1, m, dtype=jnp.float64) / m
            return kmin[:, None] + span[:, None] * frac[None, :]

        want = np.asarray(ref_edges(_np(kmin), _np(kmax)))
        span = (kmax - kmin).clamp(min=torch.finfo(torch.float64).tiny)
        got = _np(tcdf.bin_edges(kmin, span, m))
        np.testing.assert_array_equal(got, want)
        unfused = _np(kmin)[:, None] + _np(span)[:, None] \
            * (np.arange(1, m) / m)[None, :]
        assert (unfused != want).any()


@pytest.mark.gpu
def test_cuda_swap_pass_matches_cpu_and_keeps_launches(pools, base_keys):
    """On a card: the same ingest and maintenance as on the CPU commit the
    same leaves (K7 selects), and a find after the commits launches K2 as
    often as before them, with exact answers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = {}
    for dev in ("cpu", "cuda"):
        tp = pool_from_arrays(pools[1], device=dev)
        d = TDynamicRMI.build(base_keys, pool=tp, eps=EPS, n_leaves=N_LEAVES,
                              swap_on_drift=True, device=dev, **DRIFT)
        rng = np.random.default_rng(3)
        for _ in range(4):
            d.insert_batch(_shifted(rng))
        q = _shifted(rng, 512)
        k2 = tlk.LAUNCHES["dynamic_lookup"]
        d.find(q, path="kernel")
        before = tlk.LAUNCHES["dynamic_lookup"] - k2
        d.maybe_swap()
        k2 = tlk.LAUNCHES["dynamic_lookup"]
        _, rank = d.find(q, path="kernel")
        assert tlk.LAUNCHES["dynamic_lookup"] - k2 == before
        np.testing.assert_array_equal(_np(rank),
                                      np.searchsorted(d.live_keys(), q))
        out[dev] = (d.swaps_committed, d.swap_rejects, d.budget.copy(),
                    d._win.copy(), _np(d.index.reused_mask))
    assert out["cpu"][:2] == out["cuda"][:2] and out["cpu"][0] > 0
    for a, b in zip(out["cpu"][2:], out["cuda"][2:], strict=True):
        np.testing.assert_array_equal(a, b)
