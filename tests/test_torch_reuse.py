"""The port's lazy path held against the reference, at small sizes: the
synthetic corpus, the CDF machinery, the pool's prefix tables and kernel
K7's plain version, Algorithm-1 selection, adaptation, MLP training, and
the pooled RMI builds (RMI-MR, RMI-NN-MR).

Tolerances, with their reasons:

* bit for bit: the corpus, histograms, Algorithm-2 distances (f64 and the
  f32 prefix tables, whose order ``core.cdf.prefix_sum`` pins to
  XLA:CPU's), K7's output, selection (found, index, dist), reused masks,
  search depths and every lookup answer;
* ``rtol=1e-9`` (``atol=1e-9`` of the array's scale) for f64 parameters and
  error bounds: XLA:CPU contracts ``a*b + c`` into an FMA inside a jit and
  sums in another order than torch, so the last bits differ.  MLP training
  compares from the same initial parameters (the reference's, handed to
  the port); Adam normalizes each step, and over <= 30 steps the two
  trajectories stay within 1e-12 relative.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import repro  # noqa: F401  (enables x64 for the reference)
import jax
import jax.numpy as jnp
from repro.core import adapt as jadapt
from repro.core import bounds as jbounds
from repro.core import cdf as jcdf
from repro.core import models as jmodels
from repro.core import reuse as jreuse
from repro.core import rmi as jrmi
from repro.core import synth as jsynth
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from torch_export import (DISTS, export_pool, export_rmi, gen_keys,
                          gen_queries)

from repro_torch.convert import pool_from_arrays, rmi_from_arrays
from repro_torch.core import adapt as tadapt
from repro_torch.core import bounds as tbounds
from repro_torch.core import cdf as tcdf
from repro_torch.core import models as tmodels
from repro_torch.core import reuse as treuse
from repro_torch.core import rmi as trmi
from repro_torch.core import synth as tsynth
from repro_torch.kernels import ksdist as tks
from repro_torch.kernels import ops as tops

RTOL = 1e-9
STEPS = 30
N_LEAVES = 128


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _close(t, j, what=""):
    t, j = _np(t), _np(j)
    scale = max(float(np.abs(j[np.isfinite(j)]).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=RTOL * scale,
                               err_msg=what)


def _ref_leaf_inits(n, seed, device):
    """The reference's per-slot leaf-MLP initial parameters."""
    p = jax.vmap(jmodels.mlp_init)(jax.random.split(jax.random.PRNGKey(seed),
                                                    n))
    return tmodels.MLPParams(*(_t(a).to(device) for a in p))


@pytest.fixture(scope="module")
def pools():
    """(reference linear pool, reference MLP pool) and their carried
    copies in the port."""
    sp = jsynth.generate_pool(0.9, limit=64)
    jl = jreuse.build_pool(sp, kind="linear")
    jm = jreuse.build_pool(sp, kind="mlp", train_steps=STEPS)
    return dict(j_linear=jl, j_mlp=jm,
                t_linear=pool_from_arrays(export_pool(jl), device="cpu"),
                t_mlp=pool_from_arrays(export_pool(jm), device="cpu"))


@pytest.mark.parametrize("eps,kw", [(0.9, {}), (0.65, dict(ns=256, seed=1)),
                                    (0.9, dict(limit=64))])
def test_synth_identical(eps, kw):
    j, t = jsynth.generate_pool(eps, **kw), tsynth.generate_pool(eps, **kw)
    assert t.m == j.m and t.size == j.size
    np.testing.assert_array_equal(t.hists, j.hists)
    np.testing.assert_array_equal(t.datasets, j.datasets)
    if eps == 0.9 and not kw:
        assert t.size == 1221                        # the paper's Table 2


@pytest.mark.parametrize("dtype", (np.float32, np.float64))
def test_prefix_sum_is_xlas_cumsum_order(dtype):
    """XLA:CPU's f32 ``jnp.cumsum`` is neither sequential nor
    ``torch.cumsum``; ``cdf.prefix_sum`` reproduces it bit for bit."""
    rng = np.random.default_rng(0)
    for m in (12, 16, 17, 64, 100, 300):
        a = rng.random((512, m)).astype(dtype)
        a /= a.sum(1, keepdims=True)
        want = np.asarray(jnp.cumsum(jnp.asarray(a), axis=1))
        got = tcdf.prefix_sum(torch.from_numpy(a))
        np.testing.assert_array_equal(_np(got), want, err_msg=f"m={m}")
        if m == 64 and dtype is np.float32:
            assert not np.array_equal(np.cumsum(a, 1), want)


def test_cdf_parity():
    rng = np.random.default_rng(1)
    keys = np.sort(rng.lognormal(0, 1, 3000))
    other = np.sort(rng.uniform(0.5, 4, 1700))
    jk, tk = jnp.asarray(keys), torch.from_numpy(keys)
    norm_j = jcdf.normalize_keys(jk)
    norm_t = tcdf.normalize_keys(tk)
    for a, b in zip(norm_t, norm_j, strict=True):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    for m in (12, 64):
        hs_j = jcdf.histogram_sorted(norm_j[0], m, jnp.float64(0.0),
                                     jnp.float64(1.0))
        hs_t = tcdf.histogram_sorted(norm_t[0], m, 0.0, 1.0)
        np.testing.assert_array_equal(_np(hs_t), np.asarray(hs_j))
        st_j = jcdf.histogram_stream(jnp.asarray(rng.permutation(keys)), m,
                                     jnp.float64(0.5), jnp.float64(6.0))
        st_t = tcdf.histogram_stream(torch.from_numpy(
            rng.permutation(keys)), m, 0.5, 6.0)
        np.testing.assert_array_equal(_np(st_t), np.asarray(st_j))
        ht = rng.random(m)
        ht /= ht.sum()
        pool = rng.random((40, m))
        pool /= pool.sum(1, keepdims=True)
        np.testing.assert_array_equal(
            _np(tcdf.hist_distance(torch.from_numpy(pool[0]),
                                   torch.from_numpy(ht))),
            np.asarray(jcdf.hist_distance(jnp.asarray(pool[0]),
                                          jnp.asarray(ht))))
        np.testing.assert_array_equal(
            _np(tcdf.hist_distance_pool(torch.from_numpy(pool),
                                        torch.from_numpy(ht))),
            np.asarray(jcdf.hist_distance_pool(jnp.asarray(pool),
                                               jnp.asarray(ht))))
    np.testing.assert_array_equal(
        _np(tcdf.ks_distance(tk, torch.from_numpy(other))),
        np.asarray(jcdf.ks_distance(jk, jnp.asarray(other))))


@pytest.mark.parametrize("L,P,m", [(1, 1, 12), (100, 64, 64), (300, 70, 64),
                                   (17, 200, 100)])
def test_k7_plain_matches_ref_and_ops(L, P, m):
    """K7's plain version (what the CUDA kernel computes, bit for bit)
    against ``ref.ksdist_ref`` and the Pallas ``ops.ksdist_matrix`` in
    interpret mode, on the reference's own pool tables."""
    rng = np.random.default_rng(L * 7 + P)
    ph = rng.random((P, m)) ** 3
    ph /= ph.sum(1, keepdims=True)
    th = rng.random((L, m)) ** 3
    th /= th.sum(1, keepdims=True)
    pa, pps = jreuse.pool_prefix_tables(jnp.asarray(ph))
    ta, tps = treuse.pool_prefix_tables(torch.from_numpy(ph))
    np.testing.assert_array_equal(_np(ta), np.asarray(pa))
    np.testing.assert_array_equal(_np(tps), np.asarray(pps))
    got = tks.ksdist(torch.from_numpy(th), ta, tps)
    assert got.dtype == torch.float32 and tuple(got.shape) == (L, P)
    np.testing.assert_array_equal(
        _np(got), np.asarray(jref.ksdist_ref(jnp.asarray(th), pa, pps)))
    np.testing.assert_array_equal(
        _np(tops.ksdist_matrix(torch.from_numpy(th), ta, tps)),
        np.asarray(jops.ksdist_matrix(jnp.asarray(th), pa, pps)))


def test_selection_parity(pools, monkeypatch):
    """Algorithm-1 selection on a carried pool: found, index and dist bit
    for bit, batched (K7 path, over several chunks), fused (one target)
    and unfused (f64 distances)."""
    jp, tp = pools["j_linear"], pools["t_linear"]
    rng = np.random.default_rng(2)
    keys = np.sort(rng.lognormal(0, 1, 20000))
    idx = jrmi.build_rmi(jnp.asarray(keys), n_leaves=300)
    stats = jrmi.leaf_stats_sorted(idx.keys, jrmi.root_buckets(
        "linear", idx.root, idx.keys, 300, idx.n), 300)
    hists = np.array(jrmi.leaf_histograms(
        idx.keys, jrmi.root_buckets("linear", idx.root, idx.keys, 300, idx.n),
        300, jp.m, stats[1], stats[2]))
    if jp.sel_a is None:
        jp._refresh_tables()
    want = jreuse.select_from_pool_batch(jp.sel_a, jp.sel_ps,
                                         jnp.asarray(hists),
                                         jnp.float32(jp.eps))
    monkeypatch.setattr(treuse, "SELECT_CHUNK", 128)
    got = treuse.select_from_pool_batch(*tp.tables(), torch.from_numpy(hists),
                                        tp.eps)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    assert 0 < int(want.found.sum()) < 300
    for i in (0, 7, 150):
        w = jp.select(jnp.asarray(hists[i]))
        g = tp.select(torch.from_numpy(hists[i]))
        for a, b in zip(g, w, strict=True):
            np.testing.assert_array_equal(_np(a), np.asarray(b))
        w = jreuse.select_from_pool(jp.hists, None, jnp.asarray(hists[i]),
                                    jnp.float32(jp.eps))
        g = treuse.select_from_pool(tp.hists, None,
                                    torch.from_numpy(hists[i]), tp.eps)
        for a, b in zip(g, w, strict=True):
            np.testing.assert_array_equal(_np(a), np.asarray(b))


def test_adapt_and_bounds_parity():
    rng = np.random.default_rng(3)
    B = 50
    dom = lambda: [rng.uniform(0, 1, B), rng.uniform(1, 2, B),
                   rng.uniform(0, 10, B), rng.uniform(20, 99, B)]
    s, g = dom(), dom()
    js, jt = jadapt.DomainSpec(*map(jnp.asarray, s)), \
        jadapt.DomainSpec(*map(jnp.asarray, g))
    ts, tt = tadapt.DomainSpec(*map(_t, s)), tadapt.DomainSpec(*map(_t, g))
    lin = [rng.normal(size=B), rng.normal(size=B)]
    want = jax.vmap(jadapt.adapt_linear)(
        jmodels.LinearParams(*map(jnp.asarray, lin)), js, jt)
    got = tadapt.adapt_linear(tmodels.LinearParams(*map(_t, lin)), ts, tt)
    for a, b in zip(got, want, strict=True):
        _close(a, b)
    mlp = [rng.normal(size=(B, 4)), rng.normal(size=(B, 4)),
           rng.normal(size=(B, 4)), rng.normal(size=B)]
    want = jax.vmap(jadapt.adapt_mlp)(
        jmodels.MLPParams(*map(jnp.asarray, mlp)), js, jt)
    got = tadapt.adapt_mlp(tmodels.MLPParams(*map(_t, mlp)), ts, tt)
    for a, b in zip(got, want, strict=True):
        _close(a, b)
    args = [rng.normal(size=B) for _ in range(5)]
    for a, b in zip(tbounds.reuse_err_bounds(*map(_t, args)),
                    jbounds.reuse_err_bounds(*map(jnp.asarray, args)),
                    strict=True):
        _close(a, b)
    for a, b in zip(tbounds.widen_for_inserts(*map(_t, args[:3])),
                    jbounds.widen_for_inserts(*map(jnp.asarray, args[:3])),
                    strict=True):
        _close(a, b)
    keys = np.sort(rng.uniform(5, 9, 77))
    for a, b in zip(tadapt.domain_of(_t(keys)),
                    jadapt.domain_of(jnp.asarray(keys)), strict=True):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def test_mlp_train_parity_from_reference_init():
    """``mlp_train`` from the reference's own ``mlp_init(PRNGKey(s))``,
    one model and a masked batch: the packages seed training
    differently, so both start from the same parameters."""
    rng = np.random.default_rng(4)
    xs = np.sort(rng.random(100))
    ys = np.arange(100.0)
    key = jax.random.PRNGKey(3)
    p0 = jmodels.mlp_init(key)
    want = jmodels.mlp_train(key, jnp.asarray(xs), jnp.asarray(ys),
                             steps=STEPS)
    got = tmodels.mlp_train(tmodels.MLPParams(*map(_t, p0)), _t(xs), _t(ys),
                            steps=STEPS)
    for a, b in zip(got, want, strict=True):
        _close(a, b)
    X = np.sort(rng.random((6, 64)), 1)
    Y = np.cumsum(rng.integers(1, 5, (6, 64)), 1).astype(np.float64)
    M = (rng.random((6, 64)) < 0.8).astype(np.float64)
    keys = jax.random.split(jax.random.PRNGKey(9), 6)
    want = jax.vmap(lambda k, x, y, m: jmodels.mlp_train(
        k, x, y, steps=STEPS, mask=m))(keys, jnp.asarray(X), jnp.asarray(Y),
                                       jnp.asarray(M))
    p0 = jax.vmap(jmodels.mlp_init)(keys)
    got = tmodels.mlp_train(tmodels.MLPParams(*map(_t, p0)), _t(X), _t(Y),
                            steps=STEPS, mask=_t(M))
    for a, b in zip(got, want, strict=True):
        _close(a, b)
    for a, b in zip(tmodels.mlp_err_bounds(got, _t(X), _t(Y)),
                    jax.vmap(jmodels.mlp_err_bounds)(want, jnp.asarray(X),
                                                     jnp.asarray(Y)),
                    strict=True):
        _close(a, b)


def test_build_pool_parity(pools):
    """The linear pool is deterministic: built by both packages it agrees
    (order, histograms and domains exactly).  The MLP pool trains from
    another generator, so only its shape and soundness are held."""
    sp = tsynth.generate_pool(0.9, limit=64)
    t = treuse.build_pool(sp, kind="linear", device="cpu")
    j = pools["j_linear"]
    np.testing.assert_array_equal(_np(t.hists), np.asarray(j.hists))
    for a, b in zip(t.domains, j.domains, strict=True):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    for a, b in zip(t.params, j.params, strict=True):
        _close(a, b)
    _close(t.err_lo, j.err_lo)
    _close(t.err_hi, j.err_hi)
    tm = treuse.build_pool(sp, kind="mlp", train_steps=STEPS, device="cpu")
    assert tm.size == 64 and tm.m == 64 and tm.kind == "mlp"
    w = _np(tm.err_hi - tm.err_lo)
    assert np.all(np.diff(w) >= 0) and np.isfinite(w).all()


@pytest.mark.parametrize("kind", ("mlp", "linear"))
@pytest.mark.parametrize("dist", DISTS)
def test_build_rmi_pool_parity(pools, kind, dist, monkeypatch):
    """RMI-NN-MR / RMI-MR on a carried pool: reused mask and depth exact,
    parameters and bounds within tolerance (fresh leaf MLPs start from the
    reference's initial parameters), lookups on a carried index bit for
    bit on both paths, and the port's own build answers exactly."""
    monkeypatch.setattr(trmi, "_leaf_inits", _ref_leaf_inits)
    rng = np.random.default_rng(5)
    keys = gen_keys(rng, dist, 8192)
    j = jrmi.build_rmi(jnp.asarray(keys), n_leaves=N_LEAVES, kind=kind,
                       pool=pools[f"j_{kind}"], train_steps=STEPS)
    t = trmi.build_rmi(keys, n_leaves=N_LEAVES, kind=kind,
                       pool=pools[f"t_{kind}"], train_steps=STEPS,
                       device="cpu")
    np.testing.assert_array_equal(_np(t.reused_mask),
                                  np.asarray(j.reused_mask))
    assert t.reuse_fraction == j.reuse_fraction
    for f in t.leaves._fields:
        _close(getattr(t.leaves, f), getattr(j.leaves, f), f)
    _close(t.err_lo, j.err_lo, "err_lo")
    _close(t.err_hi, j.err_hi, "err_hi")
    _close(t.leaf_sim, j.leaf_sim, "leaf_sim")
    assert t.search_iters == j.search_iters
    q = gen_queries(rng, keys, 512)
    tc = rmi_from_arrays(export_rmi(j), device="cpu")
    for path in ("kernel", "jnp"):
        np.testing.assert_array_equal(
            _np(trmi.lookup(tc, q, path=path)),
            np.asarray(jrmi.lookup(j, jnp.asarray(q), path=path)),
            err_msg=path)
    np.testing.assert_array_equal(_np(trmi.lookup(t, q, path="jnp")),
                                  np.searchsorted(keys, q))


def test_reuse_or_train_parity(pools):
    """Algorithm 1 end to end on one target: a hit adapts the same pool
    entry; a miss trains (from the reference's init) and enqueues at the
    same rank."""
    jp = pools["j_mlp"]
    tp = pool_from_arrays(export_pool(jp), device="cpu")
    jp = jreuse.ModelPool(**{f: getattr(jp, f) for f in (
        "eps", "m", "kind", "hists", "params", "err_lo", "err_hi",
        "domains")})
    rng = np.random.default_rng(6)
    hit = np.sort(rng.uniform(3.0, 4.0, 500))
    w = jp.reuse_or_train(jnp.asarray(hit))
    g = tp.reuse_or_train(_t(hit))
    assert g.reused and w.reused
    for a, b in zip(g.params, w.params, strict=True):
        _close(a, b)
    _close(g.err_lo, w.err_lo)
    _close(g.err_hi, w.err_hi)
    miss = np.sort(np.concatenate([rng.uniform(0, 1, 400),
                                   rng.uniform(50, 51, 100)]))
    w = jp.reuse_or_train(jnp.asarray(miss), train_steps=STEPS, seed=2)
    g = tp.reuse_or_train(_t(miss), train_steps=STEPS, init=tmodels.MLPParams(
        *map(_t, jmodels.mlp_init(jax.random.PRNGKey(2)))))
    assert not w.reused and not g.reused
    for a, b in zip(g.params, w.params, strict=True):
        _close(a, b)
    assert tp.size == jp.size == 65
    np.testing.assert_array_equal(_np(tp.hists), np.asarray(jp.hists))
    np.testing.assert_array_equal(_np(tp.sel_a), np.asarray(jp.sel_a))


def test_mlp_root_saturates_and_serves(monkeypatch):
    """An MLP root (RMI-NN with ``root_kind="mlp"``): 1e30 and +inf route
    to the last leaf on both the f32 kernel route and the f64 route, and
    a carried MLP-root index answers bit for bit on both paths."""
    monkeypatch.setattr(trmi, "_leaf_inits", _ref_leaf_inits)
    monkeypatch.setattr(trmi, "_root_init", lambda seed, device: (
        tmodels.MLPParams(*map(_t, jmodels.mlp_init(
            jax.random.PRNGKey(seed))))))
    rng = np.random.default_rng(7)
    keys = gen_keys(rng, "lognormal", 4096)
    j = jrmi.build_rmi(jnp.asarray(keys), n_leaves=64, kind="mlp",
                       root_kind="mlp", train_steps=STEPS)
    t = trmi.build_rmi(keys, n_leaves=64, kind="mlp", root_kind="mlp",
                       train_steps=STEPS, device="cpu")
    for f in t.root._fields:
        _close(getattr(t.root, f), getattr(j.root, f), f"root.{f}")
    q = np.array([1e30, np.inf, -1e30, keys[-1]])
    from repro_torch.kernels import lookup as tlk
    blk = tlk.pack_root("mlp", t.root)
    f32q = torch.as_tensor(q, dtype=torch.float32)
    b = tlk.route_bucket(f32q, blk, n_leaves=64, route_n=t.n,
                         root_kind="mlp")
    assert int(b[0]) == int(b[1]) == 63
    tb = trmi.root_buckets("mlp", t.root, _t(q), 64, t.n)
    assert int(tb[0]) == int(tb[1]) == 63
    tc = rmi_from_arrays(export_rmi(j), device="cpu")
    assert tc.root_kind == "mlp"
    qq = gen_queries(rng, keys, 512)
    for path in ("kernel", "jnp"):
        np.testing.assert_array_equal(
            _np(trmi.lookup(tc, qq, path=path)),
            np.asarray(jrmi.lookup(j, jnp.asarray(qq), path=path)),
            err_msg=path)
    np.testing.assert_array_equal(_np(trmi.lookup(t, qq, path="jnp")),
                                  np.searchsorted(keys, qq))
