"""The MLP branches of kernels K1-K3 and the pooled dynamic index, held
against the reference at small sizes.

* Raw kernel outputs: the plain versions (what the CUDA kernels compute,
  bit for bit) against the eager oracles ``ref.lookup_ref`` /
  ``dynamic_lookup_ref`` / ``dynamic_range_ref`` with MLP roots and
  leaves, on the reference's own packed tables -- bit for bit.  The MLP
  root's four-term sum is pinned to XLA:CPU's order by its own test.
* Seam-fixed answers against ``repro.kernels.ops`` in interpret mode.
* The pooled dynamic index (``Index.build(keys, pool=...)`` with MLP
  leaves): a reference index and its pool carried across, then the same
  seeded churn -- a spread insert, a narrow insert that forces pooled
  rebuilds, duplicates, deletes, a flush -- through both packages.
  Integer outputs, reused masks and budgets bit for bit; f64 parameters
  within ``rtol=1e-9`` (fresh leaf MLPs start from the reference's initial
  parameters; XLA contracts FMAs and sums in another order).
* On a card (``gpu`` marker): the MLP instantiations of K1-K3 and kernel
  K7 against their plain versions.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import repro  # noqa: F401  (enables x64 for the reference)
import jax
import jax.numpy as jnp
from repro.core import models as jmodels
from repro.core import reuse as jreuse
from repro.core import rmi as jrmi
from repro.core import synth as jsynth
from repro.core.updates import DynamicRMI as JDynamicRMI
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from torch_export import (DISTS, export_dynamic, export_pool, gen_keys,
                          gen_queries)

from repro_torch.api import Index
from repro_torch.convert import dynamic_from_arrays, pool_from_arrays
from repro_torch.core import models as tmodels
from repro_torch.core import reuse as treuse
from repro_torch.core import rmi as trmi
from repro_torch.kernels import ksdist as tks
from repro_torch.kernels import lookup as tlk
from repro_torch.kernels import ops as tops

STEPS = 30
N_LEAVES = 64
Q = 512
RTOL = 1e-9


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _t32(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(t, j, what=""):
    t, j = _np(t), _np(j)
    scale = max(float(np.abs(j[np.isfinite(j)]).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=RTOL * scale,
                               err_msg=what)


def _ref_leaf_inits(n, seed, device):
    p = jax.vmap(jmodels.mlp_init)(jax.random.split(jax.random.PRNGKey(seed),
                                                    n))
    return tmodels.MLPParams(*(torch.tensor(np.asarray(a), device=device)
                               for a in p))


@pytest.fixture(scope="module")
def mlp_pool():
    sp = jsynth.generate_pool(0.9, limit=64)
    j = jreuse.build_pool(sp, kind="mlp", train_steps=STEPS)
    return j, pool_from_arrays(export_pool(j), device="cpu")


def _mlp_index(dist, root_kind, seed=0):
    rng = np.random.default_rng(seed)
    keys = gen_keys(rng, dist, 3001)
    idx = jrmi.build_rmi(jnp.asarray(keys), n_leaves=N_LEAVES, kind="mlp",
                         root_kind=root_kind, train_steps=STEPS)
    return idx, keys, gen_queries(rng, keys, Q)


def test_mlp_root_sum_order_is_pinned():
    """The MLP root's ``jnp.sum(h * w2, axis=1) + b2`` runs on XLA:CPU as a
    sequential sum from 0, then + b2; ``mlp_root_predict`` (and the CUDA
    kernel) use that order, which a pairwise order would not match."""
    rng = np.random.default_rng(0)
    root = np.zeros((8, 128), np.float32)
    root[0, :4] = rng.normal(0, 1e3, 4)
    root[1, :4] = rng.normal(0, 1e3, 4)
    root[2, :4] = rng.normal(0, 1, 4) * 10.0 ** rng.integers(-3, 4, 4)
    root[3, 0] = 12.5
    q = (rng.normal(0, 3, 4096) * 10.0 ** rng.integers(-2, 3, 4096)) \
        .astype(np.float32)
    jq, jr = jnp.asarray(q), jnp.asarray(root)
    h = jnp.maximum(jq[:, None] * jr[0, :4] + jr[1, :4], 0.0)
    want = np.asarray(jnp.sum(h * jr[2, :4], axis=1) + jr[3, 0])
    got = _np(tlk.mlp_root_predict(torch.from_numpy(q),
                                   torch.from_numpy(root)))
    np.testing.assert_array_equal(got, want)
    hw = np.asarray(h * jr[2, :4])
    pair = (hw[:, 0] + hw[:, 1]) + (hw[:, 2] + hw[:, 3]) + root[3, 0]
    assert not np.array_equal(pair, want)


@pytest.mark.parametrize("root_kind", ("linear", "mlp"))
@pytest.mark.parametrize("dist", DISTS)
def test_k1_k3_mlp_plain_match_refs(dist, root_kind):
    idx, keys, q = _mlp_index(dist, root_kind)
    root, mat, vec = idx.packed_tables()
    kinds = dict(root_kind=root_kind, leaf_kind="mlp")
    kw = dict(n_leaves=N_LEAVES, iters=idx.search_iters, **kinds)
    tabs = tuple(_t32(a) for a in (root, mat, vec))
    kf = _t32(keys)
    want = jref.lookup_ref(jnp.asarray(q), root, mat, vec, idx.keys, **kw)
    got = tlk.lookup(_t32(q), *tabs, kf, **kw)
    np.testing.assert_array_equal(_np(got), np.asarray(want))

    rng = np.random.default_rng(1)
    delta = np.sort(rng.choice(keys, 200) + 0.25).astype(np.float32) \
        .astype(np.float64)
    dk = jnp.asarray(np.concatenate([delta, np.full(56, np.inf)]))
    want = jref.dynamic_lookup_ref(jnp.asarray(q), root, mat, vec, idx.keys,
                                   dk, route_n=idx.n, **kw)
    got = tlk.dynamic_lookup(_t32(q), *tabs, kf, tlk.pad_delta(_t32(dk)),
                             route_n=idx.n, **kw)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    hi = q[::-1].copy()
    want = jref.dynamic_range_ref(jnp.asarray(q), jnp.asarray(hi), root, mat,
                                  vec, idx.keys, dk, route_n=idx.n, **kw)
    got = tlk.dynamic_range(_t32(q), _t32(hi), *tabs, kf,
                            tlk.pad_delta(_t32(dk)), route_n=idx.n, **kw)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    # the seam-fixed static answer against the Pallas path
    want = jops.index_lookup(jnp.asarray(q), root, mat, vec, idx.keys,
                             n_leaves=N_LEAVES, iters=idx.search_iters,
                             **kinds)
    got = tops.index_lookup(_t32(q), *tabs, kf, n_leaves=N_LEAVES,
                            iters=idx.search_iters, **kinds)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_mlp_kernel_route_saturates():
    """1e30 and +inf reach the last leaf through an MLP root (a positive
    output slope), NaN reaches leaf 0, on the f32 kernel route."""
    root = np.zeros((8, 128), np.float32)
    root[0, :4], root[1, :4] = 1.0, 0.0
    root[2, :4] = 0.25
    q = torch.tensor([1e30, np.inf, -1e30, np.nan, 5.0], dtype=torch.float32)
    b = tlk.route_bucket(q, torch.from_numpy(root), n_leaves=16, route_n=16,
                         root_kind="mlp")
    assert b.tolist() == [15, 15, 0, 0, 5]


def _pooled_state(d):
    return dict(rebuilds=d.rebuilds, base_n=d.base_n, delta_live=d.delta_live,
                delta_dead=d.delta_dead_count, base_dead=d.base_dead_count,
                deleted=d.deleted, iters=d.index.search_iters,
                cap=int(d.index.keys.shape[0]),
                dcap=int(d.delta_keys.shape[0]))


def _compare_pooled(t, j, rng, step):
    assert _pooled_state(t) == _pooled_state(j), step
    np.testing.assert_array_equal(t.n_inserts, j.n_inserts, err_msg=step)
    np.testing.assert_array_equal(t.budget, j.budget, err_msg=step)
    np.testing.assert_array_equal(_np(t.index.reused_mask),
                                  np.asarray(j.index.reused_mask),
                                  err_msg=step)
    for f in t.index.leaves._fields:
        _close(getattr(t.index.leaves, f), getattr(j.index.leaves, f),
               f"{step}: {f}")
    _close(t.index.err_lo, j.index.err_lo, f"{step}: err_lo")
    _close(t.index.err_hi, j.index.err_hi, f"{step}: err_hi")
    live = j.live_keys()
    np.testing.assert_array_equal(t.live_keys(), live, err_msg=step)
    q = gen_queries(rng, live, 256)
    hi = (q + rng.exponential(float(live[-1] - live[0]) / 50, 256)) \
        .astype(np.float32).astype(np.float64)
    for path in ("jnp", "kernel"):
        for got, want in zip(t.find(q, path=path),
                             j.find(jnp.asarray(q), path=path), strict=True):
            np.testing.assert_array_equal(_np(got), np.asarray(want),
                                          err_msg=f"{step} find {path}")
        for got, want in zip(t.find_range(q, hi, path=path),
                             j.find_range(jnp.asarray(q), jnp.asarray(hi),
                                          path=path), strict=True):
            np.testing.assert_array_equal(_np(got), np.asarray(want),
                                          err_msg=f"{step} range {path}")


@pytest.mark.parametrize("dist", ("uniform", "lognormal"))
def test_pooled_dynamic_churn(mlp_pool, dist, monkeypatch):
    """The paper's lazy path under churn: every rebuild of an MLP leaf
    re-selects from the pool (Algorithm 1), in both packages alike."""
    monkeypatch.setattr(trmi, "_leaf_inits", _ref_leaf_inits)
    jp, tp = mlp_pool
    rng = np.random.default_rng(20)
    keys = gen_keys(rng, dist, 4096)
    j = JDynamicRMI.build(jnp.asarray(keys), pool=jp, n_leaves=N_LEAVES,
                          kind="mlp", train_steps=STEPS)
    t = dynamic_from_arrays(export_dynamic(j), pool=tp, device="cpu")
    _compare_pooled(t, j, rng, "carried")
    lo, hi = keys[0], keys[-1]
    f32 = lambda a: np.asarray(a, np.float32).astype(np.float64)

    def both(verb, arg):
        getattr(j, verb)(jnp.asarray(arg))
        getattr(t, verb)(arg)

    both("insert_batch", f32(rng.uniform(lo, hi, 300)))
    both("insert_batch", f32(rng.uniform(lo, lo + (hi - lo) * 0.01, 700)))
    assert j.rebuilds > 0
    both("insert_batch", rng.choice(keys, 200))                 # duplicates
    _compare_pooled(t, j, rng, "inserts")
    both("delete_batch", rng.choice(j.live_keys(), 300))
    both("insert_batch", f32(rng.uniform(lo, lo + (hi - lo) * 0.02, 600)))
    _compare_pooled(t, j, rng, "deletes + rebuild")
    j.flush_delta()
    t.flush_delta()
    _compare_pooled(t, j, rng, "flushed")


def test_pooled_index_facade(mlp_pool, monkeypatch):
    """``Index.build(keys, pool=...)`` in the port alone: a narrow insert
    forces rebuilds that re-select from the pool (one selection batch of
    the rebuilt leaves), and every answer equals the sorted-array truth."""
    tp = mlp_pool[1]
    rng = np.random.default_rng(21)
    keys = gen_keys(rng, "lognormal", 6000)
    ix = Index.build(keys, pool=tp, kind="mlp", n_leaves=N_LEAVES,
                     train_steps=STEPS, device="cpu")
    assert ix.backend.index.reuse_fraction > 0
    selected = []

    def counting(sel_a, sel_ps, hists, eps, **kw):
        selected.append(hists.shape[0])
        return treuse.select_from_pool_batch(sel_a, sel_ps, hists, eps, **kw)

    monkeypatch.setattr(trmi, "select_from_pool_batch", counting)
    ix.insert(np.asarray(rng.uniform(keys[0], keys[0] + 1.0, 900),
                         np.float32).astype(np.float64))
    assert ix.backend.rebuilds > 0
    assert selected and sum(selected) == ix.backend.rebuilds
    ix.delete(rng.choice(ix.live_keys(), 500))
    live = ix.live_keys()
    q = gen_queries(rng, live, Q)
    for path in ("kernel", "jnp"):
        found, rank = ix.find(q, path=path)
        np.testing.assert_array_equal(_np(rank), np.searchsorted(live, q))
        np.testing.assert_array_equal(
            _np(found), np.searchsorted(live, q, side="right") > _np(rank))
        rl, rh = ix.find_range(q, q + 0.5, path=path)
        np.testing.assert_array_equal(_np(rl), np.searchsorted(live, q))
        np.testing.assert_array_equal(
            _np(rh), np.maximum(np.searchsorted(live, q + 0.5, side="right"),
                                np.searchsorted(live, q)))


@pytest.mark.gpu
def test_cuda_mlp_kernels_and_k7_match_plain():
    """The MLP instantiations of K1-K3 and kernel K7 against their plain
    versions on the card, bit for bit, at a small size (the full-size
    check is chip_smoke.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    idx, keys, q = _mlp_index("lognormal", "mlp", seed=5)
    root, mat, vec = idx.packed_tables()
    cuda = lambda a: _t32(a).cuda()
    tabs = tuple(cuda(a) for a in (root, mat, vec))
    kf = cuda(keys)
    dk = tlk.pad_delta(cuda(np.sort(keys[::7] + 0.5)))
    kw = dict(n_leaves=N_LEAVES, route_n=idx.n, iters=idx.search_iters,
              root_kind="mlp", leaf_kind="mlp")
    hi = q[::-1].copy()
    before = dict(tlk.LAUNCHES)
    pairs = [
        ((tlk.lookup(cuda(q), *tabs, kf, **kw),),
         (tlk.lookup_plain(cuda(q), *tabs, kf, **kw),)),
        (tlk.dynamic_lookup(cuda(q), *tabs, kf, dk, **kw),
         tlk.dynamic_lookup_plain(cuda(q), *tabs, kf, dk, **kw)),
        (tlk.dynamic_range(cuda(q), cuda(hi), *tabs, kf, dk, **kw),
         tlk.dynamic_range_plain(cuda(q), cuda(hi), *tabs, kf, dk, **kw)),
    ]
    rng = np.random.default_rng(6)
    ph = torch.tensor(rng.random((300, 64)) ** 3).cuda()
    ph /= ph.sum(1, keepdim=True)
    th = torch.tensor(rng.random((1000, 64)) ** 3).cuda()
    th /= th.sum(1, keepdim=True)
    pa, pps = treuse.pool_prefix_tables(ph)
    k7 = tks.LAUNCHES["ksdist"]
    pairs.append(((tks.ksdist(th, pa, pps),),
                  (tks.ksdist_plain(th, pa, pps),)))
    torch.cuda.synchronize()
    for got, want in pairs:
        for g, w in zip(got, want, strict=True):
            assert torch.equal(g, w)
    assert all(tlk.LAUNCHES[k] == before[k] + 1 for k in
               ("lookup", "dynamic_lookup", "dynamic_range"))
    assert tks.LAUNCHES["ksdist"] == k7 + 1
    # K7 over bin counts on either side of a 16-bin block and of the 64
    # bins a pass stages, L and P not multiples of the 128 x 64 tile, P = 1,
    # f32 and f64 targets, NaN in a target row and in a pool row (the f32
    # path), an empty target and pool row (an output of +0, recomputed on
    # the integer path), a negated row and an infinite one; each call is
    # one table and one distance launch
    for m in (1, 17, 64, 257):
        for L, P in ((1000, 300), (1, 1), (129, 65), (300, 1)):
            ph = torch.tensor(rng.random((P, m)) ** 3).cuda()
            ph /= ph.sum(1, keepdim=True)
            th = torch.tensor(rng.random((L, m)) ** 3).cuda()
            th /= th.sum(1, keepdim=True)
            edge = th.clone()
            edge[0] = 0.0
            if L > 3 and P > 2 and m > 5:
                th[3, 5] = float("nan")
                ph[2, m - 1] = float("nan")
                edge[1] *= -1.0
                edge[2, 1] = float("inf")
            pa, pps = treuse.pool_prefix_tables(ph)
            if P > 1:
                pa[0], pps[0] = 0.0, 0.0
            for h in (th, th.float(), edge):
                before = dict(tks.LAUNCHES)
                got = tks.ksdist(h, pa, pps)
                assert tks.LAUNCHES["ksdist"] == before["ksdist"] + 1
                assert tks.LAUNCHES["ksdist_tables"] == \
                    before["ksdist_tables"] + 1
                want = tks.ksdist_plain(h, pa, pps)
                ta, pt = tks.tables(h)
                wa, wp = tks.target_tables(h)
                torch.cuda.synchronize()
                what = (m, L, P, h.dtype)
                assert torch.equal(got.isnan(), want.isnan()), what
                assert torch.equal(got.nan_to_num(0.0), want.nan_to_num(0.0)), \
                    what
                for g, w in ((ta, wa), (pt, wp)):
                    assert torch.equal(g.isnan(), w.isnan()), what
                    assert torch.equal(g.nan_to_num(0.0).view(torch.int32),
                                       w.nan_to_num(0.0).view(torch.int32)), \
                        what
