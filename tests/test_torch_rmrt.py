"""The RMRT (``core.rmrt``) and its kernel K4 held against the reference,
at small sizes.

* ``build_rmrt`` on a carried pool: structure bit for bit (depth, node
  count, ``is_leaf``, ``child_base``, reused mask) and lookups exact on
  both paths; f64 parameters within ``rtol=1e-7``: the level fits sum f64
  segment moments in another order than XLA (``index_add`` against its
  sequential scatter) and uncentred moments cancel, so the last bits
  differ more than in the RMI's centred fits.  MLP node models start from
  the reference's initial parameters.
* K4's plain version (what the CUDA kernel computes, bit for bit) against
  the eager oracle ``ref.rmrt_lookup_ref`` on the reference's own packed
  tables, and the seam-fixed answers against ``ops.rmrt_lookup`` in
  interpret mode -- bit for bit.
* Saturation: 1e30 and +inf descend to the last child at every level.
* On a card (``gpu`` marker): K4 against its plain version.
"""
from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

import repro  # noqa: F401  (enables x64 for the reference)
import jax
import jax.numpy as jnp
from repro.core import models as jmodels
from repro.core import reuse as jreuse
from repro.core import rmrt as jrmrt
from repro.core import synth as jsynth
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from torch_export import export_pool, export_rmrt, gen_keys, gen_queries

from repro_torch.convert import pool_from_arrays, rmrt_from_arrays
from repro_torch.core import models as tmodels
from repro_torch.core import rmi as trmi
from repro_torch.core import rmrt as trmrt
from repro_torch.kernels import lookup as tlk
from repro_torch.kernels import ops as tops

STEPS = 30
RTOL = 1e-7
Q = 512


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
def pools():
    sp = jsynth.generate_pool(0.9, limit=64)
    out = {}
    for kind in ("linear", "mlp"):
        j = jreuse.build_pool(sp, kind=kind, train_steps=STEPS)
        out[kind] = (j, pool_from_arrays(export_pool(j), device="cpu"))
    return out


CASES = [("linear", "uniform", True), ("linear", "lognormal", True),
         ("linear", "zipf", False), ("mlp", "uniform", True)]


@pytest.mark.parametrize("kind,dist,pooled", CASES)
def test_build_rmrt_parity(pools, kind, dist, pooled, monkeypatch):
    monkeypatch.setattr(trmi, "_leaf_inits", _ref_leaf_inits)
    rng = np.random.default_rng(3)
    keys = gen_keys(rng, dist, 6000)
    jp, tp = pools[kind] if pooled else (None, None)
    kw = dict(leaf_cap=512, fanout=8, kind=kind, train_steps=STEPS)
    j = jrmrt.build_rmrt(jnp.asarray(keys), pool=jp, **kw)
    t = trmrt.build_rmrt(keys, pool=tp, device="cpu", **kw)
    assert (t.depth, t.num_nodes) == (j.depth, j.num_nodes)
    for f in ("is_leaf", "child_base", "reused_mask"):
        np.testing.assert_array_equal(_np(getattr(t, f)),
                                      np.asarray(getattr(j, f)), err_msg=f)
    assert t.reuse_fraction == j.reuse_fraction
    for f in ("y_start", "y_end", "node_sim"):
        np.testing.assert_array_equal(_np(getattr(t, f)),
                                      np.asarray(getattr(j, f)), err_msg=f)
    for f in t.params._fields:
        _close(getattr(t.params, f), getattr(j.params, f), f)
    _close(t.err_lo, j.err_lo, "err_lo")
    _close(t.err_hi, j.err_hi, "err_hi")
    q = gen_queries(rng, keys, Q)
    tc = rmrt_from_arrays(export_rmrt(j), device="cpu")
    for path in ("kernel", "jnp"):
        want = np.asarray(jrmrt.lookup(j, jnp.asarray(q), path=path))
        np.testing.assert_array_equal(_np(trmrt.lookup(tc, q, path=path)),
                                      want, err_msg=path)
        np.testing.assert_array_equal(_np(trmrt.lookup(t, q, path=path)),
                                      want, err_msg=f"own build, {path}")


@pytest.mark.parametrize("kind", ("linear", "mlp"))
def test_k4_plain_matches_ref_and_ops(pools, kind):
    rng = np.random.default_rng(4)
    keys = gen_keys(rng, "lognormal", 5000)
    j = jrmrt.build_rmrt(jnp.asarray(keys), leaf_cap=256, fanout=8, kind=kind,
                         pool=pools[kind][0], train_steps=STEPS)
    assert j.depth >= 2
    mat, vec = j.packed_tables()
    tc = rmrt_from_arrays(export_rmrt(j), device="cpu")
    tm, tv = tc.packed_tables()
    np.testing.assert_array_equal(_np(tm), np.asarray(mat))
    np.testing.assert_array_equal(_np(tv), np.asarray(vec))
    q = gen_queries(rng, keys, Q)
    kw = dict(fanout=j.fanout, depth=j.depth, kind=kind)
    want = jref.rmrt_lookup_ref(jnp.asarray(q), mat, vec, j.keys,
                                iters=j.search_iters, **kw)
    got = tlk.rmrt_lookup(_t32(q), tm, tv, tc.keys_f32, iters=tc.search_iters,
                          **kw)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    want = jops.rmrt_lookup(jnp.asarray(q), mat, vec, j.keys, **kw)
    got = tops.rmrt_lookup(_t32(q), tm, tv, tc.keys_f32, **kw)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_array_equal(
        _np(got), np.searchsorted(keys.astype(np.float32),
                                  q.astype(np.float32)))


def test_rmrt_descent_saturates(pools):
    """1e30 and +inf descend to the last child at every level (XLA's
    saturating float->int32), on the kernel route and the f64 route."""
    keys = gen_keys(np.random.default_rng(5), "uniform", 6000)
    t = trmrt.build_rmrt(keys, leaf_cap=256, fanout=8, kind="linear",
                         device="cpu")
    assert t.depth >= 2
    q = torch.tensor([1e30, np.inf], dtype=torch.float64)
    # the last node reached by always taking the last child
    node = 0
    while not bool(t.is_leaf[node]):
        node = int(t.child_base[node]) + t.fanout - 1
    mat, vec = t.packed_tables()
    lo, hi = tlk.rmrt_route_window(q.to(torch.float32), mat, vec, n_keys=t.n,
                                   fanout=t.fanout, depth=t.depth)
    plo, phi = tlk.lane_window(
        tlk.lane_predict(q.to(torch.float32), mat, vec,
                         torch.full((2,), node), "linear"),
        vec, torch.full((2,), node), t.n)
    assert torch.equal(lo, plo) and torch.equal(hi, phi)
    np.testing.assert_array_equal(_np(trmrt.lookup(t, q, path="jnp")),
                                  [t.n, t.n])
    np.testing.assert_array_equal(_np(trmrt.lookup(t, q, path="kernel")),
                                  [t.n, t.n])


def test_pack_rmrt_refuses_2_24_nodes():
    n = 1 << 24
    z = torch.zeros((n,), dtype=torch.float64)
    with pytest.raises(ValueError, match="2\\^24"):
        tlk.pack_rmrt("linear", tmodels.LinearParams(z, z),
                      torch.zeros((n,), dtype=torch.bool),
                      torch.zeros((n,), dtype=torch.int32), z, z, z, z)


@pytest.mark.gpu
def test_cuda_k4_matches_plain(pools):
    """K4 against its plain version on the card, bit for bit, both node
    kinds (the full-size check is chip_smoke.py): with the node rows and
    key fence the RMRT caches and with rows and fence the wrapper builds,
    on nodes given an empty leaf's sentinel window, at the clamped depth,
    cut by 3 and 8 and at full depth (the fence then searches whole-array
    windows), on keys as a view that starts inside a 32-byte sector, with
    +-0, +-inf and NaN queries."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    keys = gen_keys(np.random.default_rng(6), "lognormal", 5000)
    specials = torch.tensor([0.0, -0.0, np.inf, -np.inf, np.nan]).cuda()
    for kind in ("linear", "mlp"):
        j = jrmrt.build_rmrt(jnp.asarray(keys), leaf_cap=256, fanout=8,
                             kind=kind, train_steps=STEPS)
        t = rmrt_from_arrays(export_rmrt(j), device="cuda")
        mat, vec = (_t32(a).cuda() for a in j.packed_tables())
        assert torch.equal(mat, t.packed_tables()[0])
        kf = _t32(keys).cuda()
        q = torch.cat([_t32(gen_queries(np.random.default_rng(7), keys,
                                        Q)).cuda(), specials, kf[:3],
                       kf[-3:]])
        kw = dict(fanout=j.fanout, depth=j.depth, kind=kind)
        before = tlk.LAUNCHES["rmrt_lookup"]
        got = tlk.rmrt_lookup(q, mat, vec, kf, iters=j.search_iters,
                              rows=t.node_rows(), fence=t.key_fence, **kw)
        want = tlk.rmrt_lookup_plain(q, mat, vec, kf, iters=j.search_iters,
                                     **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        planted = vec.clone()
        leaves = torch.nonzero(t.is_leaf).squeeze(1)[::5]
        planted[1, leaves], planted[2, leaves] = -5000.0, 5000.0
        launches = 1
        for v, keys_, it in itertools.product(
                (vec, planted), (kf, kf[1:]),
                (j.search_iters, j.search_iters - 3, j.search_iters - 8,
                 tlk.full_iters(5000))):
            got = tlk.rmrt_lookup(q, mat, v, keys_, iters=it, **kw)
            want = tlk.rmrt_lookup_plain(q, mat, v, keys_, iters=it, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (kind, it, keys_.shape[0])
            launches += 1
        assert tlk.LAUNCHES["rmrt_lookup"] == before + launches
