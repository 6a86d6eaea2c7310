"""Kernels K1-K3 of the port held against the reference, at small sizes.

* Raw outputs: the port's plain versions (what the CUDA kernels compute,
  bit for bit) against the reference oracles ``ref.lookup_ref`` /
  ``dynamic_lookup_ref`` / ``dynamic_range_ref`` on the reference's own
  packed tables -- bit for bit.  With S <= 2**18 the reference searches
  one key tile, so its tiled search and the port's global search agree.
  The oracles run eagerly: XLA:CPU contracts ``a*q + b`` into an FMA
  inside a jit, and the port (like the CUDA kernels) never does.
* Seam-fixed answers: the port's ``ops`` against ``ops.index_lookup`` /
  ``dynamic_find`` / ``range_lookup`` (Pallas interpret mode) -- bit for
  bit.
* The two pinned trouble spots: saturating float->int32 routing, and the
  window clamps rounded to f32.
* On a card (``gpu`` marker): each CUDA kernel against its plain version.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import repro  # noqa: F401  (enables x64 for the reference)
import jax.numpy as jnp
from repro.core import rmi as jrmi
from repro.core.updates import DynamicRMI as JDynamicRMI
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from torch_export import DISTS, export_rmi, gen_keys, gen_queries

from repro_torch.convert import rmi_from_arrays
from repro_torch.core import rmi as trmi
from repro_torch.kernels import lookup as tlk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

N_LEAVES = 64
Q = 512


def _t32(a):
    return torch.from_numpy(np.array(a, np.float32))


def _tables(packed):
    return tuple(_t32(a) for a in packed)


def _churned(dist: str, seed: int = 0):
    """A reference dynamic index with a populated delta tier, a rebuild
    behind it and tombstones in both tiers, plus an f32-exact query mix."""
    rng = np.random.default_rng(seed)
    keys = gen_keys(rng, dist, 4096)
    d = JDynamicRMI.build(jnp.asarray(keys), n_leaves=N_LEAVES)
    span = keys[-1] - keys[0]
    d.insert_batch(rng.uniform(keys[0], keys[0] + span * 0.02, 600)
                   .astype(np.float32).astype(np.float64))     # rebuilds
    d.insert_batch(rng.choice(keys, 300))                      # duplicates
    live = d.live_keys()
    d.delete_batch(rng.choice(live, 400))
    assert d.rebuilds > 0 and d.delta_live > 0 and d.base_dead_count > 0
    return d, gen_queries(rng, d.live_keys(), Q)


@pytest.mark.parametrize("dist", DISTS)
def test_k1_plain_matches_lookup_ref(dist):
    rng = np.random.default_rng(1)
    keys = gen_keys(rng, dist, 3001)          # S not a power of two
    idx = jrmi.build_rmi(jnp.asarray(keys), n_leaves=N_LEAVES)
    root, mat, vec = idx.packed_tables()
    q = gen_queries(rng, keys, Q)
    want = np.asarray(jref.lookup_ref(jnp.asarray(q), root, mat, vec,
                                      idx.keys, n_leaves=N_LEAVES,
                                      iters=idx.search_iters))
    got = tlk.lookup(_t32(q), *_tables((root, mat, vec)), _t32(keys),
                     n_leaves=N_LEAVES, iters=idx.search_iters)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dist", DISTS)
def test_k2_k3_plain_match_refs(dist):
    d, q = _churned(dist)
    idx = d.index
    root, mat, vec = idx.packed_tables()
    kw = dict(n_leaves=N_LEAVES, route_n=d.route_n, iters=idx.search_iters)
    tabs = _tables((root, mat, vec))
    kf, dk = _t32(idx.keys), _t32(d.delta_keys)
    want = jref.dynamic_lookup_ref(jnp.asarray(q), root, mat, vec, idx.keys,
                                   d.delta_keys, **kw)
    got = tlk.dynamic_lookup(_t32(q), *tabs, kf, tlk.pad_delta(dk), **kw)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    hi = (q + np.abs(np.random.default_rng(2).normal(0, 50, Q))) \
        .astype(np.float32).astype(np.float64)
    want = jref.dynamic_range_ref(jnp.asarray(q), jnp.asarray(hi), root, mat,
                                  vec, idx.keys, d.delta_keys, **kw)
    got = tlk.dynamic_range(_t32(q), _t32(hi), *tabs, kf, tlk.pad_delta(dk),
                            **kw)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("dist", ("lognormal", "dup-heavy"))
def test_seam_fixed_answers_match_ops(dist):
    d, q = _churned(dist, seed=3)
    idx = d.index
    root, mat, vec = idx.packed_tables()
    kw = dict(n_leaves=N_LEAVES, route_n=d.route_n, iters=idx.search_iters)
    tabs = _tables((root, mat, vec))
    kf, dk = _t32(idx.keys), _t32(d.delta_keys)
    bpsum = torch.from_numpy(np.array(d.base_psum))
    dpsum = torch.from_numpy(np.array(d.delta_psum))
    jq = jnp.asarray(q)

    want = jops.index_lookup(jq, root, mat, vec, idx.keys,
                             n_leaves=N_LEAVES, iters=idx.search_iters)
    got = tops.index_lookup(_t32(q), *tabs, kf, n_leaves=N_LEAVES,
                            iters=idx.search_iters)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    want = jops.dynamic_find(jq, root, mat, vec, idx.keys, d.base_dead,
                             d.base_psum, d.delta_keys, d.delta_dead,
                             d.delta_psum, **kw)
    got = tops.dynamic_find(_t32(q), *tabs, kf, bpsum, dk, dpsum, **kw)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    truth = tref.dynamic_find_ref(_t32(q), kf, bpsum, dk, dpsum)
    for g, w in zip(got, truth, strict=True):
        assert torch.equal(g, w)

    hi = q[::-1].copy()                      # includes lo > hi pairs
    want = jops.range_lookup(jq, jnp.asarray(hi), root, mat, vec, idx.keys,
                             d.base_dead, d.base_psum, d.delta_keys,
                             d.delta_dead, d.delta_psum, **kw)
    got = tops.range_lookup(_t32(q), _t32(hi), *tabs, kf, bpsum, dk, dpsum,
                            **kw)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    truth = tref.dynamic_range_find_ref(_t32(q), _t32(hi), kf, bpsum, dk,
                                        dpsum)
    for g, w in zip(got, truth, strict=True):
        assert torch.equal(g, w)


def test_routing_saturates_like_xla():
    """A key or query beyond the root's range lands in leaf L-1, not 0:
    XLA's float->int32 saturates, torch's does not."""
    L = N_LEAVES
    x32 = np.array([np.inf, 1e30, 3e9, -3e9, -np.inf, np.nan, 5.7, -0.5],
                   np.float32)
    want = np.asarray(jnp.clip(jnp.asarray(x32).astype(jnp.int32), 0, L - 1))
    np.testing.assert_array_equal(
        tlk.trunc_clip(torch.as_tensor(x32), 0, L - 1).numpy(), want)
    assert want[0] == want[1] == L - 1 and want[5] == 0

    keys = gen_keys(np.random.default_rng(4), "uniform", 2048)
    idx = jrmi.build_rmi(jnp.asarray(keys), n_leaves=L)
    tidx = rmi_from_arrays(export_rmi(idx), device="cpu")
    q = np.array([1e30, np.inf, -1e30, keys[-1]], np.float64)
    want = np.asarray(jrmi.root_buckets("linear", idx.root, jnp.asarray(q),
                                        L, idx.n))
    got = trmi.root_buckets("linear", tidx.root, torch.as_tensor(q), L,
                            tidx.n)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0] == got[1] == L - 1


def test_window_clamp_rounds_to_f32():
    """At n_keys = 2**28 the clamp n_keys - 1 rounds to 2**28 in f32; the
    port mirrors the reference rather than clamping at 2**28 - 1."""
    S = 1 << 28
    L = 4
    root = np.zeros((8, 128), np.float32)
    root[0, 0], root[3, 0] = 1.0, 0.0
    mat = np.zeros((12, 128), np.float32)
    vec = np.zeros((8, 128), np.float32)
    mat[0, :L] = 1.0                                  # pred = q
    vec[1, :L], vec[2, :L] = -2.0, 2.0
    q = np.array([3e8, float(S - 1), 1e5, -5.0, np.inf], np.float32)
    lo, hi = tlk.route_window(torch.as_tensor(q), *_tables((root, mat, vec)),
                              n_keys=S, n_leaves=L, route_n=S)
    wlo, whi = jref._route_window_ref(
        jnp.asarray(q), jnp.asarray(root), jnp.asarray(mat), jnp.asarray(vec),
        n_leaves=L, route_n=S, root_kind="linear", leaf_kind="linear", S=S,
        lp=128)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(wlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(whi))
    assert int(lo[0]) == S            # f32(S - 1) == S


@pytest.mark.gpu
def test_cuda_kernels_match_plain():
    """Each CUDA kernel against its plain version on the card, bit for
    bit, at a small size (the full-size check is chip_smoke.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d, q = _churned("lognormal", seed=5)
    idx = d.index
    root, mat, vec = idx.packed_tables()
    kw = dict(n_leaves=N_LEAVES, route_n=d.route_n, iters=idx.search_iters)
    cuda = lambda a: _t32(a).cuda()
    tabs = tuple(cuda(a) for a in (root, mat, vec))
    kf, dk = cuda(idx.keys), tlk.pad_delta(cuda(d.delta_keys))
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
    torch.cuda.synchronize()
    for got, want in pairs:
        for g, w in zip(got, want, strict=True):
            assert torch.equal(g, w)
    assert all(tlk.LAUNCHES[k] == before[k] + 1
               for k in ("lookup", "dynamic_lookup", "dynamic_range"))
