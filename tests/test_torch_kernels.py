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

import itertools

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


@pytest.mark.parametrize("dist", ("lognormal", "dup-heavy"))
def test_seam_fixed_answers_non_finite_and_one_row_stack(dist):
    """The single-index epilogues on +-inf, NaN, +-0 and members of
    duplicate runs equal the reference's ``ops`` bit for bit (NaN ends its
    runs past the last key, as the reference's searchsorted places it),
    and equal the shard-stacked epilogues on a stack of one row."""
    d, q = _churned(dist, seed=4)
    idx = d.index
    root, mat, vec = idx.packed_tables()
    kw = dict(n_leaves=N_LEAVES, route_n=d.route_n, iters=idx.search_iters)
    tabs = _tables((root, mat, vec))
    kf, dk = _t32(idx.keys), _t32(d.delta_keys)
    bpsum = torch.from_numpy(np.array(d.base_psum))
    dpsum = torch.from_numpy(np.array(d.delta_psum))
    live = d.live_keys()
    q = np.concatenate([q[:400], np.repeat(live[::97], 2),
                        [np.nan, np.inf, -np.inf, 0.0, -0.0, live[0],
                         live[-1], np.nan]])
    hi = q[::-1].copy()
    jq, jhi = jnp.asarray(q), jnp.asarray(hi)
    ops_kw = (d.base_dead, d.base_psum, d.delta_keys, d.delta_dead,
              d.delta_psum)
    found, rank = tops.dynamic_find(_t32(q), *tabs, kf, bpsum, dk, dpsum,
                                    **kw)
    want = jops.dynamic_find(jq, root, mat, vec, idx.keys, *ops_kw, **kw)
    for g, w in zip((found, rank), want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    rng_got = tops.range_lookup(_t32(q), _t32(hi), *tabs, kf, bpsum, dk,
                                dpsum, **kw)
    want = jops.range_lookup(jq, jhi, root, mat, vec, idx.keys, *ops_kw,
                             **kw)
    for g, w in zip(rng_got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    pos = tops.index_lookup(_t32(q), *tabs, kf, n_leaves=N_LEAVES,
                            iters=idx.search_iters)
    want = jops.index_lookup(jq, root, mat, vec, idx.keys,
                             n_leaves=N_LEAVES, iters=idx.search_iters)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want))

    # the same epilogues over a one-row stack
    one = torch.zeros(q.size, dtype=torch.int32)
    df = tlk.pad_delta(dk)
    dps = tops._edge_pad(dpsum, df.shape[0] + 1)
    st = (tabs[0][None], tabs[1][None], tabs[2][None], kf[None])
    got = tops.sharded_dynamic_find(_t32(q), one, *st, bpsum[None], df[None],
                                    dps[None], **kw)
    for g, w in zip(got, (found, rank), strict=True):
        assert torch.equal(g, w)
    got = tops.sharded_range_lookup(_t32(q), _t32(hi), one, *st, bpsum[None],
                                    df[None], dps[None], **kw)
    for g, w in zip(got, rng_got, strict=True):
        assert torch.equal(g, w)
    got = tops.sharded_index_lookup(_t32(q), one, *st, n_leaves=N_LEAVES,
                                    iters=idx.search_iters)
    assert torch.equal(got, pos)


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
    bit, at a small size (the full-size check is chip_smoke.py); K2 and K3
    also with the search depth cut by 3 and by 8 (windows that do not
    converge) and on a second delta tier of 4,224 entries (more than the
    delta probe's first 12 levels visit, not a power of two); K1 with
    linear and MLP leaves, with rows and fence given and built, on leaves
    given an empty leaf's sentinel window, at the depth cut by 3 and 8 and
    at full depth (the fence then searches whole-array windows), on keys
    as a view that starts inside a 32-byte sector, with +-0, +-inf and NaN
    queries."""
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
    rng = np.random.default_rng(6)
    dk2 = tlk.pad_delta(torch.sort(cuda(rng.choice(idx.keys[:4096], 4100)))
                        .values)
    assert dk2.shape[0] == 4224
    cut = [dict(kw, iters=idx.search_iters - c) for c in (3, 8)]
    for dkx, kwx in ((dk, cut[0]), (dk, cut[1]), (dk2, kw), (dk2, cut[0])):
        pairs += [
            (tlk.dynamic_lookup(cuda(q), *tabs, kf, dkx, **kwx),
             tlk.dynamic_lookup_plain(cuda(q), *tabs, kf, dkx, **kwx)),
            (tlk.dynamic_range(cuda(q), cuda(hi), *tabs, kf, dkx, **kwx),
             tlk.dynamic_range_plain(cuda(q), cuda(hi), *tabs, kf, dkx,
                                     **kwx))]
    # K1 on its edges
    S, k0 = kf.shape[0], float(idx.keys[0])
    span = float(idx.keys[-1]) - k0
    ones = torch.ones(N_LEAVES, tlk.H)
    err = torch.from_numpy(rng.integers(2, 300, N_LEAVES).astype(np.float32))
    mlp = tlk.pack_leaves(ones, ones * -k0, ones * (S / span / tlk.H),
                          torch.zeros(N_LEAVES), -err, err)
    specials = cuda(np.array([0.0, -0.0, np.inf, -np.inf, np.nan]))
    qk = torch.cat([cuda(q), specials, kf[:3], kf[-3:]])
    k1 = 0
    for kind, (m, v) in (("linear", tabs[1:]),
                         ("mlp", tuple(a.cuda() for a in mlp))):
        planted = v.clone()
        planted[1, ::5], planted[2, ::5] = -float(S), float(S)
        for vv, keys, it in itertools.product(
                (v, planted), (kf, kf[1:]),
                (idx.search_iters, idx.search_iters - 3,
                 idx.search_iters - 8, tlk.full_iters(S))):
            k1kw = dict(n_leaves=N_LEAVES, iters=it, leaf_kind=kind)
            t1 = (tabs[0], m, vv)
            want = tlk.lookup_plain(qk, *t1, keys, **k1kw)
            pairs.append(((tlk.lookup(qk, *t1, keys, **k1kw),), (want,)))
            pairs.append(((tlk.lookup(
                qk, *t1, keys, rows=tlk.leaf_rows(m, vv, kind),
                fence=tlk.key_fence(keys), **k1kw),), (want,)))
            k1 += 2
    torch.cuda.synchronize()
    for got, want in pairs:
        for g, w in zip(got, want, strict=True):
            assert torch.equal(g, w)
    assert tlk.LAUNCHES["lookup"] == before["lookup"] + 1 + k1
    assert all(tlk.LAUNCHES[k] == before[k] + 5
               for k in ("dynamic_lookup", "dynamic_range"))


@pytest.mark.gpu
def test_cuda_k2_k3_on_unaligned_views():
    """K2 and K3 against their plain versions on the card, bit for bit, when
    both key tiers are views that start inside a 32-byte sector and end in
    a tail that is not a whole sector (a window's sector is loaded whole
    only when it lies inside the tier), with linear and with MLP leaves
    (K2 reads those from leaf-major rows), at full and at cut depth."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d, q = _churned("uniform", seed=7)
    idx = d.index
    root, mat, vec = idx.packed_tables()
    cuda = lambda a: _t32(a).cuda()
    kf, dk = cuda(idx.keys), tlk.pad_delta(cuda(d.delta_keys))
    # MLP leaves predicting the position from the key span, with windows of
    # 2 to 40 keys and every fifth leaf given an empty leaf's +-S window
    rng = np.random.default_rng(8)
    S, k0 = kf.shape[0], float(idx.keys[0])
    span = float(idx.keys[-1]) - k0
    ones = torch.ones(N_LEAVES, tlk.H)
    err = torch.from_numpy(rng.integers(2, 40, N_LEAVES).astype(np.float32))
    err[::5] = S
    mlp = tlk.pack_leaves(ones, ones * -k0, ones * (S / span / tlk.H),
                          torch.zeros(N_LEAVES), -err, err)
    leaves = {"linear": (cuda(mat), cuda(vec)),
              "mlp": tuple(a.cuda() for a in mlp)}
    hi = cuda(q[::-1].copy())
    checked = 0
    for keys, delta in ((kf[1:], dk[3:]), (kf[5:-2], dk[1:-6])):
        assert keys.shape[0] % 8 and delta.shape[0] % 8
        for kind, (m, v) in leaves.items():
            for cut in (0, 8):
                kw = dict(n_leaves=N_LEAVES, route_n=d.route_n,
                          iters=idx.search_iters - cut, leaf_kind=kind)
                tabs = (cuda(root), m, v)
                for got, want in (
                        (tlk.dynamic_lookup(cuda(q), *tabs, keys, delta,
                                            **kw),
                         tlk.dynamic_lookup_plain(cuda(q), *tabs, keys,
                                                  delta, **kw)),
                        (tlk.dynamic_range(cuda(q), hi, *tabs, keys, delta,
                                           **kw),
                         tlk.dynamic_range_plain(cuda(q), hi, *tabs, keys,
                                                 delta, **kw))):
                    torch.cuda.synchronize()
                    for g, w in zip(got, want, strict=True):
                        assert torch.equal(g, w)
                    checked += 1
    assert checked == 16
