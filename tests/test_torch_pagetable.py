"""The port's ``DynamicPageTable`` (``repro_torch.serve.kvcache``) against
the reference's (``repro.serve.kvcache``), and the per-key ``insert`` /
``delete`` of ``DynamicRMI``.

The same allocate / release sequence over six requests -- crossing request
4, where the packed keys ``(req << 22) | block`` stop being f32-exact --
drives both packages' tables over ``DynamicRMI`` and over the sharded
index on a one-shard mesh (the reference's on a one-device mesh, in
process); after every step each table's ``(found, page)`` over every
allocated block, released ones and blocks past the ends must equal the
other package's and the cache's own ``table`` dict, and
``maintenance_stats`` must be equal.  On two shards the port's table is
held against the cache and its ``DynamicRMI`` table (the reference's
sharded ``find`` on more than one device needs a batch that splits evenly
over the shards, ROADMAP queue 3).  ``path="auto"`` takes the f64 path
here (CPU tensors); on the card the table's lookups take K2 for requests
0-3 and the f64 path from request 4 on (``chip_smoke.py`` path G).
"""
from __future__ import annotations

import types

import numpy as np
import pytest

from repro_torch.core import distributed as D
from repro_torch.core.updates import DynamicRMI
from repro_torch.serve import kvcache as K

PAGES = 1024
BLOCKS = {0: 70, 1: 45, 2: 90, 3: 33, 4: 64, 5: 20, 6: 51}


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    import repro  # noqa: F401  (enables x64 for the reference)
    from repro.core.updates import DynamicRMI as JDynamicRMI
    from repro.serve import kvcache as rkv
    return types.SimpleNamespace(jax=jax, jnp=jnp, kv=rkv, dyn=JDynamicRMI)


# allocate (req) or release (-req - 1), after priming requests 0 and 1
STEPS = (2, 3, 4, -2, 5, -5, 6, -1)


def _cache(mod, **kw):
    c = mod.PagedKVCache(n_pages=PAGES, page_size=16, n_kv_heads=1,
                         head_dim=8, n_layers=1, **kw)
    for req in (0, 1):
        c.allocate_batch(req, range(BLOCKS[req]))
    return c


def _queries() -> np.ndarray:
    """Every block of every request and a few past each end, packed."""
    return np.concatenate([K._pack_keys(r, range(n + 5))
                           for r, n in BLOCKS.items()])


def _truth(cache, q):
    found, page = [], []
    for k in q.astype(np.int64):
        p = cache.table.get((int(k >> K._BLOCK_BITS),
                             int(k & ((1 << K._BLOCK_BITS) - 1))))
        found.append(p is not None)
        page.append(p)
    return np.asarray(found), page


def _check(table, q, what):
    found, page = table.lookup(q)
    want_f, want_p = _truth(table.cache, q)
    np.testing.assert_array_equal(found, want_f, err_msg=what)
    np.testing.assert_array_equal(page[want_f],
                                  np.asarray(want_p, object)[want_f]
                                  .astype(np.int64), err_msg=what)
    return found, page


def _step(table, s):
    if s >= 0:
        table.allocate(s, range(BLOCKS[s]))
    else:
        table.release(-s - 1)


@pytest.mark.parametrize("sharded", (False, True))
def test_dynamic_page_table_matches_reference(ref, sharded):
    q = _queries()
    rc = _cache(ref.kv)
    tc = _cache(K, device="cpu")
    if sharded:
        mesh = ref.jax.make_mesh((1,), ("data",))
        rt = ref.kv.DynamicPageTable.build(rc, mesh=mesh)
        tt = K.DynamicPageTable.build(tc, mesh=D.ShardMesh(1),
                                      device="cpu")
    else:
        rt = ref.kv.DynamicPageTable.build(rc)
        tt = K.DynamicPageTable.build(tc, device="cpu")
    assert tt.dyn.f32_exact
    for i, s in enumerate(STEPS):
        _step(rt, s)
        _step(tt, s)
        assert tc.table == rc.table and tc.free == rc.free
        rf, rp = rt.lookup(ref.jnp.asarray(q))
        tf, tp = _check(tt, q, f"step {i}")
        np.testing.assert_array_equal(tf, rf, err_msg=f"found, step {i}")
        np.testing.assert_array_equal(tp, rp, err_msg=f"page, step {i}")
        assert tt.maintenance_stats() == rt.maintenance_stats(), i
        np.testing.assert_array_equal(tt._keys, rt._keys)
        np.testing.assert_array_equal(tt._pages, rt._pages)
    # requests 4 on took the key space past f32
    assert not tt.dyn.f32_exact


def test_sharded_page_table_on_two_shards():
    """On two shards: every step against the cache and the single-index
    table; then everything released."""
    q = _queries()
    one = K.DynamicPageTable.build(_cache(K, device="cpu"), device="cpu")
    two = K.DynamicPageTable.build(_cache(K, device="cpu"),
                                   mesh=D.ShardMesh(2), device="cpu")
    assert two.dyn.n_shards == 2
    for i, s in enumerate(STEPS):
        _step(one, s)
        _step(two, s)
        a = _check(one, q, f"one, step {i}")
        b = _check(two, q, f"two, step {i}")
        for x, y in zip(a, b, strict=True):
            np.testing.assert_array_equal(x, y, err_msg=f"step {i}")
    stats = two.maintenance_stats()
    assert stats["sharded"] and stats["restack_rows"] > 0
    for req in {r for r, _ in two.cache.table}:
        two.release(req)
    found, page = two.lookup(q)
    assert not found.any() and (page == 0).all()


def test_build_needs_a_primed_cache():
    c = K.PagedKVCache(n_pages=8, page_size=16, n_kv_heads=1, head_dim=8,
                       n_layers=1, device="cpu")
    with pytest.raises(ValueError):
        K.DynamicPageTable.build(c, device="cpu")


@pytest.mark.parametrize("verb", ("insert", "delete"))
def test_per_key_verbs_equal_the_batch_verbs(ref, verb):
    """``insert(key)`` / ``delete(key)`` one key at a time leave the same
    index as one-key batches, and as the reference's per-key verbs: live
    keys, counters and answers."""
    rng = np.random.default_rng(5)
    base = np.unique(rng.lognormal(0, 1, 3000).astype(np.float32)) \
        .astype(np.float64)
    keys = rng.choice(base, 40, replace=False) if verb == "delete" else \
        np.unique(rng.uniform(base[0], base[-1], 40).astype(np.float32))\
        .astype(np.float64)
    a = DynamicRMI.build(base, n_leaves=32, device="cpu")
    b = DynamicRMI.build(base, n_leaves=32, device="cpu")
    j = ref.dyn.build(ref.jnp.asarray(base), n_leaves=32)
    for k in keys:
        getattr(a, verb)(float(k))
        getattr(b, verb + "_batch")(np.asarray([k]))
        getattr(j, verb)(float(k))
    q = np.concatenate([keys, base[::7]])
    want = [np.asarray(x) for x in j.find(ref.jnp.asarray(q))]
    for d in (a, b):
        np.testing.assert_array_equal(d.live_keys(), np.asarray(
            j.live_keys()))
        for got, w in zip(d.find(q), want, strict=True):
            np.testing.assert_array_equal(got.numpy(), w)
        assert (d.live_count, d.rebuilds, d.deleted, d.delta_live,
                d.delta_dead_count, d.delta_compactions) == (
            j.live_count, j.rebuilds, j.deleted, j.delta_live,
            j.delta_dead_count, j.delta_compactions)
