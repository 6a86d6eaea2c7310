"""The sharded index across mesh positions (``repro_torch.core
.distributed``: ``ShardMesh(devices=...)`` and the routed exchange).

On the CPU every position is ``"cpu"``: each still keeps its own stack of
its shards' rows, and each verb makes one answer call a position that
holds queries, as separate cards would.  Checked here:

* the mesh's rules: D positions must divide the shard count; a mesh that
  mixes device types, or names a card that is not there, raises; a
  ``device=`` that contradicts the home device raises at every entry
  point; there is no fallback;
* placement: every tensor of shard s (its ``DynamicRMI``, its rows of the
  stack and of a tenant pack, its static stack) lies on
  ``devices[s // (S / D)]``;
* one answer call a position a verb -- the wrappers of the stacked K1, K2
  and K3 called once a position, on that position's rows -- and the
  exchange's accounting (calls, answers, bytes out and back);
* answers equal to the one-stack index's after churn and a migration
  between shards on two positions; the page table, the facade's build,
  snapshot and restore on positions.

The bit-for-bit parity of every layout with the reference is in
``test_torch_sharded.py``, ``test_torch_sharded_persist.py`` and
``test_torch_frontend.py``.  On two cards (``gpu`` marker) an index over
``cuda:0`` and ``cuda:1`` answers as on the CPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.api import Index
from repro_torch.core import distributed as D
from repro_torch.core import persist as tpersist
from repro_torch.kernels import lookup as tlk
from repro_torch.serve import frontend as F
from repro_torch.serve import kvcache as K
from torch_mesh import cpu_mesh

STACKED = ("sharded_lookup", "sharded_dynamic_lookup",
           "sharded_dynamic_range")


def _keys(seed=0, n=6000):
    rng = np.random.default_rng(seed)
    return np.unique(rng.lognormal(0, 1, n).astype(np.float32)) \
        .astype(np.float64)


def _truth(live, q):
    fin = q < np.inf
    return (fin & (np.searchsorted(live, q, "right")
                   > np.searchsorted(live, q)),
            np.where(fin, np.searchsorted(live, q), 0))


def _tensors(x, seen=None):
    """Every tensor reachable from ``x`` (dataclasses, tuples, dicts and
    lists walked)."""
    seen = set() if seen is None else seen
    if isinstance(x, torch.Tensor):
        yield x
    elif id(x) in seen:
        return
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        seen.add(id(x))
        for f in dataclasses.fields(x):
            yield from _tensors(getattr(x, f.name), seen)
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v, seen)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v, seen)


@pytest.fixture
def stacked_calls(monkeypatch):
    """The stacked K1-K3 wrappers, each call recorded as (its queries'
    device, its stack's rows)."""
    calls = {k: [] for k in STACKED}

    def wrap(name, fn):
        def wrapped(*a, **kw):
            keys = a[6] if name == "sharded_dynamic_range" else a[5]
            calls[name].append((a[0].device, keys.shape[0]))
            return fn(*a, **kw)
        return wrapped
    for k in STACKED:
        monkeypatch.setattr(tlk, k, wrap(k, getattr(tlk, k)))
    return calls


# ------------------------------------------------------------ the rules --
def test_mesh_rules():
    """D must divide S; no positions, mixed device types or a card that is
    not there raise; a mesh's positions are its devices, a mesh without
    devices has the one ``device=``."""
    assert D.ShardMesh(4).positions("cpu") == (torch.device("cpu"),)
    m = D.ShardMesh(4, devices=("cpu", "cpu"))
    assert m.positions() == (torch.device("cpu"),) * 2
    assert m.positions("cpu") == m.devices
    assert m.shape == {"data": 4}
    with pytest.raises(ValueError, match="do not divide"):
        D.ShardMesh(4, devices=("cpu",) * 3)
    with pytest.raises(ValueError, match="do not divide"):
        D.ShardMesh(4, devices=())
    with pytest.raises(ValueError, match="mixes device types"):
        D.ShardMesh(2, devices=("cpu", "meta"))
    missing = "cuda" if not torch.cuda.is_available() \
        else f"cuda:{torch.cuda.device_count()}"
    with pytest.raises(RuntimeError):
        D.ShardMesh(2, devices=("cpu", missing))
    with pytest.raises(RuntimeError):
        D.ShardMesh(2, devices=(missing, missing))


def test_device_that_contradicts_the_mesh_raises(tmp_path):
    """``device=`` other than the home device raises at every entry point
    that takes a mesh."""
    keys = _keys(1, 500)
    mesh = cpu_mesh(2, 2)
    with pytest.raises(ValueError, match="home device"):
        D.build_sharded(keys, mesh, n_leaves=8, device="meta")
    with pytest.raises(ValueError, match="home device"):
        D.ShardedDynamicIndex.build(keys, mesh, n_leaves=8, device="meta")
    with pytest.raises(ValueError, match="home device"):
        Index.build(keys, mesh=mesh, n_leaves=8, device="meta")
    Index.build(keys, mesh=mesh, n_leaves=8, device="cpu").snapshot(
        tmp_path, 1)
    with pytest.raises(ValueError, match="home device"):
        tpersist.restore_sharded(tpersist.SnapshotStore(str(tmp_path)),
                                 mesh, device="meta")
    with pytest.raises(ValueError, match="one mesh"):
        F.TenantPack([
            D.ShardedDynamicIndex.build(keys, m, n_leaves=8, device="cpu")
            for m in (cpu_mesh(2, 2), cpu_mesh(2, None))])


# ------------------------------------------------ placement and calls --
@pytest.mark.parametrize("S,P", ((4, 4), (4, 2), (6, 3)))
def test_placement_and_one_call_a_position(stacked_calls, S, P):
    """Every tensor of shard s lies on its position's device; a position's
    stack holds its S / P shards; ``find``, ``find_range`` and
    ``make_lookup_fn`` make one stacked call a position, on that
    position's rows, and answer as the one-stack index does."""
    keys = _keys(2)
    mesh = cpu_mesh(S, P)
    k = S // P
    idx = D.ShardedDynamicIndex.build(keys, mesh, n_leaves=16,
                                      device="cpu")
    one = D.ShardedDynamicIndex.build(keys, D.ShardMesh(S), n_leaves=16,
                                      device="cpu")
    for s, d in enumerate(idx.shards):
        want = idx.positions[s // k]
        assert {t.device for t in _tensors(d)} == {want}
    rng = np.random.default_rng(3)
    q = np.concatenate([rng.choice(keys, 400), [np.inf, np.nan, -np.inf]])
    for path in ("kernel", "jnp"):
        D.reset_exchange()
        for k_ in stacked_calls:
            stacked_calls[k_].clear()
        got = idx.find(q, path=path) + idx.find_range(q[:200],
                                                      q[:200] * 1.01,
                                                      path=path)
        assert D.EXCHANGE["calls"] == 2 and D.EXCHANGE["answers"] == 2 * P
        assert D.EXCHANGE["bytes"] > 0
        want = one.find(q, path=path) + one.find_range(q[:200],
                                                       q[:200] * 1.01,
                                                       path=path)
        for a, b in zip(got, want, strict=True):
            assert torch.equal(a, b), path
        if path == "kernel":
            # the one-stack index's calls come after this one's
            assert stacked_calls["sharded_dynamic_lookup"][:P] == \
                [(d, k) for d in idx.positions]
            assert stacked_calls["sharded_dynamic_range"][:P] == \
                [(d, k) for d in idx.positions]
    st = idx._stack
    for i, part in enumerate(st["parts"]):
        assert (part["lo"], part["n"], part["device"]) == \
            (i * k, k, idx.positions[i])
        assert {t.device for t in _tensors(part)} == {part["device"]}
        assert part["base"].shape[0] == k
    si = D.build_sharded(keys, mesh, n_leaves=16, device="cpu")
    assert [p.keys.shape[0] for p in si.parts] == [k] * P
    ranks = D.make_lookup_fn(si, path="kernel")(q)
    assert stacked_calls["sharded_lookup"] == [(d, k) for d in si.positions]
    one_si = D.build_sharded(keys, D.ShardMesh(S), n_leaves=16,
                             device="cpu")
    assert torch.equal(ranks, D.make_lookup_fn(one_si, path="kernel")(q))


def test_tenant_pack_rows_on_positions():
    """A pack of two tenants on two positions of four shards: each
    position holds the T x S / D rows of its shards (``tenant_row``), on
    its device, and answers as the one-stack pack."""
    keys = [_keys(4, 3000), np.unique((_keys(5, 900) * 64 + 1e4).astype(
        np.float32)).astype(np.float64)]
    packs = []
    for positions in (2, None):
        mesh = cpu_mesh(4, positions)
        packs.append(F.TenantPack([
            D.ShardedDynamicIndex.build(k, mesh, n_leaves=16, device="cpu")
            for k in keys], path="kernel"))
    rng = np.random.default_rng(6)
    qmat = np.stack([rng.choice(k, 256) for k in keys])
    got, want = packs[0].find(qmat), packs[1].find(qmat)
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)
    parts = packs[0]._st["parts"]
    assert [(p["lo"], p["n"]) for p in parts] == [(0, 4), (4, 4)]
    assert [D.tenant_row(t, s, 2, 2) for t in range(2) for s in range(4)] \
        == [0, 1, 4, 5, 2, 3, 6, 7]
    for part in parts:
        assert {t.device for t in _tensors(part)} == {part["device"]}


# ------------------------------------------ moving a shard, the pool --
def test_shard_moves_and_pool_replicas():
    """``DynamicRMI.to`` (a reshard moving a shard to another position)
    copies every tensor, the pool swapped for its replica there, and
    shares the host counters; a pool's replica is made once a device,
    counts its reuses into its primary and takes no ``enqueue``.  The
    ``meta`` device stands in for another card."""
    from repro_torch.core import reuse as treuse
    from repro_torch.core import synth as tsynth
    from repro_torch.core.updates import DynamicRMI
    pool = treuse.build_pool(tsynth.generate_pool(0.65, ns=128, seed=1),
                             kind="linear", device="cpu")
    d = DynamicRMI.build(_keys(12, 800), pool=pool, n_leaves=8,
                         device="cpu")
    assert d.to("cpu") is d
    m = d.to("meta")
    rep = m.pool
    meta = {torch.device("meta")}
    assert {t.device for t in _tensors(dataclasses.replace(m, pool=None))} \
        == meta
    assert {t.device for t in _tensors(dataclasses.replace(
        rep, primary=None))} == meta
    assert m.n_inserts is d.n_inserts and m.base_n == d.base_n
    assert rep is pool.replica("meta") and rep.primary is pool
    assert rep.replica("cpu") is pool and pool.replica("cpu") is pool
    n0 = pool.reuse_count
    rep.owner.reuse_count += 3
    assert pool.reuse_count == n0 + 3 and rep.reuse_count == 0
    with pytest.raises(ValueError, match="replica"):
        rep.enqueue(pool.hists[0], treuse.models.take_rows(pool.params, 0),
                    pool.err_lo[0], pool.err_hi[0],
                    treuse.DomainSpec(*(t[0] for t in pool.domains)))


# --------------------------------------------- maintenance across them --
def test_migration_between_positions():
    """A skewed ingest into shard 0 of four shards, one a position,
    migrates a boundary run to shard 1 on the next position; every answer
    after it equals the truth and the one-stack index's, and each shard
    stays on its position."""
    keys = _keys(7, 4000)
    idx, one = (D.ShardedDynamicIndex.build(keys, m, n_leaves=16,
                                            device="cpu")
                for m in (cpu_mesh(4, 4), D.ShardMesh(4)))
    rng = np.random.default_rng(8)
    skew = np.unique(rng.uniform(keys[0], idx.splits[0], 6000)
                     .astype(np.float32)).astype(np.float64)
    for x in (idx, one):
        x.insert_batch(skew)
    assert idx.migrations_incremental + idx.migrations_full >= 1
    assert idx.splits.tolist() == one.splits.tolist()
    live = idx.live_keys()
    q = np.concatenate([rng.choice(live, 500), [idx.splits[0]]])
    f, r = idx.find(q, path="kernel")
    tf, tr = _truth(live, q)
    np.testing.assert_array_equal(f.numpy(), tf)
    np.testing.assert_array_equal(r.numpy(), tr)
    for a, b in zip((f, r), one.find(q, path="kernel"), strict=True):
        assert torch.equal(a, b)
    assert [d.device for d in idx.shards] == list(idx.positions)


def test_page_table_and_facade_on_positions(tmp_path):
    """The page table on two positions answers as on one stack after every
    step; the facade builds, snapshots and restores onto positions (and
    onto another shard count over other positions)."""
    def cache():
        c = K.PagedKVCache(n_pages=512, page_size=16, n_kv_heads=1,
                           head_dim=8, n_layers=1, device="cpu")
        for req, n in ((0, 70), (1, 45), (2, 90)):
            c.allocate_batch(req, range(n))
        return c
    q = np.concatenate([K._pack_keys(r, range(n + 5))
                        for r, n in ((0, 70), (1, 45), (2, 90), (3, 20))])
    tables = [K.DynamicPageTable.build(cache(), mesh=m, device="cpu")
              for m in (cpu_mesh(2, 2), D.ShardMesh(2))]
    for step in range(3):
        if step == 1:
            for t in tables:
                t.allocate(3, range(20))
        if step == 2:
            for t in tables:
                t.release(1)
        (fa, pa), (fb, pb) = (t.lookup(q) for t in tables)
        np.testing.assert_array_equal(fa, fb)
        np.testing.assert_array_equal(pa, pb)
    keys = _keys(9, 2000)
    ix = Index.build(keys, mesh=cpu_mesh(4, 2), n_leaves=8, device="cpu")
    ix.snapshot(tmp_path, 1)
    for n, p in ((4, 4), (2, 2), (4, 1)):
        back = Index.restore(tmp_path, mesh=cpu_mesh(n, p), device="cpu")
        assert back.backend.positions == (torch.device("cpu"),) * p
        for a, b in zip(back.find(keys[::5]), ix.find(keys[::5]),
                        strict=True):
            assert torch.equal(a, b)


# ------------------------------------------------------------ two cards --
@pytest.mark.gpu
def test_two_cards():
    """Four shards on ``cuda:0`` and ``cuda:1``: each shard's tensors on
    its card, one stacked launch a card a verb, answers equal to the
    CPU's; a migration between the cards; a reshard onto one card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    keys = _keys(10, 20000)
    mesh = D.ShardMesh(4, devices=("cuda:0", "cuda:1"))
    idx = D.ShardedDynamicIndex.build(keys, mesh, n_leaves=32)
    cpu = D.ShardedDynamicIndex.build(keys, D.ShardMesh(4), n_leaves=32,
                                      device="cpu")
    for s, d in enumerate(idx.shards):
        assert {t.device for t in _tensors(d)} == \
            {torch.device("cuda", s // 2)}
    rng = np.random.default_rng(11)
    skew = np.unique(rng.uniform(keys[0], idx.splits[0], 30000)
                     .astype(np.float32)).astype(np.float64)
    for x in (idx, cpu):
        x.insert_batch(skew)
    q = np.concatenate([rng.choice(idx.live_keys(), 4000), [np.nan]])
    k0 = tlk.LAUNCHES["sharded_dynamic_lookup"]
    got = idx.find(q)
    assert tlk.LAUNCHES["sharded_dynamic_lookup"] - k0 == 2
    want = cpu.find(q, path="kernel")
    for a, b in zip(got, want, strict=True):
        assert a.device == torch.device("cuda", 0)
        assert torch.equal(a.cpu(), b)
    moved, _ = tpersist.reshard_sharded(idx, D.ShardMesh(
        4, devices=("cuda:0",)))
    for a, b in zip(moved.find(q), want, strict=True):
        assert torch.equal(a.cpu(), b)
