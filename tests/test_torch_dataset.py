"""``IndexedDataset`` in the port (``data.indexed_dataset``) held against
the reference's with the same linear pool carried across
(``convert.pool_from_arrays``): the pipeline of ``tests/test_system.py``
plus ``append_to_shard``, ``delete_samples`` and ``locate_range``.  Shard
ids, offsets, the pieces of every range, boundaries, live keys and reuse
fractions are compared bit for bit.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import repro  # noqa: F401  (enables x64 for the reference)
from repro.core import reuse as jreuse
from repro.core import synth as jsynth
from repro.data.indexed_dataset import IndexedDataset as JDataset
from torch_export import export_pool

from repro_torch.convert import pool_from_arrays
from repro_torch.data.indexed_dataset import IndexedDataset as TDataset


@pytest.fixture(scope="module")
def pools():
    j = jreuse.build_pool(jsynth.generate_pool(0.9, limit=200), kind="linear")
    return j, pool_from_arrays(export_pool(j), device="cpu")


def _both(pools, n_shards=3, n=30_000, seed=0):
    rng = np.random.default_rng(seed)
    jds = JDataset.create(pool=pools[0], eps=0.9, n_leaves=64)
    tds = TDataset.create(pool=pools[1], eps=0.9, n_leaves=64)
    for s in range(n_shards):
        keys = np.sort(rng.lognormal(0, 0.5, n)) * 1e6 + s * 1e11
        jds.add_shard(keys)
        tds.add_shard(keys)
    _same(jds, tds)
    return jds, tds, rng


def _same(jds, tds):
    assert len(jds.shards) == len(tds.shards)
    np.testing.assert_array_equal(np.asarray(tds.boundaries),
                                  np.asarray(jds.boundaries))
    for js, ts in zip(jds.shards, tds.shards, strict=True):
        assert ts.shard_id == js.shard_id
        np.testing.assert_array_equal(ts.keys, js.keys)
        np.testing.assert_array_equal(ts.dyn.live_keys(), js.dyn.live_keys())
        assert ts.reuse_fraction == js.reuse_fraction
        np.testing.assert_array_equal(ts.index.reused_mask.numpy(),
                                      np.asarray(js.index.reused_mask))
    assert tds.mean_reuse == jds.mean_reuse


def _same_locate(jds, tds, q):
    js, jo = jds.locate(q)
    ts, to = tds.locate(q)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(to, jo)
    assert to.dtype == np.int64
    return ts, to


def _same_ranges(jds, tds, lo, hi):
    jr = jds.locate_range(lo, hi)
    tr = tds.locate_range(lo, hi)
    assert len(tr) == len(jr) == lo.size
    for a, b in zip(tr, jr, strict=True):
        assert [s for s, _ in a] == [s for s, _ in b]
        for (_, x), (_, y) in zip(a, b, strict=True):
            np.testing.assert_array_equal(x, y)
    return tr


def _range_pairs(rng, tds, m=400):
    """Ranges inside one shard, across shard seams, degenerate (lo > hi)
    and wholly out of range."""
    allk = np.concatenate([s.keys for s in tds.shards])
    lo = rng.choice(allk, m)
    hi = lo + rng.exponential(2e5, m)
    hi[:20] = lo[:20] - 1.0
    span = np.asarray([s.keys[[0, -1]] for s in tds.shards])
    lo[20:40], hi[20:40] = span[0, 1] - 5e5, span[-1, 0] + 5e5
    lo[40:50], hi[40:50] = -1e12, -1e11
    lo[50:60], hi[50:60] = 1e13, 2e13
    return lo, hi


def test_indexed_dataset_pipeline(pools):
    """``tests/test_system.py``'s pipeline: three shards, keys of shard 1
    resolve to shard 1 at their own offsets."""
    jds, tds, rng = _both(pools)
    q = rng.choice(tds.shards[1].keys, 300)
    sid, off = _same_locate(jds, tds, q)
    assert (sid == 1).all()
    np.testing.assert_array_equal(tds.shards[1].keys[off], q)
    allk = np.concatenate([s.keys for s in tds.shards])
    q = np.concatenate([rng.choice(allk, 500), rng.uniform(0, 3e11, 300),
                        [-1.0, 1e13, allk[0], allk[-1]]])
    sid, off = _same_locate(jds, tds, q)
    for s, shard in enumerate(tds.shards):
        m = sid == s
        np.testing.assert_array_equal(off[m],
                                      np.searchsorted(shard.keys, q[m]))


def test_append_delete_and_ranges(pools):
    jds, tds, rng = _both(pools, seed=1)
    lo, hi = _range_pairs(rng, tds)
    _same_ranges(jds, tds, lo, hi)
    # appends inside shard 0's range (some past its old boundary, below
    # shard 1's first key) and into the last shard past every key
    s0 = tds.shards[0].keys
    app0 = np.concatenate([rng.uniform(s0[0], s0[-1], 3000),
                           s0[-1] + rng.uniform(1.0, 1e6, 50)])
    app2 = tds.shards[2].keys[-1] + rng.uniform(1.0, 1e9, 500)
    for ds in (jds, tds):
        ds.append_to_shard(0, app0)
        ds.append_to_shard(2, app2)
        ds.delete_samples(1, tds.shards[1].keys[::3])
        ds.delete_samples(2, app2[:100])
    _same(jds, tds)
    assert tds.shards[0].dyn.rebuilds == jds.shards[0].dyn.rebuilds
    assert tds.boundaries[0] > s0[-1]
    allk = np.concatenate([s.keys for s in tds.shards])
    q = np.concatenate([rng.choice(allk, 800), app2[:100],
                        rng.uniform(0, 3e11, 200)])
    sid, off = _same_locate(jds, tds, q)
    for s, shard in enumerate(tds.shards):
        m = sid == s
        np.testing.assert_array_equal(off[m],
                                      np.searchsorted(shard.keys, q[m]))
    lo, hi = _range_pairs(rng, tds)
    pieces = _same_ranges(jds, tds, lo, hi)
    for r, got in enumerate(pieces):
        want = allk[np.searchsorted(allk, lo[r]):
                    np.searchsorted(allk, hi[r], side="right")]
        np.testing.assert_array_equal(
            np.concatenate([k for _, k in got]) if got else allk[:0], want)
    # a fully drained shard keeps its boundary and answers from no keys
    for ds in (jds, tds):
        ds.delete_samples(1, ds.shards[1].keys)
    _same(jds, tds)
    _same_locate(jds, tds, q)
    _same_ranges(jds, tds, lo, hi)


def test_misuse_raises(pools):
    jds, tds, _ = _both(pools, n_shards=2, n=2000)
    reach = np.asarray([tds.boundaries[1]])
    for ds in (jds, tds):
        with pytest.raises(ValueError, match="reach into shard 1"):
            ds.append_to_shard(0, reach)
        with pytest.raises(ValueError, match="pair up"):
            ds.locate_range(np.zeros(3), np.zeros(2))
        with pytest.raises(ValueError, match="finite"):
            ds.locate_range(np.asarray([0.0]), np.asarray([np.inf]))


def test_create_builds_its_pool_on_the_requested_device():
    ds = TDataset.create(eps=0.9, device="cpu", n_leaves=16)
    assert ds.pool.kind == "linear" and ds.pool.size == 1221
    assert ds.device.type == "cpu" and ds.mean_reuse == 0.0
    keys = np.sort(np.random.default_rng(3).lognormal(0, 0.5, 5000))
    info = ds.add_shard(torch.from_numpy(keys[::-1].copy()))
    np.testing.assert_array_equal(info.keys, keys)
    assert info.dyn.device.type == "cpu" and ds.mean_reuse > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TDataset.create(eps=0.9)
