"""Sharded snapshots, restore and reshard of the port
(``repro_torch.core.persist``: ``snapshot_sharded``, ``restore_sharded``,
``reshard_sharded``) against the reference's, on the CPU.

One reference subprocess (four host devices; a 2-shard mesh is a sub-mesh
of them) restores the snapshot the port wrote, writes its own snapshots of
a 4-shard and a 2-shard index, restores them onto 4 and 2 shards (the
reshards 4 -> 2 and 2 -> 4), restores a copy with a damaged shard file in
each ``on_corrupt`` mode, and records every answer (``find`` on
``path="jnp"``, ranges through ``_sharded_dynamic_range_fn`` as in
``test_torch_sharded.py``), live key array, split vector, counter and
``ReshardStats``.  The port then restores the reference's snapshots and
must give the same, bit for bit; the manifests of both packages'
snapshots of the same state are equal (files, array names, shapes, dtypes,
kind, meta keys).  Faults come in through the port's ``_write_bytes``
seam and ``tests/faultinject.py``'s at-rest damage.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import faultinject as fi
from repro_torch.api import Index
from repro_torch.core import distributed as D
from repro_torch.core import persist as tpersist

DEV = "cpu"

_SCRIPT = r"""
import os, pickle, shutil, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from repro.core import distributed as D
from repro.core import persist as P
sys.path.insert(0, %(tests)r)
import faultinject as fi

tmp = %(tmp)r
meshes = {n: jax.make_mesh((n,), ("data",)) for n in (2, 4)}
data = pickle.load(open(os.path.join(tmp, "inputs.pkl"), "rb"))
out = {}

def answers(idx, q, lo, hi):
    f, r = idx.find(jnp.asarray(q), path="jnp")
    st = idx._stacked()
    fn = D._sharded_dynamic_range_fn(
        idx.mesh, idx.axis, n_leaves=idx.n_leaves, leaf_kind=st["leaf_kind"],
        iters=st["iters"], use_kernel=False, interpret=None)
    rl, rr = fn(st["splits"], st["offs"], st["route_n"], st["base"],
                st["bdead"], st["bpsum"], st["dk"], st["ddead"], st["dpsum"],
                (st["root"], st["leaves"], st["err_lo"], st["err_hi"]),
                jnp.concatenate([jnp.asarray(lo), jnp.asarray(hi)]))
    rl, rr = np.asarray(rl), np.asarray(rr)
    Q = lo.size
    return dict(found=np.asarray(f), rank=np.asarray(r), rank_lo=rl[:Q],
                rank_hi=np.maximum(rr[Q:], rl[:Q]), live=idx.live_keys(),
                splits=np.asarray(idx.splits, np.float64).copy(),
                quarantined=list(idx.quarantined),
                counters={k: int(getattr(idx, k)) for k in (
                    "rebalances", "migrations_incremental",
                    "migrations_full", "restack_full", "restack_rows",
                    "capacity_shrinks", "swaps_committed")})

def restored(path, n, **kw):
    idx, rep = P.restore_sharded(P.SnapshotStore(path), meshes[n], **kw)
    a = answers(idx, *data["probe"])
    a["report"] = (rep.step, rep.n_shards_from, rep.n_shards,
                   [s for s, _ in rep.quarantined],
                   None if rep.reshard is None else rep.reshard.__dict__)
    return a

# the port's snapshot, restored onto 4 and onto 2 shards
out["port_on_4"] = restored(os.path.join(tmp, "port"), 4)
out["port_on_2"] = restored(os.path.join(tmp, "port"), 2)

# the reference's own: a 4-shard and a 2-shard index after the same churn
for n in (4, 2):
    keys, batches = data["build"][n]
    idx = D.ShardedDynamicIndex.build(jnp.asarray(keys), meshes[n],
                                      n_leaves=32, eps=0.3)
    store = P.SnapshotStore(os.path.join(tmp, "ref%%d" %% n))
    for step, (ins, dels) in enumerate(batches, start=1):
        idx.insert_batch(ins)
        idx.delete_batch(dels)
        P.snapshot_sharded(store, step, idx, blocking=(step == 1))
        store.wait()
        out["live_%%d_%%d" %% (n, step)] = answers(idx, *data["probe"])
    for m in (2, 4):
        out["ref%%d_on_%%d" %% (n, m)] = restored(store.directory, m)

# a damaged shard file in the newest step of a copy
src = os.path.join(tmp, "ref4")
bad = os.path.join(tmp, "ref4_bad")
shutil.copytree(src, bad)
fi.flip_byte(P.SnapshotStore(bad), 2, "shard_00001.npz")
out["bad_quarantine"] = restored(bad, 4, on_corrupt="quarantine")
out["bad_fallback"] = restored(bad, 4, on_corrupt="fallback")
try:
    P.restore_sharded(P.SnapshotStore(bad), meshes[4], on_corrupt="raise")
    out["bad_raise"] = "restored"
except P.SnapshotCorruption as e:
    out["bad_raise"] = "raised"
pickle.dump(out, open(os.path.join(tmp, "ref.pkl"), "wb"))
print("SHARDED_PERSIST_REF_OK")
"""


def _f32(a):
    return np.unique(np.asarray(a, np.float32)).astype(np.float64)


def _inputs(rng):
    """Keys and churn of the 4- and 2-shard indexes, and the probes."""
    out = {}
    for n in (4, 2):
        keys = _f32(rng.lognormal(0, 0.7, 3000) * 100)
        batches = [(_f32(rng.lognormal(0, 0.7, 700) * 100),
                    rng.choice(keys, 200, replace=False)) for _ in range(2)]
        out[n] = (keys, batches)
    k = out[4][0]
    q = np.concatenate([rng.choice(k, 400), _f32(rng.uniform(k[0], k[-1],
                                                            104)),
                        [np.inf, np.nan, -np.inf, 0.0, 1e30, -1e30, k[0],
                         k[-1]]])
    lo = np.concatenate([rng.choice(k, 120), [k[0], k[-1], 0.0, 1e30,
                                              -np.inf, np.nan, 5.0, 7.0]])
    hi = (lo * 1.02).astype(np.float32).astype(np.float64)
    hi[-2:] = lo[-2:] - 1.0
    return dict(build=out, probe=(q, lo, hi))


def _answers(idx, q, lo, hi):
    f, r = idx.find(q, path="jnp")
    rl, rh = idx.find_range(lo, hi, path="jnp")
    fk, rk = idx.find(q, path="kernel")
    rlk, rhk = idx.find_range(lo, hi, path="kernel")
    for a, b in ((f, fk), (r, rk), (rl, rlk), (rh, rhk)):
        assert torch.equal(a, b)
    return dict(found=f.numpy(), rank=r.numpy(), rank_lo=rl.numpy(),
                rank_hi=rh.numpy(), live=idx.live_keys(),
                splits=np.asarray(idx.splits, np.float64).copy(),
                quarantined=list(idx.quarantined),
                counters={k: int(getattr(idx, k))
                          for k in tpersist._IDX_COUNTERS})


def _same(got, want, what, keys=("found", "rank", "rank_lo", "rank_hi",
                                 "live", "splits", "quarantined")):
    for k in keys:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]),
                                      err_msg=f"{what}: {k}")


def _manifest(path, step):
    with open(os.path.join(path, f"step_{step:08d}", "manifest.json")) as f:
        m = json.load(f)
    return m, {f: e["arrays"] for f, e in m["files"].items()}


def _build(keys, batches, n, store=None, probe=None):
    """The port's index after the churn, snapshotting after each batch
    pair into ``store`` and answering ``probe`` as the reference does."""
    idx = D.ShardedDynamicIndex.build(keys, D.ShardMesh(n), n_leaves=32,
                                      eps=0.3, device=DEV)
    for step, (ins, dels) in enumerate(batches, start=1):
        idx.insert_batch(ins)
        idx.delete_batch(dels)
        if store is not None:
            tpersist.snapshot_sharded(store, step, idx,
                                      blocking=(step == 1))
            store.wait()
        if probe is not None:
            _answers(idx, *probe)
    return idx


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """(inputs, the port's answers, the reference's records, directory)."""
    tmp = tmp_path_factory.mktemp("sharded_persist")
    rng = np.random.default_rng(41)
    data = _inputs(rng)
    with open(tmp / "inputs.pkl", "wb") as fh:
        pickle.dump(data, fh)
    # the port's snapshot of its own 4-shard index (other keys, so that
    # each package restores a state it did not write itself)
    pkeys = _f32(rng.lognormal(0.3, 0.8, 2500) * 100)
    pix = D.ShardedDynamicIndex.build(pkeys, D.ShardMesh(4), n_leaves=32,
                                      eps=0.3, device=DEV)
    pix.insert_batch(_f32(rng.lognormal(0.3, 0.8, 900) * 100))
    pix.delete_batch(rng.choice(pkeys, 300, replace=False))
    tpersist.snapshot_sharded(tpersist.SnapshotStore(str(tmp / "port")), 1,
                              pix, blocking=True)
    port = _answers(pix, *data["probe"])
    env = dict(os.environ, PYTHONPATH="src")
    env.pop("XLA_FLAGS", None)
    tests = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT % {"tmp": str(tmp), "tests": tests}],
        env=env, capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(tests))
    assert proc.returncode == 0 and "SHARDED_PERSIST_REF_OK" in proc.stdout, \
        proc.stderr[-4000:]
    with open(tmp / "ref.pkl", "rb") as fh:
        ref = pickle.load(fh)
    return data, port, ref, tmp


def test_port_snapshot_restores_in_the_reference(case):
    """The port's 4-shard snapshot restores in the reference onto 4 shards
    verbatim (answers, live keys, splits, counters) and onto 2 shards
    (answers and live keys; the reshard runs there)."""
    _, port, ref, _ = case
    _same(ref["port_on_4"], port, "port on 4")
    assert ref["port_on_4"]["counters"] == port["counters"]
    assert ref["port_on_4"]["report"][:4] == (1, 4, 4, [])
    _same(ref["port_on_2"], port, "port on 2", keys=("found", "rank",
                                                     "rank_lo", "rank_hi",
                                                     "live"))
    st = ref["port_on_2"]["report"][4]
    assert st["n_from"] == 4 and st["n_to"] == 2 and st["full_rebuilds"] == 0


@pytest.mark.parametrize("n", (4, 2))
def test_reference_snapshot_restores_in_the_port(case, n):
    """The reference's snapshots restore in the port: the newest step
    verbatim, an explicit older step too; the manifests of both packages'
    snapshots of the same churn are equal."""
    data, _, ref, tmp = case
    q = data["probe"]
    store = tpersist.SnapshotStore(str(tmp / f"ref{n}"))
    for step in (2, 1):
        idx, rep = tpersist.restore_sharded(store, D.ShardMesh(n),
                                            step=step, device=DEV)
        assert (rep.step, rep.n_shards_from, rep.n_shards) == (step, n, n)
        got = _answers(idx, *q)
        want = ref[f"live_{n}_{step}"]
        _same(got, want, f"ref{n} step {step}")
        assert got["counters"] == want["counters"]
    # the same churn through the port, snapshotted: the same manifests
    keys, batches = data["build"][n]
    mine = tpersist.SnapshotStore(str(tmp / f"mine{n}"))
    live = _build(keys, batches, n, mine, q)
    _same(_answers(live, *q), ref[f"live_{n}_2"], f"port {n} live")
    for step in (1, 2):
        jm, jf = _manifest(store.directory, step)
        tm, tf = _manifest(mine.directory, step)
        assert jf == tf, step
        assert (jm["schema"], jm["kind"], jm["step"]) == \
            (tm["schema"], tm["kind"], tm["step"])
        assert sorted(jm["meta"]) == sorted(tm["meta"])
        assert [sorted(s) for s in jm["meta"]["shards"]] == \
            [sorted(s) for s in tm["meta"]["shards"]]
        assert jm["meta"]["counters"] == tm["meta"]["counters"]


@pytest.mark.parametrize("n,m", ((4, 2), (2, 4)))
def test_reshard_equals_reference(case, n, m):
    """Restoring an n-shard snapshot onto m shards: ``ReshardStats`` field
    by field, splits, answers and live keys equal the reference's, with
    ``full_rebuilds`` 0; ``reshard_sharded`` of the live same-width
    restore takes the same cuts."""
    data, _, ref, tmp = case
    store = tpersist.SnapshotStore(str(tmp / f"ref{n}"))
    idx, rep = tpersist.restore_sharded(store, D.ShardMesh(m), device=DEV)
    want = ref[f"ref{n}_on_{m}"]
    assert dataclasses.asdict(rep.reshard) == want["report"][4]
    assert rep.reshard.full_rebuilds == 0 and rep.reshard.n_to == m
    assert (rep.step, rep.n_shards_from, rep.n_shards) == (2, n, m)
    got = _answers(idx, *data["probe"])
    _same(got, want, f"{n} on {m}")
    assert got["counters"] == want["counters"]
    same, _ = tpersist.restore_sharded(store, D.ShardMesh(n), device=DEV)
    again, stats = tpersist.reshard_sharded(same, D.ShardMesh(m))
    assert dataclasses.asdict(stats) == want["report"][4]
    _same(_answers(again, *data["probe"]), want, f"reshard {n} -> {m}",
          keys=("found", "rank", "rank_lo", "rank_hi", "live", "splits"))


def test_on_corrupt_modes(case):
    """A flipped byte in a shard file of the newest step: ``"quarantine"``
    serves it with that shard empty (its range answers found False, the
    rest as before) as the reference does; ``"fallback"`` serves the older
    step; ``"raise"`` raises.  A torn manifest falls back in every mode but
    ``"raise"``; a dropped shard file quarantines like a damaged one."""
    data, _, ref, tmp = case
    bad = tmp / "port_bad"
    shutil.copytree(tmp / "ref4", bad)
    store = tpersist.SnapshotStore(str(bad))
    fi.flip_byte(store, 2, "shard_00001.npz")
    idx, rep = tpersist.restore_sharded(store, D.ShardMesh(4),
                                        on_corrupt="quarantine", device=DEV)
    assert [s for s, _ in rep.quarantined] == [1] == idx.quarantined
    got = _answers(idx, *data["probe"])
    _same(got, ref["bad_quarantine"], "quarantine")
    q = data["probe"][0]
    mine = (q > idx.splits[0]) & (q <= idx.splits[1])
    assert not got["found"][mine].any()
    assert (got["found"][~mine] == ref["live_4_2"]["found"][~mine]).all()
    idx, rep = tpersist.restore_sharded(store, D.ShardMesh(4), device=DEV)
    assert rep.step == 1 and rep.skipped[0][0] == 2
    _same(_answers(idx, *data["probe"]), ref["bad_fallback"], "fallback")
    _same(_answers(idx, *data["probe"]), ref["live_4_1"], "step 1")
    assert ref["bad_raise"] == "raised"
    with pytest.raises(tpersist.SnapshotCorruption):
        tpersist.restore_sharded(store, D.ShardMesh(4), on_corrupt="raise",
                                 device=DEV)
    with pytest.raises(tpersist.SnapshotCorruption):
        tpersist.restore_sharded(store, D.ShardMesh(4), step=2, device=DEV)
    # a dropped shard file quarantines too; a torn manifest falls back
    shutil.rmtree(bad)
    shutil.copytree(tmp / "ref4", bad)
    fi.drop_file(store, 2, "shard_00003.npz")
    idx, rep = tpersist.restore_sharded(store, D.ShardMesh(4),
                                        on_corrupt="quarantine", device=DEV)
    assert idx.quarantined == [3] and rep.step == 2
    fi.tear_manifest(store, 2)
    idx, rep = tpersist.restore_sharded(store, D.ShardMesh(4),
                                        on_corrupt="quarantine", device=DEV)
    assert rep.step == 1 and idx.quarantined == []
    with pytest.raises(ValueError, match="on_corrupt"):
        tpersist.restore_sharded(store, D.ShardMesh(4), on_corrupt="skip",
                                 device=DEV)


def test_killed_write_and_async_snapshot_under_churn(case, monkeypatch):
    """A writer killed mid-snapshot (the port's ``_write_bytes`` seam)
    commits nothing and the restore serves the previous step; an async
    snapshot taken just before more churn holds the state it was taken
    at (every array is on the host, copied, before it returns)."""
    data, _, _, tmp = case
    keys, batches = data["build"][4]
    store = tpersist.SnapshotStore(str(tmp / "kill"))
    idx = _build(keys, batches[:1], 4)
    tpersist.snapshot_sharded(store, 1, idx, blocking=True)
    want = _answers(idx, *data["probe"])
    real = tpersist._write_bytes
    calls = {"n": 0}

    def crash(path, payload):
        if calls["n"] >= 2:
            real(path, payload[:len(payload) // 2])
            raise RuntimeError("killed")
        calls["n"] += 1
        real(path, payload)

    idx.insert_batch(batches[1][0])
    monkeypatch.setattr(tpersist, "_write_bytes", crash)
    with pytest.raises(RuntimeError, match="killed"):
        tpersist.snapshot_sharded(store, 2, idx, blocking=True)
    monkeypatch.undo()
    assert store.steps() == [1]
    back, rep = tpersist.restore_sharded(store, D.ShardMesh(4), device=DEV)
    assert rep.step == 1
    _same(_answers(back, *data["probe"]), want, "after the killed write")
    # async: churn right after the call does not reach the snapshot
    want = _answers(idx, *data["probe"])
    tpersist.snapshot_sharded(store, 3, idx)
    idx.delete_batch(idx.live_keys()[::3])
    idx.insert_batch(batches[1][0] * 1.5)
    store.wait()
    back, _ = tpersist.restore_sharded(store, D.ShardMesh(4), device=DEV)
    _same(_answers(back, *data["probe"]), want, "async snapshot")


def test_facade_snapshot_restore_and_empty_reshard(tmp_path):
    """``Index`` snapshots and restores the sharded backend (``mesh=``,
    resharded on restore); an index with no live key reshards into empty
    shards."""
    keys = _f32(np.random.default_rng(3).lognormal(0, 1, 500))
    ix = Index.build(keys, mesh=D.ShardMesh(3), n_leaves=8, device=DEV)
    ix.snapshot(tmp_path, 5)
    for n in (3, 5):
        back = Index.restore(tmp_path, mesh=D.ShardMesh(n), device=DEV)
        assert back.sharded and back.backend.n_shards == n
        np.testing.assert_array_equal(back.live_keys(), keys)
        for a, b in zip(back.find(keys[::7]), ix.find(keys[::7]),
                        strict=True):
            assert torch.equal(a, b)
    assert ix.drift_scores().shape == (3, 2)
    ix.delete(keys)
    out, stats = tpersist.reshard_sharded(ix.backend, D.ShardMesh(2))
    assert stats.empty_builds == 2 and np.isneginf(out.splits).all()
    assert out.total_live == 0
    f, r = out.find(keys[:5])
    assert not f.any() and not r.any()
