"""Single-host snapshots and restore in the port (``core.persist``,
``Index.snapshot`` / ``Index.restore``), ``DynamicRMI.clone`` and
``shrink_capacity``, held against the reference.

Every comparison is exact: answers (found, rank, rank_lo, rank_hi), live
keys, counters, tier shapes, manifests, and the restored index's derived
state (packed tables, leaf rows, f32 keys and their fence, search depth,
tombstone prefix sums) against the live index's.

* Round trips in the port on the CPU: an empty index, a delta-only one, an
  all-tombstone one, a pooled MLP index with a drift monitor, and the bf16
  / f64 view-cast codec; ``find`` and ``find_range`` on both paths.
* Across packages, both ways: the reference's snapshot restored by the
  port and the port's by the reference answer as the writer did, and both
  packages write the same files, array names, shapes and dtypes.
* Fault seams: a write killed mid-file, transient ``OSError``s, a failing
  async write (an injector over the port's ``persist._write_bytes``,
  written here), and the at-rest faults of ``tests/faultinject.py``.
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

import repro  # noqa: F401  (enables x64 for the reference)
import faultinject as fi
import jax.numpy as jnp
from repro.api import Index as JIndex
from repro.core import persist as jpersist
from repro.core import reuse as jreuse
from repro.core import synth as jsynth
from repro.core import updates as jupdates
from torch_export import export_dynamic

from repro_torch.api import Index
from repro_torch.convert import dynamic_from_arrays
from repro_torch.core import persist as tpersist
from repro_torch.core import reuse as treuse
from repro_torch.core import synth as tsynth
from repro_torch.core.updates import DynamicRMI

DEV = "cpu"


def _f32(a):
    return np.asarray(a, np.float64).astype(np.float32).astype(np.float64)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _churned(seed=3, n=3000, **kw) -> Index:
    rng = np.random.default_rng(seed)
    base = np.unique(_f32(rng.lognormal(0, 0.8, n) * 1e3))
    ix = Index.build(base, n_leaves=16, eps=0.7, device=DEV, **kw)
    fresh = np.setdiff1d(np.unique(_f32(rng.lognormal(0, 0.8, 4 * n) * 1e3)),
                         base)
    ix.insert(fresh[:400])
    ix.delete(rng.choice(base, 200, replace=False))
    return ix


def _probes(live, seed=7):
    rng = np.random.default_rng(seed)
    if live.size == 0:
        return np.asarray([0.0, 1.0, -3.5])
    q = np.concatenate([rng.choice(live, 300),
                        _f32(rng.uniform(live[0] - 1, live[-1] + 1, 100)),
                        [live[0], live[-1], np.inf, -np.inf]])
    return q


def _answers(d, q, path):
    """find and find_range answers as host arrays (either package)."""
    if isinstance(d, DynamicRMI):
        f, r = d.find(q, path=path)
        lo, hi = d.find_range(q, q + 2.5, path=path)
    else:
        f, r = d.find(jnp.asarray(q), path=path)
        lo, hi = d.find_range(jnp.asarray(q), jnp.asarray(q + 2.5), path=path)
    return [_np(a) for a in (f, r, lo, hi)]


def _same_answers(a, b, q, paths=("jnp", "kernel")):
    for path in paths:
        for x, y in zip(_answers(a, q, path), _answers(b, q, path),
                        strict=True):
            np.testing.assert_array_equal(x, y, err_msg=path)


def _same_bits(a: torch.Tensor, b: torch.Tensor, what=""):
    """Equal shapes, dtypes and bit patterns (NaN included: a leaf whose
    MLP fit diverged holds NaN parameters, in the reference too)."""
    assert a.dtype == b.dtype and a.shape == b.shape, what
    if a.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a, b = (x.view(ints[x.element_size()]) for x in (a, b))
    assert torch.equal(a, b), what


def _same_derived(live: DynamicRMI, back: DynamicRMI):
    """The restored index's derived state equals the live index's."""
    li, bi = live.index, back.index
    for i, (a, b) in enumerate(zip(
            li.packed_tables() + (li.leaf_rows(), li.keys_f32, li.key_fence),
            bi.packed_tables() + (bi.leaf_rows(), bi.keys_f32, bi.key_fence),
            strict=True)):
        _same_bits(a, b, f"root, mat, vec, rows, keys_f32, fence [{i}]")
    assert bi.search_iters == li.search_iters
    assert bi.f32_exact == li.f32_exact
    for name in ("base_psum", "delta_psum", "delta_keys_f32"):
        _same_bits(getattr(back, name), getattr(live, name), name)
    _same_bits(back.packed_root(li.n_leaves), live.packed_root(li.n_leaves))


def _same_state(a: DynamicRMI, b: DynamicRMI):
    for name in ("eps", "route_n", "base_n", "base_dead_count", "delta_live",
                 "delta_dead_count", "delta_compactions", "rebuilds",
                 "deleted", "capacity_shrinks", "swap_on_drift",
                 "swaps_committed", "swap_rejects", "reuse_on_rebuild",
                 "compact_dead_ratio", "build_kwargs"):
        assert getattr(a, name) == getattr(b, name), name
    for name in ("n_inserts", "budget", "_win"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    np.testing.assert_array_equal(a.live_keys(), b.live_keys())


def _roundtrip(ix: Index, tmp_path) -> Index:
    ix.snapshot(tmp_path, 1)
    back = Index.restore(str(tmp_path), device=DEV)
    _same_state(ix.backend, back.backend)
    _same_derived(ix.backend, back.backend)
    _same_answers(ix.backend, back.backend, _probes(ix.live_keys()))
    return back


# ---------------------------------------------------------------------------
# Round trips in the port.
# ---------------------------------------------------------------------------
def test_churned_roundtrip_and_facade(tmp_path):
    ix = _churned()
    assert ix.backend.rebuilds > 0 and ix.backend.base_dead_count > 0
    back = _roundtrip(ix, tmp_path)
    assert back.backend.device.type == "cpu"
    # the restored index keeps serving churn exactly as the live one does
    extra = _f32(np.linspace(10.0, 20.0, 257))
    for d in (ix, back):
        d.insert(extra)
        d.delete(extra[::3])
    _same_state(ix.backend, back.backend)
    _same_answers(ix.backend, back.backend, _probes(ix.live_keys()))


def test_empty_index_roundtrip(tmp_path):
    ix = Index.build(np.zeros((0,), np.float64), n_leaves=8, eps=0.7,
                     device=DEV)
    back = _roundtrip(ix, tmp_path)
    back.insert(np.asarray([4.0, 2.0, 8.0]))
    f, r = back.find(np.asarray([2.0, 3.0, 8.0]))
    np.testing.assert_array_equal(_np(r), [0, 1, 2])
    np.testing.assert_array_equal(_np(f), [True, False, True])


def test_delta_only_roundtrip(linear_pools, tmp_path):
    """Every key in the delta tier over an empty base: swap mode defers the
    repairs of the over-budget leaves to the maintenance pass."""
    ix = Index.build(np.zeros((0,), np.float64), pool=linear_pools[1],
                     n_leaves=8, eps=0.7, drift_bins=16, swap_on_drift=True,
                     device=DEV)
    keys = np.unique(_f32(np.random.default_rng(5).uniform(0, 100, 500)))
    ix.insert(keys)
    assert ix.backend.delta_live == keys.size and ix.backend.base_n == 0
    _roundtrip(ix, tmp_path)


def test_all_tombstone_roundtrip(tmp_path):
    ix = _churned()
    keys = ix.live_keys()
    ix.delete(keys)
    assert ix.live_count == 0
    back = _roundtrip(ix, tmp_path)
    f, _ = back.find(keys[::5])
    assert not bool(f.any())


@pytest.fixture(scope="module")
def mlp_pool():
    return treuse.build_pool(tsynth.generate_pool(0.9, limit=48),
                             kind="mlp", train_steps=30, device=DEV)


def test_pooled_mlp_drift_roundtrip(mlp_pool, tmp_path):
    """A pooled MLP index with a drift monitor in swap mode, after shifted
    ingest latched the monitor: the pool, the monitor's histograms, score
    and latch and the swap counters ride the snapshot."""
    rng = np.random.default_rng(9)
    keys = np.unique(_f32(rng.lognormal(0, 0.5, 6000)))
    ix = Index.build(keys, pool=mlp_pool, kind="mlp", n_leaves=32, eps=0.9,
                     train_steps=30, drift_bins=64, drift_hi=0.08,
                     drift_lo=0.04, swap_on_drift=True, device=DEV)
    for _ in range(3):
        ix.insert(_f32(rng.lognormal(1.5, 0.3, 600)))
    ix.maybe_swap()
    d = ix.backend
    assert bool(d.drift.drifted) and d.drift.updates == 3
    back = _roundtrip(ix, tmp_path)
    b = back.backend
    np.testing.assert_array_equal(back.drift_scores(), ix.drift_scores())
    for name in ("ref", "acc", "score", "drifted"):
        _same_bits(getattr(b.drift, name), getattr(d.drift, name), name)
    for name in ("m", "lo", "hi", "thresh_hi", "thresh_lo", "updates",
                 "rebaselines"):
        assert getattr(b.drift, name) == getattr(d.drift, name), name
    p, q = d.pool, b.pool
    assert (q.eps, q.m, q.kind, q.reuse_count, q.trained_count) == \
        (p.eps, p.m, p.kind, p.reuse_count, p.trained_count)
    for a, c in zip(p.params + p.domains + (p.hists, p.err_lo, p.err_hi)
                    + p.tables(),
                    q.params + q.domains + (q.hists, q.err_lo, q.err_hi)
                    + q.tables(), strict=True):
        _same_bits(a, c)
    # the restored monitor keeps accumulating, and swaps keep running
    for x in (ix, back):
        x.insert(_f32(np.random.default_rng(11).lognormal(1.5, 0.3, 600)))
        x.maybe_swap()
    assert b.drift.updates == d.drift.updates == 4
    _same_state(d, b)
    _same_answers(d, b, _probes(ix.live_keys()))


def test_bf16_and_f64_viewcast_roundtrip(tmp_path):
    """bf16 rides npz as its 16-bit words tagged "bfloat16" (the
    reference's codec) and comes back a bf16 tensor; f64 beside it; the
    reference reads the same file as ml_dtypes bf16 with the same words."""
    rng = np.random.default_rng(0)
    bf = torch.from_numpy(rng.normal(size=(33,)).astype(np.float32)) \
        .to(torch.bfloat16)
    f64 = rng.normal(size=(17,))
    store = tpersist.SnapshotStore(str(tmp_path))
    store.save(1, {"x.npz": {"bf": bf, "f": f64},
                   "y.npy": {"": bf.reshape(3, 11)}}, blocking=True)
    got = store.load_file(1, "x.npz")
    assert got["bf"].dtype == torch.bfloat16
    assert torch.equal(got["bf"].view(torch.int16), bf.view(torch.int16))
    assert got["f"].dtype == np.float64
    np.testing.assert_array_equal(got["f"], f64)
    y = store.load_file(1, "y.npy")[""]
    assert tuple(y.shape) == (3, 11) and y.dtype == torch.bfloat16
    ref = jpersist.SnapshotStore(str(tmp_path)).load_file(1, "x.npz")
    assert ref["bf"].dtype.name == "bfloat16"
    np.testing.assert_array_equal(ref["bf"].view(np.uint16),
                                  bf.view(torch.int16).numpy()
                                  .view(np.uint16))
    manifest = store.read_manifest(1)
    assert manifest["files"]["x.npz"]["arrays"]["bf"] == {
        "shape": [33], "dtype": "bfloat16"}


# ---------------------------------------------------------------------------
# Across packages.
# ---------------------------------------------------------------------------
def _manifest(path, step):
    with open(os.path.join(path, f"step_{step:08d}", "manifest.json")) as f:
        m = json.load(f)
    files = {f: e["arrays"] for f, e in m["files"].items()}
    return m, files


@pytest.fixture(scope="module")
def linear_pools():
    sp = jsynth.generate_pool(0.65, ns=100, limit=40)
    j = jreuse.build_pool(sp, kind="linear", m_sim=64)
    t = treuse.build_pool(tsynth.generate_pool(0.65, ns=100, limit=40),
                          kind="linear", m_sim=64, device=DEV)
    return j, t


def _both_churned(pools):
    """The same keys and churn through both packages, pooled, with a drift
    monitor: (reference index, port index, probes)."""
    rng = np.random.default_rng(21)
    keys = np.unique(_f32(rng.lognormal(0, 0.6, 4000)))
    kw = dict(n_leaves=32, eps=0.65, drift_bins=64, drift_hi=0.08,
              drift_lo=0.04, swap_on_drift=True)
    j = JIndex.build(jnp.asarray(keys), pool=pools[0], **kw)
    t = Index.build(keys, pool=pools[1], device=DEV, **kw)
    batches = [_f32(rng.lognormal(1.2, 0.4, 500)) for _ in range(2)]
    dels = rng.choice(keys, 150, replace=False)
    for x in (j, t):
        for b in batches:
            x.insert(b)
        x.delete(dels)
        x.maybe_swap()
    return j, t, _probes(t.live_keys())


def test_cross_package_snapshots_restore_both_ways(linear_pools, tmp_path):
    j, t, q = _both_churned(linear_pools)
    np.testing.assert_array_equal(j.live_keys(), t.live_keys())
    jdir, tdir = tmp_path / "ref", tmp_path / "port"
    j.snapshot(str(jdir), 4)
    t.snapshot(str(tdir), 4)
    # the same files, array names, shapes and dtypes, kind and meta keys
    jm, jf = _manifest(jdir, 4)
    tm, tf = _manifest(tdir, 4)
    assert jf == tf
    assert (jm["schema"], jm["kind"], jm["step"]) == \
        (tm["schema"], tm["kind"], tm["step"])
    assert sorted(jm["meta"]["shard"]) == sorted(tm["meta"]["shard"])
    assert sorted(jm["meta"]["shard"]["drift"]) == \
        sorted(tm["meta"]["shard"]["drift"])
    assert jm["meta"]["pool"].keys() == tm["meta"]["pool"].keys()
    # the reference's snapshot in the port, the port's in the reference
    tj = Index.restore(str(jdir), device=DEV)
    jt = JIndex.restore(str(tdir))
    _same_answers(j.backend, tj.backend, q)
    _same_answers(t.backend, jt.backend, q)
    np.testing.assert_array_equal(tj.live_keys(), j.live_keys())
    np.testing.assert_array_equal(jt.live_keys(), t.live_keys())
    np.testing.assert_array_equal(tj.drift_scores(), j.drift_scores())
    np.testing.assert_array_equal(jt.drift_scores(), t.drift_scores())
    # the port carries the reference's index on as the reference does
    extra = _f32(np.linspace(2.0, 2.5, 300))
    for x in (j, tj):
        x.insert(extra)
        x.maybe_swap()
    _same_answers(j.backend, tj.backend, q)
    assert tj.backend.rebuilds == j.backend.rebuilds


def test_restore_checks_kind_and_steps(tmp_path):
    store = tpersist.SnapshotStore(str(tmp_path))
    with pytest.raises(tpersist.SnapshotError, match="no snapshots"):
        tpersist.restore_dynamic(store, device=DEV)
    store.save(1, {"a.npy": {"": np.arange(3.0)}}, blocking=True)
    with pytest.raises(tpersist.SnapshotCorruption, match="kind"):
        tpersist.restore_dynamic(store, device=DEV)
    with pytest.raises(ValueError, match="on_corrupt"):
        tpersist.restore_dynamic(store, on_corrupt="quarantine", device=DEV)


# ---------------------------------------------------------------------------
# Fault seams.
# ---------------------------------------------------------------------------
class _Crash(RuntimeError):
    """A writer killed mid-snapshot (not an OSError: no retry absorbs it)."""


def _inject(monkeypatch, *, kill_after=None, transient=0, fail=False):
    """Replace the port's ``_write_bytes`` seam; returns its counters."""
    real = tpersist._write_bytes
    st = {"writes": 0, "raised": 0}

    def inject(path, data):
        if fail:
            st["raised"] += 1
            raise OSError(f"injected permanent failure on {path}")
        if st["raised"] < transient:
            st["raised"] += 1
            raise OSError(f"injected transient failure on {path}")
        if kill_after is not None and st["writes"] >= kill_after:
            real(path, data[:max(len(data) // 2, 1)])   # a torn file
            st["raised"] += 1
            raise _Crash(f"killed writing {path}")
        real(path, data)
        st["writes"] += 1

    monkeypatch.setattr(tpersist, "_write_bytes", inject)
    return st


def test_async_write_failure_surfaces(tmp_path, monkeypatch):
    store = tpersist.SnapshotStore(str(tmp_path))
    _inject(monkeypatch, fail=True)
    store.save(1, {"a.npy": {"": np.arange(4.0)}})
    with pytest.raises(tpersist.SnapshotError):
        store.wait()
    # the error is consumed once; the store stays usable
    monkeypatch.undo()
    store.save(2, {"a.npy": {"": np.arange(4.0)}}, blocking=True)
    assert store.steps() == [2]
    # a failure is also raised from the next save()
    _inject(monkeypatch, fail=True)
    store.save(3, {"a.npy": {"": np.arange(4.0)}})
    store._q.join()
    with pytest.raises(tpersist.SnapshotError):
        store.save(4, {"a.npy": {"": np.arange(4.0)}})


def test_transient_write_errors_retry_with_backoff(tmp_path, monkeypatch):
    store = tpersist.SnapshotStore(str(tmp_path), retries=3, backoff=0.001)
    st = _inject(monkeypatch, transient=2)
    store.save(1, {"a.npy": {"": np.arange(4.0)}}, blocking=True)
    assert st["raised"] == 2 and store.write_retries == 2
    assert store.steps() == [1]
    _inject(monkeypatch, transient=50)
    with pytest.raises(OSError):
        store.save(2, {"a.npy": {"": np.arange(4.0)}}, blocking=True)
    assert store.steps() == [1]


def test_kill_mid_write_commits_nothing(tmp_path, monkeypatch):
    ix = _churned()
    q = _probes(ix.live_keys())
    want = _answers(ix.backend, q, "jnp")
    store = tpersist.SnapshotStore(str(tmp_path))
    ix.snapshot(store, 1)
    ix.insert(np.asarray([1.5, 2.5]))
    _inject(monkeypatch, kill_after=0)
    with pytest.raises(_Crash):
        ix.snapshot(store, 2)
    monkeypatch.undo()
    assert store.steps() == [1]
    assert any(s.endswith(".tmp") for s in os.listdir(tmp_path))
    back, step = tpersist.restore_dynamic(store, device=DEV)
    assert step == 1
    for x, y in zip(_answers(back, q, "jnp"), want, strict=True):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("fault", ["tear_manifest", "flip_byte", "drop_file"])
def test_at_rest_fault_falls_back_or_raises(fault, tmp_path):
    """A damaged newest snapshot: the default restore serves the previous
    step; ``on_corrupt="raise"`` and an explicit ``step`` raise."""
    ix = _churned()
    q = _probes(ix.live_keys())
    want = _answers(ix.backend, q, "jnp")
    store = tpersist.SnapshotStore(str(tmp_path))
    ix.snapshot(store, 1)
    ix.insert(np.asarray([7.25, 8.5]))
    ix.delete(q[:20])
    ix.snapshot(store, 2, blocking=False)
    store.wait()
    if fault == "tear_manifest":
        fi.tear_manifest(store, 2)
    else:
        getattr(fi, fault)(store, 2, "shard_00000.npz")
    back = Index.restore(store, device=DEV)
    for x, y in zip(_answers(back.backend, q, "jnp"), want, strict=True):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(tpersist.SnapshotCorruption):
        tpersist.restore_dynamic(store, on_corrupt="raise", device=DEV)
    with pytest.raises(tpersist.SnapshotCorruption):
        Index.restore(store, step=2, device=DEV)


def test_gc_keeps_the_newest(tmp_path):
    store = tpersist.SnapshotStore(str(tmp_path), keep=2)
    ix = _churned()
    for step in (1, 2, 3):
        ix.snapshot(store, step, blocking=False)
    store.wait()
    assert store.steps() == [2, 3] and store.latest_step() == 3


# ---------------------------------------------------------------------------
# clone and shrink_capacity.
# ---------------------------------------------------------------------------
def test_clone_leaves_the_original_untouched():
    ix = _churned(drift_bins=32)
    d = ix.backend
    q = _probes(ix.live_keys())
    want = _answers(d, q, "jnp")
    before = (d.live_keys(), d.n_inserts.copy(), d.budget.copy(),
              d._win.copy(), d.index.search_iters, d.rebuilds,
              d.drift.updates)
    c = d.clone()
    rng = np.random.default_rng(2)
    lo = float(before[0][0])
    c.insert_batch(_f32(rng.uniform(lo, lo + 5.0, 900)))     # rebuilds
    c.delete_batch(rng.choice(c.live_keys(), 500, replace=False))
    c.flush_delta()
    assert c.rebuilds > d.rebuilds
    np.testing.assert_array_equal(d.live_keys(), before[0])
    for a, b in zip((d.n_inserts, d.budget, d._win), before[1:4],
                    strict=True):
        np.testing.assert_array_equal(a, b)
    assert (d.index.search_iters, d.rebuilds, d.drift.updates) == before[4:]
    for x, y in zip(_answers(d, q, "jnp"), want, strict=True):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(_answers(d, q, "kernel"), want, strict=True):
        np.testing.assert_array_equal(x, y)


def test_shrink_capacity_matches_reference():
    """Both tiers stranded: the base by a reference ``shed_suffix`` (the
    donor half of a migration; carried across), the delta tier by inserts
    that a flush then merged away.  The port's shrink equals the
    reference's: tier shapes, ``capacity_shrinks``, depth and answers, and
    a small batch cannot climb back across."""
    rng = np.random.default_rng(11)
    keys = np.unique(_f32(rng.lognormal(0, 0.8, 30_000) * 1e3))
    j = jupdates.DynamicRMI.build(jnp.asarray(keys), eps=0.7, n_leaves=32,
                                  kind="linear")
    j.shed_suffix(float(keys[999]))
    t = dynamic_from_arrays(export_dynamic(j), device=DEV)
    fresh = np.setdiff1d(np.unique(_f32(rng.uniform(keys[0], keys[999],
                                                    3000))), keys)
    for d in (j, t):
        d.insert_batch(jnp.asarray(fresh) if d is j else fresh)
        d.flush_delta()
    for d in (j, t):
        assert d.delta_keys.shape[0] >= 4096 and d.delta_live == 0
    cap0 = (int(t.index.keys.shape[0]), int(t.delta_keys.shape[0]))
    assert t.shrink_capacity() is True
    assert j.shrink_capacity() is True
    assert t.capacity_shrinks == j.capacity_shrinks == 2
    for a, b in ((t.index.keys, j.index.keys), (t.base_dead, j.base_dead),
                 (t.base_psum, j.base_psum), (t.delta_keys, j.delta_keys),
                 (t.delta_leaf, j.delta_leaf), (t.delta_psum, j.delta_psum)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    assert (int(t.index.keys.shape[0]), int(t.delta_keys.shape[0])) < cap0
    assert t.index.search_iters == j.index.search_iters
    assert t.index.keys_f32.shape[0] == t.index.keys.shape[0]
    q = _probes(t.live_keys())
    _same_answers(t, j, q)
    small = np.setdiff1d(_f32(rng.uniform(keys[0], keys[999], 200)),
                         t.live_keys())[:128]
    for d in (j, t):
        d.insert_batch(jnp.asarray(small) if d is j else small)
        assert not d.shrink_capacity()
    assert t.capacity_shrinks == j.capacity_shrinks == 2
    _same_answers(t, j, _probes(t.live_keys()))
