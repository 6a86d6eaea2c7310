"""The port's main path held against the reference, at small sizes: the
single-host dynamic learned index (build -> insert / delete / find /
find_range / gather_range), plus the port's device and import rules.

Tolerances: integer outputs (found, rank, rank_lo/rank_hi, live keys,
counters, rebuild counts, search depth) are compared bit for bit.  f64
model parameters and error bounds agree to ``rtol=1e-9`` / ``atol=1e-6``
positions: both packages fit with cumulative sums over f64, but XLA and
torch sum in different orders (and XLA:CPU contracts ``a*x + b`` into an
FMA), so the parameters differ in their last bits.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro  # noqa: F401  (enables x64 for the reference)
import jax.numpy as jnp
from repro.core import rmi as jrmi
from repro.core.updates import DynamicRMI as JDynamicRMI
from torch_export import DISTS, export_dynamic, gen_keys, gen_queries

import repro_torch
from repro_torch.api import Index
from repro_torch.convert import dynamic_from_arrays
from repro_torch.core import rmi as trmi
from repro_torch.core.updates import DynamicRMI as TDynamicRMI

ROOT = Path(__file__).resolve().parents[1]
N_LEAVES = 64
Q = 256
RTOL, ATOL = 1e-9, 1e-6


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _close(t, j, what):
    t, j = _np(t), _np(j)
    scale = max(float(np.abs(j[np.isfinite(j)]).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL * scale,
                               err_msg=what)


@pytest.mark.parametrize("dist", DISTS)
def test_build_rmi_parity(dist):
    rng = np.random.default_rng(10)
    keys = gen_keys(rng, dist, 6000)
    j = jrmi.build_rmi(jnp.asarray(keys), n_leaves=N_LEAVES)
    t = trmi.build_rmi(keys, n_leaves=N_LEAVES, device="cpu")
    for name in ("a", "b"):
        _close(getattr(t.root, name), getattr(j.root, name), f"root.{name}")
        _close(getattr(t.leaves, name), getattr(j.leaves, name),
               f"leaf.{name}")
    _close(t.err_lo, j.err_lo, "err_lo")
    _close(t.err_hi, j.err_hi, "err_hi")
    assert t.search_iters == j.search_iters
    q = gen_queries(rng, keys, Q)
    for path in ("kernel", "jnp"):
        np.testing.assert_array_equal(
            _np(trmi.lookup(t, q, path=path)),
            np.asarray(jrmi.lookup(j, jnp.asarray(q), path=path)),
            err_msg=path)


def _state(d):
    return dict(rebuilds=d.rebuilds, compactions=d.delta_compactions,
                base_n=d.base_n, delta_live=d.delta_live,
                delta_dead=d.delta_dead_count, base_dead=d.base_dead_count,
                deleted=d.deleted, iters=d.index.search_iters,
                cap=int(d.index.keys.shape[0]),
                dcap=int(d.delta_keys.shape[0]))


def _compare(t, j, rng, step, paths=("jnp",)):
    assert _state(t) == _state(j), step
    np.testing.assert_array_equal(t.n_inserts, j.n_inserts, err_msg=step)
    np.testing.assert_array_equal(t.budget, j.budget, err_msg=step)
    live = j.live_keys()
    np.testing.assert_array_equal(t.live_keys(), live, err_msg=step)
    _close(t.index.leaves.a, j.index.leaves.a, f"{step}: leaf.a")
    _close(t.index.leaves.b, j.index.leaves.b, f"{step}: leaf.b")
    _close(t.index.err_lo, j.index.err_lo, f"{step}: err_lo")
    _close(t.index.err_hi, j.index.err_hi, f"{step}: err_hi")
    q = gen_queries(rng, live, Q)
    hi = (q + rng.exponential(float(live[-1] - live[0]) / 50, Q)) \
        .astype(np.float32).astype(np.float64)
    for path in paths:
        for got, want in zip(t.find(q, path=path),
                             j.find(jnp.asarray(q), path=path), strict=True):
            np.testing.assert_array_equal(_np(got), np.asarray(want),
                                          err_msg=f"{step} find {path}")
        tr = t.find_range(q, hi, path=path)
        jr = j.find_range(jnp.asarray(q), jnp.asarray(hi), path=path)
        for got, want in zip(tr, jr, strict=True):
            np.testing.assert_array_equal(_np(got), np.asarray(want),
                                          err_msg=f"{step} range {path}")
    for a, b in zip(t.gather_range(*tr), j.gather_range(*jr), strict=True):
        np.testing.assert_array_equal(a, b, err_msg=f"{step} gather_range")


@pytest.mark.parametrize("dist", DISTS)
def test_churn_parity(dist):
    """Build in the reference, carry across, then run the same seeded
    churn through both packages: a rebuild, duplicate runs, tombstoned
    hits, a delta compaction and a flush."""
    rng = np.random.default_rng(20)
    keys = gen_keys(rng, dist, 4096)
    j = JDynamicRMI.build(jnp.asarray(keys), n_leaves=N_LEAVES)
    t = dynamic_from_arrays(export_dynamic(j), device="cpu")
    lo, hi = keys[0], keys[-1]
    f32 = lambda a: np.asarray(a, np.float32).astype(np.float64)

    def both(verb, arg):
        getattr(j, verb)(jnp.asarray(arg))
        getattr(t, verb)(arg)

    _compare(t, j, rng, "carried", paths=("jnp", "kernel"))
    both("insert_batch", f32(rng.uniform(lo, hi, 500)))
    both("insert_batch", f32(rng.uniform(lo, lo + (hi - lo) * 0.01, 700)))
    assert j.rebuilds > 0
    both("insert_batch", rng.choice(keys, 200))                 # duplicates
    _compare(t, j, rng, "inserts")
    live = j.live_keys()
    both("delete_batch", rng.choice(live, 300))                 # tombstones
    both("delete_batch", np.repeat(live[len(live) // 2], 3))    # dup run
    _compare(t, j, rng, "deletes")
    dk = np.asarray(j.delta_keys)
    both("delete_batch", rng.choice(dk[np.isfinite(dk)],
                                    max(j.delta_live // 2, 1), replace=False))
    assert j.delta_compactions > 0
    both("insert_batch", f32(rng.uniform(lo, hi, 300)))
    both("delete_batch", rng.choice(j.live_keys(), 100))
    both("insert_batch", f32(rng.uniform(lo, hi, 100)))         # dead merge
    _compare(t, j, rng, "compaction")
    j.flush_delta()
    t.flush_delta()
    _compare(t, j, rng, "flushed", paths=("jnp", "kernel"))


def test_index_facade_and_empty_build():
    """The facade over an empty build: inserts route through the zero
    root, and every verb agrees with a sorted-array truth."""
    ix = Index.build(np.zeros((0,)), n_leaves=16, device="cpu")
    rng = np.random.default_rng(30)
    ins = np.asarray(rng.uniform(0, 100, 300), np.float32).astype(np.float64)
    ix.insert(ins)
    ix.delete(ins[:50])
    live = np.sort(ins[50:])
    np.testing.assert_array_equal(ix.live_keys(), live)
    assert ix.live_count == live.size
    q = np.concatenate([ins[:100], [-5.0, 500.0]])
    for path in ("kernel", "jnp"):
        found, rank = ix.find(q, path=path)
        np.testing.assert_array_equal(_np(rank), np.searchsorted(live, q))
        np.testing.assert_array_equal(
            _np(found), np.searchsorted(live, q, side="right") > _np(rank))
        np.testing.assert_array_equal(ix.gather(rank[50:100]), q[50:100])
        rl, rh = ix.find_range(q, q + 10.0, path=path)
        spans = ix.gather_range(rl, rh)
        assert all(np.all((s >= a) & (s <= a + 10.0))
                   for s, a in zip(spans, q, strict=True))


def test_entry_points_raise_without_cuda(monkeypatch):
    """No card and no device='cpu': every entry point raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    keys = np.arange(100, dtype=np.float64)
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        Index.build(keys)
    with pytest.raises(RuntimeError, match="CUDA"):
        TDynamicRMI.build(keys)
    with pytest.raises(RuntimeError, match="CUDA"):
        trmi.build_rmi(keys)


def test_kernel_path_requires_f32_exact_keys():
    keys = np.sort(np.random.default_rng(40).uniform(0, 1, 1000)) + 1.0
    ix = Index.build(keys, n_leaves=16, device="cpu")
    with pytest.raises(ValueError, match="f32-exact"):
        ix.find(keys[:10], path="kernel")
    with pytest.raises(ValueError, match="f32-exact"):
        ix.find_range(keys[:10], keys[:10], path="kernel")
    found, rank = ix.find(keys[:10], path="auto")     # f64 path on the CPU
    assert bool(found.all())
    np.testing.assert_array_equal(_np(rank), np.arange(10))


def test_unported_options_raise(tmp_path):
    """``mesh=`` builds and restores the sharded index (once an unported
    option, now ported); ``snapshot`` and ``restore`` round-trip a 64-key
    index on the CPU, single-host and sharded, and a single-host snapshot
    does not restore as a sharded one."""
    from repro_torch.core.distributed import ShardMesh
    from repro_torch.core.persist import SnapshotCorruption
    keys = np.arange(64, dtype=np.float64)
    q = np.asarray([-1.0, 0.0, 10.5, 63.0, 64.0])
    ix = Index.build(keys, n_leaves=4, device="cpu")
    ix.snapshot(tmp_path / "one")
    with pytest.raises(SnapshotCorruption, match="kind"):
        Index.restore(tmp_path / "one", mesh=ShardMesh(2), device="cpu")
    back = Index.restore(tmp_path / "one", device="cpu")
    np.testing.assert_array_equal(back.live_keys(), keys)
    for got, want in zip(back.find(q), ix.find(q), strict=True):
        assert torch.equal(got, want)
    sx = Index.build(keys, mesh=ShardMesh(2), n_leaves=4, device="cpu")
    assert sx.sharded and sx.live_count == 64
    for got, want in zip(sx.find(q), ix.find(q), strict=True):
        assert torch.equal(got, want)
    sx.snapshot(tmp_path / "two")
    back = Index.restore(tmp_path / "two", mesh=ShardMesh(2), device="cpu")
    np.testing.assert_array_equal(back.live_keys(), keys)
    for got, want in zip(back.find(q), sx.find(q), strict=True):
        assert torch.equal(got, want)


def test_port_imports_neither_jax_nor_repro():
    """A fresh interpreter that imports the whole port and chip_smoke.py
    has neither jax nor the reference package in sys.modules."""
    script = (
        "import importlib.util, sys\n"
        "import repro_torch, repro_torch.api, repro_torch.convert\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.ref\n"
        "import repro_torch.kernels.build, repro_torch.kernels.ksdist\n"
        "import repro_torch.core.rmrt, repro_torch.core.reuse\n"
        "import repro_torch.core.synth, repro_torch.core.cdf\n"
        "import repro_torch.core.adapt, repro_torch.time_segments\n"
        "import repro_torch.core.drift, repro_torch.kernels.hist\n"
        "import repro_torch.kernels.linfit\n"
        "import repro_torch.core.btree, repro_torch.core.pgm\n"
        "import repro_torch.core.radix_spline, repro_torch.core.persist\n"
        "import repro_torch.core.distributed\n"
        "import repro_torch.data.indexed_dataset\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', "
        "sys.argv[1])\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", script,
                           str(ROOT / "chip_smoke.py")], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "clean" in proc.stdout
