"""The port's sharded index (``repro_torch.core.distributed``) against the
reference's (``repro.core.distributed``) on 1-, 2- and 4-shard meshes, and
the shard-stacked K1-K3 entries walked lane by lane.

The reference runs in one subprocess a mesh size (its device count locks at
the first jax init, as in ``conftest.run_mesh_script``), the three started
together and shared by every test here through a module fixture.  Each
subprocess runs ``path="jnp"`` (its sharded kernel path fails under
``shard_map(check_vma=True)`` on jax 0.9, ROADMAP queue 3) and takes
``find_range`` through ``_sharded_dynamic_range_fn`` on ``_stacked()``
directly, sliced with numpy (``ShardedDynamicIndex.find_range`` slices a
sharded output and raises on more than one device, ROADMAP queue 3).  It
draws every batch and records the batches with its answers; the port then
runs the same operations with ``device="cpu"`` on both of its paths -- the
f64 path and the kernel path, whose shard-stacked kernels take their plain
versions on the CPU -- and every integer output must equal the
reference's bit for bit:

* ``shard_bounds`` and the splits over lognormal, duplicate-heavy and
  all-empty-prefix keys;
* ``make_lookup_fn`` ranks with ``capacity_factor`` None, 2.0 and 1.0 (the
  -1s where the budget drops queries too: the reference's scatter into a
  pair's last slot is applied in order on XLA:CPU, so the last query in
  batch order wins it, and the port mirrors that);
* ``find`` / ``find_range`` over lognormal, duplicate-heavy, seam-placed
  and non-finite queries after every step of a churn: three insert/delete
  rounds, a skewed ingest at each end (a shard sheds its suffix to the
  right neighbour and its prefix to the left one), a dead-hot shard
  rebuilt in place, a delta-hot shard flushed, a giant duplicate run that
  cannot move (its skew trigger muted), and a batch whose seam misses
  (queries routed to empty leaves) exceed the reference's per-call budget
  of 1,024 in one shard and not in the others;
* the counters, splits, mutes, counter table and ``live_keys()`` after
  every step, and a warm stack against a cold one;
* all of the above again on mesh positions (``ShardMesh(devices=...)``,
  ``tests/torch_mesh.py``: one CPU position a shard, and two positions of
  two shards), which must equal the reference and the one stack bit for
  bit, each shard on its position and each position's stack its own.

Without the reference: the shard-stacked K1-K3 walked lane by lane in
numpy (each lane's descriptor, warps whose lanes span shards, an empty
shard, rows starting inside a 32-byte sector) against their plain
versions and S single-index plain calls; the epilogues' searches confined
to each query's row; batches of any size; and, in process,
``shed_suffix`` / ``shed_prefix`` against the reference's.  On a card
(``gpu`` marker) the stacked kernels against their plain versions and the
index's answers on the card against the CPU's.

The absorb branch of ``_maybe_rebalance`` (a hot shard taking runs from a
heavier neighbour) is not reached: at ``rebalance_skew`` 2 on at most four
shards a skewed shard holds more than half of all live keys, so only a
muted neighbour could outweigh it, and a muted shard's giant run sits at
its start, where no cut can take anything.  Its migration is the same
``_migrate`` as a shed in the other direction, which both ends cover.
"""
from __future__ import annotations

import copy
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import distributed as D
from repro_torch.kernels import lookup as tlk
from repro_torch.kernels import ops
from torch_mesh import (HOME_KEYS, POSITIONED, cpu_mesh, stack_scalars,
                        stack_tensors)

MESHES = (1, 2, 4)
PATHS = ("jnp", "kernel")

_SCRIPT = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=%(ndev)d"
import numpy as np, jax, jax.numpy as jnp
from repro.core import distributed as D
sys.path.insert(0, %(tests)r)
from torch_export import export_sharded, export_sharded_index

ndev = %(ndev)d
mesh = jax.make_mesh((ndev,), ("data",))
rng = np.random.default_rng(71 + ndev)
out = {"ops": [], "recs": []}

def f32(x):
    return np.unique(np.asarray(x, np.float64).astype(np.float32)) \
        .astype(np.float64)

def f32draw(lo, hi, m):
    return np.asarray(rng.uniform(lo, hi, m), np.float32).astype(np.float64)

# ---- partitions ----------------------------------------------------------
u = f32(rng.uniform(1, 100, 40))
parts = dict(lognormal=f32(rng.lognormal(0, 1, 997) * 1e3),
             dup=np.repeat(u, rng.integers(1, 90, u.size)),
             prefix=np.concatenate([np.full(300, 7.0),
                                    f32(rng.uniform(8, 9, 23))]))
for name, k in parts.items():
    b = D.shard_bounds(k, ndev)
    out["part_" + name] = (k, b, D._splits_from_bounds(k, b))

# ---- the static index ------------------------------------------------------
# a lognormal cluster and far outliers: the last shard's leaves between them
# are empty, and queries in the gap miss their windows
cluster = f32(rng.lognormal(0, 0.8, 6000) * 1e3)
base = np.concatenate([cluster, f32(rng.uniform(1e6, 2e6, 40))])

def static_queries(keys, splits, m=512):
    q = np.concatenate([
        splits, [np.inf, np.nan, -np.inf, 0.0, 1e30, -1e30],
        rng.choice(keys, m // 2), f32draw(keys[0], keys[-1], m)])
    q = rng.permutation(q[:m - m // 8])
    # the first block all into shard 0: it overflows finite budgets
    head = rng.choice(keys[:max(keys.size // (2 * ndev), 1)], m // 8)
    return np.concatenate([head, q])

si = D.build_sharded(jnp.asarray(base), mesh, n_leaves=64)
q = static_queries(base, np.asarray(si.splits))
res = {}
for cf in (None, 2.0, 1.0):
    fn = D.make_lookup_fn(si, capacity_factor=cf, path="jnp")
    res[cf] = np.asarray(fn(jnp.asarray(q)))
out["static"] = (base, q, res, export_sharded_index(si))

# ---- the dynamic index -----------------------------------------------------
idx = D.ShardedDynamicIndex.build(jnp.asarray(base), mesh, n_leaves=32,
                                  eps=0.2)
live = base.copy()
fresh = np.setdiff1d(f32(rng.lognormal(0, 0.8, 40000) * 1e3), base)
fresh = fresh[fresh < cluster[-1]]
COUNTERS = ("rebalances", "migrations_incremental", "migrations_full",
            "restack_full", "restack_rows", "capacity_shrinks")

def splits():
    return np.asarray(idx.splits, np.float64).copy()

def find_queries(m=512):
    sp = splits()
    dups = np.repeat(rng.choice(live, 8), 3)
    q = np.concatenate([rng.choice(live, m // 2), dups, sp,
                        f32draw(live[0], live[-1], 64),
                        [np.inf, np.nan, -np.inf, 0.0, 1e30, -1e30,
                         live[0], live[-1]]])
    q = np.concatenate([q, rng.choice(fresh, max(m - q.size, 0))])[:m]
    return rng.permutation(q)

def range_pairs(m=256):
    lo = np.concatenate([rng.choice(live, m - 24), splits()[:8],
                         [live[0], live[-1], -np.inf, 0.0]])[:m - 8]
    lo = np.concatenate([lo, f32draw(live[0], live[-1], m - lo.size)])
    hi = (lo * (1 + rng.uniform(0, 0.03, m))).astype(np.float32) \
        .astype(np.float64)
    hi[-8:] = lo[-8:]                    # point ranges
    lo[-4:], hi[-4:] = hi[-4:] + 1.0, lo[-4:]   # degenerate lo > hi
    hi[:8] = np.where(np.isfinite(hi[:8]), hi[:8], 1e30)
    return lo, hi

def rec(tag, q=None):
    q = find_queries() if q is None else q
    f, r = idx.find(jnp.asarray(q), path="jnp")
    lo, hi = range_pairs()
    st = idx._stacked()
    fn = D._sharded_dynamic_range_fn(
        idx.mesh, idx.axis, n_leaves=idx.n_leaves, leaf_kind=st["leaf_kind"],
        iters=st["iters"], use_kernel=False, interpret=None)
    tables = (st["root"], st["leaves"], st["err_lo"], st["err_hi"])
    rl, rr = fn(st["splits"], st["offs"], st["route_n"], st["base"],
                st["bdead"], st["bpsum"], st["dk"], st["ddead"], st["dpsum"],
                tables, jnp.concatenate([jnp.asarray(lo), jnp.asarray(hi)]))
    rl, rr = np.asarray(rl), np.asarray(rr)
    Q = lo.size
    out["recs"].append(dict(
        tag=tag, op=len(out["ops"]), q=q, found=np.asarray(f),
        rank=np.asarray(r), lo=lo, hi=hi, rank_lo=rl[:Q],
        rank_hi=np.maximum(rr[Q:], rl[:Q]), splits=splits(),
        counters={k: int(getattr(idx, k)) for k in COUNTERS},
        counts=np.asarray(idx._counts), muted=np.asarray(idx._muted),
        live=idx.live_keys(), iters=int(st["iters"])))

def op(kind, keys):
    global live
    keys = np.asarray(keys, np.float64)
    out["ops"].append((kind, keys))
    if kind == "insert":
        idx.insert_batch(keys)
        live = np.sort(np.concatenate([live, keys]))
    else:
        idx.delete_batch(keys)
        for k in np.unique(keys):
            i = np.searchsorted(live, k)
            if i < live.size and live[i] == k:
                live = np.delete(live, i)

rec("built")
# seam misses: queries in the gap between the cluster and the outliers
# route to empty leaves of the last shard, 1,536 of them in one call
gap = np.setdiff1d(f32draw(cluster[-1] * 2, 9e5, 1536), base)
gap = np.concatenate([gap, f32draw(cluster[-1] * 2, 9e5, 1536 - gap.size)])
rec("seam", rng.permutation(np.concatenate([gap, rng.choice(cluster, 512)])))
op("insert", np.concatenate([fresh[:1200], rng.choice(live, 64)]))
op("delete", np.concatenate([rng.choice(live, 400, replace=False),
                             fresh[-4:]]))
rec("churn")
# a skewed ingest at each end: shard 0 sheds its suffix to the right, the
# last shard its prefix to the left
sp = splits()
top = sp[0] if sp.size else float(np.median(live))
op("insert", np.setdiff1d(f32draw(live[0], top, int(0.8 * live.size)), live))
rec("skew low")
sp = splits()
bot = sp[-1] if sp.size else float(np.median(live))
op("insert", np.setdiff1d(f32draw(bot, live[-1], int(0.8 * live.size)),
                          live))
rec("skew high")
def shard_keys(s):
    sp = splits()
    lo_k = sp[s - 1] if s > 0 else -np.inf
    hi_k = sp[s] if s < sp.size else np.inf
    return live[(live > lo_k) & (live <= hi_k)]

# dead-hot: most live keys of a middle shard deleted (it rebuilds in place)
s = ndev // 2
mine = shard_keys(s)
for part in np.array_split(rng.permutation(mine)[:int(0.7 * mine.size)], 3):
    op("delete", part)
rec("dead hot")
# delta-hot: duplicates of twice the rebuilt shard's live keys, under every
# leaf's budget (4x at eps 0.2), so they stay in its delta tier (it flushes)
op("insert", rng.choice(shard_keys(s), 2 * shard_keys(s).size))
rec("delta hot")
# the last shard drained (it rebuilds empty), then a skewed ingest next to
# it: a migration into a receiver with no headroom rebuilds the receiver
for _ in range(8):
    mine = shard_keys(ndev - 1)
    if mine.size:
        op("delete", np.unique(mine))
if ndev >= 3:
    mine = shard_keys(ndev - 2)
    op("insert", np.setdiff1d(f32draw(mine[0], mine[-1], 3 * live.size),
                              live))
rec("drain and refill")
# a giant duplicate run at the start of a shard: its skew cannot move
sp = splits()
s = min(1, ndev - 1)
k0 = live[live > sp[s - 1]][0] if s > 0 else live[0]
op("insert", np.full(int(1.5 * live.size), k0))
rec("giant run")
out["final"] = export_sharded(idx)
with open(%(out)r, "wb") as fh:
    pickle.dump(out, fh)
print("SHARDED_REF_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """{n_shards: the reference's batches and answers}, the three mesh
    sizes run together."""
    tmp = tmp_path_factory.mktemp("sharded_ref")
    env = dict(os.environ, PYTHONPATH="src")
    env.pop("XLA_FLAGS", None)
    tests = os.path.dirname(os.path.abspath(__file__))
    procs = {}
    for n in MESHES:
        path = str(tmp / f"ref{n}.pkl")
        script = _SCRIPT % {"ndev": n, "out": path, "tests": tests}
        procs[n] = (subprocess.Popen(
            [sys.executable, "-c", script], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
            cwd=os.path.dirname(tests)), path)
    out = {}
    for n, (proc, path) in procs.items():
        so, se = proc.communicate(timeout=600)
        assert proc.returncode == 0 and "SHARDED_REF_OK" in so, se[-4000:]
        with open(path, "rb") as fh:
            out[n] = pickle.load(fh)
    return out


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _eq(got, want, what):
    np.testing.assert_array_equal(_np(got), np.asarray(want), err_msg=what)


@pytest.mark.parametrize("n", MESHES)
def test_shard_bounds_and_splits(ref, n):
    """Bounds and splits over lognormal, duplicate-heavy and
    all-empty-prefix keys, from numpy and from a tensor."""
    for name in ("lognormal", "dup", "prefix"):
        keys, b, sp = ref[n]["part_" + name]
        for k in (keys, torch.as_tensor(keys)):
            bb = D.shard_bounds(k, n)
            _eq(bb, b, f"bounds {name}")
            _eq(D._splits_from_bounds(k, bb), sp, f"splits {name}")
    if n > 1:       # a run longer than a balanced shard: an empty prefix
        assert np.isneginf(ref[n]["part_prefix"][2]).all()


def _static_case(ref, n, positions):
    """``make_lookup_fn`` ranks of an index built on ``positions`` and of
    the reference's state converted onto them, on both paths, with the
    budget off, at 2.0 and at 1.0, against the reference's; returns the
    ranks by (factor, path)."""
    keys, q, want, arrays = ref[n]["static"]
    mesh = cpu_mesh(n, positions)
    si = D.build_sharded(keys, mesh, n_leaves=64, device="cpu")
    conv = convert.sharded_index_from_arrays(arrays, device="cpu",
                                             mesh=mesh)
    assert len(si.parts) == len(conv.parts) == (positions or 1)
    _eq(si.keys, arrays["keys"], "stacked keys")
    _eq(si.splits, arrays["splits"], "splits")
    out = {}
    for cf, r in want.items():
        for index in (si, conv):
            for path in PATHS:
                got = D.make_lookup_fn(index, capacity_factor=cf,
                                       path=path)(q)
                _eq(got, r, f"cf={cf} {path}")
                out[cf, path] = got
    return out


@pytest.mark.parametrize("n", MESHES)
def test_make_lookup_fn_equals_reference(ref, n):
    """Global ranks of ``make_lookup_fn`` on both paths, with the budget
    off, at 2.0 and at 1.0, equal the reference's, -1s included; the
    answered ones equal the truth; a converted reference index answers the
    same."""
    keys, q, want, arrays = ref[n]["static"]
    _static_case(ref, n, None)
    cap = arrays["keys"].shape[1]
    dest = np.searchsorted(arrays["splits"], q)
    truth = np.asarray([min(np.searchsorted(arrays["keys"][d], x),
                            arrays["valid"][d]) for d, x in zip(dest, q)])
    truth += dest * cap
    for cf, r in want.items():
        kept = r >= 0
        _eq(r[kept], truth[kept], f"cf={cf} truth")
        if cf is None or cf >= n:       # C = B * cf / n slots: none drop
            assert kept.all()
    assert (want[1.0] < 0).any() or n == 1


@pytest.mark.parametrize("n,positions", POSITIONED)
def test_make_lookup_fn_on_positions(ref, n, positions):
    """On a mesh of ``positions`` CPU positions, built and converted, the
    ranks equal the reference's (the budget's -1s included) and the
    one-stack index's bit for bit, on both paths."""
    want = _static_case(ref, n, None)
    for k, got in _static_case(ref, n, positions).items():
        _eq(got, want[k], f"{k} vs one stack")


def _replay(r, paths=PATHS, positions=None):
    """Run the reference's operations on the port (CPU), on a mesh of
    ``positions`` CPU positions (None: one stack); returns the index and,
    per record, {path: (found, rank, rank_lo, rank_hi)} and the counters,
    splits, mutes, counter table and live keys, read where the reference
    read them."""
    base = r["static"][0]
    n = len(r["final"]["shards"])
    idx = D.ShardedDynamicIndex.build(base, cpu_mesh(n, positions),
                                      n_leaves=32, eps=r["final"]["eps"],
                                      device="cpu")
    recs = []
    ops_ = r["ops"]
    done = 0
    for want in r["recs"]:
        for kind, keys in ops_[done:want["op"]]:
            (idx.insert_batch if kind == "insert" else idx.delete_batch)(keys)
        done = want["op"]
        got = {}
        for path in paths:
            f, rk = idx.find(want["q"], path=path)
            rl, rh = idx.find_range(want["lo"], want["hi"], path=path)
            got[path] = (f, rk, rl, rh)
        recs.append(dict(
            answers=got, splits=idx.splits.copy(),
            counters={k: int(getattr(idx, k)) for k in want["counters"]},
            counts=_np(idx._counts), muted=_np(idx._muted),
            live=idx.live_keys(), iters=idx._stack["iters"]))
    return idx, recs


@pytest.fixture(scope="module")
def replayed(ref):
    return {n: _replay(ref[n]) for n in MESHES}


@pytest.fixture(scope="module")
def replayed_on(ref):
    """The replays on CPU positions, by (shards, positions)."""
    return {(n, p): _replay(ref[n], positions=p) for n, p in POSITIONED}


def _answers_equal_reference(ref, recs, n):
    for want, got in zip(ref[n]["recs"], recs, strict=True):
        tag = want["tag"]
        live = want["live"]
        q = want["q"]
        fin = q < np.inf
        t_rank = np.where(fin, np.searchsorted(live, q), 0)
        t_found = fin & (np.searchsorted(live, q, side="right")
                         > np.searchsorted(live, q))
        _eq(want["rank"], t_rank, f"{tag}: reference rank vs truth")
        t_lo = np.where(want["lo"] < np.inf,
                        np.searchsorted(live, want["lo"]), 0)
        t_hi = np.where(want["hi"] < np.inf,
                        np.searchsorted(live, want["hi"], side="right"), 0)
        for path, (f, rk, rl, rh) in got["answers"].items():
            _eq(f, want["found"], f"{tag} {path} found")
            _eq(f, t_found, f"{tag} {path} found vs truth")
            _eq(rk, want["rank"], f"{tag} {path} rank")
            _eq(rl, want["rank_lo"], f"{tag} {path} rank_lo")
            _eq(rh, want["rank_hi"], f"{tag} {path} rank_hi")
            _eq(rl, t_lo, f"{tag} {path} rank_lo vs truth")
            _eq(rh, np.maximum(t_hi, t_lo), f"{tag} {path} rank_hi truth")


@pytest.mark.parametrize("n", MESHES)
def test_find_and_range_equal_reference(ref, replayed, n):
    """(found, rank) and (rank_lo, rank_hi) after every step, on both
    paths, equal the reference's and the truth over ``live_keys()``."""
    _answers_equal_reference(ref, replayed[n][1], n)


@pytest.mark.parametrize("n,positions", POSITIONED)
def test_find_and_range_on_positions(ref, replayed, replayed_on, n,
                                     positions):
    """On CPU positions, every step's answers on both paths equal the
    reference's, the truth and the one-stack replay's bit for bit."""
    recs = replayed_on[n, positions][1]
    _answers_equal_reference(ref, recs, n)
    for one, got in zip(replayed[n][1], recs, strict=True):
        for path, ans in got["answers"].items():
            for a, b in zip(ans, one["answers"][path], strict=True):
                assert torch.equal(a, b), path


def _state_equals_reference(ref, recs, n):
    for want, got in zip(ref[n]["recs"], recs, strict=True):
        tag = want["tag"]
        assert got["counters"] == want["counters"], tag
        _eq(got["splits"], want["splits"], f"{tag} splits")
        _eq(got["counts"], want["counts"], f"{tag} counts")
        _eq(got["muted"], want["muted"], f"{tag} muted")
        _eq(got["live"], want["live"], f"{tag} live keys")
        assert got["iters"] == want["iters"], tag


@pytest.mark.parametrize("n", MESHES)
def test_maintenance_state_equals_reference(ref, replayed, n):
    """Counters, splits, the counter table, the mutes, the stack's search
    depth and the live keys after every step equal the reference's; the
    churn ran the paths it was drawn to run."""
    _state_equals_reference(ref, replayed[n][1], n)
    last = ref[n]["recs"][-1]
    c = last["counters"]
    if n == 4:
        assert c["migrations_incremental"] >= 2, c
        assert (last["muted"] >= 0).any()
    if n > 1:
        assert c["rebalances"] >= 2 and c["restack_rows"] > 0, c


def _warm_equals_cold(idx):
    """The stack maintained row by row equals a cold assembly of the same
    state bit for bit, kernel tables included, and a row restack writes
    each position's stacked tensors in place."""
    idx.find(np.zeros(4), path="kernel")
    warm = idx._stack
    ptrs = {k: v.data_ptr() for k, v in stack_tensors(warm).items()
            if k not in HOME_KEYS}
    idx.insert_batch(idx.live_keys()[:3])
    idx.find(np.zeros(4), path="kernel")
    if idx._stack is warm or idx._stack["bcap"] == warm["bcap"]:
        now = stack_tensors(idx._stack)
        for k, p in ptrs.items():
            assert now[k].data_ptr() == p, k
    warm = idx._stack
    idx._stack = None
    idx._dirty.clear()
    cold = idx._stacked()
    idx._packed_stack(cold)
    assert stack_scalars(warm) == stack_scalars(cold)
    wt, ct = stack_tensors(warm), stack_tensors(cold)
    assert wt.keys() == ct.keys()
    for k in wt:
        if "tabs" not in k:
            _eq(wt[k], ct[k], k)


@pytest.mark.parametrize("n", MESHES)
def test_warm_stack_equals_cold(replayed, n):
    """The stack maintained row by row equals a cold assembly of the same
    state bit for bit, kernel tables included, and a row restack writes
    the stacked tensors in place."""
    _warm_equals_cold(replayed[n][0])


@pytest.mark.parametrize("n,positions", POSITIONED)
def test_maintenance_state_on_positions(ref, replayed_on, n, positions):
    """On CPU positions, the counters, splits, counter table, mutes, depth
    and live keys after every step equal the reference's (and so the one
    stack's); each shard lies on its position's device, and the stack has
    one part a position."""
    idx, recs = replayed_on[n, positions]
    _state_equals_reference(ref, recs, n)
    k = n // positions
    assert idx.positions == (torch.device("cpu"),) * positions
    for s, d in enumerate(idx.shards):
        assert d.device == idx.positions[s // k] == idx.shard_device(s)
    assert [(p["lo"], p["n"]) for p in idx._stack["parts"]] == \
        [(p * k, k) for p in range(positions)]


@pytest.mark.parametrize("n,positions", POSITIONED)
def test_warm_stack_equals_cold_on_positions(replayed_on, n, positions):
    """On CPU positions, the row-maintained stack equals a cold one bit for
    bit, each position's tensors rewritten in place."""
    _warm_equals_cold(replayed_on[n, positions][0])


def _converted_answers(ref, n, positions):
    r = ref[n]
    idx = convert.sharded_from_arrays(r["final"], device="cpu",
                                      mesh=cpu_mesh(n, positions))
    want = r["recs"][-1]
    assert {k: int(getattr(idx, k)) for k in want["counters"]} \
        == want["counters"]
    _eq(idx.live_keys(), want["live"], "live keys")
    _eq(idx._muted, want["muted"], "muted")
    for path in PATHS:
        f, rk = idx.find(want["q"], path=path)
        _eq(f, want["found"], f"{path} found")
        _eq(rk, want["rank"], f"{path} rank")
        rl, rh = idx.find_range(want["lo"], want["hi"], path=path)
        _eq(rl, want["rank_lo"], f"{path} rank_lo")
        _eq(rh, want["rank_hi"], f"{path} rank_hi")


@pytest.mark.parametrize("n", MESHES)
def test_converted_reference_state_answers_the_same(ref, replayed, n):
    """The reference's final state carried across by
    ``convert.sharded_from_arrays`` answers the last record's batches as the
    reference did, and holds its counters and live keys."""
    _converted_answers(ref, n, None)


@pytest.mark.parametrize("n,positions", POSITIONED)
def test_converted_reference_state_on_positions(ref, n, positions):
    """The reference's final state converted onto CPU positions answers as
    the reference did."""
    _converted_answers(ref, n, positions)


@pytest.mark.parametrize("n", MESHES)
def test_seam_misses_past_the_budget_in_one_shard(ref, n):
    """The "seam" batch: queries in the gap between the key cluster and the
    outliers route to empty leaves of the last shard and miss their
    windows by the thousand, past the 1,024 misses the reference's seam fix
    takes one by one in a call, while the other shards' queries do not
    miss; the port re-searches every miss in its own row, and both paths
    equal the reference (``test_find_and_range_equal_reference``)."""
    _seam_case(ref, n, None)


@pytest.mark.parametrize("n,positions", POSITIONED)
def test_seam_misses_on_positions(ref, n, positions):
    """The "seam" batch on CPU positions: the misses all in the last
    position's last shard, every one re-searched in its own row; one
    verification a position that holds queries."""
    _seam_case(ref, n, positions)
    assert ops.SEAM["calls"] <= positions


def _seam_case(ref, n, positions):
    r = ref[n]
    (want,) = [w for w in r["recs"] if w["tag"] == "seam"]
    idx = D.ShardedDynamicIndex.build(r["static"][0],
                                      cpu_mesh(n, positions),
                                      n_leaves=32, eps=r["final"]["eps"],
                                      device="cpu")
    q = want["q"]
    keys = r["static"][0]
    gap = q > keys[keys < 1e6][-1]
    dest = np.searchsorted(idx.splits, q)
    assert np.unique(dest[gap]).tolist() == [n - 1]
    ops.reset_seam()
    f, rk = idx.find(q, path="kernel")
    _eq(f, want["found"], "found")
    _eq(rk, want["rank"], "rank")
    assert ops.SEAM["misses"] > 1024, ops.SEAM
    ops.reset_seam()
    idx.find(q[~gap], path="kernel")
    assert ops.SEAM["misses"] < 1024, ops.SEAM


def test_any_batch_size_and_empty_batches():
    """The port takes batches of any size (the reference's sharded find
    slices a sharded output and needs a multiple of the shard count on
    more than one device), and empty ones."""
    rng = np.random.default_rng(5)
    keys = np.unique(rng.lognormal(0, 1, 3000).astype(np.float32)) \
        .astype(np.float64)
    idx = D.ShardedDynamicIndex.build(keys, D.ShardMesh(3), n_leaves=16,
                                      device="cpu")
    q = np.concatenate([rng.choice(keys, 500), [np.nan, np.inf, -np.inf]])
    for path in PATHS:
        f, r = idx.find(q, path=path)
        _eq(r, np.where(q < np.inf, np.searchsorted(keys, q), 0), path)
        _eq(f, np.isin(q, keys), path)
        f, r = idx.find(q[:0], path=path)
        assert f.shape == r.shape == (0,)
        rl, rh = idx.find_range(q[:0], q[:0], path=path)
        assert rl.shape == rh.shape == (0,)
    lo = np.sort(rng.choice(keys, 50))
    rl, rh = idx.find_range(lo, lo * 1.5)
    for got, a, b in zip(idx.gather_range(rl, rh), lo, lo * 1.5,
                         strict=True):
        _eq(got, keys[(keys >= a) & (keys <= b)], "gather_range")
    si = D.build_sharded(keys, D.ShardMesh(3), n_leaves=16, device="cpu")
    assert D.make_lookup_fn(si)(q[:0]).shape == (0,)
    with pytest.raises(ValueError, match="origin blocks"):
        D.make_lookup_fn(si, capacity_factor=2.0)(q[:7])


# ---------------------------------------------------------------------------
# The shard-stacked K1-K3 walked lane by lane (csrc/lookup.cu, section
# "Shard-stacked K1-K3"): each lane reads its shard's descriptor, then runs
# the single-index item body on it; a warp leaves its loop once no lane has
# a live chain, whatever shards its lanes belong to.
# ---------------------------------------------------------------------------
_WARP = 32
_INF = np.float32(np.inf)


def _lanes(nq):
    """(lane count padded to whole warps, valid mask)."""
    m = -(-max(nq, 1) // _WARP) * _WARP
    return m, np.arange(m) < nq


def _trip(chain, flat, off, n, a8, q, right, sectors):
    """One ``issue`` + ``retire`` of every lane's chain over its own row
    ``flat[off:off + n]`` (``a8``: the row's offset in its 32-byte
    sector); fails on any load outside the lane's row."""
    l, h, r = chain
    live = (r > 0) & (h > l)
    sb = l - ((a8 + l) & 7)
    sector = live & (h - l <= 8) & (((a8 + l) >> 3) == ((a8 + h - 1) >> 3))
    sector &= sectors & (sb >= 0) & (sb + 8 <= n)
    binary = live & ~sector
    below = lambda kv: np.where(right, kv <= q, kv < q)
    mid = (l + h) >> 1
    inside = mid < n
    kv = np.where(inside, flat[off + np.clip(mid, 0, n - 1)], _INF)
    b = below(kv)
    l = np.where(binary & b, mid + 1, l)
    h = np.where(binary & ~b, mid, h)
    r = np.where(binary, r - 1, r)
    pos = sb[:, None] + np.arange(8)
    assert ((pos >= 0) & (pos < n[:, None]))[sector].all()
    vals = flat[off[:, None] + np.clip(pos, 0, n[:, None] - 1)]
    for _ in range(4):
        go = sector & (r > 0) & (h > l)
        mid = (l + h) >> 1
        kv = vals[np.arange(l.shape[0]), np.clip(mid - sb, 0, 7)]
        bb = below(kv)
        l = np.where(go & bb, mid + 1, l)
        h = np.where(go & ~bb, mid, h)
        r = np.where(go, r - 1, r)
    return l, h, r


class _Stack:
    """S shards' tables stacked as the index stacks them -- each shard's
    routing scale folded into its root, so all route at ``n_leaves``, and
    one search depth, the deepest shard's -- the keys and the delta tiers
    laid out in one flat buffer each, rows ``pad`` floats apart past a
    start ``lead`` floats into a 32-byte sector."""

    def __init__(self, parts, deltas, *, n_leaves, lead=0, pad=0):
        from repro_torch.core import rmi as trmi
        self.S = len(parts)
        self.n = max(max(p.size for p in parts), 1) + pad
        self.nd = max(max(d.size for d in deltas), 1)
        self.nd = -(-self.nd // 128) * 128
        self.n_leaves = n_leaves
        roots, mats, vecs, iters = [], [], [], []
        for p in parts:
            ix = trmi.build_rmi(torch.as_tensor(p), n_leaves=n_leaves,
                                device="cpu")
            _, m, v = ix.packed_tables()
            roots.append(tlk.pack_root(ix.root_kind, ix.root,
                                       route_scale=n_leaves / max(p.size, 1)))
            mats.append(m)
            vecs.append(v)
            iters.append(ix.search_iters)
        self.roots, self.mats, self.vecs = (torch.stack(roots),
                                            torch.stack(mats),
                                            torch.stack(vecs))
        self.route_n, self.iters = n_leaves, max(iters)
        buf = np.full(lead + self.S * self.n, _INF, np.float32)
        dbuf = np.full(self.S * self.nd, _INF, np.float32)
        for s, (p, d) in enumerate(zip(parts, deltas, strict=True)):
            buf[lead + s * self.n:lead + s * self.n + p.size] = p
            dbuf[s * self.nd:s * self.nd + d.size] = np.sort(d)
        self.lead, self.buf, self.dbuf = lead, buf, dbuf
        self.keys = torch.as_tensor(buf[lead:].reshape(self.S, self.n))
        self.dk = torch.as_tensor(dbuf.reshape(self.S, self.nd))

    def windows(self, q, shard, right=None):
        """(lo, hi) of each query on its shard's tables (stages 1-3)."""
        lo = np.zeros(q.shape, np.int64)
        hi = np.zeros(q.shape, np.int64)
        for s in range(self.S):
            m = shard == s
            if m.any():
                a, b = tlk.route_window(
                    torch.as_tensor(q[m]), self.roots[s], self.mats[s],
                    self.vecs[s], n_keys=self.n, n_leaves=self.n_leaves,
                    route_n=self.route_n)
                lo[m], hi[m] = a.numpy(), b.numpy()
        return lo, hi

    def endpoints(self, x, shard, right, valid, base_sectors):
        """The kernel's ``endpoint`` for every lane, each on its shard's
        rows: (base_pos, delta_pos, trips a warp took)."""
        sid = np.where(valid, shard, 0)
        lo, hi = self.windows(x, sid)
        lo, hi = np.where(valid, lo, 0), np.where(valid, hi, 0)
        iters = self.iters
        d_iters = tlk.full_iters(self.nd)
        n = np.full(x.shape, self.n)
        nd = np.full(x.shape, self.nd)
        off = self.lead + sid * self.n
        doff = sid * self.nd
        a8, da8 = off & 7, doff & 7
        b = (lo, hi, np.where(valid, iters, 0))
        d = (np.zeros_like(lo), np.where(valid, self.nd, 0),
             np.where(valid, d_iters, 0))
        trips = np.zeros(x.shape[0] // _WARP, np.int64)
        while True:
            live = ((b[2] > 0) & (b[1] > b[0])) | ((d[2] > 0) & (d[1] > d[0]))
            warp = live.reshape(-1, _WARP).any(1)
            if not warp.any():
                break
            trips += warp
            b = _trip(b, self.buf, off, n, a8, x, right, base_sectors)
            d = _trip(d, self.dbuf, doff, nd, da8, x, right, True)
        assert (trips <= max(self.iters, d_iters)).all()
        bpos = np.where(b[0] < hi, b[0], np.minimum(hi, self.n))
        return bpos, d[0], trips

    def k2(self, q, shard):
        m, valid = _lanes(q.size)
        x = np.zeros(m, np.float32)
        x[:q.size] = q
        s = np.zeros(m, np.int64)
        s[:q.size] = shard
        bpos, dpos, trips = self.endpoints(x, s, np.zeros(m, bool), valid,
                                           True)
        return bpos[:q.size], dpos[:q.size], trips

    def k3(self, qlo, qhi, shard):
        m, valid = _lanes(2 * qlo.size)
        j = np.arange(m)
        right = (j & 1).astype(bool)
        pair = np.minimum(j >> 1, max(qlo.size - 1, 0))
        x = np.where(right, qhi[pair], qlo[pair]).astype(np.float32)
        bpos, dpos, _ = self.endpoints(x, shard[pair], right, valid, False)
        k = 2 * qlo.size
        return (bpos[:k][0::2], bpos[:k][1::2], dpos[:k][0::2],
                dpos[:k][1::2])

    def plain(self):
        return (self.roots, self.mats, self.vecs, self.keys, self.dk)

    def to(self, device):
        """A copy with the stacked tables on ``device``."""
        out = copy.copy(self)
        for k in ("roots", "mats", "vecs", "keys", "dk"):
            setattr(out, k, getattr(self, k).to(device))
        return out


def _stack_case(seed, lead):
    """Three shards over disjoint key ranges with an empty one between them
    (its row all +inf), each with a delta tier, and queries grouped by
    shard, warps spanning shards, plus the same queries shuffled."""
    rng = np.random.default_rng(seed)
    f32 = lambda x: np.unique(np.asarray(x, np.float32))
    parts = [f32(rng.lognormal(0, 1, 700) + 1), np.zeros(0, np.float32),
             f32(rng.uniform(100, 200, 333)), f32(rng.uniform(300, 301, 90))]
    deltas = [f32(rng.lognormal(0, 1, 50) + 1), np.zeros(0, np.float32),
              f32(rng.uniform(100, 200, 300)), f32(rng.uniform(300, 301, 3))]
    st = _Stack(parts, deltas, n_leaves=8, lead=lead, pad=5)
    q, shard = [], []
    for s, (p, d) in enumerate(zip(parts, deltas, strict=True)):
        k = np.concatenate([p, d, [1.5, 150.0, 300.5, -1.0, 1e30]])
        m = 37 + 11 * s
        q.append(rng.choice(k, m).astype(np.float32))
        shard.append(np.full(m, s))
    q = np.concatenate(q + [np.asarray([0.0, -0.0, np.inf, -np.inf, np.nan],
                                       np.float32)])
    shard = np.concatenate(shard + [np.asarray([0, 1, 3, 0, 2])])
    return st, q, shard


@pytest.mark.parametrize("lead", (0, 3))
@pytest.mark.parametrize("grouped", (True, False))
def test_stacked_k2_k3_lane_walk(lead, grouped):
    """The emulated shard-stacked K2 and K3 -- descriptor selection, warps
    whose lanes span shards, an empty shard, rows starting inside a 32-byte
    sector -- equal the stacked plain versions and S single-index plain
    calls bit for bit."""
    st, q, shard = _stack_case(5 + lead, lead)
    if not grouped:
        perm = np.random.default_rng(1).permutation(q.size)
        q, shard = q[perm], shard[perm]
    # a warp holding lanes of several shards
    assert any(np.unique(shard[i:i + _WARP]).size > 1
               for i in range(0, q.size, _WARP))
    kw = dict(n_leaves=st.n_leaves, route_n=st.route_n, iters=st.iters)
    qt, sh = torch.as_tensor(q), torch.as_tensor(shard, dtype=torch.int32)
    bpos, dpos, _ = st.k2(q, shard)
    pb, pd = tlk.sharded_dynamic_lookup(qt, sh, *st.plain(), **kw)
    _eq(pb, bpos, "K2 base")
    _eq(pd, dpos, "K2 delta")
    for s in range(st.S):
        m = shard == s
        a, b = tlk.dynamic_lookup_plain(
            qt[m], st.roots[s], st.mats[s], st.vecs[s], st.keys[s], st.dk[s],
            n_leaves=st.n_leaves, route_n=st.route_n, iters=st.iters)
        _eq(a, bpos[m], f"K2 base shard {s}")
        _eq(b, dpos[m], f"K2 delta shard {s}")
    hi = np.maximum(q, q * np.float32(1.01))
    want = st.k3(q, hi, shard)
    got = tlk.sharded_dynamic_range(qt, torch.as_tensor(hi), sh, *st.plain(),
                                    **kw)
    for g, w, what in zip(got, want, ("blo", "bhi", "dlo", "dhi"),
                          strict=True):
        _eq(g, w, f"K3 {what}")
    # the empty shard answers position 0 in both tiers
    empty = (shard == 1) & (q < np.inf)
    assert (bpos[empty] == 0).all() and (dpos[empty] == 0).all()


def _leaf_search_rows(st, fences, x, sid, valid, lo, hi):
    """``leaf_search<true, false>`` (K1) for every lane on its shard's keys
    and fence."""
    iters = st.iters
    nf = fences.shape[1]
    fflat = fences.reshape(-1).numpy()
    n = np.full(x.shape, st.n)
    off = st.lead + sid * st.n
    foff = sid * nf
    width = hi - lo
    on = valid & ((iters >= 31) | ((iters > 0) & (width >= 0)
                                   & (width < (1 << np.maximum(iters, 0)))))
    jl = (lo + 63) >> 6
    jh = np.maximum(np.minimum((hi + 63) >> 6, nf), jl)
    chain = (np.where(on, jl, lo), np.where(on, jh, hi),
             np.where(on, 32, np.where(valid, iters, 0)))
    while True:
        l, h, r = chain
        live = (r > 0) & (h > l)
        if not (live | on).reshape(-1, _WARP).any(1).any():
            break
        turn = on & ~live
        j = l
        chain = (np.where(turn, np.where(j > jl, ((j - 1) << 6) + 1, lo), l),
                 np.where(turn, np.where(j < jh, j << 6, hi), h),
                 np.where(turn, 32, r))
        on = on & ~turn
        fen = _trip(chain, fflat, foff, np.full(x.shape, nf), foff & 7, x,
                    False, False)
        key = _trip(chain, st.buf, off, n, off & 7, x, False, False)
        chain = tuple(np.where(on, a, b)
                      for a, b in zip(fen, key, strict=True))
    l = chain[0]
    return np.where(l < hi, l, np.minimum(hi, st.n))


@pytest.mark.parametrize("lead", (0, 3))
def test_stacked_k1_lane_walk(lead):
    """The emulated shard-stacked K1 -- each lane's leaf row, fence and
    keys from its descriptor, the fence then a 64-key interval on windows
    the depth converges -- equals the stacked plain version and S
    single-index plain calls bit for bit, ungrouped queries included."""
    st, q, shard = _stack_case(9 + lead, lead)
    perm = np.random.default_rng(2).permutation(q.size)
    q, shard = np.concatenate([q, q[perm]]), np.concatenate([shard,
                                                             shard[perm]])
    m, valid = _lanes(q.size)
    x = np.zeros(m, np.float32)
    x[:q.size] = q
    sid = np.zeros(m, np.int64)
    sid[:q.size] = shard
    sid = np.where(valid, sid, 0)
    lo, hi = st.windows(x, sid)
    fences = tlk.stacked_fences(st.keys)
    pos = _leaf_search_rows(st, fences, x, sid, valid,
                            np.where(valid, lo, 0), np.where(valid, hi, 0))
    pos = pos[:q.size]
    kw = dict(n_leaves=st.n_leaves, route_n=st.route_n, iters=st.iters)
    qt, sh = torch.as_tensor(q), torch.as_tensor(shard, dtype=torch.int32)
    _eq(tlk.sharded_lookup(qt, sh, *st.plain()[:4], **kw), pos, "K1")
    for s in range(st.S):
        mm = shard == s
        got = tlk.lookup_plain(qt[mm], st.roots[s], st.mats[s], st.vecs[s],
                               st.keys[s], n_leaves=st.n_leaves,
                               route_n=st.route_n, iters=st.iters)
        _eq(got, pos[mm], f"K1 shard {s}")


def _unknown_id_calls(st, q, shard, bad):
    """Each stacked entry on ``shard`` and on ``shard`` with one id made
    ``bad`` (-1 or S): [(entry, outputs, outputs with the bad id)]."""
    wrong = shard.copy()
    wrong[q.size // 2] = st.S if bad == "S" else bad
    dev = st.keys.device
    qt = torch.as_tensor(q).to(dev)
    kw = dict(n_leaves=st.n_leaves, route_n=st.route_n, iters=st.iters)
    tabs = st.plain()[:4]
    out = []
    for name, fn, lead, extra in (
            ("k1", tlk.sharded_lookup, (qt,), ()),
            ("k1 plain", tlk.sharded_lookup_plain, (qt,), ()),
            ("k2", tlk.sharded_dynamic_lookup, (qt,), (st.dk,)),
            ("k2 plain", tlk.sharded_dynamic_lookup_plain, (qt,), (st.dk,)),
            ("k3", tlk.sharded_dynamic_range, (qt, qt), (st.dk,)),
            ("k3 plain", tlk.sharded_dynamic_range_plain, (qt, qt),
             (st.dk,))):
        got = [fn(*lead, torch.as_tensor(sh, dtype=torch.int32).to(dev),
                  *tabs, *extra, **kw) for sh in (shard, wrong)]
        out.append((name, *(g if isinstance(g, tuple) else (g,)
                            for g in got)))
    return out


@pytest.mark.parametrize("bad", (-1, "S"))
def test_stacked_entries_answer_unknown_shard_ids_minus_one(bad):
    """A query whose shard id lies outside [0, S) reads no tables and
    answers -1 in every output (the kernels check the id against the
    descriptor count, the plain versions loop over [0, S)); every other
    query's answer is unchanged."""
    st, q, shard = _stack_case(17, 0)
    i = q.size // 2
    for name, good, got in _unknown_id_calls(st, q, shard, bad):
        for g, w in zip(got, good, strict=True):
            assert int(g[i]) == -1, name
            keep = torch.arange(q.size) != i
            assert torch.equal(g[keep], w[keep]), name


def test_stacked_epilogues_confine_searches_to_rows():
    """The shard-stacked find and range epilogues (seam fix, run ends)
    search only each query's own row: with iters cut to 0 every query
    misses and is re-searched, and every answer still equals a searchsorted
    over its own shard's tiers; the scatter back to the queries' order
    holds on the index path."""
    st, q, shard = _stack_case(13, 0)
    S = st.S
    bp = torch.zeros((S, st.n + 1), dtype=torch.int32)
    dp = torch.zeros((S, st.nd + 1), dtype=torch.int32)
    qt, sh = torch.as_tensor(q), torch.as_tensor(shard, dtype=torch.int32)
    ops.reset_seam()
    f, r = ops.sharded_dynamic_find(
        qt, sh, *st.plain()[:4], bp, st.dk, dp, n_leaves=st.n_leaves,
        route_n=st.route_n, iters=0)
    assert ops.SEAM["misses"] > 0
    rl, rh = ops.sharded_range_lookup(
        qt, qt, sh, *st.plain()[:4], bp, st.dk, dp, n_leaves=st.n_leaves,
        route_n=st.route_n, iters=0)
    for s in range(S):
        m = (shard == s) & ~np.isnan(q)     # NaN: not live on the index
        k, d = st.keys[s], st.dk[s]
        qs = qt[m]
        want = torch.searchsorted(k, qs) + torch.searchsorted(d, qs)
        wr = torch.searchsorted(k, qs, right=True) \
            + torch.searchsorted(d, qs, right=True)
        _eq(r[m], want, f"rank shard {s}")
        _eq(f[m], wr > want, f"found shard {s}")
        _eq(rl[m], want, f"rank_lo shard {s}")
        _eq(rh[m], wr, f"rank_hi shard {s}")


@pytest.mark.gpu
def test_stacked_kernels_on_the_card():
    """On the card: the shard-stacked K1-K3 equal their plain versions and
    S single-index launches bit for bit (rows starting inside a 32-byte
    sector, an empty shard, warps spanning shards), one launch a call; the
    sharded index's answers on the card equal the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for lead in (0, 3):
        st, q, shard = _stack_case(21 + lead, lead)
        flat = torch.as_tensor(st.buf).cuda()
        keys = flat[lead:].view(st.S, st.n)
        dk = st.dk.cuda()
        tabs = (st.roots.cuda(), st.mats.cuda(), st.vecs.cuda(), keys)
        qt = torch.as_tensor(q).cuda()
        hi = torch.maximum(qt, qt * 1.01)
        sh = torch.as_tensor(shard, dtype=torch.int32).cuda()
        kw = dict(n_leaves=st.n_leaves, route_n=st.route_n, iters=st.iters)
        before = dict(tlk.LAUNCHES)
        got = [(tlk.sharded_lookup(qt, sh, *tabs, **kw),),
               tlk.sharded_dynamic_lookup(qt, sh, *tabs, dk, **kw),
               tlk.sharded_dynamic_range(qt, hi, sh, *tabs, dk, **kw)]
        for k in ("sharded_lookup", "sharded_dynamic_lookup",
                  "sharded_dynamic_range"):
            assert tlk.LAUNCHES[k] == before[k] + 1, k
        want = [(tlk.sharded_lookup_plain(qt, sh, *tabs, **kw),),
                tlk.sharded_dynamic_lookup_plain(qt, sh, *tabs, dk, **kw),
                tlk.sharded_dynamic_range_plain(qt, hi, sh, *tabs, dk,
                                                **kw)]
        for g, w in zip(got, want, strict=True):
            for a, b in zip(g, w, strict=True):
                assert torch.equal(a, b)
        # an unknown shard id answers -1 on the card as in the plain version
        cst = st.to("cuda")
        for bad in (-1, "S"):
            calls = _unknown_id_calls(cst, q, shard, bad)
            for (_, good, got), (_, pgood, pgot) in zip(
                    calls[0::2], calls[1::2], strict=True):
                for a, b in zip(good + got, pgood + pgot, strict=True):
                    assert torch.equal(a, b)
    rng = np.random.default_rng(4)
    keys = np.unique(rng.lognormal(0, 1, 20000).astype(np.float32)) \
        .astype(np.float64)
    q = np.concatenate([rng.choice(keys, 3000), [np.inf, np.nan, -np.inf]])
    ins = (rng.choice(keys, 500) * 1.001).astype(np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        idx = D.ShardedDynamicIndex.build(keys, D.ShardMesh(4), n_leaves=64,
                                          device=dev)
        idx.insert_batch(ins)
        out[dev] = [_np(t) for t in idx.find(q, path="kernel")
                    + idx.find_range(q, q * 1.01, path="kernel")]
        si = D.build_sharded(keys, D.ShardMesh(4), n_leaves=64, device=dev)
        out[dev].append(_np(D.make_lookup_fn(si, path="kernel")(q)))
    for a, b in zip(out["cpu"], out["cuda"], strict=True):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("side", ("suffix", "prefix"))
def test_shed_equals_reference(side):
    """``DynamicRMI.shed_suffix`` / ``shed_prefix`` against the reference's
    from one carried-across state with tombstones and duplicates in both
    tiers, at cuts below, inside and above the keys (a cut at the end of a
    duplicate run included): both tiers, tombstones, prefix sums,
    counters, leaf intercepts and answers bit for bit."""
    import jax.numpy as jnp
    import repro  # noqa: F401  (x64)
    from repro.core.updates import DynamicRMI as JDynamicRMI
    from torch_export import export_dynamic
    rng = np.random.default_rng(17)
    keys = np.sort(np.repeat(np.unique(rng.lognormal(0, 1, 900).astype(
        np.float32)), rng.integers(1, 3, 1))).astype(np.float64)
    keys = np.sort(np.concatenate([keys, np.repeat(keys[400], 5)]))
    j = JDynamicRMI.build(jnp.asarray(keys), n_leaves=16, eps=0.5)
    ins = np.sort(rng.choice(keys, 120) * np.float32(1.0001)).astype(
        np.float32).astype(np.float64)
    j.insert_batch(jnp.asarray(ins))
    t = convert.dynamic_from_arrays(export_dynamic(j), device="cpu")
    dels = np.concatenate([rng.choice(keys, 60), ins[:20], keys[400:402]])
    j.delete_batch(jnp.asarray(dels))
    t.delete_batch(dels)
    q = np.concatenate([keys[::7], ins, [keys[0] - 1, keys[-1] + 1]])
    for cut in (keys[0] - 1.0, keys[200], keys[400], ins[50],
                keys[-1] + 1.0):
        a, b = j.clone(), t.clone()
        getattr(a, "shed_" + side)(float(cut))
        getattr(b, "shed_" + side)(float(cut))
        for name in ("base_n", "base_dead_count", "delta_live",
                     "delta_dead_count"):
            assert getattr(a, name) == getattr(b, name), (cut, name)
        for name in ("base_dead", "base_psum", "delta_keys", "delta_leaf",
                     "delta_dead", "delta_psum"):
            _eq(getattr(b, name), np.asarray(getattr(a, name)),
                f"{side} at {cut}: {name}")
        _eq(b.index.keys, np.asarray(a.index.keys), f"{side} keys")
        _eq(b.index.leaves.b, np.asarray(a.index.leaves.b), f"{side} b")
        _eq(b.live_keys(), a.live_keys(), f"{side} live")
        fa, ra = a.find(jnp.asarray(q), path="jnp")
        for path in PATHS:
            fb, rb = b.find(q, path=path)
            _eq(fb, np.asarray(fa), f"{side} at {cut} found {path}")
            _eq(rb, np.asarray(ra), f"{side} at {cut} rank {path}")
