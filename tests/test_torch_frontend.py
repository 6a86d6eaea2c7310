"""The port's batching serve front-end (``repro_torch.serve.frontend``) and
its tenant-stacked answers (``core.distributed.tenant_stacked_answer``)
against the reference's (``repro.serve.frontend``).

* ``AdaptiveBatcher`` and ``Request``, in process: the same offers at the
  same fake-clock times give the same ``ready``, ``deadline`` and cut
  sizes in both packages, and both reject the same payloads (every kind
  with NaN, +inf or -inf, an unknown kind, unpaired range endpoints).
* ``TenantPack`` on one shard, in process: the reference's ``path="jnp"``
  pack runs on a one-device mesh, and the port's pack on both of its paths
  (the f64 path, and the kernel path, whose shard-stacked kernels take
  their plain versions on the CPU) must give the same found, rank, rank_lo
  and rank_hi matrices bit for bit -- members, misses, pads and queries
  beside leaf edges -- built, after inserts and deletes, and across a
  cross-tenant capacity-class crossing, with the same ``pack_rows`` and
  ``pack_full``.
* ``TenantPack`` on 2 and 4 shards: the reference's multi-device
  ``TenantPack`` fails on jax 0.9 in ``find_range``, which slices a
  sharded output (``ShardingTypeError``; ``tests/test_serve.py::
  test_serve_mesh_{2,4}dev``, ROADMAP queue 3), but its ``find`` and its
  ``_tenant_stacked_range_fn`` called directly run there (a probe on 2
  devices).  So one reference subprocess of 4 devices (a 2-device
  sub-mesh and the whole) answers through those two, started when this
  module starts and read at its end; the port's pack must equal it bit
  for bit, each tenant's own ``find`` / ``find_range`` (which
  ``test_torch_sharded.py`` holds against the reference) and the
  searchsorted truth.  Again with the tenants on CPU mesh positions (2
  shards on 2, 4 on 4, 4 on 2), which must also equal the one-stack pack.
* One stacked call a batch over all tenants, whatever the live batch size
  (1 to 256): ``TENANT_CALLS`` and the calls of the shard-stacked K2 / K3
  wrappers.
* ``BatchingFrontend`` end to end against the truth, following the
  reference's tests: finds interleaved with updates (a stale pack row would
  miss the inserted keys), capacity classes {128, 256} and
  ``pad_fraction``, ranges, one batch mixing every kind, a range request
  that deletes nothing, a failing request that fails only its batch, an
  idle-window pass that raises while the loop serves on, a key past f32
  refused on the kernel path and answered on the f64 one, the idle-window
  ``_maintain`` on a pooled drift tenant that swaps while the answers stay
  exact; eight caller threads at once; and
  ``examples/index_service_torch.py`` at a reduced size.
* On a card (``gpu`` marker): the pack's answers on the card equal the
  CPU's, one launch of the stacked K2 / K3 a batch.

The reference is imported inside fixtures only, so that the ``gpu`` test
runs where JAX is absent.
"""
from __future__ import annotations

import os
import pickle
import runpy
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from repro_torch.core import distributed as D
from repro_torch.core import reuse as treuse
from repro_torch.core import synth as tsynth
from repro_torch.kernels import lookup as tlk
from repro_torch.kernels.lookup import capacity_class
from repro_torch.serve import frontend as F
from torch_mesh import HOME_KEYS, cpu_mesh, stack_tensors

PATHS = ("jnp", "kernel")
SIZES = ((4000, 64), (900, 16))      # the reference's _build_tenants
BUDGET = 1e-3


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    import repro  # noqa: F401  (enables x64 for the reference)
    from repro.core import distributed as rdist
    from repro.serve import frontend as rfe
    return types.SimpleNamespace(jax=jax, jnp=jnp, dist=rdist, fe=rfe)


def _f32keys(raw):
    return np.unique(np.sort(raw).astype(np.float32)).astype(np.float64)


def _spec(seed: int, sizes=SIZES):
    """Two tenants' (base keys, leaves, fresh keys), as the reference's
    ``_build_tenants`` draws them."""
    rng = np.random.default_rng(seed)
    out = []
    for i, (n, nl) in enumerate(sizes):
        pool = _f32keys(rng.lognormal(0, 0.8, n * 8) * 1e3 + i * 1e7)
        base = np.sort(rng.choice(pool, n, replace=False))
        out.append((base, nl, np.setdiff1d(pool, base)))
    return out


def _tenants(spec, n_shards: int = 1, device="cpu", positions=None, **kw):
    mesh = cpu_mesh(n_shards, positions)
    return [D.ShardedDynamicIndex.build(base, mesh, n_leaves=nl, eps=0.7,
                                        device=device, **kw)
            for base, nl, _ in spec]


def _queries(rng, live, fresh, qcap, splits=()):
    """Members, misses, pads (0.0), the splits and their f32 neighbours,
    24 keys across the live range and their upper neighbours, and
    out-of-range values: ``qcap``."""
    sp = np.asarray(splits, np.float32)
    edge = live[::max(live.size // 24, 1)].astype(np.float32)
    beside = np.concatenate([
        sp, np.nextafter(sp, np.float32(np.inf)),
        np.nextafter(sp, np.float32(-np.inf)), edge,
        np.nextafter(edge, np.float32(np.inf))]).astype(np.float64)
    fixed = np.concatenate([beside, fresh[-8:],
                            [0.0, 0.0, 1e30, live[0] / 2, live[-1] * 2]])
    q = np.concatenate([fixed, rng.choice(live, qcap - fixed.size)])
    return rng.permutation(q)


def _matrices(rng, lives, freshes, qcap, splits=None):
    splits = splits or [()] * len(lives)
    qmat = np.stack([_queries(rng, lv, fr, qcap, sp)
                     for lv, fr, sp in zip(lives, freshes, splits,
                                           strict=True)])
    hi = (qmat * (1 + rng.uniform(0, 0.02, qmat.shape))).astype(
        np.float32).astype(np.float64)
    hi[:, :8] = qmat[:, :8] - 1.0                 # degenerate lo > hi
    return qmat, np.concatenate([qmat, hi], 1)


def _truth(live, q):
    lo = np.searchsorted(live, q, side="left")
    return np.searchsorted(live, q, side="right") > lo, lo


def _range_truth(live, lo, hi):
    el = np.searchsorted(live, lo, side="left")
    return el, np.maximum(np.searchsorted(live, hi, side="right"), el)


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _eq(got, want, what):
    np.testing.assert_array_equal(_np(got), _np(want), err_msg=what)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# ------------------------------------------------- the multi-device record --
_MESH_SCRIPT = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
import repro  # noqa: F401
from repro.core import distributed as D
from repro.serve.frontend import TenantPack

with open(%(inp)r, "rb") as fh:
    inp = pickle.load(fh)
out = {}
for ndev, case in inp.items():
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:ndev]), ("data",))
    tenants = [D.ShardedDynamicIndex.build(jnp.asarray(base), mesh,
                                           n_leaves=nl, eps=0.7)
               for base, nl in case["build"]]
    pack = TenantPack(tenants, path="jnp")
    recs = []

    def answer(qmat, rmat):
        f, r = pack.find(jnp.asarray(qmat))
        st = pack._refresh()
        fn = D._tenant_stacked_range_fn(
            pack.mesh, pack.axis, n_tenants=pack.n_tenants,
            n_leaves=pack.n_leaves, leaf_kind=pack.leaf_kind,
            iters=st["iters"], use_kernel=False, interpret=None)
        rl, rr = fn(st["splits"], st["offs"], st["route_n"], st["base"],
                    st["bdead"], st["bpsum"], st["dk"], st["ddead"],
                    st["dpsum"], (st["root"], st["leaves"], st["err_lo"],
                                  st["err_hi"]), jnp.asarray(rmat))
        rl, rr = np.asarray(rl), np.asarray(rr)
        rcap = rmat.shape[1] // 2
        return (np.asarray(f), np.asarray(r), rl[:, :rcap],
                np.maximum(rr[:, rcap:], rl[:, :rcap]),
                pack.pack_rows, pack.pack_full)

    for step in case["steps"]:
        for t, kind, keys in step["ops"]:
            getattr(tenants[t], kind + "_batch")(jnp.asarray(keys))
        recs.append(answer(step["qmat"], step["rmat"]))
    out[ndev] = recs
with open(%(out)r, "wb") as fh:
    pickle.dump(out, fh)
print("FRONTEND_MESH_REF_OK")
"""


def _mesh_inputs(n_shards: int) -> dict:
    """Builds, operations and query matrices of the 2- and 4-shard cases
    (the reference's mesh-script sizes: 6,000 / 1,400 keys)."""
    spec = _spec(41 + n_shards, ((6000, 64), (1400, 16)))
    rng = np.random.default_rng(5 + n_shards)
    tenants = _tenants(spec, n_shards)
    lives = [base.copy() for base, _, _ in spec]
    freshes = [fr for _, _, fr in spec]
    qcap = 256 * n_shards
    steps = []
    for k in range(3):
        ops = []
        if k == 1:
            ins = freshes[1][:64]
            dels = rng.choice(lives[0], 48, replace=False)
            ops = [(1, "insert", ins), (0, "delete", dels)]
        if k == 2:                  # tenant 1's delta tier crosses a class
            ops = [(1, "insert", freshes[1][64:64 + 300])]
        for t, kind, keys in ops:
            getattr(tenants[t], kind + "_batch")(keys)
        lives = [t.live_keys() for t in tenants]
        qmat, rmat = _matrices(rng, lives, freshes, qcap,
                               [t.splits for t in tenants])
        steps.append(dict(ops=ops, qmat=qmat, rmat=rmat))
    return dict(build=[(base, nl) for base, nl, _ in spec], steps=steps)


@pytest.fixture(scope="module", autouse=True)
def mesh_record(tmp_path_factory):
    """The reference's 2- and 4-shard answers, from one subprocess started
    when the module starts (read by the test that needs them, last)."""
    try:
        import jax  # noqa: F401
    except ImportError:
        yield None
        return
    tmp = tmp_path_factory.mktemp("frontend_mesh")
    inp = {n: _mesh_inputs(n) for n in (2, 4)}
    with open(tmp / "inputs.pkl", "wb") as fh:
        pickle.dump(inp, fh)
    env = dict(os.environ, PYTHONPATH="src")
    env.pop("XLA_FLAGS", None)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-c", _MESH_SCRIPT % {
            "inp": str(tmp / "inputs.pkl"), "out": str(tmp / "ref.pkl")}],
        env=env, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)

    def result():
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0 and "FRONTEND_MESH_REF_OK" in out, \
            err[-4000:]
        with open(tmp / "ref.pkl", "rb") as fh:
            return inp, pickle.load(fh)
    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


# --------------------------------------------------- batcher and Request --
BATCHER_CASES = [
    # (budget, max_batch, [(keys, arrival)], probe times)
    (0.010, 1000, [(4, 0.0), (4, 0.004)], [0.0, 0.004, 0.0099, 0.010]),
    (10.0, 8, [(5, 0.0), (3, 0.0), (1, 0.5)], [0.0, 0.1]),
    (0.002, 4096, [(1, 0.001), (4095, 0.0015), (2, 0.0016)], [0.0012,
                                                              0.003]),
    (0.0, 16, [(1, 0.0)], [0.0]),
]


@pytest.mark.parametrize("case", range(len(BATCHER_CASES)))
def test_batcher_matches_reference(ref, case):
    """Offers one at a time, each followed by the probes: ``deadline``,
    ``ready(t)`` (and through the clock), and a cut whenever ready --
    equal in both packages."""
    budget, cap, offers, probes = BATCHER_CASES[case]
    clocks = FakeClock(), FakeClock()
    bs = (F.AdaptiveBatcher(budget, cap, clock=clocks[0]),
          ref.fe.AdaptiveBatcher(budget, cap, clock=clocks[1]))
    reqs = (F.Request, ref.fe.Request)
    log = ([], [])
    for n, arrival in offers:
        for b, R, lg, clk in zip(bs, reqs, log, clocks, strict=True):
            b.offer(R(0, "find", np.arange(1.0, n + 1.0), arrival))
            for t in probes:
                clk.t = t
                lg.append((len(b), b.deadline(), b.ready(t), b.ready()))
                if b.ready():
                    lg.append([r.keys.size for r in b.cut()])
                    lg.append((len(b), b.deadline(), b.ready()))
    assert log[0] == log[1]
    assert any(isinstance(x, list) for x in log[0])


BAD = (np.nan, np.inf, -np.inf)
BAD_PAYLOADS = [(kind, payload) for bad in BAD for kind, payload in (
    ("find", [bad]), ("find", [1.0, bad]), ("insert", [1.0, bad]),
    ("delete", [bad]), ("range", [[bad], [1.0]]), ("range", [[1.0], [bad]]))
] + [("scan", [1.0]), ("range", [1.0, 2.0]), ("range", [[1.0], [2.0],
                                                        [3.0]]),
     ("find", [[1.0, 2.0]])]


@pytest.mark.parametrize("case", range(len(BAD_PAYLOADS)))
def test_request_rejects_what_the_reference_rejects(ref, case):
    kind, payload = BAD_PAYLOADS[case]
    for R in (F.Request, ref.fe.Request):
        with pytest.raises(ValueError):
            R(0, kind, payload)


def test_request_and_submit_checks():
    """Valid payloads of every kind; the front-end's own checks (not
    started, unknown tenant, unpaired endpoints, double start)."""
    for kind, payload, shape in (("find", 1.0, (1,)),
                                 ("insert", [1.0, 2.0], (2,)),
                                 ("delete", np.float32(3.0), (1,)),
                                 ("range", [[1.0, 2.0], [3.0, 4.0]], (2, 2))):
        r = F.Request(1, kind, payload)
        assert r.keys.dtype == np.float64 and r.keys.shape == shape
        assert not r.done() and r.arrival is None
    fe = F.BatchingFrontend(_tenants(_spec(23)))
    with pytest.raises(RuntimeError):
        fe.submit_find(0, [1.0])
    with fe:
        with pytest.raises(ValueError):
            fe.submit_find(2, [1.0])
        with pytest.raises(ValueError):
            fe.submit_range(0, [1.0, 2.0], [3.0])
        for bad in BAD:
            with pytest.raises(ValueError):
                fe.submit_range(0, [1.0], [bad])
        with pytest.raises(RuntimeError):
            fe.start()


# ----------------------------------------------------- the pack, 1 shard --
def _one_shard_steps(seed=23):
    spec = _spec(seed)
    rng = np.random.default_rng(11)
    ins = spec[1][2][:48]
    dels = rng.choice(spec[0][0], 32, replace=False)
    grow = spec[1][2][48:48 + 300]
    return spec, rng, [[], [(1, "insert", ins), (0, "delete", dels)],
                       [(0, "delete", dels[:4])], [],
                       [(1, "insert", grow)]]


@pytest.fixture(scope="module")
def one_shard_record(ref):
    """The reference's ``TenantPack(path="jnp")`` on a one-device mesh:
    each step's operations, query matrices and answers, and its
    counters."""
    spec, rng, steps = _one_shard_steps()
    mesh = ref.jax.make_mesh((1,), ("data",))
    R = [ref.dist.ShardedDynamicIndex.build(ref.jnp.asarray(base), mesh,
                                            n_leaves=nl, eps=0.7)
         for base, nl, _ in spec]
    pack = ref.fe.TenantPack(R, path="jnp")
    recs = []
    for k, ops in enumerate(steps):
        for t, kind, keys in ops:
            getattr(R[t], kind + "_batch")(ref.jnp.asarray(keys))
        lives = [np.asarray(t.live_keys()) for t in R]
        qmat, rmat = _matrices(rng, lives, [s[2] for s in spec],
                               256)
        f, r = pack.find(ref.jnp.asarray(qmat))
        rl, rh = pack.find_range(ref.jnp.asarray(rmat))
        recs.append(dict(ops=ops, qmat=qmat, rmat=rmat, lives=lives,
                         ans=tuple(np.asarray(a) for a in (f, r, rl, rh)),
                         counters=(pack.pack_rows, pack.pack_full)))
    return spec, recs


@pytest.mark.parametrize("path", PATHS)
def test_tenant_pack_bit_exact_one_shard(one_shard_record, path):
    spec, recs = one_shard_record
    P = _tenants(spec)
    pack = F.TenantPack(P, path=path)
    assert pack.use_kernel == (path == "kernel")
    for k, rec in enumerate(recs):
        for t, kind, keys in rec["ops"]:
            getattr(P[t], kind + "_batch")(keys)
        f, r = pack.find(rec["qmat"])
        rl, rh = pack.find_range(rec["rmat"])
        for name, got, want in zip(("found", "rank", "rank_lo", "rank_hi"),
                                   (f, r, rl, rh), rec["ans"], strict=True):
            _eq(got, want, f"step {k} {path} {name}")
        assert (pack.pack_rows, pack.pack_full) == rec["counters"], k
        for t, live in enumerate(rec["lives"]):
            np.testing.assert_array_equal(P[t].live_keys(), live)
    # the crossing: tenant 1's delta tier outgrew the pack's class
    assert pack.pack_full == 2 and pack.pack_rows == 3


# ----------------------------------------------- the pack, 2 and 4 shards --
@pytest.mark.parametrize("n_shards", (2, 4))
@pytest.mark.parametrize("path", PATHS)
def test_tenant_pack_on_shards(mesh_record, n_shards, path):
    """Each step: the pack against each tenant's own find / find_range,
    the truth and the reference's multi-device answers (jnp)."""
    _pack_on_shards(mesh_record, n_shards, path, None)


@pytest.mark.parametrize("n_shards,positions", ((2, 2), (4, 4), (4, 2)))
@pytest.mark.parametrize("path", PATHS)
def test_tenant_pack_on_positions(mesh_record, n_shards, positions, path):
    """The tenants on a mesh of CPU positions: each position holds the
    T x S / D rows of its shards, and every step's answers equal the
    reference's, each tenant's own, the truth and the one-stack pack's."""
    one = _pack_on_shards(mesh_record, n_shards, path, None)
    got = _pack_on_shards(mesh_record, n_shards, path, positions)
    for a, b in zip(got, one, strict=True):
        _eq(a, b, "vs the one-stack pack")


def _pack_on_shards(mesh_record, n_shards, path, positions):
    inp, out = mesh_record()
    case, recs = inp[n_shards], out[n_shards]
    P = [D.ShardedDynamicIndex.build(base, cpu_mesh(n_shards, positions),
                                     n_leaves=nl, eps=0.7, device="cpu")
         for base, nl in case["build"]]
    pack = F.TenantPack(P, path=path)
    answers = []
    for k, (step, rec) in enumerate(zip(case["steps"], recs, strict=True)):
        for t, kind, keys in step["ops"]:
            getattr(P[t], kind + "_batch")(keys)
        qmat, rmat = step["qmat"], step["rmat"]
        rcap = rmat.shape[1] // 2
        f, r = pack.find(qmat)
        rl, rh = pack.find_range(rmat)
        for name, got, want in zip(("found", "rank", "rank_lo", "rank_hi"),
                                   (f, r, rl, rh), rec[:4], strict=True):
            _eq(got, want, f"{n_shards} shards step {k} {name} vs reference")
        assert (pack.pack_rows, pack.pack_full) == rec[4:], k
        for t, idx in enumerate(P):
            own = idx.find(qmat[t], path=path)
            _eq(f[t], own[0], f"found vs own t={t}")
            _eq(r[t], own[1], f"rank vs own t={t}")
            own = idx.find_range(rmat[t, :rcap], rmat[t, rcap:], path=path)
            _eq(rl[t], own[0], f"rank_lo vs own t={t}")
            _eq(rh[t], own[1], f"rank_hi vs own t={t}")
            live = idx.live_keys()
            tf, tr = _truth(live, qmat[t])
            _eq(f[t], tf, "found truth")
            _eq(r[t], tr, "rank truth")
            el, eh = _range_truth(live, rmat[t, :rcap], rmat[t, rcap:])
            _eq(rl[t], el, "rank_lo truth")
            _eq(rh[t], eh, "rank_hi truth")
        answers += [f, r, rl, rh]
    T, D_ = len(P), positions or 1
    assert [(p["lo"], p["n"]) for p in pack._st["parts"]] == \
        [(i * T * n_shards // D_, T * n_shards // D_) for i in range(D_)]
    return answers


def test_pack_sees_in_place_restacks():
    """A tenant's restack rewrites its stack in place (the tensors keep
    their identity), and the very next pack call answers the new rows:
    inserted keys found, deleted ones not, the other tenant's rows not
    rewritten."""
    spec = _spec(29)
    P = _tenants(spec, 2)
    pack = F.TenantPack(P, path="kernel")
    base0 = spec[0][0]
    qmat = np.stack([base0[:64], spec[1][2][:64]])
    f, _ = pack.find(qmat)
    assert f[0].all() and not f[1].any()
    ptrs = {k: v.data_ptr() for k, v in stack_tensors(P[1]._stack).items()
            if k not in HOME_KEYS}
    rows0 = P[1].restack_rows
    P[1].insert_batch(spec[1][2][:64])
    P[0].delete_batch(base0[:32])
    f, r = pack.find(qmat)
    assert P[1].restack_rows > rows0
    now = stack_tensors(P[1]._stack)
    assert all(now[k].data_ptr() == p for k, p in ptrs.items())
    assert f[1].all(), "the pack served a stale row of tenant 1"
    assert not f[0, :32].any() and f[0, 32:].all()
    _eq(r[0], _truth(P[0].live_keys(), qmat[0])[1], "rank after delete")
    assert pack.pack_rows == 2 and pack.pack_full == 1
    pack.find(qmat)
    assert pack.pack_rows == 2, "an unchanged tenant is not rewritten"


def test_kernel_pack_refuses_a_key_space_past_f32():
    """On the kernel path a tenant that takes a key f32 cannot hold fails
    the next batch (its answers would be wrong), on the f64 path it is
    answered exactly."""
    spec = _spec(53)
    base0 = spec[0][0]
    odd = np.nextafter(base0[10], np.inf)          # between two f32 values
    for path in PATHS:
        P = _tenants(spec)
        with F.BatchingFrontend(P, path=path, config=F.ServeConfig(
                latency_budget_s=BUDGET)) as fe:
            fe.warmup((1,))
            fe.submit_insert(0, [odd]).result(timeout=60.0)
            q = np.asarray([odd, base0[10], base0[11]])
            if path == "kernel":
                with pytest.raises(ValueError, match="f32-exact"):
                    fe.lookup(0, q)
            else:
                live = np.sort(np.concatenate([base0, [odd]]))
                _check(fe, [live], 0, q, "f64 path past f32")


# ------------------------------------------------ one stacked call a batch --
def test_one_stacked_call_a_batch(monkeypatch):
    """After warmup, every find batch is one tenant-stacked call and one
    call of the stacked K2 wrapper over every tenant's shards, and every
    range batch one of K3, whatever the live batch size."""
    calls = {"k2": 0, "k3": 0}
    k2, k3 = tlk.sharded_dynamic_lookup, tlk.sharded_dynamic_range

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(tlk, "sharded_dynamic_lookup", count("k2", k2))
    monkeypatch.setattr(tlk, "sharded_dynamic_range", count("k3", k3))
    spec = _spec(31)
    P = _tenants(spec, 2)
    lives = [base for base, _, _ in spec]
    rng = np.random.default_rng(7)
    with F.BatchingFrontend(P, path="kernel", config=F.ServeConfig(
            latency_budget_s=BUDGET)) as fe:
        fe.warmup((1, 200))
        c0, t0 = dict(calls), dict(D.TENANT_CALLS)
        sizes = (1, 2, 17, 64, 127, 128, 129, 199, 250, 256)
        for sz in sizes:
            tid = int(rng.integers(2))
            q = rng.choice(lives[tid], sz)
            found, rank = fe.lookup(tid, q)
            _eq(rank, _truth(lives[tid], q)[1], f"sz={sz}")
            assert found.all()
            lo = rng.choice(lives[tid], sz)
            rl, rh = fe.scan(tid, lo, lo * 1.001)
            _eq(rl, _range_truth(lives[tid], lo, lo * 1.001)[0], f"sz={sz}")
        n = len(sizes)
        assert calls["k2"] - c0["k2"] == n and calls["k3"] - c0["k3"] == n
        assert D.TENANT_CALLS["tenant_find"] - t0["tenant_find"] == n
        assert D.TENANT_CALLS["tenant_range"] - t0["tenant_range"] == n
        assert fe.stats.qcaps <= {128, 256}, fe.stats.qcaps


def test_one_stacked_call_a_position_a_batch(monkeypatch):
    """Tenants on a mesh of two CPU positions: every find batch is one
    tenant-stacked call and one stacked K2 call a position that holds
    queries of the batch (the pads route to the first), every range batch
    the same of K3, and the answers are the truth."""
    calls = {"k2": 0, "k3": 0}
    k2, k3 = tlk.sharded_dynamic_lookup, tlk.sharded_dynamic_range

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(tlk, "sharded_dynamic_lookup", count("k2", k2))
    monkeypatch.setattr(tlk, "sharded_dynamic_range", count("k3", k3))
    spec = _spec(37)
    P = _tenants(spec, 4, positions=2)
    lives = [base for base, _, _ in spec]
    rng = np.random.default_rng(9)
    with F.BatchingFrontend(P, path="kernel", config=F.ServeConfig(
            latency_budget_s=BUDGET)) as fe:
        fe.warmup((1, 200))
        for sz in (1, 17, 128, 250):
            tid = int(rng.integers(2))
            q = rng.choice(lives[tid], sz)
            c0, e0 = dict(calls), D.EXCHANGE["answers"]
            found, rank = fe.lookup(tid, q)
            _eq(rank, _truth(lives[tid], q)[1], f"sz={sz}")
            assert found.all()
            k2_calls = calls["k2"] - c0["k2"]
            assert k2_calls == D.EXCHANGE["answers"] - e0
            assert 1 <= k2_calls <= 2 and (sz < 100 or k2_calls == 2), sz
            lo = rng.choice(lives[tid], sz)
            c0 = dict(calls)
            rl, _ = fe.scan(tid, lo, lo * 1.001)
            _eq(rl, _range_truth(lives[tid], lo, lo * 1.001)[0], f"sz={sz}")
            assert 1 <= calls["k3"] - c0["k3"] <= 2


# --------------------------------------------- the front-end end to end --
def _check(fe, lives, tid, q, tag):
    q = np.asarray(q, np.float64)
    found, rank = fe.lookup(tid, q)
    tf, tr = _truth(lives[tid], q)
    _eq(rank, tr, tag)
    _eq(found, tf, tag)


def _check_range(fe, lives, tid, lo, hi, tag):
    rl, rh = fe.scan(tid, lo, hi)
    el, eh = _range_truth(lives[tid], np.asarray(lo, np.float64),
                          np.asarray(hi, np.float64))
    _eq(rl, el, tag)
    _eq(rh, eh, tag)


@pytest.mark.parametrize("path", PATHS)
def test_frontend_interleaves_updates(path):
    spec = _spec(23)
    lives = [base.copy() for base, _, _ in spec]
    fresh = [fr for _, _, fr in spec]
    rng = np.random.default_rng(3)
    with F.BatchingFrontend(_tenants(spec, 2), path=path,
                            config=F.ServeConfig(latency_budget_s=BUDGET)) \
            as fe:
        fe.warmup((1,))
        _check(fe, lives, 0, rng.choice(lives[0], 40), "t0 fresh")
        _check(fe, lives, 1, np.concatenate([rng.choice(lives[1], 20),
                                             fresh[1][-4:], [0.0, 1e30]]),
               "t1 fresh+miss")
        ins = fresh[1][:48]
        assert fe.submit_insert(1, ins).result(timeout=60.0) is None
        lives[1] = np.sort(np.concatenate([lives[1], ins]))
        dels = rng.choice(lives[0], 32, replace=False)
        fe.submit_delete(0, dels).result(timeout=60.0)
        lives[0] = np.setdiff1d(lives[0], dels)
        _check(fe, lives, 1, np.concatenate([ins[:16],
                                             rng.choice(lives[1], 20)]),
               "t1 after insert")
        _check(fe, lives, 0, np.concatenate([dels[:8],
                                             rng.choice(lives[0], 20)]),
               "t0 after delete")
        assert fe.stats.updates == 48 + 32
        assert fe.pack.pack_rows >= 1


def test_frontend_pads_to_capacity_classes():
    spec = _spec(23)
    lives = [base for base, _, _ in spec]
    rng = np.random.default_rng(5)
    cfg = F.ServeConfig(latency_budget_s=BUDGET, batch_floor=128)
    with F.BatchingFrontend(_tenants(spec), path="kernel", config=cfg) as fe:
        fe.warmup((1, 200))
        for sz in (1, 3, 127, 128, 129, 200):
            _check(fe, lives, 0, rng.choice(lives[0], sz), f"sz={sz}")
        assert fe.stats.qcaps <= {128, 256}, fe.stats.qcaps
        for c in fe.stats.qcaps:
            assert c == capacity_class(c, cfg.batch_floor)
        assert 0.0 < fe.stats.pad_fraction < 1.0
        assert fe.stats.queries == 1 + 3 + 127 + 128 + 129 + 200


def test_frontend_serves_ranges():
    """Ranges against the truth, coalesced with finds, after an insert,
    and degenerate ranges (lo > hi, wholly below or above) empty."""
    spec = _spec(23)
    lives = [base.copy() for base, _, _ in spec]
    fresh = [fr for _, _, fr in spec]
    rng = np.random.default_rng(13)
    with F.BatchingFrontend(_tenants(spec, 2), path="kernel",
                            config=F.ServeConfig(latency_budget_s=BUDGET)) \
            as fe:
        fe.warmup((1, 64))
        for tid in (0, 1):
            lo = rng.choice(lives[tid], 9)
            hi = (lo * (1 + rng.uniform(0, 0.02, 9))).astype(
                np.float32).astype(np.float64)
            _check_range(fe, lives, tid, lo, hi, f"t{tid} fresh")
        ins = fresh[1][:32]
        fe.submit_insert(1, ins).result(timeout=60.0)
        lives[1] = np.sort(np.concatenate([lives[1], ins]))
        _check_range(fe, lives, 1, ins[:8],
                     (ins[:8] * 1.01).astype(np.float32).astype(np.float64),
                     "after insert")
        span = lives[0][-1] - lives[0][0]
        for lo, hi in (([lives[0][5]], [lives[0][2]]),
                       ([lives[0][0] - span], [lives[0][0] - span / 2]),
                       ([lives[0][-1] * 2], [lives[0][-1] * 4])):
            rl, rh = fe.scan(0, lo, hi)
            assert np.array_equal(rl, rh), (lo, hi, rl, rh)
        _check_range(fe, lives, 0, [lives[0][0]], [lives[0][-1]], "span")
        assert fe.stats.ranges > 0


def _held(fe):
    """Stop the front-end's clock at 0 so that requests coalesce until
    ``release`` puts the real clock back, far past their deadlines: one
    batch, deterministically."""
    fe.clock = fe.batcher.clock = FakeClock()

    def release():
        with fe._cond:
            fe.clock = fe.batcher.clock = time.monotonic
            fe._cond.notify_all()
    return release


def test_one_batch_mixes_every_kind():
    """An insert, a delete, finds and ranges of both tenants in one batch:
    the updates apply before the batch's finds and ranges, a range request
    deletes nothing, and the batch is one stacked find and one range."""
    spec = _spec(37)
    lives = [base.copy() for base, _, _ in spec]
    fresh = [fr for _, _, fr in spec]
    P = _tenants(spec, 2)
    with F.BatchingFrontend(P, path="kernel", config=F.ServeConfig(
            latency_budget_s=BUDGET)) as fe:
        fe.warmup((1,))
        release = _held(fe)
        b0, t0 = fe.stats.batches, dict(D.TENANT_CALLS)
        ins, dels = fresh[0][:16], lives[1][:8]
        reqs = [fe.submit_insert(0, ins), fe.submit_delete(1, dels),
                fe.submit_find(0, ins), fe.submit_find(1, dels),
                fe.submit_range(1, lives[1][:4], lives[1][10:14]),
                fe.submit_range(0, ins[:2], ins[:2])]
        release()
        for r in reqs:
            r.result(timeout=60.0)
        assert fe.stats.batches - b0 == 1
        assert D.TENANT_CALLS["tenant_find"] - t0["tenant_find"] == 1
        assert D.TENANT_CALLS["tenant_range"] - t0["tenant_range"] == 1
        lives[0] = np.sort(np.concatenate([lives[0], ins]))
        lives[1] = lives[1][8:]
        assert reqs[2].found.all() and not reqs[3].found.any()
        el, eh = _range_truth(lives[1], reqs[4].keys[0], reqs[4].keys[1])
        _eq(reqs[4].rank_lo, el, "range t1")
        _eq(reqs[4].rank_hi, eh, "range t1")
        assert (reqs[5].rank_hi - reqs[5].rank_lo == 1).all()
        # a range request never deletes: its keys stay live
        for _ in range(2):
            fe.scan(0, ins[:4], ins[:4])
        _check(fe, lives, 0, ins, "range deleted nothing")
        assert P[0].total_live + P[1].total_live == \
            lives[0].size + lives[1].size
        assert fe.stats.updates == 16 + 8


def test_failing_request_fails_only_its_batch(monkeypatch):
    """An update that raises fails its caller alone; a dispatch that raises
    fails the callers of its batch; the loop serves the next batch."""
    spec = _spec(23)
    lives = [base for base, _, _ in spec]
    P = _tenants(spec)
    with F.BatchingFrontend(P, config=F.ServeConfig(
            latency_budget_s=BUDGET)) as fe:
        fe.warmup((1,))

        def broken(keys):
            raise RuntimeError("insert failed")
        monkeypatch.setattr(P[1], "insert_batch", broken)
        release = _held(fe)
        bad = fe.submit_insert(1, [1.0])
        good = fe.submit_find(0, lives[0][:5])
        release()
        with pytest.raises(RuntimeError, match="insert failed"):
            bad.result(timeout=60.0)
        assert good.result(timeout=60.0)[0].all()
        monkeypatch.undo()
        find = fe.pack.find
        fail_once = {"left": 1}

        def flaky(qmat):
            if fail_once["left"]:
                fail_once["left"] -= 1
                raise RuntimeError("dispatch failed")
            return find(qmat)
        fe.pack.find = flaky
        with pytest.raises(RuntimeError, match="dispatch failed"):
            fe.lookup(0, lives[0][:3])
        _check(fe, lives, 0, lives[0][:7], "after a failed batch")
        assert fe._thread.is_alive()


def test_failing_maintenance_keeps_serving(monkeypatch):
    """An idle-window pass that raises is counted and kept, and the next
    lookups are still answered."""
    spec = _spec(23)
    lives = [base for base, _, _ in spec]
    P = _tenants(spec)
    with F.BatchingFrontend(P, config=F.ServeConfig(
            latency_budget_s=BUDGET)) as fe:
        fe.warmup((1,))
        swap = P[0].maybe_swap
        fail_once = {"left": 1}

        def flaky():
            if fail_once["left"]:
                fail_once["left"] -= 1
                raise MemoryError("refit out of memory")
            return swap()
        monkeypatch.setattr(P[0], "maybe_swap", flaky)
        _check(fe, lives, 0, lives[0][:5], "before the failed pass")
        deadline = time.monotonic() + 30.0
        while fe.stats.maintain_failures == 0 and time.monotonic() < deadline:
            time.sleep(1e-3)
        assert fe.stats.maintain_failures == 1
        assert isinstance(fe.maintain_error, MemoryError)
        _check(fe, lives, 0, lives[0][5:12], "after the failed pass")
        _check_range(fe, lives, 1, lives[1][:4], lives[1][8:12],
                     "after the failed pass")
        assert fe._thread.is_alive() and fe.stats.maintain_failures == 1


def test_maintain_swaps_a_pooled_drift_tenant():
    """A pooled tenant with drift monitoring in swap mode under shifted
    ingest through the queue: the idle-window maintenance commits swaps,
    the swapped rows reach the pack, and every answer stays exact."""
    pool = treuse.build_pool(tsynth.generate_pool(0.65, ns=256, seed=1),
                             kind="linear", m_sim=64, device="cpu")
    rng = np.random.default_rng(7)
    f32 = lambda a: np.asarray(a).astype(np.float32).astype(np.float64)
    base = np.unique(f32(rng.lognormal(0.0, 0.5, 8000)))
    drifty = D.ShardedDynamicIndex.build(
        base, D.ShardMesh(2), n_leaves=64, eps=0.65, pool=pool,
        drift_bins=64, drift_hi=0.08, drift_lo=0.04, swap_on_drift=True,
        rebalance_ratio=None, device="cpu")
    spec = _spec(23)
    plain = _tenants(spec[:1], 2)[0]
    lives = [base.copy(), spec[0][0].copy()]
    with F.BatchingFrontend([drifty, plain], path="kernel",
                            config=F.ServeConfig(latency_budget_s=BUDGET)) \
            as fe:
        fe.warmup((1,))
        for _ in range(4):
            b = np.setdiff1d(np.unique(f32(rng.lognormal(1.5, 0.4, 600))),
                             lives[0])
            fe.submit_insert(0, b).result(timeout=60.0)
            lives[0] = np.sort(np.concatenate([lives[0], b]))
            _check(fe, lives, 0, np.concatenate([b[:50], rng.choice(
                lives[0], 50)]), "after a shifted batch")
        deadline = time.monotonic() + 30.0
        while fe.stats.swaps == 0 and time.monotonic() < deadline:
            _check(fe, lives, 1, rng.choice(lives[1], 8), "idle window")
        assert fe.stats.swaps > 0 and drifty.swaps_committed > 0
        for _ in range(3):
            _check(fe, lives, 0, rng.choice(lives[0], 200), "swapped")
        _check_range(fe, lives, 0, lives[0][:50], lives[0][50:100],
                     "swapped range")


def test_stress_many_callers():
    """Eight caller threads submit finds and inserts of disjoint fresh keys
    at once; every find answers the truth of the live set it can see (its
    own inserts included), and at the end every inserted key is found."""
    spec = _spec(43)
    P = _tenants(spec, 2)
    fresh = spec[1][2]
    errors = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with F.BatchingFrontend(P, path="kernel", config=F.ServeConfig(
                latency_budget_s=BUDGET)) as fe:
            fe.warmup((1, 64))

            def caller(i):
                try:
                    rng = np.random.default_rng(i)
                    mine = fresh[i * 16:(i + 1) * 16]
                    fe.submit_insert(1, mine).result(timeout=60.0)
                    f, _ = fe.lookup(1, mine)
                    assert f.all()
                    q = rng.choice(spec[0][0], 32)
                    f, r = fe.lookup(0, q)
                    _eq(r, _truth(spec[0][0], q)[1], f"caller {i}")
                except Exception as e:      # noqa: BLE001 - reported below
                    errors.append(e)
            threads = [threading.Thread(target=caller, args=(i,))
                       for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120.0)
            assert not any(t.is_alive() for t in threads)
            assert not errors, errors
            f, _ = fe.lookup(1, fresh[:128])
            assert f.all()
    finally:
        sys.setswitchinterval(old)


def test_example_runs_on_the_cpu():
    """``examples/index_service_torch.py`` at a reduced size on the CPU:
    the typed insert, the Poisson drive (every drawn key found) and the
    dataset demo."""
    _example(1)


def test_example_runs_on_two_positions():
    """The example with its tenants' shards on two CPU positions."""
    _example(2)


def _example(positions):
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "index_service_torch.py")
    out = runpy.run_path(path)["main"](
        ["--device", "cpu", "--rate", "200", "--duration", "0.5", "--n",
         "8192", "--positions", str(positions)])
    assert out["requests"] > 0 and 0 < out["batches"] <= out["requests"]
    assert out["launches"] == 0          # plain versions on the CPU
    assert out["p99_ms"] >= out["p50_ms"] > 0.0


# ----------------------------------------------------------------- card --
@pytest.mark.gpu
def test_pack_on_the_card():
    """On the card: the pack's answers equal the CPU's, and a find batch is
    one launch of the stacked K2, a range batch one of K3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = _spec(47)
    rng = np.random.default_rng(9)
    cpu = F.TenantPack(_tenants(spec, 4), path="kernel")
    card = F.TenantPack(_tenants(spec, 4, device="cuda"), path="kernel")
    assert card.use_kernel
    lives = [base for base, _, _ in spec]
    for qcap in (128, 256, 1024):
        qmat, rmat = _matrices(rng, lives, [s[2] for s in spec], qcap)
        k0 = dict(tlk.LAUNCHES)
        got = card.find(qmat) + card.find_range(rmat)
        assert tlk.LAUNCHES["sharded_dynamic_lookup"] \
            - k0["sharded_dynamic_lookup"] == 1
        assert tlk.LAUNCHES["sharded_dynamic_range"] \
            - k0["sharded_dynamic_range"] == 1
        want = cpu.find(qmat) + cpu.find_range(rmat)
        for g, w in zip(got, want, strict=True):
            _eq(g, w, f"qcap {qcap}")
