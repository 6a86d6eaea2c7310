"""K1 and K4 of the CUDA kernels (``csrc/lookup.cu``), emulated on the CPU
lane by lane and warp by warp, and held against the plain versions and the
reference's Pallas kernels.  No card is needed: the emulation walks what
every lane of a warp loads and compares.

* Rows: K1 reads a leaf from its leaf-major row (``lookup.leaf_rows``: 16
  bytes a linear leaf, 64 an MLP leaf), K4 a node from its node-major row
  (``lookup.node_rows``: 32 bytes a linear node, 80 an MLP node); the
  builders' rows equal the packed tables' entries, and every row loaded
  lies inside the table.
* K4's descent runs the reference's ``depth`` levels over the node rows, a
  lane at its leaf staying there; it moves exactly as the static loop.
* The search: a window the static depth converges (``hi - lo <
  2**iters``) is searched on the key fence (``lookup.key_fence``: every
  64th key) and then within one 64-key interval of the keys; any other
  window replays the static loop's midpoints.  K1 takes binary trips, K4
  finishes from a sector as K2 does (``test_torch_k2_k3._trip``, which
  fails on any load outside its tier); a warp leaves once no lane has a
  live window or a fence step left.  The emulation fails on any probe
  outside the keys or the fence.
* The index caches its rows and fence beside its packed tables and f32
  keys, passes them to the kernels' wrappers, and drops them with the
  tables: fresh after ``DynamicRMI`` rebuilds and after a drift swap
  commits.

Cases: random queries, queries below and above the keys, +-0, +-inf and
NaN; duplicate keys; leaves given an empty leaf's sentinel window (+-n: a
full-array window, unconverged at the clamped depth, converged at full
depth); ``iters`` cut by 8; keys as a view that starts inside a 32-byte
sector; keys without capacity pads (windows that end at ``n_keys``);
linear and MLP leaves and nodes.  Every emulated result equals
``lookup_plain`` / ``rmrt_lookup_plain`` bit for bit, and the reference's
``lookup_pallas`` / ``rmrt_lookup_pallas`` (interpret mode).  With
``iters`` cut, an unconverged search ends where its window makes it end,
and the reference's Pallas kernels compute the window inside a jit, where
XLA:CPU contracts ``a*q + b`` into an FMA (the port never does): those
cases are held against the reference's eager oracles ``ref.lookup_ref`` /
``rmrt_lookup_ref`` instead, which round as the kernels do.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import pytest
import torch

import repro  # noqa: F401  (enables x64 for the reference)
import jax.numpy as jnp
from repro.kernels import lookup as jlk
from repro.kernels import ref as jref
from test_torch_k2_k3 import _trip
from torch_export import gen_keys

from repro_torch.core import rmi as trmi
from repro_torch.core import rmrt as trmrt
from repro_torch.core.updates import DynamicRMI as TDynamicRMI
from repro_torch.kernels import lookup as tlk
from repro_torch.kernels import ops as tops

_F32 = np.float32
_WARP = 32
_SHIFT = 6                      # csrc/lookup.cu kFenceShift
_ALL = 32                       # trips enough for any converged window


# ---------------------------------------------------------------------------
# The emulation
# ---------------------------------------------------------------------------
def _to_i32(x, lo, hi):
    """``__float2int_rz(clip_nan(x, lo, hi))``, as the plain version."""
    return tlk.clip_to_i32(torch.from_numpy(np.asarray(x, _F32)), lo,
                           hi).numpy().astype(np.int64)


def _bounds(pred, elo, ehi, n):
    with np.errstate(invalid="ignore", over="ignore"):
        flo = np.floor(pred + elo)
        fhi = np.ceil(pred + ehi) + _F32(1)
    return (_to_i32(flo, 0.0, tlk._f32(n - 1)),
            _to_i32(fhi, 1.0, tlk._f32(n)))


def _mlp(q, b2, w1, b1, w2):
    """b2 + sum_k relu(q*w1_k + b1_k) * w2_k, sequentially, in f32."""
    pred = b2
    with np.errstate(invalid="ignore", over="ignore"):
        for k in range(tlk.H):
            h = q * w1[:, k] + b1[:, k]
            h = np.where(h < 0, _F32(0), h)
            pred = pred + h * w2[:, k]
    return pred


def _k1_window(q, root, rows, kind, *, n_keys, n_leaves, route_n,
               root_kind="linear"):
    """K1's stages 1-3 from the leaf rows: one row a query."""
    b = tlk.route_bucket(torch.from_numpy(q), torch.from_numpy(root),
                         n_leaves=n_leaves, route_n=route_n,
                         root_kind=root_kind).numpy().astype(np.int64)
    assert ((b >= 0) & (b < rows.shape[0])).all()
    r = rows[b]
    if kind == "linear":
        with np.errstate(invalid="ignore", over="ignore"):
            pred = r[:, 0] * q + r[:, 1]
        return _bounds(pred, r[:, 2], r[:, 3], n_keys)
    pred = _mlp(q, r[:, 12], r[:, 0:4], r[:, 4:8], r[:, 8:12])
    return _bounds(pred, r[:, 13], r[:, 14], n_keys)


def _node_predict(row, q, kind):
    if kind == "linear":
        with np.errstate(invalid="ignore", over="ignore"):
            return row[:, 0] * q + row[:, 1]
    return _mlp(q, row[:, 1], row[:, 8:12], row[:, 12:16], row[:, 16:20])


def _pad(a, m, v):
    return np.concatenate([a, np.full(m - a.shape[0], v, a.dtype)])


def _k4_window(q, rows, kind, *, fanout, depth, n_keys):
    """K4's descent from the node rows, lane by lane: (lo, hi, levels each
    lane moved)."""
    row = np.repeat(rows[:1], q.shape[0], 0)            # node 0
    node = np.zeros(q.shape[0], np.int64)
    moved = np.zeros(q.shape[0], np.int64)
    ffan = _F32(fanout)
    for _ in range(depth):
        ys = row[:, 4]
        with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
            ratio = (_node_predict(row, q, kind) - ys) * ffan \
                / (row[:, 5] - ys)
        child = tlk.trunc_clip(torch.from_numpy(ratio), 0,
                               fanout - 1).numpy().astype(np.int64)
        move = ~(row[:, 7] > 0.5)
        nxt = _to_i32(row[:, 6], -2.0 ** 31, 2.0 ** 31) + child
        node = np.where(move, nxt, node)
        assert ((node >= 0) & (node < rows.shape[0])).all()
        row = rows[node]
        moved += move
    lo, hi = _bounds(_node_predict(row, q, kind), row[:, 2], row[:, 3],
                     n_keys)
    return lo, hi, moved


def _step(chain, sel, keys, a8, q, sectors):
    """One trip (``issue`` + ``retire``) of the selected lanes' chains."""
    l, h, r = chain
    live = sel & (r > 0) & (h > l)
    mid = (l + h) >> 1
    assert (mid[live] >= 0).all()
    nl, nh, nr = _trip((l, h, np.where(sel, r, 0)), keys, a8, q,
                       np.zeros(l.shape[0], bool), sectors)
    return (np.where(sel, nl, l), np.where(sel, nh, h),
            np.where(sel, nr, r))


def _leaf_search(keys, a8, q, lo, hi, iters, fence_on=True, sectors=True,
                 valid=None):
    """``leaf_search<fence_on, sectors>`` for every lane: (position, trips
    each warp took, lanes that searched the fence, lanes whose fence window
    held an entry)."""
    n = keys.shape[0]
    fence = keys[::1 << _SHIFT].copy()
    nf = fence.shape[0]
    assert nf == -(-n // 64)
    nq = q.shape[0]
    m = -(-nq // _WARP) * _WARP
    valid = np.ones(nq, bool) if valid is None else valid
    x, valid = _pad(q, m, _F32(0)), _pad(valid, m, False)
    lo, hi = _pad(lo, m, 0), _pad(hi, m, 0)
    width = hi - lo
    on = fence_on & valid & ((iters >= 31) | (
        (iters > 0) & (width >= 0) & (width < (1 << max(iters, 0)))))
    jl = (lo + 63) >> _SHIFT
    jh = np.maximum(np.minimum((hi + 63) >> _SHIFT, nf), jl)
    fenced, entries = on.copy(), on & (jh > jl)
    chain = (np.where(on, jl, lo), np.where(on, jh, hi),
             np.where(on, _ALL, np.where(valid, iters, 0)))
    trips = np.zeros(m // _WARP, np.int64)
    while True:
        l, h, r = chain
        live = (r > 0) & (h > l)
        going = (live | on).reshape(-1, _WARP).any(1)
        if not going.any():
            break
        trips += going
        turn = on & ~live                       # the fence's key interval
        j = l
        chain = (np.where(turn, np.where(j > jl, ((j - 1) << _SHIFT) + 1,
                                         lo), l),
                 np.where(turn, np.where(j < jh, j << _SHIFT, hi), h),
                 np.where(turn, _ALL, r))
        on = on & ~turn
        assert (chain[1][on] <= nf).all()       # no fence probe past nf
        chain = _step(chain, on, fence, 0, x, sectors)
        chain = _step(chain, ~on, keys, a8, x, sectors)
    l = chain[0]
    pos = np.where(l < hi, l, np.minimum(hi, n))
    return pos[:nq], trips, fenced[:nq], entries[:nq]


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------
def _keys(rng, n, dist, pad=True):
    live = np.sort(gen_keys(rng, dist, n)).astype(_F32)
    cap = tlk.capacity_class(n) if pad else n
    return live, np.concatenate([live, np.full(cap - n, np.inf, _F32)])


def _queries(rng, live, m=1500):
    specials = np.array([0.0, -0.0, np.inf, -np.inf, np.nan], _F32)
    return np.concatenate([
        rng.choice(live, m // 2),
        rng.uniform(live[0] - 1, live[-1] * 1.2, m // 2).astype(_F32),
        live[:3], live[-3:], specials]).astype(_F32)


def _mlp_tables(rng, live, L, n):
    """MLP leaves predicting the position from the key span, windows of 2
    to 200 keys."""
    k0, span = float(live[0]), float(live[-1] - live[0])
    ones = torch.ones(L, tlk.H)
    err = torch.from_numpy(rng.integers(2, 200, L).astype(_F32))
    return tlk.pack_leaves(ones, ones * -k0, ones * (n / span / tlk.H),
                           torch.zeros(L), -err, err)


def _sentinel(vec, leaves, n):
    vec = vec.clone()
    vec[1, leaves], vec[2, leaves] = -float(n), float(n)
    return vec


K1_CASES = {
    # name: (keys, leaves, dist, leaf kind, iters cut, sentinel, a8, pad,
    #        full depth)
    "lognormal": (20_001, 64, "lognormal", "linear", 0, False, 0, True,
                  False),
    "dup-heavy": (9_999, 32, "dup-heavy", "linear", 0, False, 0, True,
                  False),
    "mlp leaves": (12_007, 48, "uniform", "mlp", 0, False, 0, True, False),
    "iters cut by 8": (20_001, 64, "lognormal", "linear", 8, False, 0, True,
                       False),
    "empty leaves": (20_001, 64, "lognormal", "linear", 0, True, 0, True,
                     False),
    "empty leaves, full depth": (9_999, 32, "dup-heavy", "linear", 0, True,
                                 0, True, True),
    "mlp, empty, cut": (12_007, 48, "uniform", "mlp", 8, True, 5, True,
                        False),
    "unaligned keys": (4_099, 16, "lognormal", "linear", 0, False, 3, True,
                       False),
    "unpadded keys": (20_001, 64, "zipf", "linear", 0, True, 7, False,
                      True),
}


def _k1_case(name, seed=1):
    n, L, dist, kind, cut, sentinel, a8, pad, full = K1_CASES[name]
    rng = np.random.default_rng(seed)
    live, kf = _keys(rng, n, dist, pad)
    idx = trmi.build_rmi(torch.from_numpy(live.astype(np.float64)),
                         n_leaves=L, device="cpu")
    root, mat, vec = idx.packed_tables()
    if kind == "mlp":
        mat, vec = _mlp_tables(rng, live, L, n)
    q = _queries(rng, live)
    S = kf.shape[0]                # routed over S, as lookup_pallas routes
    if sentinel:
        leaf = tlk.route_bucket(torch.from_numpy(q[:12]), root, n_leaves=L,
                                route_n=S).long()
        vec = _sentinel(vec, leaf, n)
    iters = tlk.search_iters(vec[1, :L], vec[2, :L], S)
    iters = tlk.full_iters(S) if full else iters - cut
    kw = dict(n_leaves=L, route_n=S, iters=iters, leaf_kind=kind)
    return (root, mat, vec), kf, q, kw, a8


@pytest.mark.parametrize("name", list(K1_CASES))
def test_k1_emulation_matches_plain_and_reference(name):
    tabs, kf, q, kw, a8 = _k1_case(name)
    root, mat, vec = tabs
    kind, S = kw["leaf_kind"], kf.shape[0]
    rows = tlk.leaf_rows(mat, vec, kind).numpy()
    lo, hi = _k1_window(q, root.numpy(), rows, kind, n_keys=S,
                        n_leaves=kw["n_leaves"], route_n=kw["route_n"])
    plo, phi = tlk.route_window(torch.from_numpy(q), *tabs, n_keys=S,
                                n_leaves=kw["n_leaves"],
                                route_n=kw["route_n"], leaf_kind=kind)
    np.testing.assert_array_equal(lo, plo.numpy())
    np.testing.assert_array_equal(hi, phi.numpy())
    # K1: from the fence, in binary trips
    pos, trips, fenced, entries = _leaf_search(kf, a8, q, lo, hi,
                                               kw["iters"], sectors=False)
    want = tlk.lookup_plain(torch.from_numpy(q), *tabs, torch.from_numpy(kf),
                            **kw).numpy()
    np.testing.assert_array_equal(pos, want)
    # the wrapper on the CPU, given the rows and fence it checks
    got = tlk.lookup(torch.from_numpy(q), *tabs, torch.from_numpy(kf),
                     rows=torch.from_numpy(rows),
                     fence=tlk.key_fence(torch.from_numpy(kf)), **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert S <= 1 << 18                    # one reference key tile
    ref = jref.lookup_ref if "cut" in name else jlk.lookup_pallas
    want = ref(jnp.asarray(q), *(jnp.asarray(a.numpy()) for a in tabs),
               jnp.asarray(kf), n_leaves=kw["n_leaves"], leaf_kind=kind,
               iters=kw["iters"])
    np.testing.assert_array_equal(pos, np.asarray(want))
    assert entries.any() or "cut" in name  # windows that cross the fence
    conv = (hi - lo) < (1 << kw["iters"])
    np.testing.assert_array_equal(fenced, conv)
    if "cut" in name or ("empty" in name and "full" not in name):
        assert not conv.all()              # windows the depth leaves open
    if "full depth" in name:
        assert conv.all() and ((hi - lo) > 1 << 12).any()


K4_CASES = {
    # name: (kind, dist, iters cut, sentinel, a8, full depth)
    "linear": ("linear", "lognormal", 0, False, 0, False),
    "mlp": ("mlp", "uniform", 0, False, 0, False),
    "linear, cut": ("linear", "dup-heavy", 8, False, 3, False),
    "empty leaves": ("linear", "lognormal", 0, True, 0, False),
    "empty leaves, full depth": ("linear", "zipf", 0, True, 6, True),
    "mlp, empty, cut": ("mlp", "lognormal", 8, True, 1, False),
}


@pytest.fixture(scope="module")
def trees():
    out = {}
    for kind, dist in (("linear", "lognormal"), ("linear", "dup-heavy"),
                       ("linear", "zipf"), ("mlp", "uniform"),
                       ("mlp", "lognormal")):
        keys = np.sort(gen_keys(np.random.default_rng(4), dist, 6000))
        out[kind, dist] = trmrt.build_rmrt(keys, leaf_cap=256, fanout=8,
                                           kind=kind, train_steps=20,
                                           device="cpu")
    return out


@pytest.mark.parametrize("name", list(K4_CASES))
def test_k4_emulation_matches_plain_and_reference(trees, name):
    kind, dist, cut, sentinel, a8, full = K4_CASES[name]
    tree = trees[kind, dist]
    assert tree.depth >= 2
    mat, vec = tree.packed_tables()
    kf = tree.keys_f32.numpy()
    live = kf
    rng = np.random.default_rng(5)
    q = _queries(rng, live)
    if sentinel:
        leaves = torch.nonzero(tree.is_leaf).squeeze(1)[::7]
        vec = _sentinel(vec, leaves, tree.n)
    S = kf.shape[0]
    iters = tlk.full_iters(S) if full else tlk.search_iters(
        vec[1], vec[2], S) - cut
    tkw = dict(fanout=tree.fanout, depth=tree.depth, kind=kind)
    rows = tlk.node_rows(mat, vec, kind).numpy()
    lo, hi, moved = _k4_window(q, rows, kind, n_keys=S, fanout=tree.fanout,
                               depth=tree.depth)
    plo, phi = tlk.rmrt_route_window(torch.from_numpy(q), mat, vec,
                                     n_keys=S, **tkw)
    np.testing.assert_array_equal(lo, plo.numpy())
    np.testing.assert_array_equal(hi, phi.numpy())
    # the rows move each query as the lane-major static loop does
    np.testing.assert_array_equal(moved, _static_levels(q, mat, vec, **tkw))
    pos, _, fenced, _ = _leaf_search(kf, a8, q, lo, hi, iters)  # K4: both
    want = tlk.rmrt_lookup_plain(torch.from_numpy(q), mat, vec,
                                 torch.from_numpy(kf), iters=iters,
                                 **tkw).numpy()
    np.testing.assert_array_equal(pos, want)
    got = tlk.rmrt_lookup(torch.from_numpy(q), mat, vec,
                          torch.from_numpy(kf), iters=iters,
                          rows=torch.from_numpy(rows),
                          fence=tlk.key_fence(torch.from_numpy(kf)), **tkw)
    np.testing.assert_array_equal(got.numpy(), want)
    ref = jref.rmrt_lookup_ref if cut else jlk.rmrt_lookup_pallas
    want = ref(jnp.asarray(q), jnp.asarray(mat.numpy()),
               jnp.asarray(vec.numpy()), jnp.asarray(kf), iters=iters, **tkw)
    np.testing.assert_array_equal(pos, np.asarray(want))
    conv = (hi - lo) < (1 << max(iters, 0))
    np.testing.assert_array_equal(fenced, conv & (iters > 0))
    if cut or (sentinel and not full):
        assert not conv.all()


def _static_levels(q, mat, vec, *, fanout, depth, kind):
    """The levels of the reference's static descent that change the node."""
    npad = mat.shape[1]
    fv = vec.reshape(-1)
    qt = torch.from_numpy(q)
    node = torch.zeros(q.shape, dtype=torch.int64)
    levels = torch.zeros_like(node)
    for _ in range(depth):
        pred = tlk.lane_predict(qt, mat, vec, node, kind)
        ys = fv[node + 3 * npad]
        child = tlk.trunc_clip((pred - ys) * float(fanout)
                               / (fv[node + 4 * npad] - ys), 0, fanout - 1)
        move = ~(fv[node + 6 * npad] > 0.5)
        levels += move
        node = torch.where(move, fv[node + 5 * npad].long() + child, node)
    return levels.numpy()


# ---------------------------------------------------------------------------
# The fence search alone, on every window of a small tier
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,a8", [(200, 0), (257, 3), (640, 7), (129, 1)])
def test_fence_search_equals_the_static_loop(n, a8):
    """Every window [lo, hi) of a tier of n keys with runs of duplicates,
    hi up to n + 16 (the f32-rounded clamp can pass n), queries below, on,
    between and past the keys, NaN and +-inf: the fence search of a
    converged window and the replay of an unconverged one end where the
    static loop ends."""
    keys = np.repeat(np.arange(n // 3 + 1, dtype=_F32), 3)[:n]
    rng = np.random.default_rng(n)
    lo = rng.integers(0, n, 4000)
    hi = lo + rng.integers(-2, n + 16 - lo + 1, 4000)
    hi = np.minimum(hi, n + 16)
    q = np.concatenate([rng.uniform(-2, n // 3 + 2, 3995).astype(_F32),
                        np.array([np.nan, np.inf, -np.inf, 0.0, -0.0],
                                 _F32)])
    rng.shuffle(q)
    for iters, fence_on, sectors in itertools.product(
            (-1, 0, 3, 6, 9, tlk.full_iters(n)), (True, False),
            (True, False)):
        pos, _, fenced, entries = _leaf_search(keys, a8, q, lo, hi, iters,
                                               fence_on, sectors)
        raw = tlk.window_search(torch.from_numpy(keys), torch.from_numpy(q),
                                torch.from_numpy(lo).int(),
                                torch.from_numpy(hi).int(), iters)
        want = tlk._window_result(raw, torch.from_numpy(hi).int(), n)
        np.testing.assert_array_equal(pos, want.numpy())
        if iters >= 9:
            assert (entries.any() and fenced.any()) == fence_on


# ---------------------------------------------------------------------------
# The rows and the fence: builders, caching, freshness
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["linear", "mlp"])
def test_row_builders_equal_the_packed_entries(kind):
    rng = np.random.default_rng(9)
    L = 300
    w = [torch.from_numpy(rng.normal(0, 1, (L, tlk.H)).astype(_F32))
         for _ in range(3)]
    b2, elo, ehi = (torch.from_numpy(rng.normal(0, 9, L).astype(_F32))
                    for _ in range(3))
    if kind == "linear":
        w[0][:, 1:] = 0
        w[1][:] = 0
        w[2][:] = 0
    mat, vec = tlk.pack_leaves(*w, b2, elo, ehi)
    vec[3:7] = torch.from_numpy(rng.normal(0, 5, (4, mat.shape[1]))
                                .astype(_F32))
    rows = tlk.leaf_rows(mat, vec, kind)
    assert rows.is_contiguous() and rows.data_ptr() % 16 == 0
    if kind == "linear":
        want = torch.stack([mat[0], vec[0], vec[1], vec[2]], 1)
    else:
        want = torch.cat([mat.T, vec[:3].T, torch.zeros(mat.shape[1], 1)], 1)
    assert torch.equal(rows, want)
    nodes = tlk.node_rows(mat, vec, kind)
    assert nodes.is_contiguous() and nodes.data_ptr() % 16 == 0
    assert nodes.shape == (mat.shape[1], 8 if kind == "linear" else 20)
    head = mat[0] if kind == "linear" else torch.zeros(mat.shape[1])
    assert torch.equal(nodes[:, 0], head)
    assert torch.equal(nodes[:, 1:8], vec[:7].T)
    if kind == "mlp":
        assert torch.equal(nodes[:, 8:], mat.T)
    kf = torch.from_numpy(np.sort(rng.normal(0, 1, 1000)).astype(_F32))
    fence = tlk.key_fence(kf[3:])
    assert torch.equal(fence, kf[3::64]) and fence.shape == (16,)


def test_wrappers_refuse_bad_rows_and_fences():
    tabs, kf, q, kw, _ = _k1_case("lognormal")
    root, mat, vec = tabs
    qt, kt = torch.from_numpy(q), torch.from_numpy(kf)
    rows = tlk.leaf_rows(mat, vec, "linear")
    for bad in (tlk.leaf_rows(mat, vec, "mlp"), rows[:-1], rows.double(),
                torch.zeros(rows.shape[0] * 4 + 1)[1:].reshape(rows.shape),
                rows.T.contiguous().T):
        with pytest.raises(ValueError):
            tlk.lookup(qt, *tabs, kt, rows=bad, **kw)
    for bad in (tlk.key_fence(kt)[:-1], tlk.key_fence(kt).double()):
        with pytest.raises(ValueError):
            tlk.lookup(qt, *tabs, kt, fence=bad, **kw)
    with pytest.raises(ValueError):
        tlk.rmrt_lookup(qt, mat, vec, kt, fanout=2, depth=1, rows=rows)


def _spy(monkeypatch, name, seen):
    real = getattr(tlk, name)

    def spy(*a, **kw):
        seen.append((name, kw.get("rows"), kw.get("fence")))
        return real(*a, **kw)
    monkeypatch.setattr(tlk, name, spy)


def test_index_paths_pass_the_cached_rows(monkeypatch, trees):
    """``rmi.lookup`` (K1), ``DynamicRMI.find`` (K2) and ``rmrt.lookup``
    (K4) hand the wrappers the rows and fence their index caches -- the
    same tensors at every call, so no call builds them."""
    seen = []
    for name in ("lookup", "dynamic_lookup", "rmrt_lookup"):
        _spy(monkeypatch, name, seen)
    rng = np.random.default_rng(11)
    keys = np.sort(gen_keys(rng, "lognormal", 5000))
    q = rng.choice(keys, 256)
    idx = trmi.build_rmi(keys, n_leaves=32, device="cpu")
    d = TDynamicRMI.build(keys, n_leaves=32, device="cpu")
    tree = trees["linear", "lognormal"]
    for _ in range(2):
        trmi.lookup(idx, q, path="kernel")
        d.find(q, path="kernel")
        trmrt.lookup(tree, q, path="kernel")
    assert idx.key_fence is not None
    want = {"lookup": (idx.leaf_rows(), idx.key_fence),
            "dynamic_lookup": (d.index.leaf_rows(), None),
            "rmrt_lookup": (tree.node_rows(), tree.key_fence)}
    assert len(seen) == 6
    for name, rows, fence in seen:
        assert rows is want[name][0] and fence is want[name][1]


def _fresh(index):
    """The index's rows and fence as a fresh packing gives them."""
    cold = dataclasses.replace(index, _packed=None, _kf32=None)
    return cold.leaf_rows(), cold.key_fence


@pytest.mark.parametrize("kind", ["linear", "mlp"])
def test_cached_rows_fresh_after_a_rebuild(kind):
    """Rows and fence fresh after a Lemma 4.1 rebuild merges the delta tier
    into new base keys and refits leaves."""
    rng = np.random.default_rng(12)
    keys = np.unique(gen_keys(rng, "uniform", 6000).astype(_F32)
                     .astype(np.float64))
    d = TDynamicRMI.build(keys, n_leaves=32, kind=kind, train_steps=20,
                          device="cpu")
    old_rows, old_fence = d.index.leaf_rows(), d.index.key_fence
    narrow = np.unique(rng.uniform(keys[100], keys[130], 400).astype(_F32)
                       .astype(np.float64))
    d.insert_batch(narrow)
    assert d.rebuilds > 0
    rows, fence = _fresh(d.index)
    assert torch.equal(d.index.leaf_rows(), rows)
    assert d.index.leaf_rows() is not old_rows
    assert torch.equal(d.index.key_fence, fence)
    assert not torch.equal(d.index.key_fence, old_fence)
    assert torch.equal(fence, tlk.key_fence(d.index.keys_f32))
    q = rng.choice(d.live_keys(), 300)
    found, rank = d.find(q, path="kernel")
    np.testing.assert_array_equal(rank.numpy(),
                                  np.searchsorted(d.live_keys(), q))


def test_cached_rows_fresh_after_a_swap_commit():
    """A drift swap commits new leaf models: the rows go with the packed
    tables; the keys stay, and with them the f32 copy."""
    from repro_torch.core import reuse as treuse
    from repro_torch.core import synth as tsynth
    pool = treuse.build_pool(tsynth.generate_pool(0.65, ns=256, seed=1),
                             kind="linear", m_sim=64, device="cpu")
    rng = np.random.default_rng(7)
    keys = np.unique(rng.lognormal(0.0, 0.5, 8000).astype(_F32)
                     .astype(np.float64))
    d = TDynamicRMI.build(keys, pool=pool, eps=0.65, n_leaves=64,
                          swap_on_drift=True, drift_bins=64, drift_hi=0.08,
                          drift_lo=0.04, device="cpu")
    for _ in range(4):
        d.insert_batch(np.sort(rng.lognormal(1.5, 0.4, 600).astype(_F32)
                               .astype(np.float64)))
    old_rows, kf = d.index.leaf_rows(), d.index.keys_f32
    assert d.maybe_swap(np.flatnonzero(d.n_inserts > 0)) > 0
    rows, _ = _fresh(d.index)
    assert torch.equal(d.index.leaf_rows(), rows)
    assert not torch.equal(rows, old_rows)
    assert d.index.keys_f32 is kf
    assert torch.equal(rows, tlk.leaf_rows(*d.index.packed_tables()[1:],
                                           "linear"))


def test_rmrt_caches_node_rows_and_fence(trees):
    for (kind, _), tree in trees.items():
        mat, vec = tree.packed_tables()
        assert tree.node_rows() is tree.node_rows()
        assert torch.equal(tree.node_rows(), tlk.node_rows(mat, vec, kind))
        assert torch.equal(tree.key_fence, tlk.key_fence(tree.keys_f32))
        q = tree.keys_f32[::37].double()
        np.testing.assert_array_equal(
            trmrt.lookup(tree, q, path="kernel").numpy(),
            trmrt.lookup(tree, q, path="jnp").numpy())
        assert torch.equal(
            tops.rmrt_lookup(q.float(), mat, vec, tree.keys_f32,
                             fanout=tree.fanout, depth=tree.depth,
                             kind=kind, rows=tree.node_rows(),
                             fence=tree.key_fence),
            trmrt.lookup(tree, q, path="kernel"))
