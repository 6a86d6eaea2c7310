"""The search of the CUDA kernels K2 and K3 (``csrc/lookup.cu``), emulated on
the CPU step for step and held against the plain versions and the
reference.  No card is needed: the emulation walks what every lane of a warp
loads and compares, trip by trip.

* Interleaved chains: an endpoint runs its base-tier window search and its
  delta-tier probe in one loop, a trip of each a turn; a warp leaves the
  loop once no lane has a live chain, and never takes more trips than the
  static loop's ``max(iters, d_iters)``.
* Sector finish: once a live window lies in one aligned 32-byte sector (the
  array's own offset in its sector counts) that lies wholly inside the
  tier, the lane loads the sector and runs the remaining trips on the
  loaded copy -- the same midpoints, at most four (K2's two chains and K3's
  delta chain; K3's base chain takes binary trips to its end).  A window
  whose sector reaches before the tier's start or past its length takes
  binary trips, positions at or past the length reading +inf; the
  emulation fails on any sector load outside the tier.
* K3's lanes: work item 2p is the left boundary of ``q_lo[p]``, 2p + 1 the
  right boundary of ``q_hi[p]``.
* K2's leaf-major MLP rows (``lookup.leaf_rows``) give the same window as
  the lane-major tables, bit for bit.
* The planted edges of ``chip_smoke.py``: the positions its delta tiers
  duplicate and query (``_tree_positions``) are exactly what the delta
  probe's first levels visit.

Every emulated result must equal ``window_search`` / ``_window_result`` /
``full_probe`` bit for bit, on windows the static depth converges and on
windows it does not (an empty leaf's sentinel full-array window, ``iters``
cut by 8), and on small tiers the reference's eager oracles
``ref.dynamic_lookup_ref`` / ``dynamic_range_ref``.
"""
from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import repro  # noqa: F401  (enables x64 for the reference)
import jax.numpy as jnp
from repro.core.updates import DynamicRMI as JDynamicRMI
from repro.kernels import ref as jref
from torch_export import gen_keys, gen_queries

from repro_torch.core import rmi as trmi
from repro_torch.kernels import lookup as tlk

_F32 = np.float32
_INF = _F32(np.inf)
_PAST = _F32(-np.inf)          # a lane that loads no sector (never read)
_WARP = 32


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _below(kv, q, right):
    return np.where(right, kv <= q, kv < q)


def _trip(chain, keys, a8, q, right, sectors=True):
    """One trip of every lane's chain (``issue`` then ``retire``); with
    ``sectors`` false the chain takes binary trips only."""
    l, h, r = chain
    n = keys.shape[0]
    idx = np.arange(l.shape[0])
    live = (r > 0) & (h > l)
    sb = l - ((a8 + l) & 7)
    sector = live & (h - l <= 8) & (((a8 + l) >> 3) == ((a8 + h - 1) >> 3))
    sector &= sectors & (sb >= 0) & (sb + 8 <= n)
    binary = live & ~sector
    # a binary trip: the key at the midpoint
    mid = (l + h) >> 1
    kv = np.where(mid < n, keys[np.clip(mid, 0, n - 1)], _INF)
    b = _below(kv, q, right)
    l = np.where(binary & b, mid + 1, l)
    h = np.where(binary & ~b, mid, h)
    r = np.where(binary, r - 1, r)
    # a sector trip: the 8 keys at sb, all inside the tier; then up to four
    # trips on the loaded copy
    pos = sb[:, None] + np.arange(8)
    assert ((pos >= 0) & (pos < n))[sector].all()
    vals = np.where(sector[:, None], keys[np.clip(pos, 0, n - 1)], _PAST)
    for _ in range(4):
        go = sector & (r > 0) & (h > l)
        mid = (l + h) >> 1
        assert ((mid - sb)[go] >= 0).all() and ((mid - sb)[go] < 8).all()
        kv = vals[idx, np.clip(mid - sb, 0, 7)]
        b = _below(kv, q, right)
        l = np.where(go & b, mid + 1, l)
        h = np.where(go & ~b, mid, h)
        r = np.where(go, r - 1, r)
    # a window of at most 8 keys empties in at most 4 trips
    assert not (sector & (r > 0) & (h > l)).any()
    return l, h, r


def _endpoints(base, a8b, delta, a8d, x, right, lo, hi, iters, valid,
               base_sectors=True):
    """The kernel's ``endpoint`` for every lane: (base_pos, delta_pos,
    trips a warp took).  Lanes are padded to whole warps.  K2's base chain
    finishes from sectors, K3's (``base_sectors`` false) does not."""
    m = -(-x.shape[0] // _WARP) * _WARP
    pad = m - x.shape[0]

    def padded(a, v):
        return np.concatenate([a, np.full(pad, v, a.dtype)])

    x, lo, hi = padded(x, 0), padded(lo, 0), padded(hi, 0)
    right, valid = padded(right, False), padded(valid, False)
    d_iters = tlk.full_iters(delta.shape[0])
    b = (np.where(valid, lo, 0), np.where(valid, hi, 0),
         np.where(valid, iters, 0))
    d = (np.zeros(m, np.int64), np.where(valid, delta.shape[0], 0),
         np.where(valid, d_iters, 0))
    trips = np.zeros(m // _WARP, np.int64)
    while True:
        live = ((b[2] > 0) & (b[1] > b[0])) | ((d[2] > 0) & (d[1] > d[0]))
        warp = live.reshape(-1, _WARP).any(1)
        if not warp.any():
            break
        trips += warp
        b = _trip(b, base, a8b, x, right, base_sectors)
        d = _trip(d, delta, a8d, x, right)
    assert (trips <= max(iters, d_iters)).all()
    n = base.shape[0]
    bpos = np.where(b[0] < hi, b[0], np.minimum(hi, n))
    return bpos[:m - pad], d[0][:m - pad], trips


def _k2(tabs, keys, dk, q, *, n_leaves, route_n, iters, leaf_kind="linear",
        a8=(0, 0)):
    lo, hi = tlk.route_window(torch.from_numpy(q), *tabs,
                              n_keys=keys.shape[0], n_leaves=n_leaves,
                              route_n=route_n, leaf_kind=leaf_kind)
    ones = np.ones(q.shape[0], bool)
    return _endpoints(keys, a8[0], dk, a8[1], q, ~ones, lo.numpy().astype(
        np.int64), hi.numpy().astype(np.int64), iters, ones)


def _k3(tabs, keys, dk, qlo, qhi, *, n_leaves, route_n, iters,
        leaf_kind="linear", a8=(0, 0)):
    """K3's lanes: item 2p the left boundary of qlo[p], 2p + 1 the right
    boundary of qhi[p]."""
    x = np.empty(2 * qlo.shape[0], _F32)
    x[0::2], x[1::2] = qlo, qhi
    right = np.arange(x.shape[0]) % 2 == 1
    lo, hi = tlk.route_window(torch.from_numpy(x), *tabs,
                              n_keys=keys.shape[0], n_leaves=n_leaves,
                              route_n=route_n, leaf_kind=leaf_kind)
    bpos, dpos, trips = _endpoints(
        keys, a8[0], dk, a8[1], x, right, lo.numpy().astype(np.int64),
        hi.numpy().astype(np.int64), iters, np.ones(x.shape[0], bool),
        base_sectors=False)
    return bpos[0::2], bpos[1::2], dpos[0::2], dpos[1::2], trips


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------
def _tier(rng, size, source, dup_levels=12):
    """A sorted delta tier of ``size`` entries: a draw of ``source``, each
    key the probe's first ``dup_levels`` levels visit repeated at the next
    position, the last eighth +inf (as chip_smoke.py plants them)."""
    nf = size - size // 8
    x = np.sort(rng.choice(source, nf).astype(_F32))
    pos = np.asarray(_chip_smoke()._tree_positions(size, dup_levels))
    dup = pos[pos + 1 < nf]
    x[dup + 1] = x[dup]
    return np.concatenate([x, np.full(size - nf, _INF, _F32)]), pos


def _index(rng, n, n_leaves, dist="lognormal", pad=True):
    """Sorted f32 keys (n not a multiple of 8; +inf capacity pads unless
    ``pad`` is false, so that windows end at n_keys itself) and the port's
    linear index tables over them."""
    keys = np.sort(gen_keys(rng, dist, n)).astype(_F32)
    idx = trmi.build_rmi(torch.from_numpy(keys.astype(np.float64)),
                         n_leaves=n_leaves, device="cpu")
    cap = tlk.capacity_class(n) if pad else n
    kf = np.concatenate([keys, np.full(cap - n, _INF, _F32)])
    return kf, idx.packed_tables(), idx.search_iters, keys


def _queries(rng, keys, dk, tree, m=1500):
    specials = np.array([0.0, -0.0, np.inf, -np.inf, np.nan], _F32)
    return np.concatenate([
        rng.choice(keys, m // 3), dk[tree],
        rng.uniform(keys[0] - 1, keys[-1] * 1.2, m // 3).astype(_F32),
        specials]).astype(_F32)


def _plain_k2(tabs, keys, dk, q, **kw):
    return [a.numpy() for a in tlk.dynamic_lookup_plain(
        torch.from_numpy(q), *tabs, torch.from_numpy(keys),
        torch.from_numpy(dk), **kw)]


def _plain_k3(tabs, keys, dk, qlo, qhi, **kw):
    return [a.numpy() for a in tlk.dynamic_range_plain(
        torch.from_numpy(qlo), torch.from_numpy(qhi), *tabs,
        torch.from_numpy(keys), torch.from_numpy(dk), **kw)]


def _sentinel(tabs, q, n, n_leaves, route_n, count=8):
    """Tables whose leaves for the first ``count`` queries carry an empty
    leaf's sentinel bounds (+-n: a full-array window)."""
    root, mat, vec = tabs
    leaf = tlk.route_bucket(torch.from_numpy(q[:count]), root,
                            n_leaves=n_leaves, route_n=route_n).long()
    vec = vec.clone()
    vec[1, leaf], vec[2, leaf] = -float(n), float(n)
    return root, mat, vec


# ---------------------------------------------------------------------------
# The convergence bound the sector finish relies on
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("w", [1, 2, 3, 5, 7, 8, 9, 16, 100, 4097])
def test_window_empties_within_its_bit_length(w):
    """The floor midpoint leaves at most floor(w / 2) keys a trip, whatever
    each comparison says, so a window of w keys empties in bit_length(w)
    trips: at most 4 for a sector's 8."""
    rng = np.random.default_rng(w)
    worst = 0
    outcomes = (np.array(list(np.ndindex(*(2,) * w.bit_length())))
                if w <= 16 else rng.integers(0, 2, (4096, w.bit_length())))
    for seq in outcomes:
        lo, hi, t = 0, w, 0
        for below in seq:
            if hi <= lo:
                break
            mid = (lo + hi) >> 1
            lo, hi = (mid + 1, hi) if below else (lo, mid)
            t += 1
        assert hi <= lo
        worst = max(worst, t)
    assert worst <= w.bit_length()
    assert w > 8 or worst <= 4


@pytest.mark.parametrize("a8,n", [(0, 13), (0, 16), (3, 13), (3, 21),
                                  (7, 16), (7, 21), (5, 8), (1, 9)])
def test_sector_finish_stays_inside_the_tier(a8, n):
    """Every window of at most 9 keys of a tier of n keys starting a8 floats
    into its sector, with queries below, on and between the keys and past
    them: the trips equal the static loop's (``window_search``), a sector is
    loaded only when it lies inside [0, n) (``_trip`` asserts it), and
    windows at the tier's head or tail take binary trips instead."""
    keys = np.repeat(np.arange(n // 2 + 1, dtype=_F32), 2)[:n]
    pairs = [(lo, hi) for lo in range(n) for hi in range(lo + 1,
                                                          min(lo + 9, n) + 1)]
    qs = np.concatenate([np.arange(-1, n // 2 + 2, 0.5, dtype=_F32),
                         np.array([np.inf, np.nan], _F32)])
    lo = np.array([p[0] for p in pairs for _ in qs], np.int64)
    hi = np.array([p[1] for p in pairs for _ in qs], np.int64)
    q = np.tile(qs, len(pairs))
    refused = 0
    for right in (False, True):
        r = np.full(lo.shape[0], 4, np.int64)
        chain = (lo, hi, r)
        sb = lo - ((a8 + lo) & 7)
        one = ((a8 + lo) >> 3) == ((a8 + hi - 1) >> 3)
        refused += int((one & ((sb < 0) | (sb + 8 > n))).sum())
        rights = np.full(lo.shape[0], right)
        while ((chain[2] > 0) & (chain[1] > chain[0])).any():
            chain = _trip(chain, keys, a8, q, rights)
        want = tlk.window_search(torch.from_numpy(keys), torch.from_numpy(q),
                                 torch.from_numpy(lo).int(),
                                 torch.from_numpy(hi).int(), 4, right=right)
        np.testing.assert_array_equal(chain[0], want.numpy())
    assert refused > 0 or (a8 == 0 and n % 8 == 0)


# ---------------------------------------------------------------------------
# K2 and K3 emulated against the plain versions
# ---------------------------------------------------------------------------
K2_CASES = {
    # name: (key count, leaves, delta size, dist, iters cut, sentinel, a8)
    "lognormal": (20_001, 64, 1152, "lognormal", 0, False, (0, 0)),
    "dup-heavy": (9_999, 32, 4224, "dup-heavy", 0, False, (0, 0)),
    "delta 128": (3_001, 16, 128, "lognormal", 0, False, (0, 0)),
    "delta 4095": (5_003, 16, 4095, "uniform", 0, False, (0, 0)),
    "delta 2^14": (8_191, 64, 1 << 14, "lognormal", 0, False, (0, 0)),
    "iters cut by 8": (20_001, 64, 1152, "lognormal", 8, False, (0, 0)),
    "empty leaves": (20_001, 64, 1152, "lognormal", 0, True, (0, 0)),
    "empty leaves, cut": (9_999, 32, 4224, "dup-heavy", 8, True, (0, 0)),
    "unaligned tiers": (4_099, 16, 1152, "lognormal", 0, False, (3, 5)),
    "unaligned, cut": (4_099, 16, 4224, "dup-heavy", 8, True, (7, 1)),
    "unpadded keys": (20_001, 64, 1152, "lognormal", 0, False, (0, 0)),
    "unpadded, cut": (9_997, 32, 4095, "dup-heavy", 8, True, (6, 3)),
}
UNPADDED = ("unpadded keys", "unpadded, cut")


def _case(name, seed):
    n, L, size, dist, cut, sentinel, a8 = K2_CASES[name]
    rng = np.random.default_rng(seed)
    keys, tabs, iters, live = _index(rng, n, L, dist,
                                     pad=name not in UNPADDED)
    dk, tree = _tier(rng, size, live)
    q = _queries(rng, live, dk, tree)
    if sentinel:
        tabs = _sentinel(tabs, q, n, L, n)
    kw = dict(n_leaves=L, route_n=n, iters=iters - cut)
    return rng, keys, tabs, dk, q, kw, a8


@pytest.mark.parametrize("name", list(K2_CASES))
def test_k2_emulation_matches_plain(name):
    rng, keys, tabs, dk, q, kw, a8 = _case(name, 1)
    bpos, dpos, trips = _k2(tabs, keys, dk, q, a8=a8, **kw)
    want = _plain_k2(tabs, keys, dk, q, **kw)
    np.testing.assert_array_equal(bpos, want[0])
    np.testing.assert_array_equal(dpos, want[1])
    # the pieces: window_search + _window_result and full_probe
    lo, hi = tlk.route_window(torch.from_numpy(q), *tabs,
                              n_keys=keys.shape[0], n_leaves=kw["n_leaves"],
                              route_n=kw["route_n"])
    raw = tlk.window_search(torch.from_numpy(keys), torch.from_numpy(q), lo,
                            hi, kw["iters"])
    np.testing.assert_array_equal(
        bpos, tlk._window_result(raw, hi, keys.shape[0]).numpy())
    np.testing.assert_array_equal(
        dpos, tlk.full_probe(torch.from_numpy(dk), torch.from_numpy(q))
        .numpy())
    if "cut" in name or "empty" in name:
        # the planted windows are more than the depth converges
        assert bool(((hi - lo) > (1 << kw["iters"]) - 1).any())
    if name in UNPADDED:
        # windows that end at n_keys, a tail that is not a whole sector
        assert keys.shape[0] % 8 and bool((hi == keys.shape[0]).any())


@pytest.mark.parametrize("name", ["lognormal", "dup-heavy", "delta 4095",
                                  "iters cut by 8", "empty leaves, cut",
                                  "unaligned, cut", "unpadded, cut"])
def test_k3_emulation_matches_plain(name):
    rng, keys, tabs, dk, q, kw, a8 = _case(name, 2)
    qlo = q
    qhi = (q + np.abs(rng.normal(0, 0.05, q.shape[0]))).astype(_F32)
    qhi[: q.shape[0] // 16] = qlo[: q.shape[0] // 16]      # lo == hi
    qhi[q.shape[0] // 16: q.shape[0] // 8] -= 1.0           # lo > hi
    got = _k3(tabs, keys, dk, qlo, qhi, a8=a8, **kw)[:4]
    want = _plain_k3(tabs, keys, dk, qlo, qhi, **kw)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)


def test_warp_exit_and_tail_lanes():
    """A warp takes exactly as many trips as its slowest live chain needs
    (never the static depth when its lanes converge early), and lanes past
    the end of the work are inert."""
    rng, keys, tabs, dk, q, kw, _ = _case("lognormal", 3)
    q = q[: 32 * 20 + 7]                        # a ragged last warp
    bpos, dpos, trips = _k2(tabs, keys, dk, q, **kw)
    want = _plain_k2(tabs, keys, dk, q, **kw)
    np.testing.assert_array_equal(bpos, want[0])
    np.testing.assert_array_equal(dpos, want[1])
    # per lane: the trips its two chains take, interleaved, is the larger
    lo, hi = tlk.route_window(torch.from_numpy(q), *tabs,
                              n_keys=keys.shape[0], n_leaves=kw["n_leaves"],
                              route_n=kw["route_n"])
    lane = np.zeros(q.shape[0], np.int64)
    for i in range(q.shape[0]):
        one = lambda a: a[i:i + 1]              # noqa: E731
        _, _, t = _endpoints(keys, 0, dk, 0, one(q), np.zeros(1, bool),
                             one(lo.numpy().astype(np.int64)),
                             one(hi.numpy().astype(np.int64)), kw["iters"],
                             np.ones(1, bool))
        lane[i] = t[0]
    pad = np.concatenate([lane, np.zeros(-lane.shape[0] % 32, np.int64)])
    np.testing.assert_array_equal(trips, pad.reshape(-1, 32).max(1))
    assert trips.max() <= max(kw["iters"], tlk.full_iters(dk.shape[0]))


# ---------------------------------------------------------------------------
# K2's leaf-major MLP rows
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1])
def test_leaf_rows_give_the_lane_major_window(seed):
    """``route_window_rows`` on ``leaf_rows`` (the same f32 steps) equals
    ``lane_predict`` + ``lane_window`` on the lane-major tables."""
    rng = np.random.default_rng(seed)
    L, n = 200, 50_000
    w = [torch.from_numpy(rng.normal(0, s, (L, 4)).astype(_F32))
         for s in (1.0, 2.0, 3.0)]
    b2, elo, ehi = (torch.from_numpy(rng.normal(m, 40, L).astype(_F32))
                    for m in (n / 2, -30, 30))
    mat, vec = tlk.pack_leaves(*w, b2, elo, ehi)
    rows = tlk.leaf_rows(mat, vec)
    assert rows.shape == (mat.shape[1], 16) and rows.is_contiguous()
    q = torch.from_numpy(rng.normal(0, 3, 4096).astype(_F32))
    j = torch.from_numpy(rng.integers(0, L, 4096))
    r = rows[j]
    pred = r[:, 12]
    for k in range(4):
        pred = pred + tlk.relu(q * r[:, k] + r[:, 4 + k]) * r[:, 8 + k]
    lo = tlk.clip_to_i32(torch.floor(pred + r[:, 13]), 0.0, tlk._f32(n - 1))
    hi = tlk.clip_to_i32(torch.ceil(pred + r[:, 14]) + 1.0, 1.0,
                         tlk._f32(n))
    want = tlk.lane_window(tlk.lane_predict(q, mat, vec, j, "mlp"), vec, j, n)
    np.testing.assert_array_equal(lo.numpy(), want[0].numpy())
    np.testing.assert_array_equal(hi.numpy(), want[1].numpy())
    assert bool((rows[:, 15] == 0).all())


# ---------------------------------------------------------------------------
# chip_smoke.py's planted delta-probe keys
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("nd,levels", [
    (128, 7), (128, 12), (1152, 10), (1152, 12), (4095, 11), (4095, 12),
    (4096, 12), (4224, 12), (1 << 14, 12), (1 << 14, 14), (1152, 1)])
def test_tree_positions_are_the_probe_midpoints(nd, levels):
    """``_tree_positions(nd, levels)`` lists, in level order, exactly the
    positions the delta probe's first ``levels`` trips read over queries
    that reach every node (one between each pair of keys); F up to
    floor(log2 nd) keeps every window of the tree non-empty."""
    tree = _chip_smoke()._tree_positions(nd, levels)
    dk = np.arange(nd, dtype=_F32) * 2
    q = np.arange(-1, 2 * nd + 1, dtype=_F32)   # below, on and between keys
    l, h = np.zeros(q.shape[0], np.int64), np.full(q.shape[0], nd)
    seen, order = set(), []
    for _ in range(levels):
        live = h > l
        mid = (l + h) >> 1
        for m in sorted(set(mid[live].tolist()) - seen):
            seen.add(m)
        order += sorted(set(mid[live].tolist()))
        below = dk[np.clip(mid, 0, nd - 1)] < q
        l = np.where(live & below, mid + 1, l)
        h = np.where(live & ~below, mid, h)
    assert sorted(tree) == sorted(seen)
    assert tree == order
    assert len(set(tree)) == len(tree)
    if levels <= int(math.log2(nd)):
        assert len(tree) == (1 << levels) - 1


# ---------------------------------------------------------------------------
# Against the reference's eager oracles on small tiers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dist", ["lognormal", "dup-heavy", "uniform"])
def test_emulation_matches_reference_oracles(dist):
    rng = np.random.default_rng(7)
    keys = gen_keys(rng, dist, 4096)
    d = JDynamicRMI.build(jnp.asarray(keys), n_leaves=64)
    d.insert_batch(rng.choice(keys, 300))                      # duplicates
    d.insert_batch(rng.uniform(keys[0], keys[-1], 500)
                   .astype(np.float32).astype(np.float64))
    q = gen_queries(rng, d.live_keys(), 512)
    idx = d.index
    root, mat, vec = idx.packed_tables()
    kw = dict(n_leaves=64, route_n=d.route_n, iters=idx.search_iters)
    tabs = tuple(torch.from_numpy(np.array(a, _F32)) for a in (root, mat,
                                                                vec))
    kf = np.array(idx.keys, _F32)
    dk = tlk.pad_delta(torch.from_numpy(np.array(d.delta_keys, _F32)))
    qf = q.astype(_F32)
    bpos, dpos, _ = _k2(tabs, kf, dk.numpy(), qf, a8=(5, 2), **kw)
    want = jref.dynamic_lookup_ref(jnp.asarray(q), root, mat, vec, idx.keys,
                                   d.delta_keys, **kw)
    np.testing.assert_array_equal(bpos, np.asarray(want[0]))
    np.testing.assert_array_equal(dpos, np.asarray(want[1]))
    hi = (q + np.abs(rng.normal(0, 50, q.shape[0]))).astype(np.float32) \
        .astype(np.float64)
    got = _k3(tabs, kf, dk.numpy(), qf, hi.astype(_F32), a8=(1, 6), **kw)
    want = jref.dynamic_range_ref(jnp.asarray(q), jnp.asarray(hi), root, mat,
                                  vec, idx.keys, d.delta_keys, **kw)
    for g, w in zip(got[:4], want, strict=True):
        np.testing.assert_array_equal(g, np.asarray(w))
