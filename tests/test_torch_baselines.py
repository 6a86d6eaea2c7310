"""The paper's baselines in the port (``core.btree``, ``core.pgm``,
``core.radix_spline``) held against the reference, bit for bit.

* Build arrays: B+tree levels, PGM segment keys / slopes / intercepts per
  level, RadixSpline points and radix table, key bounds; and ``height``,
  ``n_segments``, ``size_bytes``.  The host build loops are the
  reference's, so every array is equal.
* Positions: equal to the reference's jitted ``lookup`` and to
  ``np.searchsorted(..., "left")`` on members, non-members, keys below the
  first and above the last, +-0, +-inf and huge finite values; NaN is held
  against the reference only (its rank is 0 in both).
* Windows: the +-eps window before the verified search, saturate-then-wrap
  int32 arithmetic included, against the reference's ops run eagerly
  (``jax.disable_jit``).  The jitted reference contracts
  ``slope * q + icept`` and ``y0 + t * (y1 - y0)`` into an FMA on XLA:CPU,
  which the port never does, so its windows are not held.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import repro  # noqa: F401  (enables x64 for the reference)
import jax
import jax.numpy as jnp
from repro.core import btree as jbtree
from repro.core import pgm as jpgm
from repro.core import radix_spline as jrs

from repro_torch.core import btree as tbtree
from repro_torch.core import pgm as tpgm
from repro_torch.core import radix_spline as trs

DISTS = ("lognormal", "dup-heavy", "int-uniform")
# every key set at 4,096 and 65,537 keys; the tiny sets (1, 2, 16 and 17
# keys; dup-heavy ones under 50 keys hold one key value) on two of them
CASES = ([("lognormal", n) for n in (1, 2, 16, 17)]
         + [("dup-heavy", n) for n in (2, 17)]
         + [(d, n) for d in DISTS for n in (4096, 65537)])
FANOUTS = (4, 16, 64)
PGM_EPS = (8, 32, 64)
RS_CASES = ((16, 8), (16, 12), (32, 8), (32, 12))


def _keys(dist: str, n: int) -> np.ndarray:
    rng = np.random.default_rng(DISTS.index(dist) * 1_000_003 + n)
    if dist == "lognormal":
        raw = rng.lognormal(0.0, 1.0, n)
    elif dist == "dup-heavy":
        raw = rng.choice(rng.uniform(0.0, 1e3, max(n // 50, 1)), n)
    else:
        raw = np.floor(rng.uniform(0.0, 4.0 * n, n))
    return np.sort(raw.astype(np.float32).astype(np.float64))


def _queries(keys: np.ndarray) -> np.ndarray:
    rng = np.random.default_rng(keys.size)
    lo, hi = keys[0], keys[-1]
    span = max(hi - lo, 1.0)
    return np.concatenate([
        rng.choice(keys, 300),                              # members
        rng.uniform(lo - 0.1 * span, hi + 0.1 * span, 300),  # non-members
        (keys[:-1] + keys[1:])[:50] / 2,
        [lo - 1.0, hi + 1.0, lo - 1e6, hi + 1e6, 0.0, -0.0, np.inf,
         -np.inf, 1e300, -1e300, np.nan]])


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _check_positions(got, want, keys, q):
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert _np(got).dtype == np.int32
    ok = ~np.isnan(q)
    np.testing.assert_array_equal(_np(got)[ok],
                                  np.searchsorted(keys, q[ok], "left"))


def _eager_window(module, fn, args):
    """The (lo, hi) the reference hands its final verified search, with
    every op run eagerly."""
    seen = []
    real = module.verified_search

    def capture(keys, queries, lo, hi, iters=None):
        seen.append((np.asarray(lo), np.asarray(hi)))
        return real(keys, queries, lo, hi, iters=iters)

    module.verified_search = capture
    try:
        with jax.disable_jit():
            fn(*args)
    finally:
        module.verified_search = real
    (lo, hi), = seen
    return lo, hi


def _check_btree(keys, fanouts):
    q = _queries(keys)
    for fanout in fanouts:
        j = jbtree.build_btree(jnp.asarray(keys), fanout)
        t = tbtree.build_btree(keys, fanout, device="cpu")
        assert t.height == j.height and t.n == j.n == keys.size
        for a, b in zip(t.levels, j.levels, strict=True):
            np.testing.assert_array_equal(_np(a), np.asarray(b))
        _check_positions(tbtree.lookup(t, q),
                         jbtree.lookup(j, jnp.asarray(q)), keys, q)


@pytest.mark.parametrize("dist,n", CASES)
def test_btree_matches_reference(dist, n):
    _check_btree(_keys(dist, n), FANOUTS)


@pytest.mark.parametrize("fanout", FANOUTS)
def test_btree_at_its_fanout(fanout):
    """1, 2, fanout and fanout + 1 keys: no level, and the first level."""
    for n in (1, 2, fanout, fanout + 1):
        _check_btree(_keys("lognormal", n), (fanout,))


@pytest.mark.parametrize("dist,n", CASES)
def test_pgm_matches_reference(dist, n):
    keys = _keys(dist, n)
    q = _queries(keys)
    for eps in PGM_EPS:
        j = jpgm.build_pgm(jnp.asarray(keys), eps)
        t = tpgm.build_pgm(keys, eps, device="cpu")
        assert t.n_segments == j.n_segments and t.n == j.n
        for name in ("seg_keys", "seg_slope", "seg_icept"):
            for a, b in zip(getattr(t, name), getattr(j, name), strict=True):
                assert a.dtype == torch.float64
                np.testing.assert_array_equal(_np(a), np.asarray(b))
        _check_positions(tpgm.lookup(t, q), jpgm.lookup(j, jnp.asarray(q)),
                         keys, q)
        lo, hi = tpgm._pgm_window(t, torch.from_numpy(q))
        want = _eager_window(jpgm, jpgm._pgm_lookup, (
            j.keys, tuple(j.seg_keys), tuple(j.seg_slope),
            tuple(j.seg_icept), eps, jnp.asarray(q)))
        np.testing.assert_array_equal(_np(lo), want[0])
        np.testing.assert_array_equal(_np(hi), want[1])


@pytest.mark.parametrize("dist,n", CASES)
def test_radix_spline_matches_reference(dist, n):
    keys = _keys(dist, n)
    q = _queries(keys)
    for eps, bits in RS_CASES:
        j = jrs.build_rs(jnp.asarray(keys), eps, bits)
        t = trs.build_rs(keys, eps, bits, device="cpu")
        assert (t.key_min, t.key_max) == (j.key_min, j.key_max)
        assert t.size_bytes == j.size_bytes
        for name in ("spline_x", "spline_y", "radix_table"):
            a, b = getattr(t, name), np.asarray(getattr(j, name))
            assert _np(a).dtype == b.dtype, name
            np.testing.assert_array_equal(_np(a), b)
        _check_positions(trs.lookup(t, q), jrs.lookup(j, jnp.asarray(q)),
                         keys, q)
        lo, hi = trs._rs_window(t, torch.from_numpy(q))
        want = _eager_window(jrs, jrs._rs_lookup, (
            j.keys, j.spline_x, j.spline_y, j.radix_table, bits, eps,
            j.key_min, j.key_max, jnp.asarray(q)))
        np.testing.assert_array_equal(_np(lo), want[0])
        np.testing.assert_array_equal(_np(hi), want[1])


def test_eps_window_saturates_then_wraps():
    """``pred.astype(int32) -/+ offset`` then the clip, as XLA computes it:
    out-of-range and infinite predictions saturate to the int32 extremes,
    NaN converts to 0, and the offset then wraps (INT32_MIN - eps turns
    positive, so a -inf prediction gives the empty window (m - 1, 1))."""
    big = 2.0 ** 31
    pred = np.array([-np.inf, np.inf, np.nan, -1e300, 1e300, big, big - 1,
                     big - 0.5, -big, -big - 1, -big + 0.5, -0.7, 0.7,
                     -64.5, 63.9, 5.5, 1e9, -1e9, 0.0, -0.0])
    for eps, m in ((8, 1), (64, 100), (64, 5000), (1, 2 ** 31 - 1)):
        lo, hi = tpgm.eps_window(torch.from_numpy(pred), eps, m)
        p = jnp.asarray(pred).astype(jnp.int32)
        np.testing.assert_array_equal(_np(lo),
                                      np.asarray(jnp.clip(p - eps, 0, m - 1)))
        np.testing.assert_array_equal(
            _np(hi), np.asarray(jnp.clip(p + eps + 2, 1, m)))
    lo, hi = tpgm.eps_window(torch.tensor([-np.inf]), 64, 100)
    assert (int(lo[0]), int(hi[0])) == (99, 1)


def test_baselines_run_on_the_requested_device():
    keys = _keys("lognormal", 4096)
    for build in (tbtree.build_btree, tpgm.build_pgm, trs.build_rs):
        idx = build(keys, device="cpu")
        assert idx.keys.device.type == "cpu"
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                build(keys)
