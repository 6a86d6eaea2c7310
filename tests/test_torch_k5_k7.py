"""The index arithmetic of the CUDA kernels K7 (``csrc/ksdist.cu``) and K5
(``csrc/linfit.cu``), emulated on the CPU step for step and held against
the plain versions and the reference.  No card is needed: each emulation
walks the order in which the kernel reads, sums and writes.

* K7's table kernel: one thread a row, XLA's cumsum order level by level,
  the level totals kept in the A_T row until the last (descending) pass
  overwrites them.  Its f32 tables must equal ``target_tables`` /
  ``cdf.exclusive_prefix`` bit for bit (compared as bit patterns, so the
  sign of zero counts) for m from 1 to 4,096, from f32 and f64 input, and
  the tables ``ksdist_pallas`` builds (JAX on the CPU, interpret mode),
  through its distances.
* K7's distance kernel on finite tables: the maximum over the terms' f32
  bit patterns read as int32 (a Hopper three-way integer max), started at
  +0 and recomputed in f32 where it stays there, equals the f32 maximum
  bit for bit.
* K5's partition: blocks of 4,096 keys numbered from the arrays' common
  16-byte alignment, 16 keys a thread, runs of equal buckets flushed inside
  a thread, joined across threads by the warp shuffle scan and the carry
  across warps.  Every key with an in-range bucket must be added exactly
  once, and the sums must equal ``linfit_sums_plain`` within one f32 ulp
  of each sum's magnitude (the kernel's f64 sums differ from the plain
  version's only in order).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import repro  # noqa: F401  (enables x64 for the reference)
import jax.numpy as jnp
from repro.core import reuse as jreuse
from repro.kernels import ksdist as jksdist

from repro_torch.core import cdf as tcdf
from repro_torch.kernels import ksdist as tks
from repro_torch.kernels import linfit as tlinfit

_F32 = np.float32
_BLOCK = 16


# ---------------------------------------------------------------------------
# K7: the table kernel's order
# ---------------------------------------------------------------------------
def _tables_walk(h):
    """(A_T, P_T) as ``ksdist_tables_kernel`` computes them.  Each column
    operation is the f32 operation every thread does on its own row;
    unwritten slots hold NaN, so a read before a write shows."""
    x = np.asarray(h).astype(_F32)            # __double2float_rn
    L, m = x.shape
    a = np.full((L, m), np.nan, _F32)          # level totals, then A_T
    p = np.full((L, m), np.nan, _F32)          # level-0 sums, then P_T
    zero = np.zeros(L, _F32)

    def local_sums(src, dst, w, tot):
        for j0 in range(0, w, _BLOCK):
            v = [src[:, j0 + t].copy() if j0 + t < w else zero
                 for t in range(_BLOCK)]
            s = v[0]
            dst[:, j0] = s
            for t in range(1, _BLOCK):
                s = s + v[t]
                if j0 + t < w:
                    dst[:, j0 + t] = s
            if tot is not None:
                tot[:, j0 // _BLOCK] = s

    off, wid = [0], [m]
    local_sums(x, p, m, a if m > _BLOCK else None)
    while wid[-1] > _BLOCK:
        w = -(-wid[-1] // _BLOCK)
        o = 0 if len(wid) == 1 else off[-1] + wid[-1]
        off.append(o)
        wid.append(w)
        lvl = a[:, o:o + w]
        local_sums(lvl, lvl, w,
                   a[:, o + w:o + w + -(-w // _BLOCK)] if w > _BLOCK
                   else None)
    depth = len(wid) - 1
    for d in range(depth - 1, 0, -1):
        cur, up = a[:, off[d]:], a[:, off[d + 1]:]
        for k in range(wid[d]):
            j = k // _BLOCK
            cur[:, k] = cur[:, k] + (zero if j == 0 else up[:, j - 1])
    up = a[:, off[1]:] if depth > 0 else None
    for k in range(m - 1, -1, -1):
        e = zero
        if k > 0:
            e = p[:, k - 1].copy()
            if depth > 0:
                j = (k - 1) // _BLOCK
                e = e + (zero if j == 0 else up[:, j - 1])
        p[:, k] = e
        a[:, k] = x[:, k] + e
    return a, p


def _hists(L, m, dtype, seed, ieee_edges=True):
    """(L, m) histograms with an empty row and a row near the f32 maximum;
    with ``ieee_edges`` also signed zeros and f32 subnormals, which the
    kernel and the plain version keep but XLA:CPU does not (it flushes
    subnormals to zero and starts its cumsum from +0).  Real histograms
    hold 0 or at least 1/n, so neither edge reaches the reference."""
    rng = np.random.default_rng(seed)
    h = rng.random((L, m)) ** 3
    h /= h.sum(1, keepdims=True)
    h[0] = 0.0                                  # an empty leaf
    h[3] *= 1e30
    if ieee_edges:
        h[1, ::2] = -0.0                        # signed zeros
        h[2] *= 1e-40                           # f32 subnormals
    return h.astype(dtype)


def _bits(a):
    return np.asarray(a, _F32).view(np.uint32)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m", [1, 15, 16, 17, 64, 100, 256, 257, 4096])
def test_k7_table_walk_matches_target_tables(m, dtype):
    h = _hists(37, m, dtype, seed=m)
    ta, pt = _tables_walk(h)
    want_a, want_p = tks.target_tables(torch.from_numpy(h))
    np.testing.assert_array_equal(_bits(ta), _bits(want_a.numpy()))
    np.testing.assert_array_equal(_bits(pt), _bits(want_p.numpy()))
    ex = tcdf.exclusive_prefix(torch.from_numpy(h.astype(_F32)))
    np.testing.assert_array_equal(_bits(pt), _bits(ex.numpy()))
    got_a, got_p = tks.tables(torch.from_numpy(h))     # the CPU route
    np.testing.assert_array_equal(_bits(got_a.numpy()), _bits(ta))
    np.testing.assert_array_equal(_bits(got_p.numpy()), _bits(pt))


@pytest.mark.parametrize("m", [17, 64])
def test_k7_table_walk_non_finite_rows(m):
    """NaN and infinities run through the same order (compared with NaN
    equal to NaN)."""
    h = _hists(9, m, np.float64, seed=3)
    h[4, 5] = np.nan
    h[5, m - 1] = np.inf
    h[6, 0] = -np.inf
    h[7, 3], h[7, m - 2] = np.inf, -np.inf
    with np.errstate(invalid="ignore"):
        ta, pt = _tables_walk(h)
    want_a, want_p = tks.target_tables(torch.from_numpy(h))
    np.testing.assert_array_equal(ta, want_a.numpy())
    np.testing.assert_array_equal(pt, want_p.numpy())
    assert np.isnan(ta[4, 5:]).all() and not np.isnan(ta[4, :5]).any()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m", [12, 64, 100])
def test_k7_table_walk_matches_ksdist_pallas(m, dtype):
    """The walk's tables against the ones ``ksdist_pallas`` builds from
    ``jnp.cumsum``: directly (its two lines) and through its distances in
    interpret mode, which equal the plain distance of the walk's tables."""
    rng = np.random.default_rng(m + 1)
    th = _hists(70, m, dtype, seed=m + 2, ieee_edges=False)
    ph = rng.random((50, m)) ** 3
    ph /= ph.sum(1, keepdims=True)
    ta, pt = _tables_walk(th)
    ht = jnp.asarray(th).astype(jnp.float32)
    jpt = jnp.concatenate([jnp.zeros((ht.shape[0], 1), jnp.float32),
                           jnp.cumsum(ht, 1)[:, :-1]], 1)
    np.testing.assert_array_equal(_bits(pt), _bits(jpt))
    np.testing.assert_array_equal(_bits(ta), _bits(ht + jpt))
    pa, pps = jreuse.pool_prefix_tables(jnp.asarray(ph))
    want = np.asarray(jksdist.ksdist_pallas(jnp.asarray(th), pa, pps,
                                            interpret=True))
    got = tks.distance_plain(torch.from_numpy(ta), torch.from_numpy(pt),
                             torch.from_numpy(np.asarray(pa)),
                             torch.from_numpy(np.asarray(pps)))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def _distance_keys(ta, pt, pa, pps):
    """The distance kernel's integer path on finite tables: each term's f32
    bit pattern as int32, the maximum from a start of 0 (the pattern of
    +0), and an f32 maximum of the terms wherever that stays 0."""
    ta, pt, pa, pps = (np.asarray(a, _F32) for a in (ta, pt, pa, pps))
    with np.errstate(over="ignore"):
        up = pa[None, :, :] - pt[:, None, :]
        dn = ta[:, None, :] - pps[None, :, :]
    keys = np.maximum(up.view(np.int32).max(2), dn.view(np.int32).max(2))
    r = np.maximum(keys, 0).view(_F32)
    exact = np.maximum(up.max(2), dn.max(2))
    return np.where(keys <= 0, exact, r), keys <= 0


@pytest.mark.parametrize("case", ["histograms", "zero_rows", "negative",
                                  "overflow"])
def test_k7_integer_max_path_is_exact(case):
    """Where every operand is finite the kernel takes the maximum over the
    terms' bit patterns; that must equal the f32 maximum bit for bit,
    including outputs at or below +0 (recomputed) and terms that overflow
    to +-inf."""
    rng = np.random.default_rng(sum(map(ord, case)))
    th = _hists(40, 64, np.float64, seed=5, ieee_edges=False)
    ph = _hists(30, 64, np.float64, seed=6, ieee_edges=False)
    if case == "zero_rows":
        th[5] = ph[7] = 0.0
        th[6, ::3] = -0.0
    elif case == "negative":
        th[::2] *= -1.0
        ph[1::3] -= rng.random(64)
    elif case == "overflow":
        th[4, 0] = 3e38
        ph[2, 0] = -3e38
    ta, pt = tks.target_tables(torch.from_numpy(th))
    pa, pps = tks.target_tables(torch.from_numpy(ph))
    assert np.isfinite(ta.numpy()).all() and np.isfinite(pa.numpy()).all()
    got, recomputed = _distance_keys(ta, pt, pa, pps)
    want = tks.distance_plain(ta, pt, pa, pps).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    if case == "zero_rows":
        assert recomputed[5, 7]
    if case == "overflow":
        assert np.isinf(want).any()


# ---------------------------------------------------------------------------
# K5: the kernel's partition of keys into runs
# ---------------------------------------------------------------------------
K5_THREADS, K5_PER = 256, 16
K5_CHUNK = K5_THREADS * K5_PER


class _Run:
    """A run's partial moments and the keys it holds (first, last)."""

    __slots__ = ("m", "lo", "hi")

    def __init__(self, m, lo, hi):
        self.m, self.lo, self.hi = m, lo, hi

    @staticmethod
    def zero():
        return _Run(np.zeros(5), None, None)

    @staticmethod
    def key(i, x, y):
        xv, yv = float(x), float(y)
        return _Run(np.array([1.0, xv, yv, xv * yv, xv * xv]), i, i)

    def join(self, later):
        """``join(earlier, later)``: the keys must be adjacent."""
        if self.lo is None:
            return _Run(self.m + later.m, later.lo, later.hi)
        if later.lo is None:
            return _Run(self.m + later.m, self.lo, self.hi)
        assert self.hi + 1 == later.lo, (self.lo, self.hi, later.lo)
        return _Run(self.m + later.m, self.lo, later.hi)


def _k5_emulate(x, y, b, nb, offsets):
    """(sums (nb, 5) f64, times each key was added) as ``linfit_kernel``
    computes them for arrays whose element offsets inside their 16-byte
    groups are ``offsets`` (x, y, buckets), as the host code reads them
    from the pointers."""
    n = len(x)
    vec = len(set(offsets)) == 1
    off = offsets[0] if vec else 0
    sums = np.zeros((nb, 5))
    cover = np.zeros(n, np.int64)

    def flush(bk, r):
        if bk < 0 or bk >= nb or r.m[0] == 0:
            return
        sums[bk] += r.m
        cover[r.lo:r.hi + 1] += 1

    blocks = -(-(n + off) // K5_CHUNK) if n > 0 else 0
    for blk in range(blocks):
        head_b, tail_b, split, head, cur = [], [], [], [], []
        for t in range(K5_THREADS):
            i0 = blk * K5_CHUNK + t * K5_PER - off
            if vec and i0 >= 0 and i0 + K5_PER <= n:
                # 128-bit loads: x + i0 must sit on a 16-byte boundary
                assert (offsets[0] + i0) % 4 == 0
            ks = [(i, b[i] if 0 <= i < n else -1,
                   x[i] if 0 <= i < n else 0.0, y[i] if 0 <= i < n else 0.0)
                  for i in range(i0, i0 + K5_PER)]
            hb = ks[0][1]
            sp, hd = False, _Run.zero()
            c, cb = _Run.key(ks[0][0], ks[0][2], ks[0][3]), hb
            for i, bk, xv, yv in ks[1:]:
                k = _Run.key(i, xv, yv)
                if bk == cb:
                    c = c.join(k)
                else:
                    if sp:
                        flush(cb, c)
                    else:
                        hd = c
                    sp, c, cb = True, k, bk
            head_b.append(hb)
            tail_b.append(cb)
            split.append(sp)
            head.append(hd)
            cur.append(c)
        tid = range(K5_THREADS)
        joins_prev = [t > 0 and head_b[t] == tail_b[t - 1] for t in tid]
        ends_here = [t == K5_THREADS - 1 or head_b[t + 1] != tail_b[t]
                     for t in tid]
        reset = [split[t] or not joins_prev[t] for t in tid]
        c = list(cur)
        # the warp shuffle scan (Kogge-Stone, 5 rounds) ...
        for w0 in range(0, K5_THREADS, 32):
            o = 1
            while o < 32:
                prev_c = c[w0:w0 + 32]
                prev_r = reset[w0:w0 + 32]
                for lane in range(o, 32):
                    t = w0 + lane
                    if not prev_r[lane]:
                        c[t] = prev_c[lane - o].join(prev_c[lane])
                    reset[t] = prev_r[lane] or prev_r[lane - o]
                o <<= 1
        # ... then the carry across warps
        carry, before = _Run.zero(), [None] * K5_THREADS
        for w0 in range(0, K5_THREADS, 32):
            w_last_c, w_last_r = c[w0 + 31], reset[w0 + 31]
            for lane in range(32):
                t = w0 + lane
                if not reset[t]:
                    c[t] = carry.join(c[t])
            before[w0] = carry
            for lane in range(1, 32):
                before[w0 + lane] = c[w0 + lane - 1]
            carry = w_last_c if w_last_r else carry.join(w_last_c)
        for t in tid:
            if split[t]:
                flush(head_b[t],
                      before[t].join(head[t]) if joins_prev[t] else head[t])
            if ends_here[t]:
                flush(tail_b[t], c[t])
    return sums, cover


def _k5_case(case, rng):
    n = {"tiny": 13, "block_edges": 3 * K5_CHUNK + 5}.get(case, 20_011)
    nb = 97
    x = rng.standard_normal(n).astype(_F32)
    y = rng.standard_normal(n).astype(_F32)
    b = np.sort(rng.integers(0, nb, n)).astype(np.int32)
    offsets = (0, 0, 0)
    if case == "permuted":
        b = rng.permutation(b)
    elif case == "one_bucket":
        b[:] = 5
    elif case == "out_of_range":
        b[:7] = -1
        b[-9:] = nb + 2
        b[n // 2:n // 2 + 40] = -3
    elif case == "block_edges":
        # a run crossing every block edge
        b = ((np.arange(n) + K5_CHUNK // 2) // K5_CHUNK).astype(np.int32)
    elif case == "thread_edges":
        b = ((np.arange(n) + 8) // 16 % nb).astype(np.int32)
    elif case in ("offset1", "offset3"):
        offsets = (int(case[-1]),) * 3
    elif case == "mixed_alignment":
        offsets = (1, 0, 1)
    return x, y, b, nb, offsets


@pytest.mark.parametrize("case", ["sorted", "permuted", "one_bucket",
                                  "out_of_range", "block_edges",
                                  "thread_edges", "offset1", "offset3",
                                  "mixed_alignment", "tiny"])
def test_k5_partition_covers_each_key_once(case):
    rng = np.random.default_rng(sum(map(ord, case)))
    x, y, b, nb, offsets = _k5_case(case, rng)
    sums, cover = _k5_emulate(x, y, b, nb, offsets)
    ok = (b >= 0) & (b < nb)
    np.testing.assert_array_equal(cover, ok.astype(np.int64))
    xt, yt, bt = (torch.from_numpy(a) for a in (x, y, b))
    want = tlinfit.linfit_sums_plain(xt, yt, bt, nb).numpy()
    mag = tlinfit.linfit_sums_plain(xt.abs(), yt.abs(), bt, nb).numpy()
    got = sums.astype(_F32)
    ulp = np.nextafter(mag, np.inf) - mag
    assert (np.abs(got - want) <= ulp).all()
    np.testing.assert_array_equal(got[:, 0],
                                  np.bincount(b[ok], minlength=nb))
