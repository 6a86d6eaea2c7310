"""Kernels K6 (streaming histogram) and K5 (per-bucket moment sums) of the
port, held against the reference at small sizes.

* K6: ``hist_plain`` (what the CUDA kernel computes, bit for bit) against
  the reference's ``ops.histogram`` in Pallas interpret mode, bit for bit,
  over the reference test's sweep plus keys outside [lo, hi], +-inf and
  NaN; the port's ``ref.hist_ref`` against the reference's oracle.
* K5: ``linfit_sums_plain`` against ``linfit_sums_pallas`` (interpret)
  within rtol 1e-6 / atol 1e-5: the port sums in f64, the TPU kernel in
  f32 tiles, so the two differ by the f32 accumulation error, well under
  1e-6 of each sum at these sizes.  Out-of-range buckets add nothing.
* ``ops.segment_linfit`` against the reference's within rtol 1e-6 on the
  slopes; the intercept ``mean_y - a * mean_x`` cancels two terms of the
  positions' magnitude, so it is compared at 1e-6 of that magnitude.  Both
  against the f64 ``segment_linear_fit`` at the reference test's rtol 5e-3.
* On a card (``gpu`` marker): each kernel against its plain version.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import repro  # noqa: F401  (enables x64 for the reference)
import jax.numpy as jnp
from repro.core import rmi as jrmi
from repro.kernels import linfit as jlinfit
from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.core import rmi as trmi
from repro_torch.kernels import hist as thist
from repro_torch.kernels import linfit as tlinfit
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _hist_keys(n, dtype, seed):
    rng = np.random.default_rng(seed)
    k = (rng.random(n) * 50 + 3).astype(dtype)
    # both edges and keys just inside and outside them
    k[:4] = np.asarray([3.0, 53.0, np.nextafter(3.0, 0), 53.5], dtype)
    return k


@pytest.mark.parametrize("n", [100, 1_000, 4_097, 20_000])
@pytest.mark.parametrize("m", [12, 64, 130])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_k6_plain_matches_pallas(n, m, dtype):
    k = _hist_keys(n, dtype, seed=n * m)
    want = np.asarray(jops.histogram(jnp.asarray(k), m, 3.0, 53.0))
    got = _np(thist.hist_plain(torch.from_numpy(k), m, 3.0, 53.0))
    np.testing.assert_array_equal(got, want)
    got = _np(tops.histogram(torch.from_numpy(k), m, 3.0, 53.0))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        _np(tref.hist_ref(torch.from_numpy(k), m, 3.0, 53.0)),
        np.asarray(jref.hist_ref(jnp.asarray(k), m, 3.0, 53.0)))


def test_k6_out_of_domain_keys_match_pallas():
    """Keys far outside [lo, hi], +-inf and NaN: XLA's saturating convert
    sends NaN to bin 0 and, through the wrapping ``- 1``, -inf and keys so
    far below ``lo`` that the conversion saturates to the last bin."""
    k = np.asarray([-np.inf, -1e30, -5.0, 0.0, 0.5, 1.0, 2.0, 1e30, np.inf,
                    np.nan, -3e9, 7e8], np.float32)
    want = np.asarray(jops.histogram(jnp.asarray(k), 8, 0.0, 1.0))
    got = _np(thist.hist_plain(torch.from_numpy(k), 8, 0.0, 1.0))
    np.testing.assert_array_equal(got, want)
    # the last bin: 1, 2, 7e8, 1e30, +inf, and -inf, -1e30, -3e9
    assert got[-1] * k.size == 8
    # a degenerate domain (hi == lo) takes the 1e-30 span floor
    k = np.asarray([1.0, 1.0, 2.0, 0.5], np.float32)
    np.testing.assert_array_equal(
        _np(thist.hist_plain(torch.from_numpy(k), 4, 1.0, 1.0)),
        np.asarray(jops.histogram(jnp.asarray(k), 4, 1.0, 1.0)))


def _linfit_inputs(n, nb, seed, oob=True):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.random(n))
    b = np.minimum((x * nb).astype(np.int32), nb - 1)
    if oob:
        b[:5] = -1                          # the TPU kernel's pad id
        b[-5:] = nb + 3                     # past the last bucket
        b[n // 2:n // 2 + 3] = nb + 600     # past the kernel's bucket tile
    y = np.arange(n, dtype=np.float64)
    return x, y, b


@pytest.mark.parametrize("n,nb", [(500, 4), (3000, 64), (6000, 513)])
def test_k5_plain_matches_pallas(n, nb):
    x, y, b = _linfit_inputs(n, nb, seed=n)
    xs = ((x - x.mean()) / x.std()).astype(np.float32)
    ys = ((y - y.mean()) / y.std()).astype(np.float32)
    want = np.asarray(jlinfit.linfit_sums_pallas(
        jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(b), nb))
    got = _np(tlinfit.linfit_sums_plain(torch.from_numpy(xs),
                                        torch.from_numpy(ys),
                                        torch.from_numpy(b), nb))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    ok = (b >= 0) & (b < nb)
    np.testing.assert_array_equal(got[:, 0], np.bincount(b[ok], minlength=nb))
    np.testing.assert_allclose(
        _np(tref.linfit_sums_ref(torch.from_numpy(xs), torch.from_numpy(ys),
                                 torch.from_numpy(b), nb)),
        np.asarray(jref.linfit_sums_ref(jnp.asarray(xs), jnp.asarray(ys),
                                        jnp.asarray(b), nb)),
        rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("n,nb,oob", [(500, 4, False), (3000, 64, True),
                                      (6000, 64, False)])
def test_segment_linfit_matches_reference(n, nb, oob):
    x, y, b = _linfit_inputs(n, nb, seed=n + 1, oob=oob)
    want = np.asarray(jops.segment_linfit(jnp.asarray(x), jnp.asarray(y),
                                          jnp.asarray(b), nb))
    got = _np(tops.segment_linfit(torch.from_numpy(x), torch.from_numpy(y),
                                  torch.from_numpy(b), nb))
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-6)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-6,
                               atol=1e-6 * float(np.abs(y).max()))
    # both against the f64 segment fit, where a bucket has two keys or more
    ok = (b >= 0) & (b < nb)
    bt = torch.from_numpy(np.where(ok, b, nb).astype(np.int32))
    p64 = trmi.segment_linear_fit(torch.from_numpy(x), bt, nb)
    j64 = jrmi.segment_linear_fit(jnp.asarray(x), jnp.asarray(b), nb)
    occupied = np.bincount(b[ok], minlength=nb) > 1
    np.testing.assert_allclose(_np(p64.a), np.asarray(j64.a), rtol=1e-9)
    for fit in (got, want):
        np.testing.assert_allclose(fit[occupied, 0], _np(p64.a)[occupied],
                                   rtol=5e-3)


def test_segment_linfit_empty_bucket():
    """A bucket without keys gets slope and intercept 0, as in the
    reference (``where(sxx > 1e-20)`` and ``where(n > 0)``)."""
    x = np.concatenate([np.linspace(1.0, 2.0, 40), np.linspace(3.0, 4.0, 60)])
    y = np.arange(100, dtype=np.float64)
    b = np.concatenate([np.zeros(40, np.int32), np.full(60, 2, np.int32)])
    want = np.asarray(jops.segment_linfit(jnp.asarray(x), jnp.asarray(y),
                                          jnp.asarray(b), 3))
    got = _np(tops.segment_linfit(torch.from_numpy(x), torch.from_numpy(y),
                                  torch.from_numpy(b), 3))
    np.testing.assert_array_equal(got[1], [0.0, 0.0])
    np.testing.assert_array_equal(want[1], [0.0, 0.0])
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-6)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-6, atol=1e-4)


@pytest.mark.gpu
def test_cuda_k5_k6_match_plain():
    """K6 bit for bit and K5 within one f32 ulp of each sum's magnitude
    (counts exact) against their plain versions on the card: sorted,
    unsorted and one-bucket keys, runs across the kernel's block edges,
    misaligned slices and no keys (the full-size check is
    chip_smoke.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(8)
    k = torch.from_numpy(rng.lognormal(0, 1, 300_001).astype(np.float32))
    k[:6] = torch.tensor([-np.inf, np.inf, np.nan, -1e30, 1e30, 0.0])
    kc = k.cuda()
    h0 = thist.LAUNCHES["hist"]
    for m in (1, 64, 130, 4096):
        got = thist.hist(kc, m, 0.5, 20.0)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), thist.hist_plain(k, m, 0.5, 20.0))
    assert thist.LAUNCHES["hist"] == h0 + 4
    x, y, b = _linfit_inputs(200_003, 777, seed=9)
    n = b.shape[0]
    xs = torch.from_numpy(x.astype(np.float32)).cuda()
    ys = torch.from_numpy((y / y.max()).astype(np.float32)).cuda()
    # (x, y, buckets, what): n = 200,003 is not a multiple of 4; runs of
    # 4,096 keys straddle every block edge of the kernel's 4,096-key blocks;
    # x[1:] with y and buckets sliced alike takes the 128-bit loads one key
    # later, with them copied (another alignment) the scalar loads
    edges = ((np.arange(n) + 2048) // 4096 % 777).astype(np.int32)
    cases = [(xs, ys, b, "sorted"), (xs, ys, rng.permutation(b), "unsorted"),
             (xs, ys, np.zeros(n, np.int32), "one bucket"),
             (xs, ys, edges, "runs across block edges")]
    l0 = tlinfit.LAUNCHES["linfit"]
    for xc, yc, bb, what in cases:
        bt = torch.from_numpy(bb).cuda()
        _assert_k5_within_ulp(xc, yc, bt, what)
        _assert_k5_within_ulp(xc[1:], yc[1:], bt[1:], what + ", x[1:]")
        _assert_k5_within_ulp(xc[1:], yc[1:].clone(), bt[1:].clone(),
                              what + ", x[1:] alone misaligned")
    assert tlinfit.LAUNCHES["linfit"] == l0 + 3 * len(cases)
    empty = torch.zeros(0, dtype=torch.float32, device="cuda")
    got = tlinfit.linfit_sums(empty, empty, empty.int(), 777)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), torch.zeros((777, 5)))
    assert tlinfit.LAUNCHES["linfit"] == l0 + 3 * len(cases)


def _assert_k5_within_ulp(xs, ys, bt, what):
    got = tlinfit.linfit_sums(xs, ys, bt, 777)
    want = tlinfit.linfit_sums_plain(xs, ys, bt, 777)
    mag = tlinfit.linfit_sums_plain(xs.abs(), ys.abs(), bt, 777)
    torch.cuda.synchronize()
    ulp = torch.nextafter(mag, torch.full_like(mag, np.inf)) - mag
    assert bool(((got - want).abs() <= ulp).all()), what
    assert torch.equal(got[:, 0], want[:, 0]), what
