"""Two-layer RMI (counterpart of ``repro.core.rmi``): linear root, linear
leaves, fresh fits.

Every per-leaf operation is batched across all leaves.  The root is linear
and so monotone, so the bucket array over sorted keys is itself sorted and
each per-leaf reduction has a scatter-free form: boundaries by
``searchsorted``, sums by cumulative-sum differences; the residual min/max
use ``scatter_reduce``, whose result does not depend on order.  Pool reuse
(Algorithm 1) and MLP models arrive with ROADMAP queue 1 item 6.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from .. import not_ported, resolve_device
from . import models
from .paths import resolve_path

_F64 = torch.float64


# ---------------------------------------------------------------------------
# Sorted-bucket per-leaf reductions.
# ---------------------------------------------------------------------------
def _bucket_bounds(buckets: torch.Tensor, n_leaves: int):
    """[start, end) of each leaf's run in non-decreasing ``buckets``
    (out-of-range buckets -- the dump bucket ``n_leaves`` -- sort past)."""
    lid = torch.arange(n_leaves, dtype=buckets.dtype, device=buckets.device)
    return (torch.searchsorted(buckets, lid),
            torch.searchsorted(buckets, lid, right=True))


def leaf_stats_sorted(keys: torch.Tensor, buckets: torch.Tensor,
                      n_leaves: int):
    """Per-leaf (count, key_min, key_max, pos_min, pos_max) for
    non-decreasing ``buckets``; empty leaves get (0, 0, 1, 0, 0)."""
    n = keys.shape[0]
    start, end = _bucket_bounds(buckets, n_leaves)
    count = (end - start).to(_F64)
    empty = count == 0
    s = start.clamp(0, n - 1)
    e = (end - 1).clamp(0, n - 1)
    zero = torch.zeros((), dtype=_F64, device=keys.device)
    kmin = torch.where(empty, zero, keys[s])
    kmax = torch.where(empty, zero + 1.0, keys[e])
    pmin = torch.where(empty, zero, start.to(_F64))
    pmax = torch.where(empty, zero, e.to(_F64))
    return count, kmin, kmax, pmin, pmax


def _segsum(v: torch.Tensor, start: torch.Tensor,
            end: torch.Tensor) -> torch.Tensor:
    """Per-leaf sums of ``v`` over [start, end) by one cumulative sum."""
    c = torch.cat([torch.zeros((1,), dtype=v.dtype, device=v.device),
                   torch.cumsum(v, 0)])
    return c[end] - c[start]


def segment_linear_fit_sorted(keys: torch.Tensor, buckets: torch.Tensor,
                              n_leaves: int) -> models.LinearParams:
    """Per-leaf least squares of position on key for non-decreasing
    ``buckets``: two-pass cumsum-difference moments (per-leaf means, then
    centred products).  Non-finite keys (capacity padding) contribute
    zero to every moment."""
    n = keys.shape[0]
    dev = keys.device
    start, end = _bucket_bounds(buckets, n_leaves)
    finite = torch.isfinite(keys)
    zero = torch.zeros((), dtype=_F64, device=dev)
    x = torch.where(finite, keys.to(_F64), zero)
    y = torch.arange(n, dtype=_F64, device=dev)
    cnt = (end - start).to(_F64)
    nn = cnt.clamp(min=1.0)
    mx = _segsum(x, start, end) / nn
    my = (start + end - 1).to(_F64) / 2.0   # mean of consecutive positions
    bc = buckets.clamp(0, n_leaves - 1).long()
    xc = torch.where(finite, x - mx[bc], zero)
    yc = torch.where(finite, y - my[bc], zero)
    sxy = _segsum(xc * yc, start, end)
    sxx = _segsum(xc * xc, start, end)
    a = torch.where(sxx.abs() > 1e-30, sxy / sxx, zero)
    b = torch.where(cnt > 0, my - a * mx, zero)
    return models.LinearParams(a=a, b=b)


def segment_residual_bounds_sorted(pred: torch.Tensor, buckets: torch.Tensor,
                                   n_leaves: int):
    """Per-leaf (min, max) of (true position - prediction); 0 on empty
    leaves.  Entries in the dump bucket ``n_leaves`` are dropped."""
    n = pred.shape[0]
    dev = pred.device
    r = torch.arange(n, dtype=_F64, device=dev) - pred
    idx = buckets.clamp(0, n_leaves).long()
    lo = torch.full((n_leaves + 1,), torch.inf, dtype=_F64, device=dev) \
        .scatter_reduce(0, idx, r, "amin")
    hi = torch.full((n_leaves + 1,), -torch.inf, dtype=_F64, device=dev) \
        .scatter_reduce(0, idx, r, "amax")
    start, end = _bucket_bounds(buckets, n_leaves)
    empty = start == end
    zero = torch.zeros((), dtype=_F64, device=dev)
    return (torch.where(empty, zero, lo[:n_leaves]),
            torch.where(empty, zero, hi[:n_leaves]))


def _sentinel_bounds(err_lo, err_hi, count, n: int):
    """Empty leaves are reachable by out-of-distribution queries: give them
    a sound full-array window."""
    return (torch.where(count > 0, err_lo, torch.full_like(err_lo, -float(n))),
            torch.where(count > 0, err_hi, torch.full_like(err_hi, float(n))))


def _leaf_predict_all(leaves: models.LinearParams, keys: torch.Tensor,
                      buckets: torch.Tensor) -> torch.Tensor:
    """Predict every key with its own leaf's model (buckets past the last
    leaf read the last leaf, as JAX's clamped gather does)."""
    b = buckets.clamp(0, leaves.a.shape[0] - 1).long()
    return leaves.a[b] * keys + leaves.b[b]


def _measure_bounds(keys, buckets, leaves, count, n_leaves: int):
    pred = _leaf_predict_all(leaves, keys, buckets)
    lo, hi = segment_residual_bounds_sorted(pred, buckets, n_leaves)
    return _sentinel_bounds(lo, hi, count, keys.shape[0])


# ---------------------------------------------------------------------------
# The index structure.
# ---------------------------------------------------------------------------
@dataclass
class RMIIndex:
    keys: torch.Tensor               # (n,) sorted f64
    root_kind: str                   # "linear"
    root: models.LinearParams
    leaf_kind: str                   # "linear"
    leaves: models.LinearParams      # stacked (L,)
    err_lo: torch.Tensor             # (L,) f64
    err_hi: torch.Tensor             # (L,) f64
    n_leaves: int
    reused_mask: torch.Tensor        # (L,) bool (always False: no pool yet)
    leaf_sim: torch.Tensor           # (L,) f64 (Lemma 4.1 input)
    # lazily derived serving state
    _iters: int | None = None        # error-window search depth
    _packed: tuple | None = None     # (root, mat, vec) kernel tables
    _f32_exact: bool | None = None   # keys round-trip through f32
    _kf32: torch.Tensor | None = None  # f32 copy of keys (kernel key space)

    @property
    def n(self) -> int:
        return int(self.keys.shape[0])

    @property
    def device(self) -> torch.device:
        return self.keys.device

    @property
    def search_iters(self) -> int:
        """Static per-query search depth bounded by the error window (§4)."""
        if self._iters is None:
            from ..kernels.lookup import search_iters
            self._iters = search_iters(self.err_lo, self.err_hi, self.n)
        return self._iters

    @property
    def keys_f32(self) -> torch.Tensor:
        """The keys in the kernel's f32 key space (cached)."""
        if self._kf32 is None:
            self._kf32 = self.keys.to(torch.float32)
        return self._kf32

    @property
    def f32_exact(self) -> bool:
        """True when every key round-trips through f32 -- the precondition
        of the kernel path, which searches and seam-verifies in f32."""
        if self._f32_exact is None:
            self._f32_exact = bool(
                (self.keys_f32.to(_F64) == self.keys).all())
        return self._f32_exact

    def packed_tables(self) -> tuple:
        """(root, mat, vec) packed f32 tables for the lookup kernels."""
        if self._packed is None:
            from ..kernels import lookup as _lk
            root = _lk.pack_root(self.root_kind, self.root)
            w1, b1, w2, b2 = _leaf_table_arrays(self.leaves, self.n_leaves)
            mat, vec = _lk.pack_leaves(w1, b1, w2, b2, self.err_lo,
                                       self.err_hi)
            self._packed = (root, mat, vec)
        return self._packed


def _leaf_table_arrays(leaves: models.LinearParams, n_leaves: int):
    """Uniform (L, H)/(L,) leaf tables: a linear leaf rides in w1[:, 0]
    and b2."""
    dev = leaves.a.device
    w1 = torch.zeros((n_leaves, models.HIDDEN), dtype=torch.float32,
                     device=dev)
    w1[:, 0] = leaves.a.to(torch.float32)
    zeros = torch.zeros_like(w1)
    return w1, zeros, zeros, leaves.b


def root_buckets(kind: str, params, keys: torch.Tensor, n_leaves: int,
                 n: int) -> torch.Tensor:
    """Leaf of each key under the root, scaled by ``n``: int32, clipped to
    [0, n_leaves - 1] after a saturating conversion (a key beyond the
    root's range lands in leaf n_leaves - 1, never in leaf 0)."""
    from ..kernels.lookup import trunc_clip
    if kind != "linear":
        raise not_ported("an MLP root", "6")
    pred = models.linear_predict(params, keys)
    return trunc_clip(pred * n_leaves / n, 0, n_leaves - 1)


class LeafFit(NamedTuple):
    """Batched per-leaf fit result (all leaves; see :func:`fit_leaves`)."""
    leaves: models.LinearParams
    reused: torch.Tensor     # (L,) bool -- Algorithm 1 pool hit
    err_lo: torch.Tensor     # (L,) sound bounds (sentinel window on empty)
    err_hi: torch.Tensor
    sim: torch.Tensor        # (L,) build-time similarity
    count: torch.Tensor      # (L,) member counts


def fit_leaves(keys: torch.Tensor, buckets: torch.Tensor, n_leaves: int,
               kind: str = "linear", pool=None, refit_mask=None,
               sorted_buckets: bool = True) -> LeafFit:
    """Fit every leaf of an RMI layer: fresh closed-form fits and measured
    residual bounds, all leaves batched.  ``refit_mask`` names the leaves
    the caller will keep (the rebuild path); without a pool every row is
    a fresh fit, so it only matters for pool selection."""
    if pool is not None:
        raise not_ported("pool reuse", "6")
    if kind != "linear":
        raise not_ported("MLP leaves", "6")
    if not sorted_buckets:
        raise not_ported("unsorted-bucket fits (non-monotone roots)", "6")
    count = leaf_stats_sorted(keys, buckets, n_leaves)[0]
    fresh = segment_linear_fit_sorted(keys, buckets, n_leaves)
    err_lo, err_hi = _measure_bounds(keys, buckets, fresh, count, n_leaves)
    dev = keys.device
    return LeafFit(leaves=fresh,
                   reused=torch.zeros((n_leaves,), dtype=torch.bool,
                                      device=dev),
                   err_lo=err_lo, err_hi=err_hi,
                   sim=torch.ones((n_leaves,), dtype=_F64, device=dev),
                   count=count)


def build_rmi(keys, n_leaves: int = 1024, kind: str = "linear",
              root_kind: str = "linear", pool=None, *,
              device=None) -> RMIIndex:
    """Build a two-layer RMI over a sorted key array, on ``device`` (CUDA
    unless ``device="cpu"``)."""
    dev = resolve_device(device)
    if pool is not None:
        raise not_ported("pool reuse", "6")
    if kind != "linear" or root_kind != "linear":
        raise not_ported("MLP roots and leaves", "6")
    keys = torch.as_tensor(keys, dtype=_F64, device=dev)
    n = keys.shape[0]
    if n == 0:
        # Empty partition: zero models and one-slot windows; every key slot
        # a consumer pads in is +inf, so any finite query resolves to 0.
        zero = torch.zeros((), dtype=_F64, device=dev)
        ones = torch.ones((n_leaves,), dtype=_F64, device=dev)
        return RMIIndex(
            keys=keys, root_kind=root_kind,
            root=models.LinearParams(a=zero, b=zero), leaf_kind=kind,
            leaves=models.LinearParams(a=torch.zeros_like(ones),
                                       b=torch.zeros_like(ones)),
            err_lo=-ones, err_hi=ones.clone(), n_leaves=n_leaves,
            reused_mask=torch.zeros((n_leaves,), dtype=torch.bool,
                                    device=dev),
            leaf_sim=ones.clone())
    root = models.linear_fit(keys, torch.arange(n, dtype=_F64, device=dev))
    buckets = root_buckets(root_kind, root, keys, n_leaves, n)
    fit = fit_leaves(keys, buckets, n_leaves, kind=kind)
    return RMIIndex(keys=keys, root_kind=root_kind, root=root, leaf_kind=kind,
                    leaves=fit.leaves, err_lo=fit.err_lo, err_hi=fit.err_hi,
                    n_leaves=n_leaves, reused_mask=fit.reused,
                    leaf_sim=fit.sim)


# ---------------------------------------------------------------------------
# Lookup: root -> leaf -> bounded branchless binary search (f64 path).
# ---------------------------------------------------------------------------
def leaf_window(leaves: models.LinearParams, err_lo, err_hi, b, q, n: int):
    """Routed-leaf predict + error-bound window clip, f64: (lo, hi) int32."""
    from ..kernels.lookup import clip_to_i32
    bl = b.long()
    pred = leaves.a[bl] * q + leaves.b[bl]
    lo = clip_to_i32(torch.floor(pred + err_lo[bl]), 0.0, float(n - 1))
    hi = clip_to_i32(torch.ceil(pred + err_hi[bl]) + 1, 1.0, float(n))
    return lo, hi


def rmi_lookup(index: RMIIndex, queries: torch.Tensor,
               iters: int | None = None) -> torch.Tensor:
    """f64 positions of ``queries`` (first index with key >= query):
    predict, clamp the window to the leaf's error bounds, search it at
    depth ``iters``, verify."""
    b = root_buckets(index.root_kind, index.root, queries, index.n_leaves,
                     index.n)
    lo, hi = leaf_window(index.leaves, index.err_lo, index.err_hi, b,
                         queries, index.n)
    return verified_search(index.keys, queries, lo, hi, iters=iters)


def bounded_search(keys, queries, lo, hi, iters: int | None = None):
    """Branchless left-boundary search of each query in keys[lo:hi) at a
    fixed depth (default the full ceil(log2 n) + 1)."""
    from ..kernels.lookup import full_iters, window_search
    iters = full_iters(keys.shape[0]) if iters is None else iters
    return window_search(keys, queries, lo, hi, iters)


def verified_search(keys, queries, lo, hi, iters: int | None = None):
    """Bounded search + seam verification: positions breaking the
    left-boundary invariant are re-searched over the whole array."""
    n = keys.shape[0]
    r = bounded_search(keys, queries, lo, hi, iters=iters)
    rc = r.clamp(0, n - 1).long()
    valid = ((r == 0) | (keys[(r - 1).clamp(0, n - 1).long()] < queries)) \
        & ((r == n) | (keys[rc] >= queries))
    if bool(valid.all()):
        return r
    full = bounded_search(keys, queries, torch.zeros_like(lo),
                          torch.full_like(hi, n))
    return torch.where(valid, r, full)


def lookup(index: RMIIndex, queries, *, path: str = "auto",
           clamp_iters: bool = True) -> torch.Tensor:
    """Serving lookup.  ``path`` (``core.paths``): ``"kernel"`` is the
    fused lookup kernel K1 in f32 key space, ``"jnp"`` the f64 plain path,
    ``"auto"`` the kernel on CUDA when the keys are f32-exact.  The kernel
    path's left boundary is defined in f32 key space: a non-member f64
    query within one f32 ulp of a key rounds onto it."""
    q = torch.as_tensor(queries, dtype=_F64, device=index.device)
    iters = index.search_iters if clamp_iters else None
    if resolve_path(path, f32_exact=lambda: index.f32_exact,
                    device=index.device):
        from ..kernels import ops
        from ..kernels.lookup import full_iters
        root, mat, vec = index.packed_tables()
        return ops.index_lookup(
            q.to(torch.float32), root, mat, vec, index.keys_f32,
            n_leaves=index.n_leaves,
            iters=iters if iters is not None else full_iters(index.n))
    return rmi_lookup(index, q, iters=iters)
