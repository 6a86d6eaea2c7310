"""Two-layer RMI with optional agile model reuse (counterpart of
``repro.core.rmi``; paper §3, Fig. 3).

Variants (the paper's roster):
  RMI        root + leaves linear, fresh fits          build_rmi(kind="linear")
  RMI-NN     root linear, leaves 1x4 MLP, fresh        build_rmi(kind="mlp")
  RMI-MR     linear leaves, pool reuse                 build_rmi(..., pool=linear_pool)
  RMI-NN-MR  MLP leaves, pool reuse                    build_rmi(..., pool=mlp_pool)

Every per-leaf operation is batched across all leaves: segment statistics,
similarity histograms, pool selection (kernel K7 on CUDA), affine
adaptation, MLP training of the leaves the pool misses, residual bounds.
With a linear (monotone) root the bucket array over sorted keys is itself
sorted and the per-leaf reductions take a scatter-free form (boundaries by
``searchsorted``, sums by cumulative-sum differences); an MLP root takes
the unsorted forms (``bincount``, ``scatter_reduce``, ``index_add``).
Counts, minima and maxima are exact in any order; f64 sums are not, so
fitted parameters agree with the reference within a tolerance.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from .. import resolve_device
from . import cdf, models
from .adapt import DomainSpec, adapt_linear, adapt_mlp
from .bounds import reuse_err_bounds
from .paths import resolve_path
from .reuse import ModelPool, PoolSelection, select_from_pool_batch

_F64 = torch.float64
_I32 = torch.int32
TRAIN_CAP = 1024    # points a leaf MLP trains on (denser leaves decimated)


def _pow2(v: int) -> int:
    return 1 << max(int(v) - 1, 1).bit_length()


def zero_leaves(kind: str, n_leaves: int, device) -> tuple:
    """Stacked all-zero leaf parameters of either kind."""
    if kind == "linear":
        z = torch.zeros((n_leaves,), dtype=_F64, device=device)
        return models.LinearParams(a=z, b=z.clone())
    zh = torch.zeros((n_leaves, models.HIDDEN), dtype=_F64, device=device)
    return models.MLPParams(w1=zh, b1=zh.clone(), w2=zh.clone(),
                            b2=torch.zeros((n_leaves,), dtype=_F64,
                                           device=device))


# ---------------------------------------------------------------------------
# Unsorted per-leaf reductions (any root).  Bucket ids outside
# [0, n_leaves) are dropped, as XLA's segment ops drop them.
# ---------------------------------------------------------------------------
_SPREAD_BINS = 1 << 22     # sub-bins a spread CUDA segment reduction uses


def _seg_index(buckets, n_leaves):
    ok = (buckets >= 0) & (buckets < n_leaves)
    return torch.where(ok, buckets, n_leaves).long()


def _spread(buckets, n_leaves):
    """(index, G): segment ids of ``buckets`` (out-of-range ids to the
    spare segment ``n_leaves``), each spread over G sub-bins by position.
    On CUDA a segment reduction is atomics into its output, and with few
    segments (an RMRT's first levels) they would serialize on a handful of
    addresses; G sub-bins per segment spread them out (the 200M-key RMRT
    of ``chip_smoke.py`` builds 22x faster on an H100 than with G = 1,
    ``python -m repro_torch.time_segments``).  On the CPU G = 1 (the
    reference's sequential scatter order)."""
    idx = _seg_index(buckets, n_leaves)
    if not buckets.is_cuda:
        return idx, 1
    g = max(1, min(1024, _SPREAD_BINS // (n_leaves + 1)))
    if g > 1:
        idx = idx * g + torch.arange(idx.shape[0], device=idx.device) % g
    return idx, g


def _seg_sum(v, buckets, n_leaves):
    idx, g = _spread(buckets, n_leaves)
    out = torch.zeros(((n_leaves + 1) * g,), dtype=v.dtype, device=v.device)
    out.index_add_(0, idx, v)
    return out.view(n_leaves + 1, g).sum(1)[:n_leaves]


def _seg_ext(v, buckets, n_leaves, how):
    idx, g = _spread(buckets, n_leaves)
    fill = torch.inf if how == "amin" else -torch.inf
    out = torch.full(((n_leaves + 1) * g,), fill, dtype=v.dtype,
                     device=v.device).scatter_reduce(0, idx, v, how)
    out = out.view(n_leaves + 1, g)
    return (out.amin(1) if how == "amin" else out.amax(1))[:n_leaves]


def leaf_stats(keys, buckets, n_leaves: int):
    """Per-leaf (count, key_min, key_max, pos_min, pos_max); empty leaves
    get (0, 0, 1, 0, 0)."""
    n = keys.shape[0]
    pos = torch.arange(n, dtype=_F64, device=keys.device)
    count = torch.bincount(_seg_index(buckets, n_leaves),
                           minlength=n_leaves + 1)[:n_leaves].to(_F64)
    empty = count == 0
    zero = torch.zeros((), dtype=_F64, device=keys.device)
    kmin = torch.where(empty, zero, _seg_ext(keys, buckets, n_leaves, "amin"))
    kmax = torch.where(empty, zero + 1.0,
                       _seg_ext(keys, buckets, n_leaves, "amax"))
    pmin = torch.where(empty, zero, _seg_ext(pos, buckets, n_leaves, "amin"))
    pmax = torch.where(empty, zero, _seg_ext(pos, buckets, n_leaves, "amax"))
    return count, kmin, kmax, pmin, pmax


def leaf_histograms(keys, buckets, n_leaves: int, m: int, kmin, kmax):
    """(n_leaves, m) leaf-normalized similarity histograms (right-closed
    bins), one bincount."""
    from ..kernels.lookup import trunc_clip
    bc = buckets.clamp(0, n_leaves - 1).long()      # XLA's clamped gather
    span = (kmax - kmin).clamp(min=torch.finfo(_F64).tiny)
    x = (keys - kmin[bc]) / span[bc]
    b = trunc_clip(torch.ceil(x * m), 0, m) - 1
    b = b.clamp(0, m - 1).long()
    ok = (buckets >= 0) & (buckets < n_leaves)
    flat = torch.where(ok, buckets.long() * m + b, n_leaves * m)
    counts = torch.bincount(flat, minlength=n_leaves * m + 1)[:n_leaves * m]
    counts = counts.to(_F64).reshape(n_leaves, m)
    return counts / counts.sum(1, keepdim=True).clamp(min=1.0)


def segment_linear_fit(keys, buckets, n_leaves: int) -> models.LinearParams:
    """Closed-form least squares (pos on key) per leaf from raw segment
    moments, any bucket order."""
    n = keys.shape[0]
    x = keys.to(_F64)
    y = torch.arange(n, dtype=_F64, device=keys.device)
    seg = lambda v: _seg_sum(v, buckets, n_leaves)
    cnt, sx, sy = seg(torch.ones_like(x)), seg(x), seg(y)
    sxx, sxy = seg(x * x), seg(x * y)
    denom = cnt * sxx - sx * sx
    zero = torch.zeros_like(denom)
    a = torch.where(denom.abs() > 1e-30, (cnt * sxy - sx * sy) / denom, zero)
    b = torch.where(cnt > 0, (sy - a * sx) / cnt.clamp(min=1.0), zero)
    return models.LinearParams(a=a, b=b)


def segment_residual_bounds(pred, buckets, n_leaves: int):
    """Per-leaf (min, max) of (true position - prediction); 0 when empty."""
    n = pred.shape[0]
    r = torch.arange(n, dtype=_F64, device=pred.device) - pred
    cnt = torch.bincount(_seg_index(buckets, n_leaves),
                         minlength=n_leaves + 1)[:n_leaves]
    zero = torch.zeros((), dtype=_F64, device=pred.device)
    return (torch.where(cnt > 0, _seg_ext(r, buckets, n_leaves, "amin"),
                        zero),
            torch.where(cnt > 0, _seg_ext(r, buckets, n_leaves, "amax"),
                        zero))


# ---------------------------------------------------------------------------
# Sorted-bucket per-leaf reductions (monotone root).
# ---------------------------------------------------------------------------
def _bucket_bounds(buckets: torch.Tensor, n_leaves: int):
    """[start, end) of each leaf's run in non-decreasing ``buckets``
    (out-of-range buckets -- the dump bucket ``n_leaves`` -- sort past)."""
    lid = torch.arange(n_leaves, dtype=buckets.dtype, device=buckets.device)
    return (torch.searchsorted(buckets, lid),
            torch.searchsorted(buckets, lid, right=True))


def leaf_stats_sorted(keys: torch.Tensor, buckets: torch.Tensor,
                      n_leaves: int):
    """:func:`leaf_stats` for non-decreasing ``buckets``."""
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


def leaf_histograms_ranges(keys, buckets, rid, m: int, kmin, kmax):
    """:func:`leaf_histograms` for the leaf rows ``rid`` of non-decreasing
    ``buckets``: bin populations by searchsorted at the bin edges (cost
    R*m, not n).  ``kmin``/``kmax`` are the rows' own."""
    lid = rid.to(buckets.dtype)
    start = torch.searchsorted(buckets, lid)
    end = torch.searchsorted(buckets, lid, right=True)
    span = (kmax - kmin).clamp(min=torch.finfo(_F64).tiny)
    edges = cdf.bin_edges(kmin, span, m)
    pos = torch.searchsorted(keys, edges.reshape(-1), right=True) \
        .reshape(rid.shape[0], m - 1)
    pos = torch.minimum(torch.maximum(pos, start[:, None]), end[:, None])
    bounds = torch.cat([start[:, None], pos, end[:, None]], 1)
    counts = (bounds[:, 1:] - bounds[:, :-1]).to(_F64)
    return counts / counts.sum(1, keepdim=True).clamp(min=1.0)


def _segsum(v: torch.Tensor, start: torch.Tensor,
            end: torch.Tensor) -> torch.Tensor:
    """Per-leaf sums of ``v`` over [start, end) by one cumulative sum."""
    c = torch.cat([torch.zeros((1,), dtype=v.dtype, device=v.device),
                   torch.cumsum(v, 0)])
    return c[end] - c[start]


def segment_linear_fit_sorted(keys: torch.Tensor, buckets: torch.Tensor,
                              n_leaves: int) -> models.LinearParams:
    """Per-leaf least squares for non-decreasing ``buckets``: two-pass
    cumsum-difference moments (per-leaf means, then centred products).
    Non-finite keys (capacity padding) contribute zero to every moment."""
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
    lo = _seg_ext(r, buckets, n_leaves, "amin")
    hi = _seg_ext(r, buckets, n_leaves, "amax")
    start, end = _bucket_bounds(buckets, n_leaves)
    empty = start == end
    zero = torch.zeros((), dtype=_F64, device=dev)
    return torch.where(empty, zero, lo), torch.where(empty, zero, hi)


def _sentinel_bounds(err_lo, err_hi, count, n: int):
    """Empty leaves are reachable by out-of-distribution queries: give them
    a sound full-array window."""
    return (torch.where(count > 0, err_lo, torch.full_like(err_lo, -float(n))),
            torch.where(count > 0, err_hi, torch.full_like(err_hi, float(n))))


def _leaf_predict_all(kind: str, leaves, keys: torch.Tensor,
                      buckets: torch.Tensor) -> torch.Tensor:
    """Predict every key with its own leaf's model (buckets past the last
    leaf read the last leaf, as JAX's clamped gather does).  MLP leaves
    are evaluated one hidden unit at a time, so no (n, H) array exists."""
    nl = leaves[0].shape[0]
    b = buckets.clamp(0, nl - 1).long()
    if kind == "linear":
        return leaves.a[b] * keys + leaves.b[b]
    s = torch.zeros_like(keys, dtype=_F64)
    for k in range(models.HIDDEN):
        z = keys * leaves.w1[b, k] + leaves.b1[b, k]
        s = s + torch.where(z > 0, z, torch.zeros_like(z)) * leaves.w2[b, k]
    return s + leaves.b2[b]


def _measure_bounds(kind, keys, buckets, leaves, count, n_leaves: int,
                    sorted_buckets: bool):
    pred = _leaf_predict_all(kind, leaves, keys, buckets)
    fn = segment_residual_bounds_sorted if sorted_buckets \
        else segment_residual_bounds
    lo, hi = fn(pred, buckets, n_leaves)
    return _sentinel_bounds(lo, hi, count, keys.shape[0])


# ---------------------------------------------------------------------------
# The index structure.
# ---------------------------------------------------------------------------
@dataclass
class RMIIndex:
    keys: torch.Tensor               # (n,) sorted f64
    root_kind: str                   # "linear" | "mlp"
    root: models.LinearParams | models.MLPParams
    leaf_kind: str                   # "linear" | "mlp"
    leaves: models.LinearParams | models.MLPParams   # stacked (L, ...)
    err_lo: torch.Tensor             # (L,) f64
    err_hi: torch.Tensor             # (L,) f64
    n_leaves: int
    reused_mask: torch.Tensor        # (L,) bool: Algorithm 1 pool hit
    leaf_sim: torch.Tensor           # (L,) f64 (Lemma 4.1 input)
    # lazily derived serving state
    _iters: int | None = None        # error-window search depth
    _packed: tuple | None = None     # ((root, mat, vec), leaf rows) kernel
                                     #   tables
    _f32_exact: bool | None = None   # keys round-trip through f32
    _kf32: tuple | None = None       # (f32 copy of keys, its key fence)

    @property
    def n(self) -> int:
        return int(self.keys.shape[0])

    @property
    def device(self) -> torch.device:
        return self.keys.device

    @property
    def reuse_fraction(self) -> float:
        """Share of models taken from the pool (a mean as XLA computes it:
        the count times the reciprocal of the length)."""
        m = self.reused_mask
        return float(m.sum()) * (1.0 / max(m.shape[0], 1))

    @property
    def search_iters(self) -> int:
        """Static per-query search depth bounded by the error window (§4)."""
        if self._iters is None:
            from ..kernels.lookup import search_iters
            self._iters = search_iters(self.err_lo, self.err_hi, self.n)
        return self._iters

    def _key_space(self) -> tuple:
        if self._kf32 is None:
            from ..kernels.lookup import key_fence
            # tracelint: ok[f32-cast](the copy f32_exact compares)
            kf = self.keys.to(torch.float32)
            self._kf32 = (kf, key_fence(kf))
        return self._kf32

    @property
    def keys_f32(self) -> torch.Tensor:
        """The keys in the kernel's f32 key space (cached)."""
        return self._key_space()[0]

    @property
    def key_fence(self) -> torch.Tensor:
        """Every 64th key of ``keys_f32``, cached with it: the fence K1
        searches first (``kernels.lookup.key_fence``)."""
        return self._key_space()[1]

    @property
    def f32_exact(self) -> bool:
        """True when every key round-trips through f32 -- the precondition
        of the kernel path, which searches and seam-verifies in f32."""
        if self._f32_exact is None:
            self._f32_exact = bool(
                (self.keys_f32.to(_F64) == self.keys).all())
        return self._f32_exact

    def _pack(self) -> tuple:
        if self._packed is None:
            from ..kernels import lookup as _lk
            root = _lk.pack_root(self.root_kind, self.root)
            w1, b1, w2, b2 = _leaf_table_arrays(self.leaf_kind, self.leaves,
                                                self.n_leaves)
            mat, vec = _lk.pack_leaves(w1, b1, w2, b2, self.err_lo,
                                       self.err_hi)
            self._packed = ((root, mat, vec),
                            _lk.leaf_rows(mat, vec, self.leaf_kind))
        return self._packed

    def packed_tables(self) -> tuple:
        """(root, mat, vec) packed f32 tables for the lookup kernels."""
        return self._pack()[0]

    def leaf_rows(self) -> torch.Tensor:
        """The leaf-major rows K1 (and K2, for MLP leaves) read, cached with
        the packed tables: dropping ``_packed`` drops both."""
        return self._pack()[1]


def _leaf_table_arrays(kind: str, leaves, n_leaves: int):
    """Uniform (L, H)/(L,) leaf tables for either leaf kind (a linear leaf
    rides in w1[:, 0] and b2)."""
    if kind != "linear":
        return leaves.w1, leaves.b1, leaves.w2, leaves.b2
    dev = leaves.a.device
    w1 = torch.zeros((n_leaves, models.HIDDEN), dtype=torch.float32,
                     device=dev)
    w1[:, 0] = leaves.a.to(torch.float32)
    zeros = torch.zeros_like(w1)
    return w1, zeros, zeros, leaves.b


def _root_predict(kind, params, keys):
    return (models.linear_predict if kind == "linear"
            else models.mlp_predict)(params, keys)


def root_buckets(kind: str, params, keys: torch.Tensor, n_leaves: int,
                 n: int) -> torch.Tensor:
    """Leaf of each key under the root, scaled by ``n``: int32, clipped to
    [0, n_leaves - 1] after a saturating conversion (a key beyond the
    root's range lands in leaf n_leaves - 1, never in leaf 0)."""
    from ..kernels.lookup import trunc_clip
    pred = _root_predict(kind, params, keys)
    return trunc_clip(pred * n_leaves / n, 0, n_leaves - 1)


class LeafFit(NamedTuple):
    """Batched per-leaf fit result (all leaves; see :func:`fit_leaves`)."""
    leaves: tuple
    reused: torch.Tensor     # (L,) bool -- Algorithm 1 pool hit
    err_lo: torch.Tensor     # (L,) sound bounds (sentinel window on empty)
    err_hi: torch.Tensor
    sim: torch.Tensor        # (L,) build-time similarity
    count: torch.Tensor      # (L,) member counts


def fit_leaves(keys: torch.Tensor, buckets: torch.Tensor, n_leaves: int,
               kind: str = "linear", pool: ModelPool | None = None,
               paper_bounds: bool = False, train_steps: int = 300,
               seed: int = 0, refit_mask=None,
               sorted_buckets: bool = False) -> LeafFit:
    """Fit every leaf of an RMI layer: Algorithm-1 pool reuse first
    (batched selection + affine adaptation), fresh fits on the misses,
    residual bounds in one batched predict.  ``refit_mask`` names the
    leaves the caller will keep (the rebuild path): selection and MLP
    training are restricted to them.  A pool of another kind is ignored.
    ``sorted_buckets`` (sound only for a monotone root) selects the
    scatter-free reductions."""
    dev = keys.device
    stats = leaf_stats_sorted if sorted_buckets else leaf_stats
    count, kmin, kmax, pmin, pmax = stats(keys, buckets, n_leaves)
    if pool is not None and pool.kind != kind:
        pool = None
    if pool is not None:
        sel_a, sel_ps = pool.tables()
        if refit_mask is not None and sorted_buckets:
            sel = _select_compact(keys, buckets, refit_mask, kmin, kmax,
                                  sel_a, sel_ps, pool.eps, m=pool.m,
                                  n_leaves=n_leaves)
        else:
            hists = leaf_histograms(keys, buckets, n_leaves, pool.m, kmin,
                                    kmax)
            sel = select_from_pool_batch(sel_a, sel_ps, hists, pool.eps)
            del hists
        found = sel.found & (count > 1)
        if refit_mask is not None:
            found = found & refit_mask
    else:
        found = torch.zeros((n_leaves,), dtype=torch.bool, device=dev)

    if kind == "linear":
        fit_fn = segment_linear_fit_sorted if sorted_buckets \
            else segment_linear_fit
        fresh = fit_fn(keys, buckets, n_leaves)
    else:
        skip = None
        if pool is not None or refit_mask is not None:
            skip = found if refit_mask is None else found | ~refit_mask
        fresh = _batched_leaf_mlp(keys, buckets, n_leaves, count, kmin, kmax,
                                  pmin, train_steps, seed, skip_mask=skip)

    if pool is not None:
        leaves, err_lo, err_hi, sim = _pool_merge_measure(
            keys, buckets, fresh, found, sel, pool, count, kmin, kmax, pmin,
            pmax, kind=kind, n_leaves=n_leaves, paper_bounds=paper_bounds,
            sorted_buckets=sorted_buckets)
    else:
        leaves = fresh
        err_lo, err_hi = _measure_bounds(kind, keys, buckets, fresh, count,
                                         n_leaves, sorted_buckets)
        sim = torch.ones((n_leaves,), dtype=_F64, device=dev)
    return LeafFit(leaves=leaves, reused=found, err_lo=err_lo, err_hi=err_hi,
                   sim=sim, count=count)


def _select_compact(keys, buckets, refit_mask, kmin, kmax, sel_a, sel_ps,
                    eps, *, m: int, n_leaves: int) -> PoolSelection:
    """Algorithm-1 selection for the rebuilt leaves only (rebuild path):
    range histograms and one K7 batch over those rows, scattered back to
    full (L,) selection arrays (zero / False elsewhere)."""
    dev = keys.device
    rid = torch.nonzero(refit_mask).squeeze(1)
    hist = leaf_histograms_ranges(keys, buckets, rid, m, kmin[rid],
                                  kmax[rid])
    sel = select_from_pool_batch(sel_a, sel_ps, hist, eps)
    found = torch.zeros((n_leaves,), dtype=torch.bool, device=dev)
    index = torch.zeros((n_leaves,), dtype=_I32, device=dev)
    dist = torch.zeros((n_leaves,), dtype=_F64, device=dev)
    found[rid], index[rid], dist[rid] = sel.found, sel.index, sel.dist
    return PoolSelection(found=found, index=index, dist=dist)


def _pool_merge_measure(keys, buckets, fresh, found, sel, pool, count, kmin,
                        kmax, pmin, pmax, *, kind: str, n_leaves: int,
                        paper_bounds: bool, sorted_buckets: bool):
    """Adapt the selected pool models (Lemma 3.2 folds), merge them with
    the fresh fits and measure residual bounds."""
    idx = sel.index.long()
    src = DomainSpec(*(a[idx] for a in pool.domains))
    tgt = DomainSpec(x_start=kmin,
                     x_end=torch.where(kmax > kmin, kmax, kmin + 1.0),
                     y_start=pmin, y_end=torch.maximum(pmax, pmin + 1.0))
    adapt = adapt_linear if kind == "linear" else adapt_mlp
    adapted = adapt(models.take_rows(pool.params, idx), src, tgt)
    leaves = models.where_rows(found, adapted, fresh)
    err_lo, err_hi = _measure_bounds(kind, keys, buckets, leaves, count,
                                     n_leaves, sorted_buckets)
    if paper_bounds:
        s_dy = (tgt.y_end - tgt.y_start) / (src.y_end - src.y_start)
        thm_lo, thm_hi = reuse_err_bounds(pool.err_lo[idx], pool.err_hi[idx],
                                          sel.dist, count, s_dy)
        err_lo = torch.where(found, thm_lo, err_lo)     # found => count > 1
        err_hi = torch.where(found, thm_hi, err_hi)
    sim = torch.where(found, 1.0 - sel.dist, torch.ones_like(sel.dist))
    return leaves, err_lo, err_hi, sim


def _leaf_inits(n: int, seed: int, device) -> models.MLPParams:
    """Initial parameters of ``n`` leaf MLPs trained in one batch (slot
    order), drawn from a generator seeded with ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return models.mlp_init(g, batch=(n,))


def _batched_leaf_mlp(keys, buckets, n_leaves, count, kmin, kmax, pmin,
                      train_steps: int, seed: int, skip_mask=None):
    """Train leaf MLPs in one batch.  Only the leaves outside ``skip_mask``
    (the pool's misses, or the rebuilt leaves) enter the batch, compacted
    into slots 0..K-1 (K the pow2 pad of their count, slot K the dump);
    that is where agile reuse saves build time."""
    dev = keys.device
    if skip_mask is None:
        miss = torch.arange(n_leaves, device=dev)
    else:
        miss = torch.nonzero(~skip_mask).squeeze(1)
    zero = zero_leaves("mlp", n_leaves, dev)
    nm = int(miss.shape[0])
    if nm == 0:
        return zero
    K = _pow2(nm)
    cap = min(_pow2(max(int(count[miss].max()), 2)), TRAIN_CAP)
    slot_of = torch.full((n_leaves,), K, dtype=torch.int64, device=dev)
    slot_of[miss] = torch.arange(nm, device=dev)
    take = lambda a: torch.cat([a[miss], torch.zeros((K + 1 - nm,),
                                                     dtype=a.dtype,
                                                     device=dev)])
    # Bucket ids past the last leaf read slot_of[L - 1], as JAX's clamped
    # gather does.
    slots = slot_of[buckets.clamp(0, n_leaves - 1).long()]
    p = _padded_leaf_mlp_train(
        keys, slots, K + 1, cap, take(kmin),
        take(torch.where(kmax > kmin, kmax, kmin + 1.0)), take(pmin),
        take(count), train_steps, _leaf_inits(K + 1, seed, dev))
    return type(zero)(*(z.index_copy(0, miss, t[:nm])
                        for z, t in zip(zero, p, strict=True)))


def _padded_leaf_mlp_train(keys, slots, n_slots: int, cap: int, kmin, kmax,
                           pmin, count, train_steps: int,
                           init: models.MLPParams) -> models.MLPParams:
    """Train one MLP per slot on its keys, laid out in (n_slots, cap)
    padded rows.  A slot's keys enter in key order at their within-slot
    rank; slots denser than ``cap`` are decimated to rank * cap / count.
    Decimation can map two keys to one cell: the later key (higher
    position) wins, on every device.  The dump slot ``n_slots - 1`` is
    left empty (its model is discarded).  The leaf normalization is folded
    into the first layer, so leaves consume raw keys like pool models."""
    dev = keys.device
    K = n_slots - 1
    live = torch.nonzero(slots < K).squeeze(1)       # key positions, sorted
    sl = slots[live]
    order = torch.argsort(sl, stable=True)
    sb = sl[order]
    run_start = torch.searchsorted(sb, torch.arange(n_slots, device=dev))
    offs = torch.empty_like(sl)
    offs[order] = torch.arange(sl.shape[0], device=dev) - run_start[sb]
    del order, sb
    cnt_b = count[sl].clamp(min=1.0)
    from ..kernels.lookup import trunc_clip
    dec = trunc_clip(offs.to(_F64) * cap / cnt_b, -1, 2 ** 31 - 2).long()
    slot = torch.where(cnt_b > cap, dec, offs).clamp(0, cap - 1)
    flat = sl * cap + slot
    del offs, dec, slot
    winner = torch.full((n_slots * cap,), -1, dtype=torch.int64, device=dev)
    winner.scatter_reduce_(0, flat, torch.arange(flat.shape[0], device=dev),
                           "amax")
    cell = torch.nonzero(winner >= 0).squeeze(1)
    src = winner[cell]
    pos = live[src]
    srow = sl[src]
    span = torch.where(kmax > kmin, kmax - kmin, torch.ones_like(kmax))
    X = torch.zeros((n_slots * cap,), dtype=_F64, device=dev)
    Y = torch.zeros_like(X)
    M = torch.zeros_like(X)
    X[cell] = (keys[pos] - kmin[srow]) / span[srow]
    Y[cell] = pos.to(_F64)
    M[cell] = 1.0
    p = models.mlp_train(init, X.reshape(n_slots, cap),
                         Y.reshape(n_slots, cap), steps=train_steps,
                         mask=M.reshape(n_slots, cap))
    return models.MLPParams(
        w1=p.w1 / span[:, None],
        b1=p.b1 - p.w1 * (kmin / span)[:, None],
        w2=p.w2, b2=p.b2)


def _root_init(seed: int, device) -> models.MLPParams:
    """Initial parameters of an MLP root, from a generator seeded with
    ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return models.mlp_init(g)


def build_rmi(keys, n_leaves: int = 1024, kind: str = "linear",
              root_kind: str = "linear", pool: ModelPool | None = None,
              paper_bounds: bool = False, train_steps: int = 300,
              root_subsample: int = 1 << 16, seed: int = 0, *,
              device=None) -> RMIIndex:
    """Build a two-layer RMI over a sorted key array, on ``device`` (CUDA
    unless ``device="cpu"``).  With ``pool``, every leaf first attempts
    agile model reuse (batched Algorithm 1); only missing leaves are
    trained.  ``paper_bounds`` takes Theorem 3.3's bounds for reused
    leaves; the default measures residuals (sound and tighter)."""
    dev = resolve_device(device)
    for k in (kind, root_kind):
        if k not in ("linear", "mlp"):
            raise ValueError(f"model kind must be 'linear' or 'mlp': {k!r}")
    keys = torch.as_tensor(keys, dtype=_F64, device=dev)
    n = keys.shape[0]
    if n == 0:
        # Empty partition: zero models and one-slot windows; every key slot
        # a consumer pads in is +inf, so any finite query resolves to 0.
        if root_kind != "linear":
            raise ValueError("build_rmi on an empty key array requires a "
                             "linear root (nothing to train an MLP root on)")
        zero = torch.zeros((), dtype=_F64, device=dev)
        ones = torch.ones((n_leaves,), dtype=_F64, device=dev)
        return RMIIndex(
            keys=keys, root_kind=root_kind,
            root=models.LinearParams(a=zero, b=zero), leaf_kind=kind,
            leaves=zero_leaves(kind, n_leaves, dev),
            err_lo=-ones, err_hi=ones.clone(), n_leaves=n_leaves,
            reused_mask=torch.zeros((n_leaves,), dtype=torch.bool,
                                    device=dev),
            leaf_sim=ones.clone())
    pos = torch.arange(n, dtype=_F64, device=dev)
    if root_kind == "linear":
        root = models.linear_fit(keys, pos)
    else:
        stride = max(1, n // root_subsample)
        sub, subpos = keys[::stride], pos[::stride]
        span = keys[-1] - keys[0]
        norm = (sub - keys[0]) / span
        p = models.mlp_train(_root_init(seed, dev), norm, subpos,
                             steps=train_steps)
        root = models.MLPParams(w1=p.w1 / span,
                                b1=p.b1 - p.w1 * keys[0] / span,
                                w2=p.w2, b2=p.b2)
    buckets = root_buckets(root_kind, root, keys, n_leaves, n)
    fit = fit_leaves(keys, buckets, n_leaves, kind=kind, pool=pool,
                     paper_bounds=paper_bounds, train_steps=train_steps,
                     seed=seed, sorted_buckets=root_kind == "linear")
    return RMIIndex(keys=keys, root_kind=root_kind, root=root, leaf_kind=kind,
                    leaves=fit.leaves, err_lo=fit.err_lo, err_hi=fit.err_hi,
                    n_leaves=n_leaves, reused_mask=fit.reused,
                    leaf_sim=fit.sim)


# ---------------------------------------------------------------------------
# Lookup: root -> leaf -> bounded branchless binary search (f64 path).
# ---------------------------------------------------------------------------
def leaf_window(kind: str, leaves, err_lo, err_hi, b, q, n: int):
    """Routed-leaf predict + error-bound window clip, f64: (lo, hi) int32."""
    from ..kernels.lookup import clip_to_i32
    pred = _leaf_predict_all(kind, leaves, q, b)
    bl = b.long()
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
    lo, hi = leaf_window(index.leaf_kind, index.leaves, index.err_lo,
                         index.err_hi, b, queries, index.n)
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
    # sync: ok(f64 path only: the seam check's one read a call)
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
            n_leaves=index.n_leaves, root_kind=index.root_kind,
            leaf_kind=index.leaf_kind,
            iters=iters if iters is not None else full_iters(index.n),
            rows=index.leaf_rows(), fence=index.key_fence)
    return rmi_lookup(index, q, iters=iters)
