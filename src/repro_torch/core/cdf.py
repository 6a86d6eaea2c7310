"""CDF machinery (counterpart of ``repro.core.cdf``): exact KS distance,
relative-frequency histograms, the paper's Algorithm 2 histogram distance,
and the prefix sums every distance is built from.

Definitions (paper §3):
  sim(D_S, D_T)  = 1 - sup_x |cdf_S(x) - cdf_T(x)|          (Def. 3.1)
  dist(D_S, D_T) = 1 - sim(D_S, D_T)   (two-sample Kolmogorov-Smirnov statistic)
  dist_h(D_S, D_T) >= dist(D_S, D_T)                        (Eq. 3, Algorithm 2)

Prefix sums run in XLA:CPU's order for ``jnp.cumsum`` (:func:`prefix_sum`),
not sequentially and not in ``torch.cumsum``'s order: a one-ulp difference
in an f32 prefix table moves a distance across the reuse threshold
``1 - eps`` and changes which pool entry a leaf selects.  Likewise, a
division by a dataset's (static) length is a multiplication by its
reciprocal, as XLA rewrites it inside the reference's jitted functions.
"""
from __future__ import annotations

import torch

_F64 = torch.float64
_BLOCK = 16     # XLA's scan block: sequential inside, blocks joined by totals


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the last axis in the order XLA:CPU
    computes ``jnp.cumsum``: a row of width <= 16 is summed sequentially;
    a wider row is cut into blocks of 16 (zero-padded), each block summed
    sequentially, the block totals prefix-summed the same way (recursively)
    and each block's exclusive total added to its entries.  Bit-identical
    to ``jnp.cumsum`` in f32 and f64 (``tests/test_torch_reuse.py``)."""
    m = x.shape[-1]
    if m <= _BLOCK:
        cols = [x[..., 0]]
        for j in range(1, m):
            cols.append(cols[-1] + x[..., j])
        return torch.stack(cols, -1) if m else x.clone()
    nb = -(-m // _BLOCK)
    xp = torch.nn.functional.pad(x, (0, nb * _BLOCK - m))
    loc = prefix_sum(xp.reshape(*x.shape[:-1], nb, _BLOCK))
    inc = prefix_sum(loc[..., -1])
    exc = torch.cat([torch.zeros_like(inc[..., :1]), inc[..., :-1]], -1)
    return (loc + exc[..., None]).reshape(*x.shape[:-1], nb * _BLOCK)[..., :m]


def exclusive_prefix(h: torch.Tensor) -> torch.Tensor:
    """``concat([0], cumsum(h)[:-1])`` over the last axis, XLA's order."""
    inc = prefix_sum(h)
    return torch.cat([torch.zeros_like(h[..., :1]), inc[..., :-1]], -1)


# ---------------------------------------------------------------------------
# Exact two-sample KS distance (Def. 3.1).
# ---------------------------------------------------------------------------
def ks_distance(sorted_a: torch.Tensor, sorted_b: torch.Tensor):
    """Exact ``sup_x |cdf_A(x) - cdf_B(x)|`` of two sorted 1-D key arrays:
    both right-continuous CDFs evaluated at every union point."""
    union = torch.cat([sorted_a, sorted_b])
    fa = torch.searchsorted(sorted_a, union, right=True).to(_F64) \
        * (1.0 / sorted_a.shape[0])
    fb = torch.searchsorted(sorted_b, union, right=True).to(_F64) \
        * (1.0 / sorted_b.shape[0])
    return (fa - fb).abs().max()


def ks_similarity(sorted_a, sorted_b):
    """sim(D_S, D_T) per Def. 3.1."""
    return 1.0 - ks_distance(sorted_a, sorted_b)


# ---------------------------------------------------------------------------
# Relative-frequency histograms.
# ---------------------------------------------------------------------------
def histogram_sorted(sorted_keys: torch.Tensor, m: int, lo, hi):
    """m-bin relative-frequency histogram of sorted keys (last axis; rows
    of a 2-D array are separate datasets): the m - 1 interior edges are
    located by binary search.  Right-closed bins, the first also taking
    keys == lo; keys above ``hi`` fall into the last bin."""
    n = sorted_keys.shape[-1]
    dt = sorted_keys.dtype
    frac = torch.arange(1, m + 1, dtype=dt, device=sorted_keys.device) / m
    edges = lo + (hi - lo) * frac
    if sorted_keys.dim() > 1:
        edges = edges.expand(*sorted_keys.shape[:-1], m).contiguous()
    cum = torch.searchsorted(sorted_keys.contiguous(), edges, right=True)
    counts = torch.diff(cum, dim=-1, prepend=torch.zeros_like(cum[..., :1]))
    counts[..., -1] += n - cum[..., -1]
    return counts.to(_F64) * (1.0 / n)


def histogram_stream(keys: torch.Tensor, m: int, lo, hi):
    """m-bin relative-frequency histogram of unsorted keys (right-closed
    bins: ``bin = ceil(x * m) - 1`` clipped to [0, m - 1])."""
    from ..kernels.lookup import trunc_clip
    n = keys.shape[0]
    tiny = torch.finfo(keys.dtype).tiny
    span = hi - lo
    span = span.clamp(min=tiny) if isinstance(span, torch.Tensor) \
        else max(span, tiny)
    idx = trunc_clip(torch.ceil((keys - lo) / span * m), 1, m) - 1
    counts = torch.bincount(idx.long(), minlength=m).to(_F64)
    return counts * (1.0 / n)


# ---------------------------------------------------------------------------
# Algorithm 2: histogram-based distance upper bound.
# ---------------------------------------------------------------------------
def hist_distance(hs: torch.Tensor, ht: torch.Tensor):
    """Algorithm 2: ``dist_h`` of two m-bin histograms (last axis; leading
    axes broadcast).  Within bin i cdf_S is at most the inclusive prefix
    P_S + H_S[i] and cdf_T at least the exclusive prefix P_T, and
    symmetrically, so dist_h >= dist (Eq. 3)."""
    ps = exclusive_prefix(hs)
    pt = exclusive_prefix(ht)
    up = hs + ps - pt
    dn = ht + pt - ps
    return torch.maximum(up.amax(-1), dn.amax(-1))


def hist_distance_pool(pool_hists: torch.Tensor, ht: torch.Tensor):
    """Algorithm 2 of one target histogram against a whole (P, m) pool."""
    return hist_distance(pool_hists, ht[None, :])


def normalize_keys(keys: torch.Tensor):
    """Map keys to [0, 1]: (normalized, lo, hi)."""
    lo, hi = keys.min(), keys.max()
    span = (hi - lo).clamp(min=torch.finfo(_F64).tiny)
    return (keys - lo) / span, lo, hi
