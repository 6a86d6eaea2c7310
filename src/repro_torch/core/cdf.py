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
reciprocal, as XLA rewrites it inside the reference's jitted functions,
and per-leaf bin edges are a fused multiply-add (:func:`bin_edges`).
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


def reverse_prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """``out[j] = sum_{i >= j} x[i]`` over the last axis in the order
    XLA:CPU computes ``lax.cumsum(reverse=True)`` (the transpose of
    ``jnp.cumsum``, hence its VJP): a row of width <= 16 gives each entry
    its own sum from j to the end, taken from j onward; a wider row is
    zero-padded at its end into blocks of 16, each block summed so, the
    block totals summed the same way (recursively) and each block's
    following blocks' total added to its entries."""
    m = x.shape[-1]
    if m <= _BLOCK:
        out = x.clone()
        for d in range(1, m):
            out[..., :m - d] = out[..., :m - d] + x[..., d:]
        return out
    nb = -(-m // _BLOCK)
    xp = torch.nn.functional.pad(x, (0, nb * _BLOCK - m))
    loc = reverse_prefix_sum(xp.reshape(*x.shape[:-1], nb, _BLOCK))
    inc = reverse_prefix_sum(loc[..., 0])
    exc = torch.cat([inc[..., 1:], torch.zeros_like(inc[..., :1])], -1)
    return (loc + exc[..., None]).reshape(*x.shape[:-1], nb * _BLOCK)[..., :m]


class PrefixSum(torch.autograd.Function):
    """``prefix_sum`` under a gradient, with the VJP JAX gives
    ``jnp.cumsum``: ``reverse_prefix_sum`` of the cotangent, in XLA's
    order (autograd of ``prefix_sum``'s own additions would sum it in
    another)."""

    @staticmethod
    def forward(ctx, x):
        return prefix_sum(x)

    @staticmethod
    def backward(ctx, g):
        return reverse_prefix_sum(g)


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


def ceil_to_bin(c: torch.Tensor, m: int) -> torch.Tensor:
    """``clip(int32(c) - 1, 0, m - 1)`` of integral floats ``c`` with XLA's
    integer semantics (saturating conversion, NaN -> 0, wrapping
    subtraction), int64."""
    c = c.to(torch.float64)
    c = torch.where(torch.isnan(c), torch.zeros_like(c),
                    c.clamp(-2.0 ** 31, 2.0 ** 31 - 1))
    v = c.to(torch.int64) - 1
    v = torch.where(v < -2 ** 31, v + 2 ** 32, v)      # int32 wrap
    return v.clamp(0, m - 1)


def normalize_keys(keys: torch.Tensor):
    """Map keys to [0, 1]: (normalized, lo, hi)."""
    lo, hi = keys.min(), keys.max()
    span = (hi - lo).clamp(min=torch.finfo(_F64).tiny)
    return (keys - lo) / span, lo, hi


# ---------------------------------------------------------------------------
# A correctly rounded f64 fused multiply-add, and the bin edges built on it.
# ---------------------------------------------------------------------------
_SPLIT = 134217729.0        # 2**27 + 1: Veltkamp's splitter for f64


def _two_sum(a, b):
    """(s, e) with s = fl(a + b) and s + e = a + b exactly (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    """(p, e) with p = fl(a * b) and p + e = a * b exactly (Dekker), barring
    overflow of the split and underflow of the error term."""
    def split(v):
        c = _SPLIT * v
        hi = c - (c - v)
        return hi, v - hi
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    return p, (((ah * bh - p) + ah * bl) + al * bh) + al * bl


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once, in f64, by error-free transformations
    and a sum rounded to odd (Boldo and Melquiond, "Emulation of FMA and
    correctly rounded sums: proved algorithms using rounding to odd", IEEE
    Trans. Computers 57(4), 2008).  Torch has no fused multiply-add of its
    own that is fused on every device; this one gives the same bits on the
    CPU and on a card.  Exact for finite operands whose product neither
    overflows the split (|a|, |b| < 1e300) nor underflows (|a*b| >
    2**-960)."""
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    v, e = _two_sum(tl, ul)
    # round v to odd: an inexact sum with an even significand moves one
    # ulp toward the exact value
    even = (v.view(torch.int64) & 1) == 0
    toward = torch.where(e > 0, torch.full_like(v, torch.inf),
                         torch.full_like(v, -torch.inf))
    v = torch.where((e != 0) & even, torch.nextafter(v, toward), v)
    return th + v


def bin_edges(kmin: torch.Tensor, span: torch.Tensor, m: int) -> torch.Tensor:
    """(R, m - 1) interior bin edges ``kmin + span * (j / m)`` of R f64
    ranges, as the reference's jitted functions compute them: XLA turns
    ``j / m`` into ``j * (1 / m)`` and contracts the multiply-add into one
    rounding.  An edge one ulp off moves a key across a bin and can change
    an Algorithm-2 distance and a pool selection."""
    frac = torch.arange(1, m, dtype=_F64, device=kmin.device) * (1.0 / m)
    shape = (kmin.shape[0], m - 1)
    return fma(span[:, None].expand(shape), frac[None, :].expand(shape),
               kmin[:, None].expand(shape))
