"""RadixSpline baseline (counterpart of ``repro.core.radix_spline``; the
paper's competitor #5): a single-pass error-bounded greedy spline and a
radix table over key prefixes.

The build is one pass (GreedySplineCorridor), a host numpy loop copied
from the reference as it is, so the spline points and the radix table come
out bit for bit.  The lookup runs on the device: radix bucket -> search of
the spline points in the bucket's range -> linear interpolation -> a
verified search of the +-eps window.  The bucket's conversion saturates as
XLA's does (``kernels.lookup.trunc_clip``) and the window's offsets wrap
after it (``pgm.eps_window``).  XLA:CPU contracts ``y0 + t * (y1 - y0)``
into an FMA inside the reference's jit and this module never does, so a
window can differ from the jitted reference's by one position; the
verified answers are the same.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..kernels.lookup import full_iters, trunc_clip
from .bounds import _host
from .pgm import eps_window
from .rmi import bounded_search, verified_search

_F64 = torch.float64


def _greedy_spline(keys: np.ndarray, eps: int) -> np.ndarray:
    """GreedySplineCorridor (Neumann/Michel; as in RadixSpline): indices of
    spline knots such that chord interpolation between consecutive knots is
    within +-eps of the true rank.

    Invariant: the cone [lo, hi] from the current knot (xb, yb) contains
    every slope that passes within +-eps of all points seen since the knot.
    A point whose exact slope lies inside the cone may safely *end* the
    segment (the chord hits it exactly and stays within the corridor); when
    it falls outside, the previous point becomes a knot."""
    n = keys.size
    pts = [0]
    lo_s, hi_s = -np.inf, np.inf
    xb, yb = keys[0], 0
    prev = 0
    for i in range(1, n):
        x = keys[i]
        if x == xb:
            continue
        s = (i - yb) / (x - xb)
        if s < lo_s or s > hi_s:
            # knot at the last in-corridor point, restart cone from it
            pts.append(prev)
            xb, yb = keys[prev], prev
            lo_s, hi_s = -np.inf, np.inf
            if x == xb:
                continue
        dx = x - xb
        lo_s = max(lo_s, (i - eps - yb) / dx)
        hi_s = min(hi_s, (i + eps - yb) / dx)
        prev = i
    pts.append(n - 1)
    return np.unique(np.asarray(pts, np.int64))


@dataclass
class RSIndex:
    keys: torch.Tensor
    eps: int
    spline_x: torch.Tensor      # (S,) f64 spline point keys
    spline_y: torch.Tensor      # (S,) f64 their ranks
    radix_bits: int
    radix_table: torch.Tensor   # (2**bits + 1,) int32 first spline point
                                #   of each radix bucket
    key_min: float
    key_max: float

    @property
    def n(self) -> int:
        return int(self.keys.shape[0])

    @property
    def size_bytes(self) -> int:
        return int(self.spline_x.numel() * 16 + self.radix_table.numel() * 4)


def build_rs(keys, eps: int = 32, radix_bits: int = 12, *,
             device=None) -> RSIndex:
    """Build on the host, then put the keys, spline and radix table on
    ``device`` (CUDA unless ``device="cpu"``)."""
    dev = resolve_device(device)
    keys_np = _host(keys)
    pts = _greedy_spline(keys_np, eps)
    sx, sy = keys_np[pts], pts.astype(np.float64)
    kmin, kmax = float(keys_np[0]), float(keys_np[-1])
    span = max(kmax - kmin, np.finfo(np.float64).tiny)
    # radix table over the leading bits of the normalized key
    buckets = ((sx - kmin) / span * ((1 << radix_bits) - 1)).astype(np.int64)
    table = np.searchsorted(buckets, np.arange((1 << radix_bits) + 1))
    return RSIndex(keys=torch.tensor(keys_np, device=dev), eps=eps,
                   spline_x=torch.as_tensor(sx, device=dev),
                   spline_y=torch.as_tensor(sy, device=dev),
                   radix_bits=radix_bits,
                   radix_table=torch.as_tensor(table, dtype=torch.int32,
                                               device=dev),
                   key_min=kmin, key_max=kmax)


def lookup(index: RSIndex, queries) -> torch.Tensor:
    """Left-boundary rank of each query, int32 (``rmi.lookup``'s
    semantics)."""
    q = torch.as_tensor(queries, dtype=_F64, device=index.keys.device)
    lo, hi = _rs_window(index, q)
    # the +-eps window takes a clamped depth (the spline search keeps full
    # depth: a bucket's occupancy is not statically bounded)
    return verified_search(index.keys, q, lo, hi,
                           iters=full_iters(2 * index.eps + 2))


def _rs_window(index: RSIndex, q: torch.Tensor):
    """The +-eps window of each query around its interpolated rank."""
    sx, sy, table = index.spline_x, index.spline_y, index.radix_table
    S = sx.shape[0]
    nb = (1 << index.radix_bits) - 1
    span = max(index.key_max - index.key_min, np.finfo(np.float64).tiny)
    b = trunc_clip((q - index.key_min) / span * nb, 0, nb).long()
    lo = table[b]
    hi = torch.clamp(table[b + 1] + 1, max=S)
    # right spline point: the first spline key >= q, within [lo, hi)
    r = bounded_search(sx, q, lo, hi).long()
    # clip(r, 1, S - 1) as jnp.clip: with one point it is 0, and r - 1
    # then indexes the last point, as a negative index does in the
    # reference
    r = torch.clamp(torch.clamp(r, min=1), max=S - 1)
    x0, x1 = sx[r - 1], sx[r]
    y0, y1 = sy[r - 1], sy[r]
    t = torch.where(x1 > x0, (q - x0) / (x1 - x0), 0.0)
    return eps_window(y0 + t * (y1 - y0), index.eps, index.n)
