"""PGM-style baseline (counterpart of ``repro.core.pgm``; the paper's
competitor #4): a piecewise-linear model index with a worst-case error
bound per segment, built bottom-up.

Segments come from the streaming shrinking-cone PLA, a host numpy loop
over the keys copied from the reference as it is, so the segments come out
bit for bit; the recursion indexes the segment start keys the same way
until one segment remains.  The lookup descends the hierarchy on the
device with eps-bounded searches, then searches the final +-eps window and
verifies it.

The window arithmetic is XLA's: ``pred.astype(int32) - eps`` saturates the
conversion (NaN -> 0) and then wraps the int32 offset before the clip
(:func:`eps_window`).  XLA:CPU contracts ``slope * q + icept`` into an FMA
inside the reference's jit and this module never does, so a window can
differ from the jitted reference's by one position; the verified answers
are the same.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..kernels.lookup import full_iters
from .bounds import _host
from .rmi import bounded_search, verified_search

_F64 = torch.float64
_I32 = torch.int32


def _shrinking_cone(keys: np.ndarray, eps: int):
    """Greedy PLA: (starts, slopes) s.t. the line through (keys[start],
    start) with the cone slope predicts every member rank within +-eps."""
    n = keys.size
    starts, slopes = [0], []
    lo, hi = -np.inf, np.inf          # slope cone
    x0, y0 = keys[0], 0
    for i in range(1, n):
        x = keys[i]
        if x == x0:
            continue
        dx = x - x0
        s_lo, s_hi = (i - y0 - eps) / dx, (i - y0 + eps) / dx
        nlo, nhi = max(lo, s_lo), min(hi, s_hi)
        if nlo > nhi:                 # cone collapsed -> close segment
            slopes.append(_mid(lo, hi))
            starts.append(i)
            x0, y0 = x, i
            lo, hi = -np.inf, np.inf
        else:
            lo, hi = nlo, nhi
    slopes.append(_mid(lo, hi))
    return np.asarray(starts, np.int64), np.asarray(slopes)


def _mid(lo: float, hi: float) -> float:
    if not np.isfinite(lo) and not np.isfinite(hi):
        return 0.0                    # single-point segment
    if not np.isfinite(lo):
        return hi
    if not np.isfinite(hi):
        return lo
    return 0.5 * (lo + hi)


@dataclass
class PGMIndex:
    keys: torch.Tensor
    eps: int
    # per level (leaf level first): segment start keys, slopes, intercepts
    seg_keys: list
    seg_slope: list
    seg_icept: list

    @property
    def n(self) -> int:
        return int(self.keys.shape[0])

    @property
    def n_segments(self) -> int:
        return int(self.seg_keys[0].shape[0])


def build_pgm(keys, eps: int = 64, *, device=None) -> PGMIndex:
    """Build on the host, then put the keys and segment tables on
    ``device`` (CUDA unless ``device="cpu"``)."""
    dev = resolve_device(device)
    keys_np = _host(keys)
    seg_keys, seg_slope, seg_icept = [], [], []
    cur = keys_np
    while True:
        starts, slope = _shrinking_cone(cur, eps)
        icept = starts - slope * cur[starts]     # line through (key[s], s)
        for out, arr in ((seg_keys, cur[starts]), (seg_slope, slope),
                         (seg_icept, icept)):
            out.append(torch.as_tensor(arr, dtype=_F64, device=dev))
        if starts.size <= 1:
            break
        cur = cur[starts]
    return PGMIndex(keys=torch.tensor(keys_np, device=dev), eps=eps,
                    seg_keys=seg_keys, seg_slope=seg_slope,
                    seg_icept=seg_icept)


def lookup(index: PGMIndex, queries) -> torch.Tensor:
    """Left-boundary rank of each query, int32 (``rmi.lookup``'s
    semantics)."""
    q = torch.as_tensor(queries, dtype=_F64, device=index.keys.device)
    lo, hi = _pgm_window(index, q)
    return verified_search(index.keys, q, lo, hi, iters=_eps_iters(index.eps))


def eps_window(pred: torch.Tensor, eps: int, n: int):
    """``clip(pred.astype(int32) - eps, 0, n - 1)`` and
    ``clip(pred.astype(int32) + eps + 2, 1, n)`` as XLA computes them: the
    conversion saturates (NaN -> 0, beyond int32 -> its extremes), then the
    int32 offset wraps before the clip.  Returns int32 (lo, hi)."""
    p = torch.where(torch.isnan(pred), 0.0,
                    pred.clamp(-2.0 ** 31, 2.0 ** 31 - 1)).to(torch.int64)

    def wrap(v):
        return (v + 2 ** 31) % 2 ** 32 - 2 ** 31

    return (wrap(p - eps).clamp(0, n - 1).to(_I32),
            wrap(p + eps + 2).clamp(1, n).to(_I32))


def _pgm_window(index: PGMIndex, q: torch.Tensor):
    """The leaf level's +-eps window of each query after the descent from
    the root level (the last list entry)."""
    eps, sk, sl, si = index.eps, index.seg_keys, index.seg_slope, \
        index.seg_icept
    seg = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    for lvl in range(len(sk) - 1, 0, -1):
        nxt_keys = sk[lvl - 1]
        m = nxt_keys.shape[0]
        lo, hi = eps_window(sl[lvl][seg] * q + si[lvl][seg], eps, m)
        # rank among the next level's start keys: the last start <= q,
        # in a window 2*eps+2 wide by the cone bound (unverified, as in
        # the reference)
        pos = bounded_search(nxt_keys, q, lo, hi,
                             iters=_eps_iters(eps)).long()
        nxt = nxt_keys[pos.clamp(0, m - 1)]
        seg = torch.where((pos < m) & (nxt == q), pos,
                          (pos - 1).clamp(min=0))
    # duplicate-heavy keys can exceed the cone bound (duplicates carry no
    # slope constraint): the caller's verified search keeps lookups exact
    return eps_window(sl[0][seg] * q + si[0][seg], eps, index.n)


def _eps_iters(eps: int) -> int:
    """Search depth for a +-eps window (2*eps+2 positions)."""
    return full_iters(2 * eps + 2)
