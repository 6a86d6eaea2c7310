"""Error-bound algebra (counterpart of ``repro.core.bounds``): Theorem 3.3's
reuse bounds, Lemma 4.1's insertion budget and the search-window
accounting that sets the static search depth of every lookup kernel."""
from __future__ import annotations

import math

import numpy as np
import torch


def reuse_err_bounds(err_lo, err_hi, dist, n_t, s_dy):
    """Theorem 3.3: bounds of a reused model on the target dataset,
    ``(-dist * n_T + err_lo * S_dy, dist * n_T + err_hi * S_dy)``; sound
    for the Algorithm-2 upper bound dist_h too (Eq. 3)."""
    return -dist * n_t + err_lo * s_dy, dist * n_t + err_hi * s_dy


def widen_for_inserts(err_lo, err_hi, n_inserts):
    """§4: a leaf whose CDF is untouched by i inserts only needs its bounds
    widened by i (positions after the insertion point shift by <= i)."""
    return err_lo - n_inserts, err_hi + n_inserts


def insertion_budget(sim: torch.Tensor, eps: float,
                     n: torch.Tensor) -> torch.Tensor:
    """Lemma 4.1: max #inserts before a rebuild is required,
    ``n_i <= (sim - eps) / (1 + eps - sim) * n``, clamped at 0 (f64)."""
    sim = sim.to(torch.float64)
    return torch.clamp(torch.floor((sim - eps) / (1.0 + eps - sim)
                                   * n.to(torch.float64)), min=0.0)


def insertion_headroom(budget, n_inserts) -> float:
    """Aggregate Lemma 4.1 headroom: sum over leaves of the remaining
    insertion budget max(budget_l - inserts_l, 0).  Host numpy."""
    b = np.asarray(budget, np.float64)
    i = np.asarray(n_inserts, np.float64)
    return float(np.maximum(b - i, 0.0).sum())


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float64).numpy()
    return np.asarray(a, np.float64)


def window_widths(err_lo, err_hi) -> np.ndarray:
    """Per-leaf search-window widths: ceil(err_hi) - floor(err_lo) + 3
    (the +3 is the clamp/rounding slack of the lookup's window math).
    Host numpy: it feeds the static search depth, not tensor code."""
    return np.ceil(_host(err_hi)) - np.floor(_host(err_lo)) + 3.0


def clamped_depth(widths, n_keys: int) -> int:
    """Static branchless-search depth covering the widest *live* window
    (sentinel full-array windows on empty leaves are excluded; queries
    routed there are caught by the seam verification)."""
    # tracelint: ok[hot-sync](widths is the host-side np width mirror)
    w = np.asarray(widths, np.float64)
    live = w < n_keys
    wmax = float(w[live].max()) if live.any() else float(max(n_keys, 2))
    wmax = min(max(wmax, 2.0), float(max(n_keys, 2)))
    return int(math.ceil(math.log2(wmax))) + 1
