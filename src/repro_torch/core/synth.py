"""Synthetic dataset generation (paper §3, "Synthetic dataset generation");
a numpy copy of ``repro.core.synth`` (the reference package imports jax on
import, so the port keeps its own copy).  Same seed, same arrays.

The CDF space [0,1]^2 is discretized by the reuse threshold eps: any CDF is
within 1-eps of some grid polyline. The paper limits per-bin probability mass
to {0, (1-eps)/2, (1-eps)} over m = ceil(2/(1-eps)) bins (m=12 at eps=0.9,
matching Table 2), enumerates all such histograms, and samples ns=100 keys
per histogram.

Enumeration: with q = 1-eps, choose i bins of mass q and j bins of mass q/2
with i*q + j*q/2 = 1, i.e. 2i + j = round(2/q). This reproduces Table 2
exactly for eps in {0.5, 0.8, 0.9(m=12)}: 19, 8,953 and 1,221 datasets.
For eps in {0.6, 0.7} the paper reports 95 / 987, which no integral
(i, j) assignment reproduces (2/q = 5 and 6.67); we additionally emit
"remainder" histograms (one extra bin carrying the leftover mass < q/2) so
every mass vector still sums to exactly 1. The discrepancy is recorded by
the reference; the default eps=0.9 configuration is exact.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass

import numpy as np

__all__ = [
    "num_bins",
    "enumerate_histograms",
    "datasets_from_histograms",
    "SyntheticPool",
    "generate_pool",
]


def num_bins(eps: float) -> int:
    """m = ceil(2/(1-eps)); the paper overrides m=12 for eps=0.9 (Table 2)."""
    if abs(eps - 0.9) < 1e-12:
        return 12
    return math.ceil(2.0 / (1.0 - eps) - 1e-9)  # fp-tolerant ceil


def enumerate_histograms(eps: float, m: int | None = None) -> np.ndarray:
    """All m-bin histograms with bin mass in {0, q/2, q}, q = 1-eps, summing
    to 1 (plus remainder-completion histograms when 2/q is fractional).

    Returns (P, m) float64 array of relative frequencies.
    """
    q = 1.0 - eps
    m = num_bins(eps) if m is None else m
    two_over_q = 2.0 / q
    out: list[np.ndarray] = []

    units = int(round(two_over_q))
    exact = abs(two_over_q - units) < 1e-9
    # i bins of mass q (2 half-units), j bins of mass q/2 (1 half-unit).
    for i in range(0, min(m, units // 2) + 1):
        rem_units = (units if exact else int(two_over_q)) - 2 * i
        if rem_units < 0:
            break
        j = rem_units
        leftover = 1.0 - i * q - j * (q / 2.0) if not exact else 0.0
        n_extra = 1 if (not exact and leftover > 1e-12) else 0
        if i + j + n_extra > m:
            continue
        for full_bins in itertools.combinations(range(m), i):
            rest = [b for b in range(m) if b not in full_bins]
            for half_bins in itertools.combinations(rest, j):
                if n_extra:
                    used = set(full_bins) | set(half_bins)
                    for extra in (b for b in range(m) if b not in used):
                        h = np.zeros(m)
                        h[list(full_bins)] = q
                        h[list(half_bins)] = q / 2.0
                        h[extra] = leftover
                        out.append(h)
                else:
                    h = np.zeros(m)
                    h[list(full_bins)] = q
                    h[list(half_bins)] = q / 2.0
                    out.append(h)
    if not out:
        raise ValueError(f"no histograms for eps={eps}, m={m}")
    hists = np.stack(out)
    np.testing.assert_allclose(hists.sum(1), 1.0, atol=1e-9)
    return hists


def datasets_from_histograms(
    hists: np.ndarray, ns: int = 100, seed: int = 0
) -> np.ndarray:
    """Sample one sorted ns-key dataset in [0,1] per histogram (paper: random
    key values per bin, data range [0,1], ns=100). Returns (P, ns) float64.

    Bin counts are largest-remainder rounded so each dataset has exactly ns
    keys; keys are uniform within their bin and sorted.
    """
    rng = np.random.default_rng(seed)
    P, m = hists.shape
    counts = np.floor(hists * ns).astype(np.int64)
    # Largest-remainder method to hit exactly ns per dataset.
    short = ns - counts.sum(1)
    rema = hists * ns - counts
    order = np.argsort(-rema, axis=1)
    for p in range(P):
        for k in range(short[p]):
            counts[p, order[p, k]] += 1
    data = np.empty((P, ns))
    width = 1.0 / m
    for p in range(P):
        vals = []
        for b in range(m):
            c = counts[p, b]
            if c:
                vals.append(b * width + width * rng.random(c))
        data[p] = np.sort(np.concatenate(vals))
    return data


@dataclass(frozen=True)
class SyntheticPool:
    """The raw synthetic corpus: histograms + sampled sorted datasets."""
    eps: float
    m: int
    hists: np.ndarray      # (P, m) relative frequencies
    datasets: np.ndarray   # (P, ns) sorted keys in [0,1]

    @property
    def size(self) -> int:
        return self.hists.shape[0]


def generate_pool(eps: float, ns: int = 100, seed: int = 0,
                  m: int | None = None, limit: int | None = None) -> SyntheticPool:
    """Generate the full synthetic corpus for a reuse threshold eps.

    ``limit`` truncates the corpus (deterministic shuffle first) — useful in
    unit tests; production uses the full enumeration.
    """
    hists = enumerate_histograms(eps, m=m)
    if limit is not None and hists.shape[0] > limit:
        perm = np.random.default_rng(seed + 1).permutation(hists.shape[0])[:limit]
        hists = hists[np.sort(perm)]
    data = datasets_from_histograms(hists, ns=ns, seed=seed)
    return SyntheticPool(eps=eps, m=num_bins(eps) if m is None else m,
                         hists=hists, datasets=data)
