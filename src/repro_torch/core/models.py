"""Index models (counterpart of ``repro.core.models``): the linear model.

Each model predicts a storage position from a key (positions 0..n-1); the
error bounds are the residual extrema, position in [pred + err_lo,
pred + err_hi].  The 1x4 MLP and its training wait for the pool-reuse
slice (ROADMAP queue 1 item 6).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

HIDDEN = 4  # paper: "one hidden layer of four neurons"


class LinearParams(NamedTuple):
    a: torch.Tensor  # slope, f64
    b: torch.Tensor  # intercept, f64


def linear_predict(p: LinearParams, x: torch.Tensor) -> torch.Tensor:
    return p.a * x + p.b


def linear_fit(keys: torch.Tensor, pos: torch.Tensor) -> LinearParams:
    """Closed-form least squares of position on key, in f64."""
    x = keys.to(torch.float64)
    y = pos.to(torch.float64)
    n = x.shape[0]
    sx, sy = x.sum(), y.sum()
    sxx, sxy = (x * x).sum(), (x * y).sum()
    denom = n * sxx - sx * sx
    a = torch.where(denom.abs() > 1e-30, (n * sxy - sx * sy) / denom,
                    torch.zeros_like(denom))
    b = (sy - a * sx) / n
    return LinearParams(a=a, b=b)
