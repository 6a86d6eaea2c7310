"""Index models (counterpart of ``repro.core.models``): the linear model and
the paper's 1-hidden-layer / 4-neuron network, with batched training.

Each model predicts a storage position from a key (positions 0..n-1); the
error bounds are the residual extrema, position in [pred + err_lo,
pred + err_hi].  Parameters are f64 and may carry leading batch axes (one
model per pool entry or per leaf); every function here works on a whole
batch at once.

Training differs from the reference in one way only: initial parameters
come from a ``torch.Generator`` instead of ``jax.random``, so a model
trained here is not the reference's model.  :func:`mlp_train` takes its
initial parameters explicitly, so a test can start both packages from the
same point.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

HIDDEN = 4  # paper: "one hidden layer of four neurons"
_F64 = torch.float64


class LinearParams(NamedTuple):
    a: torch.Tensor  # slope, f64
    b: torch.Tensor  # intercept, f64


def linear_predict(p: LinearParams, x: torch.Tensor) -> torch.Tensor:
    return p.a * x + p.b


def linear_fit(keys: torch.Tensor, pos: torch.Tensor) -> LinearParams:
    """Closed-form least squares of position on key over the last axis,
    in f64 (leading axes are separate datasets)."""
    x = keys.to(_F64)
    y = pos.to(_F64)
    n = x.shape[-1]
    sx, sy = x.sum(-1), y.sum(-1)
    sxx, sxy = (x * x).sum(-1), (x * y).sum(-1)
    denom = n * sxx - sx * sx
    a = torch.where(denom.abs() > 1e-30, (n * sxy - sx * sy) / denom,
                    torch.zeros_like(denom))
    b = (sy - a * sx) / n
    return LinearParams(a=a, b=b)


def take_rows(p, idx):
    """Rows ``idx`` of every field of stacked parameters."""
    return type(p)(*(a[idx] for a in p))


def where_rows(mask, new, old):
    """Stacked parameters: ``new``'s rows where ``mask``, else ``old``'s."""
    sel = lambda a, o: torch.where(
        mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, o)
    return type(new)(*(sel(a, o) for a, o in zip(new, old, strict=True)))


# ---------------------------------------------------------------------------
# 1x4 MLP.  Keys are fed normalized to [0, 1]; the output is a position.
# ---------------------------------------------------------------------------
class MLPParams(NamedTuple):
    w1: torch.Tensor  # (..., HIDDEN)
    b1: torch.Tensor  # (..., HIDDEN)
    w2: torch.Tensor  # (..., HIDDEN)
    b2: torch.Tensor  # (...)


def mlp_init(generator: torch.Generator | None = None, batch: tuple = (),
             device=None) -> MLPParams:
    """Init for CDF-shaped targets on [0, 1] (the reference's recipe):
    positive slopes with ReLU kinks spread across the domain so no unit is
    dead over the input range.  ``batch`` stacks independent draws."""
    dev = torch.device("cpu") if device is None else torch.device(device)
    if generator is not None:
        dev = generator.device
    shape = tuple(batch) + (HIDDEN,)
    w1 = 1.0 + torch.randn(shape, dtype=_F64, device=dev,
                           generator=generator).abs() * 2.0
    kinks = torch.linspace(0.0, 0.75, HIDDEN, dtype=_F64, device=dev)
    return MLPParams(
        w1=w1, b1=-w1 * kinks,
        w2=torch.randn(shape, dtype=_F64, device=dev,
                       generator=generator).abs(),
        b2=torch.zeros(tuple(batch), dtype=_F64, device=dev))


def _lift(p: MLPParams, x: torch.Tensor):
    """(w1, b1, w2, b2) reshaped so that column k broadcasts against ``x``:
    the parameters' leading axes align with the leading axes of ``x``."""
    lead = p.b2.dim()
    extra = x.dim() - lead
    if extra < 0:
        raise ValueError("x has fewer axes than the parameter batch")
    col = lambda a: a.reshape(a.shape[:lead] + (1,) * extra + a.shape[lead:])
    return col(p.w1), col(p.b1), col(p.w2), p.b2.reshape(
        p.b2.shape + (1,) * extra)


def _hidden(w1, b1, x, k):
    z = x * w1[..., k] + b1[..., k]
    return z, torch.where(z > 0, z, torch.zeros_like(z))


def mlp_predict(p: MLPParams, x: torch.Tensor) -> torch.Tensor:
    """Predicted positions of ``x``: ``sum_k relu(x*w1_k + b1_k) * w2_k +
    b2``, the terms summed in order k = 0..3."""
    w1, b1, w2, b2 = _lift(p, x)
    s = torch.zeros_like(x, dtype=_F64)
    for k in range(HIDDEN):
        s = s + _hidden(w1, b1, x, k)[1] * w2[..., k]
    return s + b2


def mlp_train(p0: MLPParams, xs: torch.Tensor, ys: torch.Tensor,
              steps: int = 400, lr: float = 0.1,
              mask: torch.Tensor | None = None) -> MLPParams:
    """Full-batch Adam fit of tiny MLPs from ``p0``: xs (..., n) in [0, 1]
    -> ys positions, one model per leading index.  ``mask`` (0/1 per
    point) serves ragged batches padded to a common width.  The loss is
    ``sum(mask * ((pred - ys) / yscale)**2) / max(sum(mask), 1)``; its
    gradient is written out by hand, in f64."""
    xs = xs.to(_F64)
    ys = ys.to(_F64)
    mask = torch.ones_like(xs) if mask is None else mask.to(_F64)
    denom = mask.sum(-1).clamp(min=1.0)
    yscale = (ys * mask).abs().amax(-1).clamp(min=1.0)
    # d loss / d pred = coef * mask * (pred - ys)
    coef = (2.0 / (yscale * yscale * denom)).unsqueeze(-1)
    p = MLPParams(*(a.to(_F64).clone() for a in p0))
    mu = MLPParams(*(torch.zeros_like(a) for a in p))
    nu = MLPParams(*(torch.zeros_like(a) for a in p))
    for step in range(1, steps + 1):
        w1, b1, w2, b2 = _lift(p, xs)
        pred = torch.zeros_like(xs)
        hs, gates = [], []
        for k in range(HIDDEN):
            z, h = _hidden(w1, b1, xs, k)
            pred = pred + h * w2[..., k]
            hs.append(h)
            gates.append(z > 0)
        r = coef * mask * (pred + b2 - ys)
        g_b2 = r.sum(-1)
        g_w2, g_b1, g_w1 = [], [], []
        for k in range(HIDDEN):
            g_w2.append((r * hs[k]).sum(-1))
            rk = torch.where(gates[k], r, torch.zeros_like(r)) * w2[..., k]
            g_b1.append(rk.sum(-1))
            g_w1.append((rk * xs).sum(-1))
        del hs, gates, r
        g = MLPParams(w1=torch.stack(g_w1, -1), b1=torch.stack(g_b1, -1),
                      w2=torch.stack(g_w2, -1), b2=g_b2)
        c1 = 1.0 - 0.9 ** step
        c2 = 1.0 - 0.999 ** step
        mu = MLPParams(*(0.9 * m + 0.1 * gi for m, gi in zip(mu, g,
                                                            strict=True)))
        nu = MLPParams(*(0.999 * v + 0.001 * gi * gi
                         for v, gi in zip(nu, g, strict=True)))
        p = MLPParams(*(pi - lr * (m / c1) / (torch.sqrt(v / c2) + 1e-8)
                        for pi, m, v in zip(p, mu, nu, strict=True)))
    return p


def train_pool(generator: torch.Generator | None, xs: torch.Tensor,
               ys: torch.Tensor, steps: int = 400) -> MLPParams:
    """Pre-train a whole pool: xs/ys (P, ns) -> stacked MLPParams (P, ...),
    initial parameters drawn from ``generator``."""
    p0 = mlp_init(generator, batch=(xs.shape[0],), device=xs.device)
    return mlp_train(p0, xs, ys, steps=steps)


# ---------------------------------------------------------------------------
# Error bounds (empirical residual extrema over the last axis).
# ---------------------------------------------------------------------------
def _residual_bounds(r: torch.Tensor):
    return r.amin(-1), r.amax(-1)


def linear_err_bounds(p: LinearParams, xs: torch.Tensor, pos: torch.Tensor):
    a = p.a.unsqueeze(-1) if p.a.dim() and p.a.dim() == xs.dim() - 1 else p.a
    b = p.b.unsqueeze(-1) if p.b.dim() and p.b.dim() == xs.dim() - 1 else p.b
    return _residual_bounds(pos - (a * xs + b))


def mlp_err_bounds(p: MLPParams, xs: torch.Tensor, pos: torch.Tensor):
    return _residual_bounds(pos - mlp_predict(p, xs))
