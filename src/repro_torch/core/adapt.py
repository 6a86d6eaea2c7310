"""Model adaptation (paper §3 "Model adaptation", Lemma 3.2; counterpart of
``repro.core.adapt``).

A pool model trained on keys in [xs_s, xs_e] predicting positions in
[ys_s, ys_e] serves a target with key range [xt_s, xt_e] and position range
[yt_s, yt_e] through T_in(x) = a1*x + b1 and T_out(y) = a2*y + b2:

    a1 = S_dx = (xs_e - xs_s)/(xt_e - xt_s),   b1 = xs_s - xt_s * S_dx
    a2 = S_dy = (yt_e - yt_s)/(ys_e - ys_s),   b2 = yt_s - ys_s * S_dy

Both maps fold exactly into the model: into (a', b') for a linear model,
into the first and last layer of the 1x4 MLP.  Everything is f64 and
batched over leading axes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .models import LinearParams, MLPParams


class DomainSpec(NamedTuple):
    """Key/position ranges of a dataset, as used by T_in / T_out."""
    x_start: torch.Tensor
    x_end: torch.Tensor
    y_start: torch.Tensor
    y_end: torch.Tensor


def affine_coeffs(src: DomainSpec, tgt: DomainSpec):
    """((a1, b1), (a2, b2)) of T_in / T_out."""
    s_dx = (src.x_end - src.x_start) / (tgt.x_end - tgt.x_start)
    s_dy = (tgt.y_end - tgt.y_start) / (src.y_end - src.y_start)
    a1, b1 = s_dx, src.x_start - tgt.x_start * s_dx
    a2, b2 = s_dy, tgt.y_start - src.y_start * s_dy
    return (a1, b1), (a2, b2)


def adapt_linear(p: LinearParams, src: DomainSpec,
                 tgt: DomainSpec) -> LinearParams:
    """Lemma 3.2: a' = a*S_dx*S_dy, b' = (a*b1 + b)*S_dy + b2."""
    (a1, b1), (a2, b2) = affine_coeffs(src, tgt)
    return LinearParams(a=p.a * a1 * a2, b=(p.a * b1 + p.b) * a2 + b2)


def adapt_mlp(p: MLPParams, src: DomainSpec, tgt: DomainSpec) -> MLPParams:
    """The exact MLP fold: the first layer absorbs T_in, the last T_out.
    ``p`` is stacked (B, H) / (B,) against (B,) domains."""
    (a1, b1), (a2, b2) = affine_coeffs(src, tgt)
    col = lambda v: v.unsqueeze(-1) if p.w1.dim() > v.dim() else v
    return MLPParams(w1=p.w1 * col(a1), b1=p.w1 * col(b1) + p.b1,
                     w2=p.w2 * col(a2), b2=p.b2 * a2 + b2)


def domain_of(sorted_keys: torch.Tensor) -> DomainSpec:
    """DomainSpec of a sorted dataset with positions 0..n-1."""
    n = sorted_keys.shape[0]
    z = torch.zeros((), dtype=torch.float64, device=sorted_keys.device)
    return DomainSpec(x_start=sorted_keys[0], x_end=sorted_keys[-1],
                      y_start=z, y_end=z + float(n - 1))
