"""AdamW with f32 master weights (a port of ``repro.train.optimizer`` on one
device: no sharding specs, no psum).

The state's leaves mirror the parameter tree (``mu``, ``nu`` and
``master`` f32, ``step`` an int32 scalar), so a checkpoint of
``{"params": ..., "opt": ...}`` has the reference's leaf paths.  Trees are
walked in the reference's leaf order (``jax.tree.leaves``: dict keys
sorted, NamedTuple fields in order, ``None`` skipped), which fixes the
order of ``global_grad_norm``'s sum.

``update`` works in place (the reference donates its buffers to the jit):
it rewrites the moments, the master weights and the bf16 parameters and
returns the same objects.  Its arithmetic is the reference's, in f32, in
the reference's order of operations.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.persist import tree_paths
from ..models.model import tree_map

F32 = torch.float32


class AdamWState(NamedTuple):
    mu: dict
    nu: dict
    master: dict
    step: torch.Tensor


def leaves(tree) -> list:
    """The tensors of a tree of dicts and NamedTuples, in the reference's
    leaf order (``core.persist.tree_paths``' order)."""
    return [t for _, t in tree_paths(tree)]


def init(params: dict) -> AdamWState:
    """Zero moments, the parameters upcast to f32 as the master weights,
    step 0, all on the parameters' device."""
    dev = leaves(params)[0].device
    zeros = lambda p: torch.zeros(p.shape, dtype=F32, device=p.device)
    return AdamWState(mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                      master=tree_map(lambda p: p.detach().to(F32), params),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The f32 square root correctly rounded, as XLA and CUDA give it.
    torch's CPU kernel is off by an ulp on some inputs; there the root
    is taken in f64 and rounded once (exact: 53 bits cover the 2 x 24 + 2
    a correctly rounded f32 root needs)."""
    if x.device.type == "cuda":
        return torch.sqrt(x)
    return torch.sqrt(x.to(torch.float64)).to(F32)


def global_grad_norm(grads) -> torch.Tensor:
    """The L2 norm of every gradient (a tree or its ``leaves`` list), in
    f32: each leaf's sum of squares, added in leaf order, then the square
    root (one device: no psum)."""
    sq = None
    for g in grads if isinstance(grads, list) else leaves(grads):
        t = (g.to(F32) ** 2).sum()
        sq = t if sq is None else sq + t
    return sqrt_rn(sq)


@torch.no_grad()
def update(params: dict, grads, st: AdamWState, *, lr: float,
           scale: torch.Tensor | float = 1.0, b1: float = 0.9,
           b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
           dtype=torch.bfloat16):
    """One AdamW step, in place; returns ``(params, state)``.  ``grads``
    mirrors ``params`` (a tree or its ``leaves`` list); ``scale`` is the
    caller's clip multiplier.  Per leaf, in f32: ``g = g * scale``, ``mu =
    b1 mu + (1 - b1) g``, ``nu = b2 nu + (1 - b2) g g``, ``m = m - lr
    ((mu / c1) / (sqrt(nu / c2) + eps) + wd m)`` with ``c = 1 - b **
    step``; the parameters become ``m`` rounded to ``dtype``."""
    step = st.step + 1
    sf = step.to(F32)
    c1 = 1.0 - torch.pow(torch.full((), b1, dtype=F32, device=sf.device), sf)
    c2 = 1.0 - torch.pow(torch.full((), b2, dtype=F32, device=sf.device), sf)
    flat_g = grads if isinstance(grads, list) else leaves(grads)
    for p, g, mu, nu, m in zip(leaves(params), flat_g, leaves(st.mu),
                               leaves(st.nu), leaves(st.master), strict=True):
        g = g.to(F32) * scale
        mu.mul_(b1).add_((1 - b1) * g)
        nu.mul_(b2).add_((1 - b2) * g * g)
        upd = (mu / c1).div_(sqrt_rn(nu / c2).add_(eps))
        upd.add_(weight_decay * m)
        m.sub_(upd.mul_(lr))
        # tracelint: ok[hot-sync](a device copy of the new weights; the call graph links this train-step update to a serve path by its name)
        p.copy_(m.to(dtype))
    return params, st._replace(step=step)
