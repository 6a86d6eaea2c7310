"""AdamW with f32 master weights (a port of ``repro.train.optimizer``).

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

On a mesh (``models.sharding.ModelMesh``) every tree is a list over its
positions, each leaf the position's shard; the state's leaves carry their
parameter's spec (``state_specs``: ZeRO, the optimizer state as sharded
as the weights).  ``init`` and ``update`` take such lists: positions of
one device may share a stored tensor (``serve.step.shard_tree(...,
share=True)``), and each stored tensor is created and updated once, not
once a position that holds it (``sharding.once_per_stored``).
``global_grad_norm`` takes the reference's weights (``repl_weights``:
one over the number of copies of a leaf across ``data`` and ``model``)
and sums over those axes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.persist import tree_paths
from ..models.model import tree_map
from ..models.sharding import once_per_stored

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


def state_specs(param_specs: dict) -> AdamWState:
    """The state's specs: each moment and master leaf its parameter's,
    the step replicated."""
    return AdamWState(mu=param_specs, nu=param_specs, master=param_specs,
                      step=())


def init(params):
    """Zero moments, the parameters upcast to f32 as the master weights,
    step 0, all on the parameters' device.  A list of trees (a mesh's
    positions) gives a list of states; positions that share a stored
    parameter share its state tensors."""
    if not isinstance(params, list):
        return init([params])[0]
    state = once_per_stored(lambda p: (
        torch.zeros(p.shape, dtype=F32, device=p.device),
        torch.zeros(p.shape, dtype=F32, device=p.device),
        p.detach().to(F32)))
    return [AdamWState(mu=tree_map(lambda p: state(p)[0], t),
                       nu=tree_map(lambda p: state(p)[1], t),
                       master=tree_map(lambda p: state(p)[2], t),
                       step=torch.zeros((), dtype=torch.int32,
                                        device=leaves(t)[0].device))
            for t in params]


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The f32 square root correctly rounded, as XLA and CUDA give it.
    torch's CPU kernel is off by an ulp on some inputs; there the root
    is taken in f64 and rounded once (exact: 53 bits cover the 2 x 24 + 2
    a correctly rounded f32 root needs)."""
    if x.device.type == "cuda":
        return torch.sqrt(x)
    return torch.sqrt(x.to(torch.float64)).to(F32)


def global_grad_norm(grads, repl_weights=None, mesh=None):
    """The L2 norm of every gradient (a tree or its ``leaves`` list), in
    f32: each leaf's sum of squares times its weight (``repl_weights``,
    a list a leaf; none on one device), added in leaf order, then the
    square root.  With ``mesh``, ``grads`` is a list over its positions
    (each a leaves list) and the positions' sums are added over ``data``
    and ``model`` in position order before the root (the reference's
    ``psum_forced(sq, ("data", "model"))``): a list of the norm on every
    position."""
    if mesh is None:
        return sqrt_rn(_sum_squares(grads, repl_weights))
    sq = [_sum_squares(g, repl_weights) for g in grads]
    sq = mesh.grad_sync(sq, ("data", "model"))
    return [sqrt_rn(t) for t in sq]


def _sum_squares(grads, weights=None) -> torch.Tensor:
    sq = None
    flat = grads if isinstance(grads, list) else leaves(grads)
    for i, g in enumerate(flat):
        t = (g.to(F32) ** 2).sum()
        if weights is not None:
            t = weights[i] * t
        sq = t if sq is None else sq + t
    return sq


def _bias_corrections(step: torch.Tensor, b1: float, b2: float) -> tuple:
    sf = step.to(F32)
    c1 = 1.0 - torch.pow(torch.full((), b1, dtype=F32, device=sf.device), sf)
    c2 = 1.0 - torch.pow(torch.full((), b2, dtype=F32, device=sf.device), sf)
    return c1, c2


def _adamw_leaf(p, g, mu, nu, m, *, c1, c2, scale, lr, b1, b2, eps,
                weight_decay, dtype) -> None:
    """One stored leaf's AdamW step, in place."""
    g = g.to(F32) * scale
    mu.mul_(b1).add_((1 - b1) * g)
    nu.mul_(b2).add_((1 - b2) * g * g)
    upd = (mu / c1).div_(sqrt_rn(nu / c2).add_(eps))
    upd.add_(weight_decay * m)
    m.sub_(upd.mul_(lr))
    # tracelint: ok[hot-sync](a device copy of the new weights; the call graph links this train-step update to a serve path by its name)
    p.copy_(m.to(dtype))


@torch.no_grad()
def update(params, grads, st, *, lr: float,
           scale: torch.Tensor | float | list = 1.0, b1: float = 0.9,
           b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
           dtype=torch.bfloat16):
    """One AdamW step, in place; returns ``(params, state)``.  ``grads``
    mirrors ``params`` (a tree or its ``leaves`` list); ``scale`` is the
    caller's clip multiplier.  Per leaf, in f32: ``g = g * scale``, ``mu =
    b1 mu + (1 - b1) g``, ``nu = b2 nu + (1 - b2) g g``, ``m = m - lr
    ((mu / c1) / (sqrt(nu / c2) + eps) + wd m)`` with ``c = 1 - b **
    step``; the parameters become ``m`` rounded to ``dtype``.

    On a mesh ``params``, ``grads`` (leaves lists), ``st`` and ``scale``
    are lists over its positions; a stored parameter that several
    positions share is updated once, from the first of them (their
    gradients and states are the same)."""
    kw = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
              dtype=dtype)
    if not isinstance(params, list):
        flat_g = grads if isinstance(grads, list) else leaves(grads)
        params, (st,) = update([params], [flat_g], [st], scale=scale, **kw)
        return params[0], st
    # once a stored parameter: its first holder's gradient and state
    leaf, out = once_per_stored(_adamw_leaf, key=lambda p, *_: (p,)), []
    for r, (pr, gr, sr) in enumerate(zip(params, grads, st, strict=True)):
        step = sr.step + 1
        c1, c2 = _bias_corrections(step, b1, b2)
        sc = scale[r] if isinstance(scale, list) else scale
        for p, g, mu, nu, m in zip(leaves(pr), gr, leaves(sr.mu),
                                   leaves(sr.nu), leaves(sr.master),
                                   strict=True):
            leaf(p, g, mu, nu, m, c1=c1, c2=c2, scale=sc, **kw)
        out.append(sr._replace(step=step))
    return params, out
