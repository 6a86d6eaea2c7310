"""The int8 gradient sum over the ``pod`` axis with error feedback (a port of
``repro.train.grad_compress``).

The pod axis is the slowest link between a multi-pod mesh's positions, so
the reference offers to send its gradient sum quantised: per leaf and
position, ``g = g + residual``, a scale ``max(max |g|, 1e-12) / 127``
(its max over ``pod``), ``q = clip(round(g / scale), -127, 127)`` as
int8, the new residual ``g - q scale``, and the sum over ``pod`` of q in
int32 times the scale.  ``torch.round`` rounds half to even, as
``jnp.round`` does, so both packages quantise a tie alike.

Trees on a mesh are lists over its positions (``models.sharding.
ModelMesh``); each leaf's work is done once for the positions of a device
that share its gradient and residual tensors (``sharding.each_stored``).
``COLLECTIVES`` counts the scale's max under ``pod_pmax`` and the sum
under ``pod_psum_int8``, its bytes those of the int8 payload (the
reference sums it as int32).
"""
from __future__ import annotations

import torch

from ..models.model import tree_map
from ..models.sharding import each_stored, once_per_stored
from .optimizer import leaves

F32 = torch.float32


def init_residual(params):
    """f32 zeros shaped as ``params`` (a tree, or a list of trees over a
    mesh's positions; a tensor shared by several positions gets one
    residual they share)."""
    zeros = once_per_stored(
        lambda p: torch.zeros(p.shape, dtype=F32, device=p.device))
    if isinstance(params, list):
        return [tree_map(zeros, t) for t in params]
    return tree_map(zeros, params)


def _quantise(g: torch.Tensor, r: torch.Tensor) -> tuple:
    """(g + r in f32, its scale before the max over pod)."""
    g = g.to(F32) + r
    return g, torch.clamp_min(g.abs().amax(), 1e-12) / 127.0


def _levels(g: torch.Tensor, scale: torch.Tensor) -> tuple:
    """(the int8 levels of g at ``scale``, the new residual g - q scale)."""
    lv = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return lv, g - lv.to(F32) * scale


def compressed_pod_psum(grads: list, residual: list, mesh) -> tuple:
    """``grads`` (a leaves list a position) summed over ``pod`` through
    int8 with error feedback; ``residual`` a tree a position.  Returns
    (the summed gradients, f32, a leaves list a position; the new
    residual trees)."""
    D = mesh.size
    res = [leaves(t) for t in residual]
    n_leaves = len(grads[0])
    new_g = [[None] * n_leaves for _ in range(D)]
    new_r = [[None] * n_leaves for _ in range(D)]
    for i in range(n_leaves):
        made = each_stored(_quantise, [g[i] for g in grads],
                           [t[i] for t in res])
        g = [m[0] for m in made]
        scale = mesh.pmax([m[1] for m in made], "pod", kind="pod_pmax")
        done = each_stored(_levels, g, scale)
        for r in range(D):
            new_r[r][i] = done[r][1]
        summed = mesh.pod_psum([d[0].to(torch.int32) for d in done],
                               kind="pod_psum_int8", itemsize=1)
        got = each_stored(lambda lv, s: lv.to(F32) * s, summed, scale)
        for r in range(D):
            new_g[r][i] = got[r]
    out_r = []
    for r in range(D):
        new = {id(a): b for a, b in zip(res[r], new_r[r], strict=True)}
        out_r.append(tree_map(lambda t, _n=new: _n[id(t)], residual[r]))
    return new_g, out_r
