"""The training step (a port of ``repro.train.step``): the reference's
``shard_map`` step over the positions of a ``models.sharding.ModelMesh``,
and on one device that step on one position.

``make_train_step(cfg, lr=...)`` returns ``step(params, opt, inputs,
labels, pos) -> (params, opt, metrics)``: the loss ``lm_loss(forward(mode=
"train"))`` and its gradient by autograd, the global gradient norm, the
clip scale ``min(1, 1 / max(gnorm, 1e-12))`` and ``optimizer.update``.
The parameters and the optimizer state are updated in place (the
reference donates them to its jit) and returned.  ``metrics`` holds the
loss and the gradient norm as 0-d f32 tensors on the device: nothing is
read back to the host here.

``make_train_step(cfg, mesh, ...)`` returns the reference's ``step(params,
opt, residual, inputs, labels, pos) -> (params, opt, residual, metrics)``
over lists with one entry a position (``step.in_specs`` /
``step.out_specs`` say how ``serve.step.shard_tree`` cuts the global trees
and ``gather_tree`` puts them back).  One process drives every position,
so the positions' forward programs are one autograd graph, and the step
differentiates ONE copy of the loss (position 0's; after the loss's sums
over ``model`` and the batch axes every position holds the same scalar).
Every position's leaves enter the graph as leaves of their own (positions
of one device may share a stored tensor), so each receives its own
position's share; FSDP leaves receive their ``data`` group's through the
gather's reduce-scatter.  The gradients are then summed over the axes
their leaf is replicated on (``param_sync_axes``, ``ModelMesh.
grad_sync``), which the reference's varying-axes types do by
themselves.  That sum includes ``pod``: the reference's gradients arrive
summed over ``pod`` already, and its step sums them over ``pod`` a second
time (``repro/train/step.py:140-145``), so every mesh with a pod axis of
two trains on twice the gradient.  The port keeps that (ROADMAP queue 3).

Collective inventory of a mesh step (``models.sharding.COLLECTIVES``):
``fsdp_gather`` (a superblock's leaves, again in remat's recompute) and
its transpose ``reduce_scatter``, ``tp_psum`` (a block's output, the
embedding, the loss's sums; their transposes in the backward),
``pmax`` (the loss's offset), ``batch_psum`` (the loss), ``grad_sync``
(replicated leaves' gradients and the norm's squares), ``pod_psum`` or,
with ``compress_pod``, ``pod_pmax`` and ``pod_psum_int8``.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models import layers
from ..models import model as M
from ..models.sharding import ModelMesh, batch_axes_for, each_stored
from . import grad_compress, optimizer

F32 = torch.float32


def batch_shapes(cfg, global_batch: int, seq_len: int) -> dict:
    """(shape, dtype) of each input of a step, the reference's: ids (B, S)
    int32, or embeddings (B, S, d) bf16 where ``cfg.embed_input``; labels
    (B, S) int32; positions (B, S) int32, or (3, B, S) for M-RoPE."""
    B, S = global_batch, seq_len
    inputs = ((B, S, cfg.d_model), torch.bfloat16) if cfg.embed_input \
        else ((B, S), torch.int32)
    pos = (3, B, S) if cfg.rope == "mrope" else (B, S)
    return {"inputs": inputs, "labels": ((B, S), torch.int32),
            "pos": (pos, torch.int32)}


def batch_specs(cfg, mesh) -> dict:
    """The inputs' PartitionSpecs on ``mesh``: the batch over pod and
    data (``repro/train/step.py:26``)."""
    b_ax = batch_axes_for(mesh) or None
    tok = (b_ax, None, None) if cfg.embed_input else (b_ax, None)
    pos = (None, b_ax, None) if cfg.rope == "mrope" else (b_ax, None)
    return {"inputs": tok, "labels": (b_ax, None), "pos": pos}


def auto_microbatch(cfg, global_batch: int, seq_len: int, *, mesh=None,
                    budget_bytes: float = 2.5e9) -> int:
    """The reference's microbatch count: the smallest power of two (at
    most the local batch) for which the remat checkpoints, one saved x a
    superblock, ``B_local / nmb * S * d_model * 2 B * n_sb``, fit the
    budget; ``B_local`` the batch over the mesh's pod and data sizes."""
    n_batch = 1
    for a in (batch_axes_for(mesh) if mesh is not None else ()):
        n_batch *= mesh.axis_size(a)
    b_local = max(global_batch // n_batch, 1)
    width = cfg.d_model * (3 if "mamba" in cfg.pattern else 1)
    saved = b_local * seq_len * width * 2 * cfg.n_sb
    nmb = 1
    while saved / nmb > budget_bytes and nmb < b_local:
        nmb *= 2
    return nmb


def _clip(gnorm: torch.Tensor) -> torch.Tensor:
    return torch.minimum(torch.ones((), dtype=F32, device=gnorm.device),
                         1.0 / torch.clamp_min(gnorm, 1e-12))


def make_train_step(cfg, mesh=None, *, lr: float = 3e-4, remat: bool = True,
                    microbatch: int = 1, compress_pod: bool = False,
                    psum_dtype=None):
    """With ``mesh``: ``_mesh_step``.  ``compress_pod`` (the int8 sum over
    ``pod``) and ``psum_dtype`` (the dtype of every ``tp_psum``, the
    reference's ``set_psum_dtype``) act only there.

    One device: ``step(params, opt, inputs, labels, pos) -> (params, opt,
    metrics)``, the mesh step on one position (a mesh with no axes on the
    inputs' device, where every collective is the identity), its trees
    and tensors passed in and out bare.

    ``microbatch`` > 1 splits the (local) batch into that many slices
    taken one after another, accumulating f32 gradients (``acc +
    f32(g)``) and the loss, both divided by the count at the end, as the
    reference's scan does; M-RoPE's (3, B, S) ids are sliced on their
    batch axis, 1."""
    if mesh is not None:
        if psum_dtype is not None:
            mesh = dataclasses.replace(mesh, psum_dtype=psum_dtype)
        return _mesh_step(cfg, mesh, lr=lr, remat=remat,
                          microbatch=microbatch, compress_pod=compress_pod)
    if compress_pod or psum_dtype is not None:
        raise ValueError("compress_pod and psum_dtype act on a mesh's "
                         "collectives: pass mesh= (a ModelMesh)")
    layers._no_tp(cfg.tp_shard)
    steps = {}

    def step(params, opt, inputs, labels, pos):
        dev = inputs.device
        if dev not in steps:
            steps[dev] = _mesh_step(cfg, ModelMesh((), (), devices=dev),
                                    lr=lr, remat=remat,
                                    microbatch=microbatch,
                                    compress_pod=False)
        ps, st, _, metrics = steps[dev]([params], [opt], None, [inputs],
                                        [labels], [pos])
        return ps[0], st[0], metrics

    return step


def _mesh_step(cfg, mesh, *, lr: float, remat: bool, microbatch: int,
               compress_pod: bool):
    """The reference's ``shard_map`` step over the positions of ``mesh``:
    ``step(params, opt, residual, inputs, labels, pos) -> (params, opt,
    residual, metrics)``, each argument a list over the positions (the
    parameters, the AdamW state and, with ``compress_pod``, the residual
    cut by ``param_specs``; ``residual`` passes through untouched
    otherwise).  Per microbatch: the forward, position 0's loss
    differentiated (``torch.autograd.grad`` of every position's own
    leaves; a leaf its position does not reach gets zeros), each leaf's
    gradients summed over its replication axes (``grad_sync``, in the
    gradient's dtype); the microbatches' f32 sum divided by their count;
    then the sum over ``pod`` where the mesh names it (again: the
    reference's double count), int8 with ``compress_pod``; the norm
    weighted by ``1 / copies`` over data and model, the clip, and the
    update, once per stored tensor.  ``metrics``: position 0's loss and
    norm."""
    D = mesh.size
    specs = M.param_specs(cfg)
    sync = [tuple(a for a in s.split(",") if a)
            for s in optimizer.leaves(M.param_sync_axes(cfg))]
    weights = []
    for axes in sync:
        n = 1
        for a in axes:
            if a in ("data", "model"):
                n *= mesh.axis_size(a)
        weights.append(1.0 / n)
    has_pod = "pod" in mesh.axis_names
    bs = batch_specs(cfg, mesh)

    def grads_of(ps, flat, inputs, labels, pos) -> tuple:
        """(position 0's loss, the synced gradients leaf-major: one list
        over the positions a leaf)."""
        x, _ = M.forward(ps, cfg, inputs, pos=pos, mode="train",
                         remat=remat, mesh=mesh)
        loss = M.lm_loss(ps, cfg, x, labels, cfg.tp_shard, mesh=mesh)
        wrt = [t for fl in flat for t in fl]
        got = torch.autograd.grad(loss[0], wrt, allow_unused=True)
        n = len(flat[0])
        out = []
        for i in range(n):
            gi = [got[r * n + i] for r in range(D)]
            gi = [torch.zeros_like(flat[r][i]) if g is None else g
                  for r, g in enumerate(gi)]
            out.append(mesh.grad_sync(gi, sync[i]))
        return loss[0].detach(), out

    def step(params, opt, residual, inputs, labels, pos):
        B = inputs[0].shape[0]
        if B % microbatch:
            raise ValueError(f"local batch {B} is not a multiple of "
                             f"microbatch {microbatch}")
        ps = [M.tree_map(lambda t: t.detach().requires_grad_(), p)
              for p in params]
        flat = [optimizer.leaves(p) for p in ps]
        if microbatch == 1:
            loss, grads = grads_of(ps, flat, inputs, labels, pos)
        else:
            n = B // microbatch
            grads, lsum = None, torch.zeros((), dtype=F32,
                                            device=inputs[0].device)
            for i in range(microbatch):
                sl = slice(i * n, (i + 1) * n)
                p_sl = [p[:, sl] if cfg.rope == "mrope" else p[sl]
                        for p in pos]
                l, g = grads_of(ps, flat, [t[sl] for t in inputs],
                                [t[sl] for t in labels], p_sl)
                g = [each_stored(lambda t: t.to(F32), gi) for gi in g]
                grads = g if grads is None else \
                    [each_stored(torch.add, a, gi)
                     for a, gi in zip(grads, g, strict=True)]
                lsum = lsum + l
                del g
            grads = [each_stored(lambda t: t / microbatch, a) for a in grads]
            loss = lsum / microbatch
        del ps, flat
        by_pos = [[g[r] for g in grads] for r in range(D)]
        del grads
        if has_pod:
            if compress_pod:
                by_pos, residual = grad_compress.compressed_pod_psum(
                    by_pos, residual, mesh)
            else:
                lm = [mesh.pod_psum([g[i] for g in by_pos])
                      for i in range(len(by_pos[0]))]
                by_pos = [[g[r] for g in lm] for r in range(D)]
        gnorm = optimizer.global_grad_norm(by_pos, weights, mesh)
        scale = each_stored(_clip, gnorm)
        params, opt = optimizer.update(params, by_pos, opt, lr=lr,
                                       scale=scale)
        return params, opt, residual, {"loss": loss, "grad_norm": gnorm[0]}

    res_spec = specs if compress_pod else None
    step.in_specs = (specs, optimizer.state_specs(specs), res_spec,
                     bs["inputs"], bs["labels"], bs["pos"])
    step.out_specs = (specs, optimizer.state_specs(specs), res_spec,
                      {"loss": (), "grad_norm": ()})
    step.mesh = mesh
    return step
