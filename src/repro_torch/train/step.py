"""The training step on one device (a port of ``repro.train.step`` without
the mesh: no shard_map, no psums, no jit).

``make_train_step(cfg, lr=...)`` returns ``step(params, opt, inputs,
labels, pos) -> (params, opt, metrics)``: the loss ``lm_loss(forward(mode=
"train"))`` and its gradient by autograd, the global gradient norm, the
clip scale ``min(1, 1 / max(gnorm, 1e-12))`` and ``optimizer.update``.
The parameters and the optimizer state are updated in place (the
reference donates them to its jit) and returned.  ``metrics`` holds the
loss and the gradient norm as 0-d f32 tensors on the device: nothing is
read back to the host here.
"""
from __future__ import annotations

import torch

from .. import not_ported
from ..models import model as M
from . import optimizer

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


def auto_microbatch(cfg, global_batch: int, seq_len: int, *,
                    budget_bytes: float = 2.5e9) -> int:
    """The reference's microbatch count on one card: the smallest power of
    two (at most the batch) for which the remat checkpoints, one saved x a
    superblock, ``B / nmb * S * d_model * 2 B * n_sb``, fit the budget."""
    width = cfg.d_model * (3 if "mamba" in cfg.pattern else 1)
    saved = global_batch * seq_len * width * 2 * cfg.n_sb
    nmb = 1
    while saved / nmb > budget_bytes and nmb < global_batch:
        nmb *= 2
    return nmb


def make_train_step(cfg, *, lr: float = 3e-4, remat: bool = True,
                    microbatch: int = 1, compress_pod: bool = False):
    """``step(params, opt, inputs, labels, pos) -> (params, opt,
    metrics)``.  ``microbatch`` > 1 splits the batch into that many slices
    taken one after another, accumulating f32 gradients (``acc + f32(g)``)
    and the loss, both divided by the count at the end, as the
    reference's scan does; M-RoPE's (3, B, S) ids are sliced on their
    batch axis, 1."""
    if compress_pod:
        raise not_ported("compress_pod (the int8 gradient psum over a pod "
                         "axis: multi-card training)", "14e")

    def loss_and_grads(ps, inputs, labels, pos):
        x, _ = M.forward(ps, cfg, inputs, pos=pos, mode="train", remat=remat)
        loss = M.lm_loss(ps, cfg, x, labels, cfg.tp_shard)
        return loss, list(torch.autograd.grad(loss, optimizer.leaves(ps)))

    def step(params, opt, inputs, labels, pos):
        # leaves that share the parameters' storage and record gradients
        ps = M.tree_map(lambda t: t.detach().requires_grad_(), params)
        if microbatch == 1:
            loss, grads = loss_and_grads(ps, inputs, labels, pos)
            loss = loss.detach()
        else:
            B = inputs.shape[0]
            if B % microbatch:
                raise ValueError(f"batch {B} is not a multiple of "
                                 f"microbatch {microbatch}")
            n = B // microbatch
            acc, lsum = None, torch.zeros((), dtype=F32,
                                          device=inputs.device)
            for i in range(microbatch):
                sl = slice(i * n, (i + 1) * n)
                p_sl = pos[:, sl] if cfg.rope == "mrope" else pos[sl]
                l, g = loss_and_grads(ps, inputs[sl], labels[sl], p_sl)
                g = [gi.to(F32) for gi in g]      # 0 + g: the first slice
                acc = g if acc is None else [a + gi for a, gi in
                                             zip(acc, g, strict=True)]
                lsum = lsum + l.detach()
                del g
            grads = [a / microbatch for a in acc]
            loss = lsum / microbatch
        del ps
        gnorm = optimizer.global_grad_norm(grads)
        scale = torch.minimum(torch.ones((), dtype=F32, device=gnorm.device),
                              1.0 / torch.clamp_min(gnorm, 1e-12))
        params, opt = optimizer.update(params, grads, opt, lr=lr,
                                       scale=scale)
        return params, opt, {"loss": loss, "grad_norm": gnorm}

    return step
