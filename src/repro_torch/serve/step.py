"""Serving steps (a port of ``repro.serve.step``).

prefill: full-sequence forward into fresh caches, returns the last
         position's logits (B, V_padded) f32 and the caches.
decode:  one-token step against the caches, returns the greedy next ids
         (B,) int32 and the caches.

Both write the caches in place (the reference donates them to its jit).

With ``mesh=None`` the steps run on one device, on whole tensors.  With a
``models.sharding.ModelMesh`` they are the reference's ``shard_map``
programs: every argument and result is a list with one entry a position
(its local shard), as ``shard_tree`` cuts a global tree by the step's
``in_specs`` and ``gather_tree`` puts one back together by its
``out_specs`` (attributes of the returned function, PartitionSpecs as
tuples of axis names).  State stays on its positions between calls.

Sharding variants, as the reference's:
  batch-sharded: the batch over (pod, data), KV heads over model.
  seq-sharded:   the batch replicated, the caches' time axis over data,
                 the positions' partial softmax results combined across
                 data (flash-decoding: K8's ``return_partial`` form and
                 ``flash_merge``).

Weights, as the reference's: FSDP storage by default, the trees
``shard_tree`` cuts by ``param_specs`` (``data`` included), each
superblock's leaves, the embedding and the head gathered over ``data`` at
use (``models.model.gather_fsdp``; ``make_prefill`` always gathers in the
reference, ``make_decode_step`` unless ``replicate_weights``).  With
``replicate_weights=True`` (both steps here) the weights are held
gathered: the trees cut by ``serve_param_specs``, no gather a step.  The
two forms compute the same numbers bit for bit (a gather is a copy), and
on a mesh whose ``data`` axis has one position they are the same tree.
"""
from __future__ import annotations

import torch

from ..models import model as M
from ..models.sharding import (FSDP, TP, batch_axes_for, local_slice,
                               shard_index)


def _cache_specs(cfg, mesh, *, batch_sharded: bool, seq_shard: bool) -> dict:
    """The caches' PartitionSpecs (``repro/serve/step.py:40-64``)."""
    if batch_sharded and seq_shard:
        raise ValueError("seq_shard cuts the caches' time axis over data, "
                         "so the batch cannot be: give batch_sharded=False")
    tp = TP if cfg.tp_shard else None
    b_ax = batch_axes_for(mesh) if batch_sharded else None
    seq_ax = FSDP if seq_shard else None
    out = {}
    for i in range(cfg.sb):
        kind = cfg.pattern[i]
        if kind == "attn":
            # heads over model both for sharded KV heads and for the
            # replicated-KV layout's one-slot-a-rank cache
            kv_tp = tp if (cfg.kv_sharded or cfg.tp_shard) else None
            kv = (None, b_ax, seq_ax, kv_tp, None)
            out[f"pos{i}"] = {"k": kv, "v": kv}
        elif kind == "mamba":
            out[f"pos{i}"] = {"conv": (None, b_ax, None, tp),
                              "h": (None, b_ax, tp, None)}
        elif kind == "mlstm":
            out[f"pos{i}"] = {"c": (None, b_ax, None, None, None),
                              "n": (None, b_ax, None, None),
                              "m": (None, b_ax, None)}
        else:
            z = (None, b_ax, None, None)
            out[f"pos{i}"] = {k: z for k in ("h", "c", "n", "m")}
    return out


def serve_shapes(cfg, shape, mesh) -> dict:
    """The decode cell's GLOBAL (shape, dtype) of each argument
    (``repro/serve/step.py:67-91``): a batch at least the batch axes'
    size is batch-sharded, else the cache's time axis is sequence-
    sharded."""
    B, S = shape.global_batch, shape.seq_len
    n = 1
    for a in batch_axes_for(mesh):
        n *= mesh.axis_size(a)
    batch_sharded = B >= n
    tok = ((B, 1, cfg.d_model), torch.bfloat16) if cfg.embed_input \
        else ((B, 1), torch.int32)
    pos = ((3, B, 1) if cfg.rope == "mrope" else (B, 1), torch.int32)
    return {"tokens": tok, "pos": pos,
            "caches": M.cache_shapes(cfg, B, S, local=False),
            "cache_len": ((), torch.int32),
            "batch_sharded": batch_sharded, "seq_shard": not batch_sharded}


def _strip_fsdp(specs):
    """Serving's weights: the ``data`` entries of the param specs dropped
    (every position holds its ``model`` shard whole)."""
    def strip(sp):
        return tuple(None if e == FSDP else e for e in sp)
    return M.tree_map(strip, specs)


def serve_param_specs(cfg) -> dict:
    """The weights' specs when serving: ``param_specs`` without ``data``."""
    return _strip_fsdp(M.param_specs(cfg))


def _io_specs(cfg, mesh, batch_sharded: bool) -> tuple:
    b_ax = batch_axes_for(mesh) if batch_sharded else None
    tok = (b_ax, None, None) if cfg.embed_input else (b_ax, None)
    pos = (None, b_ax, None) if cfg.rope == "mrope" else (b_ax, None)
    return b_ax, tok, pos


def shard_tree(tree, specs, mesh, *, share: bool = True) -> list:
    """A GLOBAL tree of tensors cut onto ``mesh``'s positions by ``specs``
    (a tree of the same structure, a PartitionSpec tuple a leaf): one tree
    a position, each leaf that position's shard, contiguous, on its
    device -- the counterpart of ``shard_map``'s in_specs.  With
    ``share`` (weights) the positions of one device holding the same
    shard share one tensor (a leaf already whole and on that device is
    used as it is); without it (caches, written in place) every position
    gets its own copy."""
    made = {}

    def one(r):
        dev = mesh.devices[r]

        def leaf(t, spec):
            key = (id(t), dev, tuple(shard_index(mesh, r, e) for e in spec))
            if share and key in made:
                return made[key]
            x = local_slice(t, spec, mesh, r)
            if share:
                x = x.to(dev).contiguous()  # sync: ok(device to device)
            else:
                x = torch.empty(x.shape, dtype=x.dtype,
                                device=dev).copy_(x)
            made[key] = x
            return x
        return M.tree_map(leaf, tree, specs)
    return [one(r) for r in range(mesh.size)]


def gather_tree(trees: list, specs, mesh, *, device=None):
    """The GLOBAL tree put back together from the positions' trees by
    ``specs`` (the first position holding each shard gives it), on
    ``device`` (default the first position's) -- the counterpart of
    ``shard_map``'s out_specs."""
    dev = mesh.devices[0] if device is None else torch.device(device)

    def leaf(*a):
        per, spec = a[:-1], a[-1]
        counts = [shard_index(mesh, 0, e)[1] for e in spec]
        local = per[0]
        shape = [n * c for n, c in zip(local.shape, counts, strict=False)]
        shape += list(local.shape[len(counts):])
        out = torch.empty(shape, dtype=local.dtype, device=dev)
        seen = set()
        for r, t in enumerate(per):
            key = tuple(shard_index(mesh, r, e)[0] for e in spec)
            if key in seen:
                continue
            seen.add(key)
            local_slice(out, spec, mesh, r).copy_(t)
        return out
    return M.tree_map(leaf, trees[0], *trees[1:], specs)


def _weight_specs(cfg, replicate_weights: bool) -> dict:
    return serve_param_specs(cfg) if replicate_weights else \
        M.param_specs(cfg)


def make_prefill(cfg, mesh=None, *, batch_sharded: bool = True,
                 replicate_weights: bool = False):
    """fn(params, caches, tokens, pos) -> (logits (B, V_padded) f32,
    caches).  ``tokens``: ids (B, S), or embeddings (B, S, d) where
    ``cfg.embed_input``; ``pos``: (B, S), or (3, B, S) (t, h, w) ids for
    M-RoPE.  The attention of every layer goes over the whole ``S_max``
    cache with ``q_offset = 0, kv_valid = S``.

    With ``mesh``: every argument and result a list over its positions
    (``fn.in_specs``, ``fn.out_specs``); the logits are each position's
    vocab shard (``tp_shard``), (B_local, V_padded / model).  The weights
    in FSDP storage (``param_specs``, gathered at use), as the reference's
    ``make_prefill`` always takes them; or held gathered with
    ``replicate_weights`` (``serve_param_specs``), an option the reference
    lacks: a server that decodes with ``make_decode_step(...,
    replicate_weights=True)`` holds only the gathered trees, and prefills
    its requests from them rather than keeping an FSDP copy beside them."""
    if mesh is None:
        def prefill(params, caches, tokens, pos):
            x, caches = M.forward(params, cfg, tokens, pos=pos,
                                  caches=caches, mode="prefill")
            logits = M.lm_logits(params, cfg, x[:, -1:, :], cfg.tp_shard)
            return logits[:, 0, :], caches
        return prefill

    b_ax, tok, pos_spec = _io_specs(cfg, mesh, batch_sharded)
    c_specs = _cache_specs(cfg, mesh, batch_sharded=batch_sharded,
                           seq_shard=False)

    fsdp = not replicate_weights

    def prefill_mesh(params, caches, tokens, pos):
        x, caches = M.forward(params, cfg, tokens, pos=pos, caches=caches,
                              mode="prefill", mesh=mesh, fsdp=fsdp)
        logits = M.lm_logits(params, cfg, [t[:, -1:, :] for t in x],
                             cfg.tp_shard, mesh=mesh, fsdp=fsdp)
        return [lg[:, 0, :] for lg in logits], caches
    prefill_mesh.in_specs = (_weight_specs(cfg, replicate_weights), c_specs,
                             tok, pos_spec)
    prefill_mesh.out_specs = ((b_ax, TP if cfg.tp_shard else None), c_specs)
    return prefill_mesh


def make_decode_step(cfg, mesh=None, *, batch_sharded: bool = True,
                     seq_shard: bool = False,
                     replicate_weights: bool = False):
    """fn(params, caches, tokens, pos, cache_len) -> (next ids (B,) int32,
    caches).  ``tokens``: ids (B, 1), or embeddings (B, 1, d) where
    ``cfg.embed_input``.  Positions come from ``cache_len``, but for
    M-RoPE, whose (3, B, 1) ids in ``pos`` are kept: an int, or a 0-d int32
    tensor on the model's device, as the reference's step takes it (a
    traced int32 scalar, ``repro/serve/step.py:109-115``).  A tensor is
    read nowhere on the host: K8 reads the positions from device memory
    and the caches are written by ``index_copy_``, so a dense model's step
    makes no host sync and launches the same kernels whatever the value,
    and can be captured in a CUDA graph (MoE archs read their routing
    counts on the host, ``layers.moe_route``).

    With ``mesh``: lists over its positions (``fn.in_specs``,
    ``fn.out_specs``); under ``tp_shard`` the vocab shards' logits are
    all-gathered over ``model`` before the argmax over ``[:vocab_size]``,
    as the reference's (``:123-127``); ``seq_shard`` decodes against
    caches whose time axis is cut over ``data``, the batch replicated
    (with ``batch_sharded=False``: both would cut ``data`` twice).  The
    weights in FSDP storage, gathered over ``data`` every step, or held
    gathered with ``replicate_weights`` (the reference's ``:99-137``)."""
    if mesh is None:
        def decode(params, caches, tokens, pos, cache_len):
            x, caches = M.forward(params, cfg, tokens, pos=pos,
                                  caches=caches, mode="decode",
                                  cache_len=cache_len)
            logits = M.lm_logits(params, cfg, x, cfg.tp_shard)[:, 0, :]
            nxt = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)
            return nxt.to(torch.int32), caches
        return decode

    b_ax, tok, pos_spec = _io_specs(cfg, mesh, batch_sharded)
    c_specs = _cache_specs(cfg, mesh, batch_sharded=batch_sharded,
                           seq_shard=seq_shard)

    fsdp = not replicate_weights

    def decode_mesh(params, caches, tokens, pos, cache_len):
        x, caches = M.forward(params, cfg, tokens, pos=pos, caches=caches,
                              mode="decode", cache_len=cache_len,
                              seq_sharded=seq_shard, mesh=mesh, fsdp=fsdp)
        logits = [lg[:, 0, :] for lg in M.lm_logits(
            params, cfg, x, cfg.tp_shard, mesh=mesh, fsdp=fsdp)]
        if cfg.tp_shard:
            logits = mesh.all_gather(logits, TP, dim=1)
        nxt = [torch.argmax(lg[:, :cfg.vocab_size], dim=-1).to(torch.int32)
               for lg in logits]
        return nxt, caches
    decode_mesh.in_specs = (_weight_specs(cfg, replicate_weights), c_specs,
                            tok, pos_spec, ())
    decode_mesh.out_specs = ((b_ax,), c_specs)
    return decode_mesh
