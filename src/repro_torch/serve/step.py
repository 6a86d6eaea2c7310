"""Serving steps on one device (a port of ``repro.serve.step`` without the
mesh: no shard_map, no sharding specs, no jit).

prefill: full-sequence forward into fresh caches, returns the last
         position's logits (B, V_padded) f32 and the caches.
decode:  one-token step against the caches, returns the greedy next ids
         (B,) int32 and the caches.

Both write the caches in place (the reference donates them to its jit).
"""
from __future__ import annotations

import torch

from ..models import model as M


def make_prefill(cfg):
    """fn(params, caches, tokens, pos) -> (logits (B, V_padded) f32,
    caches).  ``tokens``: ids (B, S), or embeddings (B, S, d) where
    ``cfg.embed_input``; ``pos``: (B, S), or (3, B, S) (t, h, w) ids for
    M-RoPE.  The attention of every layer goes over the whole ``S_max``
    cache with ``q_offset = 0, kv_valid = S``."""
    def prefill(params, caches, tokens, pos):
        x, caches = M.forward(params, cfg, tokens, pos=pos, caches=caches,
                              mode="prefill")
        logits = M.lm_logits(params, cfg, x[:, -1:, :], cfg.tp_shard)
        return logits[:, 0, :], caches
    return prefill


def make_decode_step(cfg):
    """fn(params, caches, tokens, pos, cache_len) -> (next ids (B,) int32,
    caches).  ``tokens``: ids (B, 1), or embeddings (B, 1, d) where
    ``cfg.embed_input``.  Positions come from ``cache_len`` (an int), but
    for M-RoPE, whose (3, B, 1) ids in ``pos`` are kept."""
    def decode(params, caches, tokens, pos, cache_len):
        x, caches = M.forward(params, cfg, tokens, pos=pos, caches=caches,
                              mode="decode", cache_len=cache_len)
        logits = M.lm_logits(params, cfg, x, cfg.tp_shard)[:, 0, :]
        nxt = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)
        return nxt.to(torch.int32), caches
    return decode
