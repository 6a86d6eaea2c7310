"""Reduced-size variants of every assigned architecture for CPU smoke tests:
same family/pattern/features, tiny dims, tp=1 (smoke mesh is (1,1,1))."""
from __future__ import annotations

import dataclasses

from .base import ArchConfig, MoECfg, get_arch


def reduce_cfg(cfg: ArchConfig, *, n_layers: int | None = None,
               d_model: int = 64, vocab: int = 256) -> ArchConfig:
    nl = n_layers or cfg.sb
    nl = max(nl, cfg.sb)
    nl = (nl // cfg.sb) * cfg.sb
    moe = None
    if cfg.moe is not None:
        moe = MoECfg(n_experts=8, top_k=min(cfg.moe.top_k, 2), d_expert=32,
                     n_shared=min(cfg.moe.n_shared, 1), every=cfg.moe.every,
                     offset=cfg.moe.offset)
    return dataclasses.replace(
        cfg,
        n_layers=nl, pattern=cfg.pattern[:nl], sb=cfg.sb,
        d_model=d_model,
        n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 2) if
        cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16,
        d_ff=96 if cfg.d_ff else 0,
        vocab_size=vocab,
        moe=moe,
        tp=1, tp_shard=False,
        d_state=8, d_conv=4, expand=2,
        xl_heads=2,
    )


def reduced(name: str, **kw) -> ArchConfig:
    return reduce_cfg(get_arch(name), **kw)
