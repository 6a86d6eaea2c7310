"""jamba-v0.1-52b [hybrid] — arXiv:2403.19887.

32L d_model=4096 32H (GQA kv=8) d_ff=14336/expert vocab=65536, MoE 16e top-2.
Mamba:attention 7:1 interleave (attention at offset 4 of each 8-layer
period), MoE every 2nd layer (offset 1). Superblock = 8 layers.
"""
from .base import ArchConfig, MoECfg

_PERIOD = ("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba",
           "mamba")

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=65536,
    pattern=_PERIOD * 4, sb=8,
    moe=MoECfg(n_experts=16, top_k=2, d_expert=14336, every=2, offset=1),
    family="hybrid", subquadratic=True,
)
