"""granite-moe-1b-a400m [moe] — hf:ibm-granite/granite-3.0-1b-a400m-base.

24L d_model=1024 16H (GQA kv=8) d_ff=512/expert vocab=49155, MoE 32e top-8.
"""
from .base import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49155,
    moe=MoECfg(n_experts=32, top_k=8, d_expert=512),
    family="moe",
)
