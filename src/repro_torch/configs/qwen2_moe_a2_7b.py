"""qwen2-moe-a2.7b [moe] — hf:Qwen/Qwen1.5-MoE-A2.7B.

24L d_model=2048 16H (GQA kv=16) d_ff=1408/expert vocab=151936,
60 routed experts top-4 + 4 shared experts. QKV bias (qwen1.5 lineage).
"""
from .base import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=151936, qkv_bias=True,
    moe=MoECfg(n_experts=60, top_k=4, d_expert=1408, n_shared=4),
    family="moe",
)
