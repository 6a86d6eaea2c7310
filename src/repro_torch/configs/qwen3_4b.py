"""qwen3-4b [dense] — hf:Qwen/Qwen3 family.

36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936; qk_norm; decoupled
head_dim=128 (projections 2560 -> 4096).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-4b",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=9728, vocab_size=151936, qk_norm=True,
    family="dense",
)
