"""qwen1.5-4b [dense] — hf:Qwen/Qwen1.5 family.

40L d_model=2560 20H (GQA kv=20) d_ff=6912 vocab=151936, QKV bias.
20 heads pad to 32 for TP-16 (zero-weight heads; counted as padding waste).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-4b",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20, head_dim=128,
    d_ff=6912, vocab_size=151936, qkv_bias=True,
    family="dense",
)
