"""qwen2-vl-72b [vlm] — arXiv:2409.12191.

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064, M-RoPE (temporal/
height/width sections 16/24/24 over head_dim/2), dynamic-resolution vision
frontend is a STUB: input_specs supplies precomputed 3-D position ids (and
patch embeddings arrive as ordinary token positions).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=29568, vocab_size=152064, rope="mrope", mrope_sections=(16, 24, 24),
    family="vlm",
)
