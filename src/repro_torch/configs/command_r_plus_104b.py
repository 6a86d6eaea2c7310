"""command-r-plus-104b [dense] — hf:CohereForAI (unverified tier).

64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000, no biases.
Cohere-style PARALLEL blocks: attention and FFN read the same normed input
and their partial outputs share a single TP psum (also halves the per-layer
collective payload — EXPERIMENTS.md §Perf P9).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-plus-104b",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
    d_ff=33792, vocab_size=256000, parallel_block=True,
    family="dense",
)
