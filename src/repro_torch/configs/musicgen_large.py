"""musicgen-large [audio] — arXiv:2306.05284.

48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048, decoder-only over EnCodec
tokens. Modality frontend is a STUB: input_specs provides precomputed frame
embeddings (B, S, d_model) — the four-codebook sum lives in the frontend.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=2048, embed_input=True, rope="none",
    family="audio",
)
