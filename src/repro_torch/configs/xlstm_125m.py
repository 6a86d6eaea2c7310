"""xlstm-125m [ssm] — arXiv:2405.04517 (unverified tier).

12L d_model=768 4 heads vocab=50304, alternating mLSTM/sLSTM blocks
(superblock = 2), no separate FFN (d_ff=0; block-internal up/down
projections, expand=2). Model is too small for 16-way tensor parallel:
weights are replicated across the model axis (tp_shard=False), only
FSDP/DP shard it — recorded in DESIGN.md §Arch-applicability.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, head_dim=192,
    d_ff=0, vocab_size=50304,
    pattern=("mlstm", "slstm") * 6, sb=2,
    xl_heads=4, expand=2, tp_shard=False, rope="none",
    family="ssm", subquadratic=True,
)
