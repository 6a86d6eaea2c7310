"""Entry points: LM serving (``python -m repro_torch.launch.serve``) and
LM training (``python -m repro_torch.launch.train``)."""
from __future__ import annotations

import numpy as np
import torch


def bf16_draws(a: np.ndarray, dev) -> torch.Tensor:
    """f64 draws (frame embeddings) as bf16 on ``dev``, rounded through
    f32, as ``jnp.asarray(a, jnp.bfloat16)`` rounds them."""
    return torch.from_numpy(a.astype(np.float32)).to(dev).to(torch.bfloat16)
