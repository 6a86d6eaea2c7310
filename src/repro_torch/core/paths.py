"""Execution-path selection for every lookup surface of the port.

``path`` keeps the reference's three names, so a test can hand the same
string to both packages:

  ``path="auto"``    the hand-written CUDA kernel when the tensors lie on a
                     CUDA device and the key space is exactly
                     f32-representable, the f64 plain-tensor path otherwise.
  ``path="kernel"``  the kernel semantics (f32 key space, clamped window
                     search, seam fix).  On CUDA tensors that is the CUDA
                     kernel, on CPU tensors its plain PyTorch version.
                     Raises ``ValueError`` when the key space is not
                     f32-exact.
  ``path="jnp"``     the port's f64 plain-tensor path (the name is the
                     reference's; nothing here uses jax).  Works for any
                     key space.
"""
from __future__ import annotations

from typing import Callable

import torch

PATHS = ("auto", "kernel", "jnp")


def resolve_path(path: str = "auto", *, f32_exact: bool | Callable[[], bool],
                 device, what: str = "key space") -> bool:
    """True when the kernel semantics should serve the call.

    ``f32_exact`` may be a bool or a zero-argument callable; the callable
    is only invoked when the decision needs it, so ``path="jnp"`` never
    pays for the exactness pass."""
    if path not in PATHS:
        raise ValueError(f"path must be one of {PATHS}, got {path!r}")
    if path == "jnp":
        return False
    if path == "auto" and torch.device(device).type != "cuda":
        return False
    # sync: ok(a python bool: the caller's cached f32_exact flag)
    exact = f32_exact() if callable(f32_exact) else bool(f32_exact)
    if path == "kernel" and not exact:
        raise ValueError(
            f"path='kernel' on a {what} that is not f32-exact: the kernel's "
            "f32 search and seam verification cannot distinguish "
            "f32-colliding f64 keys, so wrong positions would be returned "
            "silently")
    return exact
