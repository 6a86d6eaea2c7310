"""repro_torch — the PyTorch/CUDA port of ``repro``, the lazy learned index.

Laid out like the JAX package (``core/``, ``kernels/``, ``data/``,
``api.py``) so each module has a counterpart there.  It imports torch and
numpy only: never jax, never anything of ``repro``.

Device policy: every entry point (``api.Index.build`` / ``restore``,
``core.updates.DynamicRMI.build``, ``core.rmi.build_rmi``, the baselines'
builds, ``core.distributed``'s builds and ``core.persist``'s restores,
``data.indexed_dataset.IndexedDataset.create``) runs on
``cuda`` unless the caller passes ``device="cpu"``, and raises when no
card is present.  There is no silent fallback to the CPU.  Dtypes are
explicit everywhere (keys and model parameters f64, kernel tables and the
kernel key space f32, positions int32); the default dtype is never set.
"""
from __future__ import annotations

import torch

__all__ = ["not_ported", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``device`` says
    otherwise.  Raises when CUDA is asked for (explicitly or by default)
    and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA unless device='cpu' is passed, and no "
            "CUDA device is available")
    return dev


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error for a feature of the reference this port has not reached,
    naming its ROADMAP queue 1 item."""
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1 "
                               f"item {item})")
