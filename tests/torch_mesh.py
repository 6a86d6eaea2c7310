"""Mesh layouts and stack views shared by the port's sharded tests.

A layout is the ``devices`` of a ``ShardMesh``: ``None`` stacks every shard
on the one ``device="cpu"``; a tuple of ``"cpu"`` positions places each
position's shards on its own stack, as separate cards would hold them.
"""
from __future__ import annotations

import torch

from repro_torch.core.distributed import ShardMesh

# (shards, positions): one position a shard at every width the reference
# runs, and two positions of two shards each
POSITIONED = ((1, 1), (2, 2), (4, 4), (4, 2))

# What a restack writes whole on the home device: the splits, the live
# offsets and the member keys.  Everything else is rewritten in place.
HOME_KEYS = ("offs", "splits", "member")


def cpu_mesh(n_shards: int, positions: int | None):
    """``ShardMesh(n_shards)`` with ``positions`` CPU positions (None: no
    ``devices``)."""
    devices = None if positions is None else ("cpu",) * positions
    return ShardMesh(n_shards, devices=devices)


def stack_tensors(st: dict) -> dict:
    """Every tensor of a sharded stack (``ShardedDynamicIndex._stack``) or
    tenant pack by name: the home device's, and each position's
    (``p<i>/<name>``; model parameters by field, kernel tables under
    ``packed``).  The descriptors (``tabs``), rebuilt after every restack,
    are left out."""
    out = {k: v for k, v in st.items() if isinstance(v, torch.Tensor)}
    for i, part in enumerate(st["parts"]):
        for k, v in part.items():
            if k == "tabs":
                continue
            if isinstance(v, torch.Tensor):
                out[f"p{i}/{k}"] = v
            elif k in ("root", "leaves"):
                for j, t in enumerate(v):
                    out[f"p{i}/{k}.{j}"] = t
            elif k == "packed" and v is not None:
                for kk, t in v.items():
                    out[f"p{i}/packed/{kk}"] = t
    return out


def stack_scalars(st: dict) -> dict:
    """The stack's host values: capacity classes, depth, leaf kind, and
    each position's device, first row and row count."""
    out = {k: v for k, v in st.items()
           if not isinstance(v, (torch.Tensor, list, dict))}
    out["parts"] = [(p["device"], p["lo"], p["n"]) for p in st["parts"]]
    return out
