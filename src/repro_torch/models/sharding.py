"""The mesh of the manual-SPMD model code (a port of
``repro.models.sharding``).

Mesh axes, as the reference's (DESIGN.md §4):
  pod    -- pure data parallel across pods
  data   -- batch shard (serving), or the KV cache's time axis in
            sequence-sharded decode
  model  -- tensor parallel (heads / d_ff / vocab)

The reference runs its model code under ``shard_map`` with the axis names
bound, and its collectives are XLA's.  The port has one process drive the
mesh: a ``ModelMesh`` is a grid of positions, each a ``torch.device``,
laid out row-major over (pod, data, model), and a value "on the mesh" is a
list with one tensor a position (its local shard).  The model code runs a
position at a time between collectives, and each collective is an explicit
operation over those lists: ``tp_psum`` and ``all_gather`` (over
``model``) and ``gather_stack`` (the partials brought to every position,
where the reference combines them with a ``pmax`` and two ``psum`` over
``data``).  Where several positions share a
device (every position is ``cuda:0`` on a one-card machine, ``"cpu"`` in
the tests), a collective's result is computed once a group and device and
shared by those positions; sums run in position order.

``COLLECTIVES`` counts each kind's calls and the bytes it would move
between positions if each position were its own card (a ring: an
all-reduce of b bytes over n positions moves 2 (n - 1) / n b into each,
an all-gather of n shards of b bytes (n - 1) b into each), as
``core.distributed.EXCHANGE`` counts the index's exchange; reset it with
``reset_collectives`` before a step.

The reference's typing helpers (``pvary_all``, ``scan_aligned``,
``psum_forced``, ``unvary``, its jax 0.4.x compat shim, ``set_mesh_axes``,
``set_batch_axes``) manage JAX's varying-manual-axes types and are numeric
identities; the port has no such types and keeps none of them.  Nor does
it keep ``set_psum_dtype``: the TP psum sums in the dtype it is given,
as the reference's does by default.  Its FSDP
gather (``fsdp_gather``, ``set_fsdp_gather``) is the identity here too:
serving holds the weights gathered over ``data`` (the reference's
``replicate_weights=True``), and FSDP storage is training's, ROADMAP queue
1 item 14e.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import resolve_device

POD, FSDP, TP = "pod", "data", "model"
AXES = (POD, FSDP, TP)

# calls and bytes between positions a kind, as if each position were a card
COLLECTIVES = {k: {"calls": 0, "bytes": 0}
               for k in ("tp_psum", "all_gather", "gather_stack")}


def reset_collectives() -> None:
    for v in COLLECTIVES.values():
        v["calls"] = v["bytes"] = 0


def _device(d) -> torch.device:
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass(frozen=True)
class ModelMesh:
    """A (pod, data, model) grid of positions: ``shape`` the sizes of the
    axes in ``axis_names`` (a subset of pod, data, model in that order;
    an axis left out has size 1), ``devices`` one device a position in
    row-major order (a single device, or None for the entry point's
    default, puts every position there)."""
    shape: tuple
    axis_names: tuple = AXES
    devices: tuple | None = None

    def __post_init__(self):
        names = tuple(self.axis_names)
        if len(names) != len(self.shape) or \
                [a for a in AXES if a in names] != list(names):
            raise ValueError(f"axes {names} of shape {self.shape}: a subset "
                             f"of {AXES} in that order, one size each")
        if any(int(s) < 1 for s in self.shape):
            raise ValueError(f"mesh shape {self.shape}")
        size = 1
        for s in self.shape:
            size *= int(s)
        devs = self.devices
        if devs is None or isinstance(devs, (str, torch.device)):
            devs = (devs,) * size
        devs = tuple(_device(d) for d in devs)
        if len(devs) != size:
            raise ValueError(f"{len(devs)} devices for a mesh of {size} "
                             f"positions")
        if len({d.type for d in devs}) > 1:
            raise ValueError("a mesh mixes device types: "
                             f"{[str(d) for d in devs]}")
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))
        object.__setattr__(self, "axis_names", names)
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)] \
            if name in self.axis_names else 1

    def coords(self, r: int) -> dict:
        """Position r's index on each of pod, data and model."""
        out = {}
        for name, n in reversed(list(zip(self.axis_names, self.shape,
                                          strict=True))):
            r, out[name] = divmod(r, n)
        return {a: out.get(a, 0) for a in AXES}

    def axis_index(self, name: str, r: int) -> int:
        return self.coords(r)[name]

    def position(self, **idx) -> int:
        """The position at the given axis indices (0 on the rest)."""
        r = 0
        for name, n in zip(self.axis_names, self.shape, strict=True):
            r = r * n + int(idx.get(name, 0))
        return r

    def groups(self, axis) -> list:
        """The positions that differ only along ``axis`` (a name, or a
        tuple of names varying row-major), one list a group, each in
        axis order."""
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        out = {}
        for r in range(self.size):
            c = self.coords(r)
            out.setdefault(tuple(c[a] for a in AXES if a not in axes),
                           []).append(r)
        return list(out.values())

    # -- collectives over per-position lists --------------------------------
    def tp_psum(self, xs: list) -> list:
        """The reference's ``tp_psum``: the sum over ``model`` in position
        order, on every position."""
        n = self.axis_size(TP)
        out = [None] * self.size
        for g in self.groups(TP):
            COLLECTIVES["tp_psum"]["calls"] += 1
            b = xs[g[0]].numel() * xs[g[0]].element_size()
            COLLECTIVES["tp_psum"]["bytes"] += 2 * (n - 1) * b
            done = {}
            for r in g:
                dev = self.devices[r]
                if dev not in done:
                    acc = xs[g[0]].to(dev)  # sync: ok(device to device)
                    for i in g[1:]:
                        # sync: ok(device to device: a position's share)
                        acc = acc + xs[i].to(dev)
                    done[dev] = acc
                out[r] = done[dev]
        return out

    def all_gather(self, xs: list, axis: str = TP, dim: int = 0) -> list:
        """``lax.all_gather(x, axis, axis=dim, tiled=True)``: the shards
        of ``axis`` concatenated along ``dim`` in axis order, on every
        position."""
        return self._gather(xs, axis, "all_gather",
                            lambda ts: torch.cat(ts, dim))

    def gather_stack(self, xs: list, axis: str = FSDP, dim: int = 0) -> list:
        """The tensors (or tuples of tensors) of the positions along
        ``axis`` stacked on a new dimension ``dim`` in axis order, on every
        position: the partials of a flash-decoding combine brought to
        each position."""
        if isinstance(xs[0], tuple):
            parts = [self.gather_stack([x[j] for x in xs], axis, dim)
                     for j in range(len(xs[0]))]
            return [tuple(p[r] for p in parts) for r in range(self.size)]
        return self._gather(xs, axis, "gather_stack",
                            lambda ts: torch.stack(ts, dim))

    def _gather(self, xs: list, axis: str, kind: str, join) -> list:
        n = self.axis_size(axis)
        out = [None] * self.size
        for g in self.groups(axis):
            COLLECTIVES[kind]["calls"] += 1
            COLLECTIVES[kind]["bytes"] += n * (n - 1) * \
                xs[g[0]].numel() * xs[g[0]].element_size()
            done = {}
            for r in g:
                dev = self.devices[r]
                if dev not in done:
                    # sync: ok(device to device: the shards of a group)
                    done[dev] = join([xs[i].to(dev) for i in g])
                out[r] = done[dev]
        return out


def batch_axes_for(mesh: ModelMesh) -> tuple:
    """The batch-carrying axes of ``mesh`` (pod and data, where present)."""
    return tuple(a for a in (POD, FSDP) if a in mesh.axis_names)


def spec_axes(entry) -> tuple:
    """The mesh axes one PartitionSpec entry names: None, a name, or a
    tuple of names (sharded row-major over them)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_index(mesh: ModelMesh, r: int, entry) -> tuple:
    """(index, count) of position r's shard along a dimension whose spec
    entry is ``entry``."""
    idx, cnt = 0, 1
    c = mesh.coords(r)
    for a in spec_axes(entry):
        n = mesh.axis_size(a)
        idx, cnt = idx * n + c[a], cnt * n
    return idx, cnt


def local_slice(t: torch.Tensor, spec: tuple, mesh: ModelMesh,
                r: int) -> torch.Tensor:
    """Position r's shard of the global tensor ``t`` under ``spec`` (a
    view; a dimension must divide by its shard count)."""
    if len(spec) > t.dim():
        raise ValueError(f"spec {spec} for a {t.dim()}-d tensor")
    out = t
    for d, entry in enumerate(spec):
        i, n = shard_index(mesh, r, entry)
        if n == 1:
            continue
        if t.shape[d] % n:
            raise ValueError(f"dimension {d} of {tuple(t.shape)} does not "
                             f"divide into {n} shards ({entry})")
        k = t.shape[d] // n
        out = out.narrow(d, i * k, k)
    return out
