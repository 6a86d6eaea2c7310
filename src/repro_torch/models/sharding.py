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

Training adds the collectives of the reference's step (``repro/train/
step.py``): ``fsdp_gather`` (its ``lax.all_gather(..., "data", tiled=True)``
of a weight's FSDP shards, whose autograd backward is the reduce-scatter
over ``data``: ZeRO's gradient reduction), ``pmax`` (the loss's stability
offset over ``model``, outside the gradient), ``batch_psum`` (the loss's
``psum_forced`` over pod and data), ``grad_sync`` (the sum of a replicated
leaf's gradients over the axes it is replicated on, which the reference's
varying-axes types insert as the transpose of an implicit broadcast) and
``pod_psum``.  Each is counted in ``COLLECTIVES``; so are the transposes
the backward runs (``tp_psum``'s all-reduce of the cotangent, under
``tp_psum``; ``fsdp_gather``'s under ``reduce_scatter``).  Serving from
FSDP storage gathers each superblock's leaves, the embedding and the head
with ``fsdp_gather`` at use, as the reference's serving steps do
(``serve.step``); with ``replicate_weights=True`` it holds them gathered
and calls none.

``psum_dtype`` (a field of the mesh, set by ``train.step.make_train_step``
from its argument of that name: the reference's ``set_psum_dtype``, which
is a global there) casts every ``tp_psum``'s operands to that dtype
before the sum, as the reference does.

The reference's typing helpers (``pvary_all``, ``scan_aligned``,
``psum_forced``, ``unvary``, its jax 0.4.x compat shim, ``set_mesh_axes``,
``set_batch_axes``) manage JAX's varying-manual-axes types and are numeric
identities; the port has no such types and keeps none of them.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import resolve_device

POD, FSDP, TP = "pod", "data", "model"
AXES = (POD, FSDP, TP)

# calls and bytes between positions a kind, as if each position were a card
COLLECTIVES = {k: {"calls": 0, "bytes": 0}
               for k in ("tp_psum", "all_gather", "gather_stack",
                         "fsdp_gather", "reduce_scatter", "pmax",
                         "batch_psum", "grad_sync", "pod_pmax", "pod_psum",
                         "pod_psum_int8")}


# Callables given (kind, bytes, n) of every collective a group of n
# positions runs (``launch.op_cost.OpCost`` registers itself while it is
# entered: a chip takes part in one call a group it belongs to).
WATCHERS: list = []


def reset_collectives() -> None:
    for v in COLLECTIVES.values():
        v["calls"] = v["bytes"] = 0


def _device(d) -> torch.device:
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _count(kind: str, nbytes: int, n: int) -> None:
    COLLECTIVES[kind]["calls"] += 1
    COLLECTIVES[kind]["bytes"] += int(nbytes)
    for w in WATCHERS:
        w(kind, int(nbytes), n)


class _Tally(torch.autograd.Function):
    """The identity, whose backward counts one collective of ``kind``: the
    transpose a collective's backward runs."""

    @staticmethod
    def forward(ctx, x, kind: str, nbytes: int, n: int):
        ctx.kind, ctx.nbytes, ctx.n = kind, nbytes, n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        _count(ctx.kind, ctx.nbytes, ctx.n)
        return g, None, None, None


def _tallied(x: torch.Tensor, kind: str, nbytes: int, n: int
             ) -> torch.Tensor:
    if torch.is_grad_enabled() and x.requires_grad:
        return _Tally.apply(x, kind, nbytes, n)
    return x


class _FsdpGather(torch.autograd.Function):
    """The shards of one ``data`` group concatenated along ``dim``, one
    result a device of the group; backward the reduce-scatter: shard j's
    gradient is slice j of the results' gradients summed in device order,
    in their dtype, on shard j's device (counted as ``reduce_scatter``)."""

    @staticmethod
    def forward(ctx, dim: int, devs: tuple, nbytes: int, *shards):
        ctx.dim, ctx.nbytes = dim, nbytes
        ctx.homes = [s.device for s in shards]
        ctx.width = shards[0].shape[dim]
        # sync: ok(device to device: the shards of a group)
        return tuple(torch.cat([s.to(d) for s in shards], dim) for d in devs)

    @staticmethod
    def backward(ctx, *gs):
        _count("reduce_scatter", ctx.nbytes, len(ctx.homes))
        k, out = ctx.width, []
        for j, home in enumerate(ctx.homes):
            acc = None
            for g in gs:
                if g is None:
                    continue
                # sync: ok(device to device: a slice of the gradient)
                part = g.narrow(ctx.dim, j * k, k).to(home)
                acc = part if acc is None else acc + part
            out.append(acc)
        return (None, None, None, *out)


@dataclass(frozen=True)
class ModelMesh:
    """A (pod, data, model) grid of positions: ``shape`` the sizes of the
    axes in ``axis_names`` (a subset of pod, data, model in that order;
    an axis left out has size 1), ``devices`` one device a position in
    row-major order (a single device, or None for the entry point's
    default, puts every position there); ``psum_dtype`` the dtype every
    ``tp_psum`` sums in (None: its operands')."""
    shape: tuple
    axis_names: tuple = AXES
    devices: tuple | None = None
    psum_dtype: torch.dtype | None = None

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
        order (in ``psum_dtype`` where set), on every position.  Under a
        gradient the backward's all-reduce of the cotangent is counted
        too."""
        if self.psum_dtype is not None:
            xs = [x.to(self.psum_dtype) for x in xs]
        return self._reduce(xs, TP, "tp_psum", torch.add, tally=True)

    def _reduce(self, xs: list, axes, kind: str, op,
                itemsize: int | None = None, tally: bool = False) -> list:
        """``op`` folded over the positions of each group along ``axes``
        in position order, computed once a group and device, on every
        position, as plain torch ops (autograd differentiates them).
        ``itemsize`` counts the bytes at that width (a payload narrower
        than the dtype the sum is taken in); ``tally`` counts the
        backward's transpose as one more call of ``kind``."""
        out = [None] * self.size
        n = 1
        for a in ((axes,) if isinstance(axes, str) else axes):
            n *= self.axis_size(a)
        for g in self.groups(axes):
            b = xs[g[0]].numel() * (itemsize or xs[g[0]].element_size())
            _count(kind, 2 * (n - 1) * b, n)
            first = _tallied(xs[g[0]], kind, 2 * (n - 1) * b, n) if tally \
                else xs[g[0]]
            done = {}
            for r in g:
                dev = self.devices[r]
                if dev not in done:
                    acc = first.to(dev)  # sync: ok(device to device)
                    for i in g[1:]:
                        # sync: ok(device to device: a position's share)
                        acc = op(acc, xs[i].to(dev))
                    done[dev] = acc
                out[r] = done[dev]
        return out

    def pmax(self, xs: list, axis: str = TP, kind: str = "pmax") -> list:
        """``lax.pmax`` over ``axis``: the elementwise max of the group's
        tensors (the loss's stability offset; no gradient flows)."""
        return self._reduce([x.detach() for x in xs], axis, kind,
                            torch.maximum)

    def batch_psum(self, xs: list) -> list:
        """The loss's ``psum_forced(x, batch_axes())``: the sum over pod
        and data in position order, on every position.  Its transpose is
        a broadcast of the cotangent: no collective in the backward."""
        return self._reduce(xs, batch_axes_for(self), "batch_psum",
                            torch.add)

    def grad_sync(self, gs: list, axes) -> list:
        """The sum of a replicated leaf's gradients over ``axes`` (those
        it is replicated on), in position order and in their dtype: what
        the reference's varying-axes types insert as the transpose of a
        replicated value's implicit broadcast."""
        axes = tuple(a for a in axes if self.axis_size(a) > 1)
        if not axes:
            return list(gs)
        return self._reduce(gs, axes, "grad_sync", torch.add)

    def pod_psum(self, xs: list, kind: str = "pod_psum",
                 itemsize: int | None = None) -> list:
        """``lax.psum(x, "pod")`` in position order and in x's dtype."""
        return self._reduce(xs, POD, kind, torch.add, itemsize)

    def fsdp_gather(self, ws: list, dim: int = 0) -> list:
        """``lax.all_gather(w, "data", axis=dim, tiled=True)``: each
        position's FSDP shard concatenated with the rest of its ``data``
        group along ``dim`` (once a group and device).  Its autograd
        backward is the reduce-scatter: shard j's gradient the sum, in
        position order, of slice j of the gathered tensors' gradients
        (``_FsdpGather``).  The identity where ``data`` has one
        position."""
        n = self.axis_size(FSDP)
        if n == 1:
            return list(ws)
        out = [None] * self.size
        for g in self.groups(FSDP):
            b = ws[g[0]].numel() * ws[g[0]].element_size()
            _count("fsdp_gather", n * (n - 1) * b, n)
            devs = list(dict.fromkeys(self.devices[r] for r in g))
            made = _FsdpGather.apply(dim, tuple(devs), n * (n - 1) * b,
                                     *(ws[i] for i in g))
            for r in g:
                out[r] = made[devs.index(self.devices[r])]
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
            _count(kind, n * (n - 1) * xs[g[0]].numel() *
                   xs[g[0]].element_size(), n)
            done = {}
            for r in g:
                dev = self.devices[r]
                if dev not in done:
                    # sync: ok(device to device: the shards of a group)
                    done[dev] = join([xs[i].to(dev) for i in g])
                out[r] = done[dev]
        return out


def once_per_stored(fn, key=None):
    """``fn`` memoised on the identity of its positional arguments (or of
    ``key(*args)``): positions of one device may share a stored tensor
    (``serve.step.shard_tree(share=True)``), and work on that tensor is
    done once, its result shared by every position that holds it.  The
    arguments must outlive the returned function (identities are its
    keys)."""
    made = {}

    def call(*args, **kw):
        k = tuple(map(id, key(*args) if key is not None else args))
        if k not in made:
            made[k] = fn(*args, **kw)
        return made[k]
    return call


def each_stored(fn, *cols) -> list:
    """``fn`` over the positions' entries of ``cols`` (lists over the
    positions), once for each distinct tuple of objects
    (``once_per_stored``)."""
    f = once_per_stored(fn)
    return [f(*args) for args in zip(*cols, strict=True)]


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
