"""Op-level cost accounting of one step (the counterpart of
``repro.launch.hlo_cost``): FLOPs, bytes and collective traffic a chip.

The reference walks compiled HLO and multiplies each ``while`` body by its
trip count.  The port has no HLO: ``OpCost`` is a ``TorchDispatchMode``
that sees every aten op the step runs, so Python loops (superblocks,
positions, microbatches, loss chunks) are counted by execution.

Model (``summary()`` returns ``HloCost.summary()``'s keys, and more):

* FLOPs: ``torch.utils.flop_counter``'s registered formulas (matmuls,
  convolutions, attention), split by the dtype of the op's first tensor
  operand (``flops_by_dtype``); other ops count no FLOPs.
* Bytes: each op's operand and result bytes (a result that is one of the
  operands, as an in-place op returns, once); view and metadata ops, and
  allocations, are free, as ``broadcast`` / ``reshape`` are in
  ``hlo_cost.py``.
* A hand-written kernel is counted at its wrapper by ``kernels.cost``'s
  work (its ``region``), on every device: the CUDA launch, the CPU plain
  version that stands in for it, or the meta branch of a dry run.  The aten
  ops issued inside a region are not counted, so a count does not depend
  on the device.  ``layers._mm_f32`` is counted so too (the card's bf16
  GEMM with an f32 result).  ``kernels`` lists each region's calls,
  FLOPs and bytes.
* Collectives: ``models.sharding.COLLECTIVES``' kinds on the reference's,
  ``all-reduce`` (``tp_psum``, ``batch_psum``, ``grad_sync``, ``pmax``,
  ``pod_pmax``, ``pod_psum``, ``pod_psum_int8``), ``all-gather``
  (``all_gather``, ``fsdp_gather``, ``gather_stack``) and
  ``reduce-scatter`` (``reduce_scatter``); the index service's exchange
  (``core.distributed.EXCHANGE``) as ``all-to-all``.  Each collective
  adds a whole group's ring traffic (``2 (n - 1) b`` for an all-reduce of
  b bytes over n positions), so a chip's share is the total over the mesh
  size, as the reference's per-chip ``2 (n - 1) / n b``; a chip takes part
  in one call a group.

Every number is a chip's: the mesh's total over ``chips``.  One process
drives every position, so work that positions of one device share (a
collective's result, a weight's gather) is done, and counted, once a
group and device.

``track_memory=True`` also follows the storages the step creates (a
finalizer on each), for ``temp_bytes``: the peak of the live bytes made
since ``__enter__`` (the arguments are older), and ``temp_bytes_position``
, the peak over the positions of the bytes each holds, a storage held by
the positions of its operands (the positions common to all of them, else
any of them; an op with no operands by the last op's).  ``owners`` maps
argument storages to their positions (``dryrun.owners_of``).
"""
from __future__ import annotations

import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..core import distributed
from ..kernels import cost
from ..models import sharding

KIND = {"tp_psum": "all-reduce", "batch_psum": "all-reduce",
        "grad_sync": "all-reduce", "pmax": "all-reduce",
        "pod_pmax": "all-reduce", "pod_psum": "all-reduce",
        "pod_psum_int8": "all-reduce", "all_gather": "all-gather",
        "fsdp_gather": "all-gather", "gather_stack": "all-gather",
        "reduce_scatter": "reduce-scatter"}
DTYPE_OF_UNIT = {cost.BF16: "bfloat16", cost.F32: "float32"}

_aten = torch.ops.aten
# metadata and allocation ops: no bytes move
_FREE = {_aten.detach, _aten.alias, _aten.lift_fresh, _aten.empty,
         _aten.empty_like, _aten.empty_strided, _aten.new_empty,
         _aten.new_empty_strided, _aten.sym_size, _aten.sym_stride,
         _aten.sym_numel, _aten.sym_storage_offset, _aten.is_same_size,
         _aten.set_, _aten.resize_, _aten._local_scalar_dense}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCost(TorchDispatchMode):
    """Counts what runs while it is entered (``with OpCost(chips=n) as c:
    step(...)``; ``c.summary()``)."""

    def __init__(self, chips: int = 1, *, track_memory: bool = False,
                 owners: dict | None = None):
        super().__init__()
        self.chips = chips
        self.track = track_memory
        self.flops = defaultdict(float)
        self.bytes = 0
        self.ops = 0
        self.kernels = defaultdict(lambda: {"calls": 0, "flops": 0,
                                            "bytes": 0})
        self.coll = defaultdict(float)
        self.coll_calls = defaultdict(float)
        self.by_name = defaultdict(lambda: {"calls": 0, "bytes": 0})
        # memory: live storages made since __enter__, by their cdata
        self._owners = dict(owners or {})
        self._live: dict = {}
        self._live_bytes = 0
        self.temp_peak = 0
        self._pos_live = defaultdict(int)
        self._pos_peak = defaultdict(int)
        self._last_owner = frozenset()

    # -- registration ------------------------------------------------------
    def __enter__(self):
        cost.COUNTERS.append(self)
        sharding.WATCHERS.append(self._collective)
        self._exchange0 = dict(distributed.EXCHANGE)
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        cost.COUNTERS.remove(self)
        sharding.WATCHERS.remove(self._collective)
        ex = {k: v - self._exchange0[k]
              for k, v in distributed.EXCHANGE.items()}
        if ex["calls"]:
            self.coll["all-to-all"] += ex["bytes"]
            self.coll_calls["all-to-all"] += ex["calls"] * self.chips
            self.by_name["exchange"]["calls"] += ex["calls"]
            self.by_name["exchange"]["bytes"] += ex["bytes"]
        return out

    def kernel(self, name: str, work: cost.Work) -> None:
        """A hand-written kernel's call (``kernels.cost.region``)."""
        k = self.kernels[name]
        k["calls"] += 1
        k["flops"] += work.ops
        k["bytes"] += work.bytes
        self.flops[DTYPE_OF_UNIT[work.unit]] += work.ops
        self.bytes += work.bytes

    def _collective(self, kind: str, nbytes: int, n: int) -> None:
        if n == 1:                      # a group of one moves nothing
            return
        name = KIND[kind]
        self.coll[name] += nbytes
        self.coll_calls[name] += n
        self.by_name[kind]["calls"] += 1
        self.by_name[kind]["bytes"] += nbytes

    # -- the ops -----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if not cost.inside() and not func.is_view and \
                func.overloadpacket not in _FREE:
            self.ops += 1
            packet = func.overloadpacket
            if packet in flop_registry:
                f = flop_registry[packet](*args, **kwargs, out_val=out)
                self.flops[str(ins[0].dtype).removeprefix("torch.")] += f
            self.bytes += sum(_nbytes(t) for t in ins) + sum(
                _nbytes(t) for t in outs if not any(t is s for s in ins))
        if self.track:
            self._follow(ins, outs)
        return out

    def _follow(self, ins: list, outs: list) -> None:
        keys = {t.untyped_storage()._cdata for t in ins}
        sets = [s for s in map(self._owners.get, keys) if s]
        if sets:
            common = frozenset.intersection(*sets)
            owner = common or frozenset().union(*sets)
            self._last_owner = owner
        else:
            owner = self._last_owner
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in keys or key in self._live or key in self._owners:
                continue        # a view, an in-place result or an argument
            nb = st.nbytes()
            self._live[key] = (nb, owner)
            self._owners[key] = owner
            self._live_bytes += nb
            self.temp_peak = max(self.temp_peak, self._live_bytes)
            for r in owner:
                self._pos_live[r] += nb
                if self._pos_live[r] > self._pos_peak[r]:
                    self._pos_peak[r] = self._pos_live[r]
            weakref.finalize(st, self._freed, key)

    def _freed(self, key) -> None:
        nb, owner = self._live.pop(key, (0, ()))
        self._owners.pop(key, None)
        self._live_bytes -= nb
        for r in owner:
            self._pos_live[r] -= nb

    # -- results -----------------------------------------------------------
    def summary(self) -> dict:
        n = self.chips
        coll = {k: v / n for k, v in self.coll.items()}
        return {
            "flops": sum(self.flops.values()) / n,
            "bytes": self.bytes / n,
            "collective_bytes_by_kind": coll,
            "collective_counts": {k: v / n
                                  for k, v in self.coll_calls.items()},
            "collective_bytes": float(sum(coll.values())),
            "flops_by_dtype": {k: v / n for k, v in
                               sorted(self.flops.items()) if v},
            "kernels": {k: dict(v) for k, v in sorted(self.kernels.items())},
            "collectives": {k: dict(v)
                            for k, v in sorted(self.by_name.items())},
            "ops": self.ops,
            "chips": n,
        }

    def memory(self) -> dict:
        """The temporaries' peaks (``track_memory``): all positions', and
        the largest one position held."""
        return {"temp_bytes": self.temp_peak,
                "temp_bytes_position": max(self._pos_peak.values(),
                                           default=0)}
