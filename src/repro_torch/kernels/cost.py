"""The work of each hand-written kernel, from its arguments' shapes and
dtypes: the bytes it must move (each input read once, each output
written once) and the operations it does, with the unit they run on
(``"bf16"``: the tensor cores; ``"f32"``: the CUDA cores at f32).

``chip_smoke.py`` reads K8's bounds from here, and ``launch.op_cost``
counts a kernel by its wrapper's work: a wrapper runs through
:func:`counted`, which opens a :func:`region` with it around the launch
on a card, the meta branch that stands in for the launch in a dry run,
and the plain version on the CPU.  While a region is open the aten ops
issued inside it are not counted, so a count does not depend on the
device.  Where no counter listens a wrapper computes no work and opens no
region.  ``layers._mm_f32`` (a bf16 GEMM with an
f32 result on a card, an f32 product of the upcast operands elsewhere)
is counted the same way, as the card computes it.

Formulas:

* K8, every form (``flash_work``): q read, the output written (bf16 out,
  or f32 ``(m, l, acc)`` in the ``return_partial`` form), the K and V rows
  of the keys the mask keeps (the first ``min(kv_valid, q_offset + Sq)``
  positions; ``kv_valid`` without the causal mask), f32 fq and fk with
  ``bias``, the f32 ``lse`` with ``lse``; 4 dh operations a (query, valid
  key) pair (the QK and PV products).  Tensor positions (in device memory)
  cannot be read without a sync, so such a call counts the keys its
  launch's grid covers: every key of the cache, for every row.  The
  split-KV tile's partials and its combine pass stay on chip in this
  count: they are the tile's, not the function's.
* K8's combine across positions (``merge_work``): m, l and acc read, the
  bf16 output written; 4 operations an accumulator entry.
* K1, one index and shard-stacked (``lookup_work``): per query the query
  and (stacked) its shard id read, the position written, its leaf row (16
  bytes linear, 64 MLP) and ``iters`` 4-byte key probes; 12 (linear) or
  40 (MLP) operations and 2 a probe.  A shape-only count: every probe a
  read of its own, where ``chip_smoke.py`` counts the distinct sectors
  this run's data touches.  K2-K7 keep ``chip_smoke.py``'s data-dependent
  counts.
* ``gemm_work``: a and b read, the f32 product written; 2 M N K
  operations, on the tensor cores where both are bf16.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

BF16, F32 = "bf16", "f32"       # the units operations run on


class Work(NamedTuple):
    bytes: int
    ops: int
    unit: str


# Counters that receive each region's (name, work): ``launch.op_cost``
# registers itself while it is entered.
COUNTERS: list = []
_DEPTH = [0]


def inside() -> bool:
    """Whether a kernel's region is open (its inner ops are not counted)."""
    return _DEPTH[0] > 0


@contextlib.contextmanager
def region(name: str, work: Work):
    """Hand ``work`` to every counter under ``name`` (only where no region
    is open: a region inside another is the outer one's), and keep the aten
    ops issued inside uncounted."""
    if not _DEPTH[0]:
        for c in COUNTERS:
            c.kernel(name, work)
    _DEPTH[0] += 1
    try:
        yield
    finally:
        _DEPTH[0] -= 1


def counted(work, fn, *args):
    """``fn(*args)``; where a counter listens, inside ``region(*work())``
    (``work`` gives the kernel's (name, Work)).  With no counter nothing is
    computed and no region is entered."""
    if not COUNTERS:
        return fn(*args)
    with region(*work()):
        return fn(*args)


def _keys_seen(Sq: int, q_offset: int, kv_valid: int) -> tuple[int, int]:
    """(keys any row sees, sum over the rows of the keys each sees)."""
    per_row = np.clip(np.minimum(kv_valid, q_offset + np.arange(Sq) + 1), 0,
                      None)
    return max(0, min(kv_valid, q_offset + Sq)), int(per_row.sum())


def flash_work(q: torch.Tensor, k: torch.Tensor, q_offset, kv_valid, *,
               unit: str = BF16, lse: bool = False, bias: bool = False,
               partial: bool = False, causal: bool = True) -> Work:
    """One K8 call on q (B, Sq, H, dh) and k/v (B, Skv, Hkv, dh); the
    positions ints, or tensors (then every key of the cache counts, for
    every row: read nowhere on the host)."""
    B, Sq, H, dh = q.shape
    el = q.element_size()
    if isinstance(q_offset, torch.Tensor) or \
            isinstance(kv_valid, torch.Tensor):
        keys, pairs = k.shape[1], Sq * k.shape[1]
    else:   # without the causal mask every row sees kv_valid keys
        keys, pairs = _keys_seen(Sq, int(q_offset if causal else kv_valid),
                                 int(kv_valid))
    nbytes = q.numel() * el + 2 * B * keys * k.shape[2] * dh * el
    rows = B * H * Sq
    nbytes += (2 * rows + q.numel()) * 4 if partial else q.numel() * el
    if bias:
        nbytes += (rows + B * k.shape[1] * H) * 4
    if lse:
        nbytes += rows * 4
    return Work(nbytes, 4 * dh * B * H * pairs, unit)


def merge_work(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor) -> Work:
    """One ``flash_merge`` of D positions' partials (m, l (B, H, D, Sq),
    acc (B, H, D, Sq, dh))."""
    nbytes = (m.numel() + l.numel() + acc.numel()) * 4 + \
        acc[:, :, 0].numel() * 2
    return Work(nbytes, 4 * acc.numel(), F32)


def lookup_work(nq: int, iters: int, *, leaf_kind: str = "linear",
                stacked: bool = False) -> Work:
    """One K1 launch over ``nq`` queries at search depth ``iters``."""
    row = 16 if leaf_kind == "linear" else 64
    per_q = 8 + (4 if stacked else 0) + row + 4 * iters
    flops = 12 if leaf_kind == "linear" else 40
    return Work(nq * per_q, nq * (flops + 2 * iters), F32)


def gemm_work(a: torch.Tensor, b: torch.Tensor) -> Work:
    """A product of 2-d (M, K) . (K, N) or 3-d batched operands with an
    f32 result."""
    M, K, N = a.shape[-2], a.shape[-1], b.shape[-1]
    batch = a.shape[0] if a.dim() == 3 else 1
    out = batch * M * N * 4
    unit = BF16 if a.dtype == b.dtype == torch.bfloat16 else F32
    return Work(a.numel() * a.element_size() + b.numel() * b.element_size()
                + out, 2 * batch * M * N * K, unit)
