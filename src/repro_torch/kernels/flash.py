"""K8: blockwise flash attention (forward) -- wrapper, plain PyTorch
version and launch counters (the CUDA kernel is ``csrc/flash.cu``).

The function is the one every LM attention layer of the reference calls,
``repro.models.layers.flash_attention`` (its ``bias_qk`` form, the mLSTM's,
in a tile of its own); the TPU kernel
``repro.kernels.flash.flash_attention_pallas`` is its special case
``q_offset = 0``, ``kv_valid = Skv``, with GQA broadcast by the caller,
and adds ``causal=False``.  For q (B, Sq, H, dh) and k/v (B, Skv, Hkv, dh),
f32 or bf16, any dh from 1 to 256, query head h reading KV head ``h // (H
// Hkv)``:

    s    = (f32(q) * scale) . f32(k)          scale = f32(1 / f32(sqrt(dh)))
    mask = k_pos <= q_offset + i  and  k_pos < kv_valid   (masked: -inf)
           (``causal=False``: k_pos < kv_valid alone)
    online softmax over key blocks, running max floored at -1e30
    out  = acc / max(l, 1e-30), rounded once to q's dtype.

Positions: ``q_offset`` and ``kv_valid`` are Python ints, or 0-d integer
tensors on q's device (the reference's traced int32 arrays: a decode
step's ``cache_len``).  Ints are checked (``0 <= kv_valid <= Skv``) and
passed by value; a tensor position is never read on the host on the CUDA
path (no ``int()``, ``.item()`` or ``.tolist()``): the tiles read
``(q_offset, kv_valid)`` from device memory, clamp ``kv_valid`` into ``[0,
Skv]`` as the reference's masks bound it, and take a negative
``q_offset`` (a sequence-sharded chunk past ``length``: no key seen).  So
a call with tensor positions syncs nothing and its launches depend on
shapes alone, which a CUDA graph needs.  The plain versions take both
(the split-KV plain version's runs follow the tile's plan, see
``flash_decode_split_plain``).

``flash_attention_plain`` is the reference's blockwise jnp algorithm in
torch (``kv_block = min(1024, ceil(Skv / 128) * 128)``).  The tests and the
CPU path use it; nothing on the CUDA path calls it.  The kernels sum their
dot products in other orders and over 64-key tiles, so the two agree to
f32 rounding, not bit for bit.

On a CUDA tensor ``flash_attention`` launches one of three tiles of
``csrc/flash.cu``, by dtype, head dim and rows ``Sq * G`` (G = H // Hkv;
``tile_of``):

* bf16, dh 64, 80, 96 or 128, ``Sq * G > 8`` (prefill): the tensor-core
  tile (``wgmma``, TMA-fed K/V; dh 80 and 96 at a padded width of 128),
  counted in ``LAUNCHES["flash"]``;
* bf16, dh 64, 80, 96, 128 or 256, ``Sq * G <= 8`` (decode): the split-KV
  tile, the keys cut into ``split_plan``'s runs of whole 64-key tiles, one
  block each writing f32 partials, then a combine pass; counted in
  ``LAUNCHES["flash_decode"]``, its combine pass beside it in
  ``LAUNCHES["flash_combine"]``.  Int positions cut the valid keys
  (``decode_kend``); tensor positions cut every key of the cache, and a run
  past the valid keys writes the empty partial (``decode_plan``);
* f32 at any dh, and bf16 at any other dh (bf16 prefill at dh 256 among
  them): the CUDA-core tile, at a padded width of 16, 32, 64, 128 or 256,
  counted in ``LAUNCHES["flash_cc"]``;
* with ``bias_qk = (fq, fk)`` (f32 (B, Sq, H) and (B, Skv, H), the
  mLSTM's F_t and i_s - F_s): the bias tile, bf16 at dh 64 or 384
  (``bias_tile_of``), causal and with int positions only (its one caller,
  the mLSTM's prefill, passes 0), each score ``(s + fq[i]) + fk[j]``
  before the mask, p = exp of ``s - m``; built as the tensor-core tile
  (``wgmma``, TMA-fed 64-key K/V tiles in an mbarrier ring, P in bf16 hi +
  lo), at dh 384 two warpgroups on the same 64 rows, 192 output columns
  each; counted in ``LAUNCHES["flash_bias"]``.

A head dim above 256 (or below 1) raises in ``tile_of``.

``flash_decode_split_plain`` is the split-KV tile's partials and combine
in plain torch, for the tests and ``chip_smoke.py``.

Flash-decoding across mesh positions (sequence-sharded decode: each
position holds a chunk of the KV cache's time axis) takes two more forms:

* ``flash_attention(..., return_partial=True)``: each row's f32
  unnormalised ``(m, l, acc)``, (B, H, Sq), (B, H, Sq) and (B, H, Sq, dh),
  the reference's ``return_partial`` (a row that sees no key: m = -1e30,
  l = 0, acc = 0).  On a card the split-KV tile's runs, then
  ``flash_combine_kernel`` in its partial mode, which combines the runs
  without the division (bf16 at the split-KV tile's head dims with ``Sq *
  G <= 8``: the decode shapes),
  counted in ``LAUNCHES["flash_partial"]``; its plain version is the
  split-KV plain version stopped before its division
  (``flash_decode_split_plain(return_partial=True)``).
* ``flash_merge(m, l, acc)``: D positions' partials, stacked on a third
  axis, into ``sum_i acc_i e^(m_i - M) / max(sum_i l_i e^(m_i - M),
  1e-30)``, M = max_i m_i, rounded once to bf16, (B, Sq, H, dh): the
  decode tile's combine kernel with the positions as its runs, counted in
  ``LAUNCHES["flash_merge"]``; plain version ``flash_merge_plain``.

Training (``FlashAttention``, which ``flash_attention`` takes whenever
autograd records): the forward launches the same tensor-core, CUDA-core or
bias tile with its ``lse`` output, each row's f32 log-sum-exp ``m +
log(l)`` of (B, H, Sq) (of the biased scores in the bias form), counted in
``LAUNCHES`` as any launch of the tile and in ``LSE_LAUNCHES`` besides, and
in ``REMAT_LAUNCHES`` too where the autograd engine runs it inside a
backward pass (a checkpoint's recompute: remat); the
split-KV decode tile writes no ``lse`` and raises, and so does
``causal=False`` under a gradient (the reference's Pallas kernel has
none).  The backward (``flash_attention_bwd``) is torch ops, not a
kernel: the reference's TPU kernel is forward only and the reference
trains by XLA's autodiff of its jnp scan, so the port recomputes the
softmax from ``lse`` in f32, a block of query rows at a time over every
key they see (``P = exp(s - lse)``, ``D = rowsum(P * dP)`` exact in f32),
sums dk and dv over the G query heads a KV head serves, and rounds once
to the inputs' dtype; in the bias form it also returns the bias terms'
gradients, ``dfq = sum_j dS`` and ``dfk = sum_i dS`` per query head, in
f32.  No library attention: SDPA's backward rounds P to
bf16.  On the CPU the forward is the plain version (``return_lse``) and
the backward the same code.

On ``meta`` tensors (a dry run: ``launch.dryrun``) every wrapper stands in
for its launch: it returns empty outputs of the kernel's shapes and dtypes
(``lse`` and the partial ``(m, l, acc)`` included) and launches nothing,
so ``LAUNCHES`` (which counts launches only) stays as it is.  This is a
device type of its own, not a fallback: CPU tensors take the plain
version, CUDA tensors launch the kernel, and a failed build or launch
raises.  On every device the wrapper hands the kernel's work
(``kernels.cost``) to an active counter (``launch.op_cost.OpCost``, which
counts the calls by tile) and keeps the ops it issues itself uncounted.
The torch-op backward runs on meta as the aten ops it is.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import build, cost

LAUNCHES = {"flash": 0, "flash_decode": 0, "flash_combine": 0,
            "flash_cc": 0, "flash_bias": 0, "flash_partial": 0,
            "flash_merge": 0}
LSE_LAUNCHES = {"flash": 0, "flash_cc": 0,   # of those, with the lse output
                "flash_bias": 0}
REMAT_LAUNCHES = dict(LSE_LAUNCHES)           # of those, inside a backward

MAX_DIM = 256                     # the largest head dim a tile takes
TC_DIMS = (64, 80, 96, 128)       # head dims of the bf16 tensor-core tile
DECODE_DIMS = (64, 80, 96, 128, 256)   # head dims of the split-KV tile
BIAS_DIMS = (64, 384)             # head dims of the bias tile (the mLSTM's)
DECODE_ROWS = 8                   # rows of the decode tiles (Sq * G <= 8)
KEY_TILE = 64                     # keys a tile of every kernel
BWD_Q_BLOCK = 256                 # query rows a block of the backward


def in_backward() -> bool:
    """Whether the autograd engine is running a backward pass on this
    thread: a forward run now is a checkpoint's recompute."""
    return torch._C._current_graph_task_id() != -1


def reset_launches() -> None:
    for counts in (LAUNCHES, LSE_LAUNCHES, REMAT_LAUNCHES):
        for k in counts:
            counts[k] = 0


def softmax_scale(dh: int) -> float:
    """1 / sqrt(dh) as the reference rounds it: sqrt in f32, then the
    reciprocal in f32."""
    return float(np.float32(1.0) / np.float32(np.sqrt(dh)))


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention takes q (B, Sq, H, dh) and k, v "
                         "(B, Skv, Hkv, dh)")
    B, _, H, dh = q.shape
    if k.shape[0] != B or k.shape[3] != dh or H % k.shape[2]:
        raise ValueError(f"incompatible shapes q {tuple(q.shape)}, k/v "
                         f"{tuple(k.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
            torch.float32, torch.bfloat16):
        raise TypeError("flash_attention takes q, k, v all f32 or all bf16")


def _check_bias(q, k, bias_qk) -> tuple:
    fq, fk = bias_qk
    B, Sq, H, _ = q.shape
    want = ((B, Sq, H), (B, k.shape[1], H))
    if (tuple(fq.shape), tuple(fk.shape)) != want or \
            fq.dtype != torch.float32 or fk.dtype != torch.float32:
        raise ValueError(f"bias_qk takes f32 (fq, fk) shaped {want}, got "
                         f"{tuple(fq.shape)} {fq.dtype}, {tuple(fk.shape)} "
                         f"{fk.dtype}")
    return fq, fk


def device_positions(q_offset, kv_valid) -> bool:
    """Whether a call's positions are in device memory: either is a 0-d
    tensor (the other may be an int or None)."""
    return isinstance(q_offset, torch.Tensor) or \
        isinstance(kv_valid, torch.Tensor)


def _bias_form(q_offset, kv_valid, causal: bool) -> None:
    """The bias form is causal, with int positions (its one caller, the
    mLSTM's prefill, passes 0); raise for anything else."""
    if not causal or device_positions(q_offset, kv_valid):
        raise ValueError("bias_qk (the mLSTM's form) takes int q_offset and "
                         "kv_valid and the causal mask only: no tensor "
                         "positions, no causal=False")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, q_offset, kv_valid=None,
                          kv_block: int = 1024, return_lse: bool = False,
                          bias_qk: tuple | None = None,
                          return_partial: bool = False, causal: bool = True):
    """Plain version of K8: the reference's blockwise online softmax
    (``repro.models.layers.flash_attention``), (B, Sq, H, dh) in q's
    dtype; with ``return_lse`` also each row's f32 ``m + log(l)`` (B, H,
    Sq) from the reference's final ``m`` and ``l``; with
    ``return_partial`` the final f32 ``(m, l, acc)`` themselves, (B, H,
    Sq), (B, H, Sq), (B, H, Sq, dh), undivided (the reference's
    ``return_partial=True``).  ``bias_qk = (fq, fk)``, f32 (B, Sq, H) and
    (B, Skv, H), adds ``fq[b, i, h]`` then ``fk[b, j, h]`` to each score
    before the mask, fk zero-padded to the key blocks, as the reference
    does for the mLSTM.  ``causal=False`` masks ``k_pos < kv_valid`` alone
    (the TPU kernel's form).  The positions may be 0-d tensors on q's
    device (a tensor ``kv_valid`` clamped into ``[0, Skv]``, as the tiles
    clamp it); nothing is read on the host."""
    _check(q, k, v)
    if bias_qk is not None:
        _bias_form(q_offset, kv_valid, causal)
        bias_qk = _check_bias(q, k, bias_qk)
    B, Sq, H, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    f32, dev = torch.float32, q.device
    kv_block = min(kv_block, -(-Skv // 128) * 128)
    nb = -(-Skv // kv_block)
    pad = nb * kv_block - Skv
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    if kv_valid is None and pad:
        kv_valid = Skv
    if isinstance(kv_valid, torch.Tensor):
        kv_valid = kv_valid.clamp(0, Skv)
    if bias_qk is not None:
        fq_t = bias_qk[0].transpose(1, 2)[:, :, :, None]       # (B, H, Sq, 1)
        fk_t = torch.nn.functional.pad(bias_qk[1], (0, 0, 0, pad)) \
            .transpose(1, 2)[:, :, None, :]                     # (B, H, 1, K)
    qf = q.to(f32) * torch.tensor(softmax_scale(dh), dtype=f32, device=dev)
    q_pos = q_offset + torch.arange(Sq, device=dev)
    m = torch.full((B, H, Sq), -1e30, dtype=f32, device=dev)
    l = torch.zeros((B, H, Sq), dtype=f32, device=dev)
    acc = torch.zeros((B, H, Sq, dh), dtype=f32, device=dev)
    for start in range(0, nb * kv_block, kv_block):
        kb = kp[:, start:start + kv_block].repeat_interleave(G, dim=2)
        vb = vp[:, start:start + kv_block].repeat_interleave(G, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb.to(f32))
        kv_pos = start + torch.arange(kv_block, device=dev)
        mask = kv_pos[None, :] <= q_pos[:, None] if causal else \
            torch.ones((Sq, kv_block), dtype=torch.bool, device=dev)
        if kv_valid is not None:
            mask &= (kv_pos < kv_valid)[None, :]
        if bias_qk is not None:
            s = s + fq_t + fk_t[..., start:start + kv_block]
        s = torch.where(mask[None, None], s, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1)).clamp_min(-1e30)
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                   vb.to(f32))
        m = m_new
    if return_partial:
        return m, l, acc
    out = acc / l.clamp_min(1e-30)[..., None]
    # laid out (B, Sq, H, dh) as the kernels write it
    out = out.transpose(1, 2).to(q.dtype).contiguous()
    return (out, m + torch.log(l)) if return_lse else out


def split_plan(blocks: int, kend: int, sms: int) -> tuple[int, int]:
    """(n_split, tiles_per) of the split-KV decode tile: ``kend`` keys cut
    into runs of ``tiles_per`` whole 64-key tiles, enough runs that
    ``blocks * n_split`` (blocks = B * Hkv) reaches twice the SM count
    while every run holds at least one tile; one empty run when ``kend``
    is 0."""
    tiles = -(-kend // KEY_TILE)
    if tiles == 0:
        return 1, 0
    per = max(1, tiles // min(-(-2 * sms // blocks), tiles))
    return -(-tiles // per), per


def decode_kend(q_offset: int, kv_valid: int, Sq: int,
                causal: bool = True) -> int:
    """Keys any row of a decode call can see: min(kv_valid, q_offset +
    Sq), at least 0 (without the causal mask kv_valid)."""
    return max(0, min(kv_valid, q_offset + Sq) if causal else kv_valid)


def flash_decode_split_plain(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, q_offset,
                             kv_valid=None, n_split: int,
                             return_partial: bool = False,
                             causal: bool = True,
                             plan_keys: int | None = None):
    """Plain version of the split-KV decode tile's arithmetic: the first
    ``plan_keys`` keys cut into ``n_split`` runs of ``ceil(tiles /
    n_split)`` whole 64-key tiles (trailing runs may be empty); per run the
    masked scores ``(f32(q) * scale) . k``, m = max(rowmax, -1e30), l = sum
    p, acc = p . v with p = exp(s - m); then M = max m_i and out = sum acc_i
    e^(m_i - M) / max(sum l_i e^(m_i - M), 1e-30), rounded once to q's
    dtype.  A run with no key kept has m = -1e30, l = 0, acc = 0.
    ``plan_keys`` follows the tile's plans (``decode_plan``): by default
    the valid keys (``decode_kend``) for int positions, every key of the
    cache (Skv) for tensor positions, whose runs past the valid keys come
    out empty; positions are never read on the host.  With
    ``return_partial``, the return_partial form's plain version: stopped
    before the division, f32 (M, sum l_i e^(m_i - M), sum acc_i e^(m_i -
    M)) shaped (B, H, Sq), (B, H, Sq), (B, H, Sq, dh)."""
    _check(q, k, v)
    B, Sq, H, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    tensor = device_positions(q_offset, kv_valid)
    kv_valid = Skv if kv_valid is None else kv_valid
    if isinstance(kv_valid, torch.Tensor):
        kv_valid = kv_valid.clamp(0, Skv)
    f32, dev = torch.float32, q.device
    if plan_keys is None:
        plan_keys = Skv if tensor else decode_kend(q_offset, kv_valid, Sq,
                                                   causal)
    tiles = -(-plan_keys // KEY_TILE)
    span = -(-tiles // n_split) * KEY_TILE        # keys a run
    qf = q.to(f32) * torch.tensor(softmax_scale(dh), dtype=f32, device=dev)
    q_pos = q_offset + torch.arange(Sq, device=dev)
    ms, ls, accs = [], [], []
    for i in range(n_split):
        lo, hi = min(i * span, plan_keys), min((i + 1) * span, plan_keys)
        kb = k[:, lo:hi].repeat_interleave(G, dim=2).to(f32)
        vb = v[:, lo:hi].repeat_interleave(G, dim=2).to(f32)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb)
        kv_pos = lo + torch.arange(hi - lo, device=dev)
        mask = (kv_pos < kv_valid)[None, :]
        if causal:
            mask = (kv_pos[None, :] <= q_pos[:, None]) & mask
        s = torch.where(mask[None, None], s, float("-inf"))
        m = s.amax(-1).clamp_min(-1e30) if hi > lo else torch.full(
            (B, H, Sq), -1e30, dtype=f32, device=dev)
        p = torch.exp(s - m[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bhqk,bkhd->bhqd", p, vb))
    m = torch.stack(ms)
    M = m.amax(0)
    w = torch.exp(m - M)
    den = (torch.stack(ls) * w).sum(0)
    num = (torch.stack(accs) * w[..., None]).sum(0)
    if return_partial:
        return M, den, num
    out = num / den.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def _check_merge(m, l, acc) -> None:
    if m.dim() != 4 or l.shape != m.shape or acc.dim() != 5 or \
            acc.shape[:4] != m.shape or any(
                t.dtype != torch.float32 for t in (m, l, acc)):
        raise ValueError(f"flash_merge takes f32 m, l (B, H, D, Sq) and acc "
                         f"(B, H, D, Sq, dh), got {tuple(m.shape)} {m.dtype}"
                         f", {tuple(l.shape)}, {tuple(acc.shape)}")


def flash_merge_plain(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                      dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain version of the combine across positions: the D partials
    stacked on axis 2 (m, l (B, H, D, Sq), acc (B, H, D, Sq, dh), f32)
    into ``sum_i acc_i e^(m_i - M) / max(sum_i l_i e^(m_i - M), 1e-30)``
    with M = max(max_i m_i, -1e30), each sum taken in position order, as
    (B, Sq, H, dh) rounded once to ``dtype`` (the reference's ``pmax``,
    two ``psum`` and division, ``repro/models/layers.py:249-254``)."""
    _check_merge(m, l, acc)
    M = m.amax(2).clamp_min(-1e30)
    L = torch.zeros_like(M)
    A = torch.zeros_like(acc[:, :, 0])
    for i in range(m.shape[2]):
        e = torch.exp(m[:, :, i] - M)
        L = L + l[:, :, i] * e
        A = A + acc[:, :, i] * e[..., None]
    out = A / L.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(dtype).contiguous()


def flash_merge(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor
                ) -> torch.Tensor:
    """K8's combine across positions (``flash_merge_plain``'s function,
    bf16 out): CUDA tensors launch ``flash_combine_kernel`` with every
    head a group of one and the D positions as its runs; CPU tensors take
    the plain version."""
    _check_merge(m, l, acc)
    return cost.counted(
        lambda: ("flash_merge", cost.merge_work(m, l, acc)), _merge, m, l,
        acc)


def _merge(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor
           ) -> torch.Tensor:
    if m.device.type not in ("cuda", "meta"):
        return flash_merge_plain(m, l, acc)
    B, H, D, Sq = m.shape
    dh = acc.shape[-1]
    m, l, acc = m.contiguous(), l.contiguous(), acc.contiguous()
    out = torch.empty((B, Sq, H, dh), dtype=torch.bfloat16, device=m.device)
    if out.numel() == 0 or m.device.type == "meta":
        return out
    rc = build.library("flash").repro_flash_merge(
        m.data_ptr(), l.data_ptr(), acc.data_ptr(), out.data_ptr(), B, Sq,
        H, dh, D, torch.cuda.current_stream(m.device).cuda_stream)
    build.check(rc, "flash (combine across positions)")
    LAUNCHES["flash_merge"] += 1
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_plan(q: torch.Tensor, k: torch.Tensor, *, q_offset,
                kv_valid, causal: bool = True) -> tuple[int, int]:
    """``split_plan`` of a split-KV decode launch on these CUDA tensors:
    over the valid keys (``decode_kend``) for int positions; over every
    key of the cache for tensor positions, so that the launch's shape
    depends on shapes alone (a run past the valid keys writes the empty
    partial)."""
    keys = k.shape[1] if device_positions(q_offset, kv_valid) else \
        decode_kend(q_offset, kv_valid, q.shape[1], causal)
    return split_plan(q.shape[0] * k.shape[2], keys,
                      _sm_count(q.device.index or 0))


def tile_of(dtype: torch.dtype, dh: int, rows: int) -> str:
    """The ``LAUNCHES`` key of the tile that serves f32 or bf16 inputs on a
    card (rows = Sq * G); raises for a head dim no tile takes (outside 1 to
    ``MAX_DIM``)."""
    if not 1 <= dh <= MAX_DIM:
        raise ValueError(f"the kernels take head dims 1 to {MAX_DIM}, got "
                         f"{dh}")
    if dtype == torch.bfloat16:
        if rows <= DECODE_ROWS and dh in DECODE_DIMS:
            return "flash_decode"
        if rows > DECODE_ROWS and dh in TC_DIMS:
            return "flash"
    return "flash_cc"


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_offset,
            kv_valid, lse: torch.Tensor | None, bias: tuple | None = None,
            causal: bool = True) -> torch.Tensor:
    """One launch of the tile ``tile_of`` picks (``bias_tile_of`` where
    ``bias``, the checked (fq, fk) of the bias form, is given), on CUDA
    tensors (on meta tensors its stand-in: the empty output, no launch);
    ``lse`` (f32 (B, H, Sq), or None) receives each row's log-sum-exp."""
    _, Sq, H, dh = q.shape
    Hkv = k.shape[2]
    tile = tile_of(q.dtype, dh, Sq * (H // Hkv)) if bias is None else \
        bias_tile_of(q.dtype, dh)
    if lse is not None and tile == "flash_decode":
        raise ValueError(f"the {tile} tile writes no lse")
    if bias is not None and any(t.device != q.device for t in bias):
        raise ValueError("bias_qk must lie on q's device")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    meta = q.device.type == "meta"
    if not meta and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention needs 16-byte aligned tensors")
    out = torch.empty_like(q)
    if out.numel() == 0 or meta:
        return out
    _launch_tile(tile, q, k, v, out, q_offset, kv_valid, lse, bias, causal)
    if tile == "flash_decode":
        LAUNCHES["flash_combine"] += 1
    LAUNCHES[tile] += 1
    if lse is not None:
        LSE_LAUNCHES[tile] += 1
        if in_backward():
            REMAT_LAUNCHES[tile] += 1
    return out


def _by_value(q: torch.Tensor, q_offset, kv_valid) -> tuple:
    """(pos, q_offset, kv_valid) as a tile takes them: ints by value and
    no ``pos``; else ``pos``, int32 (q_offset, kv_valid) on q's device
    (an int of the two filled there, nothing copied from the host), and
    zeros by value."""
    if not device_positions(q_offset, kv_valid):
        return None, q_offset, kv_valid

    def one(x):
        if isinstance(x, torch.Tensor):
            return x.reshape(()).to(torch.int32)
        return torch.full((), x, dtype=torch.int32, device=q.device)
    return torch.stack((one(q_offset), one(kv_valid))), 0, 0


def _launch_tile(tile: str, q, k, v, out, q_offset, kv_valid, lse, bias,
                 causal: bool = True) -> None:
    """The launch of ``tile`` on contiguous CUDA tensors."""
    B, Sq, H, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    lib = build.library("flash")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scale = softmax_scale(dh)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    lse_ptr = None if lse is None else lse.data_ptr()
    pos, qo, kvv = _by_value(q, q_offset, kv_valid)
    pos_ptr = None if pos is None else pos.data_ptr()
    if tile == "flash":
        rc = lib.repro_flash_tc(*ptrs, out.data_ptr(), lse_ptr, pos_ptr, B,
                                Sq, Skv, H, Hkv, dh, qo, kvv, int(causal),
                                scale, stream)
        build.check(rc, "flash (tensor-core tile)")
    elif tile == "flash_decode":
        n_split, per = decode_plan(q, k, q_offset=q_offset,
                                   kv_valid=kv_valid, causal=causal)
        # f32 partials m, l and acc of every run, one buffer
        part = torch.empty(B * Hkv * n_split * Sq * (H // Hkv) * (dh + 2),
                           dtype=torch.float32, device=q.device)
        rc = lib.repro_flash_decode(*ptrs, part.data_ptr(), out.data_ptr(),
                                    None, None, None, pos_ptr, B, Sq, Skv, H,
                                    Hkv, dh, qo, kvv, int(causal), scale,
                                    n_split, per, stream)
        build.check(rc, "flash (split-KV decode tile and combine)")
    elif tile == "flash_bias":
        fq, fk = (t.contiguous() for t in bias)
        rc = lib.repro_flash_bias(*ptrs, fq.data_ptr(), fk.data_ptr(),
                                  out.data_ptr(), lse_ptr, B, Sq, Skv, H,
                                  Hkv, dh, qo, kvv, scale, stream)
        build.check(rc, "flash (bias tile)")
    else:
        rc = lib.repro_flash_cc(
            *ptrs, out.data_ptr(), lse_ptr, pos_ptr, B, Sq, Skv, H, Hkv, dh,
            qo, kvv, int(causal), int(q.dtype == torch.bfloat16),
            int(Sq * (H // Hkv) <= DECODE_ROWS), scale, stream)
        build.check(rc, "flash (CUDA-core tile)")


def tile_work(q, k, q_offset, kv_valid, tile: str, *,
              lse: bool = False, bias: bool = False,
              partial: bool = False, causal: bool = True) -> cost.Work:
    """``cost.flash_work`` of one call of ``tile``: the prefill and bias
    tiles compute on the bf16 tensor cores, the others at f32."""
    unit = cost.BF16 if tile in ("flash", "flash_bias") else cost.F32
    return cost.flash_work(q, k, q_offset, kv_valid, unit=unit, lse=lse,
                           bias=bias, partial=partial, causal=causal)


def _tile_name(q, k, bias) -> str:
    """The name a call is counted under: the tile a card launches (on a
    card or meta, inputs no tile takes raise here), or ``flash_plain`` for
    the CPU's plain version on such inputs."""
    try:
        if bias is not None:
            return bias_tile_of(q.dtype, q.shape[-1])
        return tile_of(q.dtype, q.shape[-1],
                       q.shape[1] * (q.shape[2] // k.shape[2]))
    except ValueError:
        if q.device.type in ("cuda", "meta"):
            raise
        return "flash_plain"


def _launch_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_offset, kv_valid, causal: bool = True) -> tuple:
    """The return_partial form on CUDA tensors: the split-KV tile's runs
    and ``flash_combine_kernel`` in its partial mode, (m, l, acc) f32 (on
    meta tensors the empty outputs, no launch)."""
    B, Sq, H, dh = q.shape
    Hkv = k.shape[2]
    if tile_of(q.dtype, dh, Sq * (H // Hkv)) != "flash_decode":
        raise ValueError(f"return_partial runs on the split-KV decode tile: "
                         f"bf16 q, k, v at head dims {DECODE_DIMS} with Sq "
                         f"* H / Hkv <= {DECODE_ROWS}, got {q.dtype}, dh "
                         f"{dh}, {Sq * (H // Hkv)} rows")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    meta = q.device.type == "meta"
    if not meta and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention needs 16-byte aligned tensors")
    f32 = dict(dtype=torch.float32, device=q.device)
    m = torch.empty((B, H, Sq), **f32)
    l = torch.empty((B, H, Sq), **f32)
    acc = torch.empty((B, H, Sq, dh), **f32)
    if acc.numel() == 0 or meta:
        return m, l, acc
    n_split, per = decode_plan(q, k, q_offset=q_offset, kv_valid=kv_valid,
                               causal=causal)
    part = torch.empty(B * Hkv * n_split * Sq * (H // Hkv) * (dh + 2),
                       **f32)
    pos, qo, kvv = _by_value(q, q_offset, kv_valid)
    rc = build.library("flash").repro_flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), part.data_ptr(), None,
        m.data_ptr(), l.data_ptr(), acc.data_ptr(),
        None if pos is None else pos.data_ptr(), B, Sq, k.shape[1], H, Hkv,
        dh, qo, kvv, int(causal), softmax_scale(dh), n_split, per,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "flash (split-KV tile, return_partial)")
    LAUNCHES["flash_partial"] += 1
    return m, l, acc


def bias_tile_of(dtype: torch.dtype, dh: int) -> str:
    """The ``LAUNCHES`` key of the tile that serves ``bias_qk`` on a card;
    raises for inputs it does not take (bf16 only, head dims
    ``BIAS_DIMS``)."""
    if dtype != torch.bfloat16 or dh not in BIAS_DIMS:
        raise ValueError(f"the bias tile takes bf16 q, k, v at head dims "
                         f"{BIAS_DIMS}, got {dtype} at {dh}")
    return "flash_bias"


def _args_of(q, k, v, q_offset, kv_valid) -> tuple:
    """The call's checked (q_offset, kv_valid): ints with ``0 <= kv_valid
    <= Skv`` (None: Skv), or, where either is a tensor, each tensor 0-d,
    of an integer dtype and on q's device, kept as it is (None: Skv)."""
    _check(q, k, v)
    Skv = k.shape[1]
    if device_positions(q_offset, kv_valid):
        for name, x in (("q_offset", q_offset), ("kv_valid", kv_valid)):
            if isinstance(x, torch.Tensor) and (
                    x.dim() != 0 or x.dtype.is_floating_point or
                    x.dtype.is_complex or x.dtype == torch.bool or
                    x.device != q.device):
                raise ValueError(f"{name} takes an int or a 0-d integer "
                                 f"tensor on q's device {q.device}, got "
                                 f"{tuple(x.shape)} {x.dtype} on {x.device}")
        return q_offset, Skv if kv_valid is None else kv_valid
    kv_valid = Skv if kv_valid is None else int(kv_valid)
    if not 0 <= kv_valid <= Skv:
        raise ValueError(f"kv_valid {kv_valid} outside [0, {Skv}]")
    return int(q_offset), kv_valid


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, q_offset, kv_valid=None,
                        bias_qk: tuple | None = None, causal: bool = True
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """K8 with its row statistics: (out, lse), lse f32 (B, H, Sq) = m +
    log(l) of each row's scaled scores (with ``bias_qk``, scaled and
    biased).  CUDA tensors launch the tile with its ``lse`` output; CPU
    tensors take the plain version."""
    q_offset, kv_valid = _args_of(q, k, v, q_offset, kv_valid)
    if bias_qk is not None:
        _bias_form(q_offset, kv_valid, causal)
        bias_qk = _check_bias(q, k, bias_qk)
    return cost.counted(
        lambda: _work(q, k, q_offset, kv_valid, bias_qk, lse=True,
                      causal=causal),
        _forward, q, k, v, q_offset, kv_valid, bias_qk, True, causal)


def _work(q, k, q_offset, kv_valid, bias, **kw) -> tuple:
    """(name, work) of a call of the tile that serves these inputs."""
    tile = _tile_name(q, k, bias)
    return tile, tile_work(q, k, q_offset, kv_valid, tile,
                           bias=bias is not None, **kw)


def _forward(q, k, v, q_offset, kv_valid, bias, lse: bool,
             causal: bool = True):
    """K8's forward on q's device: the plain version on the CPU, else
    ``_launch`` (on meta its stand-in); ``(out, lse)`` with ``lse``."""
    if q.device.type not in ("cuda", "meta"):
        return flash_attention_plain(q, k, v, q_offset=q_offset,
                                     kv_valid=kv_valid, return_lse=lse,
                                     bias_qk=bias, causal=causal)
    if not lse:
        return _launch(q, k, v, q_offset, kv_valid, None, bias, causal)
    B, Sq, H, _ = q.shape
    out_lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    return _launch(q, k, v, q_offset, kv_valid, out_lse, bias, causal), \
        out_lse


def _partial(q, k, v, q_offset, kv_valid, causal: bool = True) -> tuple:
    if q.device.type not in ("cuda", "meta"):
        return flash_attention_plain(q, k, v, q_offset=q_offset,
                                     kv_valid=kv_valid, return_partial=True,
                                     causal=causal)
    return _launch_partial(q, k, v, q_offset, kv_valid, causal)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor, lse: torch.Tensor, *,
                        q_offset, kv_valid=None,
                        bias_qk: tuple | None = None) -> tuple:
    """(dq, dk, dv) of K8 from its inputs, the output's cotangent and the
    forward's ``lse``, in torch ops on any device; with ``bias_qk = (fq,
    fk)`` also (dfq, dfk), f32 (B, Sq, H) and (B, Skv, H).  A block of
    ``BWD_Q_BLOCK`` query rows at a time, in f32: ``s = (f32(q) * scale) .
    k`` over the keys the block sees (bias form: ``(s + fq[i]) + fk[j]``),
    ``P = exp(s - lse)`` (masked: 0), ``dV += P^T dO``, ``dP = dO V^T``,
    ``D = rowsum(P * dP)``, ``dS = P * (dP - D)``, ``dQ = scale * dS K``,
    ``dK += dS^T (q * scale)``, ``dfq = sum_j dS``, ``dfk += sum_i dS``.
    The G = H / Hkv query heads of a KV head are rows of one product, so
    dk and dv come out summed over them (the transpose of the reference's
    ``jnp.repeat``); dfk stays a query head's own.  Keys at or past
    ``kv_valid`` get zero.  Each gradient of q, k, v is rounded once to its
    input's dtype.  With tensor positions (read nowhere on the host) every
    block goes over all Skv keys, the mask alone keeping the ones it sees."""
    q_offset, kv_valid = _args_of(q, k, v, q_offset, kv_valid)
    if bias_qk is not None:
        _bias_form(q_offset, kv_valid, True)
        bias_qk = _check_bias(q, k, bias_qk)
    tensor = device_positions(q_offset, kv_valid)
    if isinstance(kv_valid, torch.Tensor):
        kv_valid = kv_valid.clamp(0, k.shape[1])
    B, Sq, H, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    f32, dev = torch.float32, q.device
    scale = torch.tensor(softmax_scale(dh), dtype=f32, device=dev)

    def rows(t):                        # (B, Sq, H, x) -> (B, Hkv, G, Sq, x)
        return t.to(f32).reshape(B, Sq, Hkv, G, -1).permute(0, 2, 3, 1, 4)

    qs = rows(q) * scale
    do = rows(dout)
    ls = lse.reshape(B, Hkv, G, Sq)
    kf = k.to(f32).transpose(1, 2)      # (B, Hkv, Skv, dh)
    vf = v.to(f32).transpose(1, 2)
    dq = torch.empty((B, Hkv, G, Sq, dh), dtype=f32, device=dev)
    dk = torch.zeros((B, Hkv, Skv, dh), dtype=f32, device=dev)
    dv = torch.zeros((B, Hkv, Skv, dh), dtype=f32, device=dev)
    if bias_qk is not None:             # (B, S, H) -> (B, Hkv, G, S)
        fqr, fkr = (t.reshape(B, -1, Hkv, G).permute(0, 2, 3, 1)
                    for t in bias_qk)
        dfq = torch.zeros((B, Hkv, G, Sq), dtype=f32, device=dev)
        dfk = torch.zeros((B, Hkv, G, Skv), dtype=f32, device=dev)
    kv_pos = torch.arange(Skv, device=dev)
    for i0 in range(0, Sq, BWD_Q_BLOCK):
        i1 = min(i0 + BWD_Q_BLOCK, Sq)
        kend = Skv if tensor else max(0, min(kv_valid, q_offset + i1))
        bq = i1 - i0
        n = G * bq
        if kend == 0:
            dq[:, :, :, i0:i1] = 0
            continue
        qb = qs[:, :, :, i0:i1].reshape(B, Hkv, n, dh)
        dob = do[:, :, :, i0:i1].reshape(B, Hkv, n, dh)
        kb, vb = kf[:, :, :kend], vf[:, :, :kend]
        q_pos = q_offset + torch.arange(i0, i1, device=dev)
        keep = (kv_pos[None, :kend] <= q_pos[:, None]) & \
            (kv_pos[None, :kend] < kv_valid)                  # (bq, kend)
        keep = keep.expand(G, -1, -1).reshape(n, kend)
        s = qb @ kb.transpose(-1, -2)                         # (B, Hkv, n, k)
        if bias_qk is not None:
            s = (s.view(B, Hkv, G, bq, kend) + fqr[..., i0:i1, None]
                 + fkr[:, :, :, None, :kend]).view(B, Hkv, n, kend)
        lb = ls[:, :, :, i0:i1].reshape(B, Hkv, n, 1)
        p = torch.where(keep, torch.exp(s - lb), torch.zeros((), dtype=f32,
                                                             device=dev))
        del s
        dv[:, :, :kend] += p.transpose(-1, -2) @ dob
        dp = dob @ vb.transpose(-1, -2)
        ds = p * (dp - (p * dp).sum(-1, keepdim=True))
        del p, dp
        dq[:, :, :, i0:i1] = (ds @ kb).reshape(B, Hkv, G, bq, dh) * scale
        dk[:, :, :kend] += ds.transpose(-1, -2) @ qb
        if bias_qk is not None:
            ds = ds.view(B, Hkv, G, bq, kend)
            dfq[..., i0:i1] = ds.sum(-1)
            dfk[..., :kend] += ds.sum(3)
        del ds
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, dh).to(q.dtype)
    grads = (dq, dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(
        v.dtype))
    if bias_qk is None:
        return grads
    return grads + (dfq.permute(0, 3, 1, 2).reshape(B, Sq, H),
                    dfk.permute(0, 3, 1, 2).reshape(B, Skv, H))


class FlashAttention(torch.autograd.Function):
    """K8 under a gradient: the forward launches the tile with its ``lse``
    output (CPU: the plain version), saving q, k, v, ``lse`` and, in the
    bias form, fq and fk; the backward is ``flash_attention_bwd``, which
    also gives fq and fk their gradients.  There is no fallback: a tile
    that fails to build or launch fails the step."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, kv_valid, fq=None, fk=None):
        bias = None if fq is None else (fq, fk)
        out, lse = flash_attention_lse(q, k, v, q_offset=q_offset,
                                       kv_valid=kv_valid, bias_qk=bias)
        ctx.save_for_backward(q, k, v, lse, fq, fk)
        ctx.q_offset, ctx.kv_valid = q_offset, kv_valid
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse, fq, fk = ctx.saved_tensors
        bias = None if fq is None else (fq, fk)
        grads = flash_attention_bwd(q, k, v, dout, lse,
                                    q_offset=ctx.q_offset,
                                    kv_valid=ctx.kv_valid, bias_qk=bias)
        return (*grads[:3], None, None,
                *(grads[3:] if bias is not None else (None, None)))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_offset, kv_valid=None,
                    bias_qk: tuple | None = None,
                    return_partial: bool = False, causal: bool = True):
    """K8 (replaces ``repro.kernels.flash.flash_attention_pallas``, in the
    general form of ``repro.models.layers.flash_attention``): GQA attention
    of q (B, Sq, H, dh) over k, v (B, Skv, Hkv, dh) at query positions
    ``q_offset + i``, causal (``causal=False``: the Pallas kernel's full
    attention), keys at positions ``>= kv_valid`` masked; the positions
    ints, or 0-d integer tensors on q's device that nothing reads on the
    host; with ``bias_qk = (fq, fk)`` each score gains ``fq[b, i, h] +
    fk[b, j, h]`` (the mLSTM's parallel form; causal, int positions).
    CUDA tensors launch a kernel (``tile_of``; ``bias_tile_of`` with
    ``bias_qk``); CPU tensors take the plain version.  Where autograd
    records (grad enabled and an input, fq and fk included, requiring it)
    the call goes through ``FlashAttention`` (causal only).
    ``return_partial`` returns the f32 ``(m, l, acc)`` instead (no bias,
    no gradient; on a card ``_launch_partial``)."""
    q_offset, kv_valid = _args_of(q, k, v, q_offset, kv_valid)
    if bias_qk is not None:
        _bias_form(q_offset, kv_valid, causal)
    if return_partial:
        if bias_qk is not None:
            raise ValueError("return_partial takes no bias_qk")
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            raise ValueError("return_partial has no backward")
        return cost.counted(
            lambda: ("flash_partial", tile_work(
                q, k, q_offset, kv_valid, "flash_partial", partial=True,
                causal=causal)),
            _partial, q, k, v, q_offset, kv_valid, causal)
    bias = () if bias_qk is None else _check_bias(q, k, bias_qk)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (q, k, v, *bias)):
        if not causal:
            raise ValueError("causal=False has no backward (the reference's "
                             "Pallas kernel has none)")
        return FlashAttention.apply(q, k, v, q_offset, kv_valid, *bias)
    bias = bias or None
    return cost.counted(
        lambda: _work(q, k, q_offset, kv_valid, bias, causal=causal),
        _forward, q, k, v, q_offset, kv_valid, bias, False, causal)
