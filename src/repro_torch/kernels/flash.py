"""K8: blockwise causal flash attention (forward) -- wrapper, plain PyTorch
version and launch counters (the CUDA kernel is ``csrc/flash.cu``).

The function is the one every LM attention layer of the reference calls,
``repro.models.layers.flash_attention`` without ``bias_qk``; the TPU kernel
``repro.kernels.flash.flash_attention_pallas`` is its special case
``q_offset = 0``, ``kv_valid = Skv``, ``Sq = Skv``, with GQA broadcast by
the caller.  For q (B, Sq, H, dh) and k/v (B, Skv, Hkv, dh), f32 or bf16,
query head h reading KV head ``h // (H // Hkv)``:

    s    = (f32(q) * scale) . f32(k)          scale = f32(1 / f32(sqrt(dh)))
    mask = k_pos <= q_offset + i  and  k_pos < kv_valid   (masked: -inf)
    online softmax over key blocks, running max floored at -1e30
    out  = acc / max(l, 1e-30), rounded once to q's dtype.

``flash_attention_plain`` is the reference's blockwise jnp algorithm in
torch (``kv_block = min(1024, ceil(Skv / 128) * 128)``).  The tests and the
CPU path use it; nothing on the CUDA path calls it.  The kernel sums its
dot products in another order and over 64-key tiles, so the two agree to
f32 rounding, not bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from . import build

LAUNCHES = {"flash": 0, "flash_decode": 0}

DIMS = (16, 32, 64, 128)         # head dims the kernel is instantiated for
DECODE_ROWS = 8                   # rows of the decode tile (Sq * G <= 8)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, q_offset: int, kv_valid: int | None = None,
                          kv_block: int = 1024) -> torch.Tensor:
    """Plain version of K8: the reference's blockwise online softmax
    (``repro.models.layers.flash_attention``), (B, Sq, H, dh) in q's
    dtype."""
    _check(q, k, v)
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
    qf = q.to(f32) * torch.tensor(softmax_scale(dh), dtype=f32, device=dev)
    q_pos = int(q_offset) + torch.arange(Sq, device=dev)
    m = torch.full((B, H, Sq), -1e30, dtype=f32, device=dev)
    l = torch.zeros((B, H, Sq), dtype=f32, device=dev)
    acc = torch.zeros((B, H, Sq, dh), dtype=f32, device=dev)
    for start in range(0, nb * kv_block, kv_block):
        kb = kp[:, start:start + kv_block].repeat_interleave(G, dim=2)
        vb = vp[:, start:start + kv_block].repeat_interleave(G, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb.to(f32))
        kv_pos = start + torch.arange(kv_block, device=dev)
        mask = kv_pos[None, :] <= q_pos[:, None]
        if kv_valid is not None:
            mask &= (kv_pos < int(kv_valid))[None, :]
        s = torch.where(mask[None, None], s, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1)).clamp_min(-1e30)
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                   vb.to(f32))
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_offset: int, kv_valid: int | None = None
                    ) -> torch.Tensor:
    """K8 (replaces ``repro.kernels.flash.flash_attention_pallas``, in the
    general form of ``repro.models.layers.flash_attention``): causal GQA
    attention of q (B, Sq, H, dh) over k, v (B, Skv, Hkv, dh) at query
    positions ``q_offset + i``, keys at positions ``>= kv_valid`` masked.
    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    _check(q, k, v)
    q_offset = int(q_offset)
    Skv = k.shape[1]
    kv_valid = Skv if kv_valid is None else int(kv_valid)
    if not 0 <= kv_valid <= Skv:
        raise ValueError(f"kv_valid {kv_valid} outside [0, {Skv}]")
    if q.device.type != "cuda":
        return flash_attention_plain(q, k, v, q_offset=q_offset,
                                     kv_valid=kv_valid)
    B, Sq, H, dh = q.shape
    if dh not in DIMS:
        raise ValueError(f"the kernel takes head dims {DIMS}, got {dh}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention needs 16-byte aligned tensors")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    decode = Sq * (H // k.shape[2]) <= DECODE_ROWS
    rc = build.library("flash").repro_flash(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Skv,
        H, k.shape[2], dh, q_offset, kv_valid,
        int(q.dtype == torch.bfloat16), int(decode), softmax_scale(dh),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "flash")
    LAUNCHES["flash_decode" if decode else "flash"] += 1
    return out
