"""Transformer layers of the LM serving path on one device (a port of
``repro.models.layers``: norms, RoPE, flash attention, the attention block
and the dense SwiGLU MLP).

Numerics follow the reference: parameters and activations bf16, every
projection an ``einsum(bf16, bf16, preferred_element_type=f32)`` whose f32
result is kept where the reference keeps it (the MLP's gate and up
projections, the logits) and rounded once to bf16 where the reference
casts it (q, k, v, the attention and MLP outputs).  ``matmul_f32`` is that
product: on the card a bf16 GEMM with an f32 result
(``torch.mm(..., out_dtype=torch.float32)``: bf16 operands, f32 sums), on
the CPU an f32 product of the upcast operands (the products of two bf16
values are exact in f32).  No GEMM with a bf16 result is issued, so the
setting ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
never applies and is never changed.  Norms, RoPE and the softmax run in f32.

There is no mesh: tensor-parallel layouts (``cfg.tp_shard``), sequence-
sharded caches, ``bias_qk``, partial softmax results, M-RoPE and MoE raise
``not_ported`` (ROADMAP queue 1 item 14).  Caches are updated in place.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import not_ported
from ..kernels import flash as _flash

F32 = torch.float32
BF16 = torch.bfloat16


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("...d,df->...f", x, w, preferred_element_type=f32)``: f32
    result of bf16 (or f32) operands."""
    lead, d = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, d)
    if x.device.type == "cuda" and x.dtype == w.dtype == BF16:
        out = torch.mm(x2, w, out_dtype=F32)
    else:
        out = torch.mm(x2.to(F32), w.to(F32))
    return out.reshape(*lead, w.shape[-1])


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalised in f32, rounded to x's dtype, then scaled (in that
    order, as the reference)."""
    xf = x.to(F32)
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=F32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (B, S, H, dh); pos: (B, S) int.  Half-split (NeoX) rotation in
    f32, rounded once to x's dtype."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = pos[..., None].to(F32) * freqs                # (B, S, dh/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.to(F32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def apply_mrope(x, pos3, theta, sections):
    raise not_ported("M-RoPE (apply_mrope)", "14")


# ---------------------------------------------------------------------------
# flash attention (K8)
# ---------------------------------------------------------------------------
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_offset: int, kv_valid: int | None = None,
                    bias_qk: tuple | None = None,
                    return_partial: bool = False) -> torch.Tensor:
    """q: (B, Sq, H, dh); k/v: (B, Skv, Hkv, dh) with H % Hkv == 0.  Causal
    over global positions (``q_offset`` for decode), keys at positions
    ``>= kv_valid`` masked.  K8 (``kernels.flash.flash_attention``): CUDA
    tensors launch the kernel, CPU tensors take its plain version."""
    if bias_qk is not None:
        raise not_ported("flash_attention(bias_qk=...) (the mLSTM reuse)",
                         "14")
    if return_partial:
        raise not_ported("flash_attention(return_partial=True) "
                         "(sequence-sharded decode)", "14")
    return _flash.flash_attention(q, k, v, q_offset=q_offset,
                                  kv_valid=kv_valid)


# ---------------------------------------------------------------------------
# attention block (GQA + optional qk_norm / bias)
# ---------------------------------------------------------------------------
class AttnParams(NamedTuple):
    ln: torch.Tensor          # (d,)
    wq: torch.Tensor          # (d, H*dh)
    wk: torch.Tensor          # (d, KV*dh)
    wv: torch.Tensor          # (d, KV*dh)
    wo: torch.Tensor          # (H*dh, d)
    bq: torch.Tensor | None   # (H*dh,) with qkv_bias
    bk: torch.Tensor | None
    bv: torch.Tensor | None
    qn: torch.Tensor | None   # (dh,) qk_norm scales
    kn: torch.Tensor | None


def _no_tp(tp_shard: bool) -> None:
    if tp_shard:
        raise not_ported("tensor-parallel layouts (cfg.tp_shard=True; serve "
                         "configs.single_card(cfg) on one card)", "14")


def attention_block(p: AttnParams, x: torch.Tensor, cfg, *, pos, cache=None,
                    layer_slot: int = 0, tp_shard: bool,
                    reduce: bool = True) -> tuple:
    """x: (B, S, d).  Returns (out, new_cache).

    cache: None (attend over this call's own K/V) or a dict with ``k``/``v``
    (B, S_max, KV, dh) and ``length`` (the filled prefix, an int): the new
    K/V are written at ``length`` (the start clamped to ``S_max - S``, as
    ``dynamic_update_slice`` clamps it), in place, and the queries attend
    over the cache with ``q_offset = length``, ``kv_valid = length + S``.
    """
    _no_tp(tp_shard)
    B, S, _ = x.shape
    dh = cfg.head_dim
    h = rms_norm(x, p.ln, cfg.norm_eps)
    q = matmul_f32(h, p.wq).to(BF16)
    k = matmul_f32(h, p.wk).to(BF16)
    v = matmul_f32(h, p.wv).to(BF16)
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    Hl = q.shape[-1] // dh
    q = q.reshape(B, S, Hl, dh)
    k = k.reshape(B, S, -1, dh)
    v = v.reshape(B, S, -1, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p.qn, cfg.norm_eps)
        k = rms_norm(k, p.kn, cfg.norm_eps)
    if cfg.rope == "rope":
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    elif cfg.rope == "mrope":
        apply_mrope(q, pos, cfg.rope_theta, cfg.mrope_sections)

    new_cache = None
    if cache is None:
        o = flash_attention(q, k, v, q_offset=0)
    elif cache.get("seq_sharded", False):
        raise not_ported("sequence-sharded KV caches (flash-decoding across "
                         "devices)", "14")
    else:
        length = int(cache["length"])
        kc, vc = cache["k"], cache["v"]
        start = min(max(length, 0), kc.shape[1] - S)
        kc[:, start:start + S] = k
        vc[:, start:start + S] = v
        o = flash_attention(q, kc, vc, q_offset=length, kv_valid=length + S)
        new_cache = {"k": kc, "v": vc}

    out = matmul_f32(o.reshape(B, S, Hl * dh), p.wo)
    return (out.to(x.dtype) if reduce else out), new_cache


# ---------------------------------------------------------------------------
# dense MLP (SwiGLU)
# ---------------------------------------------------------------------------
class MLPParams(NamedTuple):
    ln: torch.Tensor
    w_gate: torch.Tensor      # (d, f)
    w_up: torch.Tensor        # (d, f)
    w_down: torch.Tensor      # (f, d)


def mlp_block(p: MLPParams, x: torch.Tensor, cfg, *, tp_shard: bool,
              reduce: bool = True, pre_normed: torch.Tensor | None = None
              ) -> torch.Tensor:
    """SwiGLU: ``silu(g) * u`` of the f32 gate and up projections, rounded
    to bf16, then the down projection (f32, rounded to x's dtype when
    ``reduce``)."""
    _no_tp(tp_shard)
    h = rms_norm(x, p.ln, cfg.norm_eps) if pre_normed is None else pre_normed
    g = matmul_f32(h, p.w_gate)
    u = matmul_f32(h, p.w_up)
    a = (g * torch.sigmoid(g) * u).to(BF16)
    out = matmul_f32(a, p.w_down)
    return out.to(x.dtype) if reduce else out


def moe_block(p, x, cfg, *, tp_shard: bool, capacity_factor: float = 1.25):
    raise not_ported("MoE FFN (moe_block)", "14")
