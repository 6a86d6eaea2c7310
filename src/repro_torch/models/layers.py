"""Transformer layers of the LM path on one device (a port of
``repro.models.layers``: norms, RoPE, flash attention, the attention block,
the dense SwiGLU MLP and the MoE block), for serving and for training.

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

Under a gradient ``matmul_f32`` and ``bmm_f32`` take the reference's
transpose of ``einsum(bf16, bf16, preferred_element_type=f32)``: each
operand's gradient is the f32 cotangent times the other operand, an f32
product, rounded once to the operand's dtype (``_MatmulF32``).

Tensor-parallel layouts (``cfg.tp_shard``) and sequence-sharded caches
run on a ``models.sharding.ModelMesh``: ``attention_block`` and
``mlp_block`` take ``mesh=`` and then lists with one tensor a mesh
position (its local shard) for the parameters, inputs and caches, run a
position at a time and end in the reference's one ``tp_psum`` over
``model`` (none with ``reduce=False``); the sequence-sharded branch
combines the positions' partial softmax results (K8's ``return_partial``
form, ``kernels.flash.flash_merge``) across ``data``.  ``moe_block``
takes ``mesh=`` too: its experts over ``model`` (expert parallelism as
tensor parallelism, one ``tp_psum``).  Without a mesh a tensor-parallel
layout raises ``not_ported`` (ROADMAP queue 1 item 14d).  Caches are
updated in place.  The activations ``softplus``, ``log_sigmoid``,
``sigmoid`` and ``silu`` are jax.nn's formulas, for the recurrent blocks
(``models/ssm.py``, ``models/xlstm.py``), with JAX's derivatives under a
gradient (``_Softplus``, ``_Sigmoid``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import not_ported
from ..kernels import cost as _cost
from ..kernels import flash as _flash
from .sharding import TP

F32 = torch.float32
BF16 = torch.bfloat16


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 product of 2-d (``mm``) or 3-d (``bmm``) operands: on the card a
    bf16 GEMM with an f32 result where both are bf16 (and so on meta
    tensors, a dry run of the card), else an f32 product of the upcast
    operands.  Counted as the card computes it (``kernels.cost``)."""
    return _cost.counted(lambda: ("mm_f32", _cost.gemm_work(a, b)),
                         _mm_f32_on, a, b)


def _mm_f32_on(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mm = torch.mm if a.dim() == 2 else torch.bmm
    if a.device.type in ("cuda", "meta") and a.dtype == b.dtype == BF16:
        return mm(a, b, out_dtype=F32)
    return mm(a.to(F32), b.to(F32))


class _MatmulF32(torch.autograd.Function):
    """``_mm_f32`` with the reference's transpose.  JAX differentiates
    ``einsum(x, w, preferred_element_type=f32)`` into an f32 cotangent g
    times the other operand, in f32, rounded once to the operand's dtype:
    ``dx = bf16(g . f32(w)^T)``, ``dw = bf16(f32(x)^T . g)``.  The port does
    exactly that.  Cost: both backward products are f32 GEMMs (the
    cotangent is f32, so the bf16 tensor cores cannot take them; on an
    H100 67 TFLOP/s against 989), plus an f32 copy of the other operand.
    ``torch.mm(..., out_dtype=f32)`` has no backward of its own to use."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = (g @ b.to(F32).transpose(-1, -2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = (a.to(F32).transpose(-1, -2) @ g).to(b.dtype)
        return ga, gb


def _records(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _MatmulF32.apply(a, b) if _records(a, b) else _mm_f32(a, b)


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("...d,df->...f", x, w, preferred_element_type=f32)``: f32
    result of bf16 (or f32) operands."""
    lead, d = x.shape[:-1], x.shape[-1]
    out = _mm(x.reshape(-1, d), w)
    return out.reshape(*lead, w.shape[-1])


def bmm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("ecd,edf->ecf", x, w, preferred_element_type=f32)``."""
    return _mm(x, w)


def no_tf32(dev: torch.device) -> None:
    """The recurrent blocks' f32 products (the sLSTM's recurrence, the
    mLSTM's state) are f32 GEMMs, as the reference's f32 einsums: on the
    card only while TF32 is off (``torch.backends.cuda.matmul.allow_tf32``,
    False by default), else raise rather than keep 10 mantissa bits."""
    if dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the recurrent blocks need full f32 products: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")


# ---------------------------------------------------------------------------
# activations (jax.nn's formulas, and under a gradient JAX's derivatives)
# ---------------------------------------------------------------------------
def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _no_posinf(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t == float("inf"), torch.zeros((), dtype=t.dtype,
                                                      device=t.device), t)


class _Softplus(torch.autograd.Function):
    """``logaddexp(x, 0)`` with the custom JVP JAX gives it: ``g *
    exp(r(x) - r(y))``, r putting 0 for +inf (1 at x = +inf, 0 at -inf, 0.5
    at 0).  Autograd of the formula would give 1 or 0 at x = 0 (the
    clamp's subgradient; torch's sign(0) is 0) and round differently."""

    @staticmethod
    def forward(ctx, x):
        y = _softplus(x)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return g * torch.exp(_no_posinf(x) - _no_posinf(y))


class _Sigmoid(torch.autograd.Function):
    """``lax.logistic`` with JAX's derivative ``g * (s * (1 - s))``
    (torch's rounds ``(g * (1 - s)) * s``)."""

    @staticmethod
    def forward(ctx, x):
        s = torch.sigmoid(x)
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return g * (s * (1.0 - s))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, ``logaddexp(x, 0)``: ``max(x, 0) +
    log1p(exp(-|x|))`` (``F.softplus`` switches to x above a threshold);
    under a gradient ``_Softplus``."""
    return _Softplus.apply(x) if _records(x) else _softplus(x)


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -softplus(-x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``; under a gradient ``_Sigmoid``."""
    return _Sigmoid.apply(x) if _records(x) else torch.sigmoid(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``x * sigmoid(x)``; under a gradient the product's
    transpose and ``_Sigmoid``'s, as JAX differentiates it."""
    return x * sigmoid(x)


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


def mrope_section_ids(sections, n: int, device=None) -> torch.Tensor:
    """``jnp.repeat(arange(3), sections, total_repeat_length=n)``, the
    section (0 = t, 1 = h, 2 = w) of each of the n = dh / 2 frequency
    slots, (n,) int64, by JAX's algorithm: a mark at each section's start
    that lies below n, and each slot the count of marks up to it, less one.
    So sections summing past n are cut (at dh 16, (16, 24, 24) gives every
    slot the t id), and sections summing short leave the rest on the last
    id ((2, 2, 2) at n 8: 0 0 1 1 2 2 2 2)."""
    j = torch.arange(n, device=device)
    starts = [sum(int(r) for r in sections[:i]) for i in range(len(sections))]
    return sum((j >= s).long() for s in starts) - 1


def apply_mrope(x: torch.Tensor, pos3: torch.Tensor, theta: float,
                sections) -> torch.Tensor:
    """M-RoPE (qwen2-vl): x (B, S, H, dh); pos3 (3, B, S) int, the (t, h,
    w) ids.  Frequency slot j turns by the id of its section
    (``mrope_section_ids``), in f32, then the half-split rotation of
    ``apply_rope``, rounded once to x's dtype.  Linear in x: autograd's
    transpose adds each half's two products, as JAX's does, in one f32
    addition (the same sum in either order)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    sec = mrope_section_ids(sections, x.shape[-1] // 2, pos3.device)
    ang = pos3.to(F32)[sec].permute(1, 2, 0) * freqs      # (B, S, dh/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.to(F32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# flash attention (K8)
# ---------------------------------------------------------------------------
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_offset: int, kv_valid: int | None = None,
                    bias_qk: tuple | None = None,
                    return_partial: bool = False) -> torch.Tensor:
    """q: (B, Sq, H, dh); k/v: (B, Skv, Hkv, dh) with H % Hkv == 0.  Causal
    over global positions (``q_offset`` for decode), keys at positions
    ``>= kv_valid`` masked; ``bias_qk = (fq, fk)``, f32 (B, Sq, H) and
    (B, Skv, H), adds the per-query and per-key terms to each score (the
    mLSTM's parallel form; under autograd fq and fk get gradients).  K8
    (``kernels.flash.flash_attention``): CUDA tensors launch the kernel,
    CPU tensors take its plain version.  ``return_partial`` returns each
    row's unnormalised f32 ``(m, l, acc)``, (B, H, Sq), (B, H, Sq) and (B,
    H, Sq, dh), for a combine across positions."""
    return _flash.flash_attention(q, k, v, q_offset=q_offset,
                                  kv_valid=kv_valid, bias_qk=bias_qk,
                                  return_partial=return_partial)


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
        raise not_ported("tensor-parallel layouts (cfg.tp_shard=True) "
                         "without a mesh (pass mesh=, a ModelMesh, or serve "
                         "configs.single_card(cfg) on one card)", "14d")


def not_under_tp(tp_shard: bool, what: str) -> None:
    """A block the port runs only outside tensor parallelism."""
    if tp_shard:
        raise not_ported(f"{what} under tp_shard", "14d")


def _qkv(p: AttnParams, x: torch.Tensor, cfg, pos, tp_rank=None) -> tuple:
    """The attention block's q (B, S, Hl, dh) and k, v (B, S, KVl, dh),
    bf16, of one position's weights: Hl from the local ``wq``.
    ``tp_rank`` (the position's ``model`` index) takes the replicated-KV
    slice of a tensor-parallel layout whose KV heads are fewer than its
    width: every rank computes all KV heads and keeps the one its
    contiguous block of query heads reads, ``g = (tp_rank * Hl *
    n_kv_heads) // n_heads_padded``."""
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
    if tp_rank is not None:
        g = (tp_rank * Hl * cfg.n_kv_heads) // cfg.n_heads_padded
        k, v = k[:, :, g:g + 1], v[:, :, g:g + 1]
    if cfg.qk_norm:
        q = rms_norm(q, p.qn, cfg.norm_eps)
        k = rms_norm(k, p.kn, cfg.norm_eps)
    if cfg.rope == "rope":
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    elif cfg.rope == "mrope":
        q = apply_mrope(q, pos, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, pos, cfg.rope_theta, cfg.mrope_sections)
    return q, k, v


def _write(cache: dict, k: torch.Tensor, v: torch.Tensor, start) -> None:
    """The S new keys and values into the cache at ``start``, clamped to
    ``S_max - S`` as ``dynamic_update_slice`` clamps it, in place.  A
    tensor ``start`` (0-d, on the cache's device) is read nowhere on the
    host: the rows go in by ``index_copy_``."""
    S = k.shape[1]
    hi = cache["k"].shape[1] - S
    if isinstance(start, torch.Tensor):
        idx = start.clamp(0, hi) + torch.arange(S, device=start.device)
        cache["k"].index_copy_(1, idx, k)
        cache["v"].index_copy_(1, idx, v)
        return
    start = min(max(start, 0), hi)
    cache["k"][:, start:start + S] = k
    cache["v"][:, start:start + S] = v


def _write_chunk(cache: dict, k: torch.Tensor, v: torch.Tensor, off) -> None:
    """A sequence-sharded chunk's write (``repro/models/layers.py:239-
    246``): the new keys and values at ``off`` (global position less the
    chunk's base) where ``0 <= off < S_l``, else nothing.  An int ``off``
    takes that branch on the host; a tensor ``off`` the reference's form,
    read nowhere on the host: a write at ``clip(off, 0, S_l - S)`` on
    every position, of the new rows where the chunk holds ``off`` and of
    the rows it already held elsewhere."""
    S_l = cache["k"].shape[1]
    if not isinstance(off, torch.Tensor):
        if 0 <= off < S_l:
            _write(cache, k, v, off)
        return
    mine = (off >= 0) & (off < S_l)
    idx = off.clamp(0, S_l - k.shape[1]) + torch.arange(k.shape[1],
                                                        device=off.device)
    for name, new in (("k", k), ("v", v)):
        old = cache[name].index_select(1, idx)
        cache[name].index_copy_(1, idx, torch.where(mine, new, old))


def _length(cache: dict):
    """A cache's filled prefix: a tensor as it is, anything else an int."""
    length = cache["length"]
    return length if isinstance(length, torch.Tensor) else int(length)


def attention_block(p: AttnParams, x: torch.Tensor, cfg, *, pos, cache=None,
                    layer_slot: int = 0, tp_shard: bool,
                    reduce: bool = True, mesh=None) -> tuple:
    """x: (B, S, d).  Returns (out, new_cache).

    cache: None (attend over this call's own K/V) or a dict with ``k``/``v``
    (B, S_max, KV, dh) and ``length`` (the filled prefix: an int, or a 0-d
    int32 tensor on the cache's device, the reference's traced value, read
    nowhere on the host): the new K/V are written at ``length`` (the start
    clamped to ``S_max - S``, as ``dynamic_update_slice`` clamps it), in
    place, and the queries attend over the cache with ``q_offset =
    length``, ``kv_valid = length + S``.
    With ``mesh`` (a ``ModelMesh``) every argument but ``cfg`` is a list
    over its positions: ``_attention_mesh``.
    """
    if mesh is not None:
        return _attention_mesh(p, x, cfg, pos=pos, cache=cache,
                               tp_shard=tp_shard, reduce=reduce, mesh=mesh)
    _no_tp(tp_shard)
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, pos)
    new_cache = None
    if cache is None:
        o = flash_attention(q, k, v, q_offset=0)
    elif cache.get("seq_sharded", False):
        raise not_ported("sequence-sharded KV caches without a mesh (pass "
                         "mesh=, a ModelMesh)", "14d")
    else:
        length = _length(cache)
        _write(cache, k, v, length)
        kc, vc = cache["k"], cache["v"]
        o = flash_attention(q, kc, vc, q_offset=length, kv_valid=length + S)
        new_cache = {"k": kc, "v": vc}

    out = matmul_f32(o.reshape(B, S, -1), p.wo)
    return (out.to(x.dtype) if reduce else out), new_cache


def _attention_mesh(p: list, x: list, cfg, *, pos: list, cache, tp_shard,
                    reduce: bool, mesh) -> tuple:
    """The attention block on a mesh (the reference's under ``shard_map``,
    ``repro/models/layers.py:185-270``), a position at a time: q, k, v of
    the position's heads (``_qkv``; under ``tp_shard`` with replicated KV
    heads the KV slice of its ``model`` index), the attention, the output
    projection of its ``wo`` rows, then one ``tp_psum`` over ``model``
    (f32; none with ``reduce=False``, which returns the f32 partials).

    ``cache`` (a list of dicts, or None) with ``seq_sharded``: each
    position holds the chunk ``[base, base + S_l)`` of the time axis,
    ``base = data index * S_l``.  Only the position whose chunk holds
    global position ``length`` writes the new K/V, at ``clip(length -
    base, 0, S_l - 1)`` (``_write_chunk``; ``length`` an int or a 0-d
    tensor, as in ``attention_block``); every position attends over its
    whole chunk with
    ``q_offset = length - base`` and no ``kv_valid`` (a chunk past
    ``length`` sees no key, one before it all of its keys) through K8's
    ``return_partial`` form, and the positions' partials are brought to
    every position of the ``data`` group (``gather_stack``) and combined
    there (``flash_merge``): the reference's ``pmax`` and two ``psum``."""
    D = mesh.size
    kv_slice = tp_shard and not cfg.kv_sharded
    seq = cache is not None and cache[0].get("seq_sharded", False)
    outs, new_caches, parts = [None] * D, [None] * D, [None] * D
    for r in range(D):
        q, k, v = _qkv(p[r], x[r], cfg, pos[r],
                       mesh.axis_index("model", r) if kv_slice else None)
        if cache is None:
            outs[r] = flash_attention(q, k, v, q_offset=0)
            continue
        c = cache[r]
        length = _length(c)
        if seq:
            off = length - mesh.axis_index("data", r) * c["k"].shape[1]
            _write_chunk(c, k, v, off)
            parts[r] = flash_attention(q, c["k"], c["v"], q_offset=off,
                                       return_partial=True)
        else:
            _write(c, k, v, length)
            outs[r] = flash_attention(q, c["k"], c["v"], q_offset=length,
                                      kv_valid=length + k.shape[1])
        new_caches[r] = {"k": c["k"], "v": c["v"]}
    if seq:
        merged = mesh.gather_stack(parts, "data", dim=2)
        outs = [_flash.flash_merge(*merged[r]) for r in range(D)]
    out = [matmul_f32(o.reshape(*o.shape[:2], -1), p[r].wo)
           for r, o in enumerate(outs)]
    if tp_shard and reduce:
        out = mesh.tp_psum(out)
    if reduce:
        out = [o.to(xr.dtype) for o, xr in zip(out, x, strict=True)]
    return out, (None if cache is None else new_caches)


# ---------------------------------------------------------------------------
# dense MLP (SwiGLU)
# ---------------------------------------------------------------------------
class MLPParams(NamedTuple):
    ln: torch.Tensor
    w_gate: torch.Tensor      # (d, f)
    w_up: torch.Tensor        # (d, f)
    w_down: torch.Tensor      # (f, d)


def mlp_block(p: MLPParams, x: torch.Tensor, cfg, *, tp_shard: bool,
              reduce: bool = True, pre_normed: torch.Tensor | None = None,
              mesh=None) -> torch.Tensor:
    """SwiGLU: ``silu(g) * u`` of the f32 gate and up projections, rounded
    to bf16, then the down projection (f32, rounded to x's dtype when
    ``reduce``).  With ``mesh``, ``p``, ``x`` and ``pre_normed`` are lists
    over its positions: each position's d_ff shard, then one ``tp_psum``
    of the f32 outputs over ``model`` under ``tp_shard`` (none with
    ``reduce=False``)."""
    if mesh is not None:
        pn = pre_normed or [None] * mesh.size
        out = [mlp_block(pr, xr, cfg, tp_shard=False, reduce=False,
                         pre_normed=n)
               for pr, xr, n in zip(p, x, pn, strict=True)]
        if tp_shard and reduce:
            out = mesh.tp_psum(out)
        if reduce:
            out = [o.to(xr.dtype) for o, xr in zip(out, x, strict=True)]
        return out
    _no_tp(tp_shard)
    h = rms_norm(x, p.ln, cfg.norm_eps) if pre_normed is None else pre_normed
    g = matmul_f32(h, p.w_gate)
    u = matmul_f32(h, p.w_up)
    a = (g * torch.sigmoid(g) * u).to(BF16)
    out = matmul_f32(a, p.w_down)
    return out.to(x.dtype) if reduce else out


# ---------------------------------------------------------------------------
# MoE block (top-k routing into capacity buckets)
# ---------------------------------------------------------------------------
class MoEParams(NamedTuple):
    ln: torch.Tensor
    router: torch.Tensor      # (d, E)
    w_gate: torch.Tensor      # (E, d, fe)
    w_up: torch.Tensor        # (E, d, fe)
    w_down: torch.Tensor      # (E, fe, d)
    sh_gate: torch.Tensor | None   # (d, n_shared * fe) with shared experts
    sh_up: torch.Tensor | None
    sh_down: torch.Tensor | None   # (n_shared * fe, d)


def top_k(logits: torch.Tensor, k: int) -> tuple:
    """(values, indices) of the k largest entries of each row, largest
    first, the lower index first among equal values (``jax.lax.top_k``'s
    rule; ``torch.topk`` promises no order on ties): a stable descending
    sort.  The values are gathered from ``logits``, so their gradient
    scatters back to the chosen entries."""
    idx = torch.sort(logits, dim=-1, descending=True, stable=True)[1][:, :k]
    return logits.gather(-1, idx), idx


class _RepeatRows(torch.autograd.Function):
    """``x[repeat(arange(T), k)]``: each row k times in a row.  Backward:
    the k gradients of a row summed in k order in their own dtype (a
    rounding after each add), as XLA's scatter-add transposes the
    reference's gather; a fixed reduction, where an index backward would
    scatter atomics on the card."""

    @staticmethod
    def forward(ctx, x, k: int):
        ctx.k = k
        return x.unsqueeze(1).expand(-1, k, -1).reshape(-1, x.shape[-1])

    @staticmethod
    def backward(ctx, g):
        return _sum_k(g.reshape(-1, ctx.k, g.shape[-1])), None


def _sum_k(t: torch.Tensor) -> torch.Tensor:
    """(T, k, d) -> (T, d): the k slices added one after another, in k
    order."""
    out = t[:, 0]
    for j in range(1, t.shape[1]):
        out = out + t[:, j]
    return out


class _SumK(torch.autograd.Function):
    """``_sum_k`` (the combine: a token's k contributions in k order, as
    XLA:CPU's scatter-add gives them) with the transpose of the reference's
    gather, each contribution receiving its token's gradient: an expanded
    view, where autograd through the k slices would zero-fill a (T, k, d)
    tensor a slice."""

    @staticmethod
    def forward(ctx, t):
        ctx.k = t.shape[1]
        return _sum_k(t)

    @staticmethod
    def backward(ctx, g):
        return g.unsqueeze(1).expand(-1, ctx.k, -1)


class _GatherRows(torch.autograd.Function):
    """``src[idx]`` for row indices unique but for the last row (the
    trash row), whose gathered rows the caller masks to zero.  Backward:
    each gradient row written to its source row, no scatter-add; the trash
    row receives zeros whichever write lands.  An index backward would
    scatter-add with a sort, one warp adding up every duplicate of the
    trash row in turn."""

    @staticmethod
    def forward(ctx, src, idx):
        ctx.save_for_backward(idx)
        ctx.rows = src.shape[0]
        return src[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        out = g.new_zeros((ctx.rows, g.shape[1]))
        out[idx] = g
        return out, None


class _Softmax(torch.autograd.Function):
    """``jax.nn.softmax`` over the last axis: ``e / sum(e)`` with ``e =
    exp(x - max)``; backward its custom JVP transposed, ``y g - y sum(y
    g)``."""

    @staticmethod
    def forward(ctx, x):
        e = torch.exp(x - x.amax(-1, keepdim=True))
        y = e / e.sum(-1, keepdim=True)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        yg = y * g
        return yg - y * yg.sum(-1, keepdim=True)


def moe_route(logits: torch.Tensor, cfg, capacity_factor: float) -> tuple:
    """The routing of T tokens from their (T, E) f32 router logits, as
    every position of a mesh computes it over all of its tokens: (flat_w
    (T * k,) f32 gates, flat_e (T * k,) experts, pos (T * k,) each
    assignment's slot in its expert, C).  The top k by ``top_k`` (lower
    index on a tie), a softmax over the k gates; ``pos`` the exclusive
    running count of earlier assignments to the same expert (token-major,
    then k order); ``C = max(int(T * top_k * capacity_factor / E), 4)``
    with the local T and the unpadded E."""
    mc = cfg.moe
    E, k = mc.n_experts, mc.top_k
    C = max(int(logits.shape[0] * k * capacity_factor / E), 4)
    gates, top_e = top_k(logits, k)
    gates = _Softmax.apply(gates)
    flat_e = top_e.reshape(-1)                           # (T * k,)
    # the exclusive running count of the one-hot, scanned along its inner
    # axis: torch's scan along an outer axis is one thread a column, 32
    # threads walking all T * k assignments in turn
    onehot = torch.nn.functional.one_hot(flat_e, E).T.contiguous()
    pos = (torch.cumsum(onehot, 1) - onehot).gather(0, flat_e[None])[0]
    return gates.reshape(-1), flat_e, pos, C


def _moe_partial(p: MoEParams, x: torch.Tensor, cfg, *, rank: int,
                 capacity_factor: float) -> torch.Tensor:
    """One position's (T, d) f32 MoE output: its ``E_l`` experts (the
    leading axis of its ``w_gate``) starting at ``base = rank * E_l``,
    fed the assignments of all T tokens that route to them within
    capacity, plus its columns of the shared experts; the sum over the
    positions is the block's output (one card: ``rank`` 0, every
    expert)."""
    B, S, d = x.shape
    T = B * S
    k = cfg.moe.top_k
    E_l = p.w_gate.shape[0]
    base = rank * E_l
    dev = x.device

    h = rms_norm(x, p.ln, cfg.norm_eps).reshape(T, d)
    logits = matmul_f32(h, p.router)                     # (T, E)
    with torch.profiler.record_function("moe.dispatch"):
        flat_w, flat_e, pos, C = moe_route(logits, cfg, capacity_factor)
        local = pos < C
        if E_l < cfg.moe.n_experts:       # experts of the other positions
            local = local & (flat_e >= base) & (flat_e < base + E_l)
        slot = torch.where(local, (flat_e - base) * C + pos, E_l * C)
        hx = _RepeatRows.apply(h.to(BF16), k)            # (T * k, d)
        buf = torch.zeros((E_l * C + 1, d), dtype=BF16, device=dev) \
            .index_put((slot,), hx)
        buf = buf[:E_l * C].reshape(E_l, C, d)
    g = bmm_f32(buf, p.w_gate)
    u = bmm_f32(buf, p.w_up)
    y = bmm_f32((g * torch.sigmoid(g) * u).to(BF16), p.w_down)  # (E_l, C, d)
    with torch.profiler.record_function("moe.combine"):
        y_flat = torch.cat([y.reshape(E_l * C, d), y.new_zeros((1, d))])
        contrib = _GatherRows.apply(y_flat, slot) * flat_w[:, None]
        contrib = torch.where(local[:, None], contrib, contrib.new_zeros(()))
        out = _SumK.apply(contrib.reshape(T, k, d))

    if cfg.moe.n_shared:
        g2 = matmul_f32(h, p.sh_gate)
        u2 = matmul_f32(h, p.sh_up)
        out = out + matmul_f32((g2 * torch.sigmoid(g2) * u2).to(BF16),
                               p.sh_down)
    return out


def moe_block(p: MoEParams, x: torch.Tensor, cfg, *, tp_shard: bool,
              capacity_factor: float = 1.25, mesh=None) -> torch.Tensor:
    """Top-k MoE FFN with capacity buckets (the reference's ``moe_block``).
    Router logits f32, routed by ``moe_route``; an assignment at slot >= C
    goes to the trash row ``E_l * C`` and contributes nothing (its token
    goes through on the residual).  ``buf`` (E_l, C, d) bf16, the expert
    GEMMs f32 with ``silu(g) * u`` rounded to bf16, then each token's k
    weighted contributions added in k order in f32 (XLA:CPU's scatter-add
    order; no atomics), plus the shared experts where the config has them,
    rounded once to x's dtype.  The routing and the combine run under
    ``torch.profiler`` spans ``moe.dispatch`` and ``moe.combine`` (a
    trace's time by kind).

    With ``mesh`` (lists over its positions) under ``tp_shard``: expert
    parallelism as tensor parallelism.  Each position routes all of its
    tokens, keeps the assignments to its ``E_l = n_experts_padded / tp``
    experts from ``model index * E_l`` (padded experts never receive a
    token), adds its columns of the shared experts, and the positions'
    f32 partials meet in one ``tp_psum`` over ``model``: no all-to-all.
    Under a data-sharded batch T is the position's own tokens, so C is
    too."""
    if mesh is not None:
        out = [_moe_partial(pr, xr, cfg, capacity_factor=capacity_factor,
                            rank=mesh.axis_index(TP, r) if tp_shard else 0)
               for r, (pr, xr) in enumerate(zip(p, x, strict=True))]
        if tp_shard:
            out = mesh.tp_psum(out)
        return [o.reshape(xr.shape).to(xr.dtype)
                for o, xr in zip(out, x, strict=True)]
    _no_tp(tp_shard)
    out = _moe_partial(p, x, cfg, rank=0, capacity_factor=capacity_factor)
    return out.reshape(x.shape).to(x.dtype)
