"""xLSTM blocks on one device (a port of ``repro.models.xlstm``): the mLSTM
(matrix memory; its parallel form goes through K8's ``bias_qk`` form) and
the sLSTM (scalar memory, a loop over time).

mLSTM: prefill and any S > 1 run the stabilised parallel form, attention
with the exponential-gate bias terms ``fq = F_t`` and ``fk = i_s - F_s``
(``F = cumsum(log_sigmoid(f))`` over time) through
``layers.flash_attention(bias_qk=)`` -- on the card K8's bias tile -- and,
with a state, then materialise (C, n, m) from scratch: the incoming state
is not read, as in the reference.  F is summed in XLA's cumsum order
(``core.cdf.prefix_sum``: blocks of 16), bit for bit the reference's on
the CPU; at S = 2,048 a sequential or ``torch.cumsum`` order differs from
it by 2-25 f32 ulps of |F| ~ 1.7e3, each one a 1.2e-4 shift of a score.
k is divided by ``f32(sqrt(dh))`` before its bf16 cast, and K8 scales q by
its own ``1 / sqrt(dh)``: both scalings are kept.  Decode (S = 1 with a
state) is the O(1) recurrent update of (C, n, m).

sLSTM: a loop over time of the exponential-gated cell with block-diagonal
recurrent weights; its state starts at ``n = 1e-6`` only where no state is
passed (with a cache it is the cache's zeros).  The block returns its
cell outputs plus their gated FFN, which replace the layer's input (the
reference's ``x = o``).  Its time loop runs under the ``torch.profiler``
span ``slstm.scan``.

The recurrent products (the sLSTM's ``h . r_h``, the mLSTM's C, n and
decode readout) are f32 GEMMs, as the reference's f32 einsums;
``layers.no_tf32`` refuses to run them on the card under TF32.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.cdf import prefix_sum
from . import layers

F32 = torch.float32
BF16 = torch.bfloat16


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
class MLSTMParams(NamedTuple):
    ln: torch.Tensor          # (d,)
    w_qkv: torch.Tensor       # (ef, 3 * ef)
    w_if: torch.Tensor        # (d, 2 * NH): input and forget gates
    b_if: torch.Tensor        # (2 * NH,)
    w_o: torch.Tensor         # (d, ef): output gate
    w_up: torch.Tensor        # (d, 2 * ef): up-projection and its gate
    w_down: torch.Tensor      # (ef, d)
    ln_inner: torch.Tensor    # (ef,)


class MLSTMState(NamedTuple):
    c: torch.Tensor           # (B, NH, dh, dh) f32
    n: torch.Tensor           # (B, NH, dh) f32
    m: torch.Tensor           # (B, NH) f32


def _sqrt_f32(dh: int) -> float:
    """``jnp.sqrt(dh).astype(f32)`` as the reference computes it (x64 on:
    the root in f64, rounded once to f32)."""
    return float(np.float32(np.sqrt(np.float64(dh))))


def _qkv(p: MLSTMParams, u: torch.Tensor, d: int) -> torch.Tensor:
    return layers.matmul_f32(u.to(BF16), p.w_qkv)


def mlstm_block(p: MLSTMParams, x: torch.Tensor, cfg, *,
                state: MLSTMState | None, tp_shard: bool) -> tuple:
    """x: (B, S, d) -> (out (B, S, d) in x's dtype, new_state or None)."""
    layers._no_tp(tp_shard)
    B, S, d = x.shape
    NH = cfg.xl_heads
    layers.no_tf32(x.device)
    h = layers.rms_norm(x, p.ln, cfg.norm_eps)

    up = layers.matmul_f32(h, p.w_up)
    u, gate = up.chunk(2, dim=-1)
    ef = u.shape[-1]
    dh = ef // NH

    q, k, v = _qkv(p, u, d).chunk(3, dim=-1)
    q = q.reshape(B, S, NH, dh)
    k = k.reshape(B, S, NH, dh) / torch.tensor(_sqrt_f32(dh), dtype=F32,
                                               device=x.device)
    v = v.reshape(B, S, NH, dh)

    gif = layers.matmul_f32(h, p.w_if) + p.b_if
    ig, fg = gif[..., :NH], gif[..., NH:]               # (B, S, NH)
    logf = layers.log_sigmoid(fg)

    if S == 1 and state is not None:
        lf, it = logf[:, 0], ig[:, 0]
        mn = torch.maximum(lf + state.m, it)            # (B, NH)
        fw = torch.exp(lf + state.m - mn)
        iw = torch.exp(it - mn)
        kt, vt, qt = k[:, 0], v[:, 0], q[:, 0]          # (B, NH, dh) f32
        c = fw[..., None, None] * state.c + \
            iw[..., None, None] * (kt[..., :, None] * vt[..., None, :])
        n = fw[..., None] * state.n + iw[..., None] * kt
        num = (qt[..., None, :] @ c)[..., 0, :]         # (B, NH, dh)
        den = torch.abs((qt * n).sum(-1))
        out_h = num / torch.maximum(den, torch.exp(-mn))[..., None]
        new_state = MLSTMState(c=c, n=n, m=mn)
        o = out_h.reshape(B, 1, NH * dh)
    else:
        # parallel form: K8 with the gates' bias terms; F in XLA's cumsum
        # order (blocks of 16), as the reference sums it
        f_cum = prefix_sum(logf.transpose(1, 2)).transpose(1, 2)  # (B,S,NH)
        o = layers.flash_attention(q.to(BF16), k.to(BF16), v.to(BF16),
                                   q_offset=0,
                                   bias_qk=(f_cum, ig - f_cum))
        o = o.reshape(B, S, NH * dh)
        new_state = None
        if state is not None:
            # C_S = sum_s exp(F_S - F_s + i_s - m) k_s v_s^T, from scratch
            wlog = f_cum[:, -1:, :] - f_cum + ig        # (B, S, NH)
            m_fin = wlog.amax(1)                        # (B, NH)
            wts = torch.exp(wlog - m_fin[:, None, :])
            wk = (wts[..., None] * k).permute(0, 2, 3, 1)   # (B, NH, dh, S)
            c = wk @ v.permute(0, 2, 1, 3)                  # (B, NH, dh, dh)
            n = torch.einsum("bsh,bshk->bhk", wts, k)
            new_state = MLSTMState(c=c, n=n, m=m_fin)

    o = layers.rms_norm(o, p.ln_inner, cfg.norm_eps)
    og = layers.matmul_f32(h, p.w_o)
    o = o * torch.sigmoid(og)
    y = o.to(F32) * layers.silu(gate)
    out = layers.matmul_f32(y.to(BF16), p.w_down)
    return out.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
class SLSTMParams(NamedTuple):
    ln: torch.Tensor          # (d,)
    w_x: torch.Tensor         # (d, 4 * NH * dh): gates i, f, z, o
    r_h: torch.Tensor         # (NH, dh, 4 * dh): block-diagonal recurrence
    b: torch.Tensor           # (4 * NH * dh,)
    w_up: torch.Tensor        # (d, expand * d)
    w_down: torch.Tensor      # (expand * d, d)
    ln_ff: torch.Tensor       # (d,)


class SLSTMState(NamedTuple):
    h: torch.Tensor           # (B, NH, dh) f32
    c: torch.Tensor
    n: torch.Tensor
    m: torch.Tensor


def _slstm_step(st: SLSTMState, gxt: torch.Tensor, r: torch.Tensor
                ) -> SLSTMState:
    """One step in head-major layout: st's tensors (NH, B, dh), gxt (NH, B,
    4 dh), r = f32(r_h) (NH, dh, 4 dh)."""
    g = gxt + torch.bmm(st.h, r)                        # (NH, B, 4 dh)
    gi, gf, gz, go = g.chunk(4, dim=-1)
    mn = torch.maximum(gf + st.m, gi)                   # exp-gate stabiliser
    i_ = torch.exp(gi - mn)
    f_ = torch.exp(gf + st.m - mn)
    c = f_ * st.c + i_ * torch.tanh(gz)
    n = f_ * st.n + i_
    h = torch.sigmoid(go) * c / torch.clamp_min(n, 1e-6)
    return SLSTMState(h=h, c=c, n=n, m=mn)


def slstm_block(p: SLSTMParams, x: torch.Tensor, cfg, *,
                state: SLSTMState | None, tp_shard: bool) -> tuple:
    """x: (B, S, d) -> (hs + FFN(hs) in x's dtype, over the cell's outputs
    hs; new_state, returned where a state was passed or S == 1, else None).
    The result replaces x (``_run_block`` adds no residual), as in the
    reference."""
    layers._no_tp(tp_shard)
    B, S, d = x.shape
    NH = cfg.xl_heads
    dh = d // NH
    layers.no_tf32(x.device)
    xin = layers.rms_norm(x, p.ln, cfg.norm_eps)
    gx = layers.matmul_f32(xin, p.w_x) + p.b             # (B, S, 4 NH dh)
    # head-major, time first: step t reads gx[t], an (NH, B, 4 dh) slice
    gx = gx.reshape(B, S, NH, 4 * dh).permute(1, 2, 0, 3).contiguous()

    if state is None:
        z = torch.zeros((NH, B, dh), dtype=F32, device=x.device)
        st = SLSTMState(h=z, c=z, n=z + 1e-6, m=z)
    else:
        st = SLSTMState(*(t.transpose(0, 1) for t in state))
    r = p.r_h.to(F32)
    hs = torch.empty((S, NH, B, dh), dtype=F32, device=x.device)
    with torch.profiler.record_function("slstm.scan"):
        for t in range(S):
            st = _slstm_step(st, gx[t], r)
            hs[t] = st.h
    hs = hs.permute(2, 0, 1, 3).reshape(B, S, d)
    new_st = SLSTMState(*(t.transpose(0, 1).contiguous() for t in st))

    hf = layers.rms_norm(hs.to(x.dtype), p.ln_ff, cfg.norm_eps)
    ff = layers.matmul_f32(hf, p.w_up)
    ff = layers.silu(ff).to(BF16)
    out = layers.matmul_f32(ff, p.w_down)
    return (hs + out).to(x.dtype), \
        (new_st if state is not None or S == 1 else None)
