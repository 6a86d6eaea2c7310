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

Training (autograd recording): the mLSTM's parallel form goes through K8's
bias form under a gradient (``kernels.flash.FlashAttention``: the bias
tile with its ``lse`` output, a torch-op backward that also gives fq and
fk their gradients) and F's gradient is ``core.cdf.PrefixSum``'s, XLA's
order for the transpose of ``jnp.cumsum``; the sLSTM's loop is
``_SLSTMLoop``: the serving loop forward, a reverse loop of torch ops with
JAX's derivatives backward (under the ``torch.profiler`` span
``slstm.scan.backward``).  The mLSTM's sigmoid, silu and log-sigmoid take
JAX's derivatives too (``layers.sigmoid``, ``layers.silu``,
``layers.log_sigmoid``).

The recurrent products (the sLSTM's ``h . r_h``, the mLSTM's C, n and
decode readout) are f32 GEMMs, as the reference's f32 einsums;
``layers.no_tf32`` refuses to run them on the card under TF32.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.cdf import PrefixSum, prefix_sum
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
    layers.not_under_tp(tp_shard, "the mLSTM block")
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
        # order (blocks of 16), as the reference sums it, and under a
        # gradient its VJP in XLA's order too
        lt = logf.transpose(1, 2)
        f_cum = (PrefixSum.apply(lt) if layers._records(lt) else
                 prefix_sum(lt)).transpose(1, 2)               # (B, S, NH)
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
    o = o * layers.sigmoid(og)
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
    fm = gf + st.m
    mn = torch.maximum(fm, gi)                          # exp-gate stabiliser
    i_ = torch.exp(gi - mn)
    f_ = torch.exp(fm - mn)
    c = f_ * st.c + i_ * torch.tanh(gz)
    n = f_ * st.n + i_
    h = torch.sigmoid(go) * c / torch.clamp_min(n, 1e-6)
    return SLSTMState(h=h, c=c, n=n, m=mn)


class _SLSTMLoop(torch.autograd.Function):
    """The sLSTM's time loop under a gradient.  The forward is the serving
    loop (``_slstm_step`` a step, no graph), keeping each step's h, c, n
    and m; the backward recomputes every step's gates at once from them
    (one product over all steps for ``h' r``: the same values to f32
    rounding) with the step-local factors of JAX's derivatives (sigmoid
    ``s (1 - s)``, tanh ``(1 + z)(1 - z)``, a tie of the stabiliser's or
    the normaliser's max split in halves), then walks the steps in reverse
    in torch ops, 24 a step, carrying dh, dc, dn and dm; dgx is stacked
    once and dr is one product over all steps.  Autograd of the loop
    itself records about 20 ops a step, and under the superblock's
    checkpoint calls its pack and unpack hooks on each of their saved
    tensors.  Inputs in head-major layout: gx (S, NH, B, 4 dh), r (NH, dh,
    4 dh), the state's h, c, n, m (NH, B, dh); returns (hs (S, NH, B,
    dh), the final h, c, n, m)."""

    @staticmethod
    def forward(ctx, gx, r, h0, c0, n0, m0):
        st = SLSTMState(h0, c0, n0, m0)
        kept = ([], [], [], [])
        with torch.profiler.record_function("slstm.scan"):
            for t in range(gx.shape[0]):
                st = _slstm_step(st, gx[t], r)
                for lst, v in zip(kept, st, strict=True):
                    lst.append(v)
        H, C, N, M = (torch.stack(lst) for lst in kept)
        ctx.save_for_backward(gx, r, h0, c0, n0, m0, H, C, N, M)
        return (H, *st)

    @staticmethod
    def backward(ctx, dH, dh, dc, dn, dm):
        gx, r, h0, c0, n0, m0, H, C, N, M = ctx.saved_tensors
        S, NH, B, d4 = gx.shape
        zero = torch.zeros_like(h0)
        dh, dc, dn, dm = (zero if g is None else g for g in (dh, dc, dn, dm))
        with torch.profiler.record_function("slstm.scan.backward"):
            # every step's gates at once, from the states kept (step t
            # reads step t - 1's)
            Hp, Cp, Np, Mp = (torch.cat([t0[None], T[:-1]]) for T, t0 in (
                (H, h0), (C, c0), (N, n0), (M, m0)))
            hr = torch.bmm(Hp.transpose(0, 1).reshape(NH, S * B, -1), r)
            gi, gf, gz, go = (gx + hr.reshape(NH, S, B, d4).transpose(0, 1)
                              ).chunk(4, dim=-1)
            fm = gf + Mp
            I, F = torch.exp(gi - M), torch.exp(fm - M)
            Z, Sg = torch.tanh(gz), torch.sigmoid(go)
            NC = torch.clamp_min(N, 1e-6)
            # h = (s c) / max(n, 1e-6); c = f c' + i z, n = f n' + i;
            # i = exp(gi - m), f = exp(fm - m), m = max(fm, gi), fm = gf + m'
            KN = Sg * C / (NC * NC) * _tie(N, 1e-6)
            CSD = C * (Sg * (1.0 - Sg))
            IZD = I * ((1.0 + Z) * (1.0 - Z))
            CpF, NpF = Cp * F, Np * F
            TW = _tie(fm, gi)
            del hr, gi, gf, gz, go, fm, Hp, Cp, Np, Mp
            dgs = [None] * S
            rt = r.transpose(1, 2)
            for t in range(S - 1, -1, -1):
                if dH is not None:
                    dh = dh + dH[t]
                dq = dh / NC[t]
                dn = dn - dh * KN[t]
                dc = dc + dq * Sg[t]
                da = (dc * Z[t] + dn) * I[t]
                db = dc * CpF[t] + dn * NpF[t]
                dmn = dm - da - db
                to_fm = dmn * TW[t]
                dm = db + to_fm
                dgs[t] = dg = torch.cat(
                    [da + (dmn - to_fm), dm, dc * IZD[t], dq * CSD[t]], -1)
                dh = torch.bmm(dg, rt)
                dc, dn = dc * F[t], dn * F[t]
            dgx = torch.stack(dgs)                      # (S, NH, B, 4 dh)
            hp = torch.cat([h0[None], H[:-1]])
            dr = torch.bmm(hp.permute(1, 3, 0, 2).reshape(NH, -1, S * B),
                           dgx.permute(1, 0, 2, 3).reshape(NH, S * B, -1))
        return dgx, dr, dh, dc, dn, dm


def _tie(a: torch.Tensor, b) -> torch.Tensor:
    """The share of ``max(a, b)``'s gradient that goes to a: 1 where a > b,
    0.5 on a tie, 0 below (``jnp.maximum``'s and ``torch.maximum``'s
    rule)."""
    return (a > b).to(a.dtype) + 0.5 * (a == b).to(a.dtype)


def slstm_block(p: SLSTMParams, x: torch.Tensor, cfg, *,
                state: SLSTMState | None, tp_shard: bool) -> tuple:
    """x: (B, S, d) -> (hs + FFN(hs) in x's dtype, over the cell's outputs
    hs; new_state, returned where a state was passed or S == 1, else None).
    The result replaces x (``_run_block`` adds no residual), as in the
    reference."""
    layers.not_under_tp(tp_shard, "the sLSTM block")
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
    if layers._records(gx, r, *st):
        hs, *fin = _SLSTMLoop.apply(gx, r, *st)
        st = SLSTMState(*fin)
    else:
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
