"""The Mamba block of jamba's SSM layers on one device (a port of
``repro.models.ssm``: ``MambaParams``, ``MambaState``, ``_ssm_scan``,
``mamba_block``).

Numerics follow the reference: the projections are ``matmul_f32``
(bf16 operands, f32 result), the depthwise causal conv is Python's ``sum``
over the taps in f32 (tap 0 added onto the int 0, then taps 1 .. K-1, then
the bias), ``softplus`` and ``silu`` are jax.nn's formulas
(``layers.softplus``, ``layers.silu``), and the selective scan runs in f32.
Prefill scans the sequence in chunks of ``min(256, S)`` steps (``S`` must
be a multiple of it, as the reference asserts); decode (S = 1) is the
one-step recurrence.  The conv state is stored as bf16 and read back as
f32.

The scan is a loop over time on the host, as the reference's ``lax.scan``:
each chunk's decay ``exp(dt a)`` and input ``dt x b`` (L, B, d_inner,
d_state) are computed for the whole chunk first -- the same elementwise
roundings as the reference's step -- and each step is then one multiply and
one add, written into the chunk's stack of states; ``y = c . h + D x``
follows for the chunk at once (``_scan_chunk``).  The time loop runs under the
``torch.profiler`` span ``mamba.scan`` (a trace's host share of it).  The
TPU reference has no kernel here, and neither has the port.

Training (autograd recording): each chunk's states are stacked once
instead, under ``torch.utils.checkpoint`` (non-reentrant), as the
reference's chunk body is ``jax.checkpoint``ed: the backward keeps a chunk
boundary's state, not every step's.  ``softplus`` and ``silu`` take JAX's derivatives.

On a ``models.sharding.ModelMesh`` (``mamba_block(..., mesh=)``) the block
runs a position at a time in two halves around the reference's two
collectives: the ``x_proj`` features' ``tp_psum`` and the output's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from . import layers

F32 = torch.float32
BF16 = torch.bfloat16
CHUNK = 256


class MambaParams(NamedTuple):
    ln: torch.Tensor          # (d,)
    in_proj: torch.Tensor     # (d, 2 * di)
    conv_w: torch.Tensor      # (d_conv, di)
    conv_b: torch.Tensor      # (di,)
    x_proj: torch.Tensor      # (di, dt_rank + 2 * d_state)
    dt_w: torch.Tensor        # (dt_rank, di)
    dt_b: torch.Tensor        # (di,)
    a_log: torch.Tensor       # (di, d_state)
    d_skip: torch.Tensor      # (di,)
    out_proj: torch.Tensor    # (di, d)


class MambaState(NamedTuple):
    conv: torch.Tensor        # (B, d_conv - 1, di) bf16: trailing inputs
    h: torch.Tensor           # (B, di, d_state) f32


def _scan_chunk(h, xc, dtc, bc, cc, a, d_skip) -> tuple:
    """One chunk of ``_ssm_scan``: (y (B, L, di), the last state).  The
    chunk's decay ``exp(dt a)`` and input ``dt x b`` (L, B, di, ds) first,
    then one multiply and one add a step: without a gradient each state
    written into the chunk's stack (``out=``); under one the states stacked
    once (autograd rejects ``out=``) from the inputs unbound (an index a
    step would zero-fill the whole stacks in each step's backward)."""
    decay = torch.exp(dtc.transpose(0, 1)[..., None] * a)
    u = (dtc * xc).transpose(0, 1)[..., None] * \
        bc.transpose(0, 1)[:, :, None, :]
    with torch.profiler.record_function("mamba.scan"):
        if layers._records(decay, u, h):
            steps = []
            for dt_a, dbx in zip(decay.unbind(0), u.unbind(0), strict=True):
                h = dt_a * h + dbx
                steps.append(h)
            hs = torch.stack(steps)
        else:
            hs = torch.empty_like(u)
            for t in range(hs.shape[0]):
                torch.add(decay[t] * h, u[t], out=hs[t])
                h = hs[t]
    y = (hs * cc.transpose(0, 1)[:, :, None, :]).sum(-1) + \
        d_skip * xc.transpose(0, 1)
    return y.transpose(0, 1), h


def _ssm_scan(x, dt, b_in, c_in, a, d_skip, h0, chunk: int) -> tuple:
    """Selective scan ``h_t = exp(dt_t a) h_{t-1} + dt_t b_t x_t``, ``y_t =
    c_t . h_t + D x_t`` over chunks of ``chunk`` steps (``_scan_chunk``).
    x, dt (B, S, di), b, c (B, S, ds), a (di, ds), h0 (B, di, ds); returns
    (y (B, S, di), h_final), both f32.  Under a gradient each chunk runs
    under ``torch.utils.checkpoint`` (non-reentrant: its decay, input and
    states recomputed in the backward), as the reference
    ``jax.checkpoint``s its chunk body."""
    grad = layers._records(x, dt, b_in, c_in, a, d_skip, h0)
    ys, h = [], h0
    for c0 in range(0, x.shape[1], chunk):
        args = (h, x[:, c0:c0 + chunk], dt[:, c0:c0 + chunk],
                b_in[:, c0:c0 + chunk], c_in[:, c0:c0 + chunk], a, d_skip)
        y, h = checkpoint(_scan_chunk, *args, use_reentrant=False) \
            if grad else _scan_chunk(*args)
        ys.append(y)
    # without a gradient h is a view into the last chunk's stack
    return torch.cat(ys, 1), h if grad else h.clone()


def _mamba_in(p: MambaParams, x: torch.Tensor, cfg,
              state: MambaState | None) -> tuple:
    """The block up to ``x_proj``: (xc (B, S, di) f32 after the conv and
    silu, z (B, S, di) f32, the new conv state or None, feats (B, S,
    dt_rank + 2 d_state) f32 -- a position's partial sum on a mesh).  xs
    and z are the two halves of ``in_proj``'s columns as this position
    holds them."""
    B, S, d = x.shape
    h = layers.rms_norm(x, p.ln, cfg.norm_eps)
    xz = layers.matmul_f32(h, p.in_proj)
    di = xz.shape[-1] // 2
    xs, z = xz[..., :di], xz[..., di:]

    # depthwise causal conv over time (d_conv taps)
    K = cfg.d_conv
    if state is None:
        pad = torch.zeros((B, K - 1, di), dtype=xs.dtype, device=x.device)
        new_conv = xs[:, S - (K - 1):, :] if S >= K - 1 else None
    else:
        pad = state.conv.to(xs.dtype)
        new_conv = torch.cat([pad, xs], 1)[:, -(K - 1):, :]
    xp = torch.cat([pad, xs], 1)                        # (B, S + K - 1, di)
    xc = sum(xp[:, i:i + S, :] * p.conv_w[i] for i in range(K)) + p.conv_b
    xc = layers.silu(xc)
    feats = layers.matmul_f32(xc.to(BF16), p.x_proj)
    return xc, z, new_conv, feats


def _mamba_out(p: MambaParams, xc, z, new_conv, feats, cfg,
               state: MambaState | None, chunk: int) -> tuple:
    """The block from the (summed) ``x_proj`` features on: (out (B, S, d)
    f32 -- a position's partial sum on a mesh, the new state or None)."""
    B, S, di = xc.shape
    dtr, ds = cfg.dt_rank, cfg.d_state
    dt_in = feats[..., :dtr]
    b_in = feats[..., dtr:dtr + ds]
    c_in = feats[..., dtr + ds:]
    dt = layers.softplus(layers.matmul_f32(dt_in.to(BF16), p.dt_w) + p.dt_b)
    a = -torch.exp(p.a_log.to(F32))                     # (di, ds)

    h0 = state.h if state is not None else \
        torch.zeros((B, di, ds), dtype=F32, device=xc.device)
    if S == 1:                                          # decode
        decay = torch.exp(dt[:, 0, :, None] * a)
        hn = decay * h0 + (dt[:, 0] * xc[:, 0].to(F32))[..., None] * \
            b_in[:, 0, None, :]
        y = (hn * c_in[:, 0, None, :]).sum(-1) + p.d_skip * xc[:, 0]
        y = y[:, None, :]
    else:
        ch = min(chunk, S)
        if S % ch:
            raise ValueError(f"mamba_block: the sequence ({S}) must be a "
                             f"multiple of the scan chunk ({ch})")
        y, hn = _ssm_scan(xc.to(F32), dt, b_in, c_in, a, p.d_skip, h0, ch)

    y = y * layers.silu(z)
    out = layers.matmul_f32(y.to(BF16), p.out_proj)
    new_state = None
    if state is not None or S == 1:
        conv = new_conv if new_conv is not None else \
            torch.zeros((B, cfg.d_conv - 1, di), dtype=xc.dtype,
                        device=xc.device)
        new_state = MambaState(conv=conv.to(BF16), h=hn)
    return out, new_state


def one_card_in_proj(w: torch.Tensor, tp: int) -> torch.Tensor:
    """A TP layout's global ``in_proj`` (.., d, 2 d_inner), whose rank-r
    columns are ``[xs_r | z_r]``, as the one-card form's ``[xs_0 ..
    xs_{tp-1} | z_0 .. z_{tp-1}]``: the tree on which the one-card form
    computes the TP layout's function (the gates that hold one against
    the other)."""
    *lead, d, n = w.shape
    return w.reshape(*lead, d, tp, 2, n // (2 * tp)).transpose(-3, -2) \
        .reshape(*lead, d, n)


def mamba_block(p: MambaParams, x: torch.Tensor, cfg, *,
                state: MambaState | None, tp_shard: bool,
                chunk: int = CHUNK, mesh=None) -> tuple:
    """x: (B, S, d) -> (out (B, S, d) in x's dtype, new_state).  The new
    state is returned where a state was passed or S == 1, else None.

    With ``mesh`` (a ``ModelMesh``) ``p``, ``x`` and ``state`` are lists
    over its positions and so are both results.  Under ``tp_shard`` each
    position works on its ``d_inner / tp`` channels (the reference's
    layout: its xs and z are the two halves of its own ``in_proj``
    columns, so rank r's xs and z are not columns r of the one-card
    form's xs and z halves), its ``x_proj`` partial features summed over
    ``model`` (``tp_psum``) before the softplus and the scan, its
    ``out_proj`` partial summed likewise; the conv and scan states are
    the position's channels."""
    if mesh is not None:
        st = state or [None] * mesh.size
        ins = [_mamba_in(pr, xr, cfg, sr)
               for pr, xr, sr in zip(p, x, st, strict=True)]
        feats = [f for *_, f in ins]
        if tp_shard:
            feats = mesh.tp_psum(feats)
        done = [_mamba_out(pr, xc, z, nc, f, cfg, sr, chunk)
                for pr, (xc, z, nc, _), f, sr in zip(p, ins, feats, st,
                                                     strict=True)]
        out = [o for o, _ in done]
        if tp_shard:
            out = mesh.tp_psum(out)
        return [o.to(xr.dtype) for o, xr in zip(out, x, strict=True)], \
            [s_ for _, s_ in done]
    layers._no_tp(tp_shard)
    xc, z, new_conv, feats = _mamba_in(p, x, cfg, state)
    out, new_state = _mamba_out(p, xc, z, new_conv, feats, cfg, state, chunk)
    return out.to(x.dtype), new_state
