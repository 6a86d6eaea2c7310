"""Where a training step's device time goes, on one CUDA card.

    PYTHONPATH=src python -m repro_torch.time_train [--arch
        granite-moe-1b-a400m] [--layers 24] [--batch 8] [--seq 2048]

1. The MoE block's routing and combine pieces on one layer's tensors at
   the step's shape (the first layer's router over the embedded first
   batch of the token stream, as the step's first layer routes it: zipf
   tokens repeat, so experts overflow), each in two forms, CUDA-event
   means of 10 reps, the two forms' outputs or gradients checked equal:
   - the exclusive running count of the (T k, E) one-hot: ``cumsum`` along
     its outer axis (torch's outer-axis scan runs one thread a column) and
     along the inner axis of its transpose (``layers.moe_block``'s);
   - the backward of the contributions' gather ``y_flat[slot]``: an index
     backward (a sort-based scatter-add, the overflowing assignments all
     on the trash row) and ``layers._GatherRows`` (rows written);
   - the backward of the k-term sum: autograd through the k slices and
     ``layers._SumK`` (an expanded view).
2. One warm train step (``train.step.make_train_step``, lr 1e-3, remat on)
   under ``torch.profiler``: the ops with the most device time
   (``key_averages``).

Weights are random from ``--seed``; the config is the one-card form
(``configs.single_card``), cut to ``--layers`` when given.  Each batch is
the one ``launch.train`` gives that step (``step_inputs``: token ids, or
an embedding-input arch's N(0, 1) draw; positions (3, B, S) for M-RoPE).
"""
from __future__ import annotations

import argparse
import itertools

import numpy as np
import torch

from .configs import get_arch
from .data.indexed_dataset import synthetic_token_stream
from .launch.train import step_inputs, train_config
from .models import layers as L
from .models import model as M
from .train import optimizer, step as train_step


def _ms(fn, reps: int = 10) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _moe_pieces(cfg, params, x) -> None:
    mc = cfg.moe
    T, d = x.shape[0] * x.shape[1], x.shape[2]
    E, k = mc.n_experts, mc.top_k
    C = max(int(T * k * 1.25 / E), 4)
    p = M.tree_map(lambda t: t[0], params["sb"])["pos0"]["ffn"]
    h = L.rms_norm(x, p.ln, cfg.norm_eps).reshape(T, d)
    _, top_e = L.top_k(L.matmul_f32(h, p.router), k)
    flat_e = top_e.reshape(-1)
    onehot = torch.nn.functional.one_hot(flat_e, E)

    def outer():
        return (torch.cumsum(onehot, 0) - onehot).gather(
            1, flat_e[:, None])[:, 0]

    def inner():
        oh = onehot.T.contiguous()
        return (torch.cumsum(oh, 1) - oh).gather(0, flat_e[None])[0]
    pos = inner()
    if not torch.equal(outer(), pos):
        raise AssertionError("the two running counts differ")
    local = pos < C
    slot = torch.where(local, flat_e * C + pos, E * C)
    dropped = int((~local).sum())
    y = torch.randn((E * C + 1, d), device=x.device)
    g = torch.randn((T * k, d), device=x.device) * local[:, None]

    def by_index():
        src = y.clone().requires_grad_()
        (gi,) = torch.autograd.grad(src[slot], src, g)
        return gi

    def by_rows():
        src = y.clone().requires_grad_()
        (gr,) = torch.autograd.grad(L._GatherRows.apply(src, slot), src, g)
        return gr
    if not torch.equal(by_index()[:-1], by_rows()[:-1]):
        raise AssertionError("the two gather backwards differ")
    t = torch.randn((T, k, d), device=x.device)
    gk = torch.randn((T, d), device=x.device)

    def by_slices():
        src = t.clone().requires_grad_()
        return torch.autograd.grad(L._sum_k(src), src, gk)[0]

    def by_view():
        src = t.clone().requires_grad_()
        return torch.autograd.grad(L._SumK.apply(src), src, gk)[0]
    if not torch.equal(by_slices(), by_view()):
        raise AssertionError("the two k-sum backwards differ")
    print(f"MoE pieces, one layer: T {T}, k {k}, E {E}, C {C}, "
          f"{dropped} of {T * k} assignments over capacity")
    for what, a, b in (("exclusive count: outer-axis / inner-axis scan",
                        outer, inner),
                       ("gather backward: index (scatter-add) / rows written",
                        by_index, by_rows),
                       ("k-sum backward: slices / expanded view", by_slices,
                        by_view)):
        print(f"  {what}: {_ms(a):.6f} / {_ms(b):.6f} ms")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="granite-moe-1b-a400m")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    cfg = train_config(args.arch, reduced=False, n_layers=args.layers)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = M.init_params(cfg, gen, dev)
    stream = synthetic_token_stream(args.seed, cfg.vocab_size, args.batch,
                                    args.seq)

    drawn = itertools.count()

    def batch():
        toks, labels = next(stream)
        return (step_inputs(cfg, np.ascontiguousarray(toks), next(drawn),
                            dev),
                torch.from_numpy(np.ascontiguousarray(labels)).to(dev))
    if cfg.moe is not None and get_arch(args.arch).moe_at(0):
        inputs = batch()[0]
        with torch.no_grad():
            x = inputs.to(torch.bfloat16) if cfg.embed_input else \
                M.embed_tokens(params, cfg, inputs, cfg.tp_shard)
        _moe_pieces(cfg, params, x)
        del x, inputs
    opt = optimizer.init(params)
    fn = train_step.make_train_step(cfg, lr=1e-3)
    pos = torch.arange(args.seq, dtype=torch.int32, device=dev)[None] \
        .expand(args.batch, args.seq)
    if cfg.rope == "mrope":
        pos = pos[None].expand(3, args.batch, args.seq)

    def one():
        fn(params, opt, *batch(), pos)
    one()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        one()
        torch.cuda.synchronize()
    avg = prof.key_averages()
    key = "device_time_total" if hasattr(avg[0], "device_time_total") \
        else "cuda_time_total"
    print(f"one warm step of {cfg.name} ({cfg.n_layers} layers, batch "
          f"{args.batch} x {args.seq}), ops by device time:")
    print(avg.table(sort_by=key, row_limit=args.top,
                    max_name_column_width=70))


if __name__ == "__main__":
    main()
