"""Time the lookup kernels K1-K4 on one CUDA card: the kernels of
``kernels/csrc/lookup.cu`` beside other sources of the same library, on the
inputs of ``chip_smoke.py``'s paths A and B, and print the distributions of
the work that decides their design.

    PYTHONPATH=src python -m repro_torch.time_lookup [--n 200000000]
        [--source NAME=PATH ...]

Each ``--source`` is a ``lookup.cu`` with this one's C interface: an
earlier design, for example, unpacked with ``git archive`` and given the
``rows`` arguments of ``repro_lookup`` and ``repro_rmrt_lookup`` (read or
not), or this design with one element taken out.  The wrappers of
``kernels/lookup.py`` call every source, with the rows the indexes cache
(as the index paths call them).

Inputs: lognormal(0, 1) f32 keys drawn on the card from ``--seed`` and
sorted there; a linear dynamic index over them (``Index.build(keys,
n_leaves=2**18)``) and the pooled MLP one of path B (eps 0.9 corpus, MLP
pool, ``Index.build(keys, pool=..., kind="mlp")``), each after an insert of
n / 100 spread keys into its delta tier; path B's RMRT (``build_rmrt(keys,
leaf_cap=10**6, fanout=64, kind="linear", pool=<linear pool>)``); 2**20
find queries and 2**18 range pairs drawn as ``chip_smoke.py`` draws them.

Cases: K1 on both indexes' base tiers and K4 on the RMRT, with the rows
and key fence the index caches, each also at
``iters=0`` (the route alone: root or descent and window, no search; the
search's share is the difference); K2 and K3 on both indexes, K2 with MLP
leaves reading the cached rows and (``rows built``) rows its wrapper builds
at each call as before; ``leaf_rows`` alone on the MLP tables.  K2 with
linear leaves runs code no source here should change: the call's control.
Every source is held bit for bit against the plain versions on every case;
then every (source, case) is timed by CUDA events in two turns, the sources
in order and then in reverse, and the mean printed beside the two turns and
the ptxas registers of the entry functions.

Before the times it prints, from the tables on the card: the RMRT's depth,
node and leaf counts and ``search_iters``; per query and per warp (the
maximum over its 32 lanes) the levels K4's descent walks before it reaches
a leaf, and for K1 and K4 the window width (log2) and the static loop's
live trips; the share of warps whose slowest lane needs 14 trips or more;
and the windows the static depth does not converge (an empty leaf's
full-array window).
"""
from __future__ import annotations

import argparse
import re
import subprocess

import torch

from .api import Index
from .core import reuse, rmrt, synth
from .kernels import build
from .kernels import lookup as tlk

WARP = 32


def _event_ms(fn, reps: int = 50, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _registers(report: str) -> dict:
    """Entry functions of a ptxas report -> 'N regs, M B smem'."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"((?:dynamic_|rmrt_)?(?:lookup|range)_kernel)"
                          r"ILb(\d)E(?:Lb(\d)E)?", m[1])
            name = (f"{k[1]}<{k[2]}" + (f",{k[3]}" if k[3] else "") + ">"
                    ) if k else None
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            out[name] = f"{m[1]} regs, {m[2] or 0} B smem"
            name = None
    return out


def _per_warp(x: torch.Tensor) -> torch.Tensor:
    """The maximum of each warp tile of 32 consecutive work items."""
    pad = -x.shape[0] % WARP
    return torch.cat([x, x.new_zeros(pad)]).reshape(-1, WARP).amax(1)


def _live_trips(keys, q, lo, hi, iters: int) -> torch.Tensor:
    """Per query, the trips of the static search loop whose window is not
    yet empty (the trips a lane loads a key on)."""
    n = keys.shape[0]
    l, h = lo.long(), hi.long()
    trips = torch.zeros_like(l)
    for _ in range(iters):
        live = h > l
        trips += live
        mid = (l + h) >> 1
        kv = torch.where(mid < n, keys[mid.clamp(0, n - 1)],
                         torch.full_like(q, float("inf")))
        below = kv < q
        l = torch.where(live & below, mid + 1, l)
        h = torch.where(live & ~below, mid, h)
    return trips


def _stats(x: torch.Tensor) -> str:
    x = x.double()
    qs = torch.quantile(x[: 1 << 24], torch.tensor([0.5, 0.9, 0.99],
                                                   dtype=x.dtype,
                                                   device=x.device))
    return (f"mean {float(x.mean()):.3f}, p50 {float(qs[0]):.3f}, p90 "
            f"{float(qs[1]):.3f}, p99 {float(qs[2]):.3f}, max "
            f"{float(x.max()):.3f}")


def _window_report(tag, keys, q, lo, hi, iters: int) -> None:
    width = (hi - lo).clamp(min=1).double()
    trips = _live_trips(keys, q, lo, hi, iters)
    warp = _per_warp(trips)
    print(f"  {tag}: iters {iters}; log2 window width per query "
          f"{_stats(torch.log2(width))}; per warp (max) "
          f"{_stats(_per_warp(torch.log2(width)))}")
    print(f"  {tag}: live trips per query {_stats(trips)}; per warp (max) "
          f"{_stats(warp)}; warps with a lane of 14 or more trips "
          f"{float((warp >= 14).double().mean()):.6f}; windows the static "
          f"depth does not converge {int((hi - lo > (1 << iters) - 1).sum())}"
          f" of {q.shape[0]}")


def _descent_levels(mat, vec, q, fanout: int, depth: int, kind: str):
    """Per query, the levels the RMRT descent moves before its node is a
    leaf (the static loop's steps that change the node)."""
    npad = mat.shape[1]
    fv = vec.reshape(-1)
    node = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    levels = torch.zeros_like(node)
    for _ in range(depth):
        pred = tlk.lane_predict(q, mat, vec, node, kind)
        ys = fv[node + 3 * npad]
        child = tlk.trunc_clip((pred - ys) * float(fanout)
                               / (fv[node + 4 * npad] - ys), 0, fanout - 1)
        move = ~(fv[node + 6 * npad] > 0.5)
        levels += move
        node = torch.where(move, fv[node + 5 * npad].long() + child, node)
    return levels


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n", type=int, default=200_000_000)
    p.add_argument("--n-leaves", type=int, default=1 << 18)
    p.add_argument("--queries", type=int, default=1 << 20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--rmrt-leaf-cap", type=int, default=1_000_000)
    p.add_argument("--fanout", type=int, default=64)
    p.add_argument("--source", action="append", default=[],
                   metavar="NAME=PATH")
    args = p.parse_args(argv)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed)
    n, L, nq = args.n, args.n_leaves, args.queries
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"device: {smi}; torch {torch.__version__}")

    sources = {"design": build.CSRC / "lookup.cu"}
    sources.update(s.split("=", 1) for s in args.source)
    libs = build.build_sources("lookup", sources)
    for v, (_, report) in libs.items():
        print(f"ptxas[{v}] {_registers(report)}")

    def draw(m):
        return torch.empty(m, dtype=torch.float32, device=dev).log_normal_(
            0.0, 1.0, generator=g)

    keys32 = torch.sort(draw(n)).values
    pick = keys32[torch.randint(0, n, (nq // 2,), device=dev, generator=g)]
    qf = torch.cat([pick, draw(nq - nq // 2)])
    m = nq // 4
    lof = torch.cat([keys32[torch.randint(0, n, (m // 2,), device=dev,
                                          generator=g)], draw(m - m // 2)])
    width = torch.empty(m, dtype=torch.float64, device=dev).exponential_(
        1.0 / 0.002, generator=g)
    hif = (lof.double() + width).to(torch.float32)
    hif[: m // 64] = lof[: m // 64] - 0.5

    keys = keys32.to(torch.float64)
    corpus = synth.generate_pool(0.9)
    pool = reuse.build_pool(corpus, kind="mlp", train_steps=400, device=dev)
    lin_pool = reuse.build_pool(corpus, kind="linear", device=dev)
    indexes = {"linear": Index.build(keys, n_leaves=L),
               "mlp": Index.build(keys, pool=pool, kind="mlp", n_leaves=L,
                                  train_steps=300)}
    cases = {}
    for kind, ix in indexes.items():
        ix.insert(draw(n // 100).to(torch.float64))
        d = ix.backend
        tabs, kf = d.index.packed_tables(), d.index.keys_f32
        rows, fence = d.index.leaf_rows(), d.index.key_fence
        dk = tlk.pad_delta(d.delta_keys_f32)
        kw = dict(n_leaves=L, route_n=d.route_n, iters=d.index.search_iters,
                  leaf_kind=kind)
        print(f"inputs {kind}: n {n}, leaves {L}, queries {nq}, pairs {m}, "
              f"base capacity {kf.shape[0]}, iters {kw['iters']}, delta "
              f"{dk.shape[0]} ({tlk.full_iters(dk.shape[0])} trips)")
        lo, hi = tlk.route_window(qf, *tabs, n_keys=kf.shape[0],
                                  n_leaves=L, route_n=d.route_n,
                                  leaf_kind=kind)
        _window_report(f"K1 {kind}", kf, qf, lo, hi, kw["iters"])
        a = (tabs, kf, dk, kw, rows, fence)
        for it in (kw["iters"], 0):
            tag = f"K1 {kind}" + ("" if it else " route (iters 0)")
            k1 = dict(kw, iters=it)
            cases[tag] = (
                lambda a=a, k1=k1: (tlk.lookup(qf, *a[0], a[1], rows=a[4],
                                               fence=a[5], **k1),),
                lambda a=a, k1=k1: (tlk.lookup_plain(qf, *a[0], a[1],
                                                     **k1),))
        cases[f"K2 {kind}"] = (
            lambda a=a: tlk.dynamic_lookup(qf, *a[0], a[1], a[2], rows=a[4],
                                           **a[3]),
            lambda a=a: tlk.dynamic_lookup_plain(qf, *a[0], a[1], a[2],
                                                 **a[3]))
        cases[f"K3 {kind}"] = (
            lambda a=a: tlk.dynamic_range(lof, hif, *a[0], a[1], a[2],
                                          **a[3]),
            lambda a=a: tlk.dynamic_range_plain(lof, hif, *a[0], a[1], a[2],
                                                **a[3]))
        if kind == "mlp":
            cases["K2 mlp (rows built)"] = (
                lambda a=a: tlk.dynamic_lookup(qf, *a[0], a[1], a[2],
                                               **a[3]), cases["K2 mlp"][1])
            cases["leaf_rows mlp"] = (
                lambda t=tabs: (tlk.leaf_rows(*t[1:]),), lambda: (rows,))

    tree = rmrt.build_rmrt(keys, leaf_cap=args.rmrt_leaf_cap,
                           fanout=args.fanout, kind="linear", pool=lin_pool,
                           device=dev)
    mat, vec = tree.packed_tables()
    nrows, tkf, tfence = tree.node_rows(), tree.keys_f32, tree.key_fence
    tkw = dict(fanout=tree.fanout, depth=tree.depth, kind=tree.kind)
    levels = _descent_levels(mat, vec, qf, **tkw)
    print(f"RMRT: depth {tree.depth}, nodes {tree.num_nodes}, leaves "
          f"{int(tree.is_leaf.sum())}, search_iters {tree.search_iters}")
    print(f"  K4 descent: levels moved per query {_stats(levels)}; per warp "
          f"(max) {_stats(_per_warp(levels))}; queries by levels "
          f"{torch.bincount(levels, minlength=tree.depth + 1).tolist()}")
    lo, hi = tlk.rmrt_route_window(qf, mat, vec, n_keys=tkf.shape[0], **tkw)
    _window_report("K4", tkf, qf, lo, hi, tree.search_iters)
    for it in (tree.search_iters, 0):
        tag = "K4" + ("" if it else " descent (iters 0)")
        cases[tag] = (
            lambda it=it: (tlk.rmrt_lookup(qf, mat, vec, tkf, rows=nrows,
                                           fence=tfence, iters=it, **tkw),),
            lambda it=it: (tlk.rmrt_lookup_plain(qf, mat, vec, tkf,
                                                 iters=it, **tkw),))

    orig = build.library

    def use(v):
        build.library = (lambda name: libs[v][0] if name == "lookup"
                         else orig(name))

    try:
        for v in libs:
            use(v)
            for c, (kern, plain) in cases.items():
                got, want = kern(), plain()
                torch.cuda.synchronize()
                for i, (x, y) in enumerate(zip(got, want, strict=True)):
                    if not torch.equal(x, y):
                        raise AssertionError(
                            f"{v} {c}: output {i} differs from the plain "
                            f"version at {int((x != y).sum())} entries")
        ms = {(v, c): [] for v in libs for c in cases}
        for order in (list(libs), list(libs)[::-1]):
            for v in order:
                use(v)
                for c, (kern, _) in cases.items():
                    ms[v, c].append(_event_ms(kern))
    finally:
        build.library = orig
    print("every source equals the plain versions bit for bit")
    for c in cases:
        print(f"{c}: " + ", ".join(
            f"{v} {sum(ms[v, c]) / 2:.6f} ms ({ms[v, c][0]:.6f}/"
            f"{ms[v, c][1]:.6f})" for v in libs))


if __name__ == "__main__":
    main()
