"""Time K2 (``dynamic_lookup``) and K3 (``dynamic_range``) on one CUDA card:
the kernels of ``kernels/csrc/lookup.cu`` beside other sources of the same
library, on the inputs of ``chip_smoke.py``'s paths A and B.

    PYTHONPATH=src python -m repro_torch.time_lookup [--n 200000000]
        [--source NAME=PATH ...]

Each ``--source`` is a ``lookup.cu`` with this one's C interface: an
earlier design, for example, unpacked with ``git archive`` and given the
``rows`` argument of ``repro_dynamic_lookup``.  The wrappers of
``kernels/lookup.py`` call every source, so each pays what the wrapper
does around the launch (K2 with MLP leaves: building ``leaf_rows``).

Inputs: lognormal(0, 1) f32 keys drawn on the card from ``--seed`` and
sorted there; a linear dynamic index over them (``Index.build(keys,
n_leaves=2**18)``) and the pooled MLP one of path B (eps 0.9 corpus, MLP
pool, ``Index.build(keys, pool=..., kind="mlp")``), each after an insert of
n / 100 spread keys into its delta tier; 2**20 find queries and 2**18
range pairs drawn as ``chip_smoke.py`` draws them.

Every source is held bit for bit against the plain versions on every
input; then every (source, case) is timed by CUDA events in two turns, the
sources in order and then in reverse, and the mean printed beside the two
turns and the ptxas registers of the K2/K3 entry functions.  Cases: K2 and
K3 on both indexes, K1 on the linear one (a kernel no source here should
change: the call's control), and ``leaf_rows`` alone on the MLP tables.
"""
from __future__ import annotations

import argparse
import re
import subprocess

import torch

from .api import Index
from .core import reuse, synth
from .kernels import build
from .kernels import lookup as tlk


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
    """K2/K3 entry functions of a ptxas report -> 'N regs, M B smem'."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(dynamic_\w+?_kernel)ILb(\d)ELb(\d)E", m[1])
            name = f"{k[1]}<{k[2]},{k[3]}>" if k else None
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            out[name] = f"{m[1]} regs, {m[2] or 0} B smem"
            name = None
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n", type=int, default=200_000_000)
    p.add_argument("--n-leaves", type=int, default=1 << 18)
    p.add_argument("--queries", type=int, default=1 << 20)
    p.add_argument("--seed", type=int, default=0)
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
    pool = reuse.build_pool(synth.generate_pool(0.9), kind="mlp",
                            train_steps=400, device=dev)
    indexes = {"linear": Index.build(keys, n_leaves=L),
               "mlp": Index.build(keys, pool=pool, kind="mlp", n_leaves=L,
                                  train_steps=300)}
    cases = {}
    for kind, ix in indexes.items():
        ix.insert(draw(n // 100).to(torch.float64))
        d = ix.backend
        tabs, kf = d.index.packed_tables(), d.index.keys_f32
        dk = tlk.pad_delta(d.delta_keys_f32)
        kw = dict(n_leaves=L, route_n=d.route_n, iters=d.index.search_iters,
                  leaf_kind=kind)
        print(f"inputs {kind}: n {n}, leaves {L}, queries {nq}, pairs {m}, "
              f"base capacity {kf.shape[0]}, iters {kw['iters']}, delta "
              f"{dk.shape[0]} ({tlk.full_iters(dk.shape[0])} trips)")
        a = (tabs, kf, dk, kw)
        cases[f"K2 {kind}"] = (
            lambda a=a: tlk.dynamic_lookup(qf, *a[0], a[1], a[2], **a[3]),
            lambda a=a: tlk.dynamic_lookup_plain(qf, *a[0], a[1], a[2],
                                                 **a[3]))
        cases[f"K3 {kind}"] = (
            lambda a=a: tlk.dynamic_range(lof, hif, *a[0], a[1], a[2],
                                          **a[3]),
            lambda a=a: tlk.dynamic_range_plain(lof, hif, *a[0], a[1], a[2],
                                                **a[3]))
        if kind == "linear":
            cases["K1 linear"] = (
                lambda a=a: (tlk.lookup(qf, *a[0], a[1], **a[3]),),
                lambda a=a: (tlk.lookup_plain(qf, *a[0], a[1], **a[3]),))
        else:
            rows = tlk.leaf_rows(*tabs[1:])
            cases["leaf_rows mlp"] = (
                lambda t=tabs: (tlk.leaf_rows(*t[1:]),), lambda: (rows,))

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
