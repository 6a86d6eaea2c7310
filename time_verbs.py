"""Time the port's serving verbs on one CUDA card, warm, rep by rep.

Builds, from ``--seed``, ``--n`` sorted lognormal(0, 1) f32 keys, a static
RMI, a dynamic index and an index of ``--shards`` shards stacked on the card,
gives the two dynamic ones path A's churn (a spread insert of 1% of the keys,
a delete of half as many), then times each verb ``--reps`` times with CUDA
events over one batch of ``--queries`` queries (half live keys, half fresh
draws; ranges of exponential width, ``--queries / 4`` of them).  Prints the
card, then one JSON line of per-rep milliseconds.  ``--src`` names the
source tree to import, so that two trees can be timed in turn on one card:

    python3 time_verbs.py [--src src] [--n 200000000] [--reps 20]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--src", default=str(Path(__file__).parent / "src"))
    p.add_argument("--n", type=int, default=200_000_000)
    p.add_argument("--n-leaves", type=int, default=1 << 18)
    p.add_argument("--queries", type=int, default=1 << 20)
    p.add_argument("--shards", type=int, default=8)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_verbs: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.api import Index
    from repro_torch.core import distributed as tdist
    from repro_torch.core import rmi as trmi

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed)
    f32, f64 = torch.float32, torch.float64

    def draw(m):
        return torch.empty(m, dtype=f32, device=dev).log_normal_(
            0.0, 1.0, generator=g).to(f64)

    def pick(live, m):
        return live[torch.randint(0, live.shape[0], (m,), device=dev,
                                  generator=g)]

    keys = torch.sort(draw(args.n)).values
    n_ins = args.n // 100
    sidx = trmi.build_rmi(keys, n_leaves=args.n_leaves, device=dev)
    dyn = Index.build(keys, n_leaves=args.n_leaves)
    shd = Index.build(keys, mesh=tdist.ShardMesh(args.shards),
                      n_leaves=max(args.n_leaves // args.shards, 64))
    ins = draw(n_ins)
    for ix in (dyn, shd):
        ix.insert(ins)
    dels = pick(dyn.backend.live_keys_tensor(), n_ins // 2)
    for ix in (dyn, shd):
        ix.delete(dels)
    live = dyn.backend.live_keys_tensor()
    half = args.queries // 2
    q = torch.cat([pick(live, half), draw(args.queries - half)])
    m = args.queries // 4
    lo = torch.cat([pick(live, m // 2), draw(m - m // 2)])
    hi = (lo + torch.empty(m, dtype=f64, device=dev).exponential_(
        500.0, generator=g)).to(f32).to(f64)
    verbs = {
        "static lookup": lambda: trmi.lookup(sidx, q),
        "find": lambda: dyn.find(q),
        "find_range": lambda: dyn.find_range(lo, hi),
        f"sharded find ({args.shards} shards)": lambda: shd.find(q),
        f"sharded find_range ({args.shards} shards)":
            lambda: shd.find_range(lo, hi)}
    out = {}
    for name, fn in verbs.items():
        for _ in range(3):
            fn()
        ms = []
        for _ in range(args.reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
        out[name] = ms
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps({"src": args.src, "n": args.n, "queries": args.queries,
                      "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
