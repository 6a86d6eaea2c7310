"""Time the K8 and K1 wrappers call by call on one CUDA card, the host's
share included, for one or more source trees side by side in one process.

Each case runs ``--reps`` calls back to back between two CUDA events after
``--warmup`` calls; a call that the host holds up (a small launch) shows the
host's time, a large one the kernel's.  The host's own time a call (the
loop's wall time before the closing synchronize) is printed beside it.

    python3 time_wrappers.py [--src src] [--src OTHER/src] [--turns 4]
        [--reps 200]

Every ``--src`` tree's ``repro_torch`` is imported under a name of its own
(``tree0``, ``tree1``, ...) and builds its kernels into that tree's
``build/``; each case then runs the trees in turns, A B then B A, so that
the process's drift falls on both.  One JSON line a case gives each tree's
turns and their mean.  Inputs are drawn from ``--seed``, the same for every
tree:

* K8 decode: q (4, 1, 32, 128) bf16 over k/v (4, 2,080, 8, 128) at
  q_offset 2,048 (qwen3-4b's one-card decode after a 2,048-token prompt);
* K8 ``return_partial``: q (1, 1, 2, 128) over an 8,192-key chunk, q_offset
  16,391 (path M's chunk in ``chip_smoke.py``);
* K8 ``flash_merge`` of 4 positions' partials, m, l (1, 2, 4, 1), acc
  (1, 2, 4, 1, 128) f32 (path M's);
* K8 prefill: q (4, 2,048, 32, 128) over 2,080 keys (path D's; the
  kernel's own time, a control);
* K1: a static RMI over 2^22 lognormal keys (2^12 leaves), 4,096 queries;
* stacked K1: the index service's lookup (``make_lookup_fn``, 2^20
  ``linspace`` keys on 16 shards, 2^16 queries; the exchange included).
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path


def _load(src: str, alias: str):
    """The package ``repro_torch`` of the tree ``src``, imported as
    ``alias`` (its modules import each other relatively)."""
    init = Path(src).resolve() / "repro_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        alias, init, submodule_search_locations=[str(init.parent)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return mod


def _cases(torch, pkg: str, seed: int) -> dict:
    import numpy as np
    tdist = importlib.import_module(f"{pkg}.core.distributed")
    trmi = importlib.import_module(f"{pkg}.core.rmi")
    tflash = importlib.import_module(f"{pkg}.kernels.flash")

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    bf = torch.bfloat16

    def rand(*shape, dtype=bf):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    qd, kd, vd = rand(4, 1, 32, 128), rand(4, 2080, 8, 128), \
        rand(4, 2080, 8, 128)
    qp, kp, vp = rand(1, 1, 2, 128), rand(1, 8192, 1, 128), \
        rand(1, 8192, 1, 128)
    m = rand(1, 2, 4, 1, dtype=torch.float32)
    l_ = rand(1, 2, 4, 1, dtype=torch.float32).abs() + 1.0
    acc = rand(1, 2, 4, 1, 128, dtype=torch.float32)
    qf = rand(4, 2048, 32, 128)
    keys = torch.sort(torch.empty(1 << 22, device=dev).log_normal_(
        0.0, 1.0, generator=g).to(torch.float64)).values
    sidx = trmi.build_rmi(keys, n_leaves=1 << 12, device=dev)
    ql = keys[torch.randint(0, keys.shape[0], (4096,), device=dev,
                            generator=g)]
    mesh = tdist.ShardMesh(16, axis="data", devices=(dev,) * 16)
    skeys = np.linspace(0.0, 1.0, 1 << 20).astype(np.float32) \
        .astype(np.float64)
    shd = tdist.build_sharded(skeys, mesh, axis="data", n_leaves=256)
    fn = tdist.make_lookup_fn(shd, path="kernel")
    qs = torch.as_tensor(np.random.default_rng(seed).random(1 << 16)
                         .astype(np.float32).astype(np.float64), device=dev)
    return {
        "k8_decode": lambda: tflash.flash_attention(qd, kd, vd,
                                                    q_offset=2048),
        "k8_partial": lambda: tflash.flash_attention(
            qp, kp, vp, q_offset=16391, return_partial=True),
        "k8_merge": lambda: tflash.flash_merge(m, l_, acc),
        "k8_prefill": lambda: tflash.flash_attention(qf, kd, vd,
                                                     q_offset=0),
        "k1_lookup": lambda: trmi.lookup(sidx, ql),
        "k1_stacked_service": lambda: fn(qs),
    }


def _time(torch, fn, reps: int, warmup: int) -> dict:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    host = time.perf_counter() - t0
    b.synchronize()
    return {"ms": a.elapsed_time(b) / reps, "host_us": host / reps * 1e6}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--src", action="append")
    p.add_argument("--turns", type=int, default=4)
    p.add_argument("--reps", type=int, default=200)
    p.add_argument("--warmup", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_wrappers: no CUDA device", file=sys.stderr)
        return 2
    srcs = args.src or [str(Path(__file__).parent / "src")]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip())
    cases = []
    for i, s in enumerate(srcs):
        pkg = _load(s, f"tree{i}")
        importlib.import_module(f"{pkg.__name__}.kernels.build").build_all(
            ("flash", "lookup"))
        cases.append(_cases(torch, pkg.__name__, args.seed))
    for name in cases[0]:
        reps = max(args.reps // 10, 5) if name == "k8_prefill" else args.reps
        turns: list = [[] for _ in srcs]
        for t in range(args.turns):
            order = range(len(srcs)) if t % 2 == 0 else \
                range(len(srcs) - 1, -1, -1)
            for i in order:
                turns[i].append(_time(torch, cases[i][name], reps,
                                      args.warmup))
        print(json.dumps({"case": name, "trees": [
            {"src": s, "turns": tt,
             "mean": {f: sum(x[f] for x in tt) / len(tt)
                      for f in ("ms", "host_us")}}
            for s, tt in zip(srcs, turns, strict=True)]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
