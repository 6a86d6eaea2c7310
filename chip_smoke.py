#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one CUDA card and check it.

    python3 chip_smoke.py [--n 200000000] [--n-leaves 262144]
                          [--queries 1048576] [--seed 0]

Phases (any failure exits non-zero; nothing is caught):

1. Build the lookup kernels from ``src/repro_torch/kernels/csrc`` with nvcc
   and print what ``-Xptxas -v`` reports (registers, shared memory, spills).
2. The main path, through the entry points a user calls, with every kernel
   launch counter set to 0 just before and read just after: a static
   ``build_rmi`` + ``rmi.lookup`` (kernel K1), then ``Index.build`` ->
   ``find`` (K2) -> ``find_range`` (K3) -> ``insert`` (2M keys, one batch in
   a narrow key range so that a Lemma 4.1 rebuild runs) -> ``delete`` (1M)
   -> ``find`` -> ``find_range``.  Every answer is held against a
   ``torch.searchsorted`` truth over the live keys on the card.
3. Each kernel against its plain PyTorch version at the main path's shapes,
   bit for bit after ``torch.cuda.synchronize()``.
4. Times with CUDA events after warm-up: each kernel, its plain version and
   the one PyTorch call computing the same function (``torch.searchsorted``:
   one call for K1, two for K2, four for K3), beside the least time the card
   could take (``bound_ms``) for the bytes this run's queries need.

Keys are lognormal float32 values drawn on the card from ``--seed`` and
sorted there (duplicates allowed: the index is a multiset).  The last lines
printed are the kernels' JSON line, the card's ``name, power.limit`` from
nvidia-smi, and the result line.  Exits non-zero without printing a result
when no CUDA device is present or when run outside a checkout of the repo.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, NVIDIA data sheet
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/lookup.cu"
REPLACES = {
    "lookup": "src/repro/kernels/lookup.py:274",
    "dynamic_lookup": "src/repro/kernels/lookup.py:393",
    "dynamic_range": "src/repro/kernels/lookup.py:516",
}


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n", type=int, default=200_000_000)
    p.add_argument("--n-leaves", type=int, default=1 << 18)
    p.add_argument("--queries", type=int, default=1 << 20)
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def _sync_time(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _event_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events."""
    import torch
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


def _check_equal(what, got, want):
    import torch
    if not torch.equal(got, want):
        bad = (got != want).nonzero()[:5].flatten().tolist()
        raise AssertionError(f"{what}: mismatch at {bad} "
                             f"({int((got != want).sum())} entries)")


def _probe_bytes(keys, q, lo, hi, iters: int, right: bool) -> tuple:
    """Distinct key positions a window search of these queries reads, and
    its active iterations (the data-dependent work of this run)."""
    import torch
    n = keys.shape[0]
    l, h = lo.clone(), hi.clone()
    seen, steps = [], 0
    for _ in range(iters):
        active = h > l
        mid = torch.div(l + h, 2, rounding_mode="floor")
        seen.append(mid[active & (mid < n)])
        steps += int(active.sum())
        kv = keys[mid.clamp(0, n - 1).long()]
        kv = torch.where(mid < n, kv, torch.full_like(kv, float("inf")))
        below = kv <= q if right else kv < q
        l = torch.where(active & below, mid + 1, l)
        h = torch.where(active & ~below, mid, h)
    return int(torch.unique(torch.cat(seen)).numel()) * 4, steps


def _bound(parts) -> tuple:
    """(bound_ms, bound_by) for the bytes and operations of ``parts``."""
    nbytes = sum(p[0] for p in parts)
    ops = sum(p[1] for p in parts)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _search_work(tlk, tables, keys, q, *, n_leaves, route_n, iters, right):
    """Bytes and operations one endpoint's base search needs: the query in,
    the position out, the distinct leaf rows and key positions it reads."""
    import torch
    root, mat, vec = tables
    lo, hi = tlk.route_window(q, root, mat, vec, n_keys=keys.shape[0],
                              n_leaves=n_leaves, route_n=route_n)
    kb, steps = _probe_bytes(keys, q, lo, hi, iters, right)
    b = tlk.route_bucket(q, root, n_leaves=n_leaves, route_n=route_n)
    rows = int(torch.unique(b).numel()) * 16      # slope, intercept, bounds
    nq = q.shape[0]
    return nq * 8 + rows + kb + 8, nq * 12 + 2 * steps


def _delta_work(tlk, dk, q, right):
    import torch
    lo = torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    hi = torch.full(q.shape, dk.shape[0], dtype=torch.int32, device=q.device)
    kb, steps = _probe_bytes(dk, q, lo, hi, tlk.full_iters(dk.shape[0]), right)
    return q.shape[0] * 4 + kb, 2 * steps


def main(argv=None) -> int:
    args = _args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.api import Index
    from repro_torch.core import rmi as trmi
    from repro_torch.kernels import build
    from repro_torch.kernels import lookup as tlk
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = torch.cuda.get_device_name(0)
    print(f"device: {gpu} x{torch.cuda.device_count()}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}")

    # ---- phase 1: build the kernels ---------------------------------------
    reports, t_nvcc = _sync_time(build.build_all)
    print(f"phase 1: nvcc build {t_nvcc:.3f} s "
          f"({'built now' if reports else 'already built in build/'})")
    for name, report in reports.items():
        for line in report.splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill", "smem")):
                print(f"  ptxas[{name}] {line.strip()}")

    # ---- inputs -----------------------------------------------------------
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed)
    n, L, nq = args.n, args.n_leaves, args.queries
    keys32 = torch.sort(torch.empty(n, dtype=torch.float32, device=dev)
                        .log_normal_(0.0, 1.0, generator=g)).values
    keys = keys32.to(torch.float64)

    def draw(m):
        return torch.empty(m, dtype=torch.float32, device=dev) \
            .log_normal_(0.0, 1.0, generator=g).to(torch.float64)

    def pick(live, m):
        i = torch.randint(0, live.shape[0], (m,), device=dev, generator=g)
        return live[i]

    edges = torch.tensor([0.0, -1.0, 1e-30, float(keys32[0]), 1e30, -1e30,
                          3e38, float(keys32[-1]) * 2.0], dtype=torch.float64,
                         device=dev)

    def find_queries(live):
        half = nq // 2
        return torch.cat([pick(live, half), draw(nq - half - edges.numel()),
                          edges])

    def range_pairs(live):
        m = nq // 4
        lo = torch.cat([pick(live, m // 2), draw(m - m // 2)])
        width = torch.empty(m, dtype=torch.float64, device=dev) \
            .exponential_(1.0 / 0.002, generator=g)
        hi = (lo + width).to(torch.float32).to(torch.float64)
        hi[: m // 64] = lo[: m // 64] - 0.5            # degenerate lo > hi
        return lo, hi

    seam_log = []

    def check_find(ix, q, tag):
        live = ix.backend.live_keys_tensor().to(torch.float32)
        s0 = ops.SEAM["misses"]
        (found, rank), dt = _sync_time(lambda: ix.find(q))
        seam_log.append((f"find/{tag}", ops.SEAM["misses"] - s0, q.numel()))
        qf = q.to(torch.float32)
        want = torch.searchsorted(live, qf).to(torch.int32)
        _check_equal(f"find/{tag} rank", rank, want)
        _check_equal(f"find/{tag} found", found,
                     torch.searchsorted(live, qf, right=True) > want)
        return dt

    def check_range(ix, lo, hi, tag):
        live = ix.backend.live_keys_tensor().to(torch.float32)
        s0 = ops.SEAM["misses"]
        (rl, rh), dt = _sync_time(lambda: ix.find_range(lo, hi))
        seam_log.append((f"find_range/{tag}", ops.SEAM["misses"] - s0,
                         2 * lo.numel()))
        want_lo = torch.searchsorted(live, lo.to(torch.float32)) \
            .to(torch.int32)
        want_hi = torch.maximum(torch.searchsorted(
            live, hi.to(torch.float32), right=True).to(torch.int32), want_lo)
        _check_equal(f"find_range/{tag} rank_lo", rl, want_lo)
        _check_equal(f"find_range/{tag} rank_hi", rh, want_hi)
        return dt

    # ---- phase 2: the main path, counted ------------------------------------
    tlk.reset_launches()
    ops.reset_seam()
    steps = {}
    sidx, steps["static build_rmi"] = _sync_time(
        lambda: trmi.build_rmi(keys, n_leaves=L, device=dev))
    q_static = find_queries(keys)
    s0 = ops.SEAM["misses"]
    pos, steps["static lookup"] = _sync_time(lambda: trmi.lookup(sidx,
                                                                 q_static))
    seam_log.append(("lookup/static", ops.SEAM["misses"] - s0, nq))
    _check_equal("static lookup", pos,
                 torch.searchsorted(keys32, q_static.to(torch.float32))
                 .to(torch.int32))

    ix, steps["Index.build"] = _sync_time(
        lambda: Index.build(keys, n_leaves=L))
    steps["find (built)"] = check_find(ix, find_queries(keys), "built")
    lo, hi = range_pairs(keys)
    steps["find_range (built)"] = check_range(ix, lo, hi, "built")
    n_ins = 2_000_000
    narrow = 100_000
    _, steps["insert (spread)"] = _sync_time(
        lambda: ix.insert(draw(n_ins - narrow)))
    rebuilds_spread = ix.backend.rebuilds
    narrow_keys = (1.0 + 1e-4 * torch.rand(narrow, dtype=torch.float64,
                                           device=dev, generator=g)) \
        .to(torch.float32).to(torch.float64)
    _, steps["insert (narrow)"] = _sync_time(lambda: ix.insert(narrow_keys))
    if ix.backend.rebuilds <= rebuilds_spread:
        raise AssertionError("the narrow insert batch ran no rebuild")
    live = ix.backend.live_keys_tensor()
    dels = pick(live, 1_000_000)
    _, steps["delete"] = _sync_time(lambda: ix.delete(dels))
    live = ix.backend.live_keys_tensor()
    steps["find (churned)"] = check_find(ix, find_queries(live), "churned")
    lo, hi = range_pairs(live)
    steps["find_range (churned)"] = check_range(ix, lo, hi, "churned")
    launches = dict(tlk.LAUNCHES)
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{launches}")
    d = ix.backend
    expected = n + n_ins - d.deleted
    if d.live_count != expected or live.numel() != expected:
        raise AssertionError(f"live count {d.live_count} / {live.numel()} "
                             f"!= {expected}")
    print(f"phase 2: main path ok; launches {launches}; rebuilds "
          f"{d.rebuilds}; deleted {d.deleted}; live {d.live_count}; "
          f"search_iters static {sidx.search_iters} dynamic "
          f"{d.index.search_iters}")
    for k, v in steps.items():
        print(f"  {k}: {v:.6f} s")
    for tag, miss, m in seam_log:
        print(f"  seam_misses {tag}: {miss} of {m} "
              f"({miss / m:.6%})")

    # ---- phase 3: kernels against their plain versions ----------------------
    s_tabs = sidx.packed_tables()
    d_tabs = d.index.packed_tables()
    qf = find_queries(live).to(torch.float32)
    lo, hi = range_pairs(live)
    lof, hif = lo.to(torch.float32), hi.to(torch.float32)
    dk = tlk.pad_delta(d.delta_keys_f32)
    skw = dict(n_leaves=L, iters=sidx.search_iters)
    dkw = dict(n_leaves=L, route_n=d.route_n, iters=d.index.search_iters)
    calls = {
        "lookup": (
            lambda: (tlk.lookup(qf, *s_tabs, sidx.keys_f32, **skw),),
            lambda: (tlk.lookup_plain(qf, *s_tabs, sidx.keys_f32, **skw),),
            lambda: torch.searchsorted(sidx.keys_f32, qf)),
        "dynamic_lookup": (
            lambda: tlk.dynamic_lookup(qf, *d_tabs, d.index.keys_f32, dk,
                                       **dkw),
            lambda: tlk.dynamic_lookup_plain(qf, *d_tabs, d.index.keys_f32,
                                             dk, **dkw),
            lambda: (torch.searchsorted(d.index.keys_f32, qf),
                     torch.searchsorted(dk, qf))),
        "dynamic_range": (
            lambda: tlk.dynamic_range(lof, hif, *d_tabs, d.index.keys_f32,
                                      dk, **dkw),
            lambda: tlk.dynamic_range_plain(lof, hif, *d_tabs,
                                            d.index.keys_f32, dk, **dkw),
            lambda: (torch.searchsorted(d.index.keys_f32, lof),
                     torch.searchsorted(d.index.keys_f32, hif, right=True),
                     torch.searchsorted(dk, lof),
                     torch.searchsorted(dk, hif, right=True))),
    }
    errs = {}
    for name, (kern, plain, _) in calls.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        errs[name] = 0
        for i, (a, b) in enumerate(zip(got, want, strict=True)):
            errs[name] = max(errs[name], int((a - b).abs().max()))
            _check_equal(f"{name} kernel vs plain [{i}]", a, b)
    print(f"phase 3: kernels equal their plain versions bit for bit "
          f"(tolerance 0): {errs}")

    # ---- phase 4: times ----------------------------------------------------
    work = {
        "lookup": [_search_work(tlk, s_tabs, sidx.keys_f32, qf, n_leaves=L,
                                route_n=sidx.n, iters=sidx.search_iters,
                                right=False)],
        "dynamic_lookup": [
            _search_work(tlk, d_tabs, d.index.keys_f32, qf, n_leaves=L,
                         route_n=d.route_n, iters=d.index.search_iters,
                         right=False),
            _delta_work(tlk, dk, qf, right=False)],
        "dynamic_range": [
            _search_work(tlk, d_tabs, d.index.keys_f32, lof, n_leaves=L,
                         route_n=d.route_n, iters=d.index.search_iters,
                         right=False),
            _search_work(tlk, d_tabs, d.index.keys_f32, hif, n_leaves=L,
                         route_n=d.route_n, iters=d.index.search_iters,
                         right=True),
            _delta_work(tlk, dk, lof, right=False),
            _delta_work(tlk, dk, hif, right=True)],
    }
    rows = []
    for name, (kern, plain, lib) in calls.items():
        bound_ms, bound_by = _bound(work[name])
        # turns: kernel, plain, library, kernel (the two kernel runs
        # bracket the others on the same card)
        k1 = _event_ms(kern, 50)
        p_ms = _event_ms(plain, 10)
        l_ms = _event_ms(lib, 50)
        k2 = _event_ms(kern, 50)
        rows.append(dict(
            name=name, route="cuda", source=KERNEL_SOURCE,
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=errs[name], ms=(k1 + k2) / 2, plain_ms=p_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=l_ms))
        print(f"phase 4: {name}: kernel {k1:.6f} / {k2:.6f} ms, plain "
              f"{p_ms:.6f} ms, library {l_ms:.6f} ms, bound {bound_ms:.6f} "
              f"ms ({bound_by}); launches on the main path {launches[name]}")
    print(f"  shapes: n={n} leaves={L} queries={nq} range pairs={lo.numel()} "
          f"base capacity={d.index.keys.shape[0]} delta capacity="
          f"{dk.shape[0]} iters static={sidx.search_iters} dynamic="
          f"{d.index.search_iters} delta iters={tlk.full_iters(dk.shape[0])}")
    print(f"  peak memory allocated: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": gpu,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
