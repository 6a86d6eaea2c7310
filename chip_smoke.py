#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one CUDA card and check
them.

    python3 chip_smoke.py [--n 200000000] [--n-leaves 262144]
                          [--queries 1048576] [--seed 0] [--eps 0.9]
                          [--pool-steps 400] [--leaf-steps 300]
                          [--rmrt-leaf-cap 1000000] [--fanout 64]

Phases (any failure exits non-zero; nothing is caught):

1. Build the kernels from ``src/repro_torch/kernels/csrc`` with nvcc, one
   process per source, and print what ``-Xptxas -v`` reports (registers,
   shared memory, spills) per entry point.
2. Path A, the single-host dynamic index with linear models, through the
   entry points a user calls, with every launch counter set to 0 just
   before and read just after: a static ``build_rmi`` + ``rmi.lookup``
   (K1), then ``Index.build`` -> ``find`` (K2) -> ``find_range`` (K3) ->
   ``insert`` (2M keys at 200M, one batch of them in a narrow key range so
   that a Lemma 4.1 rebuild runs) -> ``delete`` (1M) -> ``find`` ->
   ``find_range``.
3. K1-K3 (linear) against their plain versions, bit for bit after
   ``torch.cuda.synchronize()``, and timed.
4. Path B, the paper's lazy path, counted the same way: ``generate_pool``
   (1,221 datasets at eps 0.9) -> ``build_pool`` (MLP and linear, on the
   card) -> RMI-NN-MR (``build_rmi(kind="mlp", pool=...)``, pool selection
   through K7) + ``rmi.lookup`` (K1, MLP leaves) -> ``Index.build(keys,
   pool=..., kind="mlp")`` and path A's churn (K2/K3 with MLP leaves; the
   narrow insert's rebuilds re-select from the pool through K7) -> RMRT
   (``build_rmrt(kind="linear", pool=...)``) + ``rmrt.lookup`` (K4).
5. K1-K3 (MLP leaves), K4 and K7 against their plain versions, bit for
   bit, and timed; K7 is checked on all of the pooled build's leaf
   histograms and timed on ``SELECT_CHUNK`` of them, the shape of one of
   its launches in ``select_from_pool_batch``.

Every answer of both paths is held against a ``torch.searchsorted`` truth
over the live keys on the card.  Times are CUDA-event means after warm-up,
each kernel timed in two turns around its plain version and the one
PyTorch call computing the same function (``torch.searchsorted``; none for
K7), beside the least time the card could take (``bound_ms``) for the
bytes and f32 operations this run's inputs need.  Keys are lognormal
float32 values drawn on the card from ``--seed`` and sorted there.  The
last lines printed are the kernels' JSON line (K1-K3 a row per
instantiation: path A launches the linear-leaf one, path B the MLP-leaf
one), the card's ``name, power.limit`` from nvidia-smi, and the result
line.  Exits non-zero without printing a result when no CUDA device is
present or when run outside a checkout of the repo.
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
# Rows of the kernels line: K1-K3 once per instantiation the main paths
# launch (linear leaves on path A, MLP leaves on path B), K4, K7.
_LOOKUP_CU = "src/repro_torch/kernels/csrc/lookup.cu"
SOURCES = {
    "lookup": _LOOKUP_CU,
    "dynamic_lookup": _LOOKUP_CU,
    "dynamic_range": _LOOKUP_CU,
    "lookup_mlp": _LOOKUP_CU,
    "dynamic_lookup_mlp": _LOOKUP_CU,
    "dynamic_range_mlp": _LOOKUP_CU,
    "rmrt_lookup": _LOOKUP_CU,
    "ksdist": "src/repro_torch/kernels/csrc/ksdist.cu",
}
REPLACES = {
    "lookup": "src/repro/kernels/lookup.py:274",
    "dynamic_lookup": "src/repro/kernels/lookup.py:393",
    "dynamic_range": "src/repro/kernels/lookup.py:516",
    "lookup_mlp": "src/repro/kernels/lookup.py:274",
    "dynamic_lookup_mlp": "src/repro/kernels/lookup.py:393",
    "dynamic_range_mlp": "src/repro/kernels/lookup.py:516",
    "rmrt_lookup": "src/repro/kernels/lookup.py:681",
    "ksdist": "src/repro/kernels/ksdist.py:36",
}


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n", type=int, default=200_000_000)
    p.add_argument("--n-leaves", type=int, default=1 << 18)
    p.add_argument("--queries", type=int, default=1 << 20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eps", type=float, default=0.9)
    p.add_argument("--pool-steps", type=int, default=400)
    p.add_argument("--leaf-steps", type=int, default=300)
    p.add_argument("--rmrt-leaf-cap", type=int, default=1_000_000)
    p.add_argument("--fanout", type=int, default=64)
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
    """(bound_ms, bound_by) for the (bytes, operations) of ``parts``."""
    nbytes = sum(p[0] for p in parts)
    ops = sum(p[1] for p in parts)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _search_work(tlk, tables, keys, q, *, n_leaves, route_n, iters, right,
                 root_kind="linear", leaf_kind="linear"):
    """Bytes and operations one endpoint's base search needs: the query in,
    the position out, the distinct leaf rows and key positions it reads."""
    import torch
    root, mat, vec = tables
    lo, hi = tlk.route_window(q, root, mat, vec, n_keys=keys.shape[0],
                              n_leaves=n_leaves, route_n=route_n,
                              root_kind=root_kind, leaf_kind=leaf_kind)
    kb, steps = _probe_bytes(keys, q, lo, hi, iters, right)
    b = tlk.route_bucket(q, root, n_leaves=n_leaves, route_n=route_n,
                         root_kind=root_kind)
    # bytes read per leaf: a, b, err_lo, err_hi; or w1, b1, w2 (H each),
    # b2, err_lo, err_hi
    row = 4 * (4 if leaf_kind == "linear" else 3 * tlk.H + 3)
    rows = int(torch.unique(b).numel()) * row
    nq = q.shape[0]
    flops = 12 if leaf_kind == "linear" else 40
    return nq * 8 + rows + kb + 8, nq * flops + 2 * steps


def _delta_work(tlk, dk, q, right):
    import torch
    lo = torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    hi = torch.full(q.shape, dk.shape[0], dtype=torch.int32, device=q.device)
    kb, steps = _probe_bytes(dk, q, lo, hi, tlk.full_iters(dk.shape[0]), right)
    return q.shape[0] * 4 + kb, 2 * steps


def _rmrt_work(tlk, tree, q):
    """Bytes and operations of K4 on ``q``: the query in, the position out,
    the distinct node rows the descent reads (8 f32 words a linear node),
    the distinct key positions the window search reads."""
    import torch
    mat, vec = tree.packed_tables()
    npad = mat.shape[1]
    fv = vec.reshape(-1)
    node = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    seen = [node]
    for _ in range(tree.depth):
        pred = tlk.lane_predict(q, mat, vec, node, tree.kind)
        ys = fv[node + 3 * npad]
        child = tlk.trunc_clip((pred - ys) * float(tree.fanout)
                               / (fv[node + 4 * npad] - ys), 0,
                               tree.fanout - 1)
        nxt = fv[node + 5 * npad].long() + child
        node = torch.where(fv[node + 6 * npad] > 0.5, node, nxt)
        seen.append(node)
    nodes = int(torch.unique(torch.cat(seen)).numel())
    lo, hi = tlk.rmrt_route_window(q, mat, vec, n_keys=tree.n,
                                   fanout=tree.fanout, depth=tree.depth,
                                   kind=tree.kind)
    kb, steps = _probe_bytes(tree.keys_f32, q, lo, hi, tree.search_iters,
                             False)
    nq = q.shape[0]
    return nq * 8 + nodes * 32 + kb, nq * 8 * (tree.depth + 1) + 2 * steps


def _time_row(name, kern, plain, lib, parts, launches, err, reps=50,
              plain_reps=10):
    """Kernel, plain, library, kernel: the two kernel turns bracket the
    others on the same card.  Returns the JSON row."""
    bound_ms, bound_by = _bound(parts)
    k1 = _event_ms(kern, reps)
    p_ms = _event_ms(plain, plain_reps, warmup=1)
    l_ms = _event_ms(lib, reps) if lib is not None else None
    k2 = _event_ms(kern, reps)
    lib_txt = f"{l_ms:.6f} ms" if l_ms is not None else "none"
    print(f"  {name}: kernel {k1:.6f} / {k2:.6f} ms, plain {p_ms:.6f} ms, "
          f"library {lib_txt}, bound {bound_ms:.6f} ms ({bound_by}); "
          f"launches on the main paths {launches}")
    return dict(name=name, route="cuda", source=SOURCES[name],
                replaces=REPLACES[name], launches=launches, max_abs_err=err,
                ms=(k1 + k2) / 2, plain_ms=p_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=l_ms)


class _Stages:
    """Synchronised wall time of named module functions while a build runs
    (a breakdown of the build: each call is bracketed by
    ``torch.cuda.synchronize()``, so the stages add a few syncs)."""

    def __init__(self, module, names):
        self.module, self.names, self.secs, self.saved = module, names, {}, {}

    def __enter__(self):
        for name in self.names:
            fn = getattr(self.module, name)
            self.saved[name] = fn

            def timed(*a, _fn=fn, _name=name, **kw):
                out, dt = _sync_time(lambda: _fn(*a, **kw))
                self.secs[_name] = self.secs.get(_name, 0.0) + dt
                return out
            setattr(self.module, name, timed)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.module, name, fn)

    def report(self, what, total):
        parts = ", ".join(f"{k} {v:.6f} s" for k, v in self.secs.items())
        rest = total - sum(self.secs.values())
        print(f"  {what} breakdown: {parts}, rest {rest:.6f} s "
              f"(total {total:.6f} s)")


def _compare(name, kern, plain):
    """Kernel and plain outputs equal bit for bit; returns max |diff|."""
    import torch
    got, want = kern(), plain()
    torch.cuda.synchronize()
    err = 0
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        err = max(err, float((a - b).abs().max()) if a.numel() else 0.0)
        _check_equal(f"{name} kernel vs plain [{i}]", a, b)
    return int(err) if float(err).is_integer() else err


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
    from repro_torch.core import reuse as treuse
    from repro_torch.core import rmi as trmi
    from repro_torch.core import rmrt as trmrt
    from repro_torch.core import synth as tsynth
    from repro_torch.kernels import build
    from repro_torch.kernels import ksdist as tks
    from repro_torch.kernels import lookup as tlk
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = torch.cuda.get_device_name(0)
    print(f"device: {gpu} x{torch.cuda.device_count()}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    t_start = time.perf_counter()

    # ---- phase 1: build the kernels ---------------------------------------
    reports, t_nvcc = _sync_time(build.build_all)
    print(f"phase 1: nvcc build {t_nvcc:.3f} s "
          f"({'built now' if reports else 'already built in build/'})")
    for name, report in reports.items():
        for line in report.splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill", "smem")):
                print(f"  ptxas[{name}] {line.strip()}")

    def counters():
        return {**tlk.LAUNCHES, **tks.LAUNCHES}

    def reset_counters():
        tlk.reset_launches()
        tks.reset_launches()

    # ---- inputs -----------------------------------------------------------
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed)
    L, nq = args.n_leaves, args.queries

    def lognormal_keys(m):
        return torch.sort(torch.empty(m, dtype=torch.float32, device=dev)
                          .log_normal_(0.0, 1.0, generator=g)).values

    def draw(m):
        return torch.empty(m, dtype=torch.float32, device=dev) \
            .log_normal_(0.0, 1.0, generator=g).to(torch.float64)

    def pick(live, m):
        i = torch.randint(0, live.shape[0], (m,), device=dev, generator=g)
        return live[i]

    def edges_of(k32):
        return torch.tensor([0.0, -1.0, 1e-30, float(k32[0]), 1e30, -1e30,
                             3e38, float(k32[-1]) * 2.0],
                            dtype=torch.float64, device=dev)

    def find_queries(live, edges):
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

    def seam(tag, m, fn):
        s0 = ops.SEAM["misses"]
        out, dt = _sync_time(fn)
        seam_log.append((tag, ops.SEAM["misses"] - s0, m))
        return out, dt

    def check_find(ix, q, tag):
        live = ix.backend.live_keys_tensor().to(torch.float32)
        (found, rank), dt = seam(f"find/{tag}", q.numel(), lambda: ix.find(q))
        qf = q.to(torch.float32)
        want = torch.searchsorted(live, qf).to(torch.int32)
        _check_equal(f"find/{tag} rank", rank, want)
        _check_equal(f"find/{tag} found", found,
                     torch.searchsorted(live, qf, right=True) > want)
        return dt

    def check_range(ix, lo, hi, tag):
        live = ix.backend.live_keys_tensor().to(torch.float32)
        (rl, rh), dt = seam(f"find_range/{tag}", 2 * lo.numel(),
                            lambda: ix.find_range(lo, hi))
        want_lo = torch.searchsorted(live, lo.to(torch.float32)) \
            .to(torch.int32)
        want_hi = torch.maximum(torch.searchsorted(
            live, hi.to(torch.float32), right=True).to(torch.int32), want_lo)
        _check_equal(f"find_range/{tag} rank_lo", rl, want_lo)
        _check_equal(f"find_range/{tag} rank_hi", rh, want_hi)
        return dt

    def churn(ix, keys, steps, tag, edges):
        """Path A's churn on a dynamic index: find, find_range, a spread
        and a narrow insert (the narrow one must rebuild), a delete, find
        and find_range again, every answer against the truth."""
        n = keys.shape[0]
        steps[f"find (built{tag})"] = check_find(
            ix, find_queries(keys, edges), "built" + tag)
        lo, hi = range_pairs(keys)
        steps[f"find_range (built{tag})"] = check_range(ix, lo, hi,
                                                        "built" + tag)
        n_ins = min(2_000_000, n // 100)      # 2M / 100k / 1M at 200M keys
        narrow = n_ins // 20
        _, steps[f"insert (spread{tag})"] = _sync_time(
            lambda: ix.insert(draw(n_ins - narrow)))
        rebuilds0 = ix.backend.rebuilds
        k7_0 = tks.LAUNCHES["ksdist"]
        narrow_keys = (1.0 + 1e-4 * torch.rand(
            narrow, dtype=torch.float64, device=dev, generator=g)) \
            .to(torch.float32).to(torch.float64)
        _, steps[f"insert (narrow{tag})"] = _sync_time(
            lambda: ix.insert(narrow_keys))
        rebuilt = ix.backend.rebuilds - rebuilds0
        if rebuilt <= 0:
            raise AssertionError("the narrow insert batch ran no rebuild")
        live = ix.backend.live_keys_tensor()
        dels = pick(live, n_ins // 2)
        _, steps[f"delete{tag}"] = _sync_time(lambda: ix.delete(dels))
        live = ix.backend.live_keys_tensor()
        steps[f"find (churned{tag})"] = check_find(
            ix, find_queries(live, edges), "churned" + tag)
        lo, hi = range_pairs(live)
        steps[f"find_range (churned{tag})"] = check_range(ix, lo, hi,
                                                          "churned" + tag)
        d = ix.backend
        expected = n + n_ins - d.deleted
        if d.live_count != expected or live.numel() != expected:
            raise AssertionError(f"live count {d.live_count} / "
                                 f"{live.numel()} != {expected}")
        return live, rebuilt, tks.LAUNCHES["ksdist"] - k7_0

    def print_steps(steps):
        for k, v in steps.items():
            print(f"  {k}: {v:.6f} s")

    def print_seam():
        for tag, miss, m in seam_log:
            print(f"  seam_misses {tag}: {miss} of {m} ({miss / m:.6%})")
        seam_log.clear()

    rows = {}

    # ---- phase 2: path A (linear models), counted ---------------------------
    n = args.n
    keys32 = lognormal_keys(n)
    keys = keys32.to(torch.float64)
    edges = edges_of(keys32)
    reset_counters()
    ops.reset_seam()
    steps = {}
    sidx, steps["static build_rmi"] = _sync_time(
        lambda: trmi.build_rmi(keys, n_leaves=L, device=dev))
    q_static = find_queries(keys, edges)
    pos, steps["static lookup"] = seam(
        "lookup/static", nq, lambda: trmi.lookup(sidx, q_static))
    _check_equal("static lookup", pos,
                 torch.searchsorted(keys32, q_static.to(torch.float32))
                 .to(torch.int32))
    ix, steps["Index.build"] = _sync_time(
        lambda: Index.build(keys, n_leaves=L))
    live, rebuilt_a, _ = churn(ix, keys, steps, "", edges)
    launches_a = counters()
    for k in ("lookup", "dynamic_lookup", "dynamic_range"):
        if launches_a[k] <= 0:
            raise AssertionError(f"kernel {k} never launched on path A: "
                                 f"{launches_a}")
    d = ix.backend
    print(f"phase 2: path A (linear) ok; n={n}; launches {launches_a}; "
          f"rebuilds {d.rebuilds} (narrow batch {rebuilt_a}); deleted "
          f"{d.deleted}; live {d.live_count}; search_iters static "
          f"{sidx.search_iters} dynamic {d.index.search_iters}")
    print_steps(steps)
    print_seam()

    # ---- phase 3: K1-K3 (linear) against their plain versions, timed -------
    s_tabs = sidx.packed_tables()
    d_tabs = d.index.packed_tables()
    qf = find_queries(live, edges).to(torch.float32)
    lo, hi = range_pairs(live)
    lof, hif = lo.to(torch.float32), hi.to(torch.float32)
    dk = tlk.pad_delta(d.delta_keys_f32)
    skw = dict(n_leaves=L, iters=sidx.search_iters)
    dkw = dict(n_leaves=L, route_n=d.route_n, iters=d.index.search_iters)
    skf, dkf = sidx.keys_f32, d.index.keys_f32
    calls_a = {
        "lookup": (
            lambda: (tlk.lookup(qf, *s_tabs, skf, **skw),),
            lambda: (tlk.lookup_plain(qf, *s_tabs, skf, **skw),),
            lambda: torch.searchsorted(skf, qf),
            lambda: [_search_work(tlk, s_tabs, skf, qf, n_leaves=L,
                                  route_n=sidx.n, iters=sidx.search_iters,
                                  right=False)]),
        "dynamic_lookup": (
            lambda: tlk.dynamic_lookup(qf, *d_tabs, dkf, dk, **dkw),
            lambda: tlk.dynamic_lookup_plain(qf, *d_tabs, dkf, dk, **dkw),
            lambda: (torch.searchsorted(dkf, qf),
                     torch.searchsorted(dk, qf)),
            lambda: [_search_work(tlk, d_tabs, dkf, qf, n_leaves=L,
                                  route_n=d.route_n,
                                  iters=d.index.search_iters, right=False),
                     _delta_work(tlk, dk, qf, right=False)]),
        "dynamic_range": (
            lambda: tlk.dynamic_range(lof, hif, *d_tabs, dkf, dk, **dkw),
            lambda: tlk.dynamic_range_plain(lof, hif, *d_tabs, dkf, dk,
                                            **dkw),
            lambda: (torch.searchsorted(dkf, lof),
                     torch.searchsorted(dkf, hif, right=True),
                     torch.searchsorted(dk, lof),
                     torch.searchsorted(dk, hif, right=True)),
            lambda: [_search_work(tlk, d_tabs, dkf, lof, n_leaves=L,
                                  route_n=d.route_n,
                                  iters=d.index.search_iters, right=False),
                     _search_work(tlk, d_tabs, dkf, hif, n_leaves=L,
                                  route_n=d.route_n,
                                  iters=d.index.search_iters, right=True),
                     _delta_work(tlk, dk, lof, right=False),
                     _delta_work(tlk, dk, hif, right=True)]),
    }
    errs = {n: _compare(n, k, p) for n, (k, p, _, _) in calls_a.items()}
    print(f"phase 3: K1-K3 (linear) equal their plain versions bit for bit "
          f"(tolerance 0): {errs}")
    for nm, (k, p, lib, work) in calls_a.items():
        rows[nm] = _time_row(nm, k, p, lib, work(), launches_a[nm], errs[nm])
    print(f"  shapes: n={n} leaves={L} queries={nq} range pairs="
          f"{lo.numel()} base capacity={d.index.keys.shape[0]} delta "
          f"capacity={dk.shape[0]} iters static={sidx.search_iters} "
          f"dynamic={d.index.search_iters} delta iters="
          f"{tlk.full_iters(dk.shape[0])}")
    print(f"  peak memory allocated (path A): "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    del sidx, ix, d, s_tabs, d_tabs, dk, skf, dkf, live, calls_a, q_static
    del pos, keys, keys32, qf, lo, hi, lof, hif
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # ---- phase 4: path B (the lazy path), counted --------------------------
    keys32 = lognormal_keys(n)
    keys = keys32.to(torch.float64)
    edges = edges_of(keys32)
    reset_counters()
    ops.reset_seam()
    steps = {}
    corpus, steps["generate_pool"] = _sync_time(
        lambda: tsynth.generate_pool(args.eps))
    if abs(args.eps - 0.9) < 1e-12 and corpus.size != 1221:
        raise AssertionError(f"{corpus.size} synthetic datasets, not 1221")
    mlp_pool, steps["build_pool (mlp)"] = _sync_time(
        lambda: treuse.build_pool(corpus, kind="mlp",
                                  train_steps=args.pool_steps, device=dev))
    lin_pool, steps["build_pool (linear)"] = _sync_time(
        lambda: treuse.build_pool(corpus, kind="linear", device=dev))
    for name, pool in (("mlp", mlp_pool), ("linear", lin_pool)):
        w = pool.err_hi - pool.err_lo
        print(f"  pool {name}: {pool.size} models, m={pool.m}, error width "
              f"{float(w.min()):.6f} .. {float(w.max()):.6f}")

    with _Stages(trmi, ("leaf_histograms", "select_from_pool_batch",
                        "_batched_leaf_mlp", "_pool_merge_measure")) as st:
        smlp, steps["RMI-NN-MR build_rmi"] = _sync_time(
            lambda: trmi.build_rmi(keys, n_leaves=L, kind="mlp",
                                   pool=mlp_pool, train_steps=args.leaf_steps,
                                   device=dev))
    st.report("RMI-NN-MR build_rmi", steps["RMI-NN-MR build_rmi"])
    reuse_rmi = smlp.reuse_fraction
    fresh = int((~smlp.reused_mask).sum())
    q_static = find_queries(keys, edges)
    pos, steps["RMI-NN-MR lookup"] = seam(
        "lookup/RMI-NN-MR", nq,
        lambda: trmi.lookup(smlp, q_static, path="kernel"))
    _check_equal("RMI-NN-MR lookup", pos,
                 torch.searchsorted(keys32, q_static.to(torch.float32))
                 .to(torch.int32))
    sm_tabs, sm_iters = smlp.packed_tables(), smlp.search_iters
    print(f"  RMI-NN-MR: reuse_fraction {reuse_rmi:.6f}, fresh leaves "
          f"{fresh} of {L}, search_iters {sm_iters}")
    del smlp, pos
    torch.cuda.empty_cache()

    ix, steps["Index.build (pool, mlp)"] = _sync_time(
        lambda: Index.build(keys, pool=mlp_pool, kind="mlp", n_leaves=L,
                            train_steps=args.leaf_steps))
    reuse_dyn = ix.backend.index.reuse_fraction
    live, rebuilt_b, k7_rebuild = churn(ix, keys, steps, ", pool", edges)
    if k7_rebuild <= 0:
        raise AssertionError("the pooled rebuild did not re-select from the "
                             "pool")
    d = ix.backend
    print(f"  pooled Index: build reuse_fraction {reuse_dyn:.6f}; rebuilds "
          f"{d.rebuilds} (narrow batch {rebuilt_b}, {k7_rebuild} K7 "
          f"launches re-selecting from the pool); reuse_fraction after "
          f"churn {d.index.reuse_fraction:.6f}; search_iters "
          f"{d.index.search_iters}")

    with _Stages(trmrt, ("leaf_stats", "leaf_histograms",
                         "select_from_pool_batch", "segment_linear_fit",
                         "segment_residual_bounds")) as st:
        tree, steps["RMRT build_rmrt"] = _sync_time(
            lambda: trmrt.build_rmrt(keys, leaf_cap=args.rmrt_leaf_cap,
                                     fanout=args.fanout, kind="linear",
                                     pool=lin_pool, device=dev))
    st.report("RMRT build_rmrt", steps["RMRT build_rmrt"])
    q_rmrt = find_queries(keys, edges)
    pos, steps["RMRT lookup"] = seam(
        "lookup/RMRT", nq, lambda: trmrt.lookup(tree, q_rmrt, path="kernel"))
    _check_equal("RMRT lookup", pos,
                 torch.searchsorted(keys32, q_rmrt.to(torch.float32))
                 .to(torch.int32))
    print(f"  RMRT: depth {tree.depth}, num_nodes {tree.num_nodes}, leaves "
          f"{int(tree.is_leaf.sum())}, reuse_fraction "
          f"{tree.reuse_fraction:.6f}, search_iters {tree.search_iters}")
    launches_b = counters()
    if min(launches_b.values()) <= 0:
        raise AssertionError(f"a kernel of path B never launched: "
                             f"{launches_b}")
    print(f"phase 4: path B (lazy) ok; n={n}; launches {launches_b}")
    print_steps(steps)
    print_seam()
    print(f"  peak memory allocated (path B): "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    # ---- phase 5: K1-K3 (MLP), K4, K7 against plain versions, timed -------
    d_tabs = d.index.packed_tables()
    qf = find_queries(live, edges).to(torch.float32)
    lo, hi = range_pairs(live)
    lof, hif = lo.to(torch.float32), hi.to(torch.float32)
    dk = tlk.pad_delta(d.delta_keys_f32)
    mk = dict(leaf_kind="mlp")
    skw = dict(n_leaves=L, iters=sm_iters, **mk)
    dkw = dict(n_leaves=L, route_n=d.route_n, iters=d.index.search_iters,
               **mk)
    dkf = d.index.keys_f32
    qs = q_static.to(torch.float32)
    t_mat, t_vec = tree.packed_tables()
    tkw = dict(fanout=tree.fanout, depth=tree.depth, kind=tree.kind,
               iters=tree.search_iters)
    tkf = tree.keys_f32
    qr = q_rmrt.to(torch.float32)
    sel_a, sel_ps = mlp_pool.tables()
    # K7's real inputs: the RMI-NN-MR build's leaf histograms, checked at
    # full L and timed at one launch of the main path (SELECT_CHUNK rows)
    buckets = trmi.root_buckets("linear", trmi.models.linear_fit(
        keys, torch.arange(n, dtype=torch.float64, device=dev)), keys, L, n)
    st = trmi.leaf_stats_sorted(keys, buckets, L)
    hists = trmi.leaf_histograms(keys, buckets, L, mlp_pool.m, st[1], st[2])
    del buckets, st
    hc = hists[:treuse.SELECT_CHUNK]
    calls_b = {
        "lookup": (
            lambda: (tlk.lookup(qs, *sm_tabs, keys32, **skw),),
            lambda: (tlk.lookup_plain(qs, *sm_tabs, keys32, **skw),),
            lambda: torch.searchsorted(keys32, qs),
            lambda: [_search_work(tlk, sm_tabs, keys32, qs, n_leaves=L,
                                  route_n=n, iters=sm_iters, right=False,
                                  **mk)]),
        "dynamic_lookup": (
            lambda: tlk.dynamic_lookup(qf, *d_tabs, dkf, dk, **dkw),
            lambda: tlk.dynamic_lookup_plain(qf, *d_tabs, dkf, dk, **dkw),
            lambda: (torch.searchsorted(dkf, qf),
                     torch.searchsorted(dk, qf)),
            lambda: [_search_work(tlk, d_tabs, dkf, qf, n_leaves=L,
                                  route_n=d.route_n,
                                  iters=d.index.search_iters, right=False,
                                  **mk),
                     _delta_work(tlk, dk, qf, right=False)]),
        "dynamic_range": (
            lambda: tlk.dynamic_range(lof, hif, *d_tabs, dkf, dk, **dkw),
            lambda: tlk.dynamic_range_plain(lof, hif, *d_tabs, dkf, dk,
                                            **dkw),
            lambda: (torch.searchsorted(dkf, lof),
                     torch.searchsorted(dkf, hif, right=True),
                     torch.searchsorted(dk, lof),
                     torch.searchsorted(dk, hif, right=True)),
            lambda: [_search_work(tlk, d_tabs, dkf, lof, n_leaves=L,
                                  route_n=d.route_n,
                                  iters=d.index.search_iters, right=False,
                                  **mk),
                     _search_work(tlk, d_tabs, dkf, hif, n_leaves=L,
                                  route_n=d.route_n,
                                  iters=d.index.search_iters, right=True,
                                  **mk),
                     _delta_work(tlk, dk, lof, right=False),
                     _delta_work(tlk, dk, hif, right=True)]),
        "rmrt_lookup": (
            lambda: (tlk.rmrt_lookup(qr, t_mat, t_vec, tkf, **tkw),),
            lambda: (tlk.rmrt_lookup_plain(qr, t_mat, t_vec, tkf, **tkw),),
            lambda: torch.searchsorted(tkf, qr),
            lambda: [_rmrt_work(tlk, tree, qr)]),
        "ksdist": (
            lambda: (tks.ksdist(hc, sel_a, sel_ps),),
            lambda: (tks.ksdist_plain(hc, sel_a, sel_ps),),
            None,
            lambda: [(hc.numel() * 8 + 2 * sel_a.numel() * 4
                      + hc.shape[0] * sel_a.shape[0] * 4,
                      4 * hc.numel() * sel_a.shape[0]
                      + hc.shape[0] * sel_a.shape[0] + hc.numel())]),
    }
    errs = {nm: _compare(nm, k, p) for nm, (k, p, _, _) in calls_b.items()}
    errs["ksdist"] = max(errs["ksdist"], _compare(
        "ksdist (full L)", lambda: (tks.ksdist(hists, sel_a, sel_ps),),
        lambda: (tks.ksdist_plain(hists, sel_a, sel_ps),)))
    print(f"phase 5: K1-K3 (MLP leaves), K4 and K7 equal their plain "
          f"versions bit for bit (tolerance 0; K7 at full L={L} and timed "
          f"at L={hc.shape[0]}, P={sel_a.shape[0]}, m={sel_a.shape[1]}): "
          f"{errs}")
    for nm, (k, p, lib, work) in calls_b.items():
        row = nm + "_mlp" if nm in rows else nm    # K1-K3: MLP leaves
        rows[row] = _time_row(row, k, p, lib, work(), launches_b[nm],
                              errs[nm])
    print(f"  shapes: n={n} leaves={L} queries={nq} range pairs={lo.numel()} "
          f"base capacity={d.index.keys.shape[0]} delta capacity="
          f"{dk.shape[0]} iters static={sm_iters} dynamic="
          f"{d.index.search_iters} rmrt={tree.search_iters} rmrt depth="
          f"{tree.depth} rmrt nodes={tree.num_nodes}")
    print(f"  peak memory allocated (path B + checks): "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; wall "
          f"{time.perf_counter() - t_start:.1f} s")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"kernels": [rows[k] for k in SOURCES]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": gpu,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
