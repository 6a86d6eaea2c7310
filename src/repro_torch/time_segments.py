"""Time the RMRT build on one CUDA card with and without the sub-bin spread
of ``core.rmi``'s unsorted segment reductions.

    PYTHONPATH=src python -m repro_torch.time_segments [--n 200000000]

The build is ``build_rmrt(keys, leaf_cap=1e6, fanout=64, kind="linear",
pool=...)`` over lognormal f32 keys drawn on the card from ``--seed``, with
a linear pool over the eps 0.9 synthetic corpus: the RMRT of
``chip_smoke.py``.  It runs four times, spread / one bin per segment /
one bin per segment / spread (``_SPREAD_BINS = 1`` gives one bin), and
prints each run's wall time and the time of the segment statistics
(``leaf_stats``, ``segment_linear_fit``, ``segment_residual_bounds``),
each call bracketed by ``torch.cuda.synchronize()``.
"""
from __future__ import annotations

import argparse
import time

import torch

from .core import reuse, rmi, rmrt, synth

_STAGES = ("leaf_stats", "segment_linear_fit", "segment_residual_bounds")


def _timed_build(keys, pool):
    secs = dict.fromkeys(_STAGES, 0.0)
    saved = {name: getattr(rmrt, name) for name in _STAGES}

    def wrap(name, fn):
        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            secs[name] += time.perf_counter() - t0
            return out
        return timed

    for name, fn in saved.items():
        setattr(rmrt, name, wrap(name, fn))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree = rmrt.build_rmrt(keys, leaf_cap=1_000_000, fanout=64,
                               kind="linear", pool=pool)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for name, fn in saved.items():
            setattr(rmrt, name, fn)
    return tree, total, secs


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n", type=int, default=200_000_000)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed)
    keys = torch.sort(torch.empty(args.n, dtype=torch.float32, device=dev)
                      .log_normal_(0.0, 1.0, generator=g)).values \
        .to(torch.float64)
    pool = reuse.build_pool(synth.generate_pool(0.9), kind="linear",
                            device=dev)
    spread = rmi._SPREAD_BINS
    trees = {}
    for label, bins in (("spread", spread), ("one bin", 1), ("one bin", 1),
                        ("spread", spread)):
        rmi._SPREAD_BINS = bins
        try:
            tree, total, secs = _timed_build(keys, pool)
        finally:
            rmi._SPREAD_BINS = spread
        stats = sum(secs.values())
        parts = ", ".join(f"{k} {v:.6f} s" for k, v in secs.items())
        print(f"{label}: build_rmrt {total:.6f} s, segment statistics "
              f"{stats:.6f} s ({parts}); depth {tree.depth}, nodes "
              f"{tree.num_nodes}, reuse_fraction {tree.reuse_fraction:.6f}")
        trees.setdefault(label, tree)
    a, b = trees["spread"], trees["one bin"]
    same = (a.depth == b.depth and torch.equal(a.is_leaf, b.is_leaf)
            and torch.equal(a.child_base, b.child_base)
            and torch.equal(a.reused_mask, b.reused_mask))
    print(f"same tree structure with and without the spread: {same}")


if __name__ == "__main__":
    main()
