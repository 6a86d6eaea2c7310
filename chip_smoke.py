#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one CUDA card and check
them.

    python3 chip_smoke.py [--n 200000000] [--n-leaves 262144]
                          [--queries 1048576] [--seed 0] [--eps 0.9]
                          [--pool-steps 400] [--leaf-steps 300]
                          [--rmrt-leaf-cap 1000000] [--fanout 64]
                          [--shards 8]

Phases (any failure exits non-zero; nothing is caught):

1. Build the kernels from ``src/repro_torch/kernels/csrc`` with nvcc, one
   process per source, and print what ``-Xptxas -v`` reports (registers,
   shared memory, spills) per entry point; fail on any spill in the
   lookup library (K1-K4), K5's or K7's.
2. Path A, the single-host dynamic index with linear models, through the
   entry points a user calls, with every launch counter set to 0 just
   before and read just after: a static ``build_rmi`` + ``rmi.lookup``
   (K1), then ``Index.build`` -> ``find`` (K2) -> ``find_range`` (K3) ->
   ``insert`` (2M keys at 200M, one batch of them in a narrow key range so
   that a Lemma 4.1 rebuild runs) -> ``delete`` (1M) -> ``find`` ->
   ``find_range``.
3. K1-K3 (linear) against their plain versions, bit for bit after
   ``torch.cuda.synchronize()``, and timed, K1 and K2 with the rows and
   fence the index caches (as the main path calls them); K2 and K3 also on
   planted edges beside the path's queries (``_k23_edges``): queries routed
   to leaves given an empty leaf's sentinel full-array window, the search
   depth cut by 8, delta tiers of 128, 1,152, 4,095, 4,224 and 2^21
   entries with duplicates across the keys of the delta probe's first 12
   levels, queries equal to those keys, +-0, +-inf and NaN, and both tiers
   as views that start inside a 32-byte sector; K1 on its own
   (``_k1_k4_edges``): sentinel leaves, the depth cut by 8 and at full
   depth (whole-array windows through the fence), the keys as a view that
   starts inside a 32-byte sector, +-0, +-inf, NaN and the first and last
   keys.  Then the warm single-index verbs, each a launch and its
   epilogue: static ``lookup``, ``find`` and ``find_range``.
4. Path B, the paper's lazy path, counted the same way: ``generate_pool``
   (1,221 datasets at eps 0.9) -> ``build_pool`` (MLP and linear, on the
   card) -> RMI-NN-MR (``build_rmi(kind="mlp", pool=...)``, pool selection
   through K7) + ``rmi.lookup`` (K1, MLP leaves) -> ``Index.build(keys,
   pool=..., kind="mlp")`` and path A's churn (K2/K3 with MLP leaves; the
   narrow insert's rebuilds re-select from the pool through K7) -> RMRT
   (``build_rmrt(kind="linear", pool=...)``) + ``rmrt.lookup`` (K4).
5. K1-K3 (MLP leaves), K4 and K7 against their plain versions, bit for
   bit, and timed (K1, K2 and K4 with the cached rows and fence; K2 and K3
   also on phase 3's planted edges, K1 and K4 on theirs, K4 also on an
   RMRT with MLP nodes built over every 100th key); K7 is
   checked on all of the pooled build's (f64) leaf
   histograms, on the same rows in f32 and with NaN in a target row and
   two pool rows (NaN in the same places), and timed on ``SELECT_CHUNK``
   of them, the shape of one call in ``select_from_pool_batch``: the
   wrapper call (its table kernel and its distance kernel, a row each in
   the kernels line), and each launch alone through the library on
   prepared buffers (``distance_ms``, ``tables_ms``; ``distance_f32_ms``
   with a NaN in every 128-row target tile, so that every block takes the
   f32 path instead of the integer one).
6. Path C, drift-adaptive serving, counted the same way, with the
   reference drift benchmark's settings (``benchmarks/bench_updates.py``
   ``bench_drift``): a linear pool from ``generate_pool(0.65)`` (m_sim 64);
   ``Index.build(keys, pool=..., eps=0.65, drift_bins=64, drift_hi=0.02,
   drift_lo=0.01, swap_on_drift=True)`` (linear root and leaves) takes the reference
   benchmark's three-phase ingest (stationary lognormal(0, 1), shifted
   lognormal(1.8, 0.9), zipf-hot over 64 base-rank slots), 8 batches of
   n / 100 keys a phase, with the idle-window
   maintenance after every batch (``Index.maybe_swap()``, then
   ``flush_delta`` past a quarter of the base); then the same ingest into a
   refit-only index (no pool, no monitor), after the first is freed.  Per
   phase and mode: insert times, scores and latch, swaps, rebuilds inline
   and in maintenance, the swap pass's time, K7 launches, peak memory; at
   each phase's end every find and range against the truth, the cached
   packed tables against a fresh packing of the current leaves, and K2 and
   K3 against their plain versions on those tables and queries, bit for
   bit; after the swap mode, K7 and its table kernel against their plain
   versions on every swap pass's histograms, bit for bit, and K7 timed at
   the pool's P = 306 as in phase 5 (``path_c_*`` keys of its row).  The shifted phase must latch and commit
   swaps, and no commit may change the search depth or the packed tables'
   shapes.
7. K6 and K5 through the public kernel API on path C's keys:
   ``ops.histogram(keys, 64, keys[0], keys[-1])`` over the keys randomly
   permuted and over one drift batch, ``ops.segment_linfit(keys,
   positions, leaf buckets, --n-leaves)``, counted; then K6 against its
   plain version bit for bit and against an exact count, K5's raw
   sums against its plain version within one f32 ulp of each sum's
   magnitude (the sum of the terms' absolute values), counts exact, on the
   leaf buckets and on three other layouts of the same keys (all in one
   bucket, buckets permuted, a run across every 4,096-key block edge of
   the kernel), each timed, and slopes against
   the f64 ``segment_linear_fit_sorted``: ``segment_linfit``'s within 5e-3
   plus the error its first pass's f32 means allow, and those of the same
   two passes with pass 1 in f64 (pass 2 through K5) within 5e-3; both
   timed.  K6's exact count comes from the sorted keys, binned in f64 with
   a rounding to f32 after each step and counted by searching the sorted
   bin ids.
8. Path D, LM serving, counted: ``launch.serve.serve("qwen3-4b",
   reduced=False, requests=4, prompt_len=2048, new_tokens=32)``, the
   one-card form (``configs.single_card``: 36 layers, d_model 2560, 32
   query and 8 KV heads, dh 128, 4.41e9 random bf16 parameters from
   ``--seed``) at full width and depth: prefill into a 4 x 2,080-token KV
   cache, 32 greedy decode steps, the learned page table over the paged
   KV bookkeeping.  K8 must launch 36 times on the tensor-core prefill
   tile and 36 x 32 times on the split-KV decode tile (with as many
   combine passes), never on the CUDA-core tile, and K1 at least once (the
   page table).  On the
   attention inputs of the first and last layer in prefill and in the last
   decode step, K8 is held against its plain version and a dense f64
   softmax, within one bf16 ulp of the magnitude (the attention of |v|),
   the decode tile also against its split-KV plain version
   (``flash_decode_split_plain``) at the same number of runs, and the
   CUDA-core tile against its plain version on the same inputs in f32,
   with each difference printed in ulps of the magnitude beside SDPA's
   (which is not held to it) and beside the reading against one ulp of
   the plain version's own value; on layer 0, faults planted through
   K8's arguments (a 64-key tile skipped, the causal mask one key late)
   must fail that check, and one more (a decode row's last key dropped)
   is reported.  K1 is held against its plain
   version on the page table's keys, bit for bit.  K8 is timed at both
   shapes against ``scaled_dot_product_attention(enable_gqa=True)``
   (``is_causal`` for prefill, a boolean mask for decode).  The same
   serve() call runs again under ``torch.profiler`` (trace in
   ``build/path_d_trace.json``), prefill and each decode step under a
   user annotation: wall, device busy time, idle share and device time by
   kind (K8, GEMMs, the rest) of each.  Then the serving run is repeated
   with the plain attention put in place of K8 by this script, and the
   prefill logits must agree within ``LM_LOGIT_TOL`` and the first greedy
   tokens wherever the margin allows.  Prints prefill seconds, decode
   tokens/s, peak memory and K8's share of each.
9. Path E, counted, on fresh keys: the paper's baselines (B+tree at
   ``BTREE_FANOUT`` over every key on the card; PGM at ``PGM_EPS`` and
   RadixSpline at ``RS_EPS``/``RS_RADIX_BITS`` built on the host over
   ``PGM_RS_SAMPLE`` keys at evenly spaced ranks) beside ``rmi.lookup``
   (K1), each against ``torch.searchsorted``, with build seconds, lookup
   ms (not counted), shape and index bytes; then ``Index.build`` and path
   A's churn, a blocking ``snapshot`` and an async one into a temporary
   store under ``build/`` (the free disk space printed first, removed at
   the end), ``Index.restore`` (answers, cached tables, rows, fence and
   depth equal to the live index's; K2/K3 against their plain versions on
   the restored tables), a flipped byte in step 2 (``restore`` serves
   step 1's recorded answers; ``step=2`` and ``on_corrupt="raise"``
   raise), a pooled drift index at path C's settings over 2M keys round
   tripped (scores, histograms, answers); then an ``IndexedDataset`` of
   ``DATASET_SHARDS`` shards over disjoint key ranges with a linear pool
   (K7 in every build): ``locate`` of ``--queries`` keys and
   ``locate_range`` of a quarter as many pairs, against a per-shard truth,
   before and after ``append_to_shard`` and ``delete_samples``.
10. Path F, counted, on fresh keys: the sharded index, its ``--shards``
   shards stacked on the card (``--n-leaves / --shards`` leaves a shard).
   ``build_sharded`` + ``make_lookup_fn`` (the shard-stacked K1);
   ``Index.build(keys, mesh=ShardMesh(S))`` with ``find`` (stacked K2),
   ``find_range`` (stacked K3), path A's churn, skewed batches of n /
   ``SKEW_CUT`` keys into shard 0's range until it migrates, a run of
   duplicates at a seam (its rows rewritten in place), planted queries at
   and beside every split and +-inf / NaN; every call of K1-K3 must launch
   its kernel exactly once; warm find and range times and the restacks'
   times; an index with empty shards; each stacked kernel against its
   plain version and S single-index launches, bit for bit, and timed, on
   the inputs the path gives it (the batch routed and grouped, non-live
   queries replaced by their shard's member key; ``find_range``'s two
   endpoint arrays as one batch of point pairs);
   sharded snapshots (blocking, async), restore onto S shards and
   reshards onto S / 2 and 2S (``ReshardStats``, ``full_rebuilds`` 0), a
   flipped byte in one shard file under ``"quarantine"`` and
   ``"fallback"``; a find over ``WIDE_SHARDS`` shards (one launch).
11. Path G, counted, on fresh keys: the index service.  Two tenants behind
   one ``serve.frontend.BatchingFrontend`` with a 2 ms latency budget:
   tenant A ``--n`` lognormal(0, 1) keys in ``--shards`` shards of path
   F's leaves a shard, tenant B ``G_B_KEYS`` lognormal(0.5, 0.8) keys in
   as many shards of a sixteenth of those leaves; the tenant pack is T x S
   rows padded to tenant A's classes.  The pack's find and range of a
   batch mixing both tenants, members, misses, pads and queries at and
   beside every split against each tenant's own ``find`` / ``find_range``
   and the truth; the stacked K2 and K3 against their plain versions on
   the pack's T x S descriptors (bit for bit) and timed; one launch a find
   batch and one a range batch at live sizes ``G_BATCH_SIZES`` after
   ``warmup``; singleton keys deleted through the queue; a closed loop of
   full 4,096-key batches (batches and keys a second); open-loop Poisson
   drives at ``G_RATES`` requests a second, ``G_DRIVE_S`` each, of
   single-key finds split 70/30 over the tenants with ``G_RANGE_SHARE``
   range requests of ``G_RANGE_PAIRS`` pairs and ``G_INSERT_SHARE``
   insert requests of ``G_INSERT_KEYS`` keys above the tenant's largest
   (an append-heavy ingest, which leaves every find's and range's truth
   fixed during a drive), every answer against the truth, the first
   ``G_RATES_ALWAYS`` rates always and then until the first rate whose
   p99 passes ``G_P99_LIMIT`` budgets (latency from each
   request's scheduled arrival to its ``done_at``); one saturated second
   traced (``build/path_g_trace.json``: wall, device busy, idle share,
   the host's CUDA calls) and the same second untraced with a sync around
   each stage of a batch; every inserted key found and every deleted one
   not; the memory reckoned and measured.  Then ``DynamicPageTable`` at
   path D's page geometry (4 requests of 131 blocks of 16 tokens, one
   layer), over one index and over 2 shards: one K2 (or stacked K2) launch
   a lookup of 2^16 block keys while the packed keys are f32-exact
   (requests 0-3), held against its plain version on that lookup's keys
   and the table's own stack, none once requests 4-7 are in and request 1
   released (the f64 path), every ``(found, page)`` against the cache's
   table.
12. Path H, counted, on fresh keys: the sharded index across mesh
   positions, ``ShardMesh(--shards, devices=...)`` with one shard a
   position (the reference's layout), every position this card (the
   copies between positions cost nothing here; they are counted as bytes
   a call).  ``build_sharded`` + ``make_lookup_fn`` with capacity factor
   None and 2.0 (the -1s must be ``_budget_mask``'s, every other rank the
   truth); ``Index.build(mesh=)``: ``find`` and ``find_range``, path A's
   churn, a skewed ingest until a boundary run migrates from position 0 to
   position 1, a run at a seam (its position's rows rewritten in place),
   planted queries at and beside every split and +-inf / NaN, an index
   with empty shards; every call of K1-K3 must launch its kernel once a
   position; after each step, at each position, the stacked K2 and K3
   (K1 once) against their plain versions on that position's rows and the
   grouped queries the exchange gives it.  Warm ``find`` / ``find_range``
   at D = --shards and D = --shards / 4 positions and on one stack (D = 1:
   other meshes over the same shards), beside path F's; a snapshot
   restored onto ``H_RESTORE`` and resharded onto ``H_RESHARD`` (shards,
   positions), the answers against the truth after each; two tenants of
   ``H_TENANT_KEYS`` keys (tenant B's size for both: a cut) on
   ``H_TENANT_POSITIONS`` positions behind one ``BatchingFrontend``, a
   closed loop of 4,096-key batches for ``H_CLOSED_S``, one stacked K2
   launch a position a batch, every answer against the truth.

Every answer of paths A and B is held against a ``torch.searchsorted`` truth
over the live keys on the card.  Times are CUDA-event means after warm-up,
each kernel timed in two turns around its plain version and the one
PyTorch call computing the same function (``torch.searchsorted``; an f32
``index_add_`` of the stacked features for K5; SDPA for K8; none for K7,
nor for K6, whose bins ``torch.histc`` closes on the other side), beside
the least time the card could take (``bound_ms``) for the bytes and
operations this run's inputs need, the operations at the f32 rate (at the
bf16 tensor-core rate for K8's prefill tile); K1-K4 rows add
``bound_sector_ms``, the same bound with the bytes counted as the distinct
32-byte sectors the kernel's layout touches (leaf or node rows or
lane-major table rows, the fence's and the keys' probes).  A row's
``launches`` add up every path that launches that instantiation (K1
linear: paths A, D and E; K2 linear: A, C, E and G's page table; K3
linear: A, C and E; stacked K1: F and H; stacked K2: F, G, G's page table
and H; stacked K3: F, G and H; K7 and its table kernel: B, C and E).  K1's, K2's, K3's, K4's, K5's and K7's rows are
printed beside their previous designs' times from ``PERF.md`` (not
re-run; not in the
JSON line).
Keys are lognormal float32 values drawn on the card from ``--seed`` and
sorted there.  Every answer of path C is held against the truth too.  The
last lines printed are the kernels' JSON line (K1-K3 a row per
instantiation: path A launches the linear-leaf one, path B the MLP-leaf
one, path F the shard-stacked one, with ``single_launches_ms`` for S
single-index launches of its work; K8 a row per tile: ``flash`` at the prefill shape, its ``bound_ms``
on the bf16 tensor cores it computes on and ``bound_f32_ms`` on the f32
rate, ``flash_decode`` at the decode shape with its ``n_split`` and
``combine_launches``), the card's ``name, power.limit`` from nvidia-smi,
and the result line.  Phase 1 also prints the flash library's ptxas
report and the number of ``HGMMA`` instructions ``cuobjdump -sass`` finds
in it, and fails if there are none.  Exits non-zero without printing a
result when no CUDA device is present or when run outside a checkout of
the repo.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import itertools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, NVIDIA data sheet
DRIFT_EPS = 0.65               # path C's reuse threshold (bench_drift's)
DRIFT_BATCHES = 8              # batches a drift phase (bench_drift's)
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
    "ksdist_tables": "src/repro_torch/kernels/csrc/ksdist.cu",
    "hist": "src/repro_torch/kernels/csrc/hist.cu",
    "linfit": "src/repro_torch/kernels/csrc/linfit.cu",
    "flash": "src/repro_torch/kernels/csrc/flash.cu",
    "flash_decode": "src/repro_torch/kernels/csrc/flash.cu",
    "sharded_lookup": _LOOKUP_CU,
    "sharded_dynamic_lookup": _LOOKUP_CU,
    "sharded_dynamic_range": _LOOKUP_CU,
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
    "ksdist_tables": "src/repro/kernels/ksdist.py:36",
    "hist": "src/repro/kernels/hist.py:44",
    "linfit": "src/repro/kernels/linfit.py:52",
    "flash": "src/repro/kernels/flash.py:73",
    "flash_decode": "src/repro/kernels/flash.py:73",
    "sharded_lookup": "src/repro/kernels/lookup.py:274",
    "sharded_dynamic_lookup": "src/repro/kernels/lookup.py:393",
    "sharded_dynamic_range": "src/repro/kernels/lookup.py:516",
}
BF16_TC_OPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense
# The previous designs of K1-K5 and K7 (PERF.md section 6, NVIDIA H100
# 80GB HBM3, 700 W), printed beside this run's times, not re-run: K5 at 2e8
# keys, K7's wrapper call at 16,384 rows and P = 1,221 (path B) or 306
# (path C)
K5_PREVIOUS_MS = 3.642910
K7_PREVIOUS_MS = {1221: 0.684313, 306: 0.501372}
# K2 and K3 at 2^20 queries / 2^18 pairs over 200M keys, linear and MLP
# leaves (their rows of the kernels line)
K2_PREVIOUS_MS = {"dynamic_lookup": 0.193015, "dynamic_lookup_mlp": 0.303149}
K3_PREVIOUS_MS = {"dynamic_range": 0.101724, "dynamic_range_mlp": 0.154133}
# K1 (linear and MLP leaves) and K4 on the same inputs
K1_PREVIOUS_MS = {"lookup": 0.131648, "lookup_mlp": 0.217389}
K4_PREVIOUS_MS = {"rmrt_lookup": 0.313521}
# The planted K2/K3 edges: delta tiers of these sizes (the first levels of
# the delta probe's implicit tree hold 2^12 - 1 keys), queries equal to the
# keys those levels visit, and the search depth cut by this many trips
EDGE_DELTA_SIZES = (128, 1152, 4095, 4224, 1 << 21)
EDGE_TREE_LEVELS = 12
EDGE_ITERS_CUT = 8
LM_ARCH = "qwen3-4b"           # path D's model, in its one-card form
LM_REQUESTS = 4                # packed page keys below 2^24: K1 serves them
LM_PROMPT_LEN = 2048           # prompt tokens a request
LM_NEW_TOKENS = 32             # greedy tokens a request
# Path D's kernel-vs-plain prefill logits: 4x the 0.058 that f32-level
# attention differences (the plain version's key blocks of 1,024 against
# 128) move the logits of a 36-layer qwen3 cut to d_model 512 on the CPU.
LM_LOGIT_TOL = 0.25
# Path E: the reference benchmark's baseline settings
# (benchmarks/bench_lookup.py), PGM's and RadixSpline's host builds over a
# sample of this many keys, and the indexed dataset's shards
BTREE_FANOUT = 16
PGM_EPS = 64
RS_EPS, RS_RADIX_BITS = 32, 12
PGM_RS_SAMPLE = 1 << 22
DATASET_SHARDS = 8
# Path F: the wide stack's shard count (over --n / WIDE_CUT keys) and the
# skewed ingest's batches (--n / SKEW_CUT keys each, at most SKEW_BATCHES)
WIDE_SHARDS, WIDE_CUT = 64, 16
SKEW_CUT, SKEW_BATCHES = 32, 12
# Path G: tenant B's keys (its leaves a shard are a sixteenth of tenant
# A's), the front-end's latency budget, the live batch sizes checked for
# one launch a batch, the closed loop's seconds, the open-loop drives'
# offered rates (requests/s, each G_DRIVE_S seconds; the first
# G_RATES_ALWAYS rates always run, then the drives stop at the first rate
# whose p99 passes G_P99_LIMIT budgets) and their mix of range
# requests (of G_RANGE_PAIRS pairs) and insert requests (of G_INSERT_KEYS
# keys) among single-key finds
G_B_KEYS = 1 << 24
G_BUDGET_S = 2e-3
G_BATCH_SIZES = (1, 3, 127, 129, 1000, 4096)
G_CLOSED_S = 2.0
G_RATES = (250, 1000, 5000, 20000, 50000)
G_DRIVE_S = 2.0
G_P99_LIMIT = 10
G_RATES_ALWAYS = 2
# Path H: the recovery's meshes (shards, positions), the tenants' keys,
# leaves and positions (tenant B's size), and the closed loop's seconds
H_RESTORE, H_RESHARD = (4, 2), (8, 4)
H_TENANT_KEYS, H_TENANT_LEAVES, H_TENANT_POSITIONS = 1 << 24, 2048, 2
H_CLOSED_S = 1.0
G_RANGE_SHARE, G_RANGE_PAIRS = 0.05, 16
G_INSERT_SHARE, G_INSERT_KEYS = 0.01, 64


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
    p.add_argument("--shards", type=int, default=8)
    return p.parse_args(argv)


def _card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


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


def _walk(keys, q, lo, hi, iters: int, right: bool = False) -> tuple:
    """The static search loop of these queries: (the key positions it
    reads, its live trips, where each query ends)."""
    import torch
    n = keys.shape[0]
    l, h = lo.long(), hi.long()
    seen, steps = [l[:0]], 0
    for _ in range(iters):
        active = h > l
        mid = torch.div(l + h, 2, rounding_mode="floor")
        seen.append(mid[active & (mid < n)])
        steps += int(active.sum())
        kv = keys[mid.clamp(0, n - 1)]
        kv = torch.where(mid < n, kv, torch.full_like(kv, float("inf")))
        below = kv <= q if right else kv < q
        l = torch.where(active & below, mid + 1, l)
        h = torch.where(active & ~below, mid, h)
    return torch.cat(seen), steps, l


def _sectors(keys, pos) -> int:
    """Bytes of the distinct 32-byte sectors holding ``keys[pos]``."""
    import torch
    return int(torch.unique((pos + keys.data_ptr() // 4) >> 3).numel()) * 32


def _probe_bytes(keys, q, lo, hi, iters: int, right: bool) -> tuple:
    """Bytes of the distinct key positions a window search of these queries
    reads, its active iterations (the data-dependent work of this run), and
    the bytes of the distinct 32-byte sectors holding those positions."""
    import torch
    pos, steps, _ = _walk(keys, q, lo, hi, iters, right)
    pos = torch.unique(pos)
    return int(pos.numel()) * 4, steps, _sectors(keys, pos)


def _fenced_sectors(tlk, keys, fence, q, lo, hi, iters: int) -> int:
    """Bytes of the distinct 32-byte sectors the fenced search (K1, K4)
    reads: for a window the static depth converges, the fence's probes and
    those of the 64-key interval of the keys they lead to; for another
    window, the static loop's."""
    import torch
    lo, hi = lo.long(), hi.long()
    w = hi - lo
    if iters >= 31:
        conv = torch.ones_like(w, dtype=torch.bool)
    else:
        conv = (w >= 0) & (w < (1 << iters)) & (iters > 0)
    nf = fence.shape[0]
    jl = (lo + tlk.FENCE - 1) // tlk.FENCE
    jh = torch.maximum(torch.clamp((hi + tlk.FENCE - 1) // tlk.FENCE,
                                   max=nf), jl)
    qc, jl, jh = q[conv], jl[conv], jh[conv]
    fpos, _, j = _walk(fence, qc, jl, jh, 32)
    a = torch.where(j > jl, (j - 1) * tlk.FENCE + 1, lo[conv])
    b = torch.where(j < jh, j * tlk.FENCE, hi[conv])
    kpos, _, _ = _walk(keys, qc, a, b, 32)
    upos, _, _ = _walk(keys, q[~conv], lo[~conv], hi[~conv], iters)
    return (_sectors(fence, torch.unique(fpos))
            + _sectors(keys, torch.unique(torch.cat([kpos, upos]))))


def _row_sectors(ids, row_bytes: int) -> int:
    """Bytes of the distinct 32-byte sectors the 16-byte loads of rows
    ``ids`` of ``row_bytes`` bytes each touch (a fresh allocation: the
    table starts a sector)."""
    import torch
    ids = torch.unique(ids).long()
    secs = [(ids * row_bytes + o) >> 5 for o in range(0, row_bytes, 16)]
    return int(torch.unique(torch.cat(secs)).numel()) * 32


def _bound(parts) -> tuple:
    """(bound_ms, bound_by) for the (bytes, operations) of ``parts``."""
    nbytes = sum(p[0] for p in parts)
    ops = sum(p[1] for p in parts)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _sector_bound(parts) -> float:
    """The bound with each part's bytes counted as whole 32-byte sectors
    (the third entry of a part): the memory system moves sectors, and a
    search reads one scattered sector for each 4-byte key it compares."""
    return _bound([(p[2], p[1]) for p in parts])[0]


def _search_work(tlk, tables, keys, q, *, n_leaves, route_n, iters, right,
                 root_kind="linear", leaf_kind="linear", rows=False,
                 fence=None):
    """Bytes and operations one endpoint's base search needs: the query in,
    the position out, the distinct leaf words and key positions it reads;
    and the sectors the kernel's layout touches: leaf rows (``rows``: K1,
    K2 with MLP leaves) or one sector of each lane-major table row (K2 with
    linear leaves, K3), and the fence's and keys' probes (``fence``: K1)
    or the static loop's."""
    import torch
    root, mat, vec = tables
    lo, hi = tlk.route_window(q, root, mat, vec, n_keys=keys.shape[0],
                              n_leaves=n_leaves, route_n=route_n,
                              root_kind=root_kind, leaf_kind=leaf_kind)
    kb, steps, ks = _probe_bytes(keys, q, lo, hi, iters, right)
    if fence is not None:
        ks = _fenced_sectors(tlk, keys, fence, q, lo, hi, iters)
    b = tlk.route_bucket(q, root, n_leaves=n_leaves, route_n=route_n,
                         root_kind=root_kind)
    # words read per leaf: a, b, err_lo, err_hi; or w1, b1, w2 (H each),
    # b2, err_lo, err_hi
    words = 4 if leaf_kind == "linear" else 3 * tlk.H + 3
    table = int(torch.unique(b).numel()) * words * 4
    if rows:            # one row a leaf: 16 bytes linear, 64 MLP
        table_sectors = _row_sectors(b, 16 if leaf_kind == "linear" else 64)
    else:               # a lane-major row each word: one sector of each
        table_sectors = int(torch.unique(b >> 3).numel()) * words * 32
    nq = q.shape[0]
    flops = 12 if leaf_kind == "linear" else 40
    return (nq * 8 + table + kb + 8, nq * flops + 2 * steps,
            nq * 8 + table_sectors + ks + 32)


def _delta_work(tlk, dk, q, right):
    import torch
    lo = torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    hi = torch.full(q.shape, dk.shape[0], dtype=torch.int32, device=q.device)
    kb, steps, ks = _probe_bytes(dk, q, lo, hi, tlk.full_iters(dk.shape[0]),
                                 right)
    return q.shape[0] * 4 + kb, 2 * steps, q.shape[0] * 4 + ks


def _rmrt_work(tlk, tree, q):
    """Bytes and operations of K4 on ``q``: the query in, the position out,
    the distinct node rows the descent reads (8 f32 words a linear node),
    the distinct key positions the window search reads; and the sectors of
    K4's layout: a node row each node visited (one sector a linear node)
    and the fenced search's probes."""
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
    seen = torch.cat(seen)
    nodes = int(torch.unique(seen).numel())
    lo, hi = tlk.rmrt_route_window(q, mat, vec, n_keys=tree.n,
                                   fanout=tree.fanout, depth=tree.depth,
                                   kind=tree.kind)
    kf = tree.keys_f32
    kb, steps, _ = _probe_bytes(kf, q, lo, hi, tree.search_iters, False)
    ks = _fenced_sectors(tlk, kf, tree.key_fence, q, lo, hi,
                         tree.search_iters)
    nq = q.shape[0]
    row_bytes = 4 * tree.node_rows().shape[1]
    return (nq * 8 + nodes * 32 + kb, nq * 8 * (tree.depth + 1) + 2 * steps,
            nq * 8 + _row_sectors(seen, row_bytes) + ks)


def _time_row(name, kern, plain, lib, parts, launches, err, reps=50,
              plain_reps=10):
    """Kernel, plain, library, kernel: the two kernel turns bracket the
    others on the same card.  Returns the JSON row."""
    bound_ms, bound_by = _bound(parts)
    sector_ms = _sector_bound(parts) if len(parts[0]) > 2 else None
    k1 = _event_ms(kern, reps)
    p_ms = _event_ms(plain, plain_reps, warmup=1)
    l_ms = _event_ms(lib, reps) if lib is not None else None
    k2 = _event_ms(kern, reps)
    lib_txt = f"{l_ms:.6f} ms" if l_ms is not None else "none"
    prev = {**K1_PREVIOUS_MS, **K2_PREVIOUS_MS, **K3_PREVIOUS_MS,
            **K4_PREVIOUS_MS}.get(name)
    print(f"  {name}: kernel {k1:.6f} / {k2:.6f} ms, plain {p_ms:.6f} ms, "
          f"library {lib_txt}, bound {bound_ms:.6f} ms ({bound_by})"
          + (f", bound over whole sectors {sector_ms:.6f} ms"
             if sector_ms is not None else "")
          + (f"; previous design {prev:.6f} ms (PERF.md, not re-run)"
             if prev is not None else "")
          + f"; launches on the main paths {launches}")
    row = dict(name=name, route="cuda", source=SOURCES[name],
               replaces=REPLACES[name], launches=launches, max_abs_err=err,
               ms=(k1 + k2) / 2, plain_ms=p_ms, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=l_ms)
    if sector_ms is not None:
        row["bound_sector_ms"] = sector_ms
    return row


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


def _pass1_bound(ops, trmi, keys, pos, buckets, n_leaves, a64):
    """Per leaf, (whether it holds two distinct keys or more, the relative
    slope error that the f32 rounding of ``ops.segment_linfit``'s first
    pass allows).  Pass 1 sums f32-rounded
    standardised coordinates, so a leaf's means are off by at most one
    f32 ulp (u_x, u_y at the leaf's largest coordinate); pass 2 centres on
    those means, so with n keys the standardised slope a* becomes (S_xy + n
    e_x e_y) / (S_xx + n e_x^2), off by at most n u_x (u_y + |a*| u_x) /
    S_xx.  A leaf whose keys or positions span few ulps (sparse tail
    leaves at 2e8 keys, where an f32 ulp of a standardised position is
    about 7 positions) cannot meet a fixed tolerance."""
    import torch
    xn, _, sd_x = ops.standardize(keys)
    yn, _, sd_y = ops.standardize(pos)
    b = buckets.long()
    cnt = torch.bincount(b, minlength=n_leaves).to(torch.float64)
    zeros = torch.zeros(n_leaves, dtype=torch.float64, device=keys.device)
    mx = zeros.index_add(0, b, xn) / cnt.clamp(min=1.0)
    sxx = zeros.index_add(0, b, (xn - mx[b]) ** 2)
    start, end = trmi._bucket_bounds(buckets, n_leaves)
    lo, hi = start.clamp(max=keys.shape[0] - 1).long(), \
        (end - 1).clamp(min=0).long()

    def ulp(v):
        f = v.abs().to(torch.float32)
        return (torch.nextafter(f, torch.full_like(f, float("inf")))
                - f).to(torch.float64)

    u_x = torch.maximum(ulp(xn[lo]), ulp(xn[hi]))
    u_y = torch.maximum(ulp(yn[lo]), ulp(yn[hi]))
    a_s = (a64 * sd_x / sd_y).abs()
    distinct = keys[lo] < keys[hi]
    return distinct, cnt * u_x * (u_y / a_s + u_x) / sxx


def _slopes_f64_pass1(ops, tlinfit, x, y, buckets, n_buckets):
    """``ops.segment_linfit``'s slopes with its first pass kept in f64
    (per-bucket means of the f64 standardised coordinates from f64 sums)
    and its second pass through K5 as before: isolates what pass 1's f32
    rounding costs."""
    import torch
    f64 = torch.float64
    xn, _, sd_x = ops.standardize(x)
    yn, _, sd_y = ops.standardize(y)
    b = buckets.long()
    cnt = torch.bincount(b, minlength=n_buckets).to(f64).clamp(min=1.0)
    zeros = torch.zeros(n_buckets, dtype=f64, device=x.device)
    mx = zeros.index_add(0, b, xn) / cnt
    my = zeros.index_add(0, b, yn) / cnt
    s2 = tlinfit.linfit_sums((xn - mx[b]).to(torch.float32),
                             (yn - my[b]).to(torch.float32), buckets,
                             n_buckets).to(f64)
    sxy, sxx = s2[:, 3], s2[:, 4]
    a_s = torch.where(sxx > 1e-20, sxy / sxx, torch.zeros_like(sxy))
    return a_s * sd_y / sd_x


def _exact_counts(thist, sorted_keys, m, lo, hi):
    """K6's exact (m,) counts of finite sorted f32 keys inside [lo, hi],
    independent of the kernel and of ``hist_plain``: each step of the bin
    formula in f64, where it is exact (its operands are f32 values whose
    exponents differ by less than 29), rounded once to f32 as the f32
    operation rounds; the non-decreasing bin ids of the sorted keys are
    counted by a search, not by a histogram."""
    import torch
    f32, f64 = torch.float32, torch.float64
    lo32, inv_span, _ = thist.hist_params(m, lo, hi, sorted_keys.shape[0])
    k = sorted_keys.to(f64)
    if not (bool(torch.isfinite(k).all()) and float(k[0]) >= lo32
            and float(k[-1]) <= hi):
        raise AssertionError("the exact count takes finite keys in [lo, hi]")
    x = ((k - lo32).to(f32).to(f64) * inv_span).to(f32).to(f64)
    c = torch.ceil((x * float(m)).to(f32).to(f64))
    bins = (c.to(torch.int64) - 1).clamp(0, m - 1)
    if not bool((bins[1:] >= bins[:-1]).all()):
        raise AssertionError("bin ids of sorted keys are not non-decreasing")
    edges = torch.searchsorted(bins, torch.arange(m + 1, device=k.device))
    return edges[1:] - edges[:-1]


def _equal_nan(what, got, want):
    """Equal where not NaN and NaN in the same places; returns the number
    of NaN entries."""
    import torch
    nan = got.isnan()
    _check_equal(f"{what}: NaN places", nan, want.isnan())
    _check_equal(what, torch.where(nan, 0.0, got), torch.where(nan, 0.0, want))
    return int(nan.sum())


def _k7_parts_ms(build, tks, h, a, ps, reps=50):
    """(distance launch alone on prepared tables, the same on its f32
    path, table launch alone) in ms: each kernel straight through the
    library, uncounted, on buffers allocated once.  The f32 path is timed
    on the tables with a NaN in the first row of every 128-row target
    tile, so that no block takes the integer path."""
    import torch
    lib = build.library("ksdist")
    stream = torch.cuda.current_stream().cuda_stream
    L, m = h.shape
    P = a.shape[0]
    hc = h.contiguous()
    ta, pt = tks.target_tables(hc)
    ta, pt = ta.contiguous(), pt.contiguous()
    ta2, pt2 = torch.empty_like(ta), torch.empty_like(pt)
    out = torch.empty((L, P), dtype=torch.float32, device=h.device)
    is64 = int(hc.dtype == torch.float64)
    dist = lambda: build.check(lib.repro_ksdist(  # noqa: E731
        ta.data_ptr(), pt.data_ptr(), L, a.data_ptr(), ps.data_ptr(), P, m,
        out.data_ptr(), stream), "ksdist")
    tab = lambda: build.check(lib.repro_ksdist_tables(  # noqa: E731
        hc.data_ptr(), is64, L, m, ta2.data_ptr(), pt2.data_ptr(), stream),
        "ksdist_tables")
    tn = ta.clone()
    tn[::128, 0] = float("nan")
    f32 = lambda: build.check(lib.repro_ksdist(  # noqa: E731
        tn.data_ptr(), pt.data_ptr(), L, a.data_ptr(), ps.data_ptr(), P, m,
        out.data_ptr(), stream), "ksdist")
    f_ms = _event_ms(f32, reps)
    _equal_nan("ksdist (library call, f32 path)", out,
               tks.distance_plain(tn, pt, a, ps))
    d_ms, t_ms = _event_ms(dist, reps), _event_ms(tab, reps)
    torch.cuda.synchronize()
    _check_equal("ksdist (library call on prepared tables)", out,
                 tks.distance_plain(ta, pt, a, ps))
    _check_equal("ksdist_tables (library call) A_T", ta2, ta)
    _check_equal("ksdist_tables (library call) P_T", pt2, pt)
    return d_ms, f_ms, t_ms


def _spills(report: str) -> list:
    """The ptxas lines of a build report that spill."""
    import re
    bad = []
    for line in report.splitlines():
        mm = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                       line)
        if mm and (int(mm[1]) or int(mm[2])):
            bad.append(line.strip())
    return bad


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


def _tree_positions(n: int, levels: int) -> list:
    """Positions the first ``levels`` levels of a full-depth binary search
    of ``n`` entries visit: its implicit tree, in level order."""
    pos, frontier = [], [(0, n)]
    for _ in range(levels):
        nxt = []
        for lo, hi in frontier:
            if hi > lo:
                mid = (lo + hi) >> 1
                pos.append(mid)
                nxt += [(lo, mid), (mid + 1, hi)]
        frontier = nxt
    return pos


def _k23_edges(tlk, tabs, keys, live, qf, lof, hif, kw, g, what):
    """K2 and K3 against their plain versions, bit for bit, on planted
    edges at full size: queries routed to empty leaves (the leaves of 64
    queries get the sentinel bounds +-n of an empty leaf in a copy of the
    tables, a full-array window the static depth does not converge), the
    depth cut by EDGE_ITERS_CUT, delta tiers of EDGE_DELTA_SIZES entries (a
    sorted draw of live keys, each key of the probe's first EDGE_TREE_LEVELS
    levels repeated at the next position, the last eighth +inf), queries
    equal to those keys, +-0, +-inf and NaN, and the largest tier also with
    both tiers as views that start inside a 32-byte sector; every case
    beside the path's own 2^20 queries and 2^18 pairs.  Returns the largest
    |kernel - plain|."""
    import torch
    dev = qf.device
    root, mat, vec = tabs
    live = live.to(torch.float32)
    head = qf[:4096]
    leaf = tlk.route_bucket(head, root, n_leaves=kw["n_leaves"],
                            route_n=kw["route_n"],
                            root_kind=kw.get("root_kind", "linear"))
    empty = torch.unique(leaf[:64])
    vec = vec.clone()
    vec[1, empty.long()] = -float(live.numel())
    vec[2, empty.long()] = float(live.numel())
    tabs = (root, mat, vec)
    q_empty = head[torch.isin(leaf, empty)]
    specials = torch.tensor([0.0, -0.0, float("inf"), -float("inf"),
                             float("nan")], device=dev)
    err, cases = 0, 0
    for size in EDGE_DELTA_SIZES:
        nf = size - size // 8
        x = torch.sort(live[torch.randint(0, live.numel(), (nf,), device=dev,
                                          generator=g)]).values
        pos = torch.tensor(_tree_positions(size, EDGE_TREE_LEVELS),
                           device=dev)
        dup = pos[pos + 1 < nf]
        x[dup + 1] = x[dup]
        dk = torch.cat([x, torch.full((size - nf,), float("inf"),
                                      device=dev)])
        planted = torch.cat([q_empty, dk[pos], specials])
        q = torch.cat([qf, planted])
        lo, hi = torch.cat([lof, planted]), torch.cat([hif, planted])
        # the largest tier also as views that start inside a 32-byte
        # sector and end in a tail that is not a whole sector
        tiers = [(keys, dk)] + ([(keys[1:], dk[3:])]
                                if size == EDGE_DELTA_SIZES[-1] else [])
        for (kt, dt), cut in itertools.product(tiers, (0, EDGE_ITERS_CUT)):
            kwc = dict(kw, iters=kw["iters"] - cut)
            for name, kern, plain in (
                    ("K2", lambda: tlk.dynamic_lookup(q, *tabs, kt, dt,
                                                      **kwc),
                     lambda: tlk.dynamic_lookup_plain(q, *tabs, kt, dt,
                                                      **kwc)),
                    ("K3", lambda: tlk.dynamic_range(lo, hi, *tabs, kt, dt,
                                                     **kwc),
                     lambda: tlk.dynamic_range_plain(lo, hi, *tabs, kt, dt,
                                                     **kwc))):
                err = max(err, _compare(
                    f"{name} {what} (delta {dt.shape[0]}, keys "
                    f"{kt.shape[0]}, iters {kwc['iters']})", kern, plain))
                cases += 1
    print(f"  K2/K3 ({what}) equal their plain versions bit for bit on "
          f"{cases} planted cases: {q_empty.numel()} queries routed to "
          f"empty leaves, iters {kw['iters']} and "
          f"{kw['iters'] - EDGE_ITERS_CUT}, delta tiers of "
          f"{list(EDGE_DELTA_SIZES)} entries with queries equal to the keys "
          f"of their first {EDGE_TREE_LEVELS} probe levels, +-0, +-inf, NaN;"
          f" the largest also with both tiers as unaligned views")
    return err


def _k1_k4_edges(tlk, name, kern, plain, vec, empty, n_live, keys, q,
                 iters):
    """A K1 or K4 call (``kern(q, vec, keys, iters)``) against its plain
    version, bit for bit, on planted edges at full size: the leaves (nodes)
    ``empty`` given an empty leaf's sentinel window +-n_live (not converged
    at the clamped depth; converged at full depth, where the fence searches
    the whole array), the depth cut by EDGE_ITERS_CUT and at full depth,
    the keys also as a view that starts inside a 32-byte sector; queries:
    the path's own, +-0, +-inf, NaN and the first and last keys.  The
    wrappers build the rows and fence of the planted tables and views.
    Returns (largest |kernel - plain|, cases)."""
    import torch
    specials = torch.tensor([0.0, -0.0, float("inf"), -float("inf"),
                             float("nan")], device=q.device)
    q = torch.cat([q, specials, keys[:4], keys[-4:]])
    planted = vec.clone()
    planted[1, empty.long()] = -float(n_live)
    planted[2, empty.long()] = float(n_live)
    err, cases = 0, 0
    for v, kt in itertools.product((vec, planted), (keys, keys[1:])):
        for it in (iters, iters - EDGE_ITERS_CUT, tlk.full_iters(kt.shape[0])):
            err = max(err, _compare(
                f"{name} (keys {kt.shape[0]}, iters {it}, "
                f"{'sentinel leaves' if v is planted else 'leaves'})",
                lambda: (kern(q, v, kt, it),), lambda: (plain(q, v, kt, it),)))
            cases += 1
    return err, cases


def _flash_work(q, k, q_offset: int, kv_valid: int) -> tuple:
    """(bytes, operations) of one K8 launch on these inputs: q read and
    the output written, the K and V rows of the keys the mask keeps (the
    first min(kv_valid, q_offset + Sq) positions), 4 dh operations a
    (query, valid key) pair (the QK and PV products)."""
    import numpy as np
    B, Sq, H, dh = q.shape
    keys = max(0, min(kv_valid, q_offset + Sq))
    el = q.element_size()
    nbytes = 2 * q.numel() * el + 2 * B * keys * k.shape[2] * dh * el
    per_row = np.clip(np.minimum(kv_valid, q_offset + np.arange(Sq) + 1), 0,
                      None)
    return nbytes, 4 * dh * B * H * int(per_row.sum())


def _bf16_ulp(mag):
    """One bf16 ulp at each magnitude (8 significant bits)."""
    import torch
    m = mag.abs().to(torch.float64).clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(m)) - 7)


def _dense_f64(q, k, v, q_offset: int, kv_valid: int):
    """Attention by a dense f64 softmax, one batch row at a time: an oracle
    independent of the online softmax."""
    import math
    import torch
    B, Sq, H, dh = q.shape
    G = H // k.shape[2]
    qp = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(k.shape[1], device=q.device)[None, :]
    keep = (kp <= qp) & (kp < kv_valid)
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    for b in range(B):
        kb = k[b].double().repeat_interleave(G, 1)
        vb = v[b].double().repeat_interleave(G, 1)
        s = torch.einsum("qhd,khd->hqk", q[b].double(), kb) / math.sqrt(dh)
        s = s.masked_fill(~keep, float("-inf"))
        out[b] = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), vb)
    return out


def _sdpa_call(q, k, v, q_offset: int, kv_valid: int):
    """``scaled_dot_product_attention(enable_gqa=True)`` on K8's inputs,
    set up once and returned as a call giving (B, H, Sq, dh):
    ``is_causal`` over the first ``kv_valid`` keys where the queries are
    positions 0 .. kv_valid - 1 (prefill), a boolean mask otherwise."""
    import torch
    import torch.nn.functional as F
    Sq = q.shape[1]
    if q_offset == 0 and kv_valid == Sq:
        qs, ks, vs = (t.transpose(1, 2).contiguous()
                      for t in (q, k[:, :kv_valid], v[:, :kv_valid]))
        return lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True, enable_gqa=True)
    qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    kp = torch.arange(k.shape[1], device=q.device)
    keep = ((kp <= q_offset + torch.arange(Sq, device=q.device)[:, None])
            & (kp < kv_valid))[None, None]
    return lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=keep, enable_gqa=True)


K8_KERNELS = ("flash_tc_kernel", "flash_split_kernel", "flash_combine_kernel",
              "flash_cc_kernel")


def _kind(name: str) -> str:
    """A device event of path D's trace: K8 (any of its tiles, and the
    split-KV tile's combine pass), a GEMM, or the rest."""
    low = name.lower()
    if any(k in low for k in K8_KERNELS):
        return "K8"
    if any(w in low for w in ("gemm", "gemv", "nvjet", "cutlass", "xmma",
                              "sm90_")):
        return "GEMM"
    return "other"


def _trace_windows(path, tags) -> dict:
    """Read a ``torch.profiler`` chrome trace.  Per user annotation in
    ``tags``: the window from its first start to its last end on the host
    clock, the device events launched inside it (matched to their launch
    by the correlation id), and from these the wall time (the window,
    extended to its last device event's end), the device busy time (the
    union of the events' intervals), the device time by kind and the
    number of device events."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    launch, spans, dev = {}, {t: [] for t in tags}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, a = e.get("cat", ""), e.get("args") or {}
        t0 = float(e["ts"])
        t1 = t0 + float(e.get("dur", 0))
        if cat in ("cuda_runtime", "cuda_driver") and "correlation" in a:
            launch[a["correlation"]] = t0
        elif cat == "user_annotation" and e.get("name") in spans:
            spans[e["name"]].append((t0, t1))
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev.append((t0, t1, e.get("name", ""), a.get("correlation")))
    out = {}
    for tag, sp in spans.items():
        if not sp:
            raise AssertionError(f"{Path(path).name}: no '{tag}' "
                                 f"annotation")
        lo, hi = min(a for a, _ in sp), max(b for _, b in sp)
        mine = sorted((t0, t1, n) for t0, t1, n, c in dev
                      if lo <= launch.get(c, t0) <= hi)
        if not mine:
            raise AssertionError(f"{Path(path).name}: no device event in "
                                 f"'{tag}'")
        busy, end, kinds = 0.0, lo, {}
        for t0, t1, n in mine:
            busy += max(0.0, t1 - max(t0, end))
            end = max(end, t1)
            kinds[_kind(n)] = kinds.get(_kind(n), 0.0) + (t1 - t0) / 1e6
        out[tag] = dict(wall=(max(hi, end) - lo) / 1e6, busy=busy / 1e6,
                        kinds=kinds, events=len(mine))
    return out


class _Harness:
    """What the counted paths share: draws from one seeded generator on the
    card, the kernels' launch counters, ``find`` / ``find_range`` checked
    against a ``torch.searchsorted`` truth, path A's churn and the log of
    seam misses."""

    def __init__(self, dev, seed: int, nq: int):
        import torch
        from repro_torch.kernels import flash, hist, ksdist, linfit, lookup
        self.dev, self.nq = dev, nq
        self.g = torch.Generator(device=dev)
        self.g.manual_seed(seed)
        self.counted = (lookup, ksdist, hist, linfit, flash)
        self.seam_log = []
        self.notes = {}         # what a later path prints beside its own

    def counters(self):
        return {k: v for mod in self.counted for k, v in mod.LAUNCHES.items()}

    def reset_counters(self):
        for mod in self.counted:
            mod.reset_launches()

    def uncounted(self, fn):
        """``fn()`` with the launch counts put back afterwards: launches
        that compare a kernel with its plain version inside a counted run
        do not count."""
        saved = [(mod, dict(mod.LAUNCHES)) for mod in self.counted]
        out = fn()
        for mod, counts in saved:
            mod.LAUNCHES.update(counts)
        return out

    def lognormal_keys(self, m):
        import torch
        return torch.sort(torch.empty(m, dtype=torch.float32, device=self.dev)
                          .log_normal_(0.0, 1.0, generator=self.g)).values

    def draw(self, m):
        import torch
        return torch.empty(m, dtype=torch.float32, device=self.dev) \
            .log_normal_(0.0, 1.0, generator=self.g).to(torch.float64)

    def pick(self, live, m):
        import torch
        i = torch.randint(0, live.shape[0], (m,), device=self.dev,
                          generator=self.g)
        return live[i]

    def edges_of(self, k32):
        import torch
        return torch.tensor([0.0, -1.0, 1e-30, float(k32[0]), 1e30, -1e30,
                             3e38, float(k32[-1]) * 2.0],
                            dtype=torch.float64, device=self.dev)

    def find_queries(self, live, edges):
        import torch
        half = self.nq // 2
        return torch.cat([self.pick(live, half),
                          self.draw(self.nq - half - edges.numel()), edges])

    def range_pairs(self, live):
        import torch
        m = self.nq // 4
        lo = torch.cat([self.pick(live, m // 2), self.draw(m - m // 2)])
        width = torch.empty(m, dtype=torch.float64, device=self.dev) \
            .exponential_(1.0 / 0.002, generator=self.g)
        hi = (lo + width).to(torch.float32).to(torch.float64)
        hi[: m // 64] = lo[: m // 64] - 0.5            # degenerate lo > hi
        return lo, hi

    def seam(self, tag, m, fn):
        from repro_torch.kernels import ops
        s0 = ops.SEAM["misses"]
        out, dt = _sync_time(fn)
        self.seam_log.append((tag, ops.SEAM["misses"] - s0, m))
        return out, dt

    def check_find(self, ix, q, tag):
        import torch
        live = ix.backend.live_keys_tensor().to(torch.float32)
        (found, rank), dt = self.seam(f"find/{tag}", q.numel(),
                                      lambda: ix.find(q))
        qf = q.to(torch.float32)
        want = torch.searchsorted(live, qf).to(torch.int32)
        _check_equal(f"find/{tag} rank", rank, want)
        _check_equal(f"find/{tag} found", found,
                     torch.searchsorted(live, qf, right=True) > want)
        return dt

    def check_range(self, ix, lo, hi, tag):
        import torch
        live = ix.backend.live_keys_tensor().to(torch.float32)
        (rl, rh), dt = self.seam(f"find_range/{tag}", 2 * lo.numel(),
                                 lambda: ix.find_range(lo, hi))
        want_lo = torch.searchsorted(live, lo.to(torch.float32)) \
            .to(torch.int32)
        want_hi = torch.maximum(torch.searchsorted(
            live, hi.to(torch.float32), right=True).to(torch.int32), want_lo)
        _check_equal(f"find_range/{tag} rank_lo", rl, want_lo)
        _check_equal(f"find_range/{tag} rank_hi", rh, want_hi)
        return dt

    def churn(self, ix, keys, steps, tag, edges):
        """Path A's churn on a dynamic index: find, find_range, a spread
        and a narrow insert (the narrow one must rebuild), a delete, find
        and find_range again, every answer against the truth."""
        import torch
        from repro_torch.kernels import ksdist as tks
        n = keys.shape[0]
        steps[f"find (built{tag})"] = self.check_find(
            ix, self.find_queries(keys, edges), "built" + tag)
        lo, hi = self.range_pairs(keys)
        steps[f"find_range (built{tag})"] = self.check_range(
            ix, lo, hi, "built" + tag)
        n_ins = min(2_000_000, n // 100)      # 2M / 100k / 1M at 200M keys
        narrow = n_ins // 20
        _, steps[f"insert (spread{tag})"] = _sync_time(
            lambda: ix.insert(self.draw(n_ins - narrow)))
        rebuilds0 = ix.backend.rebuilds
        k7_0 = tks.LAUNCHES["ksdist"]
        narrow_keys = (1.0 + 1e-4 * torch.rand(
            narrow, dtype=torch.float64, device=self.dev,
            generator=self.g)).to(torch.float32).to(torch.float64)
        _, steps[f"insert (narrow{tag})"] = _sync_time(
            lambda: ix.insert(narrow_keys))
        rebuilt = ix.backend.rebuilds - rebuilds0
        if rebuilt <= 0:
            raise AssertionError("the narrow insert batch ran no rebuild")
        live = ix.backend.live_keys_tensor()
        dels = self.pick(live, n_ins // 2)
        _, steps[f"delete{tag}"] = _sync_time(lambda: ix.delete(dels))
        live = ix.backend.live_keys_tensor()
        steps[f"find (churned{tag})"] = self.check_find(
            ix, self.find_queries(live, edges), "churned" + tag)
        lo, hi = self.range_pairs(live)
        steps[f"find_range (churned{tag})"] = self.check_range(
            ix, lo, hi, "churned" + tag)
        d = ix.backend
        expected = n + n_ins - d.deleted
        if d.live_count != expected or live.numel() != expected:
            raise AssertionError(f"live count {d.live_count} / "
                                 f"{live.numel()} != {expected}")
        return live, rebuilt, tks.LAUNCHES["ksdist"] - k7_0

    @staticmethod
    def print_steps(steps):
        for k, v in steps.items():
            print(f"  {k}: {v:.6f} s")

    def print_seam(self):
        for tag, miss, m in self.seam_log:
            print(f"  seam_misses {tag}: {miss} of {m} ({miss / m:.6%})")
        self.seam_log.clear()


def _path_d(args, dev, rows, h) -> None:
    """Phase 8, path D: qwen3-4b served at full width and depth through
    ``launch.serve.serve``, counted; K8 against its plain version and an
    f64 oracle on the attention inputs of the first and last layer in
    prefill and in the last decode step, K1 against its plain version on
    the page table's keys; the same serving run with the plain attention,
    end to end; K8 timed at both shapes against SDPA.  Adds the K8 rows to
    ``rows`` and path D's K1 launches to the ``lookup`` row."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch, single_card
    from repro_torch.core import rmi as trmi
    from repro_torch.kernels import flash as tflash
    from repro_torch.kernels import lookup as tlk
    from repro_torch.launch import serve as tserve
    from repro_torch.models import layers as tlayers

    cfg = single_card(get_arch(LM_ARCH))
    P, T, L = LM_PROMPT_LEN, LM_NEW_TOKENS, cfg.n_layers
    real_flash = tlayers.flash_attention
    real_make_prefill = tserve.serve_step.make_prefill
    real_page_table = tserve.learned_page_table
    captured, logits, tables = {}, {}, []
    calls = [0]

    def recording(q, k, v, *, q_offset, kv_valid=None, **kw):
        """K8 as the model calls it, keeping copies of the first and last
        layer's inputs in prefill and in the last decode step."""
        step, layer = divmod(calls[0], L)
        calls[0] += 1
        if layer in (0, L - 1) and step in (0, T):
            captured[("prefill" if step == 0 else "decode", layer)] = (
                q.clone(), k.clone(), v.clone(), int(q_offset),
                int(kv_valid))
        return real_flash(q, k, v, q_offset=q_offset, kv_valid=kv_valid,
                          **kw)

    def plain(q, k, v, *, q_offset, kv_valid=None, **kw):
        return tflash.flash_attention_plain(q, k, v, q_offset=q_offset,
                                            kv_valid=kv_valid)

    def keep_logits(tag):
        def make(c):
            fn = real_make_prefill(c)

            def prefill(*a):
                out = fn(*a)
                logits[tag] = out[0].clone()
                return out
            return prefill
        return make

    def keep_table(table, **kw):
        tables.append(dict(table))
        return real_page_table(table, **kw)

    def serve_with(attn, tag):
        tlayers.flash_attention = attn
        tserve.serve_step.make_prefill = keep_logits(tag)
        tserve.learned_page_table = keep_table
        res = tserve.serve(LM_ARCH, reduced=False, requests=LM_REQUESTS,
                           prompt_len=P, new_tokens=T, seed=args.seed)
        tlayers.flash_attention = real_flash
        tserve.serve_step.make_prefill = real_make_prefill
        tserve.learned_page_table = real_page_table
        return res

    torch.cuda.reset_peak_memory_stats()
    h.reset_counters()
    res, t_all = _sync_time(lambda: serve_with(recording, "kernel"))
    launches = h.counters()
    peak = torch.cuda.max_memory_allocated() / 2**30
    # prefill on the tensor-core tile, decode on the split-KV tile and its
    # combine pass, nothing on the CUDA-core tile
    want = {"flash": L, "flash_decode": L * T, "flash_combine": L * T,
            "flash_cc": 0}
    if {k: launches[k] for k in want} != want or launches["lookup"] <= 0:
        raise AssertionError(f"path D launches {launches}, want {want} and "
                             f"K1 at least once")
    toks = res.tokens
    if toks.shape != (LM_REQUESTS, T + 1) or toks.dtype != np.int32 or \
            toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"path D tokens {toks.shape} {toks.dtype}")
    lk = logits["kernel"]
    if lk.shape != (LM_REQUESTS, cfg.vocab_padded) or \
            not bool(torch.isfinite(lk).all()):
        raise AssertionError("path D prefill logits not finite or misshapen")
    print(f"phase 8: path D ({LM_ARCH}, single card: {L} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} query / {cfg.n_kv_heads} KV heads, "
          f"dh {cfg.head_dim}, {cfg.param_count()} parameters) ok; "
          f"{LM_REQUESTS} requests x {P} prompt + {T} new tokens; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    print(f"  prefill {res.prefill_s:.6f} s; decode {res.decode_s:.6f} s "
          f"for {T} steps ({res.decode_tok_s:.3f} tokens/s); serve() "
          f"{t_all:.6f} s with weight init; peak memory allocated "
          f"{peak:.3f} GiB; page table over {res.pages} pages")
    print(f"  greedy tokens (first 8 of each request): "
          f"{toks[:, :8].tolist()}")

    errs = {"flash": 0.0, "flash_decode": 0.0}
    # faults planted through K8's arguments on layer 0's inputs, and
    # whether the check below must see them: a skipped key tile and an
    # off-by-one causal mask must fail it; one key of 2,080 dropped from a
    # decode row moves the output by about its softmax weight and is only
    # reported
    faults = {"prefill": (("one 64-key tile skipped, kv_valid - 64", 0, -64,
                           True),
                          ("the causal mask one key late, q_offset + 1", 1,
                           0, True)),
              "decode": (("one 64-key tile skipped, kv_valid - 64", 0, -64,
                          True),
                         ("the last key dropped, kv_valid - 1", 0, -1,
                          False))}
    for (phase, layer), (q, k, v, qo, kvv) in sorted(captured.items()):
        name = "flash" if phase == "prefill" else "flash_decode"
        got = h.uncounted(functools.partial(
            tflash.flash_attention, q, k, v, q_offset=qo, kv_valid=kvv))
        ref = tflash.flash_attention_plain(q, k, v, q_offset=qo,
                                           kv_valid=kvv)
        mag = tflash.flash_attention_plain(q.float(), k.float(),
                                           v.float().abs(), q_offset=qo,
                                           kv_valid=kvv)
        exact = _dense_f64(q, k, v, qo, kvv)
        sdpa = _sdpa_call(q, k, v, qo, kvv)().transpose(1, 2)
        # the CUDA-core tile (f32 inputs) on the same inputs
        qf, kf, vf = q.float(), k.float(), v.float()
        got_cc = h.uncounted(functools.partial(
            tflash.flash_attention, qf, kf, vf, q_offset=qo, kv_valid=kvv))
        ref_cc = tflash.flash_attention_plain(qf, kf, vf, q_offset=qo,
                                              kv_valid=kvv)
        # (what, got, want, printed here): the last two are read below
        checks = [("plain", got, ref, False),
                  ("f64 oracle", got, exact, False),
                  ("plain vs f64 oracle", ref, exact, False),
                  ("the CUDA-core tile (f32) vs its plain version", got_cc,
                   ref_cc, True)]
        if phase == "decode":
            n_split, per = tflash.decode_plan(q, k, q_offset=qo,
                                              kv_valid=kvv)
            checks.append((f"its split-KV plain version ({n_split} runs of "
                           f"{per} tiles)", got,
                           tflash.flash_decode_split_plain(
                               q, k, v, q_offset=qo, kv_valid=kvv,
                               n_split=n_split), True))
        torch.cuda.synchronize()
        tol = _bf16_ulp(mag)
        d_plain = (got.double() - ref.double()).abs()
        d_k, d_p = (got.double() - exact).abs(), (ref.double() - exact).abs()
        d_s = (sdpa.double() - exact).abs()
        for what, a, b, show in checks:
            d = (a.double() - b.double()).abs()
            if not bool((d <= tol).all()):
                raise AssertionError(
                    f"K8 {phase} layer {layer} vs {what}: "
                    f"{int((d > tol).sum())} entries beyond one bf16 ulp of "
                    f"the magnitude (max {float(d.max())})")
            if show:
                print(f"    {phase} layer {layer}: K8 vs {what}: max "
                      f"{float((d / tol).max()):.6f} ulps of the magnitude")
        errs[name] = max(errs[name], float(d_plain.max()))
        ulps = [float((d / tol).max()) for d in (d_plain, d_k, d_p, d_s)]
        own = d_plain / _bf16_ulp(ref)
        print(f"  K8 {phase} layer {layer} (q {tuple(q.shape)}, k/v "
              f"{tuple(k.shape)}, q_offset {qo}, kv_valid {kvv}): within one "
              f"bf16 ulp of the magnitude of the plain version and the f64 "
              f"oracle; max |kernel - plain| {float(d_plain.max()):.6e}, max "
              f"|kernel - f64| {float(d_k.max()):.6e}, max |plain - f64| "
              f"{float(d_p.max()):.6e}, entries differing from plain "
              f"{int((d_plain > 0).sum())} of {d_plain.numel()}; in ulps of "
              f"the magnitude: kernel - plain {ulps[0]:.6f}, kernel - f64 "
              f"{ulps[1]:.6f}, plain - f64 {ulps[2]:.6f}; in ulps of the "
              f"plain version's own value: kernel - plain max "
              f"{float(own.max()):.6f}, {int((own > 1).sum())} entries "
              f"beyond one")
        print(f"    SDPA (bf16, the library yardstick) vs the f64 oracle: "
              f"max {ulps[3]:.6f} ulps of the magnitude, "
              f"{int((d_s > tol).sum())} entries beyond one "
              f"({'passes' if ulps[3] <= 1 else 'fails'} K8's check)")
        for what, dq, dk, must in faults[phase] if layer == 0 else ():
            bad = h.uncounted(functools.partial(
                tflash.flash_attention, q, k, v, q_offset=qo + dq,
                kv_valid=kvv + dk))
            d = (bad.double() - exact).abs()
            beyond = int((d > tol).sum())
            if must and not beyond:
                raise AssertionError(f"K8 {phase}: the planted fault "
                                     f"({what}) passes the check")
            print(f"    planted fault ({what}): {beyond} entries beyond one "
                  f"bf16 ulp of the magnitude, max "
                  f"{float((d / tol).max()):.6f} ulps")

    # K1 on the page table's keys (the packed (request << 22) | block keys
    # and the gaps after each request's blocks), as the table builds it
    keys = torch.tensor(sorted(float((r << 22) | b) for r, b in tables[0]),
                        dtype=torch.float64, device=dev)
    pidx = trmi.build_rmi(keys, n_leaves=max(keys.numel() // 64, 1),
                          kind="linear", device=dev)
    gaps = torch.tensor([float((r << 22) + (1 << 20))
                         for r in range(LM_REQUESTS)], dtype=torch.float64,
                        device=dev)
    qk = torch.cat([keys, gaps]).to(torch.float32)
    kw = dict(n_leaves=pidx.n_leaves, iters=pidx.search_iters)
    e1 = _compare("lookup (path D page table)", lambda: h.uncounted(
        lambda: (tlk.lookup(qk, *pidx.packed_tables(), pidx.keys_f32,
                            **kw),)),
        lambda: (tlk.lookup_plain(qk, *pidx.packed_tables(), pidx.keys_f32,
                                  **kw),))
    rows["lookup"]["launches"] += launches["lookup"]
    rows["lookup"]["max_abs_err"] = max(rows["lookup"]["max_abs_err"], e1)
    print(f"  K1 on the page table's {keys.numel()} keys and {gaps.numel()} "
          f"gaps equals its plain version bit for bit (tolerance 0); path D "
          f"K1 launches {launches['lookup']}")

    for name, key in (("flash", ("prefill", 0)), ("flash_decode",
                                                  ("decode", 0))):
        q, k, v, qo, kvv = captured[key]
        work = _flash_work(q, k, qo, kvv)
        rows[name] = _time_row(
            name, lambda q=q, k=k, v=v, qo=qo, kvv=kvv: tflash.flash_attention(
                q, k, v, q_offset=qo, kv_valid=kvv),
            lambda q=q, k=k, v=v, qo=qo, kvv=kvv: tflash.flash_attention_plain(
                q, k, v, q_offset=qo, kv_valid=kvv),
            _sdpa_call(q, k, v, qo, kvv), [work], launches[name], errs[name],
            reps=20 if name == "flash" else 100,
            plain_reps=5 if name == "flash" else 20)
        if name == "flash":
            # the prefill tile computes on the bf16 tensor cores: its bound
            # is the same operations at their rate, the f32 one kept beside
            t_ops = work[1] / BF16_TC_OPS_PER_S * 1e3
            t_bytes = work[0] / HBM_BYTES_PER_S * 1e3
            rows[name]["bound_f32_ms"] = rows[name]["bound_ms"]
            rows[name]["bound_ms"], rows[name]["bound_by"] = (
                (t_ops, "operations") if t_ops >= t_bytes
                else (t_bytes, "bytes"))
        else:
            rows[name]["n_split"], rows[name]["tiles_per_split"] = (
                tflash.decode_plan(q, k, q_offset=qo, kv_valid=kvv))
            rows[name]["combine_launches"] = launches["flash_combine"]
        extra = {k: v_ for k, v_ in rows[name].items()
                 if k in ("bound_f32_ms", "n_split", "tiles_per_split",
                          "combine_launches")}
        print(f"    {work[0]} bytes, {work[1]} operations; bound_ms "
              f"{rows[name]['bound_ms']:.6f} ({rows[name]['bound_by']}); "
              f"{extra}")
    share_p = L * rows["flash"]["ms"] / 1e3 / res.prefill_s
    share_d = L * T * rows["flash_decode"]["ms"] / 1e3 / res.decode_s
    print(f"  K8's share (launches x ms): prefill {share_p:.3%}, decode "
          f"{share_d:.3%}")
    del captured

    # one serve() call traced with torch.profiler, prefill and each decode
    # step under a user annotation: where path D's time goes
    def annotated(make, tag):
        def make_annotated(c):
            fn = make(c)

            def run(*a):
                with torch.profiler.record_function(tag):
                    return fn(*a)
            return run
        return make_annotated

    real_make_decode = tserve.serve_step.make_decode_step
    tserve.serve_step.make_prefill = annotated(real_make_prefill,
                                               "path D prefill")
    tserve.serve_step.make_decode_step = annotated(real_make_decode,
                                                   "path D decode")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        res_t = tserve.serve(LM_ARCH, reduced=False, requests=LM_REQUESTS,
                             prompt_len=P, new_tokens=T, seed=args.seed)
    tserve.serve_step.make_prefill = real_make_prefill
    tserve.serve_step.make_decode_step = real_make_decode
    trace = ROOT / "build" / "path_d_trace.json"
    prof.export_chrome_trace(str(trace))
    del prof
    split = _trace_windows(trace, ("path D prefill", "path D decode"))
    for (tag, w), plain_s in zip(split.items(), (res.prefill_s,
                                                 res.decode_s)):
        kinds = ", ".join(f"{k} {v:.6f} s ({v / w['wall']:.3%})" for k, v in
                          sorted(w["kinds"].items(), key=lambda kv: -kv[1]))
        print(f"  traced {tag}: wall {w['wall']:.6f} s (serve() untraced "
              f"{plain_s:.6f} s), device busy {w['busy']:.6f} s, idle share "
              f"{1 - w['busy'] / w['wall']:.6f}; {w['events']} device "
              f"events; by kind {kinds}")
    print(f"  the trace ({trace.relative_to(ROOT)}): serve() reported "
          f"prefill {res_t.prefill_s:.6f} s and {res_t.decode_tok_s:.3f} "
          f"tokens/s under the profiler, against {res.prefill_s:.6f} s and "
          f"{res.decode_tok_s:.3f} tokens/s untraced; greedy tokens equal "
          f"to the untraced run's {int((res_t.tokens == toks).sum())} of "
          f"{toks.size}")

    res_p = serve_with(plain, "plain")
    lp = logits["plain"]
    dl = float((lk - lp).abs().max())
    v_ = cfg.vocab_size
    top2 = torch.topk(lp[:, :v_], 2).values
    margin = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    first_k = lk[:, :v_].argmax(-1).cpu().numpy()
    first_p = lp[:, :v_].argmax(-1).cpu().numpy()
    sure = margin > 2 * LM_LOGIT_TOL
    if dl > LM_LOGIT_TOL or not (first_k[sure] == first_p[sure]).all() or \
            not (first_k == toks[:, 0]).all():
        raise AssertionError(f"path D kernel vs plain prefill logits: max "
                             f"|diff| {dl} (tolerance {LM_LOGIT_TOL}), first "
                             f"tokens {first_k} / {first_p} / {toks[:, 0]}")
    agree = (res_p.tokens == toks)
    lead = [int(np.argmin(np.append(a, False))) for a in agree]
    print(f"  end to end with the plain attention: prefill logits max |kernel"
          f" - plain| {dl:.6e} (tolerance {LM_LOGIT_TOL}; logits max "
          f"{float(lp.abs().max()):.6f}); top-2 margins "
          f"{np.round(margin, 6).tolist()}; greedy tokens equal "
          f"{int(agree.sum())} of {agree.size}, leading run per request "
          f"{lead}; plain prefill {res_p.prefill_s:.6f} s, decode "
          f"{res_p.decode_tok_s:.3f} tokens/s")


def _slice_ranks(pieces, lo, hi, live_of) -> int:
    """Check every (shard, keys) piece of ``locate_range``'s answer against
    a per-shard truth: the piece is a slice of that shard's live keys (its
    offset read from the view), and its ends are the shard's ranks of the
    range clamped to the shard's live span.  Returns the number of keys
    the ranges hold."""
    import numpy as np
    seen, total = set(), 0
    for r, got in enumerate(pieces):
        for sid, piece in got:
            live, want = piece.base, live_of[sid]
            if id(live) not in seen:        # a shard's live keys, once
                if not (isinstance(live, np.ndarray)
                        and np.array_equal(live, want)):
                    raise AssertionError(f"range {r}: the piece of shard "
                                         f"{sid} is not a slice of its live "
                                         f"keys")
                seen.add(id(live))
            a = (piece.ctypes.data - live.ctypes.data) // 8
            wa = int(np.searchsorted(want, max(lo[r], want[0]), "left"))
            wb = int(np.searchsorted(want, min(hi[r], want[-1]), "right"))
            if (a, a + piece.size) != (wa, wb):
                raise AssertionError(f"range {r} shard {sid}: [{a}, "
                                     f"{a + piece.size}) != [{wa}, {wb})")
            total += piece.size
    return total


def _k23_vs_plain(dyn, q, lo, hi, what) -> dict:
    """K2 and K3 against their plain versions on a dynamic index's own
    tables, rows and delta tier, with the arguments its ``find`` and
    ``find_range`` pass them (K2 alone when ``lo`` is None); returns each
    kernel's max |diff|."""
    import torch
    from repro_torch.kernels import lookup as tlk
    idx = dyn.index
    tabs, keys, dk = idx.packed_tables(), idx.keys_f32, \
        tlk.pad_delta(dyn.delta_keys_f32)
    kw = dict(n_leaves=idx.n_leaves, route_n=dyn.route_n,
              iters=idx.search_iters, root_kind=idx.root_kind,
              leaf_kind=idx.leaf_kind)
    qf = q.to(torch.float32)
    errs = {"dynamic_lookup": _compare(
        f"dynamic_lookup ({what})",
        lambda: tlk.dynamic_lookup(qf, *tabs, keys, dk, rows=idx.leaf_rows(),
                                   **kw),
        lambda: tlk.dynamic_lookup_plain(qf, *tabs, keys, dk, **kw))}
    if lo is not None:
        lof, hif = lo.to(torch.float32), hi.to(torch.float32)
        errs["dynamic_range"] = _compare(
            f"dynamic_range ({what})",
            lambda: tlk.dynamic_range(lof, hif, *tabs, keys, dk, **kw),
            lambda: tlk.dynamic_range_plain(lof, hif, *tabs, keys, dk, **kw))
    return errs


def _stacked_k2_vs_plain(d, q, what) -> float:
    """The stacked K2 against its plain version on a sharded dynamic
    index's stack and descriptors, with the batch routed and grouped as its
    ``find`` gives it; returns the max |diff|."""
    import torch
    from repro_torch.kernels import lookup as tlk
    st = d._stacked()
    pk, tabs, kw = d._kernel_args(st, st["parts"][0])
    _, _, ds, kq, _ = d._grouped(st, q)
    kq = kq.to(torch.float32)
    tables = (pk["roots"], pk["mats"], pk["vecs"], pk["kf"])
    return _compare(
        f"sharded_dynamic_lookup ({what})",
        lambda: tlk.sharded_dynamic_lookup(kq, ds, *tables, pk["dkf"],
                                           rows=pk.get("rows"), tabs=tabs,
                                           **kw),
        lambda: tlk.sharded_dynamic_lookup_plain(kq, ds, *tables, pk["dkf"],
                                                 **kw))


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def _path_e(args, dev, rows, h) -> None:
    """Phase 9, path E, counted: the paper's baselines (B+tree over every
    key on the card, PGM and RadixSpline over a 2^22-key sample built on
    the host) beside ``rmi.lookup`` (K1); ``Index`` snapshots (blocking and
    async), restore, a flipped byte's fallback and a pooled drift index's
    round trip; an 8-shard ``IndexedDataset`` (K7 in each pooled build, K2
    ``locate``, K3 ``locate_range``) under appends and deletes.  Every
    answer is held against a ``torch.searchsorted`` truth.  Adds path E's
    launches to the rows of the kernels it launched."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch.api import Index
    from repro_torch.core import btree as tbtree
    from repro_torch.core import persist as tpersist
    from repro_torch.core import pgm as tpgm
    from repro_torch.core import radix_spline as trs
    from repro_torch.core import reuse as treuse
    from repro_torch.core import rmi as trmi
    from repro_torch.core import synth as tsynth
    from repro_torch.data.indexed_dataset import IndexedDataset
    from repro_torch.kernels import ops

    f32, f64, i32 = torch.float32, torch.float64, torch.int32
    n, L, nq = args.n, args.n_leaves, args.queries
    keys32 = h.lognormal_keys(n)
    keys = keys32.to(f64)
    edges = h.edges_of(keys32)
    h.reset_counters()
    ops.reset_seam()
    steps, times = {}, {}

    def fq(live):
        # f32-exact queries: the f32 truth (K1-K3) and the f64 one agree
        return h.find_queries(live, edges).to(f32).to(f64)

    # ---- 1. baselines beside the RMI --------------------------------------
    q = fq(keys)
    truth = torch.searchsorted(keys, q).to(i32)
    build_s = {}
    bt, build_s["B+tree"] = _sync_time(
        lambda: tbtree.build_btree(keys, BTREE_FANOUT, device=dev))
    _check_equal("B+tree lookup", tbtree.lookup(bt, q), truth)
    # PGM and RadixSpline build in a host loop a key: a sample at evenly
    # spaced ranks
    m = min(PGM_RS_SAMPLE, n)
    sample = keys[torch.arange(m, device=dev) * n // m].contiguous()
    pg, build_s["PGM"] = _sync_time(
        lambda: tpgm.build_pgm(sample, PGM_EPS, device=dev))
    rsx, build_s["RadixSpline"] = _sync_time(
        lambda: trs.build_rs(sample, RS_EPS, RS_RADIX_BITS, device=dev))
    qs = fq(sample)
    truth_s = torch.searchsorted(sample, qs).to(i32)
    _check_equal("PGM lookup", tpgm.lookup(pg, qs), truth_s)
    _check_equal("RadixSpline lookup", trs.lookup(rsx, qs), truth_s)
    sidx, build_s["RMI"] = _sync_time(
        lambda: trmi.build_rmi(keys, n_leaves=L, device=dev))
    pos, _ = h.seam("lookup/path E", nq, lambda: trmi.lookup(sidx, q))
    _check_equal("RMI lookup (K1)", pos, truth)
    idx_bytes = {
        "B+tree": sum(t.numel() * 8 for t in bt.levels),
        "PGM": sum(t.numel() * 8 for lv in (pg.seg_keys, pg.seg_slope,
                                            pg.seg_icept) for t in lv),
        "RadixSpline": rsx.size_bytes,
        "RMI": sum(t.numel() * t.element_size() for t in
                   (*sidx.root, *sidx.leaves, sidx.err_lo, sidx.err_hi))}
    shape = {"B+tree": f"height {bt.height}",
             "PGM": f"{pg.n_segments} segments, {len(pg.seg_keys)} levels",
             "RadixSpline": f"{rsx.spline_x.numel()} spline points",
             "RMI": f"{L} leaves, search_iters {sidx.search_iters}"}
    look_ms = h.uncounted(lambda: {
        "B+tree": _event_ms(lambda: tbtree.lookup(bt, q), 20),
        "PGM": _event_ms(lambda: tpgm.lookup(pg, qs), 20),
        "RadixSpline": _event_ms(lambda: trs.lookup(rsx, qs), 20),
        "RMI": _event_ms(lambda: trmi.lookup(sidx, q), 20)})
    lib_ms = _event_ms(lambda: torch.searchsorted(keys, q), 20)
    base_txt = [f"  {k}: build {build_s[k]:.6f} s, lookup {v:.6f} ms "
                f"({nq} queries over {n if k in ('B+tree', 'RMI') else m} "
                f"keys), {shape[k]}, {idx_bytes[k]} index bytes"
                for k, v in look_ms.items()]
    del bt, pg, rsx, sidx, sample, qs, truth_s, pos

    # ---- 2. snapshots and restore ------------------------------------------
    ix, steps["Index.build"] = _sync_time(lambda: Index.build(keys,
                                                              n_leaves=L))
    live, _, _ = h.churn(ix, keys, steps, " (path E)", edges)
    store_dir = ROOT / "build"
    store_dir.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="path_e_store_", dir=store_dir)
    free = shutil.disk_usage(tmp).free
    print(f"  snapshot store {Path(tmp).relative_to(ROOT)}: "
          f"{free / 2**30:.3f} GiB free")
    try:
        store = tpersist.SnapshotStore(tmp)
        _, times["snapshot step 1 (blocking)"] = _sync_time(
            lambda: ix.snapshot(store, 1))
        q1 = fq(live)
        lo1, hi1 = h.range_pairs(live)
        ans1 = ix.find(q1) + ix.find_range(lo1, hi1)
        ix.insert(h.draw(min(2_000_000, n // 100)))
        t0 = time.perf_counter()
        ix.snapshot(store, 2, blocking=False)
        times["snapshot step 2 (async): return"] = time.perf_counter() - t0
        store.wait()
        times["snapshot step 2 (async): until written"] = \
            time.perf_counter() - t0
        step_bytes = {s: _dir_bytes(store._step_dir(s))
                      for s in store.steps()}
        rix, times["Index.restore (step 2)"] = _sync_time(
            lambda: Index.restore(store))
        d, r = ix.backend, rix.backend
        if r.live_count != d.live_count or r.rebuilds != d.rebuilds:
            raise AssertionError(f"restore did not give step 2: live "
                                 f"{r.live_count} vs {d.live_count}")
        live2 = d.live_keys_tensor()
        q2 = fq(live2)
        lo2, hi2 = h.range_pairs(live2)
        h.check_find(rix, q2, "restored")
        h.check_range(rix, lo2, hi2, "restored")
        for what, a, b in (("find", rix.find(q2), ix.find(q2)),
                           ("find_range", rix.find_range(lo2, hi2),
                            ix.find_range(lo2, hi2))):
            for i, (x, y) in enumerate(zip(a, b, strict=True)):
                _check_equal(f"restored {what} [{i}] vs the live index",
                             x, y)
        for i, (x, y) in enumerate(zip(
                r.index.packed_tables() + (r.index.leaf_rows(),
                                           r.index.keys_f32,
                                           r.index.key_fence, r.base_psum,
                                           r.delta_psum),
                d.index.packed_tables() + (d.index.leaf_rows(),
                                           d.index.keys_f32,
                                           d.index.key_fence, d.base_psum,
                                           d.delta_psum), strict=True)):
            _check_equal(f"restored cache [{i}] (root, mat, vec, leaf rows, "
                         f"f32 keys, fence, psums) vs the live index", x, y)
        if r.index.search_iters != d.index.search_iters:
            raise AssertionError("restored search depth differs")
        # K2/K3 against their plain versions on the restored tables
        errs = h.uncounted(lambda: _k23_vs_plain(r, q2, lo2, hi2,
                                                 "restored"))
        del rix, r
        # a flipped byte in step 2's shard file: fall back to step 1
        path = os.path.join(store._step_dir(2), "shard_00000.npz")
        with open(path, "r+b") as fh:
            fh.seek(os.path.getsize(path) // 2)
            b = fh.read(1)
            fh.seek(-1, os.SEEK_CUR)
            fh.write(bytes([b[0] ^ 0xFF]))
        fb, times["Index.restore (step 2 damaged -> step 1)"] = _sync_time(
            lambda: Index.restore(store))
        got1 = fb.find(q1) + fb.find_range(lo1, hi1)
        for i, (x, y) in enumerate(zip(got1, ans1, strict=True)):
            _check_equal(f"fallback restore [{i}] vs step 1's answers", x, y)
        del fb, got1
        for what, kw in (("step=2", dict(step=2)),
                         ("on_corrupt='raise'", dict(on_corrupt="raise"))):
            t0 = time.perf_counter()
            try:
                tpersist.restore_dynamic(store, **kw)
            except tpersist.SnapshotCorruption as e:
                times[f"restore_dynamic({what}) raises"] = \
                    time.perf_counter() - t0
                print(f"  restore_dynamic({what}): {e}")
            else:
                raise AssertionError(f"restore_dynamic({what}) accepted a "
                                     f"damaged snapshot")
        del ix, d, live, live2, q, truth, q1, lo1, hi1, ans1, q2, lo2, hi2
        torch.cuda.empty_cache()

        # a pooled, drift-monitored index at path C's settings
        md = min(2_000_000, n)
        dpool = treuse.build_pool(tsynth.generate_pool(DRIFT_EPS),
                                  kind="linear", m_sim=64, device=dev)
        dix = Index.build(h.lognormal_keys(md).to(f64),
                          n_leaves=max(L * md // n, 64), pool=dpool,
                          eps=DRIFT_EPS, kind="linear", drift_bins=64,
                          drift_hi=0.02, drift_lo=0.01, swap_on_drift=True)
        for _ in range(4):
            dix.insert(torch.empty(md // 100, dtype=f32, device=dev)
                       .log_normal_(1.8, 0.9, generator=h.g).to(f64))
            dix.maybe_swap()
        dix.snapshot(store, 3)
        rdix, times["Index.restore (pooled drift index, 2M keys)"] = \
            _sync_time(lambda: Index.restore(store))
        dd, rd = dix.backend, rdix.backend
        if not np.array_equal(rdix.drift_scores(), dix.drift_scores()) \
                or not bool(dd.drift.drifted):
            raise AssertionError(f"drift scores {rdix.drift_scores()} vs "
                                 f"{dix.drift_scores()} (must latch)")
        for nm in ("ref", "acc"):
            _check_equal(f"restored drift {nm}", getattr(rd.drift, nm),
                         getattr(dd.drift, nm))
        dlive = dd.live_keys_tensor()
        dq = fq(dlive)
        dlo, dhi = h.range_pairs(dlive)
        h.check_find(rdix, dq, "restored drift index")
        h.check_range(rdix, dlo, dhi, "restored drift index")
        for i, (x, y) in enumerate(zip(rdix.find(dq) + rdix.find_range(
                dlo, dhi), dix.find(dq) + dix.find_range(dlo, dhi),
                strict=True)):
            _check_equal(f"restored drift index [{i}] vs the live one", x, y)
        drift_txt = (f"score {float(dd.drift.score):.6f}, latch "
                     f"{bool(dd.drift.drifted)}, swaps {dd.swaps_committed},"
                     f" rebuilds {dd.rebuilds}, step 3 "
                     f"{_dir_bytes(store._step_dir(3))} bytes")
        del dix, rdix, dd, rd, dlive, dq, dlo, dhi, dpool
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()

    # ---- 3. the indexed dataset --------------------------------------------
    lpool = treuse.build_pool(tsynth.generate_pool(0.9), kind="linear",
                              device=dev)
    ds = IndexedDataset.create(pool=lpool, eps=0.9,
                               n_leaves=max(L // DATASET_SHARDS, 64))
    # disjoint key ranges: cut at the start of a run of equal keys
    cuts = [0] + [int(torch.searchsorted(keys, keys[s * n // DATASET_SHARDS]))
                  for s in range(1, DATASET_SHARDS)] + [n]
    t0 = time.perf_counter()
    for s in range(DATASET_SHARDS):
        ds.add_shard(keys[cuts[s]:cuts[s + 1]])
    torch.cuda.synchronize()
    times["IndexedDataset: 8 x add_shard"] = time.perf_counter() - t0

    def check_dataset(tag):
        lk = [torch.as_tensor(s.keys, device=dev) for s in ds.shards]
        allk = torch.cat(lk)
        qd = h.pick(allk, nq)
        (sid, off), times[f"locate ({tag})"] = _sync_time(
            lambda: ds.locate(qd))
        bounds = torch.tensor(ds.boundaries, dtype=f64, device=dev)
        want_sid = torch.searchsorted(bounds, qd).clamp(max=len(lk) - 1)
        _check_equal(f"locate ({tag}) shard ids", torch.as_tensor(
            sid, device=dev), want_sid)
        offt = torch.as_tensor(off, device=dev)
        for s, k in enumerate(lk):
            mk = want_sid == s
            _check_equal(f"locate ({tag}) offsets in shard {s}", offt[mk],
                         torch.searchsorted(k, qd[mk]))
        lo, hi = h.range_pairs(allk)
        lo_h, hi_h = lo.cpu().numpy(), hi.cpu().numpy()
        pieces, times[f"locate_range ({tag})"] = _sync_time(
            lambda: ds.locate_range(lo_h, hi_h))
        got = _slice_ranks(pieces, lo_h, hi_h, [s.keys for s in ds.shards])
        want = int((torch.searchsorted(allk, hi, right=True)
                    - torch.searchsorted(allk, lo)).clamp(min=0).sum())
        if got != want:
            raise AssertionError(f"locate_range ({tag}): {got} keys, the "
                                 f"truth {want}")
        # K2 / K3 against their plain versions on every shard's tables, with
        # the queries and the clamped ranges locate / locate_range gave it
        last = len(lk) - 1
        s_lo = torch.searchsorted(bounds, lo).clamp(max=last)
        s_hi = torch.maximum(torch.searchsorted(bounds, hi).clamp(max=last),
                             s_lo)
        for s, k in enumerate(lk):
            rid = (s_lo <= s) & (s <= s_hi)
            ql = torch.where(s_lo[rid] == s, lo[rid], k[0])
            qh = torch.where(s_hi[rid] == s, hi[rid], k[-1])
            for kern, e in h.uncounted(functools.partial(
                    _k23_vs_plain, ds.shards[s].dyn, qd[want_sid == s], ql,
                    qh, f"shard {s}, {tag}")).items():
                errs[kern] = max(errs[kern], e)
        return got

    in_ranges = check_dataset("built")
    n_app = min(2_000_000, n // 100) // DATASET_SHARDS
    t_app = t_del = 0.0
    for s, info in enumerate(ds.shards):
        k0, k1 = float(info.keys[0]), float(info.keys[-1])
        app = (k0 + (k1 - k0) * torch.rand(n_app, dtype=f64, device=dev,
                                            generator=h.g)).to(f32).to(f64)
        _, dt = _sync_time(functools.partial(ds.append_to_shard, s, app))
        t_app += dt
        dels = h.pick(torch.as_tensor(info.keys, device=dev), n_app // 2)
        _, dt = _sync_time(functools.partial(ds.delete_samples, s, dels))
        t_del += dt
    times[f"append_to_shard x8 ({n_app} keys each)"] = t_app
    times[f"delete_samples x8 ({n_app // 2} keys each)"] = t_del
    in_ranges2 = check_dataset("after appends and deletes")
    launches = h.counters()
    for k in ("lookup", "dynamic_lookup", "dynamic_range", "ksdist",
              "ksdist_tables"):
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} never launched on path E: "
                                 f"{launches}")
    for k, v in launches.items():
        if v and k in rows:
            rows[k]["launches"] += v
    for k, e in errs.items():
        rows[k]["max_abs_err"] = max(rows[k]["max_abs_err"], e)
    rebuilt = sum(s.dyn.rebuilds for s in ds.shards)

    print(f"phase 9: path E (baselines, snapshots, indexed dataset) ok; "
          f"n={n}; launches {launches}; K2/K3 on the restored tables and "
          f"on every dataset shard's (built, and after appends and deletes) "
          f"equal their plain versions bit for bit (tolerance 0): {errs}")
    print("\n".join(base_txt))
    print(f"  torch.searchsorted over the {n} keys: {lib_ms:.6f} ms")
    h.print_steps(steps)
    for k, v in times.items():
        print(f"  {k}: {v:.6f} s")
    print(f"  snapshot bytes a step: {step_bytes}")
    print(f"  pooled drift index round trip: {drift_txt}")
    print(f"  IndexedDataset: {DATASET_SHARDS} shards, "
          f"{ds.shards[0].index.n_leaves} leaves each, mean_reuse "
          f"{ds.mean_reuse:.6f}, rebuilds {rebuilt}; live keys in the "
          f"{nq // 4} ranges {in_ranges} / {in_ranges2}")
    h.print_seam()
    print(f"  peak memory allocated (path E): "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")


def _trace_verbs(path, calls: dict) -> dict:
    """Each ``calls[tag]()`` once under ``torch.profiler`` and its own user
    annotation (a synchronise after each), the trace written to ``path``:
    ``_trace_windows``'s wall, busy time and device events per tag."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for tag, fn in calls.items():
            with torch.profiler.record_function(tag):
                fn()
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    del prof
    return _trace_windows(path, tuple(calls))


def _stacked_work(tlk, kt, q, ds, *, n_leaves, route_n, iters, right,
                  rows=False, fence=False, delta=None):
    """Bytes and operations (and sectors) of a shard-stacked call: each
    shard's ``_search_work`` (and ``_delta_work``) on its own queries, over
    its own rows of the stacks ``kt``."""
    parts = []
    for s in range(kt["keys"].shape[0]):
        qs = q[ds == s]
        if not qs.numel():
            continue
        parts.append(_search_work(
            tlk, (kt["roots"][s], kt["mats"][s], kt["vecs"][s]),
            kt["keys"][s], qs, n_leaves=n_leaves, route_n=route_n,
            iters=iters,
            right=right, rows=rows,
            fence=kt["fences"][s] if fence else None))
        if delta is not None:
            parts.append(_delta_work(tlk, delta[s], qs, right))
    # the shard ids, 4 bytes a query
    parts.append((q.shape[0] * 4, 0, q.shape[0] * 4))
    return parts


def _per_shard(call, q, ds, n_shards):
    """``call(s, queries of shard s)`` for each shard, the outputs put back
    in the batch's order: S single-index launches for what one
    shard-stacked launch answers."""
    import torch
    outs = None
    for s in range(n_shards):
        m = torch.nonzero(ds == s).squeeze(1)
        if not m.numel():
            continue
        got = call(s, q[m])
        got = got if isinstance(got, tuple) else (got,)
        if outs is None:
            outs = [torch.zeros(q.shape[:1], dtype=g.dtype,
                                device=q.device) for g in got]
        for o, g in zip(outs, got, strict=True):
            o[m] = g
    return tuple(outs)


def _restack(d):
    """A sharded dynamic index's stack and every position's kernel tables
    and descriptors, brought up to date (what a kernel-path find does
    before its launches)."""
    st = d._stacked()
    for part in st["parts"]:
        d._kernel_args(st, part)
    return st


def _row_ptrs(st) -> dict:
    """The addresses of every position's row tensors of a stack: a row
    restack writes them in place (its descriptors, which point into them,
    are built anew)."""
    import torch
    out = {}
    for i, part in enumerate(st["parts"]):
        for k, v in part.items():
            if k == "tabs":
                continue
            if isinstance(v, torch.Tensor):
                out[f"p{i}/{k}"] = v.data_ptr()
            elif k in ("root", "leaves"):
                out.update({f"p{i}/{k}.{j}": t.data_ptr()
                            for j, t in enumerate(v)})
            elif k == "packed" and v is not None:
                out.update({f"p{i}/packed/{kk}": t.data_ptr()
                            for kk, t in v.items()})
    return out


def _path_f(args, dev, rows, h) -> None:
    """Phase 10, path F, counted: the sharded index with its ``--shards``
    shards stacked on the card.  A static ``build_sharded`` +
    ``make_lookup_fn`` (the shard-stacked K1); ``Index.build(keys,
    mesh=ShardMesh(S))``: ``find`` (shard-stacked K2), ``find_range`` (K3),
    path A's churn, a skewed ingest into one shard until it migrates,
    planted edges (queries at and beside each split, an index with empty
    shards, +-inf and NaN, a duplicate run at a seam); sharded snapshots
    (blocking, async), restore onto S shards and reshards onto S / 2 and
    2S, a damaged shard file under ``"quarantine"`` and ``"fallback"``;
    a find over ``WIDE_SHARDS`` shards.  Each stacked kernel is held
    against its plain version and S single-index launches (bit for bit),
    its launches counted a call; every answer against the truth."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch.api import Index
    from repro_torch.core import distributed as tdist
    from repro_torch.core import persist as tpersist
    from repro_torch.kernels import lookup as tlk
    from repro_torch.kernels import ops

    f32, f64, i32 = torch.float32, torch.float64, torch.int32
    n, nq, S = args.n, args.queries, args.shards
    L = max(args.n_leaves // S, 64)
    mesh = tdist.ShardMesh(S)
    keys32 = h.lognormal_keys(n)
    keys = keys32.to(f64)
    edges = h.edges_of(keys32)
    h.reset_counters()
    ops.reset_seam()
    steps, per_call = {}, {}
    K = ("sharded_lookup", "sharded_dynamic_lookup", "sharded_dynamic_range")

    def fq(live):
        return h.find_queries(live, edges).to(f32).to(f64)

    def counted(name, fn):
        k0 = tlk.LAUNCHES[name]
        out, dt = _sync_time(fn)
        per_call.setdefault(name, []).append(tlk.LAUNCHES[name] - k0)
        return out, dt

    # ---- 1. the static sharded index: one launch of K1 -------------------
    si, steps["build_sharded"] = _sync_time(
        lambda: tdist.build_sharded(keys, mesh, n_leaves=L, device=dev))
    lookup = tdist.make_lookup_fn(si)
    q = fq(keys)
    ranks, steps["make_lookup_fn lookup"] = counted(
        "sharded_lookup", lambda: lookup(q))
    bounds = torch.as_tensor(tdist.shard_bounds(keys, S), device=dev)
    dest = torch.searchsorted(si.splits, q)
    cap = si.keys.shape[1]
    qf = q.to(f32)
    want = torch.searchsorted(keys32, qf) - bounds[dest] + dest * cap
    _check_equal("make_lookup_fn ranks vs the truth", ranks, want.to(i32))
    static_q = q

    # ---- 2. the dynamic sharded index ------------------------------------
    ix, steps["Index.build (mesh)"] = _sync_time(
        lambda: Index.build(keys, mesh=mesh, n_leaves=L))
    d = ix.backend
    _, steps["restack (cold: the stack and its kernel tables)"] = \
        _sync_time(lambda: _restack(d))
    live = keys
    find_q = fq(live)
    steps["find (built)"], _ = counted(
        "sharded_dynamic_lookup",
        lambda: h.check_find(ix, find_q, "sharded built"))
    lo, hi = h.range_pairs(live)
    steps["find_range (built)"], _ = counted(
        "sharded_dynamic_range",
        lambda: h.check_range(ix, lo, hi, "sharded built"))
    warm = h.uncounted(lambda: {
        "find": _event_ms(lambda: ix.find(find_q), 5, warmup=1),
        "find_range": _event_ms(lambda: ix.find_range(lo, hi), 5,
                                warmup=1)})
    n_ins = min(2_000_000, n // 100)
    _, steps["insert (spread)"] = _sync_time(
        lambda: ix.insert(h.draw(n_ins - n_ins // 20)))
    live = d.live_keys_tensor()
    _, steps["delete"] = _sync_time(
        lambda: ix.delete(h.pick(live, n_ins // 2)))
    live = d.live_keys_tensor()
    find_q = fq(live)
    steps["find (churned)"], _ = counted(
        "sharded_dynamic_lookup",
        lambda: h.check_find(ix, find_q, "sharded churned"))
    lo, hi = h.range_pairs(live)
    steps["find_range (churned)"], _ = counted(
        "sharded_dynamic_range",
        lambda: h.check_range(ix, lo, hi, "sharded churned"))
    # skewed ingest into shard 0's range until the shard migrates
    m0 = d.migrations_incremental + d.migrations_full
    top = float(d.splits[0])
    k_lo = float(keys[0])
    t_skew, batches = 0.0, 0
    while d.migrations_incremental + d.migrations_full == m0:
        if batches == SKEW_BATCHES:
            raise AssertionError(f"{batches} skewed batches ran no "
                                 f"migration: {d.live_counts()}")
        x = (k_lo + (top - k_lo) * torch.rand(
            n // SKEW_CUT, dtype=f64, device=dev, generator=h.g)).to(f32)
        _, dt = _sync_time(functools.partial(ix.insert, x.to(f64)))
        t_skew += dt
        batches += 1
    steps[f"skewed insert ({batches} x {n // SKEW_CUT} keys into shard 0"
          f"'s range)"] = t_skew
    _, steps["restack (after the migration)"] = _sync_time(
        lambda: _restack(d))
    # a duplicate run at a seam: 9 more copies of a split key, one shard
    # touched: its rows rewritten in place
    seam_key = float(d.splits[S // 2 - 1])
    _, steps["insert (a run at a seam)"] = _sync_time(
        lambda: ix.insert(torch.full((9,), seam_key, dtype=f64,
                                     device=dev)))
    ptrs = _row_ptrs(d._stack)
    rows0, full0 = d.restack_rows, d.restack_full
    _, steps["restack (one dirty row)"] = _sync_time(
        lambda: _restack(d))
    if (d.restack_rows - rows0, d.restack_full - full0) != (1, 0) or \
            _row_ptrs(d._stack) != ptrs:
        raise AssertionError("a one-shard insert must rewrite one row of "
                             "the stack in place")
    live = d.live_keys_tensor()
    live32 = live.to(f32)
    sp = torch.as_tensor(d.splits, device=dev).to(f32)
    beside = torch.cat([sp, torch.nextafter(sp, sp + 1), torch.nextafter(
        sp, sp - 1)]).to(f64)
    planted = torch.cat([beside, torch.tensor(
        [float("inf"), float("nan"), float("-inf")], dtype=f64,
        device=dev)])
    find_q = torch.cat([fq(live)[:nq - planted.numel()], planted])
    (found, rank), steps["find (skewed, planted)"] = counted(
        "sharded_dynamic_lookup", lambda: ix.find(find_q))
    fin = torch.isfinite(find_q) | (find_q == float("-inf"))
    fin &= ~torch.isnan(find_q) & (find_q < float("inf"))
    qf = find_q.to(f32)
    w_rank = torch.where(fin, torch.searchsorted(live32, qf), 0).to(i32)
    w_found = fin & (torch.searchsorted(live32, qf, right=True)
                     > torch.searchsorted(live32, qf))
    _check_equal("find (planted) rank", rank, w_rank)
    _check_equal("find (planted) found", found, w_found)
    run = torch.tensor([seam_key], dtype=f64, device=dev)
    rl, rh = ix.find_range(run, run)
    if int(rh - rl) != int((live == seam_key).sum()) or int(rh - rl) < 10:
        raise AssertionError(f"the seam run: {int(rh - rl)} keys")
    lo, hi = h.range_pairs(live)
    lo = torch.cat([lo[:-beside.numel()], beside])
    hi = torch.cat([hi[:-beside.numel()], beside + 1.0])
    _, steps["find_range (skewed, planted)"] = counted(
        "sharded_dynamic_range",
        lambda: h.check_range(ix, lo, hi, "sharded planted"))
    launches = h.counters()
    for k in K:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} never launched on path F: "
                                 f"{launches}")
    for k, v in per_call.items():
        if any(c != 1 for c in v):
            raise AssertionError(f"{k}: launches a call {v}, not 1")
    warm.update(h.uncounted(lambda: {
        "find (skewed)": _event_ms(lambda: ix.find(find_q), 5, warmup=1),
        "find_range (skewed)": _event_ms(lambda: ix.find_range(lo, hi), 5,
                                         warmup=1)}))
    # one warm find and one warm find_range traced: device events (all
    # launches, the stacked kernel's and the epilogue's), busy time, idle
    # share
    traced = h.uncounted(lambda: _trace_verbs(
        ROOT / "build" / "path_f_trace.json",
        {"path F find": lambda: ix.find(find_q),
         "path F find_range": lambda: ix.find_range(lo, hi)}))
    h.notes["path F warm"] = h.uncounted(lambda: {
        "find (skewed)": _verb_ms(lambda: ix.find(find_q)),
        "find_range (skewed)": _verb_ms(lambda: ix.find_range(lo, hi))})
    counters = {k: int(getattr(d, k)) for k in tpersist._IDX_COUNTERS}
    shard_live = d.live_counts().tolist()
    # ---- 3. the stacked kernels against plain and per-shard launches ----
    errs = {}
    st = d._stacked()
    pk, tabs, kw = d._kernel_args(st, st["parts"][0])
    # each stacked kernel's inputs as the path gives them: the batch routed
    # and grouped, non-live queries replaced by their shard's member key;
    # find_range sends its lo and hi endpoints as one batch of point pairs
    _, _, ds, kq, _ = d._grouped(st, find_q)
    kq = kq.to(f32)
    _, _, dsr, kr, _ = d._grouped(st, torch.cat([lo, hi]))
    kr = kr.to(f32)
    tables = (pk["roots"], pk["mats"], pk["vecs"], pk["kf"])
    k2 = lambda: tlk.sharded_dynamic_lookup(kq, ds, *tables, pk["dkf"],
                                            tabs=tabs, **kw)
    k2p = lambda: tlk.sharded_dynamic_lookup_plain(kq, ds, *tables,
                                                   pk["dkf"], **kw)
    k3 = lambda: tlk.sharded_dynamic_range(kr, kr, dsr, *tables, pk["dkf"],
                                           tabs=tabs, **kw)
    k3p = lambda: tlk.sharded_dynamic_range_plain(kr, kr, dsr, *tables,
                                                  pk["dkf"], **kw)
    k2s = lambda: _per_shard(lambda s, x: tlk.dynamic_lookup(
        x, pk["roots"][s], pk["mats"][s], pk["vecs"][s], pk["kf"][s],
        pk["dkf"][s], **kw), kq, ds, S)
    k3s = lambda: _per_shard(lambda s, x: tlk.dynamic_range(
        x, x, pk["roots"][s], pk["mats"][s], pk["vecs"][s], pk["kf"][s],
        pk["dkf"][s], **kw), kr, dsr, S)
    skt = si.kernel_tables()
    _, _, sds, sq, _ = tdist._grouped(si.splits, tdist._member(si.keys[:, 0]),
                                      static_q)
    sq = sq.to(f32)
    skw = dict(n_leaves=L, iters=si.search_iters)
    k1 = lambda: (tlk.sharded_lookup(sq, sds, skt["roots"], skt["mats"],
                                     skt["vecs"], skt["keys"],
                                     tabs=skt["tabs"], **skw),)
    k1p = lambda: (tlk.sharded_lookup_plain(sq, sds, skt["roots"],
                                            skt["mats"], skt["vecs"],
                                            skt["keys"], **skw),)
    k1s = lambda: _per_shard(lambda s, x: tlk.lookup(
        x, skt["roots"][s], skt["mats"][s], skt["vecs"][s], skt["keys"][s],
        rows=skt["rows"][s], fence=skt["fences"][s], **skw), sq, sds, S)

    def check(name, kern, plain, single):
        e = _compare(name, kern, plain)
        e = max(e, _compare(f"{name} vs {S} single-index launches", kern,
                            single))
        errs[name] = e
    h.uncounted(lambda: [check("sharded_lookup", k1, k1p, k1s),
                         check("sharded_dynamic_lookup", k2, k2p, k2s),
                         check("sharded_dynamic_range", k3, k3p, k3s)])

    # an index with empty shards on the card: K2 / K3 and the answers
    tiny = torch.tensor([1.0, 2.0, 5.0, 9.0, 12.0], dtype=f64, device=dev)
    tix = Index.build(tiny, mesh=mesh, n_leaves=16)
    tq = torch.tensor([0.5, 1.0, 2.0, 3.0, 9.0, 12.0, 100.0, float("inf"),
                       float("nan"), float("-inf")], dtype=f64, device=dev)
    tf, tr = tix.find(tq)
    _check_equal("empty shards: rank", tr, torch.tensor(
        [0, 0, 1, 2, 3, 4, 5, 0, 0, 0], dtype=i32, device=dev))
    _check_equal("empty shards: found", tf, torch.tensor(
        [False, True, True, False, True, True, False, False, False, False],
        device=dev))
    tst = tix.backend._stacked()
    tpk, ttabs, tkw = tix.backend._kernel_args(tst, tst["parts"][0])
    _, _, tds, tqf, _ = tix.backend._grouped(tst, tq)
    tqf = tqf.to(f32)
    ttables = (tpk["roots"], tpk["mats"], tpk["vecs"], tpk["kf"])
    errs["sharded_dynamic_lookup"] = max(errs["sharded_dynamic_lookup"],
                                         h.uncounted(lambda: _compare(
        "sharded_dynamic_lookup (empty shards)",
        lambda: tlk.sharded_dynamic_lookup(tqf, tds, *ttables, tpk["dkf"],
                                           tabs=ttabs, **tkw),
        lambda: tlk.sharded_dynamic_lookup_plain(tqf, tds, *ttables,
                                                 tpk["dkf"], **tkw))))
    empty_txt = (f"shards {tix.backend.live_counts().tolist()}, splits "
                 f"{tix.backend.splits.tolist()}")
    del tix, tst, tpk, ttabs

    # the kernels line's rows: this run's inputs, timed
    w1 = _stacked_work(tlk, skt, sq, sds, n_leaves=L, route_n=cap,
                       iters=si.search_iters, right=False, rows=True,
                       fence=True)
    kt2 = dict(roots=pk["roots"], mats=pk["mats"], vecs=pk["vecs"],
               keys=pk["kf"])
    w2 = _stacked_work(tlk, kt2, kq, ds, n_leaves=L, route_n=L,
                       iters=st["iters"], right=False, delta=pk["dkf"])
    w3 = (_stacked_work(tlk, kt2, kr, dsr, n_leaves=L, route_n=L,
                        iters=st["iters"], right=False, delta=pk["dkf"])
          + _stacked_work(tlk, kt2, kr, dsr, n_leaves=L, route_n=L,
                          iters=st["iters"], right=True, delta=pk["dkf"]))
    lib = {"sharded_lookup": lambda: torch.searchsorted(keys32, sq),
           "sharded_dynamic_lookup": lambda: torch.searchsorted(live32, kq),
           "sharded_dynamic_range": lambda: (
               torch.searchsorted(live32, kr),
               torch.searchsorted(live32, kr, right=True))}
    for name, kern, plain, work in (("sharded_lookup", k1, k1p, w1),
                                    ("sharded_dynamic_lookup", k2, k2p, w2),
                                    ("sharded_dynamic_range", k3, k3p, w3)):
        rows[name] = _time_row(name, kern, plain, lib[name], work,
                               launches[name], errs[name], plain_reps=3)
        rows[name]["single_launches_ms"] = _event_ms(
            {"sharded_lookup": k1s, "sharded_dynamic_lookup": k2s,
             "sharded_dynamic_range": k3s}[name], 5, warmup=1)

    # ---- 4. snapshots, restore, reshard, a damaged shard ------------------
    store_dir = ROOT / "build"
    store_dir.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="path_f_store_", dir=store_dir)
    print(f"  snapshot store {Path(tmp).relative_to(ROOT)}: "
          f"{shutil.disk_usage(tmp).free / 2**30:.3f} GiB free")
    times, reshard = {}, {}
    try:
        store = tpersist.SnapshotStore(tmp)
        _, times["snapshot_sharded step 1 (blocking)"] = _sync_time(
            lambda: ix.snapshot(store, 1))
        q1 = fq(live)
        lo1, hi1 = h.range_pairs(live)
        ans1 = ix.find(q1) + ix.find_range(lo1, hi1)
        ix.insert(h.draw(n_ins))
        t0 = time.perf_counter()
        ix.snapshot(store, 2, blocking=False)
        times["snapshot_sharded step 2 (async): return"] = \
            time.perf_counter() - t0
        store.wait()
        times["snapshot_sharded step 2 (async): until written"] = \
            time.perf_counter() - t0
        step_bytes = {s: _dir_bytes(store._step_dir(s))
                      for s in store.steps()}
        live2 = d.live_keys_tensor()
        q2 = fq(live2)
        lo2, hi2 = h.range_pairs(live2)
        ans2 = ix.find(q2) + ix.find_range(lo2, hi2)
        for m in (S, S // 2, 2 * S):
            (rix, rep), dt = _sync_time(functools.partial(
                tpersist.restore_sharded, store, tdist.ShardMesh(m)))
            times[f"restore_sharded onto {m} shards"] = dt
            if rep.step != 2 or rix.n_shards != m:
                raise AssertionError(f"restore onto {m}: {rep}")
            got = rix.find(q2) + rix.find_range(lo2, hi2)
            for i, (x, y) in enumerate(zip(got, ans2, strict=True)):
                _check_equal(f"restored onto {m} [{i}] vs the live index",
                             x, y)
            if m != S:
                if rep.reshard.full_rebuilds != 0:
                    raise AssertionError(f"reshard {S} -> {m}: {rep.reshard}")
                reshard[m] = dataclasses.asdict(rep.reshard)
            del rix, got
            torch.cuda.empty_cache()
        # a flipped byte in one shard file of step 2
        bad = min(3, S - 1)
        path = os.path.join(store._step_dir(2), f"shard_{bad:05d}.npz")
        with open(path, "r+b") as fh:
            fh.seek(os.path.getsize(path) // 2)
            b = fh.read(1)
            fh.seek(-1, os.SEEK_CUR)
            fh.write(bytes([b[0] ^ 0xFF]))
        (qix, rep), times["restore_sharded (quarantine)"] = _sync_time(
            lambda: tpersist.restore_sharded(store, mesh,
                                             on_corrupt="quarantine"))
        if qix.quarantined != [bad] or rep.step != 2:
            raise AssertionError(f"quarantine: {qix.quarantined} {rep}")
        qfound, qrank = qix.find(q2)
        spl = torch.as_tensor(d.splits, device=dev)
        mine = (q2 > (spl[bad - 1] if bad else -float("inf"))) \
            & (q2 <= spl[bad])
        if bool(qfound[mine].any()) or not torch.equal(qfound[~mine],
                                                       ans2[0][~mine]):
            raise AssertionError("quarantined shard's range must answer "
                                 "found False, the rest as before")
        del qix, qfound, qrank
        (fix, rep), times["restore_sharded (fallback to step 1)"] = \
            _sync_time(lambda: tpersist.restore_sharded(store, mesh))
        if rep.step != 1:
            raise AssertionError(f"fallback served step {rep.step}")
        got = fix.find(q1) + fix.find_range(lo1, hi1)
        for i, (x, y) in enumerate(zip(got, ans1, strict=True)):
            _check_equal(f"fallback restore [{i}] vs step 1's answers", x, y)
        del fix, got
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    peak_main = torch.cuda.max_memory_allocated() / 2**30
    del ix, d, si, lookup, st, pk, tabs, skt, live, live2, live32
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 5. a wide stack: one launch whatever the shard count ------------
    nw = n // WIDE_CUT
    wkeys = h.lognormal_keys(nw).to(f64)
    wix, steps[f"Index.build ({WIDE_SHARDS} shards, {nw} keys)"] = \
        _sync_time(lambda: Index.build(wkeys, mesh=tdist.ShardMesh(
            WIDE_SHARDS), n_leaves=max(args.n_leaves // WIDE_SHARDS // 4,
                                       64)))
    wq = fq(wkeys)
    h.check_find(wix, wq, "wide")
    k0 = tlk.LAUNCHES["sharded_dynamic_lookup"]
    wix.find(wq)
    wide_launches = tlk.LAUNCHES["sharded_dynamic_lookup"] - k0
    if wide_launches != 1:
        raise AssertionError(f"{WIDE_SHARDS} shards: {wide_launches} "
                             f"launches a find")
    wide_ms = _event_ms(lambda: wix.find(wq), 5, warmup=1)
    del wix, wkeys, wq

    print(f"phase 10: path F (the sharded index, {S} shards, {L} leaves a "
          f"shard) ok on {_card()}; n={n}; launches {launches}; launches a "
          f"call "
          f"{ {k: sorted(set(v)) for k, v in per_call.items()} }; the "
          f"stacked K1-K3 equal their plain versions and {S} single-index "
          f"launches bit for bit (tolerance 0): {errs}")
    h.print_steps(steps)
    print("  warm (no restack), CUDA-event means of 5 calls: " + ", ".join(
        f"{k} {v:.6f} ms" for k, v in warm.items()))
    for tag, w in traced.items():
        print(f"  traced {tag} (warm, {nq} queries): wall {w['wall']:.6f} s, "
              f"device busy {w['busy']:.6f} s, idle share "
              f"{1 - w['busy'] / w['wall']:.6f}, {w['events']} device "
              f"events (the stacked kernel one of them)")
    print(f"  counters after the churn and the skewed ingest: {counters}; "
          f"live keys a shard {shard_live}")
    print(f"  the index with empty shards: {empty_txt}")
    for k, v in times.items():
        print(f"  {k}: {v:.6f} s")
    print(f"  snapshot bytes a step: {step_bytes}")
    for m, v in reshard.items():
        print(f"  ReshardStats {S} -> {m}: {v}")
    print(f"  {WIDE_SHARDS} shards over {nw} keys: {wide_launches} launch "
          f"a find, find {wide_ms:.6f} ms")
    for name in K:
        print(f"  {name}: {S} single-index launches "
              f"{rows[name]['single_launches_ms']:.6f} ms against one "
              f"stacked launch {rows[name]['ms']:.6f} ms")
    h.print_seam()
    print(f"  peak memory allocated (path F): {peak_main:.3f} GiB")


def _above(top: float, m: int):
    """``m`` distinct f32-exact keys above ``top``, increasing (steps of
    2^-20 relative, wider than an f32 ulp)."""
    import numpy as np
    v = np.float32(top) * (1.0 + np.arange(1, m + 1) * 2.0 ** -20)
    return v.astype(np.float32).astype(np.float64)


def _singletons(live32, m: int, g):
    """``m`` live keys that occur once (deleting one leaves none), from the
    top percent of the keys: in the sparse tail, where f32 lognormal keys
    rarely repeat."""
    import torch
    n = live32.shape[0]
    i = torch.randint(n - max(n // 100, 16 * m), n, (16 * m,),
                      device=live32.device, generator=g)
    c = live32[i]
    one = (torch.searchsorted(live32, c, right=True)
           - torch.searchsorted(live32, c)) == 1
    c = torch.unique(c[one])[:m]
    if c.numel() < m:
        raise AssertionError(f"only {c.numel()} singleton keys drawn")
    return c.cpu().numpy().astype("float64")


def _percentiles(lat_ms):
    import numpy as np
    return float(np.percentile(lat_ms, 50)), float(np.percentile(lat_ms, 99))


def _path_g(args, dev, rows, h) -> None:
    """Phase 11, path G, counted: the index service.  Two tenants behind
    one ``BatchingFrontend`` (``ServeConfig(latency_budget_s=2e-3)``):
    tenant A ``--n`` lognormal(0, 1) keys, tenant B ``G_B_KEYS``
    lognormal(0.5, 0.8) keys, each in ``--shards`` shards (A at path F's
    leaves a shard, B at a sixteenth of them), f32-exact.  The pack
    against each tenant's own ``find`` / ``find_range`` and the truth; the
    stacked K2 / K3 against their plain versions on the pack's T x S
    descriptors; one launch a batch at live sizes ``G_BATCH_SIZES``;
    deletes through the queue; a closed loop of full batches; open-loop
    Poisson drives at ``G_RATES`` (single-key finds 70/30 over the
    tenants, ``G_RANGE_SHARE`` range requests, ``G_INSERT_SHARE`` insert
    requests of keys above each tenant's largest, so that no answer's
    truth moves during a drive), the first ``G_RATES_ALWAYS`` rates always,
    then until p99 passes ``G_P99_LIMIT`` budgets;
    one saturated second traced; every inserted key found and every
    deleted one not.  Then ``DynamicPageTable`` at path D's page geometry,
    over one index and over 2 shards: K2 (held against its plain version
    on the lookup's keys) for requests 0-3, the f64 path once requests 4-7
    are in."""
    import numpy as np
    import torch
    from repro_torch.api import Index
    from repro_torch.core import distributed as tdist
    from repro_torch.kernels import lookup as tlk
    from repro_torch.kernels import ops
    from repro_torch.serve import frontend as tfe
    from repro_torch.serve import kvcache as tkv

    f32, f64 = torch.float32, torch.float64
    n, S = args.n, args.shards
    L_A = max(args.n_leaves // S, 64)
    L_B = max(L_A // 16, 16)
    n_b = min(G_B_KEYS, max(n // 8, 1 << 12))
    mesh = tdist.ShardMesh(S)
    rng = np.random.default_rng(args.seed)
    h.reset_counters()
    ops.reset_seam()
    steps = {}
    K2, K3 = "sharded_dynamic_lookup", "sharded_dynamic_range"

    # ---- 1. two tenants and the pack ---------------------------------------
    keys = h.lognormal_keys(n).to(f64)
    ta, steps["Index.build (tenant A)"] = _sync_time(
        lambda: Index.build(keys, mesh=mesh, n_leaves=L_A).backend)
    del keys
    keys = torch.sort(torch.empty(n_b, dtype=f32, device=dev).log_normal_(
        0.5, 0.8, generator=h.g)).values.to(f64)
    tb, steps["Index.build (tenant B)"] = _sync_time(
        lambda: Index.build(keys, mesh=mesh, n_leaves=L_B).backend)
    del keys
    tenants = [ta, tb]
    T = len(tenants)
    fe = tfe.BatchingFrontend(tenants, config=tfe.ServeConfig(
        latency_budget_s=G_BUDGET_S))
    if not fe.pack.use_kernel:
        raise AssertionError("path G's pack must take the kernel path")
    lives = [t.live_keys_tensor().to(f32) for t in tenants]

    def truth(t, q):
        """(found, rank) of f64 queries of tenant t, on the card."""
        qf = torch.as_tensor(q, device=dev).to(f32)
        lo = torch.searchsorted(lives[t], qf)
        return (torch.searchsorted(lives[t], qf, right=True) > lo,
                lo.to(torch.int32))

    def range_truth(t, lo, hi):
        el = truth(t, lo)[1]
        return el, torch.maximum(torch.searchsorted(
            lives[t], torch.as_tensor(hi, device=dev).to(f32),
            right=True).to(torch.int32), el)

    def matrices(width):
        """A (T, width) batch of members, misses and pads (0.0), the
        splits and their f32 neighbours; its [lo | hi] range matrix."""
        qs = []
        for t in range(T):
            sp = torch.as_tensor(tenants[t].splits, device=dev).to(f32)
            fixed = torch.cat([sp, torch.nextafter(sp, sp + 1),
                               torch.nextafter(sp, sp - 1)]).to(f64)
            q = torch.cat([fixed, torch.zeros(width // 16, dtype=f64,
                                              device=dev),
                           h.draw(width // 4)])
            q = torch.cat([q, h.pick(lives[t], width - q.numel()).to(f64)])
            qs.append(q[torch.randperm(width, device=dev, generator=h.g)])
        qmat = torch.stack(qs)
        hi = (qmat + torch.empty_like(qmat).exponential_(
            500.0, generator=h.g)).to(f32).to(f64)
        hi[:, :width // 64] = qmat[:, :width // 64] - 0.5   # lo > hi
        return qmat, torch.cat([qmat, hi], 1)

    _, steps["warmup (pack assembly, every class)"] = _sync_time(
        lambda: fe.warmup(G_BATCH_SIZES))
    pk = fe.pack._st
    slot_t = [sum(int(d.index.keys.shape[0]) * 17 for d in t.shards)
              + t.n_shards * t._stack["bcap"] * 17 for t in tenants]
    slot_p = T * S * (pk["bcap"] * 8 + pk["dcap"] * 8)
    mem_txt = (f"reckoned: tenant A {slot_t[0] / 2**30:.3f} GiB, tenant B "
               f"{slot_t[1] / 2**30:.3f} GiB (shards and stack, 17 B a "
               f"slot), pack {slot_p / 2**30:.3f} GiB ({T} x {S} rows of "
               f"{pk['bcap']} base and {pk['dcap']} delta slots, 8 B a slot:"
               f" f32 key, prefix sum); {torch.cuda.memory_allocated() / 2**30:.3f}"
               f" GiB allocated after warmup")

    # ---- 2. the pack against each tenant's own answers and the truth ------
    errs = {}
    qmat, rmat = matrices(4096)
    W = qmat.shape[1]
    k0 = dict(tlk.LAUNCHES)
    (f, r), steps["pack find (2 x 4,096)"] = _sync_time(
        lambda: fe.pack.find(qmat))
    (rl, rh), steps["pack find_range (2 x 4,096 pairs)"] = _sync_time(
        lambda: fe.pack.find_range(rmat))
    direct = {k: tlk.LAUNCHES[k] - k0[k] for k in (K2, K3)}
    if direct != {K2: 1, K3: 1}:
        raise AssertionError(f"the pack's find and range: launches {direct}")

    def own(t):
        return tenants[t].find(qmat[t]) + tenants[t].find_range(
            rmat[t, :W], rmat[t, W:])
    for t in range(T):
        got = (f[t], r[t], rl[t], rh[t])
        for i, (x, y) in enumerate(zip(
                got, h.uncounted(functools.partial(own, t)), strict=True)):
            _check_equal(f"tenant {t} pack vs own [{i}]", x, y)
        for i, (x, y) in enumerate(zip(got, truth(t, qmat[t])
                                       + range_truth(t, rmat[t, :W],
                                                     rmat[t, W:]),
                                       strict=True)):
            _check_equal(f"tenant {t} pack vs truth [{i}]", x, y)
    # the stacked kernels on the pack's T x S descriptors, bit for bit
    tables, _, tabs, kw = tdist._tenant_kernel_args(pk, pk["parts"][0])
    kt = tables[:4]
    dkf = tables[5]
    _, ds, kq, _ = tdist._tenant_grouped(pk, qmat)
    _, dsr, kr, _ = tdist._tenant_grouped(pk, rmat)
    kq, kr = kq.to(f32), kr.to(f32)
    if set(ds.unique().tolist()) != set(range(T * S)):
        raise AssertionError("the checked batch must reach every row")
    errs[K2] = h.uncounted(lambda: _compare(
        f"{K2} (tenant pack, {T * S} rows)",
        lambda: tlk.sharded_dynamic_lookup(kq, ds, *kt, dkf, tabs=tabs, **kw),
        lambda: tlk.sharded_dynamic_lookup_plain(kq, ds, *kt, dkf, **kw)))
    errs[K3] = h.uncounted(lambda: _compare(
        f"{K3} (tenant pack, {T * S} rows)",
        lambda: tlk.sharded_dynamic_range(kr, kr, dsr, *kt, dkf, tabs=tabs,
                                          **kw),
        lambda: tlk.sharded_dynamic_range_plain(kr, kr, dsr, *kt, dkf,
                                                **kw)))
    kernel_ms = h.uncounted(lambda: {
        K2: _event_ms(lambda: tlk.sharded_dynamic_lookup(
            kq, ds, *kt, dkf, tabs=tabs, **kw), 20),
        K3: _event_ms(lambda: tlk.sharded_dynamic_range(
            kr, kr, dsr, *kt, dkf, tabs=tabs, **kw), 20)})
    pack_errs = dict(errs)
    del qmat, rmat, f, r, rl, rh, kq, kr, ds, dsr

    # ---- 3. one launch a batch, whatever the live batch size ---------------
    fe.start()
    per_batch = {"find": set(), "range": set()}
    for sz in G_BATCH_SIZES:
        for t in range(T):
            q = h.pick(lives[t], sz).to(f64)
            k0 = tlk.LAUNCHES[K2]
            found, rank = fe.lookup(t, q.cpu().numpy(), timeout=120.0)
            per_batch["find"].add(tlk.LAUNCHES[K2] - k0)
            wf, wr = truth(t, q)
            _check_equal(f"G find t{t} sz {sz}", torch.as_tensor(rank,
                         device=dev), wr)
            _check_equal(f"G found t{t} sz {sz}", torch.as_tensor(found,
                         device=dev), wf)
            hi = (q + 0.01).to(f32).to(f64)
            k0 = tlk.LAUNCHES[K3]
            rlo, rhi = fe.scan(t, q.cpu().numpy(), hi.cpu().numpy(),
                               timeout=120.0)
            per_batch["range"].add(tlk.LAUNCHES[K3] - k0)
            for x, y in zip((rlo, rhi), range_truth(t, q, hi), strict=True):
                _check_equal(f"G range t{t} sz {sz}",
                             torch.as_tensor(x, device=dev), y)
    if per_batch != {"find": {1}, "range": {1}}:
        raise AssertionError(f"launches a batch {per_batch}, not 1")

    # ---- 4. deletes through the queue, then the drives ---------------------
    deleted = [_singletons(lives[t], 64, h.g) for t in range(T)]
    for t in range(T):
        fe.submit(tfe.Request(t, "delete", deleted[t])).result(timeout=120.0)
    inserted = [[] for _ in range(T)]

    def refresh_truth():
        for t in range(T):
            lives[t] = tenants[t].live_keys_tensor().to(f32)
    refresh_truth()
    pools = [h.pick(lives[t], 1 << 20).to(f64).cpu().numpy()
             for t in range(T)]
    # closed loop of full batches, one request in flight
    arrays = [(t, pools[t][i * 4096:(i + 1) * 4096])
              for i in range(8) for t in range(T)]
    want = [truth(t, a)[1].cpu().numpy() for t, a in arrays]
    fe.stats = tfe.FrontendStats()
    k0 = dict(tlk.LAUNCHES)
    i, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < G_CLOSED_S:
        t, a = arrays[i % len(arrays)]
        found, rank = fe.lookup(t, a, timeout=120.0)
        if not found.all() or not np.array_equal(rank, want[i % len(arrays)]):
            raise AssertionError(f"closed loop batch {i}: wrong answers")
        i += 1
    closed_s = time.perf_counter() - t0
    closed = dict(batches=i, seconds=closed_s, batches_per_s=i / closed_s,
                  keys_per_s=4096 * i / closed_s,
                  launches=tlk.LAUNCHES[K2] - k0[K2],
                  stats_batches=fe.stats.batches)
    if closed["launches"] != i or fe.stats.batches != i:
        raise AssertionError(f"closed loop: {closed}")

    drives = []
    for rate in G_RATES:
        gaps = rng.exponential(1.0 / rate, int(rate * G_DRIVE_S * 1.5) + 16)
        arr = np.cumsum(gaps)
        arr = arr[arr < G_DRIVE_S]
        u = rng.random(arr.size)
        tid = (rng.random(arr.size) < 0.3).astype(int)
        tops = [float(lives[t][-1]) for t in range(T)]
        n_ins = [int(((u >= 1 - G_INSERT_SHARE) & (tid == t)).sum())
                 for t in range(T)]
        fresh = [_above(tops[t], max(n_ins[t], 1) * G_INSERT_KEYS)
                 for t in range(T)]
        picks = [0, 0]
        reqs = []
        for j in range(arr.size):
            t = int(tid[j])
            if u[j] < G_RANGE_SHARE:
                lo = pools[t][rng.integers(0, pools[t].size, G_RANGE_PAIRS)]
                hi = np.minimum(lo + rng.exponential(0.002, lo.size),
                                tops[t]).astype(np.float32).astype(
                                    np.float64)
                reqs.append(tfe.Request(t, "range", np.stack([lo, hi])))
            elif u[j] >= 1 - G_INSERT_SHARE:
                k = fresh[t][picks[t]:picks[t] + G_INSERT_KEYS]
                picks[t] += G_INSERT_KEYS
                inserted[t].append(k)
                reqs.append(tfe.Request(t, "insert", k))
            else:
                reqs.append(tfe.Request(t, "find", pools[t][
                    rng.integers(0, pools[t].size, 1)]))
        fe.stats = tfe.FrontendStats()
        k0 = dict(tlk.LAUNCHES)
        pr0, pf0 = fe.pack.pack_rows, fe.pack.pack_full
        t0 = fe.clock()
        for dt, req in zip(arr, reqs, strict=True):
            lag = (t0 + dt) - fe.clock()
            if lag > 0:
                time.sleep(lag)
            req.arrival = t0 + dt
            fe.submit(req)
        for req in reqs:
            req.result(timeout=300.0)
        lat = np.asarray([req.done_at - req.arrival for req in reqs]) * 1e3
        span = max(req.done_at for req in reqs) - t0
        st = fe.stats
        p50, p99 = _percentiles(lat)
        kinds = {k: [r for r in reqs if r.kind == k] for k in
                 ("find", "range", "insert")}
        drives.append(dict(
            offered=rate, requests=len(reqs), sustained=len(reqs) / span,
            p50_ms=p50, p99_ms=p99,
            find_p99_ms=_percentiles(np.asarray(
                [r.done_at - r.arrival for r in kinds["find"]]) * 1e3)[1],
            batches=st.batches,
            keys_per_batch=(st.queries + 2 * st.ranges) / max(st.batches, 1),
            pad_fraction=st.pad_fraction, qcaps=sorted(st.qcaps),
            launches={k: tlk.LAUNCHES[k] - k0[k] for k in (K2, K3)},
            pack_rows=fe.pack.pack_rows - pr0,
            pack_full=fe.pack.pack_full - pf0, swaps=st.swaps,
            updates=st.updates,
            kinds={k: len(v) for k, v in kinds.items()}))
        # every answer against the truth: inserted keys lie above each
        # tenant's largest key, so no find's or range's truth moved
        for t in range(T):
            fq = [r for r in kinds["find"] if r.tenant == t]
            if fq:
                q = np.concatenate([r.keys for r in fq])
                wf, wr = truth(t, q)
                _check_equal(f"drive {rate}: t{t} found", torch.as_tensor(
                    np.concatenate([r.found for r in fq]), device=dev), wf)
                _check_equal(f"drive {rate}: t{t} rank", torch.as_tensor(
                    np.concatenate([r.rank for r in fq]), device=dev), wr)
            rq = [r for r in kinds["range"] if r.tenant == t]
            if rq:
                el, eh = range_truth(t, np.concatenate(
                    [r.keys[0] for r in rq]), np.concatenate(
                    [r.keys[1] for r in rq]))
                _check_equal(f"drive {rate}: t{t} rank_lo", torch.as_tensor(
                    np.concatenate([r.rank_lo for r in rq]), device=dev), el)
                _check_equal(f"drive {rate}: t{t} rank_hi", torch.as_tensor(
                    np.concatenate([r.rank_hi for r in rq]), device=dev), eh)
        lb = drives[-1]["launches"]
        if max(lb.values()) > st.batches or sum(lb.values()) < st.batches:
            raise AssertionError(f"drive {rate}: {lb} launches in "
                                 f"{st.batches} batches")
        refresh_truth()
        del reqs, kinds
        if len(drives) >= G_RATES_ALWAYS and \
                p99 > G_P99_LIMIT * G_BUDGET_S * 1e3:
            break

    # one saturated second traced: a closed loop, two requests in flight
    def saturated():
        pend = [fe.submit_find(*arrays[0]), fe.submit_find(*arrays[1])]
        j, t1 = 2, time.perf_counter()
        while time.perf_counter() - t1 < 1.0:
            pend.pop(0).result(timeout=120.0)
            pend.append(fe.submit_find(*arrays[j % len(arrays)]))
            j += 1
        for p in pend:
            p.result(timeout=120.0)
        return j
    fe.stats = tfe.FrontendStats()
    (ROOT / "build").mkdir(exist_ok=True)
    traced_path = ROOT / "build" / "path_g_trace.json"
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("path G saturated"):
            sat_requests = saturated()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(traced_path))
    host_top = [(e.key, e.self_cpu_time_total / 1e3, e.count) for e in sorted(
        prof.key_averages(), key=lambda e: e.self_cpu_time_total,
        reverse=True)[:12]]
    del prof
    traced = _trace_windows(traced_path, ("path G saturated",))[
        "path G saturated"]
    traced["batches"] = fe.stats.batches
    traced["requests"] = sat_requests
    # the same saturated second untraced, each stage of a batch bracketed
    # by synchronisations: inclusive seconds a stage
    fe.stats = tfe.FrontendStats()
    with contextlib.ExitStack() as stack:
        stages = [stack.enter_context(_Stages(m, names)) for m, names in (
            (tfe.BatchingFrontend, ("_apply_updates", "_dispatch",
                                    "_resolve")),
            (tfe.TenantPack, ("_refresh",)),
            (tdist, ("_tenant_grouped", "_scatter_back")),
            (tlk, (K2,)), (ops, ("_seam_fix", "_two_tier_find")))]
        t1 = time.perf_counter()
        staged_requests = saturated()
        staged_s = time.perf_counter() - t1
    staged = dict(seconds=staged_s, requests=staged_requests,
                  batches=fe.stats.batches,
                  secs={k: v for sg in stages for k, v in sg.secs.items()})

    # ---- 5. the queue's updates, seen ----------------------------------------
    for t in range(T):
        ins = np.concatenate(inserted[t]) if inserted[t] else np.zeros(0)
        if ins.size:
            found, _ = fe.lookup(t, ins, timeout=120.0)
            if not found.all():
                raise AssertionError(f"tenant {t}: {int((~found).sum())} "
                                     f"inserted keys not found")
        found, _ = fe.lookup(t, deleted[t], timeout=120.0)
        if found.any():
            raise AssertionError(f"tenant {t}: deleted keys found")
    fe.stop()
    launches = h.counters()
    seam = ops.SEAM["misses"], ops.SEAM["calls"]
    counters = [dict(live=t.total_live, restack_rows=t.restack_rows,
                     restack_full=t.restack_full,
                     rebuilds=sum(d.rebuilds for d in t.shards))
                for t in tenants]
    pack_counts = (fe.pack.pack_rows, fe.pack.pack_full)
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_ins = [sum(a.size for a in inserted[t]) for t in range(T)]
    del fe, tenants, ta, tb, lives, pk, tables, kt, dkf, tabs, pools
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 6. the dynamic page table at path D's page geometry --------------
    blocks = (LM_PROMPT_LEN + LM_NEW_TOKENS) // 16 + 1
    pq = [(int(r) << 22) | int(b) for r, b in zip(
        rng.integers(0, 2 * LM_REQUESTS, 1 << 16),
        rng.integers(0, blocks + 4, 1 << 16), strict=True)]
    pq = np.asarray(pq, np.float64)
    tables_g, pt_errs = {}, {}
    for tag, pmesh, kname in (("one index", None, "dynamic_lookup"),
                              ("2 shards", tdist.ShardMesh(2), K2)):
        cache = tkv.PagedKVCache(n_pages=2 * LM_REQUESTS * blocks,
                                 page_size=16, n_kv_heads=8, head_dim=128,
                                 n_layers=1, device=dev)
        for req in range(LM_REQUESTS):
            cache.allocate_batch(req, range(blocks))
        pt = tkv.DynamicPageTable.build(cache, mesh=pmesh)
        for stage in ("requests 0-3", "requests 0-7 less 1"):
            if stage != "requests 0-3":
                for req in range(LM_REQUESTS, 2 * LM_REQUESTS):
                    pt.allocate(req, range(blocks))
                pt.release(1)
            k0 = tlk.LAUNCHES[kname]
            found, page = pt.lookup(pq)
            got_launches = tlk.LAUNCHES[kname] - k0
            want = [cache.table.get((int(k) >> 22, int(k) & ((1 << 22) - 1)))
                    for k in pq]
            wf = np.asarray([w is not None for w in want])
            if not np.array_equal(found, wf) or not np.array_equal(
                    page[wf], np.asarray([w for w in want if w is not None])):
                raise AssertionError(f"page table ({tag}, {stage}) wrong")
            exact = bool(pt.dyn.f32_exact)
            if exact:
                # the kernel on this lookup's own inputs, before its timing
                q = torch.as_tensor(pq, device=dev)
                what = f"page table, {tag}, {stage}"
                e = h.uncounted(
                    lambda: _stacked_k2_vs_plain(pt.dyn, q, what)
                    if pmesh is not None else
                    _k23_vs_plain(pt.dyn, q, None, None, what)[kname])
                errs[kname] = max(errs.get(kname, 0), e)
                pt_errs[(tag, stage)] = e
            ms = np.mean([_sync_time(functools.partial(pt.lookup, pq))[1]
                          for _ in range(5)]) * 1e3
            if got_launches != (1 if exact else 0):
                raise AssertionError(f"page table ({tag}, {stage}): "
                                     f"{got_launches} launches, f32-exact "
                                     f"{exact}")
            tables_g[(tag, stage)] = dict(
                f32_exact=exact, path="kernel" if exact else "f64",
                launches=got_launches, ms=ms, found=int(wf.sum()),
                err=pt_errs.get((tag, stage)), stats=pt.maintenance_stats())
        del pt, cache
    launches_pt = {k: v - launches[k] for k, v in h.counters().items()
                   if v != launches[k]}
    for k, v in launches_pt.items():
        launches[k] += v

    for name in (K2, K3, "dynamic_lookup"):
        rows[name]["launches"] += launches[name]
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                        errs.get(name, 0))
    card = _card()
    print(f"phase 11: path G (the index service: {T} tenants x {S} shards, "
          f"{L_A} / {L_B} leaves a shard) ok on {card}; tenant A n={n}, "
          f"tenant B n={n_b}; launches {launches}; the stacked K2 / K3 on "
          f"the pack's {T * S} descriptors equal their plain versions bit "
          f"for bit (tolerance 0): {pack_errs}; pack find / range launches "
          f"{direct}; launches a batch at live sizes {G_BATCH_SIZES}: "
          f"{ {k: sorted(v) for k, v in per_batch.items()} }")
    h.print_steps(steps)
    print(f"  stacked K2 on the pack (2 x 4,096 queries, {T * S} rows): "
          f"{kernel_ms[K2]:.6f} ms; stacked K3 (2 x 8,192 endpoints): "
          f"{kernel_ms[K3]:.6f} ms (CUDA events, 20 calls)")
    print(f"  memory: {mem_txt}; peak allocated (path G) {peak:.3f} GiB")
    print(f"  closed loop, full 4,096-key batches, one in flight: "
          f"{closed['batches']} batches in {closed['seconds']:.6f} s, "
          f"{closed['batches_per_s']:.3f} batches/s, "
          f"{closed['keys_per_s']:.1f} keys/s, {closed['launches']} stacked "
          f"K2 launches")
    for dv in drives:
        print(f"  drive offered {dv['offered']} req/s: {dv['requests']} "
              f"requests {dv['kinds']}, sustained {dv['sustained']:.3f} "
              f"req/s, p50 {dv['p50_ms']:.6f} ms, p99 {dv['p99_ms']:.6f} ms "
              f"(finds p99 {dv['find_p99_ms']:.6f} ms), {dv['batches']} "
              f"batches, {dv['keys_per_batch']:.3f} keys a batch, pad "
              f"fraction {dv['pad_fraction']:.6f}, classes {dv['qcaps']}, "
              f"launches {dv['launches']} (a batch: "
              f"{dv['launches'][K2] / max(dv['batches'], 1):.6f} K2, "
              f"{dv['launches'][K3] / max(dv['batches'], 1):.6f} K3), "
              f"pack_rows {dv['pack_rows']}, pack_full "
              f"{dv['pack_full']}, swaps {dv['swaps']}, update keys "
              f"{dv['updates']}")
    last = drives[-1]
    stop = "p99 over the limit" if last["p99_ms"] > \
        G_P99_LIMIT * G_BUDGET_S * 1e3 else "every rate within the limit"
    print(f"  drives stopped at {last['offered']} req/s ({stop}: "
          f"{G_P99_LIMIT} x the {G_BUDGET_S * 1e3:.1f} ms budget; the first "
          f"{G_RATES_ALWAYS} rates always run)")
    print(f"  traced saturated second ({traced['requests']} requests of "
          f"4,096 keys, {traced['batches']} batches): wall "
          f"{traced['wall']:.6f} s, device busy {traced['busy']:.6f} s, "
          f"idle share {1 - traced['busy'] / traced['wall']:.6f}, "
          f"{traced['events']} device events; host time by op (self, "
          f"ms, calls): " + "; ".join(f"{k} {ms:.3f} ({c})"
                                      for k, ms, c in host_top))
    sb = max(staged["batches"], 1)
    print(f"  the same second untraced, a sync around each stage "
          f"({staged['requests']} requests, {staged['batches']} batches in "
          f"{staged['seconds']:.6f} s), inclusive ms a batch: " + ", ".join(
              f"{k} {v * 1e3 / sb:.6f}" for k, v in staged["secs"].items()))
    print(f"  after the drives: inserted {n_ins} keys through the queue, all "
          f"found; deleted {[d.size for d in deleted]}, none found; tenants "
          f"{counters}; pack_rows / pack_full {pack_counts}; seam misses "
          f"{seam[0]} in {seam[1]} calls")
    for (tag, stage), v in tables_g.items():
        print(f"  DynamicPageTable ({tag}, {stage}): f32-exact "
              f"{v['f32_exact']}, path {v['path']}, {v['launches']} launch a"
              f" lookup of 2^16 block keys, {v['ms']:.6f} ms a lookup, "
              f"{v['found']} found, all equal to the cache's table; "
              + ("no kernel on this path" if v["err"] is None else
                 f"the kernel on these keys against its plain version "
                 f"(tolerance 0): max |diff| {v['err']}")
              + f"; {v['stats']}")
    print(f"  page-table launches {launches_pt}")


def _verb_ms(fn, reps: int = 20) -> float:
    """Mean milliseconds of ``fn`` as ``time_verbs.py`` times a verb: three
    warm-up calls, then ``reps`` calls, each between its own pair of CUDA
    events and synchronised."""
    import torch
    for _ in range(3):
        fn()
    ms = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
    return sum(ms) / len(ms)


def _positions_vs_plain(d, q, lo, hi, what) -> dict:
    """At each mesh position of a sharded dynamic index, the stacked K2
    (and K3 when ``lo`` is given) against its plain version on that
    position's rows and descriptors, with the grouped queries its
    ``find`` (``find_range``: both endpoint arrays as one batch of point
    pairs) gives the position; returns each kernel's max |diff|."""
    import torch
    from repro_torch.kernels import lookup as tlk
    f32 = torch.float32
    st = d._stacked()
    errs = {"sharded_dynamic_lookup": 0, "sharded_dynamic_range": 0}
    batches = [("sharded_dynamic_lookup", q)]
    if lo is not None:
        batches.append(("sharded_dynamic_range", torch.cat([lo, hi])))
    for name, x in batches:
        _, _, ds, kq, _ = d._grouped(st, x)
        for i, part in enumerate(st["parts"]):
            m = (ds >= part["lo"]) & (ds < part["lo"] + part["n"])
            if not bool(m.any()):
                continue
            pq, rid = kq[m].to(f32), ds[m] - part["lo"]
            pk, tabs, kw = d._kernel_args(st, part)
            tables = (pk["roots"], pk["mats"], pk["vecs"], pk["kf"])
            tag = f"{name} ({what}, position {i})"
            if name == "sharded_dynamic_lookup":
                e = _compare(
                    tag, lambda: tlk.sharded_dynamic_lookup(
                        pq, rid, *tables, pk["dkf"], rows=pk.get("rows"),
                        tabs=tabs, **kw),
                    lambda: tlk.sharded_dynamic_lookup_plain(
                        pq, rid, *tables, pk["dkf"], **kw))
            else:
                e = _compare(
                    tag, lambda: tlk.sharded_dynamic_range(
                        pq, pq, rid, *tables, pk["dkf"], tabs=tabs, **kw),
                    lambda: tlk.sharded_dynamic_range_plain(
                        pq, pq, rid, *tables, pk["dkf"], **kw))
            errs[name] = max(errs[name], e)
    return errs


def _path_h(args, dev, rows, h) -> None:
    """Phase 12, path H, counted: the sharded index across mesh positions
    (``ShardMesh(S, devices=...)`` and the routed exchange), at path F's
    geometry on a mesh of ``--shards`` positions, one shard a position, as
    the reference places them; every position is this one card, so the
    copies between positions cost nothing here.  ``build_sharded`` +
    ``make_lookup_fn`` (capacity factor None and 2.0: the -1s are
    ``_budget_mask``'s), ``Index.build(mesh=)``: ``find`` / ``find_range``,
    path A's churn, a skewed ingest until a boundary run migrates between
    positions, planted edges, an index with empty shards; at each step and
    each position the stacked K2 / K3 (K1 once) against their plain
    versions on that position's rows.  Warm verbs at D = 8 and D = 2 (and
    D = 1, path F's layout, over the same shards), the exchange's bytes a
    call, the restacks; a snapshot restored onto ``H_RESTORE`` and
    resharded onto ``H_RESHARD`` (shards, positions); two tenants of
    ``H_TENANT_KEYS`` keys on ``H_TENANT_POSITIONS`` positions behind a
    ``BatchingFrontend`` for ``H_CLOSED_S`` of closed loop.  Every answer
    against the truth; launches a call counted."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch.api import Index
    from repro_torch.core import distributed as tdist
    from repro_torch.core import persist as tpersist
    from repro_torch.kernels import lookup as tlk
    from repro_torch.kernels import ops
    from repro_torch.serve import frontend as tfe

    f32, f64, i32 = torch.float32, torch.float64, torch.int32
    n, S = args.n, args.shards
    L = max(args.n_leaves // S, 64)
    P = S
    on = lambda m, p: tdist.ShardMesh(m, devices=(dev,) * p)
    mesh = on(S, P)
    card = _card()
    keys32 = h.lognormal_keys(n)
    keys = keys32.to(f64)
    edges = h.edges_of(keys32)
    h.reset_counters()
    ops.reset_seam()
    steps, per_call, errs, warm, moved = {}, {}, {}, {}, {}
    K = ("sharded_lookup", "sharded_dynamic_lookup", "sharded_dynamic_range")

    def fq(live):
        return h.find_queries(live, edges).to(f32).to(f64)

    def counted(name, fn):
        k0 = tlk.LAUNCHES[name]
        out, dt = _sync_time(fn)
        per_call.setdefault(name, []).append(tlk.LAUNCHES[name] - k0)
        return out, dt

    def fold(e):
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0), v)

    # ---- 1. the static index: one stacked K1 a position ------------------
    si, steps["build_sharded"] = _sync_time(
        lambda: tdist.build_sharded(keys, mesh, n_leaves=L, device=dev))
    q = fq(keys)
    qf = q.to(f32)
    bounds = torch.as_tensor(tdist.shard_bounds(keys, S), device=dev)
    dest = torch.searchsorted(si.splits, q)
    cap = si.cap
    want = (torch.searchsorted(keys32, qf) - bounds[dest]
            + dest * cap).to(i32)
    budget = {}
    for cf in (None, 2.0):
        ranks, steps[f"make_lookup_fn (capacity {cf})"] = counted(
            "sharded_lookup",
            lambda cf=cf: tdist.make_lookup_fn(si, capacity_factor=cf)(q))
        keep = tdist._budget_mask(tdist._route(si.splits, q), S, cf) \
            if cf is not None else torch.ones_like(q, dtype=torch.bool)
        _check_equal(f"make_lookup_fn ({cf}) -1s vs _budget_mask",
                     ranks < 0, ~keep)
        _check_equal(f"make_lookup_fn ({cf}) ranks vs the truth",
                     ranks[keep], want[keep])
        budget[cf] = int((~keep).sum())
    member = tdist._at_home([tdist._member(p.keys[:, 0]) for p in si.parts],
                            si.device)
    _, _, sds, sq, _ = tdist._grouped(si.splits, member, q)
    sq = sq.to(f32)
    e1 = 0
    for i, part in enumerate(si.parts):
        m = sds == i
        pq, rid = sq[m], sds[m] - i
        t = part.kernel_tables()
        kw = dict(n_leaves=L, iters=si.search_iters)
        e1 = max(e1, h.uncounted(lambda t=t, pq=pq, rid=rid, kw=kw: _compare(
            f"sharded_lookup (position {i})",
            lambda: (tlk.sharded_lookup(pq, rid, t["roots"], t["mats"],
                                        t["vecs"], t["keys"], rows=t["rows"],
                                        fences=t["fences"], tabs=t["tabs"],
                                        **kw),),
            lambda: (tlk.sharded_lookup_plain(pq, rid, t["roots"],
                                              t["mats"], t["vecs"],
                                              t["keys"], **kw),))))
    fold({"sharded_lookup": e1})
    del si, ranks, want, bounds, dest, member, sq, sds

    # ---- 2. the dynamic index: one stacked K2 / K3 a position ------------
    ix, steps["Index.build (mesh of 8 positions)"] = _sync_time(
        lambda: Index.build(keys, mesh=mesh, n_leaves=L))
    d = ix.backend
    _, steps["restack (cold: every position's stack and tables)"] = \
        _sync_time(lambda: _restack(d))
    live = keys
    find_q = fq(live)
    lo, hi = h.range_pairs(live)
    steps["find (built)"], _ = counted(
        "sharded_dynamic_lookup",
        lambda: h.check_find(ix, find_q, "positions built"))
    steps["find_range (built)"], _ = counted(
        "sharded_dynamic_range",
        lambda: h.check_range(ix, lo, hi, "positions built"))
    fold(h.uncounted(lambda: _positions_vs_plain(d, find_q, lo, hi,
                                                 "built")))
    tdist.reset_exchange()
    h.uncounted(lambda: ix.find(find_q))
    moved["find"] = dict(tdist.EXCHANGE)
    tdist.reset_exchange()
    h.uncounted(lambda: ix.find_range(lo, hi))
    moved["find_range"] = dict(tdist.EXCHANGE)
    warm[f"D = {P}"] = h.uncounted(lambda: {
        "find": _verb_ms(lambda: ix.find(find_q)),
        "find_range": _verb_ms(lambda: ix.find_range(lo, hi))})
    # the same shards on 2 positions and on one stack (path F's layout):
    # other meshes over the same DynamicRMI objects, for the times only
    def view(devices):
        v = tdist.ShardedDynamicIndex(
            mesh=tdist.ShardMesh(S, devices=devices), axis=d.axis,
            splits=d.splits.copy(), shards=d.shards, eps=d.eps,
            n_leaves=d.n_leaves, build_kwargs=d.build_kwargs)
        v._init_maintenance()
        k0 = tlk.LAUNCHES["sharded_dynamic_lookup"]
        _, r = v.find(find_q)
        out = {"launches a find": tlk.LAUNCHES["sharded_dynamic_lookup"]
               - k0}
        _check_equal(f"D = {len(v.positions)}: find rank vs D = {P}", r,
                     ix.find(find_q)[1])
        out.update(find=_verb_ms(lambda: v.find(find_q)),
                   find_range=_verb_ms(lambda: v.find_range(lo, hi)))
        return out
    for devices in ((dev,) * (P // 4), None):
        tag = f"D = {len(devices) if devices else 1}"
        warm[tag] = h.uncounted(functools.partial(view, devices))
        gc.collect()
        torch.cuda.empty_cache()
    # path A's churn
    n_ins = min(2_000_000, n // 100)
    _, steps["insert (spread)"] = _sync_time(
        lambda: ix.insert(h.draw(n_ins - n_ins // 20)))
    live = d.live_keys_tensor()
    _, steps["delete"] = _sync_time(
        lambda: ix.delete(h.pick(live, n_ins // 2)))
    live = d.live_keys_tensor()
    find_q = fq(live)
    lo, hi = h.range_pairs(live)
    steps["find (churned)"], _ = counted(
        "sharded_dynamic_lookup",
        lambda: h.check_find(ix, find_q, "positions churned"))
    steps["find_range (churned)"], _ = counted(
        "sharded_dynamic_range",
        lambda: h.check_range(ix, lo, hi, "positions churned"))
    fold(h.uncounted(lambda: _positions_vs_plain(d, find_q, lo, hi,
                                                 "churned")))
    # a skewed ingest into shard 0's range until a boundary run migrates
    # from position 0 to position 1
    m0 = d.migrations_incremental + d.migrations_full
    top, k_lo = float(d.splits[0]), float(keys[0])
    t_skew, batches = 0.0, 0
    while d.migrations_incremental + d.migrations_full == m0:
        if batches == SKEW_BATCHES:
            raise AssertionError(f"{batches} skewed batches ran no "
                                 f"migration: {d.live_counts()}")
        x = (k_lo + (top - k_lo) * torch.rand(
            n // SKEW_CUT, dtype=f64, device=dev, generator=h.g)).to(f32)
        _, dt = _sync_time(functools.partial(ix.insert, x.to(f64)))
        t_skew += dt
        batches += 1
    steps[f"skewed insert ({batches} x {n // SKEW_CUT} keys, a run "
          f"migrated from position 0 to 1)"] = t_skew
    if S // P != 1:
        raise AssertionError("shards 0 and 1 must lie on two positions")
    _, steps["restack (after the migration)"] = _sync_time(
        lambda: _restack(d))
    seam_key = float(d.splits[S // 2 - 1])
    ix.insert(torch.full((9,), seam_key, dtype=f64, device=dev))
    ptrs = _row_ptrs(d._stack)
    rows0, full0 = d.restack_rows, d.restack_full
    _, steps["restack (one dirty row)"] = _sync_time(lambda: _restack(d))
    if (d.restack_rows - rows0, d.restack_full - full0) != (1, 0) or \
            _row_ptrs(d._stack) != ptrs:
        raise AssertionError("a one-shard insert must rewrite one row of "
                             "its position's stack in place")
    # planted: at and beside every split, +-inf and NaN
    live = d.live_keys_tensor()
    live32 = live.to(f32)
    sp = torch.as_tensor(d.splits, device=dev).to(f32)
    beside = torch.cat([sp, torch.nextafter(sp, sp + 1), torch.nextafter(
        sp, sp - 1)]).to(f64)
    planted = torch.cat([beside, torch.tensor(
        [float("inf"), float("nan"), float("-inf")], dtype=f64,
        device=dev)])
    find_q = torch.cat([fq(live)[:h.nq - planted.numel()], planted])
    (found, rank), steps["find (skewed, planted)"] = counted(
        "sharded_dynamic_lookup", lambda: ix.find(find_q))
    fin = (find_q < float("inf")) & ~torch.isnan(find_q)
    pq = find_q.to(f32)
    _check_equal("find (planted) rank", rank, torch.where(
        fin, torch.searchsorted(live32, pq), 0).to(i32))
    _check_equal("find (planted) found", found, fin & (torch.searchsorted(
        live32, pq, right=True) > torch.searchsorted(live32, pq)))
    lo, hi = h.range_pairs(live)
    lo = torch.cat([lo[:-beside.numel()], beside])
    hi = torch.cat([hi[:-beside.numel()], beside + 1.0])
    steps["find_range (skewed, planted)"], _ = counted(
        "sharded_dynamic_range",
        lambda: h.check_range(ix, lo, hi, "positions planted"))
    fold(h.uncounted(lambda: _positions_vs_plain(d, find_q, lo, hi,
                                                 "skewed, planted")))
    warm[f"D = {P}"].update(h.uncounted(lambda: {
        "find (skewed)": _verb_ms(lambda: ix.find(find_q)),
        "find_range (skewed)": _verb_ms(lambda: ix.find_range(lo, hi))}))
    counters = {k: int(getattr(d, k)) for k in tpersist._IDX_COUNTERS}
    shard_live = d.live_counts().tolist()
    # an index with empty shards on the 8 positions
    tiny = torch.tensor([1.0, 2.0, 5.0, 9.0, 12.0], dtype=f64, device=dev)
    tix = Index.build(tiny, mesh=mesh, n_leaves=16)
    tq = torch.tensor([0.5, 1.0, 2.0, 3.0, 9.0, 12.0, 100.0, float("inf"),
                       float("nan"), float("-inf")], dtype=f64, device=dev)
    tf, tr = tix.find(tq)
    _check_equal("empty shards: rank", tr, torch.tensor(
        [0, 0, 1, 2, 3, 4, 5, 0, 0, 0], dtype=i32, device=dev))
    _check_equal("empty shards: found", tf, torch.tensor(
        [False, True, True, False, True, True, False, False, False, False],
        device=dev))
    fold(h.uncounted(lambda: _positions_vs_plain(tix.backend, tq, None,
                                                 None, "empty shards")))
    empty_txt = f"live keys a shard {tix.backend.live_counts().tolist()}"
    del tix
    launches = h.counters()
    for k in K:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} never launched on path H: "
                                 f"{launches}")
    for k, v in per_call.items():
        if any(c != P for c in v):
            raise AssertionError(f"{k}: launches a call {v}, not {P}")
    peak_index = torch.cuda.max_memory_allocated() / 2**30

    # ---- 3. recovery: a snapshot, restored and resharded onto meshes -----
    store_dir = ROOT / "build"
    store_dir.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="path_h_store_", dir=store_dir)
    times, reshard = {}, {}
    try:
        store = tpersist.SnapshotStore(tmp)
        _, times["snapshot_sharded (blocking)"] = _sync_time(
            lambda: ix.snapshot(store, 1))
        live_snap = d.live_keys_tensor()
        del ix, d, live, live32, found, rank
        gc.collect()
        torch.cuda.empty_cache()
        rq = fq(live_snap)
        rlo, rhi = h.range_pairs(live_snap)

        def verify(got, tag, shape):
            if (got.n_shards, len(got.positions)) != shape:
                raise AssertionError(f"{tag}: {got.n_shards} shards on "
                                     f"{len(got.positions)} positions")
            _check_equal(f"{tag}: live keys", got.live_keys_tensor(),
                         live_snap)
            h.uncounted(lambda: (h.check_find(Index(got), rq, tag),
                                 h.check_range(Index(got), rlo, rhi, tag)))
        (rix, rep), dt = _sync_time(functools.partial(
            tpersist.restore_sharded, store, on(*H_RESTORE)))
        times[f"restore_sharded onto {H_RESTORE[0]} shards over "
              f"{H_RESTORE[1]} positions"] = dt
        reshard["restore"] = dataclasses.asdict(rep.reshard)
        verify(rix, "restored", H_RESTORE)
        (six, stats), dt = _sync_time(functools.partial(
            tpersist.reshard_sharded, rix, on(*H_RESHARD)))
        times[f"reshard_sharded onto {H_RESHARD[0]} shards over "
              f"{H_RESHARD[1]} positions"] = dt
        reshard["reshard"] = dataclasses.asdict(stats)
        del rix
        verify(six, "resharded", H_RESHARD)
        for v in reshard.values():
            if v["full_rebuilds"] != 0:
                raise AssertionError(f"a reshard rebuilt a shard: {reshard}")
        del six, live_snap
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    peak_main = torch.cuda.max_memory_allocated() / 2**30
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 4. two tenants on 2 positions behind one front-end --------------
    tmesh = on(S, H_TENANT_POSITIONS)
    tenants = []
    for t, (mu, sigma) in enumerate(((0.0, 1.0), (0.5, 0.8))):
        tk = torch.sort(torch.empty(H_TENANT_KEYS, dtype=f32, device=dev)
                        .log_normal_(mu, sigma, generator=h.g)).values
        tenants.append(Index.build(tk.to(f64), mesh=tmesh,
                                   n_leaves=H_TENANT_LEAVES).backend)
    lives = [t.live_keys_tensor().to(f32) for t in tenants]
    k0 = dict(tlk.LAUNCHES)
    fe = tfe.BatchingFrontend(tenants, config=tfe.ServeConfig(
        latency_budget_s=G_BUDGET_S))
    if not fe.pack.use_kernel:
        raise AssertionError("path H's pack must take the kernel path")
    with fe:
        fe.warmup((4096,))
        arrays = [(t, h.pick(lives[t], 4096).cpu().numpy())
                  for _ in range(4) for t in range(2)]
        wants = [torch.searchsorted(lives[t], torch.as_tensor(
            a, device=dev).to(f32)).to(i32).cpu().numpy() for t, a in arrays]
        b0, c0 = fe.stats.batches, tlk.LAUNCHES["sharded_dynamic_lookup"]
        i, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < H_CLOSED_S:
            t, a = arrays[i % len(arrays)]
            found, rank = fe.lookup(t, a, timeout=120.0)
            if not found.all() or not np.array_equal(
                    rank, wants[i % len(arrays)]):
                raise AssertionError(f"path H tenants: batch {i} wrong")
            i += 1
        closed_s = time.perf_counter() - t0
        tb = fe.stats.batches - b0
        tl = tlk.LAUNCHES["sharded_dynamic_lookup"] - c0
    if tb != i or tl != H_TENANT_POSITIONS * tb:
        raise AssertionError(f"path H tenants: {i} requests, {tb} batches, "
                             f"{tl} stacked K2 launches (want "
                             f"{H_TENANT_POSITIONS} a batch)")
    tenant_launches = {k: tlk.LAUNCHES[k] - k0[k] for k in K}
    del fe, tenants, lives
    gc.collect()
    torch.cuda.empty_cache()

    launches = h.counters()
    for name in K:
        rows[name]["launches"] += launches[name]
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                        errs.get(name, 0))
    fw = h.notes.get("path F warm", {})
    print(f"phase 12: path H (the sharded index across mesh positions: "
          f"{S} shards of {L} leaves on {P} positions, one shard a "
          f"position) ok on {card}; every position is {mesh.devices[0]} "
          f"(one card: the positions share it, the copies between them "
          f"are no-ops); n={n}; launches {launches}; launches a call "
          f"{ {k: sorted(set(v)) for k, v in per_call.items()} } (one a "
          f"position); the stacked K1-K3 at every position equal their "
          f"plain versions bit for bit (tolerance 0): {errs}; "
          f"make_lookup_fn -1s (capacity 2.0: equal to _budget_mask's) "
          f"{budget}")
    h.print_steps(steps)
    for tag, v in warm.items():
        print(f"  warm, {card}, {tag}: " + ", ".join(
            f"{k} {x:.6f} ms" if isinstance(x, float) else f"{k} {x}"
            for k, x in v.items()) + " (CUDA events, 20 calls a verb, as "
            "time_verbs.py)")
    if fw:
        print(f"  path F's one stack, same run (its own keys): " + ", ".join(
            f"{k} {x:.6f} ms" for k, x in fw.items()))
    for verb, e in moved.items():
        print(f"  exchange of one {verb}: {e['answers']} position calls, "
              f"{e['bytes']} bytes between the home position and the "
              f"others (queries out, answers back), reckoned as if each "
              f"position were its own card")
    print(f"  counters after the churn and the skewed ingest: {counters}; "
          f"live keys a shard {shard_live}; the index with empty shards: "
          f"{empty_txt}")
    for k, v in times.items():
        print(f"  {k}: {v:.6f} s")
    for k, v in reshard.items():
        print(f"  ReshardStats ({k}): {v}")
    print(f"  tenants: 2 x {H_TENANT_KEYS} keys, {S} shards of "
          f"{H_TENANT_LEAVES} leaves on {H_TENANT_POSITIONS} positions "
          f"(cut: tenant B's size for both); closed loop of 4,096-key "
          f"batches, one in flight: {tb} batches in {closed_s:.6f} s "
          f"({tb / closed_s:.3f} batches/s), {tl} stacked K2 launches "
          f"({tl / max(tb, 1):.3f} a batch); launches {tenant_launches}")
    h.print_seam()
    print(f"  peak memory allocated (path H): {peak_index:.3f} GiB through "
          f"the index's verbs, {peak_main:.3f} GiB through the recovery "
          f"({card})")


def main(argv=None) -> int:
    args = _args(argv)
    import numpy as np
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
    from repro_torch.core import drift as tdrift
    from repro_torch.core import reuse as treuse
    from repro_torch.core import rmi as trmi
    from repro_torch.core import rmrt as trmrt
    from repro_torch.core import synth as tsynth
    from repro_torch.kernels import build
    from repro_torch.kernels import ksdist as tks
    from repro_torch.kernels import lookup as tlk
    from repro_torch.kernels import hist as thist
    from repro_torch.kernels import linfit as tlinfit
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
                                       "spill", "smem", "arning",
                                       "Performance")):
                print(f"  ptxas[{name}] {line.strip()}")
    # K2/K3, K5 and K7 were designed to keep their register state (chains
    # and sectors, register blocks) out of local memory: no spills
    for name in ("lookup", "ksdist", "linfit"):
        if name not in reports:
            print(f"  {name}: not rebuilt now, spills not checked")
        elif _spills(reports[name]):
            raise AssertionError(f"ptxas spills in {name}: "
                                 f"{_spills(reports[name])}")
    # K8's prefill tile must run on the tensor cores: HGMMA in the SASS
    sass = build.sass("flash")
    hgmma = sum("HGMMA" in line for line in sass.splitlines())
    print(f"  flash library: {hgmma} HGMMA instructions in its SASS "
          f"(cuobjdump -sass); ptxas report above"
          f"{'' if 'flash' in reports else ' (not rebuilt now)'}")
    if hgmma == 0:
        raise AssertionError("the flash library's SASS holds no HGMMA: the "
                             "prefill tile does not use the tensor cores")

    h = _Harness(dev, args.seed, args.queries)
    g, L, nq = h.g, args.n_leaves, args.queries

    rows = {}

    # ---- phase 2: path A (linear models), counted ---------------------------
    n = args.n
    keys32 = h.lognormal_keys(n)
    keys = keys32.to(torch.float64)
    edges = h.edges_of(keys32)
    h.reset_counters()
    ops.reset_seam()
    steps = {}
    sidx, steps["static build_rmi"] = _sync_time(
        lambda: trmi.build_rmi(keys, n_leaves=L, device=dev))
    q_static = h.find_queries(keys, edges)
    pos, steps["static lookup"] = h.seam(
        "lookup/static", nq, lambda: trmi.lookup(sidx, q_static))
    _check_equal("static lookup", pos,
                 torch.searchsorted(keys32, q_static.to(torch.float32))
                 .to(torch.int32))
    ix, steps["Index.build"] = _sync_time(
        lambda: Index.build(keys, n_leaves=L))
    live, rebuilt_a, _ = h.churn(ix, keys, steps, "", edges)
    launches_a = h.counters()
    for k in ("lookup", "dynamic_lookup", "dynamic_range"):
        if launches_a[k] <= 0:
            raise AssertionError(f"kernel {k} never launched on path A: "
                                 f"{launches_a}")
    d = ix.backend
    print(f"phase 2: path A (linear) ok; n={n}; launches {launches_a}; "
          f"rebuilds {d.rebuilds} (narrow batch {rebuilt_a}); deleted "
          f"{d.deleted}; live {d.live_count}; search_iters static "
          f"{sidx.search_iters} dynamic {d.index.search_iters}")
    h.print_steps(steps)
    h.print_seam()

    # ---- phase 3: K1-K3 (linear) against their plain versions, timed -------
    s_tabs, s_rows, s_fence = (sidx.packed_tables(), sidx.leaf_rows(),
                               sidx.key_fence)
    d_tabs, d_rows = d.index.packed_tables(), d.index.leaf_rows()
    qf = h.find_queries(live, edges).to(torch.float32)
    lo, hi = h.range_pairs(live)
    lof, hif = lo.to(torch.float32), hi.to(torch.float32)
    dk = tlk.pad_delta(d.delta_keys_f32)
    skw = dict(n_leaves=L, iters=sidx.search_iters)
    dkw = dict(n_leaves=L, route_n=d.route_n, iters=d.index.search_iters)
    skf, dkf = sidx.keys_f32, d.index.keys_f32
    calls_a = {
        "lookup": (
            lambda: (tlk.lookup(qf, *s_tabs, skf, rows=s_rows, fence=s_fence,
                                **skw),),
            lambda: (tlk.lookup_plain(qf, *s_tabs, skf, **skw),),
            lambda: torch.searchsorted(skf, qf),
            lambda: [_search_work(tlk, s_tabs, skf, qf, n_leaves=L,
                                  route_n=sidx.n, iters=sidx.search_iters,
                                  right=False, rows=True, fence=s_fence)]),
        "dynamic_lookup": (
            lambda: tlk.dynamic_lookup(qf, *d_tabs, dkf, dk, rows=d_rows,
                                       **dkw),
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
    e = _k23_edges(tlk, d_tabs, dkf, live, qf, lof, hif, dkw, g, "linear")
    for nm in ("dynamic_lookup", "dynamic_range"):
        errs[nm] = max(errs[nm], e)
    leaf = tlk.route_bucket(qf[:4096], s_tabs[0], n_leaves=L, route_n=sidx.n)
    e, k1_cases = _k1_k4_edges(
        tlk, "lookup",
        lambda q, v, kt, it: tlk.lookup(q, *s_tabs[:2], v, kt, n_leaves=L,
                                        iters=it),
        lambda q, v, kt, it: tlk.lookup_plain(q, *s_tabs[:2], v, kt,
                                              n_leaves=L, iters=it),
        s_tabs[2], torch.unique(leaf[:64]), sidx.n, skf, qf,
        sidx.search_iters)
    errs["lookup"] = max(errs["lookup"], e)
    print(f"  K1 (linear) equals its plain version bit for bit on {k1_cases} "
          f"planted cases (sentinel leaves, iters {sidx.search_iters}, "
          f"{sidx.search_iters - EDGE_ITERS_CUT} and full, keys as an "
          f"unaligned view, +-0, +-inf, NaN, the first and last keys)")
    print(f"phase 3: K1-K3 (linear) equal their plain versions bit for bit "
          f"(tolerance 0): {errs}")
    for nm, (k, p, lib, work) in calls_a.items():
        rows[nm] = _time_row(nm, k, p, lib, work(), launches_a[nm], errs[nm])
    # the single-index verbs warm, each a kernel launch and its epilogue
    q64 = qf.to(torch.float64)
    warm = h.uncounted(lambda: {
        "static lookup": _event_ms(lambda: trmi.lookup(sidx, q64), 5),
        "find": _event_ms(lambda: ix.find(q64), 5),
        "find_range": _event_ms(lambda: ix.find_range(lo, hi), 5)})
    print("  warm, CUDA-event means of 5 calls: " + ", ".join(
        f"{k} {v:.6f} ms" for k, v in warm.items()))
    print(f"  shapes: n={n} leaves={L} queries={nq} range pairs="
          f"{lo.numel()} base capacity={d.index.keys.shape[0]} delta "
          f"capacity={dk.shape[0]} iters static={sidx.search_iters} "
          f"dynamic={d.index.search_iters} delta iters="
          f"{tlk.full_iters(dk.shape[0])}")
    print(f"  peak memory allocated (path A): "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    del sidx, ix, d, s_tabs, s_rows, s_fence, d_tabs, d_rows, dk, skf, dkf
    del live, calls_a, q_static, leaf
    del pos, keys, keys32, qf, lo, hi, lof, hif
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # ---- phase 4: path B (the lazy path), counted --------------------------
    keys32 = h.lognormal_keys(n)
    keys = keys32.to(torch.float64)
    edges = h.edges_of(keys32)
    h.reset_counters()
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
    q_static = h.find_queries(keys, edges)
    pos, steps["RMI-NN-MR lookup"] = h.seam(
        "lookup/RMI-NN-MR", nq,
        lambda: trmi.lookup(smlp, q_static, path="kernel"))
    _check_equal("RMI-NN-MR lookup", pos,
                 torch.searchsorted(keys32, q_static.to(torch.float32))
                 .to(torch.int32))
    sm_tabs, sm_iters = smlp.packed_tables(), smlp.search_iters
    sm_rows, sm_fence = smlp.leaf_rows(), smlp.key_fence
    print(f"  RMI-NN-MR: reuse_fraction {reuse_rmi:.6f}, fresh leaves "
          f"{fresh} of {L}, search_iters {sm_iters}")
    del smlp, pos
    torch.cuda.empty_cache()

    ix, steps["Index.build (pool, mlp)"] = _sync_time(
        lambda: Index.build(keys, pool=mlp_pool, kind="mlp", n_leaves=L,
                            train_steps=args.leaf_steps))
    reuse_dyn = ix.backend.index.reuse_fraction
    live, rebuilt_b, k7_rebuild = h.churn(ix, keys, steps, ", pool", edges)
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
    q_rmrt = h.find_queries(keys, edges)
    pos, steps["RMRT lookup"] = h.seam(
        "lookup/RMRT", nq, lambda: trmrt.lookup(tree, q_rmrt, path="kernel"))
    _check_equal("RMRT lookup", pos,
                 torch.searchsorted(keys32, q_rmrt.to(torch.float32))
                 .to(torch.int32))
    print(f"  RMRT: depth {tree.depth}, num_nodes {tree.num_nodes}, leaves "
          f"{int(tree.is_leaf.sum())}, reuse_fraction "
          f"{tree.reuse_fraction:.6f}, search_iters {tree.search_iters}")
    launches_b = h.counters()
    if min(launches_b[k] for k in ("lookup", "dynamic_lookup",
                                   "dynamic_range", "rmrt_lookup",
                                   "ksdist", "ksdist_tables")) <= 0:
        raise AssertionError(f"a kernel of path B never launched: "
                             f"{launches_b}")
    print(f"phase 4: path B (lazy) ok; n={n}; launches {launches_b}")
    h.print_steps(steps)
    h.print_seam()
    print(f"  peak memory allocated (path B): "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    # ---- phase 5: K1-K3 (MLP), K4, K7 against plain versions, timed -------
    d_tabs, d_rows = d.index.packed_tables(), d.index.leaf_rows()
    qf = h.find_queries(live, edges).to(torch.float32)
    lo, hi = h.range_pairs(live)
    lof, hif = lo.to(torch.float32), hi.to(torch.float32)
    dk = tlk.pad_delta(d.delta_keys_f32)
    mk = dict(leaf_kind="mlp")
    skw = dict(n_leaves=L, iters=sm_iters, **mk)
    dkw = dict(n_leaves=L, route_n=d.route_n, iters=d.index.search_iters,
               **mk)
    dkf = d.index.keys_f32
    qs = q_static.to(torch.float32)
    t_mat, t_vec = tree.packed_tables()
    t_rows, t_fence = tree.node_rows(), tree.key_fence
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
            lambda: (tlk.lookup(qs, *sm_tabs, keys32, rows=sm_rows,
                                fence=sm_fence, **skw),),
            lambda: (tlk.lookup_plain(qs, *sm_tabs, keys32, **skw),),
            lambda: torch.searchsorted(keys32, qs),
            lambda: [_search_work(tlk, sm_tabs, keys32, qs, n_leaves=L,
                                  route_n=n, iters=sm_iters, right=False,
                                  rows=True, fence=sm_fence, **mk)]),
        "dynamic_lookup": (
            lambda: tlk.dynamic_lookup(qf, *d_tabs, dkf, dk, rows=d_rows,
                                       **dkw),
            lambda: tlk.dynamic_lookup_plain(qf, *d_tabs, dkf, dk, **dkw),
            lambda: (torch.searchsorted(dkf, qf),
                     torch.searchsorted(dk, qf)),
            lambda: [_search_work(tlk, d_tabs, dkf, qf, n_leaves=L,
                                  route_n=d.route_n,
                                  iters=d.index.search_iters, right=False,
                                  rows=True, **mk),
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
            lambda: (tlk.rmrt_lookup(qr, t_mat, t_vec, tkf, rows=t_rows,
                                     fence=t_fence, **tkw),),
            lambda: (tlk.rmrt_lookup_plain(qr, t_mat, t_vec, tkf, **tkw),),
            lambda: torch.searchsorted(tkf, qr),
            lambda: [_rmrt_work(tlk, tree, qr)]),
        "ksdist": (
            lambda: (tks.ksdist(hc, sel_a, sel_ps),),
            lambda: (tks.ksdist_plain(hc, sel_a, sel_ps),),
            None,
            lambda: [(hc.numel() * hc.element_size()
                      + 2 * sel_a.numel() * 4
                      + hc.shape[0] * sel_a.shape[0] * 4,
                      4 * hc.numel() * sel_a.shape[0]
                      + hc.shape[0] * sel_a.shape[0] + hc.numel())]),
        # the table kernel alone: the histograms in, A_T and P_T out, about
        # two adds a bin
        "ksdist_tables": (
            lambda: tks.tables(hc),
            lambda: tks.target_tables(hc),
            None,
            lambda: [(hc.numel() * hc.element_size() + 2 * hc.numel() * 4,
                      2 * hc.numel())]),
    }
    errs = {nm: _compare(nm, k, p) for nm, (k, p, _, _) in calls_b.items()}
    e = _k23_edges(tlk, d_tabs, dkf, live, qf, lof, hif, dkw, g,
                   "MLP leaves")
    for nm in ("dynamic_lookup", "dynamic_range"):
        errs[nm] = max(errs[nm], e)
    leaf = tlk.route_bucket(qs[:4096], sm_tabs[0], n_leaves=L, route_n=n)
    e, k1_cases = _k1_k4_edges(
        tlk, "lookup (MLP leaves)",
        lambda q, v, kt, it: tlk.lookup(q, *sm_tabs[:2], v, kt, n_leaves=L,
                                        iters=it, **mk),
        lambda q, v, kt, it: tlk.lookup_plain(q, *sm_tabs[:2], v, kt,
                                              n_leaves=L, iters=it, **mk),
        sm_tabs[2], torch.unique(leaf[:64]), n, keys32, qs, sm_iters)
    errs["lookup"] = max(errs["lookup"], e)
    # K4 on path B's RMRT and on an RMRT with MLP nodes over every 100th
    # key (no path builds one: the planted cases hold its instantiation)
    sub_keys = keys[::100].contiguous()
    mtree = trmrt.build_rmrt(sub_keys, leaf_cap=max(args.rmrt_leaf_cap // 100,
                                                    64),
                             fanout=args.fanout, kind="mlp", pool=mlp_pool,
                             train_steps=args.leaf_steps, device=dev)
    k4_cases = 0
    for what, tr, qt in (("linear nodes", tree, qr),
                         ("MLP nodes", mtree, sub_keys[torch.randint(
                             0, sub_keys.shape[0], (nq // 8,), device=dev,
                             generator=g)].to(torch.float32))):
        mt, vt = tr.packed_tables()
        kw4 = dict(fanout=tr.fanout, depth=tr.depth, kind=tr.kind)
        errs["rmrt_lookup"] = max(errs["rmrt_lookup"], _compare(
            f"rmrt_lookup ({what}, cached rows and fence)",
            lambda: (tlk.rmrt_lookup(qt, mt, vt, tr.keys_f32,
                                     rows=tr.node_rows(), fence=tr.key_fence,
                                     iters=tr.search_iters, **kw4),),
            lambda: (tlk.rmrt_lookup_plain(qt, mt, vt, tr.keys_f32,
                                           iters=tr.search_iters, **kw4),)))
        e, c = _k1_k4_edges(
            tlk, f"rmrt_lookup ({what})",
            lambda q, v, kt, it: tlk.rmrt_lookup(q, mt, v, kt, iters=it,
                                                 **kw4),
            lambda q, v, kt, it: tlk.rmrt_lookup_plain(q, mt, v, kt,
                                                       iters=it, **kw4),
            vt, torch.nonzero(tr.is_leaf).squeeze(1)[::7], tr.n,
            tr.keys_f32, qt, tr.search_iters)
        errs["rmrt_lookup"] = max(errs["rmrt_lookup"], e)
        k4_cases += c + 1
    print(f"  K1 (MLP leaves) and K4 equal their plain versions bit for bit "
          f"on {k1_cases} and {k4_cases} planted cases (sentinel leaves, "
          f"iters cut by {EDGE_ITERS_CUT} and full, keys as an unaligned "
          f"view, +-0, +-inf, NaN, the first and last keys; K4 also on an "
          f"RMRT with MLP nodes over {sub_keys.shape[0]} keys: depth "
          f"{mtree.depth}, {mtree.num_nodes} nodes)")
    del mtree, sub_keys, leaf
    errs["ksdist"] = max(errs["ksdist"], _compare(
        "ksdist (full L)", lambda: (tks.ksdist(hists, sel_a, sel_ps),),
        lambda: (tks.ksdist_plain(hists, sel_a, sel_ps),)))
    # the leaf histograms are f64; the same rows in f32, and NaN in a
    # target row and in a pool row
    errs["ksdist"] = max(errs["ksdist"], _compare(
        "ksdist (f32 targets)",
        lambda: (tks.ksdist(hc.float(), sel_a, sel_ps),),
        lambda: (tks.ksdist_plain(hc.float(), sel_a, sel_ps),)))
    hn, an, pn = hc[:4096].clone(), sel_a.clone(), sel_ps.clone()
    hn[3, 10] = float("nan")
    an[5, 7] = float("nan")
    pn[9, 20] = float("nan")
    nan_k7 = _equal_nan("ksdist (NaN in a target and two pool rows)",
                        tks.ksdist(hn, an, pn), tks.ksdist_plain(hn, an, pn))
    if nan_k7 != hn.shape[0] * 2 + an.shape[0] - 2:
        raise AssertionError(f"ksdist: {nan_k7} NaN entries, not one row "
                             f"and two columns")
    del hn, an, pn
    print(f"phase 5: K1-K3 (MLP leaves), K4 and K7 equal their plain "
          f"versions bit for bit (tolerance 0; K7 at full L={L} and timed "
          f"at L={hc.shape[0]}, P={sel_a.shape[0]}, m={sel_a.shape[1]}, "
          f"{hc.dtype} histograms; also f32 histograms and NaN rows, {nan_k7}"
          f" NaN entries in the same places): {errs}")
    for nm, (k, p, lib, work) in calls_b.items():
        row = nm + "_mlp" if nm in rows else nm    # K1-K3: MLP leaves
        rows[row] = _time_row(row, k, p, lib, work(), launches_b[nm],
                              errs[nm])
    d_ms, f_ms, t_ms = _k7_parts_ms(build, tks, hc, sel_a, sel_ps)
    P_b = sel_a.shape[0]
    rows["ksdist"].update(P=P_b, distance_ms=d_ms, distance_f32_ms=f_ms,
                          tables_ms=t_ms)
    print(f"  K7 at L={hc.shape[0]}, P={P_b}: wrapper call (tables + "
          f"distances) {rows['ksdist']['ms']:.6f} ms (previous design "
          f"{K7_PREVIOUS_MS.get(P_b, float('nan')):.6f} ms, PERF.md); "
          f"distance launch alone on prepared tables {d_ms:.6f} ms (on its "
          f"f32 path {f_ms:.6f} ms), table launch alone {t_ms:.6f} ms; "
          f"bound "
          f"{rows['ksdist']['bound_ms']:.6f} ms")
    print(f"  shapes: n={n} leaves={L} queries={nq} range pairs={lo.numel()} "
          f"base capacity={d.index.keys.shape[0]} delta capacity="
          f"{dk.shape[0]} iters static={sm_iters} dynamic="
          f"{d.index.search_iters} rmrt={tree.search_iters} rmrt depth="
          f"{tree.depth} rmrt nodes={tree.num_nodes}")
    print(f"  peak memory allocated (path B + checks): "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; wall "
          f"{time.perf_counter() - t_start:.1f} s")
    del ix, d, live, tree, keys, keys32, corpus, mlp_pool, lin_pool
    del q_static, q_rmrt, pos, sm_tabs, d_tabs, qf, lo, hi, lof, hif, dk
    del dkf, qs, t_mat, t_vec, tkf, qr, sel_a, sel_ps, hists, hc, calls_b
    del sm_rows, sm_fence, d_rows, t_rows, t_fence
    torch.cuda.empty_cache()

    # ---- phase 6: path C (drift-adaptive serving), counted -----------------
    keys32 = h.lognormal_keys(n)
    keys = keys32.to(torch.float64)
    edges = h.edges_of(keys32)
    steps = {}
    dcorpus, steps["generate_pool (drift eps)"] = _sync_time(
        lambda: tsynth.generate_pool(DRIFT_EPS))
    dpool, steps["build_pool (linear, m_sim 64)"] = _sync_time(
        lambda: treuse.build_pool(dcorpus, kind="linear", m_sim=64,
                                  device=dev))
    h.print_steps(steps)
    print(f"  drift pool: {dpool.size} linear models, m={dpool.m}")
    batch = n // 100                    # 2M at 200M keys

    def drift_phases():
        """The reference benchmark's three phases, drawn anew from the same
        seeds for each mode (byte-identical batches)."""
        gd = torch.Generator(device=dev)
        gd.manual_seed(args.seed + 101)
        rng = np.random.default_rng(args.seed + 101)
        slots = rng.permutation(64)

        def lognormal(mu, sigma):
            return lambda: torch.empty(batch, dtype=torch.float32,
                                       device=dev).log_normal_(
                mu, sigma, generator=gd).to(torch.float64)

        def zipf_hot():
            # hot CDF slots: zipf over 64 base-rank slots, keys interpolated
            # between neighbouring base keys inside the slot
            r = torch.from_numpy(slots[(rng.zipf(1.2, batch) - 1) % 64]) \
                .to(dev)
            at = (r + torch.rand(batch, dtype=torch.float64, device=dev,
                                 generator=gd)) * ((n - 1) / 64.0)
            i = at.long()
            frac = at - i
            k = keys[i] * (1.0 - frac) + keys[(i + 1).clamp(max=n - 1)] * frac
            return k.to(torch.float32).to(torch.float64)

        return [("stationary", lognormal(0.0, 1.0)),
                ("shifted", lognormal(1.8, 0.9)), ("zipf-hot", zipf_hot)]

    class SwapProbe:
        """Stands in for one index's ``maybe_swap``: times each explicit
        swap pass (the O(n) one) and checks that a commit changes neither
        the search depth nor the packed tables' shapes."""

        def __init__(self, d):
            self.d, self.fn = d, d.maybe_swap
            self.calls, self.secs = 0, 0.0
            d.maybe_swap = self

        def __call__(self, leaf_ids=None):
            if leaf_ids is None:
                return self.fn()        # re-enters here for the swap pass
            d = self.d
            iters = d.index.search_iters
            shapes = [tuple(t.shape) for t in d.index.packed_tables()]
            nc, dt = _sync_time(lambda: self.fn(leaf_ids))
            self.calls += 1
            self.secs += dt
            after = [tuple(t.shape) for t in d.index.packed_tables()]
            if d.index.search_iters != iters or after != shapes:
                raise AssertionError(
                    f"a swap commit changed the search depth ({iters} -> "
                    f"{d.index.search_iters}) or the table shapes")
            return nc

    def compare_c(d, q, lo, hi, tag):
        """K2 and K3 against their plain versions on path C's tables as
        the phase left them (rewritten by swaps and repairs) and on its
        queries; first the cached packed tables against a fresh packing of
        the current leaves, so that stale tables would show."""
        tabs, rows = d.index.packed_tables(), d.index.leaf_rows()
        cold = dataclasses.replace(d.index, _packed=None)
        for i, (a, b) in enumerate(zip(tabs + (rows,),
                                       cold.packed_tables()
                                       + (cold.leaf_rows(),), strict=True)):
            _check_equal(f"path C {tag}: packed table [{i}] (3: leaf rows) "
                         f"vs a fresh packing", a, b)
        dk = tlk.pad_delta(d.delta_keys_f32)
        dkf = d.index.keys_f32
        kw = dict(n_leaves=L, route_n=d.route_n, iters=d.index.search_iters,
                  root_kind=d.index.root_kind, leaf_kind=d.index.leaf_kind)
        qf, lof, hif = (t.to(torch.float32) for t in (q, lo, hi))
        return {
            "dynamic_lookup": _compare(
                f"dynamic_lookup (path C {tag})",
                lambda: tlk.dynamic_lookup(qf, *tabs, dkf, dk, rows=rows,
                                           **kw),
                lambda: tlk.dynamic_lookup_plain(qf, *tabs, dkf, dk, **kw)),
            "dynamic_range": _compare(
                f"dynamic_range (path C {tag})",
                lambda: tlk.dynamic_range(lof, hif, *tabs, dkf, dk, **kw),
                lambda: tlk.dynamic_range_plain(lof, hif, *tabs, dkf, dk,
                                                **kw))}

    def compare_k7_c(selections):
        """K7 and its table kernel against their plain versions on each
        swap pass's (rows, m) histograms and the pool's tables; times them
        at the largest pass, at one launch's rows."""
        if not selections:
            raise AssertionError("the swap mode ran no swap pass")
        err = t_err = 0
        for i, (a, ps, h) in enumerate(selections):
            err = max(err, _compare(f"ksdist (path C swap pass {i})",
                                    lambda: (tks.ksdist(h, a, ps),),
                                    lambda: (tks.ksdist_plain(h, a, ps),)))
            t_err = max(t_err, _compare(
                f"ksdist_tables (path C swap pass {i})",
                lambda: tks.tables(h), lambda: tks.target_tables(h)))
        a, ps, h = max(selections, key=lambda s: s[2].shape[0])
        h = h[:treuse.SELECT_CHUNK]            # one launch's rows
        k_ms = _event_ms(lambda: tks.ksdist(h, a, ps), 50)
        p_ms = _event_ms(lambda: tks.ksdist_plain(h, a, ps), 5, warmup=1)
        d_ms, f_ms, t_ms = _k7_parts_ms(build, tks, h, a, ps)
        P_c = a.shape[0]
        print(f"  K7 on path C's swap passes: {len(selections)} passes, rows "
              f"{[s[2].shape[0] for s in selections]}, P={P_c}, "
              f"m={a.shape[1]}; at {h.shape[0]} rows wrapper call {k_ms:.6f}"
              f" ms (previous design "
              f"{K7_PREVIOUS_MS.get(P_c, float('nan')):.6f} ms, PERF.md; at "
              f"P={rows['ksdist'].get('P', 0)} this run "
              f"{rows['ksdist']['ms']:.6f} ms), distance launch alone "
              f"{d_ms:.6f} ms (on its f32 path {f_ms:.6f} ms), table launch "
              f"alone {t_ms:.6f} ms, plain {p_ms:.6f} ms")
        rows["ksdist"].update(path_c_P=P_c, path_c_ms=k_ms,
                              path_c_distance_ms=d_ms,
                              path_c_distance_f32_ms=f_ms,
                              path_c_tables_ms=t_ms)
        return err, t_err

    real_select = tdrift.select_from_pool_batch
    selections = []         # (sel_a, sel_ps, histograms) of each swap pass

    def capture_select(sel_a, sel_ps, hists, eps):
        selections.append((sel_a, sel_ps, hists.clone()))
        return real_select(sel_a, sel_ps, hists, eps)

    errs_c = {"dynamic_lookup": 0, "dynamic_range": 0, "ksdist": 0,
              "ksdist_tables": 0}
    h.reset_counters()
    ops.reset_seam()
    for mode in ("swap", "refit-only"):
        kw = dict(pool=dpool, drift_bins=64, drift_hi=0.02, drift_lo=0.01,
                  swap_on_drift=True) if mode == "swap" else {}
        torch.cuda.reset_peak_memory_stats()
        ix, t_build = _sync_time(functools.partial(
            Index.build, keys, n_leaves=L, eps=DRIFT_EPS, kind="linear",
            **kw))
        d = ix.backend
        probe = SwapProbe(d)
        if mode == "swap":
            tdrift.select_from_pool_batch = capture_select
        print(f"phase 6: path C {mode}: Index.build {t_build:.6f} s; "
              f"reuse_fraction {d.index.reuse_fraction:.6f}; search_iters "
              f"{d.index.search_iters}; batches of {batch} keys")
        for phase, make_batch in drift_phases():
            ts, scores, latches = [], [], []
            rb_in = rb_mnt = flushes = 0
            t_mnt = 0.0
            sw0, rj0 = d.swaps_committed, d.swap_rejects
            c0, s0, k7_0 = probe.calls, probe.secs, tks.LAUNCHES["ksdist"]
            torch.cuda.reset_peak_memory_stats()
            for _ in range(DRIFT_BATCHES):
                b = make_batch()
                r0 = d.rebuilds
                _, dt = _sync_time(functools.partial(ix.insert, b))
                ts.append(dt)
                rb_in += d.rebuilds - r0
                row = ix.drift_scores()[0]
                scores.append(float(row[0]))
                latches.append(bool(row[1]))
                r1 = d.rebuilds
                _, dt = _sync_time(ix.maybe_swap)
                t_mnt += dt
                if d.delta_live > d.base_n // 4:
                    _, dt = _sync_time(d.flush_delta)
                    t_mnt += dt
                    flushes += 1
                rb_mnt += d.rebuilds - r1
            live = d.live_keys_tensor()
            q = h.find_queries(live, edges)
            h.check_find(ix, q, f"{mode}/{phase}")
            lo, hi = h.range_pairs(live)
            h.check_range(ix, lo, hi, f"{mode}/{phase}")
            for k, e in h.uncounted(functools.partial(
                    compare_c, d, q, lo, hi, f"{mode}/{phase}")).items():
                errs_c[k] = max(errs_c[k], e)
            ms = np.asarray(ts) * 1e3
            swaps = d.swaps_committed - sw0
            ns_key = ms.sum() / (len(ts) * batch) * 1e6
            print(f"  {mode} {phase}: insert ms p50 {np.median(ms):.6f} "
                  f"max {ms.max():.6f} ({ns_key:.3f} ns/key); scores "
                  f"{' '.join(f'{v:.6f}' for v in scores)}; latch "
                  f"{''.join('1' if v else '0' for v in latches)}; swaps "
                  f"{swaps} rejects {d.swap_rejects - rj0}; rebuilds inline "
                  f"{rb_in} maintenance {rb_mnt}; flushes {flushes}; "
                  f"maintenance {t_mnt:.6f} s of which swap passes "
                  f"{probe.secs - s0:.6f} s in {probe.calls - c0}; K7 "
                  f"launches {tks.LAUNCHES['ksdist'] - k7_0}; peak memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
                  f"search_iters {d.index.search_iters}; live "
                  f"{d.live_count}")
            if mode == "swap" and phase == "shifted" and not (
                    any(latches) and swaps > 0):
                raise AssertionError("the shifted phase did not latch and "
                                     "commit swaps")
        if d.live_count != n + 3 * DRIFT_BATCHES * batch:
            raise AssertionError(f"path C {mode}: live count {d.live_count}")
        if mode == "swap":
            tdrift.select_from_pool_batch = real_select
            errs_c["ksdist"], errs_c["ksdist_tables"] = h.uncounted(
                functools.partial(compare_k7_c, selections))
            selections.clear()
        del d.maybe_swap                # break the probe's cycle
        del ix, d, probe, live, q, lo, hi
        gc.collect()
        torch.cuda.empty_cache()
    launches_c = h.counters()
    for k in ("dynamic_lookup", "dynamic_range", "ksdist", "ksdist_tables"):
        if launches_c[k] <= 0:
            raise AssertionError(f"kernel {k} never launched on path C: "
                                 f"{launches_c}")
        rows[k]["launches"] += launches_c[k]
        rows[k]["max_abs_err"] = max(rows[k]["max_abs_err"], errs_c[k])
    print(f"  path C launches {launches_c}; K2, K3 (every phase's end, both "
          f"modes) and K7 (every swap pass) equal their plain versions on "
          f"path C's inputs bit for bit (tolerance 0; K7's table kernel "
          f"too): {errs_c}")
    h.print_seam()

    # ---- phase 7: K6 and K5 through ops on path C's keys, counted ----------
    perm = keys32[torch.randperm(n, device=dev, generator=g)]
    dbatch = torch.empty(batch, dtype=torch.float32, device=dev) \
        .log_normal_(1.8, 0.9, generator=g)
    lo_k, hi_k = float(keys32[0]), float(keys32[-1])
    posn = torch.arange(n, dtype=torch.float64, device=dev)
    buckets = trmi.root_buckets("linear", trmi.models.linear_fit(keys, posn),
                                keys, L, n)
    h.reset_counters()
    steps = {}
    h_all, steps["ops.histogram (all keys, permuted)"] = _sync_time(
        lambda: ops.histogram(perm, 64, lo_k, hi_k))
    h_batch, steps["ops.histogram (one drift batch)"] = _sync_time(
        lambda: ops.histogram(dbatch, 64, lo_k, hi_k))
    fit, steps["ops.segment_linfit"] = _sync_time(
        lambda: ops.segment_linfit(keys, posn, buckets, L))
    launches_7 = h.counters()
    if launches_7["hist"] != 2 or launches_7["linfit"] != 2:
        raise AssertionError(f"K5/K6 launches on phase 7: {launches_7}")
    h.print_steps(steps)

    errs = {"hist": max(
        _compare("hist", lambda: (thist.hist(perm, 64, lo_k, hi_k),),
                 lambda: (thist.hist_plain(perm, 64, lo_k, hi_k),)),
        _compare("hist (drift batch)",
                 lambda: (thist.hist(dbatch, 64, lo_k, hi_k),),
                 lambda: (thist.hist_plain(dbatch, 64, lo_k, hi_k),)))}
    exact = _exact_counts(thist, keys32, 64, lo_k, hi_k)
    inv_n = thist.hist_params(64, lo_k, hi_k, n)[2]
    _check_equal("hist vs the exact count", h_all, exact.to(torch.float32)
                 * torch.tensor(inv_n, dtype=torch.float32, device=dev))
    print(f"  K6 hot bin: {int(exact[0])} of {n} keys in bin 0 (an f32 "
          f"accumulator is exact to 2^24 = {2**24}); drift batch bin 0 "
          f"{float(h_batch[0]):.6f}")
    xs = ops.standardize(keys)[0].to(torch.float32)
    ys = ops.standardize(posn)[0].to(torch.float32)

    def check_k5(bk, what):
        """K5's sums within one f32 ulp of each sum's magnitude (counts
        exact); returns max |diff| and the kernel's ms."""
        got = tlinfit.linfit_sums(xs, ys, bk, L)
        want = tlinfit.linfit_sums_plain(xs, ys, bk, L)
        mag = tlinfit.linfit_sums_plain(xs.abs(), ys.abs(), bk, L)
        torch.cuda.synchronize()
        ulp = torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag
        diff = (got - want).abs()
        if not bool((diff <= ulp).all()):
            raise AssertionError(f"K5 ({what}) sums beyond one f32 ulp of "
                                 f"their magnitude at "
                                 f"{int((diff > ulp).sum())} entries")
        _check_equal(f"K5 ({what}) counts", got[:, 0], want[:, 0])
        return float(diff.max()), _event_ms(
            lambda: tlinfit.linfit_sums(xs, ys, bk, L), 3, warmup=1)

    errs["linfit"], _ = check_k5(buckets, "the RMI's leaf buckets")
    # the worst contention, every key a run of its own, and a run across
    # every edge of the kernel's 4,096-key blocks
    ar = torch.arange(n, device=dev)
    k5_cases = {
        "all keys in one bucket": torch.zeros_like(buckets),
        "buckets permuted": buckets[torch.randperm(n, device=dev,
                                                   generator=g)],
        "runs across every block edge": ((ar + 2048) // 4096 % L).to(
            torch.int32)}
    del ar
    k5_ms = {}
    for what, bk in k5_cases.items():
        e, k5_ms[what] = check_k5(bk, what)
        errs["linfit"] = max(errs["linfit"], e)
    del k5_cases, bk
    print(f"  K5 on the other bucket layouts, within one f32 ulp of the "
          f"magnitude, counts exact; kernel ms: "
          + ", ".join(f"{k} {v:.6f}" for k, v in k5_ms.items()))
    p64 = trmi.segment_linear_fit_sorted(keys, buckets, L)
    cmp, bound = _pass1_bound(ops, trmi, keys, posn, buckets, L, p64.a)
    rel = ((fit[:, 0] - p64.a).abs() / p64.a.abs())[cmp]
    lim = 5e-3 + bound[cmp]
    if not bool((rel <= lim).all()):
        raise AssertionError(
            f"segment_linfit slopes beyond 5e-3 plus the pass-1 bound on "
            f"{int((rel > lim).sum())} leaves (max rel {float(rel.max())})")
    over = rel > 5e-3
    a_w = _slopes_f64_pass1(ops, tlinfit, keys, posn, buckets, L)
    rel_w = ((a_w - p64.a).abs() / p64.a.abs())[cmp]
    if not bool((rel_w <= 5e-3).all()):
        raise AssertionError(
            f"with pass 1 in f64 the slopes are beyond rtol 5e-3 on "
            f"{int((rel_w > 5e-3).sum())} leaves (max rel "
            f"{float(rel_w.max())})")
    print(f"  slopes of the same two passes with pass 1 in f64 (pass 2 "
          f"through K5): all {int(cmp.sum())} leaves within rtol 5e-3 of "
          f"the f64 fit (max rel {float(rel_w.max()):.6e}; on the "
          f"{int(over.sum())} leaves beyond it above, max rel "
          f"{float(rel_w[over].max()) if bool(over.any()) else 0.0:.6e})")
    del a_w, rel_w
    print(f"phase 7: K6 equals its plain version bit for bit (tolerance 0) "
          f"and the exact count; K5 sums within one f32 ulp of each sum's"
          f" magnitude (max |diff| {errs['linfit']:.6e}); segment_linfit "
          f"slopes on {int(cmp.sum())} leaves with two distinct keys or more"
          f": {int((~over).sum())} within rtol 5e-3 of the f64 fit, "
          f"{int(over.sum())} beyond it (max rel {float(rel.max()):.6e}) and"
          f" within 5e-3 plus the bound of pass 1's f32 coordinates (max "
          f"rel / limit {float((rel / lim).max()):.6f}); launches "
          f"{launches_7}")
    if bool(over.any()):
        lid = torch.nonzero(cmp).squeeze(1)[over]
        cnt = torch.bincount(buckets.long(), minlength=L)[lid]
        start, _ = trmi._bucket_bounds(buckets, L)
        print(f"  leaves beyond 5e-3: keys a leaf {int(cnt.min())}.."
              f"{int(cnt.max())} (median {int(cnt.median())}), first keys "
              f"{float(keys[start[lid].long()].min()):.6f}.."
              f"{float(keys[start[lid].long()].max()):.6f}")
    histc_ms = _event_ms(lambda: torch.histc(perm, 64, lo_k, hi_k), 20)
    print(f"  torch.histc over the same keys (bins closed on the left, a "
          f"different binning, for scale only): {histc_ms:.6f} ms")
    rows["hist"] = _time_row(
        "hist", lambda: (thist.hist(perm, 64, lo_k, hi_k),),
        lambda: (thist.hist_plain(perm, 64, lo_k, hi_k),), None,
        [(n * 4 + 64 * 4, n * 5)], launches_7["hist"], errs["hist"],
        reps=20, plain_reps=3)
    bl = buckets.long()
    feats = torch.stack([torch.ones_like(xs), xs, ys, xs * ys, xs * xs], 1)
    rows["linfit"] = _time_row(
        "linfit", lambda: (tlinfit.linfit_sums(xs, ys, buckets, L),),
        lambda: (tlinfit.linfit_sums_plain(xs, ys, buckets, L),),
        lambda: torch.zeros((L, 5), dtype=torch.float32,
                            device=dev).index_add_(0, bl, feats),
        [(n * 12 + L * 5 * 4, n * 12)], launches_7["linfit"],
        errs["linfit"], reps=20, plain_reps=3)
    print(f"  K5 at n={n}: {rows['linfit']['ms']:.6f} ms (previous design "
          f"{K5_PREVIOUS_MS:.6f} ms, PERF.md; not re-run), bound "
          f"{rows['linfit']['bound_ms']:.6f} ms")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  shapes: K6 n={n} m=64, drift batch {batch}; K5 n={n} buckets="
          f"{L}; peak memory allocated {peak:.3f} GiB; wall "
          f"{time.perf_counter() - t_start:.1f} s")

    del keys32, keys, perm, dbatch, posn, buckets, xs, ys, fit, p64, cmp
    del bound, rel, lim, over, feats, bl, h_all, h_batch, exact, dcorpus
    del dpool, edges
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase 8: path D (LM serving), counted ----------------------------
    _path_d(args, dev, rows, h)
    print(f"  wall {time.perf_counter() - t_start:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # ---- phase 9: path E (baselines, snapshots, dataset), counted ---------
    _path_e(args, dev, rows, h)
    print(f"  wall {time.perf_counter() - t_start:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # ---- phase 10: path F (the sharded index), counted ---------------------
    _path_f(args, dev, rows, h)
    print(f"  wall {time.perf_counter() - t_start:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # ---- phase 11: path G (the index service), counted --------------------
    _path_g(args, dev, rows, h)
    print(f"  wall {time.perf_counter() - t_start:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # ---- phase 12: path H (the sharded index across positions), counted ---
    _path_h(args, dev, rows, h)
    print(f"  wall {time.perf_counter() - t_start:.1f} s")

    smi = _card()
    print(json.dumps({"kernels": [rows[k] for k in SOURCES]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": gpu,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
