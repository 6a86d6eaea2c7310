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
   lookup library (K1-K4), K5's or K7's, and in K8's tiles at every head
   dim they are built for; every instantiation of K8's tensor-core tile
   (D 64, 80, 96, 128) must hold HGMMA.
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
   epilogue: static ``lookup``, ``find`` and ``find_range``; then one
   more warm ``Index.find`` and ``Index.find_range`` under the sync
   census (``_census``: ``torch.cuda.set_sync_debug_mode("warn")``, every
   sync the CUDA runtime reports counted by the innermost ``file:line`` of
   the port's source, each of which must be a site the static analyzer's
   hot-sync rule flags; uncounted, untimed).
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
   tokens/s, peak memory and K8's share of each.  ``serve()`` passes the
   decode step ``cache_len`` as a device scalar, as the reference's loop
   does.  On the served weights and prompts the decode step then runs 32
   steps with an int ``cache_len`` and 32 with a device one under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync; ids equal,
   or logits within ``LM_LOGIT_TOL`` where they part), and a CUDA graph
   of the tensor form's step, warmed on a side stream, captured there and
   replayed with ``cache_len`` advanced on the card, must give the
   uncaptured steps' ids and caches bit for bit (its ms a step printed
   beside theirs).  The split-KV tile with tensor positions (its plan
   fixed by the cache's length) is held against its plain version at that
   plan on layer 0's decode inputs cut to 1,000 valid keys, where a
   planted non-empty run past ``kend``, combined, must fail the check.
   K8's forms the model does not call (``D_FORMS``: ``causal=False`` on
   each tile, head dims 80, 96 and 256 on the tensor-core and split-KV
   tiles, dh 256 prefill and dh 40 on the CUDA-core tile) are each held
   against plain and f64 within one bf16 ulp, a planted fault (a row's
   last key dropped, on inputs where that key carries the row) must fail,
   and each is timed beside SDPA and its bound: the ``forms`` of the
   ``flash`` and ``flash_decode`` rows of the kernels line.
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
   table.  Before the page table, with the front-end stopped, one warm
   batch of both tenants' finds (2,048 keys) and ranges (256 pairs),
   ``_dispatch`` then ``_resolve`` on this thread, under the sync census.
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
   launch a position a batch, every answer against the truth.  After the
   warm verbs at D = --shards, one more ``find`` and ``find_range`` there
   under the sync census.
13. The port's static analyzer (``repro_torch.analysis``) on the card's
   host over ``ANALYZED``: no unsuppressed finding, the counts by rule and
   the suppressed hot-sync sites printed; the kernel rule's static shared
   memory of every ``__global__`` held against the size of each entry's
   ``.nv.shared.<entry>`` section in ``cuobjdump -elf`` of the built
   library, less the 1 KiB the card reserves a block where the cubin
   reserves it (``_elf_smem``, ``_reserved_bytes``,
   ``_smem_vs_card``: at most the library's, equal where the rule bounded
   every dimension, every entry one the rule read), and those against the
   ``bytes smem`` of ptxas's report for each library phase 1 built now;
   every launch the rule bounds, and every launch in the traces of paths
   D, F and G (CUPTI's static plus dynamic bytes), against the card's own
   opt-in limit read at run time
   (``cudaDevAttrMaxSharedMemoryPerBlockOptin``); the census of phases 3,
   11 and 12 summed up.
14. Path I, LM training, counted: ``launch.train.train("granite-moe-1b-
   a400m", steps=8, batch=8, seq=2048, lr=1e-3)``, the one-card form
   (``configs.single_card``: 24 layers, d_model 1,024, 16 query and 8 KV
   heads, dh 64, 32 experts top-8, 1.385e9 random bf16 parameters from
   ``--seed``) at full width and depth, remat on, a loss read every step.
   K8 must launch 48 times a step (24 forward, 24 in the recompute), each
   on the tensor-core tile with its ``lse`` output, never on another tile;
   every loss finite and the last below the first.  On the first step's
   attention inputs of layers 0 and 23: ``lse`` within ``I_LSE_ATOL`` of
   the plain version's and an f64 oracle's, ``out`` bit-equal to the tile
   launched without ``lse`` and within one bf16 ulp of the magnitude of
   plain, and dq, dk, dv from ``FlashAttention`` within ``I_GRAD_ULPS``
   bf16 ulps of the leaf against f64 autograd of a dense softmax; K8 timed
   there with and without ``lse`` beside plain, SDPA and its bound (the
   ``path_i_*`` keys of the ``flash`` row).  One warm step traced with
   ``torch.profiler`` (``build/path_i_trace.json``): wall, device busy,
   idle share, device time by kind (K8 forward, the attention backward's
   torch ops, MoE dispatch and combine, GEMMs, the rest).  From the same
   weights and first batch, the loss and grad norm with the plain
   attention forward put in place of the tile by this script, within
   ``I_PLAIN_LOSS_RTOL`` / ``I_PLAIN_GNORM_RTOL``.  Then a cut of
   ``I_CUT_LAYERS`` layers of the same width trains 8 steps with a
   checkpoint at step 4 (async) and 8 (blocking) into a temporary store
   under ``build/`` (removed at the end): the restored step 4 and 8 equal
   the live state bit for bit, and a step from the restored step 4 gives
   the uninterrupted step 5's loss and parameters, bit for bit or, where
   the card's sums are not in a fixed order, within
   ``I_RESUME_LOSS_RTOL`` and one bf16 ulp (printed which).  Prints step
   seconds (warm: the median of steps 2-8), tokens a second, peak memory
   and K8 launches a step.
15. Path J, the recurrent families served, counted, one process after path
   I: ``launch.serve.serve`` at full width for xlstm-125m (``single_card``:
   12 layers, 6 mLSTM at head dim 384 = 2 x 768 / 4, 6 sLSTM at 192,
   vocabulary 50,304, random bf16 weights from ``--seed``) and for
   jamba-v0.1-52b cut to its first superblock (``J_JAMBA_LAYERS``: 7 Mamba
   layers and the attention layer at position 4, 32 / 8 heads at dh 128,
   MoE of 16 experts top-2 at positions 1, 3, 5 and 7; 1.33e10
   parameters, where 32 layers would not fit the card), each 4 requests
   of 2,048 prompt and 32 new tokens.  xlstm: K8's bias tile 6 times in
   prefill, no K8 in decode; jamba: the tensor-core tile once and the
   split-KV tile 32 times; K1 for the page table; finite logits.  K8
   against its plain version and an f64 oracle on every input each arch
   gives it; the bias tile also on ``J_BIAS_EDGES``
   (biases near +-1.4e3 that cancel, ``kv_valid < Skv`` with fk zero past
   it, Sq not a multiple of its 64-row block, dh 64, GQA with a
   ``q_offset``) and two planted faults that must fail the check (fk one
   key late, the causal mask one key late); the bias tile timed at the
   first mLSTM layer's shape against its plain version and SDPA in f32
   with the (B, H, S, S) f32 bias mask (``flash_bias`` row: ``bound_ms``
   on the bf16 tensor cores, ``bound_f32_ms``, ``sdpa_mask_bytes``).  A
   second prefill of each arch on the same weights traced with
   ``torch.profiler``: wall, device busy, idle share, device time by kind
   (K8, GEMMs, the sLSTM's and the Mamba scan's time loops, MoE dispatch
   and combine, the rest) and the loops' host time.  Then each arch served
   again with K8's plain version and with the plain version at 512-key
   blocks (the control: f32 rounding order only): prefill logits and the
   first decode step's, kernel vs plain, within ``J_LOGIT_FLOOR`` or
   ``J_CONTROL_FACTOR`` times the control's difference, whichever is
   larger, greedy first tokens equal where the margin exceeds twice it;
   xlstm (sLSTM layers, whose recurrence decorrelates such runs) to the
   logits' scale, ``J_SCALE_RTOL``.  Prints prefill s, decode tokens/s, peak
   memory and K8 launches by tile; phase 1 also fails on a spill in
   ``flash_bias_kernel`` and unless its SASS holds ``HGMMA`` (``wgmma``)
   and no ``HMMA`` (``mma.sync``).
16. Path K, the recurrent families trained, counted, after path J:
   ``launch.train.train("xlstm-125m", steps=K_STEPS, batch=8, seq=2048,
   lr=1e-3)`` in its one-card form at full width and depth (12 layers: 6
   mLSTM at head dim 384, 6 sLSTM at 192; 1.34e8 random bf16 parameters
   from ``--seed``), remat on, a loss read every step.  K8's bias tile
   must launch twice a mLSTM layer a step (the forward and the remat's
   recompute), each with its ``lse`` output, and no other tile; every
   loss finite and the last below the first.  On the first step's inputs
   of the first and last mLSTM layer: ``out`` with ``lse`` bit-equal to
   the tile without it and within one bf16 ulp of the magnitude of plain,
   ``lse`` within ``K_LSE_ATOL`` of plain's and an f64 oracle's, dq, dk,
   dv from ``FlashAttention`` within ``K_GRAD_ULPS`` bf16 ulps of the
   leaf of f64 autograd of the dense biased softmax, and dfq, dfk within
   ``K_BIAS_SUM_RTOL`` of the largest sum of |dS| over the same axis.
   ``lse`` on ``J_BIAS_EDGES`` the same way, and a planted fault (one
   query row's fq raised by ``K_LSE_FAULT`` tolerances: every output
   within one ulp, the ``lse`` check must fail).  The tile timed there
   with and without ``lse`` beside plain, SDPA in f32 with the f32 bias
   mask (forward only) and the torch-op backward (the ``path_k_*`` keys
   of the ``flash_bias`` row).  A warm step of a
   ``K_TRACE_LAYERS``-layer cut of the same width traced with
   ``torch.profiler``: wall, device busy, idle share, device time by kind
   (the sLSTM loop forward with the recompute and backward, the bias tile
   and its backward, GEMMs, the rest) and the loops' host spans.  Then one
   Mamba layer at jamba-v0.1-52b's full width (d_model 4,096, d_inner
   8,192) on ``K_MAMBA_B`` x ``K_MAMBA_S`` tokens in its train form: the
   input's and every weight's gradient with each scan chunk checkpointed
   equal to those without the checkpoint bit for bit, and within
   ``K_MAMBA_RTOL`` of each leaf's largest entry of the block in f64
   (``_mamba_f64``: the port's bf16 roundings kept, the rest f64).
   Prints step seconds (warm: the median of steps 2 on), tokens a second,
   peak memory, the backward's seconds and peak memory.
17. Path L, the embedding-input and M-RoPE families, counted, after path
   K: musicgen-large (``single_card``: 48 layers, d_model 2,048, 32 / 32
   heads at dh 64, frame embeddings (B, S, 2,048) in bf16 for inputs, no
   token table, no rotation; 3.226e9 random parameters) at full width and
   depth through ``launch.serve.serve`` at path D's traffic (4 requests of
   2,048 prompt and 32 new positions, each decode step a fresh frame
   draw): K8 launched once a layer on the prefill tile and once a layer a
   step on the split-KV tile, K1 for the page table; a second ``serve()``
   traced (``build/path_l_trace.json``, removed once read: wall, device
   busy, idle share, device time by kind, device events a decode step);
   served again with the plain attention, the prefill logits within
   ``LM_LOGIT_TOL``; then trained through ``launch.train.train`` at path
   I's batch and sequence, at its ``L_LR``, for ``L_TRAIN_STEPS`` steps (K8
   twice a layer a step, each with ``lse``; the loss finite and
   falling).  qwen2-vl-72b (M-RoPE with sections (16, 24, 24) over
   dh 128, 64 / 8 heads) at full width cut to ``L_QWEN_SERVE_LAYERS``
   layers, served the same way (the launcher's ids, t = h = w), then one
   more prefill through ``serve_step.make_prefill`` at image-layout ids
   (``_image_ids``: ``L_IMAGE``'s text prefix, a grid of patches at one t
   with h the row and w the column, text resuming at the largest id + 1)
   with the kernel and with the plain attention (within
   ``LM_LOGIT_TOL``) and at text positions (farther than that:
   the h and w ids reach the logits); ``apply_mrope`` at those ids within
   one bf16 ulp of the magnitude of an f64 evaluation of the formula and
   differing from ``apply_rope`` at the t ids; then trained cut to
   ``L_QWEN_TRAIN_LAYERS`` layer at ``L_QWEN_TRAIN_BATCH`` x 2,048 a step
   and one warm step traced (``_l_span``: the token table's index
   backward, K8's backward).  K8 on the first and last layer's inputs in
   prefill and in the last decode step against its plain version and an
   f64 oracle (``_k8_check``), and on the first training step's with
   ``lse`` and gradients (``_lse_grad_check``: ``lse`` within
   ``L_LSE_ATOL``); each of the five shapes (each arch's prefill and
   training, musicgen's decode; qwen2-vl's decode at group 8 too) timed
   against plain and SDPA beside its bound (``_l_time``; the
   ``path_l_shapes`` of the ``flash`` and ``flash_decode`` rows).  Prints
   prefill s, decode tokens/s, step s, tokens/s, peak memory and each
   stage's wall.
18. Path M, tensor-parallel and sequence-sharded serving, counted:
   qwen3-4b in its published layout (``get_arch``: tp 16, ``tp_shard``,
   KV heads replicated over ``model``; 36 layers, 4.41e9 random bf16
   parameters from ``--seed``, drawn once as the one-card tree, which is
   the layout's global tree) on ``ModelMesh`` positions that are all this
   card.  On ``M_MESH`` (1, 1, 16), path D's traffic (4 requests of 2,048
   + 32 tokens) through ``serve.step.make_prefill(cfg, mesh)`` and
   ``make_decode_step(cfg, mesh)``: K8's tensor-core tile once a layer a
   position in prefill, the split-KV tile (and its combine) once a layer a
   position a step; the prefill logits within ``LM_LOGIT_TOL`` of the
   one-card form's on the same global weights (else within
   ``J_CONTROL_FACTOR`` times a control: the one-card form with K8's plain
   version), the greedy tokens that agree printed; K8 at group 2 (2 query
   heads over 1 KV slot, dh 128) against plain and f64 (``_k8_check``)
   and timed in both tiles (``path_m_shape`` of the ``flash`` and
   ``flash_decode`` rows).  Then a ``M_SEQ_PROMPT``-token prompt
   prefilled on (1, 1, 16) into ``M_SEQ_MAX``-position caches, laid onto
   ``M_SEQ_MESH`` (1, 4, 16)'s 4 chunks of the time axis by
   ``gather_tree`` and ``shard_tree`` (chunks 0-1 full, chunk 2 the owner
   of the new tokens, chunk 3 empty), the unsharded (1, 1, 16) decode
   run ``M_STEPS`` greedy steps and the sequence-sharded decode the same
   steps teacher-forced with its tokens: K8's ``return_partial`` form
   (``flash_partial``) and the combine across positions
   (``flash_merge``) once a layer a position a step; each step's logits
   within ``LM_LOGIT_TOL`` of the unsharded decode's (else 4x a control:
   its last step with K8's plain version), the first token equal.  On the
   last step's inputs of the first and last layer, every chunk's
   ``return_partial`` against its plain version and an f64 partial
   (``_partial_check``: m, and l and acc at f64's m, within
   ``M_PART_RTOL`` of their scales), the combine against its plain
   version and the dense f64 attention over the global keys within one
   bf16 ulp of the magnitude (``_merge_check``); planted faults (the
   combine with every m_i = 0, so e^(m_i - M) dropped; a chunk's last
   64-key tile dropped) must be caught.  Prints prefill s, decode
   tokens/s and launches a step on both meshes, peak memory, the
   collectives' bytes a step as if each position were a card
   (``models.sharding.COLLECTIVES``), and the new forms' rows (kernel,
   plain, SDPA at group 2 over a chunk, bound).  No time across cards is
   measured: every position is this card.
19. Path N, MoE and Mamba under tensor parallelism, counted, after path
   M, on ``ModelMesh`` positions that are all this card.  qwen2-moe-a2.7b
   in its published layout (tp 16: 60 experts padded to 64, 4 a position;
   4 shared experts, 352 columns a position; 16 / 16 heads, QKV bias) cut
   to ``N_MOE_LAYERS`` layers at full width, then jamba-v0.1-52b's first
   superblock (path J's cut) in its: 7 Mamba layers at 512 channels a
   position, one attention layer (one KV slot a position), 4 MoE layers of
   one expert a position.  Each at path D's traffic on (1, 1, 16),
   ``N_STEPS`` greedy decode steps, through ``make_prefill(cfg, mesh)`` and
   ``make_decode_step(cfg, mesh)``, gated against the one-card form on the
   same global weights (padded experts dropped; jamba's Mamba ``in_proj``
   columns regrouped into the one-card halves): every MoE layer's routes
   of both forms recorded and the assignments that differ counted; prefill
   logits within ``LM_LOGIT_TOL`` (else 4x a control: the one-card form
   with K8's plain version) over the requests whose routes agree in every
   layer, and over all requests against the one-card form fed the TP
   form's experts (``layers.top_k`` answering with them).  Then jamba's
   ``long_500k`` cell: the global weights freed, an ``N_LONG_PROMPT``-token
   prompt prefilled on (1, 1, 16) into ``N_LONG_MAX``-position caches,
   the attention positions from the prompt's end to ``N_LONG_MAX -
   N_STEPS`` drawn from ``--seed`` at each KV slot's channel mean and
   deviation of the prompt's keys and values, ``N_STEPS`` steps decoded
   from there unsharded and, teacher-forced with its tokens, on (1, 4,
   16)'s four chunks of 131,072 (the owner last), its logits gated
   against the unsharded decode's over the steps whose routes agree, the
   first token equal.  K8 checked on the prefill tile at group 2, the
   decode tile over 524,288 keys, ``return_partial`` on each 131,072-key
   chunk and the combine of the four positions (``_k8_check``,
   ``_partial_check``, ``_merge_check``); the decode tile and the
   ``return_partial`` form timed at those lengths (``path_n`` keys of
   their rows).  Prints launches (as ``expect`` states them), the
   collectives' bytes by stage and by the block that calls each
   ``tp_psum``, peak memory and the path's wall.
20. Path O, training on a mesh, counted, after path N, on ``ModelMesh``
   positions that are all this card.  O1: ``O_ARCH`` (qwen3-4b) in its
   published layout cut to ``O_LAYERS`` layers at full width on
   ``O_MESH`` (2, 2, 16), the parameters, AdamW state and int8 residual
   in FSDP storage (``param_specs``; positions of the card holding one
   shard share it), path I's batch: ``O_STEPS`` steps of
   ``make_train_step(cfg, mesh, compress_pod=True)``, the last traced for
   the device's idle share (``_o_traced``).  Gates against the one-card
   step on the same global weights and batch, run first and freed, on
   the first step's gradients as the pods hold them before the pod sum
   (``_OSpy``: the compressed sum's inputs) summed over pod in f64, which
   is the sum without compression: the loss, the grad norm at twice the
   one-card norm (the reference's double-counted pod sum), every gathered
   gradient within ``O_GRAD_RL2`` relative L2 of twice the one-card
   gradient (``_o_pod_sum_gate``), each at least
   ``O_CONTROL_FACTOR`` times a control (the one-card step with K8's plain
   version); the compressed sum within its bound per element and every
   residual equal to ``(g + r) - q scale`` (``_o_compression``); K8's
   launches a step, remat's recompute counted apart
   (``flash.REMAT_LAUNCHES``), and K8 with ``lse`` on the step's own q,
   k, v (B 2, S 2,048, 2 query heads over 1 KV slot, dh 128) against
   plain and f64 and timed (``path_o_*`` keys of the ``flash`` row).  O2:
   ``O_MOE_ARCH`` (granite-moe-1b-a400m) in its published layout cut to
   ``O_MOE_LAYERS`` layers on ``O_MOE_MESH`` (1, 2, 16): one step, its
   MoE routes recorded and fed to the one-card step (a microbatch a data
   shard, so that C counts the same tokens) through ``layers.top_k``,
   gated the same way at 1x (no pod) and on AdamW's ``mu``; planted
   faults (final_ln's gradient not summed over its copies; final_ln
   updated twice) must fail the gates; then steps 2 and 3, the state
   saved at step 2 from the mesh and restored onto the same mesh and
   onto ``O_RESHARD`` (1, 4, 16): every gathered leaf equal to the saved
   bit for bit, and step 3 from the restore equal to step 3 live.
   Prints step seconds, tokens/s, idle share, peak memory and the
   collectives' calls and bytes a step by kind.
21. Path P, the launch cost tools (``_path_p``): first, uncounted, one
   production cell dry (``P_DRY_CELL``: qwen3-4b ``decode_32k`` on the
   16 x 16 mesh of meta positions, ``launch.dryrun.run_cell``: its row
   and wall time printed) and the FSDP prefill below dry on meta under
   ``launch.op_cost.OpCost``.  Then, counted: qwen3-4b's published layout
   cut to ``P_LAYERS`` (4) layers on ``P_MESH`` (1, 4, 16) positions of
   the card, path D's prompts and ``P_STEPS`` (4) greedy decode steps,
   served once from FSDP-stored weights (``make_prefill(cfg, mesh)``,
   gathered over ``data`` at use) and once with ``replicate_weights=
   True``: logits, ids and every cache equal bit for bit, K8's prefill
   and decode tiles launched once a layer a position a call; each form's
   collectives a step, stored weight bytes a position and peak memory.
   Then the FSDP prefill once more under ``OpCost`` on the card: its
   FLOPs by dtype, bytes, kernels, K8 launches and collective bytes equal
   the dry run's, position 0's argument bytes equal the dry run's; the
   roofline's compute and memory seconds beside the measured prefill (CUDA
   events) and the dry run's temporaries beside the rise of
   ``max_memory_allocated``.  Last the index service's cell on the card
   (``dryrun.lower_index_service``: 2^20 keys, 16 shards a position, 2^16
   queries through the stacked K1), its answers against a
   ``torch.searchsorted`` truth, 32 stacked K1 launches.

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
linear: A, C and E; stacked K1: F, H and P; stacked K2: F, G, G's page table
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
``combine_launches``, both with path L's shapes in ``path_l_shapes``;
``flash_bias`` at path J's mLSTM shape, with path K's launches and
``path_k_*`` times; ``flash_partial`` and ``flash_merge`` at path M's
sequence-sharded decode shape; path N's decode tile over 524,288 keys in
``flash_decode``'s ``path_n_shape`` and its ``return_partial`` form over
a 131,072-key chunk in ``flash_partial``'s ``path_n``; path O's launches
and K8 with ``lse`` at its shape in ``flash``'s ``path_o_*`` keys; path
P's launches in ``flash``'s, ``flash_decode``'s and ``sharded_lookup``'s
``path_p_launches``), the
card's
``name, power.limit`` from nvidia-smi,
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
    "flash_bias": "src/repro_torch/kernels/csrc/flash.cu",
    "flash_partial": "src/repro_torch/kernels/csrc/flash.cu",
    "flash_merge": "src/repro_torch/kernels/csrc/flash.cu",
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
    "flash_bias": "src/repro/kernels/flash.py:73",
    "flash_partial": "src/repro/kernels/flash.py:73",
    "flash_merge": "src/repro/kernels/flash.py:73",
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
# K8's forms path D's model does not call, checked and timed in phase 8 at
# public models' shapes (``_d_forms``): (row, what, dtype, B, Sq, Skv, H,
# Hkv, dh, q_offset, kv_valid, causal)
D_FORMS = (
    ("flash", "qwen3-4b prefill, causal=False", "bfloat16", 1, 2048, 2048,
     32, 8, 128, 0, 2048, False),
    ("flash", "phi-2 prefill (dh 80)", "bfloat16", 1, 2048, 2048, 32, 32,
     80, 0, 2048, True),
    ("flash", "phi-3-mini prefill (dh 96)", "bfloat16", 1, 2048, 2048, 32,
     32, 96, 0, 2048, True),
    ("flash", "gemma-7b prefill (dh 256, CUDA-core tile)", "bfloat16", 1,
     2048, 2048, 16, 16, 256, 0, 2048, True),
    ("flash", "dh 40 prefill (CUDA-core tile)", "bfloat16", 1, 1024, 1024,
     8, 8, 40, 0, 1024, True),
    ("flash", "f32 prefill, causal=False (CUDA-core tile)", "float32", 1,
     1024, 1024, 8, 8, 64, 0, 1024, False),
    ("flash_decode", "qwen3-4b decode, causal=False", "bfloat16", 4, 1,
     2080, 32, 8, 128, 2048, 2049, False),
    ("flash_decode", "phi-2 decode (dh 80)", "bfloat16", 4, 1, 2080, 32, 32,
     80, 2048, 2049, True),
    ("flash_decode", "phi-3-mini decode (dh 96)", "bfloat16", 4, 1, 2080,
     32, 32, 96, 2048, 2049, True),
    ("flash_decode", "gemma-7b decode (dh 256)", "bfloat16", 4, 1, 2080, 16,
     16, 256, 2048, 2049, True),
)
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
# Phase 13: the paths the port's static analyzer reads (its CLI's), and
# what torch.cuda.set_sync_debug_mode("warn") says at each sync
# Path I: the model trained (the reference launcher's default arch, in its
# one-card form), its batch, steps and lr (the CLI's), the checkpoint
# gate's depth cut and checkpoint interval, and the gates' tolerances: K8's
# lse against plain and an f64 oracle (absolute; lse is about 5 here), the
# attention gradients against f64 autograd in bf16 ulps of the leaf, the
# plain-attention step's loss and grad norm (relative), and the resumed
# step's loss where the card's sums are not in a fixed order (relative)
I_ARCH = "granite-moe-1b-a400m"
I_BATCH, I_SEQ, I_STEPS, I_LR = 8, 2048, 8, 1e-3
I_CUT_LAYERS, I_CKPT_EVERY = 4, 4
I_LSE_ATOL = 1e-5
I_GRAD_ULPS = 2
I_PLAIN_LOSS_RTOL, I_PLAIN_GNORM_RTOL = 1e-3, 1e-2
I_RESUME_LOSS_RTOL = 1e-5
# Path J: the recurrent families served (each arch's one-card form, 4
# requests of LM_PROMPT_LEN prompt and LM_NEW_TOKENS new tokens, as path D);
# jamba cut to its first superblock (7 Mamba layers and 1 attention layer;
# its 32 layers hold 5.16e10 parameters, 103 GB of bf16, over the card's
# 80 GB); K8's bias tile checked on these planted edges (name, B, Sq, Skv,
# H, Hkv, dh, q_offset, kv_valid or None for Skv, forget-gate shift)
J_ARCHS = ("xlstm-125m", "jamba-v0.1-52b")
J_JAMBA_LAYERS = 8
J_BIAS_EDGES = (
    ("biases near +-1.4e3 that cancel (forget gates N(0.3, 1))", 4, 2048,
     2048, 4, 4, 384, 0, None, 0.3),
    ("kv_valid < Skv, fk zero past it", 2, 2048, 2048, 4, 4, 384, 0, 1500,
     0.0),
    ("Sq not a multiple of the 64-row block", 2, 2047, 2047, 4, 4, 384, 0,
     None, 0.0),
    ("dh 64", 4, 2048, 2048, 4, 4, 64, 0, None, 0.0),
    ("dh 64, GQA 8 / 4, q_offset 16", 2, 1000, 1016, 8, 4, 64, 16, None,
     0.0))
# The end-to-end gate: kernel vs plain logits within max(J_LOGIT_FLOOR,
# J_CONTROL_FACTOR x the control's difference), the control being the plain
# version with 512-key blocks against its 1,024-key blocks: an f32
# rounding-order change alone.  An arch with sLSTM layers is held to the
# logits' scale instead (standard deviation within J_SCALE_RTOL of plain's,
# mean within J_SCALE_RTOL of that deviation): with random weights the
# sLSTM's 2,048-step recurrence decorrelates runs that differ at f32 level
# (xlstm's kernel and plain prefill logits 0.86 and 1.88 apart in two
# designs of the bias tile, the control 0.35, the logits up to 4.5), while
# every K8 call of the path is within one bf16 ulp on its own inputs
J_LOGIT_FLOOR = 0.25
J_CONTROL_FACTOR = 4
J_CONTROL_BLOCK = 512
J_SCALE_RTOL = 0.1
# Path K: the recurrent families trained.  xlstm-125m (the launcher's
# --arch) in its one-card form at full width and depth, its batch,
# sequence, steps and lr; the gates' tolerances: the bias tile's lse
# against plain and an f64 oracle (absolute: each biased score carries the
# f32 roundings of adding |F| up to about 1.7e3, 1.2e-4 an ulp there), dq /
# dk / dv against f64 autograd in bf16 ulps of the leaf, dfq / dfk within
# a share of the largest sum of |dS| over the same axis (f64), the lse of
# the planted fault's row raised by this many tolerances.  Then one Mamba
# layer at jamba's full width in its train form, batch and sequence, its
# gradients against the same block in f64 (each leaf's largest |diff| over
# its largest entry)
K_ARCH = "xlstm-125m"
K_BATCH, K_SEQ, K_STEPS, K_LR = 8, 2048, 4, 1e-3
K_LSE_ATOL = 1e-3
K_GRAD_ULPS = 2
K_BIAS_SUM_RTOL = 2e-3
K_LSE_FAULT = 16
# the traced warm step's depth cut: one superblock (an mLSTM and an sLSTM
# layer) at full width, batch and sequence.  All 12 layers' chrome trace
# ran to 2.1 GB and took 81 s to read back in this phase's first run
K_TRACE_LAYERS = 2
K_MAMBA_ARCH = "jamba-v0.1-52b"
K_MAMBA_B, K_MAMBA_S = 2, 2048
K_MAMBA_RTOL = 0.03
# Path L: the embedding-input and M-RoPE families at path D's serving
# traffic and path I's training traffic (I_BATCH or L_QWEN_TRAIN_BATCH x
# I_SEQ a step), L_TRAIN_STEPS steps.  musicgen-large at full width and
# depth; qwen2-vl-72b at full width cut in depth: L_QWEN_SERVE_LAYERS
# layers served (9.513e9 parameters, 19.0 GB; its 80 layers hold 7.27e10,
# 145 GB, over the card's 80 GB) and L_QWEN_TRAIN_LAYERS trained (3.369e9
# parameters, 53.9 GB of weights, gradients and AdamW state before
# activations); the image layout of its extra prefill (text positions,
# grid rows, grid columns); K8's lse against plain and f64 (absolute).
# Each arch trains at its L_LR: AdamW's first steps move every weight by
# about lr, in step over a layer's fan-in, so a layer's output moves by
# about lr x fan-in of its scale, and the launcher has no warmup (the
# published recipes warm up over thousands of steps).  On an H100, at path
# I's 1e-3 musicgen diverged (losses 8.14, 14.41, 14.91, 13.94), at 1e-4
# too (8.14, 7.53, 8.41, 9.16); at 1e-5 it fell (8.14, 8.00, 8.07, 8.01),
# and qwen2-vl's fan-in of 29,568 diverged (12.39, 10.97, 19.51, 18.41).
L_TRAIN_STEPS = 4
L_LR = {"musicgen-large": 1e-5, "qwen2-vl-72b": 1e-6}
L_QWEN_SERVE_LAYERS = 8
L_QWEN_TRAIN_LAYERS = 1
L_QWEN_TRAIN_BATCH = 4
L_IMAGE = (100, 32, 48)
L_LSE_ATOL = 1e-3
# Path M: qwen3-4b in its published layout (tp 16, tp_shard) on mesh
# positions that are all the one card: path D's traffic on (1, 1, 16);
# then a prompt of M_SEQ_PROMPT tokens into caches of M_SEQ_MAX positions
# (qwen3's native context, the reference's decode_32k length) decoded
# M_STEPS steps with the cache's time axis over the 4 data positions of
# (1, 4, 16): chunks 0-1 full, chunk 2 the new tokens' owner (the first
# step writes its first position), chunk 3 empty.  M_STEPS is cut from
# path D's 32: a sequence-sharded step is the host's, 4.8 s on an H100
# (64 positions x 36 layers of about 100 device events each), and 32 of
# them with the unsharded steps beside them would take about 200 s of the
# script's time limit.  K8's return_partial form against its plain
# version and f64: m, and l and acc brought to f64's m, within
# M_PART_RTOL of their scales (f32 sums over up to 8,192 keys)
M_ARCH = "qwen3-4b"
M_MESH, M_SEQ_MESH = (1, 1, 16), (1, 4, 16)
M_SEQ_MAX, M_SEQ_PROMPT, M_STEPS = 32768, 16384, 8
M_PART_RTOL = 1e-4
# Path N: MoE and Mamba under tensor parallelism, at path D's traffic with
# N_STEPS decode steps (cut from 32: a TP step is the host's, 16
# positions' launches a layer), then jamba's long_500k cell: one
# 524,288-position context, N_LONG_PROMPT tokens of it prefilled (a
# prefill of 524,288 through 16 positions' host scan loops would take many
# minutes), the rest of the attention positions drawn, N_STEPS steps
# decoded.  qwen2-moe cut to N_MOE_LAYERS layers at full width; jamba to
# path J's first superblock
N_MOE_ARCH, N_MOE_LAYERS = "qwen2-moe-a2.7b", 4
N_JAMBA_ARCH = "jamba-v0.1-52b"
N_MESH, N_SEQ_MESH = (1, 1, 16), (1, 4, 16)
N_STEPS = 8
N_LONG_MAX, N_LONG_PROMPT = 524288, 4096
N_PSUM_BY = {"embed_tokens": "embedding", "_attention_mesh": "attention",
             "mlp_block": "MLP", "moe_block": "MoE",
             "mamba_block": "Mamba (x_proj features, output)",
             "_run_block_mesh": "parallel block"}
# Path O: training on a mesh, on positions that are all this card.  O1:
# qwen3-4b in its published layout (tp 16, KV heads replicated) cut to
# O_LAYERS of its 36 layers at full width (1.18e9 parameters, 0.78e9 of
# them the embedding and the head) on O_MESH (data cut from the
# production 16 to 2), path I's traffic: O_STEPS steps with
# compress_pod.  O2:
# granite-moe-1b-a400m's published layout cut to O_MOE_LAYERS of its 24
# layers on O_MOE_MESH, one step gated, then the checkpoint gate on its
# state: saved at step 2, restored onto the same mesh and onto O_RESHARD.
# O1's state (about 21 GB with the residual) is not checkpointed: the
# snapshot store writes about 0.3 GB/s (path E), minutes for it.
O_ARCH, O_LAYERS, O_MESH, O_STEPS = "qwen3-4b", 4, (2, 2, 16), 3
O_MOE_ARCH, O_MOE_LAYERS, O_MOE_MESH = "granite-moe-1b-a400m", 2, (1, 2, 16)
O_RESHARD = (1, 4, 16)
O_LR = 1e-4
# The gates against the one-card step: the loss (relative), the grad norm
# (relative, against twice the one-card norm on O1's two pods), every
# gathered gradient and AdamW mu (relative L2), each at least
# O_CONTROL_FACTOR times the same reading of the one-card step with K8's
# plain version; the compression's f32 slack, in ulps of the largest
# |g + r| of a pod.  The gradients are bf16, and the mesh rounds other
# values to bf16 than the one-card form does (a block's output is the sum
# of 16 positions' f32 partials, a replicated leaf's gradient the sum of
# its copies' bf16 shares): on the CPU rehearsal (d_model 64) every leaf
# came within 0.0035-0.0153 relative L2
O_LOSS_RTOL, O_GNORM_RTOL, O_GRAD_RL2 = 1e-3, 1e-2, 5e-2
O_CONTROL_FACTOR = 4
O_COMP_SLACK = 4
# Path P: the launch cost tools on the card.  qwen3-4b's published layout
# cut to P_LAYERS layers (path O1's cut) on P_MESH positions of this card,
# path D's prompts (LM_REQUESTS x LM_PROMPT_LEN) then P_STEPS greedy
# decode steps, served from FSDP-stored weights and from replicated ones;
# the FSDP prefill counted by OpCost on the card and dry on meta; the
# index service's cell on the card; one production cell dry (P_DRY_CELL)
P_LAYERS, P_MESH, P_STEPS = 4, (1, 4, 16), 4
P_DRY_CELL = ("qwen3-4b", "decode_32k", False)
ANALYZED = ("src/repro_torch", "chip_smoke.py", "time_verbs.py",
            "examples/index_service_torch.py")
SYNC_WARNING = "called a synchronizing CUDA operation"


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


def _sass_functions(sass: str, name: str) -> list:
    """The SASS text of each function of a ``cuobjdump -sass`` listing
    whose mangled name holds ``name``."""
    out, cur = [], None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = [] if name in line else None
            if cur is not None:
                out.append(cur)
        elif cur is not None:
            cur.append(line)
    return ["\n".join(f) for f in out]


def _entry_report(report: str, name: str) -> str:
    """The lines of a ptxas report (``-Xptxas -v``) about the entry
    functions whose mangled names hold ``name``."""
    import re
    out, mine = [], False
    for line in report.splitlines():
        mm = re.search(r"(?:Compiling entry function|Function properties "
                       r"for) '?([^' ]+)", line)
        if mm:
            mine = name in mm[1]
        if mine:
            out.append(line)
    return "\n".join(out)


def _ptxas_smem(report: str) -> dict:
    """Static shared memory per entry function of a build report
    (``-Xptxas -v``): mangled name -> the ``bytes smem`` of its ``Used``
    line (0 where the line names none)."""
    import re
    out, entry = {}, None
    for line in report.splitlines():
        mm = re.search(r"Compiling entry function '([^']+)'", line)
        if mm:
            entry = mm[1]
            continue
        if entry is not None and "Used" in line and "registers" in line:
            sm = re.search(r"(\d+) bytes smem", line)
            out[entry] = int(sm[1]) if sm else 0
            entry = None
    return out


@functools.lru_cache(maxsize=1)
def _analysis() -> tuple:
    """The port's static analyzer over ``ANALYZED`` (pure AST, on the
    host), once: every finding, suppressed ones with their reasons."""
    from repro_torch.analysis import analyze
    return tuple(analyze([ROOT / p for p in ANALYZED], root=ROOT))


def _hot_sync_spans() -> dict:
    """path -> [(first, last line)] of every hot-sync finding, suppressed
    or not: the sites the rule flags."""
    from repro_torch.analysis.engine import span
    out = {}
    for fd in _analysis():
        if fd.rule == "hot-sync":
            out.setdefault(str(fd.path), []).append(span(fd))
    return out


def _census(h, where: str, calls: dict) -> None:
    """One warm call of each of ``calls`` with the CUDA runtime's sync
    detector on (``torch.cuda.set_sync_debug_mode("warn")``): each sync it
    reports, by the innermost frame in the port's source (else where the
    warning points), counted by site; fails on a site that the analyzer's
    hot-sync rule does not flag.  Launches do not count."""
    import warnings

    import torch
    flagged = _hot_sync_spans()
    src = str(ROOT / "src" / "repro_torch") + os.sep
    for name, fn in calls.items():
        sites = {}
        show = warnings.showwarning

        def hook(message, category, filename, lineno, file=None, line=None,
                 sites=sites, show=show):
            if SYNC_WARNING not in str(message):
                return show(message, category, filename, lineno, file, line)
            f = sys._getframe(1)
            while f is not None and not f.f_code.co_filename.startswith(src):
                f = f.f_back
            site = (os.path.relpath(f.f_code.co_filename, ROOT), f.f_lineno) \
                if f is not None else (filename, lineno)
            sites[site] = sites.get(site, 0) + 1
        torch.cuda.synchronize()
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = hook
            torch.cuda.set_sync_debug_mode("warn")
            try:
                h.uncounted(fn)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        missed = sorted(s for s in sites if not any(
            a <= s[1] <= b for a, b in flagged.get(s[0], ())))
        print(f"  sync census ({where}) {name}: {sum(sites.values())} syncs "
              f"a call: " + (", ".join(
                  f"{p}:{ln} x{c}" for (p, ln), c in sorted(sites.items()))
                  or "none"))
        if missed:
            raise AssertionError(
                f"syncs at sites the hot-sync rule does not flag ({where}, "
                f"{name}): {missed}")
        h.census.setdefault(where, {})[name] = sites


def _entry_name(mangled: str) -> str | None:
    """The unqualified name of a mangled entry function, past an
    anonymous namespace (``_ZN<n>_GLOBAL__N_...<len><name>...``)."""
    import re
    i = 3 if mangled.startswith("_ZN") else 2
    while True:
        d = re.match(r"\d+", mangled[i:])
        if d is None:
            return None
        i += len(d[0])
        ident, i = mangled[i:i + int(d[0])], i + int(d[0])
        if not ident.startswith("_GLOBAL__N"):
            return ident


def _elf_smem(text: str, reserved: int) -> dict:
    """Static shared memory per function of a cubin, from the section
    table of ``cuobjdump -elf``: mangled name -> the size of its
    ``.nv.shared.<name>`` section (0 for a ``.text.<name>`` without one).
    Where the cubin has a ``.nv.shared.reserved`` section, each function's
    section also holds the ``reserved`` bytes the card keeps a block for
    the system: they are taken off."""
    sizes, cols_n = {}, None
    for line in text.splitlines():
        cols = line.split()
        if cols[:3] == ["Index", "Offset", "Size"]:
            cols_n = len(cols)
            continue
        if cols_n is None or len(cols) != cols_n:
            cols_n = None
            continue
        sizes[cols[-1]] = int(cols[2], 16)
    has_reserve = any(n.startswith(".nv.shared.reserved") for n in sizes)
    out = {}
    for name, size in sizes.items():
        if name.startswith(".text."):
            out.setdefault(name[len(".text."):], 0)
        elif name.startswith(".nv.shared.") and \
                not name.startswith(".nv.shared.reserved"):
            got = size - (reserved if has_reserve else 0)
            if got < 0:
                raise AssertionError(f"{name}: {size} bytes, below the "
                                     f"{reserved} reserved a block")
            out[name[len(".nv.shared."):]] = got
    return out


def _smem_vs_card(usage: dict) -> list:
    """Each entry function's static shared memory as the built library
    records it (``{library: {mangled: bytes}}``) against the kernel
    rule's figure for its ``__global__``: the figure must be at most the
    library's, and equal where the rule bounded every dimension; every
    ``__global__`` the rule read must be there.  Returns (library, kernel,
    library bytes, figure, exact) rows; a function that is no
    ``__global__`` of the source (a runtime helper) gets kernel None."""
    from repro_torch.analysis import engine as teng
    from repro_torch.analysis.rules import kernel as tkernel
    rows = []
    for lib, entries in sorted(usage.items()):
        f = next(x for x in teng.load_project(
            [ROOT / f"src/repro_torch/kernels/csrc/{lib}.cu"],
            root=ROOT).cuda)
        kernels = {k.kernel: k for k in tkernel.figures(f)[0]}
        seen = set()
        for mangled, got in sorted(entries.items()):
            k = kernels.get(_entry_name(mangled) or "")
            if k is None:
                rows.append((lib, None, got, 0, False))
                continue
            seen.add(k.kernel)
            if k.bytes > got or (k.exact and k.bytes != got):
                raise AssertionError(
                    f"{lib}.cu {k.kernel}: the kernel rule's static shared "
                    f"memory {'' if k.exact else 'at least '}{k.bytes} "
                    f"bytes against the library's {got}")
            rows.append((lib, k.kernel, got, k.bytes, k.exact))
        if set(kernels) - seen:
            raise AssertionError(f"{lib}: no entry in the library for "
                                 f"{sorted(set(kernels) - seen)}")
    return rows


def _trace_smem() -> dict:
    """kernel name -> the most shared memory (static plus dynamic) a
    launch of it used, as CUPTI recorded it in the traces paths D, F and
    G left under ``build/`` (``args["shared memory"]`` of each kernel
    event; {} where the traces carry no such figure)."""
    import re
    out = {}
    for name in ("path_d_trace.json", "path_f_trace.json",
                 "path_g_trace.json"):
        path = ROOT / "build" / name
        if not path.exists():
            continue
        for ev in json.loads(path.read_text()).get("traceEvents", []):
            got = (ev.get("args") or {}).get("shared memory")
            if ev.get("cat") == "kernel" and got is not None:
                k = re.split(r"[<(]", ev.get("name", "").replace(
                    "(anonymous namespace)", ""))[0].split("::")[-1]
                k = (k.split() or ["?"])[-1]
                out[k] = max(out.get(k, 0), int(got))
    return out


@functools.lru_cache(maxsize=None)
def _device_attribute(attr: int) -> int:
    """``cudaDeviceGetAttribute(attr)`` of card 0, read at run time."""
    import ctypes
    cudart = ctypes.CDLL("/usr/local/cuda/lib64/libcudart.so")
    v = ctypes.c_int()
    rc = cudart.cudaDeviceGetAttribute(ctypes.byref(v), attr, 0)
    if rc != 0:
        raise RuntimeError(f"cudaDeviceGetAttribute({attr}): error {rc}")
    return v.value


def _optin_bytes() -> int:
    """The card's own per-block opt-in shared memory limit
    (cudaDevAttrMaxSharedMemoryPerBlockOptin), read at run time."""
    import torch
    got = getattr(torch.cuda.get_device_properties(0),
                  "shared_memory_per_block_optin", None)
    return int(got) if got else _device_attribute(97)


def _reserved_bytes() -> int:
    """The shared memory the card keeps in every block for the system
    (cudaDevAttrReservedSharedMemoryPerBlock, 1 KiB since sm_80)."""
    return _device_attribute(111)


def _phase13(reports: dict, h) -> None:
    """The static analyzer on the card: no unsuppressed finding; the
    kernel rule's shared memory against the built libraries and the
    card's opt-in limit; the sync census of phases 3, 11 and 12."""
    from repro_torch.analysis import Config
    from repro_torch.analysis import engine as teng
    from repro_torch.analysis.rules import kernel as tkernel
    findings = _analysis()
    bad = [fd for fd in findings if fd.suppressed is None]
    if bad:
        raise AssertionError("the port's static analyzer: " + "; ".join(
            fd.render() for fd in bad))
    by_rule = {}
    for fd in findings:
        by_rule[fd.rule] = by_rule.get(fd.rule, 0) + 1
    hot = {(str(fd.path), fd.line) for fd in findings
           if fd.rule == "hot-sync"}
    print(f"phase 13: the static analyzer ({' '.join(ANALYZED)}): 0 "
          f"unsuppressed findings; suppressed by rule {by_rule}; "
          f"{len(hot)} suppressed hot-sync sites on the hot path, in "
          f"{len({p for p, _ in hot})} files")
    # static shared memory: each library's own record (cuobjdump), held
    # against ptxas's report wherever this process built the library
    from repro_torch.kernels import build
    reserved = _reserved_bytes()
    usage = {lib: _elf_smem(build.elf(lib), reserved)
             for lib in build.SIGNATURES}
    for lib, report in reports.items():
        ptxas = _ptxas_smem(report)
        if {k: usage[lib].get(k) for k in ptxas} != ptxas:
            raise AssertionError(f"{lib}: cuobjdump -elf "
                                 f"{usage[lib]} against ptxas {ptxas}")
    rows = _smem_vs_card(usage)
    others = sorted({(lib, got) for lib, k, got, _, _ in rows if k is None})
    rows = [r for r in rows if r[1] is not None]
    shown = {}
    for lib, k, got, fig, exact in rows:
        key = (lib, k, got, fig, exact)
        shown[key] = shown.get(key, 0) + 1
    for (lib, k, got, fig, exact), c in sorted(shown.items()):
        if got or fig:
            print(f"  {lib}.cu {k}: {got} bytes static shared memory "
                  f"(its .nv.shared section), the kernel "
                  f"rule {fig if exact else f'at least {fig}'} ({c} entries)")
    print(f"  static shared memory: {len(rows)} entries of "
          f"{len(usage)} libraries (cuobjdump -elf's .nv.shared sections "
          f"less the {reserved} bytes reserved a block where the cubin "
          f"reserves them; ptxas's report also read for "
          f"{sorted(reports) or 'none: built before this process'}), "
          f"each at or above the kernel rule's figure, equal where it is "
          f"exact ({sum(1 for *_, e in rows if e)} of them); "
          f"{sum(1 for _, _, g, _, _ in rows if g == 0)} at 0 bytes; "
          f"functions that are no __global__ (library, bytes): "
          f"{others or 'none'}")
    optin = _optin_bytes()
    project = teng.load_project([ROOT / "src/repro_torch/kernels/csrc"],
                                root=ROOT)
    n_bounded, unbounded = 0, set()
    for f in project.cuda:
        for la in tkernel.figures(f)[1]:
            if la.static + (la.dynamic or 0) > optin:
                raise AssertionError(
                    f"{la.file}:{la.line}: {la.kernel} launch of at least "
                    f"{la.static + (la.dynamic or 0)} bytes of shared "
                    f"memory, above the card's opt-in limit {optin}")
            if la.dynamic is None:
                unbounded.add(la.kernel)
            else:
                n_bounded += 1
    traced = _trace_smem()
    over = {k: v for k, v in traced.items() if v > optin}
    if over:
        raise AssertionError(f"traced launches above the card's opt-in "
                             f"limit {optin}: {over}")
    print(f"  launches: the card's opt-in limit {optin} bytes a block "
          f"(Config.smem_budget_bytes {Config().smem_budget_bytes}); "
          f"{n_bounded} launch figures bounded by the constants, within "
          f"it; dynamic bytes set at run time: {', '.join(sorted(unbounded))}"
          f"; traced launches (paths D, F, G; static plus dynamic, "
          f"CUPTI), the most a kernel: " + (", ".join(
              f"{k} {v}" for k, v in sorted(traced.items()) if v)
              or "no figure in the traces"))
    for where, calls in h.census.items():
        for name, sites in calls.items():
            print(f"  sync census {where}, {name}: "
                  f"{sum(sites.values())} syncs a call at {len(sites)} "
                  f"sites, every one flagged by hot-sync")


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


def _k8_bound(work) -> tuple:
    """(bound_ms, bound_by) of one K8 call's ``kernels.cost`` work (its
    ``flash.tile_work``): the operations at the rate of the unit they run
    on (the bf16 tensor cores for the prefill and bias tiles, f32 for the
    rest), the bytes at HBM's."""
    rate = BF16_TC_OPS_PER_S if work.unit == "bf16" else F32_OPS_PER_S
    t_ops = work.ops / rate * 1e3
    t_bytes = work.bytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _bf16_ulp(mag):
    """One bf16 ulp at each magnitude (8 significant bits)."""
    import torch
    m = mag.abs().to(torch.float64).clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(m)) - 7)


def _keep(q, k, q_offset: int = 0, kv_valid=None, causal: bool = True):
    """The mask of K8's call, (Sq, Skv): key j <= q_offset + i (causal)
    and j < kv_valid."""
    import torch
    qp = q_offset + torch.arange(q.shape[1], device=q.device)[:, None]
    kp = torch.arange(k.shape[1], device=q.device)[None, :]
    keep = kp < (k.shape[1] if kv_valid is None else kv_valid)
    return ((kp <= qp) & keep) if causal else keep.expand(q.shape[1], -1)


def _f64_scores(qb, kb, bias_b, keep):
    """One batch row's scaled (with ``bias_b = (fq[b], fk[b])``, also
    biased) scores in f64, (H, Sq, Skv), -inf outside ``keep``, from f64
    qb (Sq, H, dh) and kb (Skv, Hkv, dh)."""
    import math
    import torch
    G = qb.shape[1] // kb.shape[1]
    s = torch.einsum("qhd,khd->hqk", qb, kb.repeat_interleave(G, 1)) \
        / math.sqrt(qb.shape[-1])
    if bias_b is not None:
        s = s + bias_b[0].double().T[:, :, None] + \
            bias_b[1].double().T[:, None, :]
    return s.masked_fill(~keep, float("-inf"))


def _dense_f64(q, k, v, q_offset: int, kv_valid: int, bias=None,
               causal: bool = True):
    """Attention by a dense f64 softmax, one batch row at a time: an oracle
    independent of the online softmax; ``bias = (fq, fk)`` adds the
    per-query and per-key terms (K8's bias form); ``causal=False`` keeps
    every key below ``kv_valid``."""
    import torch
    G = q.shape[2] // k.shape[2]
    keep = _keep(q, k, q_offset, kv_valid, causal)
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    for b in range(q.shape[0]):
        s = _f64_scores(q[b].double(), k[b].double(),
                        None if bias is None else (bias[0][b], bias[1][b]),
                        keep)
        out[b] = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1),
                              v[b].double().repeat_interleave(G, 1))
    return out


def _sdpa_call(q, k, v, q_offset: int, kv_valid: int, causal: bool = True):
    """``scaled_dot_product_attention(enable_gqa=True)`` on K8's inputs,
    set up once and returned as a call giving (B, H, Sq, dh):
    ``is_causal`` over the first ``kv_valid`` keys where the queries are
    positions 0 .. kv_valid - 1 (prefill), a boolean mask otherwise; without
    the causal mask no mask over the first ``kv_valid`` keys."""
    import torch
    import torch.nn.functional as F
    Sq = q.shape[1]
    if not causal or (q_offset == 0 and kv_valid == Sq):
        qs, ks, vs = (t.transpose(1, 2).contiguous()
                      for t in (q, k[:, :kv_valid], v[:, :kv_valid]))
        return lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=causal, enable_gqa=True)
    qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    kp = torch.arange(k.shape[1], device=q.device)
    keep = ((kp <= q_offset + torch.arange(Sq, device=q.device)[:, None])
            & (kp < kv_valid))[None, None]
    return lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=keep, enable_gqa=True)


K8_KERNELS = ("flash_tc_kernel", "flash_split_kernel", "flash_combine_kernel",
              "flash_cc_kernel", "flash_bias_kernel")


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
        self.census = {}        # phase -> call -> {(path, line): syncs}

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
    captured, logits, tables, kept = {}, {}, [], {}
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
                if tag == "kernel":     # the weights and prompts, kept for
                    kept.update(params=a[0], prompts=a[2], pos=a[3])
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
            "flash_cc": 0, "flash_bias": 0}
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
        work = tflash.tile_work(q, k, qo, kvv, name)
        rows[name] = _time_row(
            name, lambda q=q, k=k, v=v, qo=qo, kvv=kvv: tflash.flash_attention(
                q, k, v, q_offset=qo, kv_valid=kvv),
            lambda q=q, k=k, v=v, qo=qo, kvv=kvv: tflash.flash_attention_plain(
                q, k, v, q_offset=qo, kv_valid=kvv),
            _sdpa_call(q, k, v, qo, kvv), [work[:2]], launches[name],
            errs[name],
            reps=20 if name == "flash" else 100,
            plain_reps=5 if name == "flash" else 20)
        if name == "flash":
            # the prefill tile computes on the bf16 tensor cores: its bound
            # is the same operations at their rate, the f32 one kept beside
            rows[name]["bound_f32_ms"] = rows[name]["bound_ms"]
            rows[name]["bound_ms"], rows[name]["bound_by"] = _k8_bound(work)
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
    _d_device_split(h, *captured[("decode", 0)][:3], rows)
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
    del res_p, lp
    _d_device_steps(cfg, kept, toks)
    del kept
    _d_forms(h, dev, rows)


def _planted_last_key(q, k, qo: int, kvv: int, causal: bool):
    """A copy of k whose key ``kvv - 1`` is, in every KV head, the query
    row that sees it last (the first row without the causal mask): that
    row puts most of its weight there, so that dropping the key (kv_valid
    - 1) moves its output far beyond one bf16 ulp."""
    G = q.shape[2] // k.shape[2]
    i = min(q.shape[1] - 1, kvv - 1 - qo) if causal else 0
    planted = k.clone()
    planted[:, kvv - 1] = q[:, i, ::G]
    return planted


def _d_forms(h, dev, rows) -> None:
    """Phase 8: K8's forms that path D's model does not call, at public
    models' shapes with seeded inputs: ``causal=False`` on the tensor-core,
    CUDA-core and split-KV tiles, head dims 80, 96 and 256 on the
    tensor-core and split-KV tiles (dh 256 prefill on the CUDA-core tile)
    and 40 on the CUDA-core tile.  Each is held against its plain version
    and the f64 oracle within one bf16 ulp of the magnitude
    (``_k8_check``), a planted fault (a row's last key dropped, on inputs
    where that key carries the row) must fail the check, and each is timed
    beside SDPA and its bound: the ``forms`` of the ``flash`` and
    ``flash_decode`` rows."""
    import functools
    import torch
    from repro_torch.kernels import flash as tflash
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    for row, what, dt, B, Sq, Skv, H, Hkv, dh, qo, kvv, causal in D_FORMS:
        dt = getattr(torch, dt)

        def rn(*shape):
            return torch.randn(shape, generator=g, device=dev).to(dt)
        q, k, v = rn(B, Sq, H, dh), rn(B, Skv, Hkv, dh), rn(B, Skv, Hkv, dh)
        tile = tflash.tile_of(dt, dh, Sq * (H // Hkv))
        call = functools.partial(tflash.flash_attention, q, k, v,
                                 q_offset=qo, kv_valid=kvv, causal=causal)
        before = dict(tflash.LAUNCHES)
        got = call()
        done = {t: tflash.LAUNCHES[t] - before[t] for t in before}
        if done[tile] != 1 or sum(done.values()) != 1 + (
                tile == "flash_decode"):
            raise AssertionError(f"K8 {what}: launches {done}, want one of "
                                 f"{tile}")
        chk = _k8_check(h, what, q, k, v, qo, kvv, causal=causal, got=got)
        tflash.LAUNCHES.update(before)
        # the planted fault: the key that carries a row, dropped
        kp = _planted_last_key(q, k, qo, kvv, causal)
        bad = h.uncounted(functools.partial(
            tflash.flash_attention, q, kp, v, q_offset=qo, kv_valid=kvv - 1,
            causal=causal))
        mag = tflash.flash_attention_plain(q.float(), kp.float(),
                                           v.float().abs(), q_offset=qo,
                                           kv_valid=kvv, causal=causal)
        d = (bad.double() - _dense_f64(q, kp, v, qo, kvv, None, causal)) \
            .abs() / _bf16_ulp(mag)
        if not bool((d > 1).any()):
            raise AssertionError(f"K8 {what}: the planted fault (a row's "
                                 f"last key dropped) passes the check")
        reps = 20 if row == "flash" else 100
        k_ms = _event_ms(lambda: h.uncounted(call), reps)
        p_ms = _event_ms(functools.partial(
            tflash.flash_attention_plain, q, k, v, q_offset=qo, kv_valid=kvv,
            causal=causal), 3, warmup=1)
        s_ms = _event_ms(_sdpa_call(q, k, v, qo, kvv, causal), reps)
        work = tflash.tile_work(q, k, qo, kvv, tile, causal=causal)
        bound, by = _k8_bound(work)
        form = dict(form=what, tile=tile, dtype=str(dt).split(".")[-1],
                    shape=[B, Sq, Skv, H, Hkv, dh], q_offset=qo,
                    kv_valid=kvv, causal=causal, ms=k_ms, plain_ms=p_ms,
                    sdpa_ms=s_ms, bound_ms=bound, bound_by=by,
                    max_abs_err=chk["max_abs_err"],
                    ulps_plain=chk["plain"], ulps_f64=chk["f64"],
                    fault_ulps=float(d.max()))
        rows[row].setdefault("forms", []).append(form)
        print(f"  K8 {what} ({tile}; q {tuple(q.shape)}, k/v "
              f"{tuple(k.shape)}, q_offset {qo}, kv_valid {kvv}): within one "
              f"bf16 ulp of the magnitude of plain ({chk['plain']:.6f}) and "
              f"f64 ({chk['f64']:.6f}); planted fault {float(d.max()):.3f} "
              f"ulps, caught; kernel {k_ms:.6f} ms, plain {p_ms:.6f} ms, "
              f"SDPA {s_ms:.6f} ms, bound {bound:.6f} ms ({by})")
        del q, k, v, kp, got, bad, mag, d


def _d_device_split(h, q, k, v, rows) -> None:
    """Phase 8: the split-KV tile with tensor positions, on path D's layer-0
    decode inputs with ``kv_valid`` cut to 1,000 of the cache's 2,080 keys,
    so that the fixed plan (every key of the cache, ``decode_plan``) has
    runs past the valid keys, which must write the empty partial: against
    its plain version at that plan and the f64 oracle within one bf16 ulp;
    a planted run past ``kend`` that writes a non-empty partial (keys past
    ``kv_valid`` combined through the combine kernel, ``flash_merge``) must
    fail the check, the empty partial pass it; the fixed plan timed beside
    the int positions' plan over ``kend``."""
    import functools
    import torch
    from repro_torch.kernels import flash as tflash
    qo, kvv = 999, 1000
    dev = q.device
    pos = dict(q_offset=torch.full((), qo, dtype=torch.int32, device=dev),
               kv_valid=torch.full((), kvv, dtype=torch.int32, device=dev))
    n_fixed, per = tflash.decode_plan(q, k, **pos)
    n_kend, per_k = tflash.decode_plan(q, k, q_offset=qo, kv_valid=kvv)
    got = h.uncounted(functools.partial(tflash.flash_attention, q, k, v,
                                        **pos))
    plain = tflash.flash_decode_split_plain(q, k, v, n_split=n_fixed, **pos)
    mag = tflash.flash_attention_plain(q.float(), k.float(), v.float().abs(),
                                       q_offset=qo, kv_valid=kvv)
    exact = _dense_f64(q, k, v, qo, kvv)
    tol = _bf16_ulp(mag)
    ulps = {}
    for what, want in (("its plain version at the fixed plan", plain),
                       ("the f64 oracle", exact)):
        d = (got.double() - want.double()).abs() / tol
        if not bool((d <= 1).all()):
            raise AssertionError(f"K8 split-KV tile, tensor positions, vs "
                                 f"{what}: max {float(d.max())} ulps")
        ulps[what] = float(d.max())
    # the valid keys' partial, then a run past kend: empty, or planted
    m, l, acc = h.uncounted(functools.partial(
        tflash.flash_attention, q, k[:, :kvv], v[:, :kvv], q_offset=qo,
        return_partial=True))
    pm, pl, pa = h.uncounted(functools.partial(
        tflash.flash_attention, q, k[:, kvv:kvv + 192], v[:, kvv:kvv + 192],
        q_offset=0, return_partial=True, causal=False))
    merged = {}
    for name, run in (("empty", (torch.full_like(m, -1e30),
                                 torch.zeros_like(l), torch.zeros_like(acc))),
                      ("planted", (pm, pl, pa))):
        out = h.uncounted(functools.partial(
            tflash.flash_merge, torch.stack((m, run[0]), 2),
            torch.stack((l, run[1]), 2), torch.stack((acc, run[2]), 2)))
        merged[name] = float(((out.double() - exact).abs() / tol).max())
    if merged["empty"] > 1 or merged["planted"] <= 1:
        raise AssertionError(f"K8 split-KV tile: a run past kend, combined, "
                             f"in ulps of the magnitude {merged}: the empty "
                             f"partial must pass, a planted one fail")
    t_fixed = _event_ms(lambda: h.uncounted(functools.partial(
        tflash.flash_attention, q, k, v, **pos)), 100)
    t_kend = _event_ms(lambda: h.uncounted(functools.partial(
        tflash.flash_attention, q, k, v, q_offset=qo, kv_valid=kvv)), 100)
    rows["flash_decode"]["device_positions"] = dict(
        kv_valid=kvv, Skv=k.shape[1], n_split=n_fixed, tiles_per_split=per,
        kend_n_split=n_kend, kend_tiles_per_split=per_k, ms=t_fixed,
        kend_ms=t_kend, ulps_plain=ulps[
            "its plain version at the fixed plan"],
        ulps_f64=ulps["the f64 oracle"], empty_run_ulps=merged["empty"],
        planted_run_ulps=merged["planted"])
    print(f"  K8 split-KV tile with tensor positions (q_offset {qo}, "
          f"kv_valid {kvv} of {k.shape[1]} keys): the fixed plan {n_fixed} "
          f"runs of {per} tiles (over kend: {n_kend} of {per_k}); within "
          f"one bf16 ulp of its plain version at that plan "
          f"({ulps['its plain version at the fixed plan']:.6f}) and f64 "
          f"({ulps['the f64 oracle']:.6f}); a run past kend combined: empty "
          f"{merged['empty']:.6f} ulps, planted non-empty "
          f"{merged['planted']:.3f} ulps (caught); {t_fixed:.6f} ms at the "
          f"fixed plan, {t_kend:.6f} ms at kend's")


def _d_device_steps(cfg, kept, toks) -> None:
    """Phase 8: path D's decode step with ``cache_len`` a device scalar, from
    the served run's weights and prompts: the int form's steps, then the
    tensor form's under ``torch.cuda.set_sync_debug_mode("error")`` (no host
    sync), equal greedy ids (or, where they part, logits within
    ``LM_LOGIT_TOL`` at the first step that differs); then one tensor-form
    step warmed on a side stream, a step captured there in a
    ``torch.cuda.CUDAGraph`` and replayed for the remaining steps with
    ``cache_len`` and the ids advanced on the card: ids and every cache
    equal the uncaptured tensor form's bit for bit.  Prints the replay's
    ms a step beside the uncaptured step's (a finding, no claim)."""
    import numpy as np
    import torch
    from repro_torch.models import model as tM
    from repro_torch.serve import step as tstep
    P, T, B = LM_PROMPT_LEN, LM_NEW_TOKENS, LM_REQUESTS
    dev = kept["prompts"].device
    params = kept["params"]
    caches0 = tM.init_cache(cfg, B, P + T, device=dev)
    lg0, caches0 = tstep.make_prefill(cfg)(params, caches0, kept["prompts"],
                                           kept["pos"])
    tok0 = torch.argmax(lg0[:, :cfg.vocab_size], -1).to(torch.int32)
    if not (tok0.cpu().numpy() == toks[:, 0]).all():
        raise AssertionError("path D's prefill again: other first tokens")
    dec = tstep.make_decode_step(cfg)
    real_logits = tM.lm_logits
    seen = []

    def logits_kept(*a, **kw):
        out = real_logits(*a, **kw)
        seen.append(out[:, 0].clone())
        return out

    def copy(c):
        return {p: {n: t.clone() for n, t in v.items()} for p, v in c.items()}

    def steps(form):
        caches, tok, ids = copy(caches0), tok0, []
        dpos = torch.empty((B, 1), dtype=torch.int32, device=dev)
        seen.clear()
        tM.lm_logits = logits_kept
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(T):
            dpos.fill_(P + i)
            if form == "int":
                tok, caches = dec(params, caches, tok[:, None], dpos, P + i)
            else:
                cl = torch.full((), P + i, dtype=torch.int32, device=dev)
                torch.cuda.set_sync_debug_mode("error")
                try:
                    tok, caches = dec(params, caches, tok[:, None], dpos, cl)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            ids.append(tok)
        end.record()
        torch.cuda.synchronize()
        tM.lm_logits = real_logits
        return torch.stack(ids, 1), list(seen), caches, \
            start.elapsed_time(end) / T

    ids_i, lg_i, _, ms_int = steps("int")
    ids_t, lg_t, caches_t, ms_t = steps("tensor")
    same = (ids_i == ids_t).all(0)
    first = int(np.argmin(np.append(same.cpu().numpy(), False)))
    if first < T:
        d = float((lg_i[first] - lg_t[first]).abs().max())
        if d > LM_LOGIT_TOL:
            raise AssertionError(f"path D decode, tensor cache_len: ids part "
                                 f"from the int form's at step {first}, "
                                 f"logits {d} apart (tolerance "
                                 f"{LM_LOGIT_TOL})")
        parted = f"part at step {first} (logits {d:.6e} apart there)"
    else:
        parted = f"equal over all {T} steps"
    del lg_i, lg_t
    # the captured step: static ids, cache_len and positions
    caches_g = copy(caches0)
    tok_in = tok0[:, None].clone()
    cl = torch.full((), P, dtype=torch.int32, device=dev)
    dpos = cl.expand(B, 1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):           # warm: step 0, uncaptured
        out, caches_g = dec(params, caches_g, tok_in, dpos, cl)
    torch.cuda.current_stream().wait_stream(side)
    ids_g = [out.clone()]
    tok_in.copy_(out[:, None])
    cl.fill_(P + 1)
    # tracelint: ok[retrace](one capture, replayed for the path's steps)
    graph = torch.cuda.CUDAGraph()
    # tracelint: ok[retrace](the capture of that one graph)
    with torch.cuda.graph(graph, stream=side):
        out, _ = dec(params, caches_g, tok_in, dpos, cl)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(1, T):
        graph.replay()
        ids_g.append(out.clone())
        tok_in.copy_(out[:, None])
        cl.add_(1)
    end.record()
    torch.cuda.synchronize()
    ms_g = start.elapsed_time(end) / (T - 1)
    ids_g = torch.stack(ids_g, 1)
    if not torch.equal(ids_g, ids_t):
        raise AssertionError("path D decode: the CUDA graph's ids differ "
                             "from the uncaptured tensor form's")
    for p, leaves in caches_t.items():
        for n, t in leaves.items():
            _check_equal(f"path D decode: the CUDA graph's cache {p}.{n}",
                         caches_g[p][n], t)
    del graph, caches_g, caches_t, caches0
    print(f"  path D decode with cache_len a device scalar: {T} steps under "
          f"set_sync_debug_mode('error') (no host sync); greedy ids against "
          f"the int form's: {parted}; a CUDA graph of the step replayed "
          f"{T - 1} times: ids and every cache equal the uncaptured steps' "
          f"bit for bit; {ms_g:.6f} ms a step replayed against "
          f"{ms_t:.6f} ms uncaptured (tensor form; int form "
          f"{ms_int:.6f} ms)")


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
    # one warm batch of finds and ranges of both tenants, dispatched and
    # resolved on this thread, under the sync census
    def census_batch():
        batch = []
        for t in range(T):
            q = h.pick(lives[t], 2048).to(f64)
            batch += [tfe.Request(t, "find", q.cpu().numpy(), arrival=0.0),
                      tfe.Request(t, "range", torch.stack(
                          [q[:256], q[:256] + 0.01]).cpu().numpy(),
                          arrival=0.0)]
        return batch
    warm_batch, batch = census_batch(), census_batch()
    h.uncounted(lambda: fe._resolve(fe._dispatch(warm_batch)))
    torch.cuda.synchronize()
    _census(h, "phase 11", {"front-end batch (_dispatch + _resolve)":
                            lambda: fe._resolve(fe._dispatch(batch))})
    if not all(req.done() and req.error is None for req in batch):
        raise AssertionError("the census batch was not answered")
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
    _census(h, "phase 12", {f"find (D = {P})": lambda: ix.find(find_q),
                            f"find_range (D = {P})":
                                lambda: ix.find_range(lo, hi)})
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


def _lse_f64(q, k, q_offset: int = 0, kv_valid=None, bias=None):
    """Each row's log-sum-exp of the scaled (with ``bias = (fq, fk)``,
    scaled and biased) causal scores, in f64, one batch row at a time: (B,
    H, Sq)."""
    import torch
    B, Sq, H, _ = q.shape
    keep = _keep(q, k, q_offset, kv_valid)
    out = torch.empty((B, H, Sq), dtype=torch.float64, device=q.device)
    for b in range(B):
        out[b] = torch.logsumexp(_f64_scores(
            q[b].double(), k[b].double(),
            None if bias is None else (bias[0][b], bias[1][b]), keep), -1)
    return out


def _grads_f64(q, k, v, do, bias=None):
    """(dq, dk, dv) of causal attention by f64 autograd of a dense softmax,
    one batch row at a time; with ``bias = (fq, fk)`` also dfq and dfk
    (the sums of dS over keys and over queries, as (B, S, H)) and the
    largest sums of |dS| over the same axes (their scales)."""
    import torch
    G = q.shape[2] // k.shape[2]
    keep = _keep(q, k)
    outs = [torch.empty(t.shape, dtype=torch.float64, device=q.device)
            for t in (q, k, v, *(bias or ()))]
    scales = [0.0, 0.0]
    for b in range(q.shape[0]):
        qd, kd, vd = (t[b].double().requires_grad_() for t in (q, k, v))
        s = _f64_scores(qd, kd, None if bias is None else
                        (bias[0][b], bias[1][b]), keep)
        o = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1),
                         vd.repeat_interleave(G, 1))
        gs = torch.autograd.grad(o, (qd, kd, vd, s), do[b].double())
        for dst, g in zip(outs, gs[:3], strict=False):
            dst[b] = g
        if bias is not None:
            ds = gs[3]                                # (H, Sq, Skv)
            outs[3][b], outs[4][b] = ds.sum(-1).T, ds.sum(-2).T
            scales = [max(scales[0], float(ds.abs().sum(-1).max())),
                      max(scales[1], float(ds.abs().sum(-2).max()))]
        del s, o, gs
    return outs if bias is None else (*outs, *scales)


def _leaf_ulps(got, want) -> float:
    """max |got - want| in bf16 ulps of the largest |want|."""
    import math
    m = max(float(want.abs().max()), 2.0 ** -126)
    return float((got.double() - want).abs().max()) / \
        2.0 ** (math.floor(math.log2(m)) - 7)


def _lse_grad_check(h, g, what, q, k, v, lse_atol, grad_ulps) -> float:
    """K8 with ``lse`` (uncounted) on one training layer's causal inputs:
    ``out`` bit-equal to the tile launched without ``lse`` and within one
    bf16 ulp of the magnitude of plain, ``lse`` within ``lse_atol`` of the
    plain version's and an f64 oracle's, and dq, dk, dv from
    ``FlashAttention`` (a cotangent drawn from ``g``) within ``grad_ulps``
    bf16 ulps of the leaf of f64 autograd of a dense softmax; raises
    beyond, prints the figures and returns max |out - plain|."""
    import torch
    from repro_torch.kernels import flash as tflash
    out, lse = h.uncounted(functools.partial(
        tflash.flash_attention_lse, q, k, v, q_offset=0))
    bare = h.uncounted(functools.partial(tflash.flash_attention, q, k, v,
                                         q_offset=0))
    ref, lse_p = tflash.flash_attention_plain(q, k, v, q_offset=0,
                                              return_lse=True)
    lse_x = _lse_f64(q, k)
    mag = tflash.flash_attention_plain(q.float(), k.float(),
                                       v.float().abs(), q_offset=0)
    d_out = (out.double() - ref.double()).abs()
    d_lp = float((lse - lse_p).abs().max())
    d_lx = float((lse.double() - lse_x).abs().max())
    if not torch.equal(out, bare):
        raise AssertionError(f"K8 {what}: out with lse differs from the "
                             f"tile without it")
    if not bool((d_out <= _bf16_ulp(mag)).all()):
        raise AssertionError(f"K8 {what}: out beyond one bf16 ulp of the "
                             f"magnitude from plain")
    if max(d_lp, d_lx) > lse_atol:
        raise AssertionError(f"K8 {what}: lse off by {d_lp} (plain) / "
                             f"{d_lx} (f64), tolerance {lse_atol}")
    do = torch.randn(q.shape, generator=g, device=q.device).to(q.dtype)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    with torch.enable_grad():
        o = h.uncounted(functools.partial(tflash.flash_attention, qg, kg,
                                          vg, q_offset=0))
        o.backward(do)
    exact = _grads_f64(q, k, v, do)
    gu = [_leaf_ulps(a.grad, x)
          for a, x in zip((qg, kg, vg), exact, strict=True)]
    if max(gu) > grad_ulps:
        raise AssertionError(f"K8 {what}: dq/dk/dv {gu} ulps of the leaf "
                             f"from f64 autograd, tolerance {grad_ulps}")
    print(f"  K8 {what} (q {tuple(q.shape)}, k/v {tuple(k.shape)}): out "
          f"with lse equal to the tile without it bit for bit, within one "
          f"bf16 ulp of the magnitude of plain (max |diff| "
          f"{float(d_out.max()):.6e}); lse max |kernel - plain| "
          f"{d_lp:.6e}, |kernel - f64| {d_lx:.6e} (tolerance {lse_atol}); "
          f"dq, dk, dv against f64 autograd {[round(x, 6) for x in gu]} "
          f"ulps of the leaf (tolerance {grad_ulps})")
    return float(d_out.max())


def _train_span(cat: str, name: str):
    """Path I's kinds by span: K8's backward (an autograd
    ``FlashAttentionBackward`` op) and the MoE routing and combine."""
    if cat == "cpu_op" and "FlashAttentionBackward" in name:
        return "attention backward"
    if cat in ("user_annotation", "cpu_op") and \
            name in ("moe.dispatch", "moe.combine"):
        return "MoE dispatch and combine"
    return None


def _trace_kinds(path, tag, span_of=_train_span,
                 by_name=(("K8", "K8 forward"), ("GEMM", "GEMMs"))) -> dict:
    """A traced window (``torch.profiler`` chrome trace): the window of the
    user annotation ``tag`` (wall: to its last device event's end), the
    device busy time (the union of the device events' intervals) and the
    device time by kind, a device event's kind set by the span its launch
    lies in (``span_of(cat, name)`` names a span's kind, or None), else by
    ``_kind`` of its name (renamed by ``by_name``, the rest "other"); the
    host time of each span kind (its spans' durations summed) and the 8
    kernels with the most device time."""
    import bisect
    events = json.loads(Path(path).read_text())["traceEvents"]
    launch, dev, win, spans = {}, [], [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, a, name = e.get("cat", ""), e.get("args") or {}, e.get("name", "")
        t0 = float(e["ts"])
        t1 = t0 + float(e.get("dur", 0))
        if cat in ("cuda_runtime", "cuda_driver") and "correlation" in a:
            launch[a["correlation"]] = t0
        elif cat == "user_annotation" and name == tag:
            win.append((t0, t1))
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev.append((t0, t1, name, a.get("correlation")))
        elif span_of(cat, name) is not None:
            spans.setdefault(span_of(cat, name), []).append((t0, t1))
    if not win:
        raise AssertionError(f"{Path(path).name}: no '{tag}' annotation")
    lo, hi = min(a for a, _ in win), max(b for _, b in win)
    sorted_spans = {k: sorted(v) for k, v in spans.items()}
    span_s = {k: sum(t1 - t0 for t0, t1 in v if lo <= t0 <= hi) / 1e6
              for k, v in sorted_spans.items()}
    names_of = dict(by_name)

    def inside(kind, t):
        sp = sorted_spans[kind]
        i = bisect.bisect_right(sp, (t, float("inf"))) - 1
        return any(sp[j][0] <= t <= sp[j][1] for j in range(max(i - 8, 0),
                                                            i + 1))
    mine = sorted((t0, t1, n, launch.get(c, t0)) for t0, t1, n, c in dev
                  if lo <= launch.get(c, t0) <= hi)
    if not mine:
        raise AssertionError(f"{Path(path).name}: no device event in '{tag}'")
    busy, end, kinds, names = 0.0, lo, {}, {}
    for t0, t1, n, tl in mine:
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
        kind = next((k for k in sorted_spans if inside(k, tl)), None)
        if kind is None:
            kind = names_of.get(_kind(n), "other")
        kinds[kind] = kinds.get(kind, 0.0) + (t1 - t0) / 1e6
        names[n[:72]] = names.get(n[:72], 0.0) + (t1 - t0) / 1e6
    top = sorted(names.items(), key=lambda kv: -kv[1])[:8]
    return dict(wall=(max(hi, end) - lo) / 1e6, busy=busy / 1e6, kinds=kinds,
                events=len(mine), top=top, span_s=span_s)


def _path_i(args, dev, rows, h) -> None:
    """Phase 14, path I: granite-moe-1b-a400m trained at full width and
    depth through ``launch.train.train``, counted; K8's ``lse`` output,
    its ``out`` and the attention gradients against the plain version and
    f64 oracles on layer 0's and layer 23's inputs of the first step; a
    traced warm step; one step with the plain attention from the same
    weights and batch; the checkpoint gate on a 4-layer cut of the same
    width.  Adds path I's K8 launches and times to the ``flash`` row."""
    import shutil
    import statistics
    import tempfile
    import numpy as np
    import torch
    from repro_torch.configs import get_arch, single_card
    from repro_torch.data.indexed_dataset import synthetic_token_stream
    from repro_torch.kernels import flash as tflash
    from repro_torch.launch import train as tlaunch
    from repro_torch.models import layers as tlayers
    from repro_torch.models import model as TM
    from repro_torch.train import optimizer as topt
    from repro_torch.train.checkpoint import Checkpointer
    from repro_torch.train.step import make_train_step

    cfg = single_card(get_arch(I_ARCH))
    L, tokens = cfg.n_layers, I_BATCH * I_SEQ
    pos = torch.arange(I_SEQ, dtype=torch.int32, device=dev)[None] \
        .expand(I_BATCH, I_SEQ)

    def batch(cfg_, i):
        """The stream's i-th batch on the card, as ``train`` draws it."""
        stream = synthetic_token_stream(args.seed, cfg_.vocab_size, I_BATCH,
                                        I_SEQ)
        for _ in range(i):
            next(stream)
        toks, labels = next(stream)
        return (torch.from_numpy(toks).to(dev),
                torch.from_numpy(labels).to(dev))

    real_flash = tlayers.flash_attention
    captured, calls = {}, [0]

    def recording(q, k, v, *, q_offset, kv_valid=None, **kw):
        """K8 as the model calls it, keeping copies of layer 0's and the
        last layer's inputs in the first step's forward."""
        if calls[0] in (0, L - 1):
            captured[calls[0]] = tuple(t.detach().clone() for t in (q, k, v))
        calls[0] += 1
        return real_flash(q, k, v, q_offset=q_offset, kv_valid=kv_valid, **kw)

    torch.cuda.reset_peak_memory_stats()
    h.reset_counters()
    tlayers.flash_attention = recording
    try:
        res, t_all = _sync_time(lambda: tlaunch.train(
            I_ARCH, steps=I_STEPS, batch=I_BATCH, seq=I_SEQ, lr=I_LR,
            reduced=False, ckpt_dir=None, log_every=1, seed=args.seed))
    finally:
        tlayers.flash_attention = real_flash
    launches, with_lse = h.counters(), dict(tflash.LSE_LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {"flash": 2 * L * I_STEPS, "flash_decode": 0, "flash_combine": 0,
            "flash_cc": 0, "flash_bias": 0}
    if {k: launches[k] for k in want} != want or \
            with_lse["flash"] != want["flash"]:
        raise AssertionError(f"path I launches {launches}, with lse "
                             f"{with_lse}; want {want}, every one with lse")
    losses = res.losses
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"path I losses {losses}: not finite or not "
                             f"falling")
    warm = statistics.median(res.step_s[1:])
    print(f"phase 14: path I ({I_ARCH}, single card: {L} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} query / {cfg.n_kv_heads} KV heads, "
          f"dh {cfg.head_dim}, {cfg.moe.n_experts} experts top-"
          f"{cfg.moe.top_k}, {cfg.param_count()} parameters, "
          f"{cfg.param_count(active_only=True)} active) ok; {I_STEPS} steps "
          f"of {I_BATCH} x {I_SEQ} tokens, lr {I_LR}, remat on")
    print(f"  losses {[round(x, 6) for x in losses]}; grad norms "
          f"{[round(x, 6) for x in res.grad_norms]}")
    print(f"  step seconds {[round(x, 6) for x in res.step_s]}; warm (median "
          f"of steps 2-{I_STEPS}) {warm:.6f} s, {tokens / warm:.1f} tokens/s; "
          f"train() {t_all:.3f} s with weight init; peak memory allocated "
          f"{peak:.3f} GiB; K8 launches a step "
          f"{launches['flash'] / I_STEPS:.1f} (tensor-core tile, all with "
          f"lse: {with_lse})")

    # K8's lse, out and gradients on the first step's layer 0 and 23
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed + 14)
    err = max(_lse_grad_check(h, g, f"layer {layer}", q, k, v, I_LSE_ATOL,
                              I_GRAD_ULPS)
              for layer, (q, k, v) in sorted(captured.items()))
    q, k, v = captured[0]
    work = tflash.tile_work(q, k, 0, I_SEQ, "flash", lse=True)
    i_bound, i_by = _k8_bound(work)
    k_ms = _event_ms(lambda: h.uncounted(lambda: tflash.flash_attention_lse(
        q, k, v, q_offset=0)), 20)
    bare_ms = _event_ms(lambda: h.uncounted(lambda: tflash.flash_attention(
        q, k, v, q_offset=0)), 20)
    p_ms = _event_ms(lambda: tflash.flash_attention_plain(
        q, k, v, q_offset=0, return_lse=True), 3, warmup=1)
    s_ms = _event_ms(_sdpa_call(q, k, v, 0, I_SEQ), 20)
    do = torch.randn(q.shape, generator=g, device=dev).to(q.dtype)
    _, lse = h.uncounted(lambda: tflash.flash_attention_lse(q, k, v,
                                                            q_offset=0))
    b_ms = _event_ms(lambda: tflash.flash_attention_bwd(
        q, k, v, do, lse, q_offset=0), 5, warmup=1)
    row = rows["flash"]
    row["launches"] += launches["flash"]
    row["max_abs_err"] = max(row["max_abs_err"], err)
    row.update(path_i_launches=launches["flash"], path_i_lse_ms=k_ms,
               path_i_no_lse_ms=bare_ms, path_i_plain_ms=p_ms,
               path_i_sdpa_ms=s_ms, path_i_bound_ms=i_bound,
               path_i_backward_ms=b_ms)
    print(f"  K8 at path I's shape: with lse {k_ms:.6f} ms, without "
          f"{bare_ms:.6f} ms, plain (with lse) {p_ms:.6f} ms, SDPA "
          f"{s_ms:.6f} ms, bound {i_bound:.6f} ms ({i_by} on the bf16 "
          f"tensor cores: {work[0]} bytes, {work[1]} operations); the "
          f"backward's torch ops {b_ms:.6f} ms a layer")
    del captured, q, k, v, do, lse

    # one warm step traced: where the time goes
    step_fn = make_train_step(cfg, lr=I_LR)
    inputs, labels = batch(cfg, I_STEPS)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("path I step"):
            step_fn(res.params, res.opt, inputs, labels, pos)
        torch.cuda.synchronize()
    trace = ROOT / "build" / "path_i_trace.json"
    trace.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(trace))
    del prof
    w = _trace_kinds(trace, "path I step")
    kinds = ", ".join(f"{k_} {v_:.6f} s ({v_ / w['busy']:.3%} of busy)"
                      for k_, v_ in sorted(w["kinds"].items(),
                                           key=lambda kv: -kv[1]))
    print(f"  traced warm step ({trace.relative_to(ROOT)}): wall "
          f"{w['wall']:.6f} s, device busy {w['busy']:.6f} s, idle share "
          f"{1 - w['busy'] / w['wall']:.6f}; {w['events']} device events; "
          f"by kind {kinds}")
    for name, sec in w["top"]:
        print(f"    {sec:.6f} s  {name}")
    del res, step_fn
    gc.collect()
    torch.cuda.empty_cache()

    # the same weights and first batch through the plain attention
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = TM.init_params(cfg, gen, dev)
    inputs, labels = batch(cfg, 0)

    def loss_gnorm():
        ps = TM.tree_map(lambda t: t.detach().requires_grad_(), params)
        x, _ = TM.forward(ps, cfg, inputs, pos=pos, mode="train")
        loss = TM.lm_loss(ps, cfg, x, labels, False)
        grads = list(torch.autograd.grad(loss, topt.leaves(ps)))
        return float(loss.detach()), float(topt.global_grad_norm(grads))

    real_lse = tflash.flash_attention_lse
    lk, gk = h.uncounted(loss_gnorm)
    tflash.flash_attention_lse = functools.partial(
        tflash.flash_attention_plain, return_lse=True)
    try:
        (lp, gp), t_p = _sync_time(loss_gnorm)
    finally:
        tflash.flash_attention_lse = real_lse
    if abs(lp - lk) > I_PLAIN_LOSS_RTOL * abs(lk) or \
            abs(gp / gk - 1) > I_PLAIN_GNORM_RTOL:
        raise AssertionError(f"path I plain attention: loss {lp} / {lk}, "
                             f"grad norm {gp} / {gk}")
    print(f"  the first step with the plain attention forward: loss {lp:.6f}"
          f" against the kernel's {lk:.6f} (train()'s first step "
          f"{losses[0]:.6f}; |diff| {abs(lp - lk):.6e}, tolerance "
          f"{I_PLAIN_LOSS_RTOL} relative), grad norm {gp:.6f} against "
          f"{gk:.6f} (tolerance {I_PLAIN_GNORM_RTOL} relative); plain "
          f"forward and backward {t_p:.3f} s")
    del params, inputs, labels
    gc.collect()
    torch.cuda.empty_cache()

    # the checkpoint gate on a cut of the same width
    cut = tlaunch.train_config(I_ARCH, reduced=False, n_layers=I_CUT_LAYERS)
    kept = {}

    def keep(step, params, opt, metrics):
        if step == I_CKPT_EVERY:
            kept["state"] = TM.tree_map(lambda t: t.clone(),
                                          {"params": params, "opt": opt})
        elif step == I_CKPT_EVERY + 1:
            kept["loss"] = metrics["loss"].clone()
            kept["params"] = TM.tree_map(lambda t: t.clone(), params)

    store_dir = ROOT / "build"
    store_dir.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="path_i_ckpt_", dir=store_dir)
    print(f"  checkpoint gate ({cut.n_layers} layers of the same width, "
          f"{cut.param_count()} parameters): store "
          f"{Path(tmp).relative_to(ROOT)}, "
          f"{shutil.disk_usage(tmp).free / 2**30:.3f} GiB free")
    try:
        res_c, t_c = _sync_time(lambda: tlaunch.train(
            I_ARCH, steps=I_STEPS, batch=I_BATCH, seq=I_SEQ, lr=I_LR,
            reduced=False, n_layers=I_CUT_LAYERS, ckpt_dir=tmp,
            ckpt_every=I_CKPT_EVERY, log_every=I_STEPS, seed=args.seed,
            on_step=keep))
        ck = Checkpointer(tmp)
        on_disk = ck._store.steps()
        nbytes = _dir_bytes(os.path.join(tmp, f"step_{I_CKPT_EVERY:08d}"))
        back, t_r = _sync_time(lambda: ck.restore(I_CKPT_EVERY,
                                                  kept["state"]))
        for a, b in zip(topt.leaves(back), topt.leaves(kept["state"]),
                        strict=True):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError("path I: the restored step-4 state "
                                     "differs from the live one")
        last = ck.restore(I_STEPS, {"params": res_c.params,
                                    "opt": res_c.opt})
        for a, b in zip(topt.leaves(last), topt.leaves(
                {"params": res_c.params, "opt": res_c.opt}), strict=True):
            if not torch.equal(a, b):
                raise AssertionError("path I: the restored final state "
                                     "differs from the live one")
        inputs, labels = batch(cut, I_CKPT_EVERY + 1)
        p5, _, m5 = make_train_step(cut, lr=I_LR)(
            back["params"], back["opt"], inputs, labels, pos)
        l_live, l_back = float(kept["loss"]), float(m5["loss"])
        diffs = [(a.double() - b.double()).abs() / _bf16_ulp(b)
                 for a, b in zip(topt.leaves(p5),
                                 topt.leaves(kept["params"]), strict=True)]
        n_diff = sum(int((d > 0).sum()) for d in diffs)
        worst = max(float(d.max()) for d in diffs)
        exact = n_diff == 0 and l_live == l_back
        if not exact and (abs(l_back - l_live) > I_RESUME_LOSS_RTOL *
                          abs(l_live) or worst > 1):
            raise AssertionError(f"path I resume: loss {l_back} / {l_live}, "
                                 f"{n_diff} parameters differ, by up to "
                                 f"{worst} ulps")
        print(f"  cut: {I_STEPS} steps in {t_c:.3f} s with checkpoints at "
              f"{on_disk} ({nbytes} bytes a step, async at step "
              f"{I_CKPT_EVERY}, blocking at {I_STEPS}); losses "
              f"{[round(x, 6) for x in res_c.losses]}; restore of step "
              f"{I_CKPT_EVERY} {t_r:.3f} s, bit-equal to the live params and "
              f"optimizer state, step {I_STEPS} bit-equal to the final "
              f"state; the step from the restored state: loss {l_back:.9f} "
              f"against the uninterrupted {l_live:.9f}, "
              f"{'bit for bit' if exact else 'NOT bit for bit'} ("
              f"{n_diff} parameters differ, by up to {worst} bf16 ulps; "
              f"tolerance if not exact: loss {I_RESUME_LOSS_RTOL} relative, "
              f"parameters one ulp)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _j_bias_inputs(g, dev, B, Sq, Skv, H, Hkv, dh, shift):
    """bf16 q, k, v and the mLSTM's bias terms from ``g``: fq = F_t, fk =
    i_s - F_s, F the running sum over time of log_sigmoid(N(shift, 1))
    forget gates (about -1.2e3 at 2,048 steps), i ~ N(0, 1)."""
    import torch
    from repro_torch.models import layers as tlayers
    n = max(Sq, Skv)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev)
    q = rn(B, Sq, H, dh).to(torch.bfloat16)
    k = (rn(B, Skv, Hkv, dh) / dh ** 0.5).to(torch.bfloat16)
    v = rn(B, Skv, Hkv, dh).to(torch.bfloat16)
    f_cum = torch.cumsum(tlayers.log_sigmoid(rn(B, n, H) + shift), 1)
    ig = rn(B, n, H)
    return q, k, v, f_cum[:, :Sq].contiguous(), (ig - f_cum)[:, :Skv] \
        .contiguous()


def _k8_check(h, what, q, k, v, qo, kvv, bias=None, causal=True,
              got=None) -> dict:
    """K8 (uncounted; or ``got``, its output already made) against its
    plain version and a dense f64 oracle on these inputs, each within one
    bf16 ulp of the magnitude (the attention of |v| in f32); raises
    beyond.  Returns the largest |kernel - plain| and the comparisons in
    ulps of the magnitude."""
    import functools
    import torch
    from repro_torch.kernels import flash as tflash
    kw = {} if causal else {"causal": False}
    if got is None:
        got = h.uncounted(functools.partial(
            tflash.flash_attention, q, k, v, q_offset=qo, kv_valid=kvv,
            bias_qk=bias, **kw))
    ref = tflash.flash_attention_plain(q, k, v, q_offset=qo, kv_valid=kvv,
                                       bias_qk=bias, **kw)
    mag = tflash.flash_attention_plain(q.float(), k.float(), v.float().abs(),
                                       q_offset=qo, kv_valid=kvv,
                                       bias_qk=bias, **kw)
    exact = _dense_f64(q, k, v, qo, kvv, bias, causal)
    torch.cuda.synchronize()
    tol = _bf16_ulp(mag)
    out = {"max_abs_err": float((got.double() - ref.double()).abs().max())}
    for name, a, b in (("plain", got, ref), ("f64", got, exact),
                       ("plain vs f64", ref, exact)):
        d = (a.double() - b.double()).abs()
        if not bool((d <= tol).all()):
            raise AssertionError(f"K8 {what} vs {name}: {int((d > tol).sum())}"
                                 f" entries beyond one bf16 ulp of the "
                                 f"magnitude (max {float(d.max())})")
        out[name] = float((d / tol).max())
    return out


def _path_j(args, dev, rows, h) -> None:
    """Phase 15, path J: the recurrent families served through
    ``launch.serve.serve`` at full width, counted: xlstm-125m at full depth
    (6 mLSTM layers through K8's bias tile at head dim 384, 6 sLSTM
    layers), jamba-v0.1-52b cut to its first superblock (7 Mamba layers, 1
    attention layer on K8's prefill and split-KV decode tiles, MoE at
    positions 1, 3, 5 and 7), 4 requests of 2,048 prompt and 32 new tokens
    each.  K8 against its plain version and an f64 oracle on every K8
    input each arch gives it, and the bias tile on
    ``J_BIAS_EDGES`` with two planted faults; the bias tile timed against
    its plain version and SDPA with an f32 bias mask; a traced second
    prefill of each arch (device time by kind, the time loops' host spans,
    idle share); each arch served again with the plain attention and with
    the plain attention at 512-key blocks (the control), prefill and first
    decode logits, kernel vs plain, within the larger of ``J_LOGIT_FLOOR``
    and ``J_CONTROL_FACTOR`` times the control's (an arch with sLSTM
    layers: their scale within ``J_SCALE_RTOL``).  Adds the
    ``flash_bias`` row and path J's K8 launches to the ``flash`` and
    ``flash_decode`` rows."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch, single_card
    from repro_torch.kernels import flash as tflash
    from repro_torch.launch import serve as tserve
    from repro_torch.models import layers as tlayers
    from repro_torch.models import model as TM

    P, T, B = LM_PROMPT_LEN, LM_NEW_TOKENS, LM_REQUESTS
    rows.setdefault("flash_bias", {"launches": 0, "max_abs_err": 0.0})
    real = dict(flash=tlayers.flash_attention, card=tserve.single_card,
                init=TM.init_params, logits=TM.lm_logits)

    def config(arch):
        c = single_card(get_arch(arch))
        if arch.startswith("jamba"):
            c = dataclasses.replace(c, n_layers=J_JAMBA_LAYERS,
                                    pattern=c.pattern[:J_JAMBA_LAYERS])
        return c

    def served(arch, attn, keep):
        """serve() with K8 as ``attn`` and the arch cut by ``config``; the
        weights and the first two logits (prefill, first decode step) kept
        in ``keep``."""
        def init(*a, **kw):
            keep["params"] = real["init"](*a, **kw)
            return keep["params"]

        def logits(*a, **kw):
            out = real["logits"](*a, **kw)
            if len(keep.setdefault("logits", [])) < 2:
                keep["logits"].append(out[:, -1].clone())
            return out
        tlayers.flash_attention = attn
        tserve.single_card = lambda c: config(arch)
        TM.init_params, TM.lm_logits = init, logits
        try:
            return tserve.serve(arch, reduced=False, requests=B,
                                prompt_len=P, new_tokens=T, seed=args.seed)
        finally:
            tlayers.flash_attention = real["flash"]
            tserve.single_card = real["card"]
            TM.init_params, TM.lm_logits = real["init"], real["logits"]

    def recording(store, wanted):
        """K8 as the model calls it, keeping copies of the inputs of the
        calls numbered in ``wanted``."""
        calls = [0]

        def rec(q, k, v, *, q_offset, kv_valid=None, bias_qk=None, **kw):
            if calls[0] in wanted:
                store[calls[0]] = (
                    q.clone(), k.clone(), v.clone(), int(q_offset),
                    k.shape[1] if kv_valid is None else int(kv_valid),
                    None if bias_qk is None else tuple(t.clone()
                                                       for t in bias_qk))
            calls[0] += 1
            return real["flash"](q, k, v, q_offset=q_offset,
                                 kv_valid=kv_valid, bias_qk=bias_qk, **kw)
        return rec

    def plain_at(block):
        def plain(q, k, v, *, q_offset, kv_valid=None, bias_qk=None, **kw):
            return tflash.flash_attention_plain(
                q, k, v, q_offset=q_offset, kv_valid=kv_valid,
                bias_qk=bias_qk, kv_block=block)
        return plain

    for arch in J_ARCHS:
        cfg = config(arch)
        n_mlstm = cfg.pattern.count("mlstm")
        n_attn = cfg.pattern.count("attn")
        store, keep = {}, {}
        # K8's calls, every one kept: xlstm's mLSTM layers in prefill (none
        # in decode); jamba's attention layer in prefill, then one a step
        wanted = range(n_mlstm + n_attn * (1 + T))
        torch.cuda.reset_peak_memory_stats()
        h.reset_counters()
        res, t_all = _sync_time(lambda: served(
            arch, recording(store, wanted), keep))
        launches = h.counters()
        peak = torch.cuda.max_memory_allocated() / 2**30
        want = {"flash": n_attn, "flash_decode": n_attn * T,
                "flash_combine": n_attn * T, "flash_cc": 0,
                "flash_bias": n_mlstm}
        if {k: launches[k] for k in want} != want or launches["lookup"] <= 0:
            raise AssertionError(f"path J {arch} launches {launches}, want "
                                 f"{want} and K1 at least once")
        toks = res.tokens
        lk, dk = keep["logits"]
        if toks.shape != (B, T + 1) or toks.min() < 0 or \
                toks.max() >= cfg.vocab_size or \
                lk.shape != (B, cfg.vocab_padded) or \
                not bool(torch.isfinite(lk).all() & torch.isfinite(dk).all()):
            raise AssertionError(f"path J {arch}: tokens {toks.shape} or "
                                 f"logits {tuple(lk.shape)} misshapen or not "
                                 f"finite")
        kinds = {k: cfg.pattern.count(k) for k in sorted(set(cfg.pattern))}
        sizes = []
        TM.tree_map(lambda t: sizes.append(t.numel()), keep["params"])
        n_params = sum(sizes)
        print(f"phase 15: path J ({arch}, single card: {cfg.n_layers} layers "
              f"{kinds}, d_model {cfg.d_model}, {n_params} parameters) ok; "
              f"{B} requests x {P} prompt + {T} new tokens; "
              f"K8 launches by tile "
              f"{ {k: launches[k] for k in want if launches[k]} }; K1 "
              f"{launches['lookup']}")
        print(f"  prefill {res.prefill_s:.6f} s; decode {res.decode_s:.6f} s "
              f"for {T} steps ({res.decode_tok_s:.3f} tokens/s); serve() "
              f"{t_all:.6f} s with weight init; peak memory allocated "
              f"{peak:.3f} GiB; page table over {res.pages} pages")
        print(f"  greedy tokens (first 8 of each request): "
              f"{toks[:, :8].tolist()}")
        rows["lookup"]["launches"] += launches["lookup"]

        # K8 on every input the model gave it (the first and last printed)
        worst = {}
        for i, (q, k, v, qo, kvv, bias) in sorted(store.items()):
            name = "flash_bias" if bias is not None else \
                tflash.tile_of(q.dtype, q.shape[-1],
                               q.shape[1] * q.shape[2] // k.shape[2])
            r = _k8_check(h, f"{arch} call {i} ({name})", q, k, v, qo, kvv,
                          bias)
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                            r["max_abs_err"])
            worst = {key: max(worst.get(key, 0.0), x) for key, x in r.items()}
            if i not in (0, len(store) - 1):
                continue
            extra = "" if bias is None else (
                f"; |fq| up to {float(bias[0].abs().max()):.3f}, |fk| up to "
                f"{float(bias[1].abs().max()):.3f}")
            print(f"  K8 {name} on call {i} (q {tuple(q.shape)}, k/v "
                  f"{tuple(k.shape)}, q_offset {qo}, kv_valid {kvv}{extra}): "
                  f"in ulps of the magnitude, kernel - plain "
                  f"{r['plain']:.6f}, kernel - f64 {r['f64']:.6f}, plain - "
                  f"f64 {r['plain vs f64']:.6f}; max |kernel - plain| "
                  f"{r['max_abs_err']:.6e}")
        print(f"  K8 on all {len(store)} calls: the largest in ulps of the "
              f"magnitude, kernel - plain {worst['plain']:.6f}, kernel - f64 "
              f"{worst['f64']:.6f}, plain - f64 {worst['plain vs f64']:.6f}")
        for name in ("flash", "flash_decode", "flash_bias"):
            rows[name]["launches"] += launches[name]

        if n_mlstm:
            _j_bias_edges(h, dev, rows, store[0], launches["flash_bias"])
        # a second prefill on the same weights, traced
        params = keep.pop("params")
        caches = TM.init_cache(cfg, B, P + T, device=dev)
        prompts = torch.from_numpy(np.random.default_rng(args.seed).integers(
            0, cfg.vocab_size, (B, P))).to(device=dev, dtype=torch.int32)
        pos = torch.arange(P, dtype=torch.int32, device=dev)[None].expand(B, P)
        prefill = tserve.serve_step.make_prefill(cfg)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function("path J prefill"):
                lt, _ = prefill(params, caches, prompts, pos)
            torch.cuda.synchronize()
        trace = ROOT / "build" / f"path_j_{arch}_trace.json"
        trace.parent.mkdir(exist_ok=True)
        prof.export_chrome_trace(str(trace))
        del prof, params, caches
        w = _trace_kinds(trace, "path J prefill", span_of=_j_span,
                         by_name=(("K8", "K8"), ("GEMM", "GEMMs")))
        trace.unlink()
        d_pre = float((lt - lk).abs().max())
        kinds_txt = ", ".join(f"{k} {v:.6f} s ({v / w['busy']:.3%} of busy)"
                              for k, v in sorted(w["kinds"].items(),
                                                 key=lambda kv: -kv[1]))
        loops = ", ".join(f"{k} {v:.6f} s ({v / w['wall']:.3%} of the wall)"
                          for k, v in w["span_s"].items())
        print(f"  traced second prefill: wall {w['wall']:.6f} s, device busy "
              f"{w['busy']:.6f} s, idle share "
              f"{1 - w['busy'] / w['wall']:.6f}; {w['events']} device "
              f"events; by kind {kinds_txt}; host time in the time loops: "
              f"{loops or 'none'}; logits max |diff| to the first prefill "
              f"{d_pre:.6e}")
        print(f"    top kernels: " + "; ".join(f"{n} {t:.6f} s"
                                               for n, t in w["top"]))
        del keep

        # the same serving run with K8's plain version, and the control
        ends = {}
        for tag, block in (("plain", 1024), ("control", J_CONTROL_BLOCK)):
            kept = {}
            ends[tag] = (served(arch, plain_at(block), kept), *kept["logits"])
            del kept
        res_p, lp, dp = ends["plain"]
        res_c, lc, dc = ends["control"]
        first = (toks[:, 0], res_p.tokens[:, 0], res_c.tokens[:, 0])
        # the first decode step's input is each run's first token
        same = torch.from_numpy((first[0] == first[1]) &
                                (first[1] == first[2])).to(dev)
        d_pre, c_pre = float((lk - lp).abs().max()), \
            float((lc - lp).abs().max())
        d_dec, c_dec = (float(t[same].abs().max()) if bool(same.any())
                        else 0.0 for t in (dk - dp, dc - dp))
        tol = max(J_LOGIT_FLOOR, J_CONTROL_FACTOR * max(c_pre, c_dec))
        # the logits' scale, kernel against plain: (std ratio - 1, |mean
        # difference| / plain's std) of the prefill and first decode logits
        scale = [(float(a.std() / b.std()) - 1,
                  float((a.mean() - b.mean()).abs() / b.std()))
                 for a, b in ((lk, lp), (dk, dp))]
        decorrelated = "slstm" in cfg.pattern
        v_ = cfg.vocab_size
        top2 = torch.topk(lp[:, :v_], 2).values
        margin = (top2[:, 0] - top2[:, 1]).cpu().numpy()
        sure = margin > 2 * tol
        agree = res_p.tokens == toks
        lead = [int(np.argmin(np.append(a, False))) for a in agree]
        print(f"  end to end with the plain attention: prefill logits max "
              f"|kernel - plain| {d_pre:.6e} (control |plain at "
              f"{J_CONTROL_BLOCK}-key blocks - plain| {c_pre:.6e}), first "
              f"decode step's {d_dec:.6e} (control {c_dec:.6e}) over the "
              f"{int(same.sum())} requests whose first token agrees in all "
              f"three; tolerance {tol:.6f} (logits max "
              f"{float(lp.abs().max()):.6f}); top-2 margins "
              f"{np.round(margin, 6).tolist()}; greedy tokens equal "
              f"{int(agree.sum())} of {agree.size}, leading run per request "
              f"{lead}; control's tokens equal plain's "
              f"{int((res_c.tokens == res_p.tokens).sum())}; plain prefill "
              f"{res_p.prefill_s:.6f} s, decode {res_p.decode_tok_s:.3f} "
              f"tokens/s")
        print(f"    the logits' scale, kernel vs plain (std ratio - 1, "
              f"|mean difference| / std): prefill {scale[0][0]:.6f}, "
              f"{scale[0][1]:.6f}; first decode step {scale[1][0]:.6f}, "
              f"{scale[1][1]:.6f}; gate: "
              f"{'the scale (sLSTM layers)' if decorrelated else 'the'}"
              f"{'' if decorrelated else ' logits'}")
        if decorrelated:
            if any(abs(r) > J_SCALE_RTOL or m > J_SCALE_RTOL
                   for r, m in scale):
                raise AssertionError(f"path J {arch} kernel vs plain logits' "
                                     f"scale {scale} beyond {J_SCALE_RTOL}")
        elif d_pre > tol or d_dec > tol or \
                not (first[0][sure] == first[1][sure]).all():
            raise AssertionError(f"path J {arch} kernel vs plain logits: "
                                 f"prefill {d_pre}, decode {d_dec} "
                                 f"(tolerance {tol}), first tokens "
                                 f"{first[0]} / {first[1]}")
        del ends, lc, dc
        del lk, dk, lp, dp, store
        gc.collect()
        torch.cuda.empty_cache()


def _j_span(cat: str, name: str):
    """Path J's kinds by span: the sLSTM's and the Mamba scan's time loops,
    the MoE routing and combine."""
    if cat not in ("user_annotation", "cpu_op"):
        return None
    return {"slstm.scan": "sLSTM time loop", "mamba.scan": "Mamba time loop",
            "moe.dispatch": "MoE dispatch and combine",
            "moe.combine": "MoE dispatch and combine"}.get(name)


def _j_bias_edges(h, dev, rows, first, launches) -> None:
    """K8's bias tile on ``J_BIAS_EDGES`` and two planted faults, then its
    row of the kernels line, timed on the first mLSTM layer's inputs
    (``first``: q, k, v, q_offset, kv_valid, (fq, fk))."""
    import torch
    from repro_torch.kernels import flash as tflash
    g = torch.Generator(device=dev)
    g.manual_seed(25)
    for what, B, Sq, Skv, H, Hkv, dh, qo, kvv, shift in J_BIAS_EDGES:
        q, k, v, fq, fk = _j_bias_inputs(g, dev, B, Sq, Skv, H, Hkv, dh,
                                         shift)
        if kvv is None:
            kvv = Skv
        fk[:, kvv:] = 0.0
        r = _k8_check(h, f"bias tile ({what})", q, k, v, qo, kvv, (fq, fk))
        rows["flash_bias"]["max_abs_err"] = max(
            rows["flash_bias"]["max_abs_err"], r["max_abs_err"])
        print(f"  K8 bias tile, {what} (q {tuple(q.shape)}, k/v "
              f"{tuple(k.shape)}, q_offset {qo}, kv_valid {kvv}, |fq| up to "
              f"{float(fq.abs().max()):.3f}): in ulps of the magnitude, "
              f"kernel - plain {r['plain']:.6f}, kernel - f64 {r['f64']:.6f},"
              f" plain - f64 {r['plain vs f64']:.6f}")
    q, k, v, qo, kvv, (fq, fk) = first
    exact = _dense_f64(q, k, v, qo, kvv, (fq, fk))
    mag = tflash.flash_attention_plain(q.float(), k.float(), v.float().abs(),
                                       q_offset=qo, kv_valid=kvv,
                                       bias_qk=(fq, fk))
    tol = _bf16_ulp(mag)
    for what, qo_f, fk_f in (("fk one key late", qo, torch.roll(fk, 1, 1)),
                             ("the causal mask one key late", qo + 1, fk)):
        bad = h.uncounted(lambda: tflash.flash_attention(
            q, k, v, q_offset=qo_f, kv_valid=kvv, bias_qk=(fq, fk_f)))
        d = (bad.double() - exact).abs()
        if not bool((d > tol).any()):
            raise AssertionError(f"K8 bias tile: the planted fault ({what}) "
                                 f"passes the check")
        print(f"    planted fault ({what}): {int((d > tol).sum())} entries "
              f"beyond one bf16 ulp of the magnitude, max "
              f"{float((d / tol).max()):.6f} ulps")
    del exact, mag, tol

    # timed at the first mLSTM layer's shape; the library yardstick is SDPA
    # in f32 with the (B, H, Sq, Skv) f32 bias mask (-inf where masked)
    sdpa, mask_bytes = _bias_sdpa(q, k, v, qo, kvv, (fq, fk))
    work = tflash.tile_work(q, k, qo, kvv, "flash_bias", bias=True)
    nbytes, ops = work.bytes, work.ops
    err = rows["flash_bias"]["max_abs_err"]
    row = _time_row(
        "flash_bias", lambda: tflash.flash_attention(
            q, k, v, q_offset=qo, kv_valid=kvv, bias_qk=(fq, fk)),
        lambda: tflash.flash_attention_plain(
            q, k, v, q_offset=qo, kv_valid=kvv, bias_qk=(fq, fk)),
        sdpa, [(nbytes, ops)], launches, err, reps=10, plain_reps=3)
    # bf16 inputs: the least time is the operations on the bf16 tensor
    # cores; the f32 rate the tile computes at kept beside it
    row["bound_f32_ms"] = row["bound_ms"]
    row["bound_ms"], row["bound_by"] = _k8_bound(work)
    row["sdpa_mask_bytes"] = mask_bytes
    rows["flash_bias"] = row
    print(f"    {nbytes} bytes, {ops} operations; bound_ms "
          f"{row['bound_ms']:.6f} ({row['bound_by']}), bound_f32_ms "
          f"{row['bound_f32_ms']:.6f}; SDPA's f32 mask "
          f"{row['sdpa_mask_bytes']} bytes")
    del sdpa


def _bias_sdpa(q, k, v, qo, kvv, bias):
    """The bias tile's library yardstick on these inputs: a call of SDPA in
    f32 with the (B, H, Sq, Skv) f32 bias mask (fq + fk, -inf where
    masked), and the mask's bytes."""
    import torch
    fq, fk = bias
    dev, Sq, Skv = q.device, q.shape[1], k.shape[1]
    keep = (torch.arange(Skv, device=dev)[None, :]
            <= qo + torch.arange(Sq, device=dev)[:, None]) & \
        (torch.arange(Skv, device=dev) < kvv)[None, :]
    mask = (fq.transpose(1, 2)[..., None] + fk.transpose(1, 2)[:, :, None, :]
            ).masked_fill(~keep, float("-inf"))
    qs, ks, vs = (t.transpose(1, 2).float().contiguous() for t in (q, k, v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask)
    return sdpa, mask.numel() * mask.element_size()


def _k_span(cat: str, name: str):
    """Path K's kinds by span: the sLSTM's time loop forward (with the
    checkpoint's recompute) and backward (``_SLSTMLoop``'s spans), the bias
    tile's torch-op backward (an autograd ``FlashAttentionBackward`` op)."""
    if cat in ("user_annotation", "cpu_op") and name.startswith("slstm.scan"):
        return "sLSTM loop " + ("backward" if name.endswith("backward")
                                else "forward")
    if cat == "cpu_op" and "FlashAttentionBackward" in name:
        return "bias tile's backward (torch ops)"
    return None


def _path_k(args, dev, rows, h) -> None:
    """Phase 16, path K: xlstm-125m trained at full width and depth through
    ``launch.train.train``, counted (every mLSTM layer's K8 call on the
    bias tile with its ``lse`` output, in the forward and again in the
    remat's recompute); the bias tile's ``lse``, ``out`` and gradients (dq,
    dk, dv, dfq, dfk) against plain and f64 oracles on the first step's
    first and last mLSTM layer; ``J_BIAS_EDGES`` with ``lse`` and a planted
    ``lse`` fault; the tile timed with and without ``lse`` beside plain and
    the torch-op backward; a traced warm step; then one Mamba layer at
    jamba's full width in its train form against the same block without
    the chunk checkpoint (bit for bit) and in f64.  Adds path K's launches
    and times to the ``flash_bias`` row."""
    import statistics
    import numpy as np
    import torch
    from repro_torch.data.indexed_dataset import synthetic_token_stream
    from repro_torch.kernels import flash as tflash
    from repro_torch.launch import train as tlaunch
    from repro_torch.models import layers as tlayers
    from repro_torch.models import model as TM
    from repro_torch.train import optimizer as topt
    from repro_torch.train.step import make_train_step

    t_path = time.perf_counter()
    cfg = tlaunch.train_config(K_ARCH, reduced=False)
    n_m, n_s = cfg.pattern.count("mlstm"), cfg.pattern.count("slstm")
    tokens = K_BATCH * K_SEQ
    real_flash = tlayers.flash_attention
    captured, calls = {}, [0]

    def recording(q, k, v, *, q_offset, kv_valid=None, bias_qk=None, **kw):
        """K8 as the model calls it, keeping copies of the first and last
        mLSTM layer's inputs in the first step's forward."""
        if calls[0] in (0, n_m - 1):
            captured[calls[0]] = tuple(t.detach().clone() for t in (
                q, k, v, *bias_qk))
        calls[0] += 1
        return real_flash(q, k, v, q_offset=q_offset, kv_valid=kv_valid,
                          bias_qk=bias_qk, **kw)

    torch.cuda.reset_peak_memory_stats()
    h.reset_counters()
    tlayers.flash_attention = recording
    try:
        res, t_all = _sync_time(lambda: tlaunch.train(
            K_ARCH, steps=K_STEPS, batch=K_BATCH, seq=K_SEQ, lr=K_LR,
            reduced=False, ckpt_dir=None, log_every=1, seed=args.seed))
    finally:
        tlayers.flash_attention = real_flash
    launches, with_lse = h.counters(), dict(tflash.LSE_LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {"flash": 0, "flash_decode": 0, "flash_combine": 0,
            "flash_cc": 0, "flash_bias": 2 * n_m * K_STEPS}
    if {k: launches[k] for k in want} != want or \
            with_lse["flash_bias"] != want["flash_bias"]:
        raise AssertionError(f"path K launches {launches}, with lse "
                             f"{with_lse}; want {want}, every one with lse")
    losses = res.losses
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"path K losses {losses}: not finite or not "
                             f"falling")
    warm = statistics.median(res.step_s[1:])
    print(f"phase 16: path K ({K_ARCH}, single card: {cfg.n_layers} layers, "
          f"{n_m} mLSTM at head dim {cfg.expand * cfg.d_model // cfg.xl_heads}"
          f" and {n_s} sLSTM at {cfg.d_model // cfg.xl_heads}, d_model "
          f"{cfg.d_model}, {cfg.param_count()} parameters) ok; {K_STEPS} "
          f"steps of {K_BATCH} x {K_SEQ} tokens, lr {K_LR}, remat on")
    print(f"  losses {[round(x, 6) for x in losses]}; grad norms "
          f"{[round(x, 6) for x in res.grad_norms]}")
    print(f"  step seconds {[round(x, 6) for x in res.step_s]}; warm (median "
          f"of steps 2-{K_STEPS}) {warm:.6f} s, {tokens / warm:.1f} tokens/s; "
          f"train() {t_all:.3f} s with weight init; peak memory allocated "
          f"{peak:.3f} GiB; K8 bias-tile launches {launches['flash_bias']} "
          f"({launches['flash_bias'] / K_STEPS:.1f} a step), with lse "
          f"{with_lse['flash_bias']}; other K8 tiles 0")

    # the bias tile's lse, out and gradients on the first and last mLSTM
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed + 16)
    err = 0.0
    for layer, (q, k, v, fq, fk) in sorted(captured.items()):
        bias = (fq, fk)
        out, lse = h.uncounted(functools.partial(
            tflash.flash_attention_lse, q, k, v, q_offset=0, bias_qk=bias))
        bare = h.uncounted(functools.partial(
            tflash.flash_attention, q, k, v, q_offset=0, bias_qk=bias))
        ref, lse_p = tflash.flash_attention_plain(
            q, k, v, q_offset=0, return_lse=True, bias_qk=bias)
        lse_x = _lse_f64(q, k, bias=bias)
        mag = tflash.flash_attention_plain(q.float(), k.float(),
                                           v.float().abs(), q_offset=0,
                                           bias_qk=bias)
        d_out = (out.double() - ref.double()).abs()
        d_lp = float((lse - lse_p).abs().max())
        d_lx = float((lse.double() - lse_x).abs().max())
        if not torch.equal(out, bare):
            raise AssertionError(f"bias tile, mLSTM layer {layer}: out with "
                                 f"lse differs from the tile without it")
        if not bool((d_out <= _bf16_ulp(mag)).all()):
            raise AssertionError(f"bias tile, mLSTM layer {layer}: out "
                                 f"beyond one bf16 ulp of the magnitude")
        if max(d_lp, d_lx) > K_LSE_ATOL:
            raise AssertionError(f"bias tile, mLSTM layer {layer}: lse off "
                                 f"by {d_lp} (plain) / {d_lx} (f64), "
                                 f"tolerance {K_LSE_ATOL}")
        do = torch.randn(q.shape, generator=g, device=dev).to(q.dtype)
        leaves = [t.clone().requires_grad_() for t in (q, k, v, fq, fk)]
        with torch.enable_grad():
            o = h.uncounted(functools.partial(
                tflash.flash_attention, *leaves[:3], q_offset=0,
                bias_qk=tuple(leaves[3:])))
            o.backward(do)
        dq, dk, dv, dfq, dfk, sq, sk = _grads_f64(q, k, v, do, bias)
        gu = [_leaf_ulps(a.grad, x) for a, x in zip(leaves[:3], (dq, dk, dv),
                                                    strict=True)]
        gs = [float((a.grad.double() - x).abs().max()) / sc
              for a, x, sc in ((leaves[3], dfq, sq), (leaves[4], dfk, sk))]
        if max(gu) > K_GRAD_ULPS or max(gs) > K_BIAS_SUM_RTOL:
            raise AssertionError(f"bias tile, mLSTM layer {layer}: dq/dk/dv "
                                 f"{gu} ulps of the leaf (tolerance "
                                 f"{K_GRAD_ULPS}), dfq/dfk {gs} of the "
                                 f"largest sum of |dS| (tolerance "
                                 f"{K_BIAS_SUM_RTOL})")
        err = max(err, float(d_out.max()))
        print(f"  bias tile, mLSTM layer {layer} (q {tuple(q.shape)}, |fq| "
              f"up to {float(fq.abs().max()):.3f}): out with lse equal to "
              f"the tile without it bit for bit, within one bf16 ulp of the "
              f"magnitude of plain (max |diff| {float(d_out.max()):.6e}); "
              f"lse max |kernel - plain| {d_lp:.6e}, |kernel - f64| "
              f"{d_lx:.6e} (tolerance {K_LSE_ATOL}); dq, dk, dv against f64 "
              f"autograd {[round(x, 6) for x in gu]} ulps of the leaf "
              f"(tolerance {K_GRAD_ULPS}); dfq, dfk "
              f"{[f'{x:.3e}' for x in gs]} of the largest sum of |dS| "
              f"({sq:.6f}, {sk:.6f}; tolerance {K_BIAS_SUM_RTOL})")
        del leaves, o, dq, dk, dv, dfq, dfk, lse_x, mag, ref
    _k_lse_edges(h, dev)

    # timed at the first mLSTM layer's shape: with and without lse, plain
    # (with lse), and the torch-op backward
    q, k, v, fq, fk = captured[0]
    bias = (fq, fk)
    work = tflash.tile_work(q, k, 0, K_SEQ, "flash_bias", bias=True,
                            lse=True)
    nbytes, ops = work.bytes, work.ops
    bound = _k8_bound(work)[0]
    k_ms = _event_ms(lambda: h.uncounted(lambda: tflash.flash_attention_lse(
        q, k, v, q_offset=0, bias_qk=bias)), 20)
    bare_ms = _event_ms(lambda: h.uncounted(lambda: tflash.flash_attention(
        q, k, v, q_offset=0, bias_qk=bias)), 20)
    p_ms = _event_ms(lambda: tflash.flash_attention_plain(
        q, k, v, q_offset=0, return_lse=True, bias_qk=bias), 3, warmup=1)
    do = torch.randn(q.shape, generator=g, device=dev).to(q.dtype)
    _, lse = h.uncounted(lambda: tflash.flash_attention_lse(
        q, k, v, q_offset=0, bias_qk=bias))
    b_ms = _event_ms(lambda: tflash.flash_attention_bwd(
        q, k, v, do, lse, q_offset=0, bias_qk=bias), 5, warmup=1)
    # the library yardstick of the forward, as phase 15's (no library
    # backward gives the bias sums)
    sdpa, mask_bytes = _bias_sdpa(q, k, v, 0, K_SEQ, bias)
    l_ms = _event_ms(sdpa, 20)
    del sdpa
    row = rows["flash_bias"]
    row["launches"] += launches["flash_bias"]
    row["max_abs_err"] = max(row["max_abs_err"], err)
    row.update(path_k_launches=launches["flash_bias"], path_k_lse_ms=k_ms,
               path_k_no_lse_ms=bare_ms, path_k_plain_ms=p_ms,
               path_k_bound_ms=bound, path_k_backward_ms=b_ms,
               path_k_library_ms=l_ms, path_k_sdpa_mask_bytes=mask_bytes)
    print(f"  bias tile at path K's shape (q {tuple(q.shape)}): with lse "
          f"{k_ms:.6f} ms, without {bare_ms:.6f} ms, plain (with lse) "
          f"{p_ms:.6f} ms, SDPA in f32 with the {mask_bytes}-byte f32 bias "
          f"mask {l_ms:.6f} ms, bound {bound:.6f} ms ({nbytes} bytes, {ops} "
          f"operations on the bf16 tensor cores); the backward's torch ops "
          f"{b_ms:.6f} ms a layer")
    del captured, q, k, v, fq, fk, bias, do, lse

    del res
    gc.collect()
    torch.cuda.empty_cache()

    # one warm step of a cut of the same width traced: where the time goes
    cut = tlaunch.train_config(K_ARCH, reduced=False, n_layers=K_TRACE_LAYERS)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = TM.init_params(cut, gen, dev)
    opt = topt.init(params)
    step_fn = make_train_step(cut, lr=K_LR)
    toks, labels = next(synthetic_token_stream(args.seed, cut.vocab_size,
                                               K_BATCH, K_SEQ))
    inputs = torch.from_numpy(toks).to(dev)
    labels = torch.from_numpy(labels).to(dev)
    pos = torch.arange(K_SEQ, dtype=torch.int32, device=dev)[None] \
        .expand(K_BATCH, K_SEQ)
    params, opt, _ = step_fn(params, opt, inputs, labels, pos)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("path K step"):
            step_fn(params, opt, inputs, labels, pos)
        torch.cuda.synchronize()
    trace = ROOT / "build" / "path_k_trace.json"
    trace.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(trace))
    del prof
    t_read = time.perf_counter()
    w = _trace_kinds(trace, "path K step", span_of=_k_span,
                     by_name=(("K8", "bias tile (K8 forward)"),
                              ("GEMM", "GEMMs")))
    t_read = time.perf_counter() - t_read
    trace_mb = trace.stat().st_size / 2**20
    trace.unlink()
    kinds = ", ".join(f"{k_} {v_:.6f} s ({v_ / w['busy']:.3%} of busy)"
                      for k_, v_ in sorted(w["kinds"].items(),
                                           key=lambda kv: -kv[1]))
    loops = ", ".join(f"{k_} {v_:.6f} s ({v_ / w['wall']:.3%} of the wall)"
                      for k_, v_ in w["span_s"].items())
    print(f"  traced warm step of a {cut.n_layers}-layer cut of the same "
          f"width ({cut.pattern}): wall {w['wall']:.6f} s, device busy "
          f"{w['busy']:.6f} s, idle share {1 - w['busy'] / w['wall']:.6f}; "
          f"{w['events']} device events ({trace_mb:.1f} MiB of trace, read "
          f"in {t_read:.1f} s); by kind {kinds}; host spans: {loops}")
    print("    top kernels: " + "; ".join(f"{n} {t:.6f} s"
                                          for n, t in w["top"]))
    del params, opt, step_fn, inputs, labels
    gc.collect()
    torch.cuda.empty_cache()
    _k_mamba(args, dev)
    print(f"  path K wall {time.perf_counter() - t_path:.1f} s")


def _k_lse_edges(h, dev) -> None:
    """The bias tile's ``lse`` on ``J_BIAS_EDGES`` against plain and f64,
    ``out`` with it bit-equal to the tile without it; then a planted fault:
    one row's fq raised by ``K_LSE_FAULT`` lse tolerances leaves every
    output within one ulp (a row's constant cancels in its softmax) but
    must fail the ``lse`` check."""
    import torch
    from repro_torch.kernels import flash as tflash
    g = torch.Generator(device=dev)
    g.manual_seed(26)
    worst = [0.0, 0.0]
    for n_edge, (what, B, Sq, Skv, H, Hkv, dh, qo, kvv, shift) in \
            enumerate(J_BIAS_EDGES):
        q, k, v, fq, fk = _j_bias_inputs(g, dev, B, Sq, Skv, H, Hkv, dh,
                                         shift)
        if kvv is None:
            kvv = Skv
        fk[:, kvv:] = 0.0
        bias = (fq, fk)
        kw = dict(q_offset=qo, kv_valid=kvv, bias_qk=bias)
        out, lse = h.uncounted(functools.partial(
            tflash.flash_attention_lse, q, k, v, **kw))
        bare = h.uncounted(functools.partial(tflash.flash_attention, q, k,
                                             v, **kw))
        _, lse_p = tflash.flash_attention_plain(
            q, k, v, q_offset=qo, kv_valid=kvv, return_lse=True,
            bias_qk=bias)
        lse_x = _lse_f64(q, k, qo, kvv, bias)
        d = [float((lse - lse_p).abs().max()),
             float((lse.double() - lse_x).abs().max())]
        if not torch.equal(out, bare) or max(d) > K_LSE_ATOL:
            raise AssertionError(f"bias tile lse ({what}): out equal to the "
                                 f"tile without lse {torch.equal(out, bare)}"
                                 f", lse off by {d} (tolerance "
                                 f"{K_LSE_ATOL})")
        worst = [max(a, b) for a, b in zip(worst, d, strict=True)]
        if n_edge:
            continue
        # the planted fault on the first edge: row i's fq raised
        i = Sq // 3
        bad_fq = fq.clone()
        bad_fq[:, i] += K_LSE_FAULT * K_LSE_ATOL
        out_f, lse_f = h.uncounted(functools.partial(
            tflash.flash_attention_lse, q, k, v, q_offset=qo, kv_valid=kvv,
            bias_qk=(bad_fq, fk)))
        mag = tflash.flash_attention_plain(q.float(), k.float(),
                                           v.float().abs(), q_offset=qo,
                                           kv_valid=kvv, bias_qk=bias)
        ulps = float(((out_f.double() - out.double()).abs()
                      / _bf16_ulp(mag)).max())
        d_f = (lse_f.double() - lse_x).abs()
        if not bool((d_f > K_LSE_ATOL).any()):
            raise AssertionError("bias tile: the planted lse fault passes "
                                 "the lse check")
        print(f"  bias tile lse, planted fault (fq of query row {i} raised "
              f"by {K_LSE_FAULT * K_LSE_ATOL}): out within {ulps:.6f} ulps "
              f"of the magnitude of the unplanted tile's, lse off by up to "
              f"{float(d_f.max()):.6e} on {int((d_f > K_LSE_ATOL).sum())} "
              f"rows: caught")
        del bad_fq, out_f, lse_f, mag, d_f
    print(f"  bias tile lse on all {len(J_BIAS_EDGES)} J_BIAS_EDGES: out with "
          f"lse equal to the tile without it bit for bit; lse max |kernel - "
          f"plain| {worst[0]:.6e}, |kernel - f64| {worst[1]:.6e} (tolerance "
          f"{K_LSE_ATOL})")


def _mamba_f64(p, x, cfg):
    """The Mamba block in f64 from the same bf16 weights and input, each of
    the port's bf16 roundings in the forward kept (the rounded value, a
    straight-through gradient), everything else f64: an oracle for its
    gradients."""
    import torch
    import torch.nn.functional as F
    f64, bf16 = torch.float64, torch.bfloat16

    def rb(t):
        return t + (t.to(bf16).to(f64) - t).detach()

    def silu(t):
        return t * torch.sigmoid(t)
    p = type(p)(*(t.to(f64) for t in p))
    B, S, _ = x.shape
    xf = x.to(f64)
    hn = rb(xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True)
                             + cfg.norm_eps))
    hh = rb(hn * p.ln)
    xz = hh @ p.in_proj
    di = xz.shape[-1] // 2
    xs, z = xz[..., :di], xz[..., di:]
    K = cfg.d_conv
    xp = torch.cat([xs.new_zeros((B, K - 1, di)), xs], 1)
    xc = silu(sum(xp[:, i:i + S] * p.conv_w[i] for i in range(K)) + p.conv_b)
    feats = rb(xc) @ p.x_proj
    dtr, ds = cfg.dt_rank, cfg.d_state
    dt = F.softplus(rb(feats[..., :dtr]) @ p.dt_w + p.dt_b, threshold=1e4)
    b_in, c_in = feats[..., dtr:dtr + ds], feats[..., dtr + ds:]
    a = -torch.exp(p.a_log)
    hst = xs.new_zeros((B, di, ds))
    ys = []
    for t in range(S):
        hst = torch.exp(dt[:, t, :, None] * a) * hst + \
            (dt[:, t] * xc[:, t])[..., None] * b_in[:, t, None, :]
        ys.append((hst * c_in[:, t, None, :]).sum(-1) + p.d_skip * xc[:, t])
    y = torch.stack(ys, 1) * silu(z)
    return rb(y) @ p.out_proj


def _k_mamba(args, dev) -> None:
    """One Mamba layer at jamba's full width (``K_MAMBA_B`` x
    ``K_MAMBA_S``), its train form (each scan chunk checkpointed): the
    input's and every weight's gradient equal to the same block without the
    chunk checkpoint bit for bit, and within ``K_MAMBA_RTOL`` of each
    leaf's largest entry of the block in f64 (``_mamba_f64``)."""
    import torch
    from repro_torch.configs import get_arch, single_card
    from repro_torch.models import model as TM
    from repro_torch.models import ssm as tssm
    cfg = single_card(get_arch(K_MAMBA_ARCH))
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed + 17)

    def make(leaf):
        if leaf.fan_in in (0, -1):
            return torch.full(leaf.shape, float(leaf.fan_in == -1),
                              dtype=torch.bfloat16, device=dev)
        return (torch.randn(leaf.shape, generator=g, device=dev)
                / leaf.fan_in ** 0.5).to(torch.bfloat16)
    p = TM.tree_map(make, TM.build_tree(cfg)["sb"]["pos0"]["core"])
    shape = (K_MAMBA_B, K_MAMBA_S, cfg.d_model)
    x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    dy = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    def grads():
        leaves = [t.clone().requires_grad_() for t in (x, *p)]
        torch.cuda.reset_peak_memory_stats()
        with torch.enable_grad():
            out, _ = tssm.mamba_block(type(p)(*leaves[1:]), leaves[0], cfg,
                                      state=None, tp_shard=False)
            (_, sec) = _sync_time(lambda: out.backward(dy))
        return [t.grad for t in leaves], sec, \
            torch.cuda.max_memory_allocated() / 2**30
    got, sec, peak = grads()
    real = tssm.checkpoint
    tssm.checkpoint = lambda fn, *a, **kw: fn(*a)   # each chunk called directly
    try:
        plain, sec_p, peak_p = grads()
    finally:
        tssm.checkpoint = real
    same = [torch.equal(a, b) for a, b in zip(got, plain, strict=True)]
    names = ("x", *p._fields)
    if not all(same):
        raise AssertionError(f"Mamba train form: the chunk checkpoint changes "
                             f"the gradients of {[n for n, s in zip(names, same, strict=True) if not s]}")
    del plain
    leaves = [t.to(torch.float64).requires_grad_() for t in (x, *p)]
    with torch.enable_grad():
        out = _mamba_f64(type(p)(*leaves[1:]), leaves[0], cfg)
        (_, sec_x) = _sync_time(lambda: out.backward(dy.to(torch.float64)))
    rel = {n: float((a.double() - b.grad).abs().max() / b.grad.abs().max())
           for n, a, b in zip(names, got, leaves, strict=True)}
    if max(rel.values()) > K_MAMBA_RTOL:
        raise AssertionError(f"Mamba train form against f64: {rel} "
                             f"(tolerance {K_MAMBA_RTOL})")
    print(f"  Mamba layer at {K_MAMBA_ARCH}'s width (d_model {cfg.d_model}, "
          f"d_inner {cfg.d_inner}, d_state {cfg.d_state}, dt_rank "
          f"{cfg.dt_rank}; {K_MAMBA_B} x {K_MAMBA_S} tokens, chunks of "
          f"{tssm.CHUNK}): input and weight gradients with the chunk "
          f"checkpoint equal to those without it bit for bit; against f64 "
          f"(largest |diff| / largest entry) "
          f"{ {n: float(f'{r:.3e}') for n, r in rel.items()} } (tolerance "
          f"{K_MAMBA_RTOL}); backward {sec:.6f} s with the checkpoint (peak "
          f"{peak:.3f} GiB), {sec_p:.6f} s without ({peak_p:.3f} GiB), f64 "
          f"{sec_x:.3f} s")


def _image_ids(batch: int, seq: int, dev):
    """(3, batch, seq) int32 M-RoPE ids laid out like an image
    (``L_IMAGE``): a text prefix (t = h = w = i), a grid of patches at t =
    the prefix's length with h = it + the row and w = it + the column,
    then text resuming at the largest id + 1."""
    import torch
    n_text, gh, gw = L_IMAGE
    i = torch.arange(seq, device=dev)
    r, c = (i - n_text).div(gw, rounding_mode="floor"), (i - n_text) % gw
    grid = (i >= n_text) & (i < n_text + gh * gw)
    after = n_text + max(gh, gw) + (i - n_text - gh * gw)
    text = torch.where(i < n_text, i, after)
    ids = torch.stack([torch.where(grid, n_text, text),
                       torch.where(grid, n_text + r, text),
                       torch.where(grid, n_text + c, text)])
    return ids[:, None].expand(3, batch, seq).to(torch.int32).contiguous()


def _mrope_f64(x, pos3, theta: float, sections) -> tuple:
    """M-RoPE in f64, from the formula: frequency slot j of dh / 2 turns by
    the id of its section (``sections`` summing to dh / 2), at
    ``theta ** (-2 j / dh)``; and the magnitude each output is held to,
    ``|x1| + |x2|`` of its pair: the f32 angle's rounding (up to about
    3e-5 at ids near 560) moves an output by that much of it, also where
    the rotation nearly cancels."""
    import numpy as np
    import torch
    dh = x.shape[-1]
    sec = torch.from_numpy(np.repeat(np.arange(3), sections)).to(x.device)
    freqs = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float64,
                                          device=x.device) / dh))
    ang = pos3.double()[sec].permute(1, 2, 0) * freqs
    cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
    x1, x2 = x.double().chunk(2, dim=-1)
    pair = x1.abs() + x2.abs()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1), \
        torch.cat([pair, pair], -1)


def _l_time(h, q, k, v, qo: int, kvv: int, lse: bool) -> dict:
    """One K8 shape of path L timed by CUDA events: the kernel (with its
    ``lse`` output where ``lse``) in two turns around the plain version and
    SDPA (``enable_gqa``); the bound of ``kernels.cost``'s bytes and
    operations (on the bf16 tensor cores for the prefill tile, at the f32
    rate for the decode tile, as their rows of the kernels line); where
    ``lse``, also the backward's torch ops."""
    import torch
    from repro_torch.kernels import flash as tflash
    rows_ = q.shape[1] * q.shape[2] // k.shape[2]
    tile = tflash.tile_of(q.dtype, q.shape[-1], rows_)
    fn = tflash.flash_attention_lse if lse else tflash.flash_attention
    kern = lambda: h.uncounted(lambda: fn(q, k, v, q_offset=qo,
                                          kv_valid=kvv))
    decode = tile == "flash_decode"
    reps, plain_reps = (100, 20) if decode else (20, 3)
    k1 = _event_ms(kern, reps)
    p_ms = _event_ms(lambda: tflash.flash_attention_plain(
        q, k, v, q_offset=qo, kv_valid=kvv, return_lse=lse), plain_reps,
        warmup=1)
    s_ms = _event_ms(_sdpa_call(q, k, v, qo, kvv), reps)
    k2 = _event_ms(kern, reps)
    work = tflash.tile_work(q, k, qo, kvv, tile, lse=lse)
    nbytes, ops = work.bytes, work.ops
    bound_ms, bound_by = _k8_bound(work)
    out = dict(tile=tile, B=q.shape[0], Sq=q.shape[1], Skv=kvv,
               heads=f"{q.shape[2]}/{k.shape[2]}", dh=q.shape[-1], lse=lse,
               ms=(k1 + k2) / 2, plain_ms=p_ms, sdpa_ms=s_ms,
               bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
               operations=ops)
    if lse:
        _, l_ = h.uncounted(lambda: tflash.flash_attention_lse(
            q, k, v, q_offset=qo, kv_valid=kvv))
        do = torch.ones_like(q)
        out["backward_ms"] = _event_ms(lambda: tflash.flash_attention_bwd(
            q, k, v, do, l_, q_offset=qo, kv_valid=kvv), 3, warmup=1)
    return out


def _l_span(cat: str, name: str):
    """Path L's training kinds by span: K8's backward (an autograd
    ``FlashAttentionBackward`` op) and the token table's index backward
    (``IndexBackward0``: a scatter-add into the embedding's gradient)."""
    if cat != "cpu_op":
        return None
    if "FlashAttentionBackward" in name:
        return "attention backward"
    if "IndexBackward" in name:
        return "embedding backward (index)"
    return None


def _path_l(args, dev, rows, h) -> None:
    """Phase 17, path L: the embedding-input and M-RoPE families, counted.
    musicgen-large (frame embeddings, no rotation; 32 / 32 heads at dh 64)
    served at full width and depth through ``launch.serve.serve``, a second
    ``serve()`` traced, the run repeated with the plain attention, then
    trained through ``launch.train.train``; qwen2-vl-72b (M-RoPE, 64 / 8
    heads at dh 128) served cut to ``L_QWEN_SERVE_LAYERS`` layers, one more
    prefill at image-layout ids (``_image_ids``) through
    ``serve_step.make_prefill``, ``apply_mrope`` at those ids against f64
    and against ``apply_rope`` at the t ids, then trained cut to
    ``L_QWEN_TRAIN_LAYERS`` layer with a warm step traced.  K8 against
    its plain version and an f64 oracle on the first and last layer's
    inputs in prefill and the last decode step, and with ``lse`` and the
    gradients on the first step's; the five shapes timed (``_l_time``).
    Adds path L's launches and its shapes (``path_l_shapes``) to the
    ``flash`` and ``flash_decode`` rows."""
    import statistics
    import numpy as np
    import torch
    from repro_torch.configs import get_arch, single_card
    from repro_torch.kernels import flash as tflash
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as tlaunch
    from repro_torch.models import layers as tlayers
    from repro_torch.models import model as TM
    from repro_torch.train.step import make_train_step

    P, T, B = LM_PROMPT_LEN, LM_NEW_TOKENS, LM_REQUESTS
    real = dict(flash=tlayers.flash_attention, card=tserve.single_card,
                init=TM.init_params, prefill=tserve.serve_step.make_prefill,
                decode=tserve.serve_step.make_decode_step)
    shapes = {}
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed + 17)

    def config(arch, layers=None):
        c = single_card(get_arch(arch))
        if layers is not None:
            c = dataclasses.replace(c, n_layers=layers,
                                    pattern=c.pattern[:layers])
        return c

    def recording(store, wanted):
        """K8 as the model calls it, keeping copies of the inputs of the
        calls numbered in ``wanted``."""
        calls = [0]

        def rec(q, k, v, *, q_offset, kv_valid=None, **kw):
            if calls[0] in wanted:
                store[calls[0]] = tuple(t.detach().clone() for t in (
                    q, k, v)) + (int(q_offset), k.shape[1] if kv_valid is
                                 None else int(kv_valid))
            calls[0] += 1
            return real["flash"](q, k, v, q_offset=q_offset,
                                 kv_valid=kv_valid, **kw)
        return rec

    def plain(q, k, v, *, q_offset, kv_valid=None, **kw):
        return tflash.flash_attention_plain(q, k, v, q_offset=q_offset,
                                            kv_valid=kv_valid)

    def served(arch, cfg, attn, keep, tag=None):
        """serve() with K8 as ``attn`` and the arch as ``cfg``; the weights
        and the prefill logits kept in ``keep``; prefill and each decode
        step under the annotations ``tag + " prefill"`` / ``" decode"``
        where ``tag`` is given."""
        def init(*a, **kw):
            keep["params"] = real["init"](*a, **kw)
            return keep["params"]

        def make(which):
            def made(c):
                fn = real[which](c)

                def run(*a):
                    with torch.profiler.record_function(
                            f"{tag} {which}") if tag else \
                            contextlib.nullcontext():
                        out = fn(*a)
                    if which == "prefill":
                        keep["logits"] = out[0].clone()
                    return out
                return run
            return made
        tlayers.flash_attention = attn
        tserve.single_card = lambda c: cfg
        TM.init_params = init
        tserve.serve_step.make_prefill = make("prefill")
        tserve.serve_step.make_decode_step = make("decode")
        try:
            return tserve.serve(arch, reduced=False, requests=B,
                                prompt_len=P, new_tokens=T, seed=args.seed)
        finally:
            tlayers.flash_attention = real["flash"]
            tserve.single_card = real["card"]
            TM.init_params = real["init"]
            tserve.serve_step.make_prefill = real["prefill"]
            tserve.serve_step.make_decode_step = real["decode"]

    def check_captured(arch, store, n_layers):
        """K8 on the captured serving inputs; returns the largest |kernel -
        plain| by tile."""
        errs = {"flash": 0.0, "flash_decode": 0.0}
        for i, (q, k, v, qo, kvv) in sorted(store.items()):
            step, layer = divmod(i, n_layers)
            name = tflash.tile_of(q.dtype, q.shape[-1],
                                  q.shape[1] * q.shape[2] // k.shape[2])
            r = _k8_check(h, f"{arch} step {step} layer {layer} ({name})",
                          q, k, v, qo, kvv)
            errs[name] = max(errs[name], r["max_abs_err"])
            where = "prefill" if step == 0 else f"decode step {step}"
            print(f"  K8 {name}, {where} layer {layer} (q "
                  f"{tuple(q.shape)}, k/v {tuple(k.shape)}, q_offset {qo}, "
                  f"kv_valid {kvv}): in ulps of the magnitude, kernel - plain"
                  f" {r['plain']:.6f}, kernel - f64 {r['f64']:.6f}, plain - "
                  f"f64 {r['plain vs f64']:.6f}; max |kernel - plain| "
                  f"{r['max_abs_err']:.6e}")
        return errs

    def end_to_end(arch, v_, lk, lp, toks, toks_p):
        """The prefill logits, kernel vs plain attention, within
        ``LM_LOGIT_TOL``; the first greedy ids (of the ``v_`` real ones)
        wherever the margin allows."""
        dl = float((lk - lp).abs().max())
        top2 = torch.topk(lp[:, :v_], 2).values
        margin = (top2[:, 0] - top2[:, 1]).cpu().numpy()
        sure = margin > 2 * LM_LOGIT_TOL
        first_k = lk[:, :v_].argmax(-1).cpu().numpy()
        first_p = lp[:, :v_].argmax(-1).cpu().numpy()
        if dl > LM_LOGIT_TOL or not (first_k[sure] == first_p[sure]).all() \
                or not (first_k == toks[:, 0]).all():
            raise AssertionError(f"path L {arch} kernel vs plain prefill "
                                 f"logits: max |diff| {dl} (tolerance "
                                 f"{LM_LOGIT_TOL}), first ids {first_k} / "
                                 f"{first_p} / {toks[:, 0]}")
        agree = toks_p == toks
        print(f"  end to end with the plain attention: prefill logits max "
              f"|kernel - plain| {dl:.6e} (tolerance {LM_LOGIT_TOL}; logits "
              f"max {float(lp.abs().max()):.6f}); top-2 margins "
              f"{np.round(margin, 6).tolist()}; greedy ids equal "
              f"{int(agree.sum())} of {agree.size}")

    def serve_phase(arch, cfg, trace):
        n = cfg.n_layers
        store, keep = {}, {}
        # prefill's and the last decode step's first and last layer
        wanted = (0, n - 1, T * n, T * n + n - 1)
        torch.cuda.reset_peak_memory_stats()
        h.reset_counters()
        t0 = time.perf_counter()
        res, t_all = _sync_time(lambda: served(arch, cfg,
                                               recording(store, wanted),
                                               keep))
        launches = h.counters()
        peak = torch.cuda.max_memory_allocated() / 2**30
        want = {"flash": n, "flash_decode": n * T, "flash_combine": n * T,
                "flash_cc": 0, "flash_bias": 0}
        if {k: launches[k] for k in want} != want or launches["lookup"] <= 0:
            raise AssertionError(f"path L {arch} launches {launches}, want "
                                 f"{want} and K1 at least once")
        toks, lk = res.tokens, keep["logits"]
        if toks.shape != (B, T + 1) or toks.min() < 0 or \
                toks.max() >= cfg.vocab_size or \
                lk.shape != (B, cfg.vocab_padded) or \
                not bool(torch.isfinite(lk).all()):
            raise AssertionError(f"path L {arch}: ids {toks.shape} or logits"
                                 f" {tuple(lk.shape)} misshapen or not "
                                 f"finite")
        sizes = []
        TM.tree_map(lambda t: sizes.append(t.numel()), keep["params"])
        print(f"phase 17: path L ({arch}, single card: {n} layers, d_model "
              f"{cfg.d_model}, {cfg.n_heads} query / {cfg.n_kv_heads} KV "
              f"heads, dh {cfg.head_dim}, rope {cfg.rope!r}, inputs "
              f"{'frame embeddings' if cfg.embed_input else 'token ids'}, "
              f"{sum(sizes)} parameters) served; {B} requests x {P} prompt "
              f"+ {T} new positions; launches "
              f"{ {k: v for k, v in launches.items() if v} }")
        print(f"  prefill {res.prefill_s:.6f} s; decode {res.decode_s:.6f} s "
              f"for {T} steps ({res.decode_tok_s:.3f} tokens/s); serve() "
              f"{t_all:.6f} s with weight init and input draws; peak memory "
              f"allocated {peak:.3f} GiB; page table over {res.pages} pages")
        print(f"  greedy ids (first 8 of each request): "
              f"{toks[:, :8].tolist()}")
        rows["lookup"]["launches"] += launches["lookup"]
        errs = check_captured(arch, store, n)
        for name in ("flash", "flash_decode"):
            rows[name]["launches"] += launches[name]
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                            errs[name])
        prefill_in, decode_in = store[0], store[T * n]
        del store
        params = keep.pop("params")
        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                res_t = served(arch, cfg, real["flash"], {}, tag="path L")
            path = ROOT / "build" / "path_l_trace.json"
            path.parent.mkdir(exist_ok=True)
            prof.export_chrome_trace(str(path))
            del prof
            split = _trace_windows(path, ("path L prefill", "path L decode"))
            path.unlink()
            for tag_, w in split.items():
                kinds = ", ".join(f"{k} {v:.6f} s ({v / w['busy']:.3%} of "
                                  f"busy)" for k, v in sorted(
                                      w["kinds"].items(),
                                      key=lambda kv: -kv[1]))
                per = "" if tag_.endswith("prefill") else \
                    f" ({w['events'] / T:.1f} a decode step)"
                print(f"  traced {tag_}: wall {w['wall']:.6f} s, device "
                      f"busy {w['busy']:.6f} s, idle share "
                      f"{1 - w['busy'] / w['wall']:.6f}; {w['events']} "
                      f"device events{per}; by kind {kinds}")
            print(f"  the traced serve(): prefill {res_t.prefill_s:.6f} s, "
                  f"{res_t.decode_tok_s:.3f} tokens/s (untraced "
                  f"{res.prefill_s:.6f} s, {res.decode_tok_s:.3f})")
        kept = {}
        res_p = served(arch, cfg, plain, kept)
        end_to_end(arch, cfg.vocab_size, lk, kept["logits"], toks,
                   res_p.tokens)
        print(f"  plain attention: prefill {res_p.prefill_s:.6f} s, decode "
              f"{res_p.decode_tok_s:.3f} tokens/s; path wall "
              f"{time.perf_counter() - t0:.3f} s")
        del kept, res_p
        return params, prefill_in, decode_in

    def train_phase(arch, cfg, batch):
        n = cfg.n_layers
        captured = {}
        torch.cuda.reset_peak_memory_stats()
        h.reset_counters()
        tlayers.flash_attention = recording(captured, (0, n - 1))
        t0 = time.perf_counter()
        try:
            res, t_all = _sync_time(lambda: tlaunch.train(
                arch, steps=L_TRAIN_STEPS, batch=batch, seq=I_SEQ,
                lr=L_LR[arch],
                reduced=False, n_layers=n, ckpt_dir=None, log_every=1,
                seed=args.seed))
        finally:
            tlayers.flash_attention = real["flash"]
        launches, with_lse = h.counters(), dict(tflash.LSE_LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        want = {"flash": 2 * n * L_TRAIN_STEPS, "flash_decode": 0,
                "flash_combine": 0, "flash_cc": 0, "flash_bias": 0}
        if {k: launches[k] for k in want} != want or \
                with_lse["flash"] != want["flash"]:
            raise AssertionError(f"path L {arch} training launches "
                                 f"{launches}, with lse {with_lse}; want "
                                 f"{want}, every one with lse")
        losses = res.losses
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"path L {arch} losses {losses}: not finite"
                                 f" or not falling")
        warm = statistics.median(res.step_s[1:])
        print(f"phase 17: path L ({arch}) trained: {n} layers, "
              f"{cfg.param_count()} parameters; {L_TRAIN_STEPS} steps of "
              f"{batch} x {I_SEQ}, lr {L_LR[arch]}, remat on")
        print(f"  losses {[round(x, 6) for x in losses]}; grad norms "
              f"{[round(x, 6) for x in res.grad_norms]}")
        print(f"  step seconds {[round(x, 6) for x in res.step_s]}; warm "
              f"(median of steps 2-{L_TRAIN_STEPS}) {warm:.6f} s, "
              f"{batch * I_SEQ / warm:.1f} tokens/s; train() {t_all:.3f} s "
              f"with weight init; peak memory allocated {peak:.3f} GiB; K8 "
              f"launches {launches['flash']} (all with lse)")
        rows["flash"]["launches"] += launches["flash"]
        return res, captured, t0

    def check_train(arch, captured, t0):
        err = max(_lse_grad_check(h, g, f"{arch} training layer {layer}",
                                  q, k, v, L_LSE_ATOL, I_GRAD_ULPS)
                  for layer, (q, k, v, _, _) in sorted(captured.items()))
        rows["flash"]["max_abs_err"] = max(rows["flash"]["max_abs_err"], err)
        q, k, v, _, _ = captured[0]
        shapes[f"{arch} training"] = _l_time(h, q, k, v, 0, q.shape[1], True)
        print(f"  path wall (training) {time.perf_counter() - t0:.3f} s")

    def free():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    # ---- musicgen-large: frame embeddings, no rotation -------------------
    arch = "musicgen-large"
    cfg = config(arch)
    params, pre, dec = serve_phase(arch, cfg, trace=True)
    del params
    shapes[f"{arch} prefill"] = _l_time(h, *pre, False)
    shapes[f"{arch} decode"] = _l_time(h, *dec, False)
    del pre, dec
    free()
    res, captured, t0 = train_phase(arch, cfg, I_BATCH)
    del res
    free()
    check_train(arch, captured, t0)
    del captured
    free()

    # ---- qwen2-vl-72b: M-RoPE, 64 / 8 heads -------------------------------
    arch = "qwen2-vl-72b"
    cfg = config(arch, L_QWEN_SERVE_LAYERS)
    params, pre, dec = serve_phase(arch, cfg, trace=False)
    shapes[f"{arch} prefill"] = _l_time(h, *pre, False)
    shapes[f"{arch} decode"] = _l_time(h, *dec, False)
    del pre, dec
    # one more prefill at image-layout ids, kernel and plain attention
    ids = _image_ids(B, P, dev)
    prompts = torch.from_numpy(np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (B, P))).to(device=dev, dtype=torch.int32)
    text = torch.arange(P, dtype=torch.int32, device=dev)[None] \
        .expand(3, B, P)
    prefill = tserve.serve_step.make_prefill(cfg)
    out = {}
    for tag, attn, pos in (("image", real["flash"], ids),
                           ("image, plain", plain, ids),
                           ("text", real["flash"], text)):
        caches = TM.init_cache(cfg, B, P + T, device=dev)
        tlayers.flash_attention = attn
        try:
            (out[tag], _), dt = _sync_time(lambda: h.uncounted(
                lambda: prefill(params, caches, prompts, pos)))
        finally:
            tlayers.flash_attention = real["flash"]
        print(f"  prefill at {tag} ids: {dt:.6f} s")
        del caches
    d_img = float((out["image"] - out["image, plain"]).abs().max())
    d_txt = float((out["image"] - out["text"]).abs().max())
    if not bool(torch.isfinite(out["image"]).all()) or \
            d_img > LM_LOGIT_TOL or d_txt <= LM_LOGIT_TOL:
        raise AssertionError(f"path L image-layout prefill: kernel vs plain "
                             f"{d_img} (tolerance {LM_LOGIT_TOL}), against "
                             f"text positions {d_txt} (must exceed it)")
    print(f"  image-layout ids ({L_IMAGE[0]} text, a {L_IMAGE[1]} x "
          f"{L_IMAGE[2]} grid at one t, text after; t, h, w up to "
          f"{ids.amax(dim=(1, 2)).tolist()}): logits max |kernel - plain| "
          f"{d_img:.6e} (tolerance {LM_LOGIT_TOL}), against the same prompt "
          f"at text positions {d_txt:.6e} (must exceed the tolerance: the "
          f"h and w ids reach the logits)")
    del out, params, prompts, text
    free()
    # apply_mrope on the card at those ids against f64, and against RoPE
    # at the t ids (the planted check that the h and w sections act)
    x = torch.randn((B, P, cfg.n_heads, cfg.head_dim), generator=g,
                    device=dev).mul_(3.0).to(torch.bfloat16)
    got = tlayers.apply_mrope(x, ids, cfg.rope_theta, cfg.mrope_sections)
    exact, mag = _mrope_f64(x, ids, cfg.rope_theta, cfg.mrope_sections)
    d = (got.double() - exact).abs() / _bf16_ulp(mag)
    rope = tlayers.apply_rope(x, ids[0], cfg.rope_theta)
    moved = int((rope != got).sum())
    if float(d.max()) > 1 or not moved:
        raise AssertionError(f"apply_mrope at image ids: {float(d.max())} "
                             f"bf16 ulps of the magnitude from f64; entries "
                             f"differing from RoPE at the t ids {moved}")
    print(f"  apply_mrope (x {tuple(x.shape)}, sections "
          f"{cfg.mrope_sections}) at the image ids: max {float(d.max()):.6f}"
          f" bf16 ulps of the magnitude from f64 (tolerance 1); "
          f"{moved} of {got.numel()} entries differ from apply_rope at the "
          f"t ids (planted: the h and w sections act)")
    del x, got, exact, mag, d, rope, ids
    free()
    cfg = config(arch, L_QWEN_TRAIN_LAYERS)
    res, captured, t0 = train_phase(arch, cfg, L_QWEN_TRAIN_BATCH)
    # one warm step traced: the token table's index backward among the rest
    pos = torch.arange(I_SEQ, dtype=torch.int32, device=dev)[None] \
        .expand(3, L_QWEN_TRAIN_BATCH, I_SEQ)
    inputs = torch.randint(0, cfg.vocab_size, (L_QWEN_TRAIN_BATCH, I_SEQ),
                           generator=g, device=dev, dtype=torch.int32)
    labels = torch.randint(0, cfg.vocab_size, (L_QWEN_TRAIN_BATCH, I_SEQ),
                           generator=g, device=dev, dtype=torch.int32)
    step_fn = make_train_step(cfg, lr=L_LR[arch])
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("path L step"):
            h.uncounted(lambda: step_fn(res.params, res.opt, inputs, labels,
                                        pos))
        torch.cuda.synchronize()
    trace = ROOT / "build" / "path_l_train_trace.json"
    prof.export_chrome_trace(str(trace))
    del prof
    w = _trace_kinds(trace, "path L step", span_of=_l_span)
    trace.unlink()
    kinds = ", ".join(f"{k_} {v_:.6f} s ({v_ / w['busy']:.3%} of busy)"
                      for k_, v_ in sorted(w["kinds"].items(),
                                           key=lambda kv: -kv[1]))
    print(f"  traced warm step ({arch}, {cfg.n_layers} layer): wall "
          f"{w['wall']:.6f} s, device busy {w['busy']:.6f} s, idle share "
          f"{1 - w['busy'] / w['wall']:.6f}; {w['events']} device events; "
          f"by kind {kinds}")
    print("    top kernels: " + "; ".join(f"{n_} {t_:.6f} s"
                                          for n_, t_ in w["top"]))
    del res, step_fn, inputs, labels, pos
    free()
    check_train(arch, captured, t0)
    del captured
    free()

    for name, sh in shapes.items():
        print(f"  K8 at {name}: " + ", ".join(
            f"{k} {v:.6f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in sh.items()))
    for name in ("flash", "flash_decode"):
        rows[name]["path_l_shapes"] = {
            k: v for k, v in shapes.items() if v["tile"] == name}


def _partial_f64(q, k, v, q_offset: int):
    """K8's return_partial form in f64 on a chunk: each row's m (the max of
    its scaled scores, -1e30 where it sees no key), l = sum e^(s - m) and
    acc = sum e^(s - m) v, (B, H, Sq) and (B, H, Sq, dh); and mag, the
    same sum of e^(s - m) |v| (the scale acc's f32 roundings take)."""
    import torch
    G = q.shape[2] // k.shape[2]
    keep = _keep(q, k, q_offset)
    ms, ls, accs, mags = [], [], [], []
    for b in range(q.shape[0]):
        s = _f64_scores(q[b].double(), k[b].double(), None, keep)
        m = s.amax(-1).clamp_min(-1e30)
        p = torch.exp(s - m[..., None])
        vb = v[b].double().repeat_interleave(G, 1)
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("hqk,khd->hqd", p, vb))
        mags.append(torch.einsum("hqk,khd->hqd", p, vb.abs()))
    return tuple(torch.stack(t) for t in (ms, ls, accs, mags))


def _partial_check(h, what, q, k, v, off) -> dict:
    """K8's return_partial launch (uncounted) against its plain version
    (the split-KV plain version stopped before its division, at the
    launch's runs) and the f64 partial: m within ``M_PART_RTOL`` of
    max(1, |m|), l and acc, brought to the f64 m by e^(m - m64), within
    ``M_PART_RTOL`` of l64 and of the f64 sum of e^(s - m) |v|.  Raises
    beyond; returns the largest |kernel - plain| and the ratios to the
    tolerance."""
    import functools
    import torch
    from repro_torch.kernels import flash as tflash
    got = h.uncounted(functools.partial(tflash.flash_attention, q, k, v,
                                        q_offset=off, return_partial=True))
    n_split = tflash.decode_plan(q, k, q_offset=off, kv_valid=k.shape[1])[0]
    plain = tflash.flash_decode_split_plain(q, k, v, q_offset=off,
                                            n_split=n_split,
                                            return_partial=True)
    m64, l64, a64, mag = _partial_f64(q, k, v, off)
    torch.cuda.synchronize()
    out = {"max_abs_err": max(float((a.double() - b.double()).abs().max())
                              for a, b in zip(got, plain, strict=True))}
    for name, (m, l, acc) in (("plain", plain), ("kernel", got)):
        m, l, acc = m.double(), l.double(), acc.double()
        tol_m = M_PART_RTOL * m64.abs().clamp_min(1.0)
        e = torch.exp(m - m64)
        e = torch.where(m64 <= -1e29, torch.ones_like(e), e)
        tol_l = M_PART_RTOL * l64.clamp_min(1e-30)
        tol_a = M_PART_RTOL * mag.clamp_min(1e-30)
        r = max(float(((m - m64).abs() / tol_m).max()),
                float(((l * e - l64).abs() / tol_l).max()),
                float(((acc * e[..., None] - a64).abs() / tol_a).max()))
        out[name] = r
        if not r <= 1.0:
            raise AssertionError(f"K8 return_partial {what}: {name} vs the "
                                 f"f64 partial {r:.3f} times the tolerance "
                                 f"{M_PART_RTOL}")
    return out


def _merge_check(h, what, parts, q, kg, vg, L) -> dict:
    """The combine across positions (uncounted) on the D positions' stacked
    partials against ``flash_merge_plain`` on the same partials and against
    the dense f64 attention of the query over the global keys [0, L]
    (every chunk's keys), each within one bf16 ulp of the magnitude (the
    attention of |v|); raises beyond.  Returns the largest |kernel -
    plain| and both readings in ulps."""
    import functools
    import torch
    from repro_torch.kernels import flash as tflash
    got = h.uncounted(functools.partial(tflash.flash_merge, *parts))
    plain = tflash.flash_merge_plain(*parts)
    exact = _dense_f64(q, kg, vg, L, L + 1)
    mag = tflash.flash_attention_plain(q.float(), kg.float(),
                                       vg.float().abs(), q_offset=L,
                                       kv_valid=L + 1)
    torch.cuda.synchronize()
    tol = _bf16_ulp(mag)
    out = {"max_abs_err": float((got.double() - plain.double()).abs().max())}
    for name, a, b in (("plain", got, plain), ("f64", got, exact),
                       ("plain vs f64", plain, exact)):
        d = (a.double() - b.double()).abs()
        if not bool((d <= tol).all()):
            raise AssertionError(f"K8 merge {what} vs {name}: "
                                 f"{int((d > tol).sum())} entries beyond one "
                                 f"bf16 ulp of the magnitude (max "
                                 f"{float(d.max())})")
        out[name] = float((d / tol).max())
    return out


def _path_m(args, dev, rows, h) -> None:
    """Phase 18, path M: qwen3-4b in its published layout (tp 16,
    ``tp_shard``, KV heads replicated over ``model``) at full width and
    depth on ``ModelMesh`` positions that are all this card, counted.
    (1, 1, 16) at path D's traffic through ``make_prefill(cfg, mesh)`` and
    ``make_decode_step(cfg, mesh)``, gated against the one-card form on the
    same global weights; then a ``M_SEQ_PROMPT``-token prompt prefilled on
    (1, 1, 16) into ``M_SEQ_MAX``-position caches, laid onto (1, 4, 16)'s
    chunks by ``gather_tree`` / ``shard_tree`` and decoded ``M_STEPS``
    steps sequence-sharded, teacher-forced with the unsharded (1, 1, 16)
    decode's tokens and gated against its logits; K8 at group 2 and its
    two new forms against their plain versions and f64, planted faults,
    the new forms' rows of the kernels line."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch, single_card
    from repro_torch.kernels import cost as tcost
    from repro_torch.kernels import flash as tflash
    from repro_torch.models import layers as tlayers
    from repro_torch.models import model as TM
    from repro_torch.models import sharding as tsh
    from repro_torch.serve import step as tstep

    t_path = time.perf_counter()
    cfg, one = get_arch(M_ARCH), single_card(get_arch(M_ARCH))
    L, T, P, B = cfg.n_layers, LM_NEW_TOKENS, LM_PROMPT_LEN, LM_REQUESTS
    V = cfg.vocab_size
    mesh = tsh.ModelMesh(M_MESH, devices=dev)
    seq = tsh.ModelMesh(M_SEQ_MESH, devices=dev)
    # the published layout on a 16-wide model axis is exact GQA: its global
    # tree is the one-card tree, and rank r's KV slot is KV head r // 2
    if TM.tree_map(lambda l: l.shape, TM.build_tree(cfg, mesh)) != \
            TM.tree_map(lambda l: l.shape, TM.build_tree(one)):
        raise AssertionError("qwen3-4b's TP-16 tree is not its one-card tree")
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed)
    glob = TM.init_params(one, g, dev)
    params, t_shard = _sync_time(lambda: tstep.shard_tree(
        glob, tstep.serve_param_specs(cfg), mesh))
    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(rng.integers(0, V, (B, P))).to(
        device=dev, dtype=torch.int32)
    pos = torch.arange(P, dtype=torch.int32, device=dev)[None].expand(B, P)
    pre = tstep.make_prefill(cfg, mesh, replicate_weights=True)
    dec = tstep.make_decode_step(cfg, mesh, replicate_weights=True)
    sdec = tstep.make_decode_step(cfg, seq, batch_sharded=False,
                                  seq_shard=True, replicate_weights=True)
    _, c_spec, t_spec, p_spec = pre.in_specs
    real = dict(flash=tlayers.flash_attention, logits=tstep.M.lm_logits,
                merge=tflash.flash_merge)
    # what the wrappers below keep: the K8 calls' inputs named in
    # ``wanted`` by (stage, step, layer, position), the first merge of a
    # layer named there, every lm_logits output
    st = dict(stage="tp", n=mesh.size, calls=0, wanted=set(), merges=0)
    captured, kept = {}, []

    def recording(q, k, v, *, q_offset, kv_valid=None, **kw):
        step, rest = divmod(st["calls"], L * st["n"])
        key = (st["stage"], step) + divmod(rest, st["n"])
        st["calls"] += 1
        if key in st["wanted"]:
            captured[key] = (q.clone(), k.clone(), v.clone(), int(q_offset),
                             None if kv_valid is None else int(kv_valid))
        return real["flash"](q, k, v, q_offset=q_offset, kv_valid=kv_valid,
                             **kw)

    def merging(m, l, acc):
        step, rest = divmod(st["calls"] - 1, L * st["n"])
        key = ("merge", step, rest // st["n"])
        if key in st["wanted"] and key not in captured:
            captured[key] = (m.clone(), l.clone(), acc.clone())
        return real["merge"](m, l, acc)

    def keep_logits(params_, cfg_, x, tp_shard, **kw):
        out = real["logits"](params_, cfg_, x, tp_shard, **kw)
        kept.append(out)
        return out

    def stage(name, n, wanted):
        st.update(stage=name, n=n, calls=0, wanted=wanted)
        tlayers.flash_attention, tstep.M.lm_logits = recording, keep_logits
        tflash.flash_merge = merging
        kept.clear()
        h.reset_counters()
        tsh.reset_collectives()

    def restore():
        tlayers.flash_attention, tstep.M.lm_logits = real["flash"], \
            real["logits"]
        tflash.flash_merge = real["merge"]

    def gathered(per, m_):
        """(B, V_padded) logits from the positions' vocab shards."""
        return tstep.gather_tree(m_.all_gather(per, "model", dim=2),
                                 (None, None, None), m_)[:, 0]

    def decode(fn, m_, params_, caches_, first, steps, start, forced=None):
        """``steps`` greedy steps of ``fn`` from the ids ``first`` (B,),
        or fed ``forced[i]`` at step i: the ids of every step (position
        0's), the caches and the seconds."""
        t_sp, p_sp = fn.in_specs[2], fn.in_specs[3]
        z = tstep.shard_tree(torch.zeros((first.shape[0], 1),
                                         dtype=torch.int32, device=dev),
                             p_sp, m_)
        nxt = tstep.shard_tree(first[:, None], t_sp, m_)
        ids = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            if forced is not None:
                nxt = tstep.shard_tree(forced[i][:, None], t_sp, m_)
            out, caches_ = fn(params_, caches_, nxt, z, start + i)
            nxt = [o[:, None] for o in out]
            ids.append(out[0])
        torch.cuda.synchronize()
        return ids, caches_, time.perf_counter() - t0

    def plain_attention(q, k, v, *, q_offset, kv_valid=None, **kw):
        return tflash.flash_attention_plain(q, k, v, q_offset=q_offset,
                                            kv_valid=kv_valid)

    none = {"flash": 0, "flash_decode": 0, "flash_combine": 0, "flash_cc": 0,
            "flash_bias": 0, "flash_partial": 0, "flash_merge": 0}

    def expect(what, got, **want):
        want = dict(none, **want)
        if {k: got[k] for k in want} != want:
            raise AssertionError(f"path M {what} launches {got}, want {want}")

    # ---- (1, 1, 16) at path D's traffic ------------------------------------
    D = mesh.size
    caches = [TM.init_cache(cfg, B, P + T, device=dev) for _ in range(D)]
    torch.cuda.reset_peak_memory_stats()
    stage("tp", D, {("tp", 0, 0, 0), ("tp", T, 0, 0)})
    try:
        (logits, caches), t_pre = _sync_time(lambda: pre(
            params, caches, tstep.shard_tree(prompts, t_spec, mesh),
            tstep.shard_tree(pos, p_spec, mesh)))
        l_pre, c_pre = h.counters(), tsh.COLLECTIVES["tp_psum"]["bytes"]
        lk = tstep.gather_tree(logits, pre.out_specs[0], mesh)
        tok = lk[:, :V].argmax(-1).to(torch.int32)
        h.reset_counters()
        tsh.reset_collectives()
        ids, caches, t_dec = decode(dec, mesh, params, caches, tok, T, P)
        l_dec = h.counters()
        coll = {k: dict(v) for k, v in tsh.COLLECTIVES.items()}
        peak_a = torch.cuda.max_memory_allocated() / 2**30
    finally:
        restore()
    expect("prefill", l_pre, flash=L * D)
    expect("decode", l_dec, flash_decode=L * D * T, flash_combine=L * D * T)
    toks = torch.stack([tok] + ids, 1)
    if not bool(torch.isfinite(lk).all()) or lk.shape != (B, cfg.vocab_padded):
        raise AssertionError("path M prefill logits not finite or misshapen")
    print(f"phase 18: path M ({M_ARCH} in its published layout: tp "
          f"{cfg.tp}, tp_shard, {cfg.n_heads_padded} query / "
          f"{cfg.n_kv_heads} KV heads, KV replicated over model (2 query "
          f"heads and 1 KV slot a position); {L} layers, "
          f"{cfg.param_count()} parameters) on mesh {M_MESH}, every "
          f"position {dev}: {B} requests x {P} prompt + {T} new tokens; "
          f"shard_tree {t_shard:.6f} s")
    print(f"  prefill {t_pre:.6f} s; decode {t_dec:.6f} s for {T} steps "
          f"({B * T / t_dec:.3f} tokens/s); launches: prefill "
          f"{ {k: v for k, v in l_pre.items() if v} }, decode a step "
          f"{ {k: v // T for k, v in l_dec.items() if v} }; peak memory "
          f"allocated {peak_a:.3f} GiB")
    print(f"  collectives, bytes as if each position were a card: prefill "
          f"tp_psum {c_pre}; decode a step " + ", ".join(
              f"{k} {v['bytes'] // T} ({v['calls'] // T} calls)"
              for k, v in coll.items() if v["calls"]))

    # the one-card form on the same global weights (uncounted: the gate)
    one_pre, one_dec = tstep.make_prefill(one), tstep.make_decode_step(one)
    oc = TM.init_cache(one, B, P + T, device=dev)
    (lo, oc), t_one = _sync_time(lambda: h.uncounted(
        lambda: one_pre(glob, oc, prompts, pos)))
    d_pre = float((lk - lo).abs().max())
    gate = LM_LOGIT_TOL
    if d_pre > gate:
        # the control: the one-card form with K8's plain version
        tlayers.flash_attention = plain_attention
        try:
            lp, _ = one_pre(glob, TM.init_cache(one, B, P + T, device=dev),
                            prompts, pos)
        finally:
            restore()
        ctrl = float((lo - lp).abs().max())
        gate = max(LM_LOGIT_TOL, J_CONTROL_FACTOR * ctrl)
        print(f"  control (the one-card form, kernel vs plain attention): "
              f"{ctrl:.6e}; gate {gate:.6e}")
    first_o = lo[:, :V].argmax(-1).to(torch.int32)
    top2 = torch.topk(lo[:, :V], 2).values
    margin = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    sure = margin > 2 * gate
    if d_pre > gate or not (first_o == tok).cpu().numpy()[sure].all():
        raise AssertionError(f"path M TP-16 prefill vs the one-card form: "
                             f"max |diff| {d_pre} (gate {gate}); first tokens "
                             f"{tok.tolist()} / {first_o.tolist()}")
    o_ids, o_tok = [first_o], first_o
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(T):
        o_tok, oc = h.uncounted(lambda: one_dec(glob, oc, o_tok[:, None],
                                                None, P + i))
        o_ids.append(o_tok)
    torch.cuda.synchronize()
    t_one_dec = time.perf_counter() - t0
    agree = (torch.stack(o_ids, 1) == toks).cpu().numpy()
    lead = [int(np.argmin(np.append(a, False))) for a in agree]
    print(f"  TP-16 prefill logits vs the one-card form on the same global "
          f"weights: max |diff| {d_pre:.6e} (gate {gate}; logits max "
          f"{float(lo.abs().max()):.6f}); top-2 margins "
          f"{np.round(margin, 6).tolist()}; greedy tokens equal "
          f"{int(agree.sum())} of {agree.size}, leading run per request "
          f"{lead}; one-card prefill {t_one:.6f} s, decode "
          f"{B * T / t_one_dec:.3f} tokens/s")
    # K8 at group 2 (2 query heads over 1 KV slot, dh 128): both bf16 tiles
    for key in (("tp", 0, 0, 0), ("tp", T, 0, 0)):
        q, k, v, qo, kvv = captured.pop(key)
        name, what = ("flash", "prefill") if key[1] == 0 else \
            ("flash_decode", "decode")
        r = _k8_check(h, f"path M {what} (group 2)", q, k, v, qo, kvv)
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                        r["max_abs_err"])
        sh = _l_time(h, q, k, v, qo, kvv, False)
        rows[name]["path_m_shape"] = sh
        print(f"  K8 {name} at group 2 (q {tuple(q.shape)}, k/v "
              f"{tuple(k.shape)}): {r['plain']:.6f} ulps of the magnitude "
              f"from plain, {r['f64']:.6f} from f64; kernel {sh['ms']:.6f} "
              f"ms, plain {sh['plain_ms']:.6f}, SDPA {sh['sdpa_ms']:.6f}, "
              f"bound {sh['bound_ms']:.6f} ({sh['bound_by']})")
    rows["flash"]["launches"] += l_pre["flash"]
    rows["flash_decode"]["launches"] += l_dec["flash_decode"]
    del caches, oc, logits, lo, ids, o_ids, o_tok, toks
    gc.collect()
    torch.cuda.empty_cache()

    # ---- a long prompt, then sequence-sharded decode ------------------------
    SM, PS, N = M_SEQ_MAX, M_SEQ_PROMPT, M_STEPS
    S_l = SM // seq.axis_size("data")
    prompt1 = torch.from_numpy(rng.integers(0, V, (1, PS))).to(
        device=dev, dtype=torch.int32)
    pos1 = torch.arange(PS, dtype=torch.int32, device=dev)[None]
    caches = [TM.init_cache(cfg, 1, SM, device=dev) for _ in range(D)]
    torch.cuda.reset_peak_memory_stats()
    h.reset_counters()
    (logits, caches), t_pre1 = _sync_time(lambda: pre(
        params, caches, tstep.shard_tree(prompt1, t_spec, mesh),
        tstep.shard_tree(pos1, p_spec, mesh)))
    l_pre1 = h.counters()
    expect("long prefill", l_pre1, flash=L * D)
    tok0 = tstep.gather_tree(logits, pre.out_specs[0], mesh)[:, :V] \
        .argmax(-1).to(torch.int32)

    def lay(per):
        """The (1, 1, 16) caches as the global tree, cut into (1, 4, 16)'s
        chunks of the time axis (a copy a position)."""
        whole = tstep.gather_tree(per, c_spec, mesh)
        return tstep.shard_tree(whole, sdec.in_specs[1], seq, share=False)
    s_caches, t_lay = _sync_time(lambda: lay(caches))
    # the data replicas of a model shard hold its tensors, as shard_tree
    # lays them: the (1, 1, 16) positions' own
    s_params = [params[seq.axis_index("model", r)] for r in range(seq.size)]
    D2 = seq.size
    stage("tp", D, set())
    try:
        u_ids, caches, t_udec = decode(dec, mesh, params, caches, tok0, N, PS)
        l_udec = h.counters()
        u_logits = [gathered(x_, mesh) for x_ in kept]
        last = {("seq", N - 1, layer, seq.position(data=c_))
                for layer in (0, L - 1) for c_ in range(4)}
        stage("seq", D2, last | {("merge", N - 1, 0), ("merge", N - 1, L - 1)})
        torch.cuda.reset_peak_memory_stats()
        s_ids, s_caches, t_sdec = decode(sdec, seq, s_params, s_caches, tok0,
                                         N, PS, forced=[tok0] + u_ids)
        l_sdec = h.counters()
        s_coll = {k: dict(v) for k, v in tsh.COLLECTIVES.items()}
        peak_b = torch.cuda.max_memory_allocated() / 2**30
        s_logits = [gathered(x_, seq) for x_ in kept]
    finally:
        restore()
    expect("unsharded decode", l_udec, flash_decode=L * D * N,
           flash_combine=L * D * N)
    rows["flash"]["launches"] += l_pre1["flash"]
    rows["flash_decode"]["launches"] += l_udec["flash_decode"]
    expect("sequence-sharded decode", l_sdec, flash_partial=L * D2 * N,
           flash_merge=L * D2 * N)
    print(f"  long context: prompt {PS} tokens into {SM}-position caches "
          f"(on {M_SEQ_MESH} chunks of {S_l}: 0 and 1 full, 2 the owner of "
          f"the new tokens, 3 empty); prefill {t_pre1:.6f} s on {M_MESH}; "
          f"caches laid onto the chunks (gather_tree, shard_tree) "
          f"{t_lay:.6f} s")
    print(f"  unsharded decode on {M_MESH}: {N} steps {t_udec:.6f} s "
          f"({N / t_udec:.3f} tokens/s), launches a step "
          f"{ {k: v // N for k, v in l_udec.items() if v} }")
    print(f"  sequence-sharded decode on {M_SEQ_MESH}: {N} steps "
          f"{t_sdec:.6f} s ({N / t_sdec:.3f} tokens/s), launches a step "
          f"{ {k: v // N for k, v in l_sdec.items() if v} }; peak memory "
          f"allocated {peak_b:.3f} GiB; collectives a step, bytes as if each"
          f" position were a card: " + ", ".join(
              f"{k} {v['bytes'] // N} ({v['calls'] // N} calls)"
              for k, v in s_coll.items() if v["calls"]))
    diffs = [float((a - b).abs().max())
             for a, b in zip(s_logits, u_logits, strict=True)]
    gate_s = LM_LOGIT_TOL
    if max(diffs) > gate_s:
        # the control: the unsharded decode's last step again, on copies of
        # its caches, with K8's plain version
        copies = [{p_: {k_: t_.clone() for k_, t_ in c_.items()}
                   for p_, c_ in cr.items()} for cr in caches]
        tlayers.flash_attention, tstep.M.lm_logits = plain_attention, \
            keep_logits
        kept.clear()
        try:
            h.uncounted(lambda: decode(dec, mesh, params, copies, tok0, 1,
                                       PS + N - 1,
                                       forced=[([tok0] + u_ids)[N - 1]]))
        finally:
            restore()
        ctrl = float((gathered(kept[0], mesh) - u_logits[-1]).abs().max())
        del copies
        gate_s = max(LM_LOGIT_TOL, J_CONTROL_FACTOR * ctrl)
        print(f"  control (the last unsharded step with K8's plain "
              f"version): {ctrl:.6e}; gate {gate_s:.6e}")
    if max(diffs) > gate_s or not bool((s_ids[0] == u_ids[0]).all()) or \
            not all(bool(torch.isfinite(x_).all()) for x_ in s_logits):
        raise AssertionError(f"path M sequence-sharded decode vs unsharded: "
                             f"max |diff| a step {diffs} (gate {gate_s}); "
                             f"first tokens {s_ids[0].tolist()} / "
                             f"{u_ids[0].tolist()}")
    s_agree = sum(int(bool((a == b).all()))
                  for a, b in zip(s_ids, u_ids, strict=True))
    print(f"  sequence-sharded vs unsharded decode logits, each step: max "
          f"|diff| {max(diffs):.6e} (gate {gate_s}; first {diffs[0]:.6e}, "
          f"last {diffs[-1]:.6e}); first token equal; greedy tokens equal "
          f"{s_agree} of {N}")

    # ---- K8's two new forms against plain and f64 --------------------------
    part_rows, merge_rows = {}, {}
    L_last = PS + N - 1
    for layer in (0, L - 1):
        parts = [captured[("seq", N - 1, layer, seq.position(data=c_))]
                 for c_ in range(4)]
        for c_, (q, k, v, off, _) in enumerate(parts):
            part_rows[(layer, c_)] = _partial_check(
                h, f"layer {layer} chunk {c_} (q_offset {off})", q, k, v, off)
        q = parts[0][0]
        kg = torch.cat([p_[1] for p_ in parts], 1)[:, :L_last + 1]
        vg = torch.cat([p_[2] for p_ in parts], 1)[:, :L_last + 1]
        merged = captured[("merge", N - 1, layer)]
        merge_rows[layer] = _merge_check(h, f"layer {layer}", merged, q, kg,
                                         vg, L_last)
        print(f"  K8 at layer {layer}, the last step's chunks (q_offset "
              f"{[p_[3] for p_ in parts]}): return_partial vs its plain "
              f"version and f64 (tolerance {M_PART_RTOL} of each scale), "
              f"ratios to it " + ", ".join(
                  f"chunk {c_} {part_rows[(layer, c_)]['plain']:.4f} / "
                  f"{part_rows[(layer, c_)]['kernel']:.4f}" for c_ in
                  range(4)) + f"; the combine across the positions vs its "
              f"plain version {merge_rows[layer]['plain']:.6f} and vs f64 "
              f"over the {L_last + 1} keys {merge_rows[layer]['f64']:.6f} "
              f"bf16 ulps of the magnitude (tolerance 1)")
        if layer:
            continue
        # planted: the rescaling e^(m_i - M) dropped (every m_i = 0)
        m_, l_, a_ = merged
        bad = h.uncounted(lambda: tflash.flash_merge(torch.zeros_like(m_),
                                                     l_, a_))
        exact = _dense_f64(q, kg, vg, L_last, L_last + 1)
        mag = tflash.flash_attention_plain(q.float(), kg.float(),
                                           vg.float().abs(), q_offset=L_last,
                                           kv_valid=L_last + 1)
        beyond = int(((bad.double() - exact).abs() > _bf16_ulp(mag)).sum())
        # planted: chunk 0's last 64-key tile dropped from its partial
        q0, k0, v0, off0, _ = parts[0]
        bm, bl, _ = h.uncounted(lambda: tflash.flash_attention(
            q0, k0, v0, q_offset=off0, kv_valid=k0.shape[1] - 64,
            return_partial=True))
        m64, l64, _, _ = _partial_f64(q0, k0, v0, off0)
        rel = float(((bl.double() * torch.exp(bm.double() - m64) - l64)
                     .abs() / l64).max())
        if not beyond or not rel > M_PART_RTOL:
            raise AssertionError(f"path M planted faults pass the checks: the "
                                 f"combine without e^(m_i - M) {beyond} "
                                 f"entries beyond; a dropped tile {rel}")
        print(f"    planted faults caught: the combine without e^(m_i - M)"
              f": {beyond} of {bad.numel()} entries beyond one bf16 ulp of "
              f"f64; return_partial without chunk 0's last 64-key tile: l "
              f"{rel:.3e} from f64 (tolerance {M_PART_RTOL})")

    # ---- their rows of the kernels line, at a full chunk's shape -----------
    q, k, v, off, _ = captured[("seq", N - 1, 0, seq.position(data=0))]
    n_split, per = tflash.decode_plan(q, k, q_offset=off, kv_valid=k.shape[1])
    pw = tflash.tile_work(q, k, off, k.shape[1], "flash_partial",
                          partial=True)
    rows["flash_partial"] = _time_row(
        "flash_partial", lambda: h.uncounted(lambda: tflash.flash_attention(
            q, k, v, q_offset=off, return_partial=True)),
        lambda: tflash.flash_decode_split_plain(
            q, k, v, q_offset=off, n_split=n_split, return_partial=True),
        _sdpa_call(q, k, v, off, k.shape[1]),
        [(pw.bytes, pw.ops)],
        l_sdec["flash_partial"],
        max(r["max_abs_err"] for r in part_rows.values()), reps=100,
        plain_reps=20)
    rows["flash_partial"].update(
        n_split=n_split, tiles_per_split=per, library="SDPA (enable_gqa, "
        "group 2) over the chunk, normalised",
        shape=f"q {tuple(q.shape)}, k/v {tuple(k.shape)}, q_offset {off}")
    m_, l_, a_ = captured[("merge", N - 1, 0)]
    mw = tcost.merge_work(m_, l_, a_)
    rows["flash_merge"] = _time_row(
        "flash_merge", lambda: h.uncounted(lambda: tflash.flash_merge(
            m_, l_, a_)),
        lambda: tflash.flash_merge_plain(m_, l_, a_), None,
        [(mw.bytes, mw.ops)], l_sdec["flash_merge"],
        max(r["max_abs_err"] for r in merge_rows.values()), reps=100,
        plain_reps=20)
    rows["flash_merge"]["shape"] = (f"{m_.shape[2]} positions' partials, "
                                    f"acc {tuple(a_.shape)}")
    print(f"  path M wall {time.perf_counter() - t_path:.1f} s")
    del captured, kept, s_caches, caches, s_params, params, glob


class _NHooks:
    """Path N's wrappers around the port while a stage runs (``with``):
    K8's calls (``layers.flash_attention``) kept where ``wanted`` names
    them by (stage, step, attention layer, position), and the first merge
    of a layer by ("merge", step, layer); position 0's routes of every MoE
    layer in order (``layers.moe_route``: the experts and whether each
    assignment is within capacity); every ``lm_logits`` output; each
    ``tp_psum``'s bytes and calls by the function that calls it; and,
    where ``stage(force=)`` holds a list of experts a MoE layer,
    ``layers.top_k`` answering with them (the one-card form fed the TP
    form's routes)."""

    def __init__(self, n_attn: int):
        import collections
        from repro_torch.kernels import flash as tflash
        from repro_torch.models import layers as tlayers
        from repro_torch.models import sharding as tsh
        from repro_torch.serve import step as tstep
        self.mods = (tlayers, tflash, tsh, tstep)
        self.real = dict(flash=tlayers.flash_attention,
                         route=tlayers.moe_route, top_k=tlayers.top_k,
                         logits=tstep.M.lm_logits, merge=tflash.flash_merge,
                         psum=tsh.ModelMesh.tp_psum)
        self.n_attn = n_attn
        self.captured = {}
        self.psum = collections.Counter()
        self.psum_calls = collections.Counter()
        self.stage(None, 1)

    def stage(self, name, n, wanted=(), force=None):
        self.name, self.n, self.wanted = name, n, set(wanted)
        self.calls = self.route_calls = 0
        self.routes, self.kept = [], []
        self.force = None if force is None else list(force)
        self.psum.clear()
        self.psum_calls.clear()

    def __enter__(self):
        tlayers, tflash, tsh, tstep = self.mods
        tlayers.flash_attention, tlayers.moe_route = self._flash, self._route
        tlayers.top_k, tstep.M.lm_logits = self._top_k, self._logits
        tflash.flash_merge = self._merge
        hooks = self

        def psum(mesh, xs):
            b0 = tsh.COLLECTIVES["tp_psum"]["bytes"]
            out = hooks.real["psum"](mesh, xs)
            who = sys._getframe(1).f_code.co_name
            hooks.psum[who] += tsh.COLLECTIVES["tp_psum"]["bytes"] - b0
            hooks.psum_calls[who] += 1
            return out
        tsh.ModelMesh.tp_psum = psum
        return self

    def __exit__(self, *exc):
        tlayers, tflash, tsh, tstep = self.mods
        tlayers.flash_attention = self.real["flash"]
        tlayers.moe_route, tlayers.top_k = self.real["route"], \
            self.real["top_k"]
        tstep.M.lm_logits = self.real["logits"]
        tflash.flash_merge = self.real["merge"]
        tsh.ModelMesh.tp_psum = self.real["psum"]

    def _flash(self, q, k, v, *, q_offset, kv_valid=None, **kw):
        step, rest = divmod(self.calls, self.n_attn * self.n)
        key = (self.name, step) + divmod(rest, self.n)
        self.calls += 1
        if key in self.wanted:
            self.captured[key] = (q.clone(), k.clone(), v.clone(),
                                  int(q_offset),
                                  None if kv_valid is None else int(kv_valid))
        return self.real["flash"](q, k, v, q_offset=q_offset,
                                  kv_valid=kv_valid, **kw)

    def _merge(self, m, l, acc):
        key = ("merge",) + divmod((self.calls - 1) // self.n, self.n_attn)
        if key in self.wanted and key not in self.captured:
            self.captured[key] = (m.clone(), l.clone(), acc.clone())
        return self.real["merge"](m, l, acc)

    def _route(self, logits, cfg, cf):
        out = self.real["route"](logits, cfg, cf)
        if self.route_calls % self.n == 0:
            _, e, pos, C = out
            self.routes.append((e.clone(), pos < C))
        self.route_calls += 1
        return out

    def _top_k(self, logits, k):
        if self.force is None:
            return self.real["top_k"](logits, k)
        idx = self.force.pop(0).reshape(logits.shape[0], k)
        return logits.gather(-1, idx), idx

    def _logits(self, params, cfg, x, tp_shard, **kw):
        out = self.real["logits"](params, cfg, x, tp_shard, **kw)
        self.kept.append(out)
        return out

    def by_block(self, per: int = 1) -> str:
        return ", ".join(
            f"{N_PSUM_BY.get(k, k)} {v // per} ({self.psum_calls[k] // per} "
            f"calls)" for k, v in self.psum.items())


def _n_routes(a: list, b: list, B: int) -> tuple:
    """Two forms' recorded routes (a list of (experts, kept) a MoE layer,
    token-major over B rows): the assignments that differ in expert or
    capacity in each layer, and a (B,) mask of the rows whose every
    assignment agrees in every layer."""
    import torch
    diff, agree = [], torch.ones(B, dtype=torch.bool, device=a[0][0].device)
    for (ea, ka), (eb, kb) in zip(a, b, strict=True):
        d = (ea != eb) | (ka != kb)
        diff.append(int(d.sum()))
        agree &= ~d.reshape(B, -1).any(1)
    return diff, agree


def _n_cell(args, dev, rows, h, arch: str, n_layers: int) -> tuple:
    """One cell of path N on (1, 1, 16): ``arch`` in its published layout
    cut to ``n_layers`` layers at full width, at path D's traffic, gated
    against its one-card form on the same global weights.  Returns (cfg,
    mesh, the positions' weights, the global tree, the one-card tree)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch, single_card
    from repro_torch.kernels import flash as tflash
    from repro_torch.models import layers as tlayers
    from repro_torch.models import model as TM
    from repro_torch.models import sharding as tsh
    from repro_torch.models import ssm as tssm
    from repro_torch.serve import step as tstep

    base = get_arch(arch)
    cfg = dataclasses.replace(base, n_layers=n_layers,
                              pattern=base.pattern[:n_layers])
    one = single_card(cfg)
    mesh = tsh.ModelMesh(N_MESH, devices=dev)
    D, tp, T, P, B = mesh.size, cfg.tp, N_STEPS, LM_PROMPT_LEN, LM_REQUESTS
    V, E = cfg.vocab_size, one.n_experts_padded
    n_attn = cfg.pattern.count("attn")
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed)
    glob = TM.init_params(cfg, g, dev, mesh=mesh)

    def one_blk(b):
        core, ffn = b["core"], b["ffn"]
        if isinstance(core, tssm.MambaParams):
            core = core._replace(in_proj=tssm.one_card_in_proj(core.in_proj,
                                                               tp))
        if isinstance(ffn, tlayers.MoEParams):
            ffn = ffn._replace(w_gate=ffn.w_gate[:, :E], w_up=ffn.w_up[:, :E],
                               w_down=ffn.w_down[:, :E])
        return {"core": core, "ffn": ffn}
    tree1 = dict(glob, sb={k: one_blk(v) for k, v in glob["sb"].items()})
    params, t_shard = _sync_time(lambda: tstep.shard_tree(
        glob, tstep.serve_param_specs(cfg), mesh))
    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(rng.integers(0, V, (B, P))).to(
        device=dev, dtype=torch.int32)
    pos = torch.arange(P, dtype=torch.int32, device=dev)[None].expand(B, P)
    pre = tstep.make_prefill(cfg, mesh, replicate_weights=True)
    dec = tstep.make_decode_step(cfg, mesh, replicate_weights=True)
    _, c_spec, t_spec, p_spec = pre.in_specs
    hooks = _NHooks(n_attn)
    caches = [TM.init_cache(cfg, B, P + T, device=dev) for _ in range(D)]
    torch.cuda.reset_peak_memory_stats()
    h.reset_counters()
    tsh.reset_collectives()
    hooks.stage("tp", D, {("tp", 0, 0, 0), ("tp", T, 0, 0)})
    with hooks:
        (logits, caches), t_pre = _sync_time(lambda: pre(
            params, caches, tstep.shard_tree(prompts, t_spec, mesh),
            tstep.shard_tree(pos, p_spec, mesh)))
        l_pre, tp_routes, psum_pre = h.counters(), list(hooks.routes), \
            hooks.by_block()
        lk = tstep.gather_tree(logits, pre.out_specs[0], mesh)
        tok = lk[:, :V].argmax(-1).to(torch.int32)
        h.reset_counters()
        tsh.reset_collectives()
        hooks.psum.clear()
        hooks.psum_calls.clear()
        nxt, ids = tok, []
        z = tstep.shard_tree(torch.zeros((B, 1), dtype=torch.int32,
                                         device=dev), p_spec, mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(T):
            out, caches = dec(params, caches, tstep.shard_tree(
                nxt[:, None], t_spec, mesh), z, P + i)
            nxt = out[0]
            ids.append(nxt)
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        l_dec, psum_dec = h.counters(), hooks.by_block(T)
        coll = {k: dict(v) for k, v in tsh.COLLECTIVES.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    none = {k: 0 for k in ("flash", "flash_decode", "flash_combine",
                           "flash_cc", "flash_bias", "flash_partial",
                           "flash_merge")}
    for what, got, want in (
            ("prefill", l_pre, dict(none, flash=n_attn * D)),
            ("decode", l_dec, dict(none, flash_decode=n_attn * D * T,
                                   flash_combine=n_attn * D * T))):
        if {k: got[k] for k in want} != want:
            raise AssertionError(f"path N {arch} {what} launches {got}, "
                                 f"want {want}")
    if not bool(torch.isfinite(lk).all()) or lk.shape != (B, cfg.vocab_padded):
        raise AssertionError(f"path N {arch} prefill logits not finite or "
                             f"misshapen")
    kinds = {k: cfg.pattern.count(k) for k in sorted(set(cfg.pattern))}
    mc = cfg.moe
    print(f"phase 19: path N ({arch} in its published layout: tp {tp}, "
          f"tp_shard; {n_layers} layers {kinds}, "
          f"{sum(cfg.moe_at(i) for i in range(n_layers))} MoE of "
          f"{mc.n_experts} experts padded to {cfg.n_experts_padded} "
          f"({cfg.n_experts_padded // tp} a position), top {mc.top_k}, "
          f"{mc.n_shared} shared; {cfg.n_heads_padded} query / "
          f"{cfg.n_kv_heads} KV heads; d_model {cfg.d_model}, "
          f"{cfg.param_count()} parameters) on mesh {N_MESH}, every "
          f"position {dev}: {B} requests x {P} prompt + {T} new tokens; "
          f"shard_tree {t_shard:.6f} s")
    print(f"  prefill {t_pre:.6f} s; decode {t_dec:.6f} s for {T} steps "
          f"({B * T / t_dec:.3f} tokens/s); launches: prefill "
          f"{ {k: v for k, v in l_pre.items() if v} }, decode a step "
          f"{ {k: v // T for k, v in l_dec.items() if v} }; peak memory "
          f"allocated {peak:.3f} GiB")
    print(f"  collectives, bytes as if each position were a card: prefill "
          f"tp_psum by block {psum_pre}; decode a step " + ", ".join(
              f"{k} {v['bytes'] // T} ({v['calls'] // T} calls)"
              for k, v in coll.items() if v["calls"])
          + f"; tp_psum by block a step {psum_dec}")

    # the one-card form on the same global weights (uncounted: the gate),
    # on its own routes and on the TP form's
    one_pre = tstep.make_prefill(one)
    with hooks:
        hooks.stage("one", 1)
        (lo, oc), t_one = _sync_time(lambda: h.uncounted(lambda: one_pre(
            tree1, TM.init_cache(one, B, P + T, device=dev), prompts, pos)))
        one_routes = hooks.routes
        hooks.stage("forced", 1, force=[e for e, _ in tp_routes])
        lf, _ = h.uncounted(lambda: one_pre(
            tree1, TM.init_cache(one, B, P + T, device=dev), prompts, pos))
        left = len(hooks.force)
    if left:
        raise AssertionError(f"path N {arch}: {left} forced routes unused")
    diff, agree = _n_routes(tp_routes, one_routes, B)
    d_forced = float((lk - lf).abs().max())
    d_free = float((lk - lo)[agree].abs().max()) if bool(agree.any()) \
        else None
    gate = LM_LOGIT_TOL
    if d_forced > gate or (d_free or 0.0) > gate:
        def plain_attention(q, k, v, *, q_offset, kv_valid=None, **kw):
            return tflash.flash_attention_plain(q, k, v, q_offset=q_offset,
                                                kv_valid=kv_valid)
        tlayers.flash_attention = plain_attention
        try:
            lp, _ = one_pre(tree1, TM.init_cache(one, B, P + T, device=dev),
                            prompts, pos)
        finally:
            tlayers.flash_attention = hooks.real["flash"]
        ctrl = float((lo - lp).abs().max())
        gate = max(LM_LOGIT_TOL, J_CONTROL_FACTOR * ctrl)
        print(f"  control (the one-card form, kernel vs plain attention): "
              f"{ctrl:.6e}; gate {gate:.6e}")
    n_ass = B * P * mc.top_k
    print(f"  MoE routes, TP-16 vs the one-card form: assignments that "
          f"differ in expert or capacity a MoE layer {diff} of {n_ass}; "
          f"requests whose routes agree in every layer "
          f"{int(agree.sum())} of {B} ({B - int(agree.sum())} left out of "
          f"the gate on its own routes)")
    top2 = torch.topk(lf[:, :V], 2).values
    margin = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    sure = margin > 2 * gate
    first_f = lf[:, :V].argmax(-1).to(torch.int32)
    if d_forced > gate or (d_free is not None and d_free > gate) or \
            not (first_f == tok).cpu().numpy()[sure].all():
        raise AssertionError(f"path N {arch} TP-16 prefill vs the one-card "
                             f"form: max |diff| {d_forced} on the TP routes, "
                             f"{d_free} on its own over the agreeing rows "
                             f"(gate {gate}); first tokens {tok.tolist()} / "
                             f"{first_f.tolist()}")
    # the one-card form's own greedy decode beside the TP form's
    one_dec = tstep.make_decode_step(one)
    o_ids, o_tok = [], lo[:, :V].argmax(-1).to(torch.int32)
    oc = TM.init_cache(one, B, P + T, device=dev)
    h.uncounted(lambda: one_pre(tree1, oc, prompts, pos))
    for i in range(T):
        o_tok, oc = h.uncounted(lambda: one_dec(tree1, oc, o_tok[:, None],
                                                None, P + i))
        o_ids.append(o_tok)
    agree_ids = (torch.stack(o_ids, 1) == torch.stack(ids, 1)).cpu().numpy()
    print(f"  TP-16 prefill logits vs the one-card form on the same global "
          f"weights: max |diff| {d_forced:.6e} fed the TP form's routes, "
          + (f"{d_free:.6e}" if d_free is not None else "no request")
          + f" on its own routes over the agreeing requests (gate {gate}; "
          f"logits max {float(lo.abs().max()):.6f}); top-2 margins "
          f"{np.round(margin, 6).tolist()}; greedy decode tokens equal "
          f"{int(agree_ids.sum())} of {agree_ids.size} (each form on its "
          f"own tokens); one-card prefill {t_one:.6f} s")
    # where the TP prefill's time goes: the same prefill again, uncounted,
    # with the Mamba scan loops, each position's MoE work and the attention
    # block each bracketed by synchronize
    c2 = [TM.init_cache(cfg, B, P + T, device=dev) for _ in range(D)]
    with _Stages(tssm, ("_ssm_scan",)) as st1, \
            _Stages(tlayers, ("_moe_partial", "_attention_mesh")) as st2:
        _, t_st = _sync_time(lambda: h.uncounted(lambda: pre(
            params, c2, tstep.shard_tree(prompts, t_spec, mesh),
            tstep.shard_tree(pos, p_spec, mesh))))
    secs = {"Mamba scan loops": st1.secs.get("_ssm_scan", 0.0),
            "MoE a position": st2.secs.get("_moe_partial", 0.0),
            "attention (its psum included)": st2.secs.get("_attention_mesh",
                                                         0.0)}
    secs["the rest"] = t_st - sum(secs.values())
    print(f"  where the TP-16 prefill's {t_st:.6f} s go (a second prefill, "
          f"each stage bracketed by synchronize): " + ", ".join(
              f"{k} {v:.6f} s ({100 * v / t_st:.1f}%)"
              for k, v in secs.items() if v))
    del c2
    for key in (("tp", 0, 0, 0), ("tp", T, 0, 0)):
        q, k, v, qo, kvv = hooks.captured.pop(key)
        name = "flash" if key[1] == 0 else "flash_decode"
        r = _k8_check(h, f"path N {arch} {name}", q, k, v, qo, kvv)
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                        r["max_abs_err"])
        print(f"  K8 {name} (q {tuple(q.shape)}, k/v {tuple(k.shape)}, group "
              f"{q.shape[2] // k.shape[2]}): {r['plain']:.6f} ulps of the "
              f"magnitude from plain, {r['f64']:.6f} from f64")
    rows["flash"]["launches"] += l_pre["flash"]
    rows["flash_decode"]["launches"] += l_dec["flash_decode"]
    del caches, oc, logits, lo, lf, ids, o_ids, hooks
    return cfg, mesh, params, glob, tree1


def _n_long(args, dev, rows, h, cfg, mesh, params) -> None:
    """jamba's long_500k cell on path N: a prompt of ``N_LONG_PROMPT``
    tokens prefilled on (1, 1, 16) into ``N_LONG_MAX``-position caches,
    the attention positions up to ``N_LONG_MAX - N_STEPS`` drawn, then
    ``N_STEPS`` steps decoded unsharded and sequence-sharded on (1, 4,
    16), teacher-forced; K8's decode tile, ``return_partial`` and merge at
    these lengths against plain and f64, and timed."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash as tflash
    from repro_torch.models import layers as tlayers
    from repro_torch.models import model as TM
    from repro_torch.models import sharding as tsh
    from repro_torch.serve import step as tstep

    seq = tsh.ModelMesh(N_SEQ_MESH, devices=dev)
    D, D2, V = mesh.size, seq.size, cfg.vocab_size
    SM, PS, N = N_LONG_MAX, N_LONG_PROMPT, N_STEPS
    start, S_l = SM - N, SM // seq.axis_size("data")
    a_pos = f"pos{cfg.pattern.index('attn')}"
    pre = tstep.make_prefill(cfg, mesh, replicate_weights=True)
    dec = tstep.make_decode_step(cfg, mesh, replicate_weights=True)
    sdec = tstep.make_decode_step(cfg, seq, batch_sharded=False,
                                  seq_shard=True, replicate_weights=True)
    _, c_spec, t_spec, p_spec = pre.in_specs
    hooks = _NHooks(1)
    rng = np.random.default_rng(args.seed + 1)
    prompt = torch.from_numpy(rng.integers(0, V, (1, PS))).to(
        device=dev, dtype=torch.int32)
    pos = torch.arange(PS, dtype=torch.int32, device=dev)[None]
    caches = [TM.init_cache(cfg, 1, SM, device=dev) for _ in range(D)]
    torch.cuda.reset_peak_memory_stats()
    h.reset_counters()
    hooks.stage("long", D)
    with hooks:
        (logits, caches), t_pre = _sync_time(lambda: pre(
            params, caches, tstep.shard_tree(prompt, t_spec, mesh),
            tstep.shard_tree(pos, p_spec, mesh)))
    l_pre = h.counters()
    if l_pre["flash"] != D or l_pre["flash_cc"] or l_pre["flash_decode"]:
        raise AssertionError(f"path N long prefill launches {l_pre}")
    tok0 = tstep.gather_tree(logits, pre.out_specs[0], mesh)[:, :V] \
        .argmax(-1).to(torch.int32)

    # the positions [PS, start) of every KV slot drawn at the slot's
    # channel mean and deviation over the prompt's keys and values
    gd = torch.Generator(device=dev)
    gd.manual_seed(args.seed)

    def draw():
        for cr in caches:
            for name in ("k", "v"):
                t = cr[a_pos][name]                   # (1, 1, SM, 1, dh)
                real = t[:, :, :PS].float()
                mu, sd = real.mean(2, keepdim=True), real.std(2, keepdim=True)
                w = torch.randn((1, 1, start - PS) + t.shape[3:],
                                generator=gd, device=dev)
                t[:, :, PS:start] = (w.mul_(sd).add_(mu)).to(t.dtype)
    _, t_draw = _sync_time(draw)

    def lay(per):
        whole = tstep.gather_tree(per, c_spec, mesh)
        return tstep.shard_tree(whole, sdec.in_specs[1], seq, share=False)
    s_caches, t_lay = _sync_time(lambda: lay(caches))
    s_params = [params[seq.axis_index("model", r)] for r in range(D2)]

    def decode(fn, m_, params_, caches_, forced=None):
        t_sp, p_sp = fn.in_specs[2], fn.in_specs[3]
        z = tstep.shard_tree(torch.zeros((1, 1), dtype=torch.int32,
                                         device=dev), p_sp, m_)
        nxt, ids = tok0, []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(N):
            if forced is not None:
                nxt = forced[i]
            out, caches_ = fn(params_, caches_, tstep.shard_tree(
                nxt[:, None], t_sp, m_), z, start + i)
            nxt = out[0]
            ids.append(nxt)
        torch.cuda.synchronize()
        return ids, caches_, time.perf_counter() - t0

    def gathered(per, m_):
        return tstep.gather_tree(m_.all_gather(per, "model", dim=2),
                                 (None, None, None), m_)[:, 0]

    h.reset_counters()
    tsh.reset_collectives()
    hooks.stage("long", D, {("long", N - 1, 0, 0)})
    with hooks:
        u_ids, caches, t_udec = decode(dec, mesh, params, caches)
        l_udec, u_routes, u_psum = h.counters(), hooks.routes, \
            hooks.by_block(N)
        u_coll = {k: dict(v) for k, v in tsh.COLLECTIVES.items()}
        u_logits = [gathered(x_, mesh) for x_ in hooks.kept]
        h.reset_counters()
        tsh.reset_collectives()
        hooks.stage("seq", D2, {("seq", N - 1, 0, seq.position(data=c_))
                                for c_ in range(4)} | {("merge", N - 1, 0)})
        s_ids, s_caches, t_sdec = decode(sdec, seq, s_params, s_caches,
                                         forced=[tok0] + u_ids)
        l_sdec, s_routes, s_psum = h.counters(), hooks.routes, \
            hooks.by_block(N)
        s_coll = {k: dict(v) for k, v in tsh.COLLECTIVES.items()}
        s_logits = [gathered(x_, seq) for x_ in hooks.kept]
    peak = torch.cuda.max_memory_allocated() / 2**30
    none = {k: 0 for k in ("flash", "flash_decode", "flash_combine",
                           "flash_cc", "flash_bias", "flash_partial",
                           "flash_merge")}
    for what, got, want in (
            ("unsharded decode", l_udec, dict(none, flash_decode=D * N,
                                               flash_combine=D * N)),
            ("sequence-sharded decode", l_sdec,
             dict(none, flash_partial=D2 * N, flash_merge=D2 * N))):
        if {k: got[k] for k in want} != want:
            raise AssertionError(f"path N long {what} launches {got}, want "
                                 f"{want}")
    print(f"  long_500k: a {PS}-token prompt into {SM}-position caches on "
          f"{N_MESH} (prefill {t_pre:.6f} s); attention positions {PS} .. "
          f"{start - 1} drawn at each KV slot's channel mean and deviation "
          f"of the prompt's ({t_draw:.6f} s); caches laid onto {N_SEQ_MESH}'s"
          f" chunks of {S_l} (gather_tree, shard_tree) {t_lay:.6f} s; "
          f"decode from cache_len {start}")
    print(f"  unsharded decode on {N_MESH}: {N} steps {t_udec:.6f} s "
          f"({N / t_udec:.3f} tokens/s), launches a step "
          f"{ {k: v // N for k, v in l_udec.items() if v} }; collectives a "
          f"step " + ", ".join(f"{k} {v['bytes'] // N} ({v['calls'] // N} "
                              f"calls)" for k, v in u_coll.items()
                              if v["calls"])
          + f"; tp_psum by block {u_psum}")
    print(f"  sequence-sharded decode on {N_SEQ_MESH}: {N} steps "
          f"{t_sdec:.6f} s ({N / t_sdec:.3f} tokens/s), launches a step "
          f"{ {k: v // N for k, v in l_sdec.items() if v} }; collectives a "
          f"step " + ", ".join(f"{k} {v['bytes'] // N} ({v['calls'] // N} "
                              f"calls)" for k, v in s_coll.items()
                              if v["calls"])
          + f"; tp_psum by block {s_psum}; peak memory allocated "
          f"{peak:.3f} GiB")
    # the steps before the first whose routes differ are gated
    n_moe = len(u_routes) // N
    step_agree = [all(bool((u_routes[i * n_moe + j][0]
                            == s_routes[i * n_moe + j][0]).all())
                      for j in range(n_moe)) for i in range(N)]
    lead = step_agree.index(False) if False in step_agree else N
    diffs = [float((a - b).abs().max())
             for a, b in zip(s_logits, u_logits, strict=True)]
    gate = LM_LOGIT_TOL
    if lead == 0 or max(diffs[:lead]) > gate or \
            not bool((s_ids[0] == u_ids[0]).all()) or \
            not all(bool(torch.isfinite(x_).all()) for x_ in s_logits):
        raise AssertionError(f"path N sequence-sharded decode vs unsharded: "
                             f"max |diff| a step {diffs} (gate {gate}, the "
                             f"first {lead} steps' routes agree); first "
                             f"tokens {s_ids[0].tolist()} / "
                             f"{u_ids[0].tolist()}")
    s_agree = sum(int(bool((a == b).all()))
                  for a, b in zip(s_ids, u_ids, strict=True))
    print(f"  sequence-sharded vs unsharded decode logits: max |diff| "
          f"{max(diffs[:lead]):.6e} over the {lead} of {N} steps whose MoE "
          f"routes agree (gate {gate}; each step "
          f"{np.round(diffs, 6).tolist()}); first token equal; greedy tokens "
          f"equal {s_agree} of {N}")

    # K8 at these lengths against plain and f64, and timed
    cap = hooks.captured
    q, k, v, qo, kvv = cap.pop(("long", N - 1, 0, 0))
    r = _k8_check(h, "path N decode over 524,288 keys", q, k, v, qo, kvv)
    rows["flash_decode"]["max_abs_err"] = max(
        rows["flash_decode"]["max_abs_err"], r["max_abs_err"])
    sh = _l_time(h, q, k, v, qo, kvv, False)
    sh["n_split"], sh["tiles_per_split"] = tflash.decode_plan(
        q, k, q_offset=qo, kv_valid=kvv)
    rows["flash_decode"]["path_n_shape"] = sh
    print(f"  K8 flash_decode over {kvv} keys (q {tuple(q.shape)}, k/v "
          f"{tuple(k.shape)}, {sh['n_split']} runs of {sh['tiles_per_split']}"
          f" tiles): {r['plain']:.6f} ulps of the magnitude from plain, "
          f"{r['f64']:.6f} from f64; kernel {sh['ms']:.6f} ms, plain "
          f"{sh['plain_ms']:.6f}, SDPA {sh['sdpa_ms']:.6f}, bound "
          f"{sh['bound_ms']:.6f} ({sh['bound_by']})")
    del q, k, v
    parts = [cap.pop(("seq", N - 1, 0, seq.position(data=c_)))
             for c_ in range(4)]
    checks = [_partial_check(h, f"path N chunk {c_} (q_offset {p_[3]})",
                             *p_[:4]) for c_, p_ in enumerate(parts)]
    L_last = start + N - 1
    q = parts[0][0]
    kg = torch.cat([p_[1] for p_ in parts], 1)[:, :L_last + 1]
    vg = torch.cat([p_[2] for p_ in parts], 1)[:, :L_last + 1]
    mr = _merge_check(h, "path N, 4 positions", cap.pop(("merge", N - 1, 0)),
                      q, kg, vg, L_last)
    del kg, vg
    print(f"  K8 at the last step's chunks (q_offset "
          f"{[p_[3] for p_ in parts]}): return_partial vs its plain version "
          f"and f64 (tolerance {M_PART_RTOL} of each scale), ratios to it "
          + ", ".join(f"chunk {c_} {c['plain']:.4f} / {c['kernel']:.4f}"
                      for c_, c in enumerate(checks))
          + f"; the combine of the 4 positions vs its plain version "
          f"{mr['plain']:.6f} and vs f64 over the {L_last + 1} keys "
          f"{mr['f64']:.6f} bf16 ulps of the magnitude (tolerance 1)")
    q, k, v, off = parts[0][:4]
    n_split, per = tflash.decode_plan(q, k, q_offset=off, kv_valid=k.shape[1])
    pw = tflash.tile_work(q, k, off, k.shape[1], "flash_partial",
                          partial=True)
    row = _time_row(
        "flash_partial", lambda: h.uncounted(lambda: tflash.flash_attention(
            q, k, v, q_offset=off, return_partial=True)),
        lambda: tflash.flash_decode_split_plain(
            q, k, v, q_offset=off, n_split=n_split, return_partial=True),
        _sdpa_call(q, k, v, off, k.shape[1]),
        [(pw.bytes, pw.ops)],
        l_sdec["flash_partial"], max(c["max_abs_err"] for c in checks),
        reps=100, plain_reps=5)
    rows["flash_partial"]["path_n"] = dict(
        {k_: row[k_] for k_ in ("ms", "plain_ms", "library_ms", "bound_ms",
                                "bound_by")},
        n_split=n_split, tiles_per_split=per,
        shape=f"q {tuple(q.shape)}, k/v {tuple(k.shape)}, q_offset {off}")
    for name, n_, err in (("flash", l_pre["flash"], None),
                          ("flash_decode", l_udec["flash_decode"], None),
                          ("flash_partial", l_sdec["flash_partial"],
                           max(c["max_abs_err"] for c in checks)),
                          ("flash_merge", l_sdec["flash_merge"],
                           mr["max_abs_err"])):
        rows[name]["launches"] += n_
        if err is not None:
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
    del caches, s_caches, s_params, parts, q, k, v, hooks, cap


def _path_n(args, dev, rows, h) -> None:
    """Phase 19, path N: MoE and Mamba under tensor parallelism on
    ``ModelMesh`` positions that are all this card, counted (module
    docstring)."""
    import torch
    t_path = time.perf_counter()
    _, _, params, glob, tree1 = _n_cell(args, dev, rows, h, N_MOE_ARCH,
                                        N_MOE_LAYERS)
    del params, glob, tree1
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  path N wall so far {time.perf_counter() - t_path:.1f} s")
    cfg, mesh, params, glob, tree1 = _n_cell(args, dev, rows, h, N_JAMBA_ARCH,
                                             J_JAMBA_LAYERS)
    del glob, tree1
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  the global weights freed: "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated (the "
          f"positions' shards); path N wall so far "
          f"{time.perf_counter() - t_path:.1f} s")
    _n_long(args, dev, rows, h, cfg, mesh, params)
    del params
    print(f"  path N wall {time.perf_counter() - t_path:.1f} s")


def _o_batch(dev, seed: int, vocab: int):
    """Path O's batch: ``I_BATCH`` x ``I_SEQ`` token ids and their next
    tokens, drawn from ``seed`` with numpy, and the positions."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, vocab, (I_BATCH, I_SEQ + 1))) \
        .to(device=dev, dtype=torch.int32)
    pos = torch.arange(I_SEQ, dtype=torch.int32, device=dev)[None] \
        .expand(I_BATCH, I_SEQ).contiguous()
    return toks[:, :-1].contiguous(), toks[:, 1:].contiguous(), pos


def _o_one_grads(one, glob, batch):
    """The one-card form's loss, gradient norm and gradients (on the host,
    in ``optimizer.leaves`` order) on the global weights: the port's
    one-card step up to its update."""
    import torch
    from repro_torch.models import model as TM
    from repro_torch.train import optimizer as topt
    inputs, labels, pos = batch
    ps = TM.tree_map(lambda t: t.detach().requires_grad_(), glob)
    x, _ = TM.forward(ps, one, inputs, pos=pos, mode="train")
    loss = TM.lm_loss(ps, one, x, labels, False)
    grads = torch.autograd.grad(loss, topt.leaves(ps))
    gnorm = topt.global_grad_norm(list(grads))
    # sync: ok(the gate's reference, read once)
    return float(loss.detach()), float(gnorm), [g.cpu() for g in grads]


def _o_gather(per: list, spec, mesh, dev):
    """One leaf put together from the positions' shards (``gather_tree``)."""
    from repro_torch.serve import step as sstep
    return sstep.gather_tree([{"x": t} for t in per], {"x": spec}, mesh,
                             device=dev)["x"]


def _o_rel_l2(got, want) -> float:
    """||got - want|| / ||want||, in f64."""
    d = float((got.double() - want.double()).norm())
    return d / max(float(want.double().norm()), 1e-30)


def _o_grad_gate(by_pos, specs, mesh, want: list, dev):
    """Each leaf's gathered gradient against the one-card gradient (host
    tensors in leaf order): the relative L2 a leaf, in leaf order."""
    out = []
    for i, spec in enumerate(specs):
        g = _o_gather([p[i] for p in by_pos], spec, mesh, dev)
        out.append(_o_rel_l2(g, want[i].to(dev)))
        del g
    return out


def _o_pod_sum_gate(grads, specs, mesh, want: list, dev) -> tuple:
    """Each leaf's gradients as the pods hold them (``grads``, a leaves
    list a position) summed over pod in f64, gathered, against twice the
    one-card gradient (host tensors in leaf order): (the relative L2 a
    leaf, in leaf order; the norm of the gathered gradient)."""
    out, sq = [], 0.0
    for i, spec in enumerate(specs):
        per = [None] * mesh.size
        for grp in mesh.groups("pod"):
            tot = sum(grads[r][i].double() for r in grp)
            for r in grp:
                per[r] = tot
        g = _o_gather(per, spec, mesh, dev)
        del per, tot
        out.append(_o_rel_l2(g, 2.0 * want[i].to(dev)))
        sq += float((g * g).sum())
        del g
    return out, sq ** 0.5


def _o_busy(prof, wall: float) -> float:
    """The idle share of a traced window of ``wall`` seconds: one less the
    union of its device events' intervals (kernels, copies, sets) over the
    wall."""
    import torch
    spans = sorted((e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA)
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return 1.0 - busy / 1e9 / wall


def _o_traced(fn):
    """``fn()`` under ``torch.profiler`` (device activity only): (its
    result, its synchronized wall seconds, the idle share)."""
    import torch
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out, wall = _sync_time(fn)
    return out, wall, _o_busy(prof, wall)


class _OSpy:
    """Path O's wrappers around the port while a step runs (``with``): the
    step's gradients after the pod sum as ``optimizer.update`` receives
    them (a leaves list a position; the one-card step is the mesh step on
    one position; ``skip``: the update not run, for a planted fault's
    gradients), the compressed sum's inputs and outputs
    (``train.grad_compress.compressed_pod_psum``), K8's first call's
    inputs (``layers.flash_attention``), position ``keep``'s MoE routes of
    the forward (``layers.moe_route``) and, where ``force`` holds a list
    of experts a MoE call, ``layers.top_k`` answering with them."""

    def __init__(self, *, skip=False, routes_of=(), n_pos=1, n_moe=0,
                 force=None):
        from repro_torch.models import layers as tlayers
        from repro_torch.train import grad_compress as tgc
        from repro_torch.train import optimizer as topt
        self.mods = (tlayers, tgc, topt)
        self.real = dict(update=topt.update, comp=tgc.compressed_pod_psum,
                         flash=tlayers.flash_attention,
                         route=tlayers.moe_route, top_k=tlayers.top_k)
        self.skip, self.routes_of, self.n_pos = skip, set(routes_of), n_pos
        self.n_moe, self.force = n_moe, force
        self.grads = self.comp = self.qkv = None
        self.routes, self.route_calls = {}, 0

    def __enter__(self):
        tlayers, tgc, topt = self.mods
        spy = self

        def update(params, grads, st, **kw):
            spy.grads = grads
            if spy.skip:
                return params, st
            return spy.real["update"](params, grads, st, **kw)

        def comp(grads, residual, mesh):
            out, new_r = spy.real["comp"](grads, residual, mesh)
            if spy.comp is None:
                spy.comp = (grads, residual, out, new_r)
            return out, new_r

        def flash(q, k, v, **kw):
            if spy.qkv is None:
                spy.qkv = tuple(t.detach().clone() for t in (q, k, v))
            return spy.real["flash"](q, k, v, **kw)

        def route(logits, cfg, cf):
            out = spy.real["route"](logits, cfg, cf)
            layer, r = divmod(spy.route_calls, spy.n_pos)
            if layer < spy.n_moe and r in spy.routes_of:
                spy.routes[(layer, r)] = out[1].clone()
            spy.route_calls += 1
            return out

        def top_k(logits, k):
            if spy.force is None:
                return spy.real["top_k"](logits, k)
            idx = spy.force.pop(0).reshape(logits.shape[0], k)
            return logits.gather(-1, idx), idx
        topt.update, tgc.compressed_pod_psum = update, comp
        tlayers.flash_attention, tlayers.moe_route = flash, route
        tlayers.top_k = top_k
        return self

    def __exit__(self, *exc):
        tlayers, tgc, topt = self.mods
        topt.update = self.real["update"]
        tgc.compressed_pod_psum = self.real["comp"]
        tlayers.flash_attention = self.real["flash"]
        tlayers.moe_route = self.real["route"]
        tlayers.top_k = self.real["top_k"]


def _o_compression(spy, mesh) -> tuple:
    """The compressed pod sum of one step held per element: ``|out -
    sum_p (g_p + r_p)| <= sum_p scale / 2`` plus ``O_COMP_SLACK`` f32 ulps
    of the largest |g_p + r_p| a pod (scale the pod max of max|g + r| /
    127), and each new residual equal to ``(g + r) - q scale`` with q the
    pod's int8 levels read back from the sum (the pods' inputs are equal:
    the gradients are summed over pod before).  Returns (the largest
    |diff| over its bound, the elements checked)."""
    import torch
    from repro_torch.train import optimizer as topt
    grads, residual, out, new_r = spy.comp
    res = [topt.leaves(t) for t in residual]
    nres = [topt.leaves(t) for t in new_r]
    worst, n = 0.0, 0
    for i in range(len(grads[0])):
        for grp in mesh.groups("pod"):
            xs = [grads[r][i].float() + res[r][i] for r in grp]
            big = max(float(x.abs().max()) for x in xs)
            scale = xs[0].new_zeros(())
            for x in xs:
                scale = torch.maximum(scale, torch.clamp_min(
                    x.abs().amax(), 1e-12) / 127.0)
            exact = sum(x.double() for x in xs)
            bound = len(xs) * float(scale) / 2 + O_COMP_SLACK * \
                len(xs) * big * 2.0 ** -23
            d = (out[grp[0]][i].double() - exact).abs()
            worst = max(worst, float(d.max()) / bound)
            lv = torch.round(out[grp[0]][i] / scale) / len(xs)
            for r, x in zip(grp, xs, strict=True):
                if not torch.equal(lv, lv.round()) or \
                        not torch.equal(nres[r][i], x - lv * scale):
                    raise AssertionError(f"path O compression: leaf {i}'s "
                                         f"residual at position {r} is not "
                                         f"(g + r) - q scale")
            n += d.numel()
    if worst > 1.0:
        raise AssertionError(f"path O compression: |compressed - "
                             f"uncompressed| {worst} times its bound")
    return worst, n


def _o_dense(args, dev, rows, h) -> None:
    """Path O1: ``O_ARCH`` in its published layout cut to ``O_LAYERS``
    layers at full width, trained on ``O_MESH`` positions of this card."""
    import statistics
    import numpy as np
    import torch
    from repro_torch.configs import get_arch, single_card
    from repro_torch.kernels import flash as tflash
    from repro_torch.models import model as TM
    from repro_torch.models import sharding as tsh
    from repro_torch.serve import step as sstep
    from repro_torch.train import optimizer as topt
    from repro_torch.train import step as tstep

    t_path = time.perf_counter()
    base = get_arch(O_ARCH)
    cfg = dataclasses.replace(base, n_layers=O_LAYERS,
                              pattern=base.pattern[:O_LAYERS])
    one = single_card(cfg)
    mesh = tsh.ModelMesh(O_MESH, devices=dev)
    if TM.tree_map(lambda l: l.shape, TM.build_tree(cfg, mesh)) != \
            TM.tree_map(lambda l: l.shape, TM.build_tree(one)):
        raise AssertionError("path O: the TP-16 tree is not the one-card tree")
    L, D, tokens = cfg.n_layers, mesh.size, I_BATCH * I_SEQ
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed)
    glob = TM.init_params(one, g, dev)
    batch = _o_batch(dev, args.seed, cfg.vocab_size)

    # ---- the one-card step's loss, norm and gradients (the gate), and a
    # control: the same with K8's plain version ----------------------------
    torch.cuda.reset_peak_memory_stats()
    (l1, n1, g1), t_one = _sync_time(lambda: h.uncounted(
        lambda: _o_one_grads(one, glob, batch)))
    peak_one = torch.cuda.max_memory_allocated() / 2**30
    real_lse = tflash.flash_attention_lse
    tflash.flash_attention_lse = functools.partial(
        tflash.flash_attention_plain, return_lse=True)
    try:
        lp, np_, gp = _o_one_grads(one, glob, batch)
    finally:
        tflash.flash_attention_lse = real_lse
    c_loss = abs(lp - l1) / abs(l1)
    c_norm = abs(np_ / n1 - 1)
    c_grad = max(_o_rel_l2(a, b) for a, b in zip(gp, g1, strict=True))
    del gp
    gate_loss = max(O_LOSS_RTOL, O_CONTROL_FACTOR * c_loss)
    gate_norm = max(O_GNORM_RTOL, O_CONTROL_FACTOR * c_norm)
    gate_grad = max(O_GRAD_RL2, O_CONTROL_FACTOR * c_grad)

    # ---- the mesh: FSDP storage, the AdamW state and residual --------------
    specs = TM.param_specs(cfg)
    sp = topt.leaves(specs)
    (params, opt, res), t_shard = _sync_time(lambda: _o_state(
        glob, specs, mesh, residual=True))
    del glob
    gc.collect()
    torch.cuda.empty_cache()
    fn_c = tstep.make_train_step(cfg, mesh, lr=O_LR, compress_pod=True)
    args_ = [sstep.shard_tree(t, s_, mesh)
             for t, s_ in zip(batch, fn_c.in_specs[3:], strict=True)]

    # ---- counted: O_STEPS compressed steps.  The first one's gradients as
    # each pod holds them before the pod sum (``_OSpy``'s record of the
    # compressed sum's inputs, the residual zero) summed over pod are the
    # uncompressed step's: the gates read them ------------------------------
    torch.cuda.reset_peak_memory_stats()
    h.reset_counters()
    losses, norms, secs, idle, coll_c, comp = [], [], [], None, None, None
    for i in range(O_STEPS):
        tsh.reset_collectives()
        if i == 0:
            with _OSpy() as spy:
                (params, opt, res, m), t = _sync_time(
                    lambda: fn_c(params, opt, res, *args_))
            coll_c = {k: dict(v) for k, v in tsh.COLLECTIVES.items()
                      if v["calls"]}
            qkv = spy.qkv
            rl2, gn_u = _o_pod_sum_gate(spy.comp[0], sp, mesh, g1, dev)
            loss_u = float(m["loss"])
            comp = _o_compression(spy, mesh)
            del spy
        elif i == O_STEPS - 1:
            (params, opt, res, m), t, idle = _o_traced(
                lambda: fn_c(params, opt, res, *args_))
        else:
            (params, opt, res, m), t = _sync_time(
                lambda: fn_c(params, opt, res, *args_))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        secs.append(t)
    launches = h.counters()
    lse, remat = dict(tflash.LSE_LAUNCHES), dict(tflash.REMAT_LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {"flash": 2 * L * D * O_STEPS, "flash_decode": 0,
            "flash_combine": 0, "flash_cc": 0, "flash_bias": 0,
            "flash_partial": 0, "flash_merge": 0}
    if {k: launches[k] for k in want} != want or \
            lse["flash"] != want["flash"] or \
            remat["flash"] != L * D * O_STEPS:
        raise AssertionError(f"path O1 launches {launches}, with lse {lse}, "
                             f"in remat's recompute {remat}; want {want}, "
                             f"every one with lse, half in the recompute")
    d_loss = abs(loss_u - l1) / abs(l1)
    d_norm = abs(gn_u / (2 * n1) - 1)
    if d_loss > gate_loss or d_norm > gate_norm or max(rl2) > gate_grad or \
            not all(np.isfinite(losses + norms)):
        raise AssertionError(f"path O1 against the one-card step: loss "
                             f"{loss_u} / {l1} ({d_loss}, gate {gate_loss}), "
                             f"grad norm {gn_u} / 2 x {n1} ({d_norm}, gate "
                             f"{gate_norm}), gradients' relative L2 up to "
                             f"{max(rl2)} (gate {gate_grad}); losses "
                             f"{losses}")
    warm = statistics.median(secs[1:])
    print(f"phase 20: path O1 ({O_ARCH} in its published layout: tp "
          f"{cfg.tp}, tp_shard, {cfg.n_heads_padded} query / "
          f"{cfg.n_kv_heads} KV heads, KV replicated over model; {L} of "
          f"{base.n_layers} layers at full width, {cfg.param_count()} "
          f"parameters) trained on mesh {O_MESH}, every position {dev}: "
          f"FSDP storage over data, {I_BATCH} x {I_SEQ} tokens a step ("
          f"{I_BATCH // (mesh.axis_size('pod') * mesh.axis_size('data'))} "
          f"sequences a (pod, data) position), lr {O_LR}, remat on; "
          f"shard_tree and the state {t_shard:.6f} s")
    print(f"  {O_STEPS} steps with compress_pod: seconds "
          f"{[round(x, 6) for x in secs]}, warm {warm:.6f} s, "
          f"{tokens / warm:.1f} tokens/s; traced last step's idle share "
          f"{idle:.6f}; losses {[round(x, 6) for x in losses]}, grad "
          f"norms {[round(x, 6) for x in norms]}; peak memory allocated "
          f"{peak:.3f} GiB (the one-card gate's {peak_one:.3f})")
    print(f"  launches over the {O_STEPS} steps {dict(want)}: with lse "
          f"{lse['flash']}, in remat's recompute {remat['flash']} (K8 a "
          f"layer a position in the forward and again in the backward)")
    print(f"  collectives of a step, bytes as if each position were a "
          f"card: " + ", ".join(f"{k} {v['bytes']} ({v['calls']} calls)"
                                for k, v in coll_c.items()))
    q8 = coll_c.get("pod_psum_int8", {"bytes": 0})["bytes"]
    print(f"  the pod sum: int8 payload {q8} bytes against {4 * q8} in f32 "
          f"and {2 * q8} in the gradients' bf16 (the sum without "
          f"compress_pod)")
    print(f"  gates against the one-card step on the same global weights "
          f"and batch ({t_one:.3f} s), on step 1's gradients summed over "
          f"pod: loss {loss_u:.9f} / {l1:.9f}, relative {d_loss:.3e} (gate "
          f"{gate_loss:.3e}; control, K8's plain version: {c_loss:.3e}); "
          f"grad norm {gn_u:.6f} = 2 x {n1:.6f} within {d_norm:.3e} (gate "
          f"{gate_norm:.3e}; control {c_norm:.3e}); every gathered gradient "
          f"within relative L2 {max(rl2):.3e} of 2 x the one-card gradient "
          f"(gate {gate_grad:.3e}; control {c_grad:.3e}; median "
          f"{statistics.median(rl2):.3e}): the reference's pod double count")
    print(f"  compression: |compressed - uncompressed| at most "
          f"{comp[0]:.6f} of its bound (sum over pods of scale / 2 plus "
          f"{O_COMP_SLACK} f32 ulps) over {comp[1]} elements; every "
          f"residual equal to (g + r) - q scale")
    del params, opt, res, args_, batch, g1
    gc.collect()
    torch.cuda.empty_cache()

    # ---- K8 with lse at the path's shape, on its own q, k, v ---------------
    q, k, v = qkv
    g8 = torch.Generator(device=dev)
    g8.manual_seed(args.seed + 20)
    err = _lse_grad_check(h, g8, "path O1 layer 0 (group 2)", q, k, v,
                          L_LSE_ATOL, I_GRAD_ULPS)
    r8 = _k8_check(h, "path O1 (group 2)", q, k, v, 0, I_SEQ)
    sh = _l_time(h, q, k, v, 0, I_SEQ, True)
    row = rows["flash"]
    row["launches"] += launches["flash"]
    row["max_abs_err"] = max(row["max_abs_err"], err, r8["max_abs_err"])
    row.update(path_o_launches=launches["flash"],
               path_o_remat_launches=remat["flash"], path_o_shape=sh)
    print(f"  K8 with lse at group 2 (q {tuple(q.shape)}, k/v "
          f"{tuple(k.shape)}): {r8['plain']:.6f} ulps of the magnitude from "
          f"plain, {r8['f64']:.6f} from f64; kernel {sh['ms']:.6f} ms, plain "
          f"{sh['plain_ms']:.6f}, SDPA {sh['sdpa_ms']:.6f}, bound "
          f"{sh['bound_ms']:.6f} ({sh['bound_by']}); its torch-op backward "
          f"{sh['backward_ms']:.6f} ms")
    print(f"  path O1 wall {time.perf_counter() - t_path:.1f} s")


def _o_state(glob, specs, mesh, *, residual: bool) -> tuple:
    """A copy of the global weights cut onto the positions (positions of a
    device holding one shard share it), their AdamW state and, where
    ``residual``, the compression residual."""
    import torch
    from repro_torch.models import model as TM
    from repro_torch.serve import step as sstep
    from repro_torch.train import grad_compress as tgc
    from repro_torch.train import optimizer as topt
    params = sstep.shard_tree(TM.tree_map(torch.clone, glob), specs, mesh)
    return params, topt.init(params), \
        tgc.init_residual(params) if residual else None


def _o_moe(args, dev, rows, h) -> None:
    """Path O2: ``O_MOE_ARCH`` in its published layout cut to
    ``O_MOE_LAYERS`` layers, one step on ``O_MOE_MESH`` gated against the
    one-card form fed its routes, the planted faults, then the checkpoint
    gate on its state."""
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import get_arch, single_card
    from repro_torch.kernels import flash as tflash
    from repro_torch.models import model as TM
    from repro_torch.models import sharding as tsh
    from repro_torch.serve import step as sstep
    from repro_torch.train import optimizer as topt
    from repro_torch.train import step as tstep
    from repro_torch.train.checkpoint import Checkpointer

    t_path = time.perf_counter()
    base = get_arch(O_MOE_ARCH)
    cfg = dataclasses.replace(base, n_layers=O_MOE_LAYERS,
                              pattern=base.pattern[:O_MOE_LAYERS])
    mesh = tsh.ModelMesh(O_MOE_MESH, devices=dev)
    # the one-card form keeps the layout's padded vocabulary in its softmax
    one = dataclasses.replace(single_card(cfg), vocab_size=cfg.vocab_padded)
    if TM.tree_map(lambda l: l.shape, TM.build_tree(cfg, mesh)) != \
            TM.tree_map(lambda l: l.shape, TM.build_tree(one)):
        raise AssertionError("path O2: the TP-16 tree is not the one-card "
                             "tree")
    L, D, tokens = cfg.n_layers, mesh.size, I_BATCH * I_SEQ
    n_moe = sum(cfg.moe_at(i) for i in range(L))
    n_data = mesh.axis_size("data")
    keep = [mesh.position(data=d_) for d_ in range(n_data)]
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed + 1)
    glob = TM.init_params(cfg, g, dev, mesh=mesh)
    batch = _o_batch(dev, args.seed + 1, cfg.vocab_size)
    specs = TM.param_specs(cfg)
    sp = topt.leaves(specs)
    fn = tstep.make_train_step(cfg, mesh, lr=O_LR)
    args_ = [sstep.shard_tree(t, s_, mesh)
             for t, s_ in zip(batch, fn.in_specs[3:], strict=True)]

    # ---- counted: one step, its routes recorded -----------------------------
    params, opt, _ = _o_state(glob, specs, mesh, residual=False)
    torch.cuda.reset_peak_memory_stats()
    h.reset_counters()
    tsh.reset_collectives()
    with _OSpy(routes_of=keep, n_pos=D, n_moe=n_moe) as spy:
        (params, opt, _, m1), t1 = _sync_time(lambda: fn(params, opt, None,
                                                         *args_))
    l_1 = h.counters()
    coll = {k: dict(v) for k, v in tsh.COLLECTIVES.items() if v["calls"]}
    peak = torch.cuda.max_memory_allocated() / 2**30
    loss_m, gn_m = float(m1["loss"]), float(m1["grad_norm"])
    grads_m, routes, qkv = spy.grads, spy.routes, spy.qkv
    del spy
    if len(routes) != n_moe * n_data:
        raise AssertionError(f"path O2 recorded {len(routes)} routes")

    # ---- the one-card step fed those routes (uncounted): a microbatch a
    # data shard (each position routes its own tokens, so C counts them),
    # remat off so that the routes are asked for once each ----------------
    force = [routes[(layer, r)] for r in keep for layer in range(n_moe)]
    fn1 = tstep.make_train_step(one, lr=O_LR, microbatch=n_data, remat=False)

    def one_step():
        ps = TM.tree_map(torch.clone, glob)
        with _OSpy(force=list(force)) as ospy:
            _, st, m_ = fn1(ps, topt.init(ps), *batch)
        if ospy.force:
            raise AssertionError(f"path O2: {len(ospy.force)} forced routes "
                                 f"unused")
        # sync: ok(the gate's reference, read once)
        return (float(m_["loss"]), float(m_["grad_norm"]),
                [t.cpu() for t in ospy.grads[0]],
                [t.cpu() for t in topt.leaves(st.mu)])
    (l1, n1, g1, mu1), t_one = _sync_time(lambda: h.uncounted(one_step))
    real_lse = tflash.flash_attention_lse
    tflash.flash_attention_lse = functools.partial(
        tflash.flash_attention_plain, return_lse=True)
    try:
        lp, np_, gp, mup = one_step()
    finally:
        tflash.flash_attention_lse = real_lse
    c_loss, c_norm = abs(lp - l1) / abs(l1), abs(np_ / n1 - 1)
    c_grad = max(_o_rel_l2(a, b) for a, b in zip(gp, g1, strict=True))
    c_mu = max(_o_rel_l2(a, b) for a, b in zip(mup, mu1, strict=True))
    del gp, mup
    gate_loss = max(O_LOSS_RTOL, O_CONTROL_FACTOR * c_loss)
    gate_norm = max(O_GNORM_RTOL, O_CONTROL_FACTOR * c_norm)
    gate_grad = max(O_GRAD_RL2, O_CONTROL_FACTOR * c_grad)
    gate_mu = max(O_GRAD_RL2, O_CONTROL_FACTOR * c_mu)

    def mu_gate(st) -> list:
        mus = [topt.leaves(s_.mu) for s_ in st]
        out = []
        for i, s_ in enumerate(sp):
            got = _o_gather([m_[i] for m_ in mus], s_, mesh, dev)
            out.append(_o_rel_l2(got, mu1[i].to(dev)))
        return out
    rl2 = _o_grad_gate(grads_m, sp, mesh, g1, dev)
    rmu = mu_gate(opt)
    del grads_m
    d_loss, d_norm = abs(loss_m - l1) / abs(l1), abs(gn_m / n1 - 1)
    if d_loss > gate_loss or d_norm > gate_norm or max(rl2) > gate_grad or \
            max(rmu) > gate_mu:
        raise AssertionError(f"path O2 against the one-card step fed its "
                             f"routes: loss {loss_m} / {l1} ({d_loss}, gate "
                             f"{gate_loss}), grad norm {gn_m} / {n1} "
                             f"({d_norm}, gate {gate_norm}), gradients up "
                             f"to {max(rl2)} (gate {gate_grad}), mu up to "
                             f"{max(rmu)} (gate {gate_mu})")

    # ---- planted faults, each on a fresh copy of the state (uncounted) ------
    real_sync, real_leaf = tsh.ModelMesh.grad_sync, topt._adamw_leaf

    def no_sync(self, gs, axes):          # final_ln's sum over its copies
        return list(gs) if gs[0].dim() == 1 else real_sync(self, gs, axes)
    fp, fo, _ = _o_state(glob, specs, mesh, residual=False)
    tsh.ModelMesh.grad_sync = no_sync
    try:
        with _OSpy(skip=True) as fs:
            h.uncounted(lambda: fn(fp, fo, None, *args_))
        f_grad = max(_o_rel_l2(_o_gather([p[i] for p in fs.grads], s_, mesh,
                                         dev), g1[i].to(dev))
                     for i, s_ in enumerate(sp))
    finally:
        tsh.ModelMesh.grad_sync = real_sync
    del fs, fp, fo
    hit = []

    def twice(p, *a, **kw):               # final_ln updated twice
        real_leaf(p, *a, **kw)
        if p.dim() == 1 and not hit:
            hit.append(p)
            real_leaf(p, *a, **kw)
    fp, fo, _ = _o_state(glob, specs, mesh, residual=False)
    topt._adamw_leaf = twice
    try:
        _, fo, _, _ = h.uncounted(lambda: fn(fp, fo, None, *args_))
    finally:
        topt._adamw_leaf = real_leaf
    f_mu = max(mu_gate(fo))
    del fp, fo
    if not (f_grad > gate_grad and f_mu > gate_mu):
        raise AssertionError(f"path O2 planted faults pass the gates: "
                             f"final_ln unsynced {f_grad}, updated twice "
                             f"{f_mu}")
    print(f"phase 20: path O2 ({O_MOE_ARCH} in its published layout: tp "
          f"{cfg.tp}, {cfg.n_experts_padded // cfg.tp} of "
          f"{cfg.n_experts_padded} experts a position, top "
          f"{cfg.moe.top_k}, {cfg.n_heads_padded} query / {cfg.n_kv_heads} "
          f"KV heads, KV replicated; {L} of {base.n_layers} layers, "
          f"{cfg.param_count()} parameters) on mesh {O_MOE_MESH}: step "
          f"{t1:.6f} s, {tokens / t1:.1f} tokens/s, loss {loss_m:.6f}, grad "
          f"norm {gn_m:.6f}; peak memory allocated {peak:.3f} GiB; launches "
          f"{ {k: v for k, v in l_1.items() if v} }")
    print(f"  collectives, bytes as if each position were a card: " +
          ", ".join(f"{k} {v['bytes']} ({v['calls']} calls)"
                    for k, v in coll.items()))
    print(f"  gates against the one-card step fed the mesh's routes "
          f"({t_one:.3f} s; a microbatch a data shard): loss relative "
          f"{d_loss:.3e} (gate {gate_loss:.3e}; control {c_loss:.3e}), grad "
          f"norm {d_norm:.3e} (gate {gate_norm:.3e}; control "
          f"{c_norm:.3e}), gradients' relative L2 up to {max(rl2):.3e} "
          f"(gate {gate_grad:.3e}; control {c_grad:.3e}), AdamW mu up to "
          f"{max(rmu):.3e} (gate {gate_mu:.3e}; control {c_mu:.3e})")
    print(f"  planted faults caught: final_ln's gradient not summed over "
          f"its {D} copies {f_grad:.3e}, final_ln updated twice (mu) "
          f"{f_mu:.3e}")

    # ---- the checkpoint: save at step 2, restore onto the same mesh and
    # onto O_RESHARD; step 3 from the restore against step 3 live ----------
    all_specs = {"params": specs, "opt": topt.state_specs(specs)}

    def per(ps, st):
        return [{"params": a, "opt": b} for a, b in zip(ps, st, strict=True)]
    store_dir = ROOT / "build"
    store_dir.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="path_o_ckpt_", dir=store_dir)
    h.reset_counters()
    try:
        (params, opt, _, m2), t2, idle = _o_traced(
            lambda: fn(params, opt, None, *args_))
        saved = sstep.gather_tree(per(params, opt), all_specs, mesh,
                                  device="cpu")
        ck = Checkpointer(tmp)
        _, t_save = _sync_time(lambda: ck.save(2, per(params, opt),
                                               blocking=True, mesh=mesh,
                                               specs=all_specs))
        (params, opt, _, m3), t3 = _sync_time(
            lambda: fn(params, opt, None, *args_))
        live = (float(m3["loss"]), sstep.gather_tree(params, specs, mesh,
                                                     device="cpu"))
        del params, opt
        gc.collect()
        torch.cuda.empty_cache()
        for shape in (O_MOE_MESH, O_RESHARD):
            m_ = tsh.ModelMesh(shape, devices=dev)
            back, t_r = _sync_time(lambda: ck.restore(2, saved, mesh=m_,
                                                      specs=all_specs))
            got = sstep.gather_tree(back, all_specs, m_, device="cpu")
            for a, b in zip(topt.leaves(got), topt.leaves(saved),
                            strict=True):
                if a.dtype != b.dtype or not torch.equal(a, b):
                    raise AssertionError(f"path O2: the state restored onto "
                                         f"{shape} differs from the saved")
            if shape == O_MOE_MESH:
                ps = [b["params"] for b in back]
                st = [b["opt"] for b in back]
                _, _, _, mb = fn(ps, st, None, *args_)
                again = (float(mb["loss"]), sstep.gather_tree(
                    ps, specs, m_, device="cpu"))
                if again[0] != live[0] or not all(
                        torch.equal(a, b) for a, b in zip(
                            topt.leaves(again[1]), topt.leaves(live[1]),
                            strict=True)):
                    raise AssertionError(f"path O2: step 3 from the restore "
                                         f"(loss {again[0]}) differs from "
                                         f"step 3 live ({live[0]})")
                del ps, st, mb
            print(f"  checkpoint of step 2 restored onto {shape} in "
                  f"{t_r:.3f} s: every gathered leaf equal to the saved bit "
                  f"for bit" + (", step 3 from it equal to step 3 live "
                               f"(loss {live[0]:.9f}) bit for bit"
                               if shape == O_MOE_MESH else ""))
            del back, got
        launches_c = h.counters()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    want = 2 * L * D
    if l_1["flash"] != want or launches_c["flash"] != 3 * want:
        raise AssertionError(f"path O2 launches {l_1['flash']}, "
                             f"{launches_c['flash']}; want {want} a step")
    print(f"  steps 2 and 3: {t2:.6f} s (traced: idle share {idle:.6f}), "
          f"{t3:.6f} s; losses {float(m2['loss']):.6f}, {live[0]:.6f}; "
          f"save {t_save:.3f} s ({sum(t.numel() * t.element_size() for t in topt.leaves(saved))} "
          f"bytes)")
    q, k, v = qkv
    r8 = _k8_check(h, "path O2 (group 1)", q, k, v, 0, I_SEQ)
    row = rows["flash"]
    row["launches"] += l_1["flash"] + launches_c["flash"]
    row["max_abs_err"] = max(row["max_abs_err"], r8["max_abs_err"])
    print(f"  K8 at group 1 (q {tuple(q.shape)}, k/v {tuple(k.shape)}): "
          f"{r8['plain']:.6f} ulps of the magnitude from plain, "
          f"{r8['f64']:.6f} from f64; path O2 wall "
          f"{time.perf_counter() - t_path:.1f} s")


def _p_serve(cfg, mesh, params, prompts, pos, replicate: bool, dev) -> dict:
    """Path P's prefill and P_STEPS greedy decode steps from one storage
    form: logits, ids and caches gathered, each step's collectives and the
    peak memory."""
    import torch
    from repro_torch.models import model as TM
    from repro_torch.models import sharding as tsh
    from repro_torch.serve import step as tstep
    pre = tstep.make_prefill(cfg, mesh, replicate_weights=replicate)
    dec = tstep.make_decode_step(cfg, mesh, replicate_weights=replicate)
    _, c_spec, t_spec, p_spec = pre.in_specs
    B, P = prompts.shape
    caches = tstep.shard_tree(
        TM.init_cache(cfg, B, P + P_STEPS, local=False, device=dev), c_spec,
        mesh, share=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tsh.reset_collectives()
    (logits, caches), t_pre = _sync_time(lambda: pre(
        params, caches, tstep.shard_tree(prompts, t_spec, mesh),
        tstep.shard_tree(pos, p_spec, mesh)))
    coll = {"prefill": {k: dict(v) for k, v in tsh.COLLECTIVES.items()
                        if v["calls"]}}
    lg = tstep.gather_tree(logits, pre.out_specs[0], mesh)
    nxt = torch.argmax(lg[:, :cfg.vocab_size], -1).to(torch.int32)[:, None]
    ids, t_dec = [], 0.0
    for i in range(P_STEPS):
        tsh.reset_collectives()
        (nx, caches), t = _sync_time(lambda: dec(
            params, caches, tstep.shard_tree(nxt, t_spec, mesh),
            tstep.shard_tree(torch.full_like(nxt, P + i), p_spec, mesh),
            P + i))
        t_dec += t
        nxt = tstep.gather_tree(nx, dec.out_specs[0], mesh)[:, None]
        ids.append(nxt[:, 0])
        coll["decode"] = {k: dict(v) for k, v in tsh.COLLECTIVES.items()
                          if v["calls"]}
    return dict(logits=lg, ids=torch.stack(ids, 1),
                caches=tstep.gather_tree(caches, c_spec, mesh), coll=coll,
                t_pre=t_pre, t_dec=t_dec,
                peak=torch.cuda.max_memory_allocated() - base)


def _p_prefill_args(cfg, mesh, glob, prompts, pos, dev):
    """The FSDP prefill and its arguments on ``mesh``'s positions (the
    weights cut from ``glob``, fresh caches)."""
    from repro_torch.models import model as TM
    from repro_torch.serve import step as tstep
    pre = tstep.make_prefill(cfg, mesh)
    _, c_spec, t_spec, p_spec = pre.in_specs
    B, P = prompts.shape
    caches = TM.init_cache(cfg, B, P + P_STEPS, local=False, device=dev)
    return pre, (tstep.shard_tree(glob, pre.in_specs[0], mesh),
                 tstep.shard_tree(caches, c_spec, mesh, share=False),
                 tstep.shard_tree(prompts, t_spec, mesh),
                 tstep.shard_tree(pos, p_spec, mesh))


def _path_p(args, dev, rows, h) -> None:
    """Phase 21, path P: serving from FSDP-stored weights against the
    replicated form, OpCost on the card against the dry run on meta, the
    index service's cell, one production cell dry."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch, single_card
    from repro_torch.kernels import flash as tflash
    from repro_torch.kernels import lookup as tlk
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.op_cost import OpCost
    from repro_torch.models import model as TM
    from repro_torch.models import sharding as tsh
    from repro_torch.serve import step as tstep

    t_path = time.perf_counter()
    base = get_arch(M_ARCH)
    cfg = dataclasses.replace(base, n_layers=P_LAYERS,
                              pattern=base.pattern[:P_LAYERS])
    one = single_card(cfg)
    mesh = tsh.ModelMesh(P_MESH, devices=dev)
    B, P, V = LM_REQUESTS, LM_PROMPT_LEN, cfg.vocab_size
    rng = np.random.default_rng(args.seed + 21)
    prompts = torch.from_numpy(rng.integers(0, V, (B, P))).to(
        device=dev, dtype=torch.int32)
    pos = torch.arange(P, dtype=torch.int32, device=dev)[None].expand(
        B, P).contiguous()

    # ---- one production cell dry, and the FSDP prefill dry on meta (a meta
    # call launches nothing; OpCost counts its calls by tile) -------------
    cell, t_cell = _sync_time(lambda: dryrun.run_cell(*P_DRY_CELL))
    meta_mesh = tsh.ModelMesh(P_MESH, devices="meta")
    m_glob = TM.init_params(one, torch.Generator(), device="meta")
    m_pre, m_args = _p_prefill_args(cfg, meta_mesh, m_glob, prompts.to(
        "meta"), pos.to("meta"), "meta")
    with OpCost(1, track_memory=True,
                owners=dryrun.owners_of(m_args, meta_mesh.size)) as c_meta:
        m_pre(*m_args)
    dry = c_meta.summary()
    dry_temp = c_meta.memory()
    # the K8 calls the dry run counted, by tile: what the card launches
    dry_launch = {k: v["calls"] for k, v in dry["kernels"].items()
                  if k in tflash.LAUNCHES}
    dry_args = dryrun._tree_bytes([a[0] for a in m_args], set())
    del m_pre, m_args, m_glob

    # ---- counted: the two storage forms' prefill and decode ---------------
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed)
    glob = TM.init_params(one, g, dev)
    specs_f, specs_r = TM.param_specs(cfg), tstep.serve_param_specs(cfg)
    per_f = tstep.shard_tree(glob, specs_f, mesh)
    per_r = tstep.shard_tree(glob, specs_r, mesh)
    stored = {k: dryrun._tree_bytes(t[0], set())
              for k, t in (("fsdp", per_f), ("replicated", per_r))}
    stacked = {k: dryrun._tree_bytes(t[0]["sb"], set())
               for k, t in (("fsdp", per_f), ("replicated", per_r))}
    h.reset_counters()
    runs = {"fsdp": _p_serve(cfg, mesh, per_f, prompts, pos, False, dev)}
    del per_f
    runs["replicated"] = _p_serve(cfg, mesh, per_r, prompts, pos, True, dev)
    launches = h.counters()
    del per_r
    L, D = cfg.n_layers, mesh.size
    want = {"flash": 2 * L * D, "flash_decode": 2 * L * D * P_STEPS}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"path P launches {launches}, want {want}")
    a, b = runs["fsdp"], runs["replicated"]
    for what in ("logits", "ids"):
        if not torch.equal(a[what], b[what]):
            raise AssertionError(f"path P: FSDP-stored serving's {what} "
                                 f"differ from the replicated form's")
    for pos_, leaves in a["caches"].items():
        for k, t in leaves.items():
            if not torch.equal(t, b["caches"][pos_][k]):
                raise AssertionError(f"path P: cache {pos_}.{k} differs "
                                     f"between the storage forms")
    if not torch.isfinite(a["logits"]).all():
        raise AssertionError("path P: non-finite logits")
    for k in want:
        rows[k]["launches"] += launches[k]
    rows["flash"]["path_p_launches"] = launches["flash"]
    rows["flash_decode"]["path_p_launches"] = launches["flash_decode"]
    print(f"phase 21: path P ({M_ARCH} in its published layout: tp "
          f"{cfg.tp}, {P_LAYERS} of {base.n_layers} layers at full width) "
          f"on mesh {P_MESH}, every position {dev}: {B} x {P} prompts and "
          f"{P_STEPS} greedy steps from FSDP-stored and from replicated "
          f"weights: logits, ids and every cache equal bit for bit; "
          f"launches {({k: launches[k] for k in want})} "
          f"(K8 a layer a position a call, both forms)")
    for k, r in runs.items():
        print(f"  {k}: stored weight bytes a position {stored[k]} (the "
              f"stacked superblock leaves {stacked[k]}); prefill "
              f"{r['t_pre']:.6f} s, {P_STEPS} decode steps {r['t_dec']:.6f}"
              f" s; peak memory above the arguments {r['peak'] / 2**30:.3f} "
              f"GiB; collectives, bytes as if each position were a card: "
              f"prefill {r['coll']['prefill']}, a decode step "
              f"{r['coll']['decode']}")
    print(f"  the FSDP form stores {stacked['fsdp'] / stacked['replicated']:.4f}"
          f" of the replicated form's stacked leaves a position (data "
          f"{mesh.axis_size('data')})")
    del runs, a, b

    # ---- the FSDP prefill counted on the card against the dry run ---------
    pre, c_args = _p_prefill_args(cfg, mesh, glob, prompts, pos, dev)
    card_args = dryrun._tree_bytes([x[0] for x in c_args], set())
    torch.cuda.synchronize()
    tflash.reset_launches()
    used = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with OpCost(1) as c_card:
        pre(*c_args)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - used
    card = c_card.summary()
    card_launch = {k: v for k, v in tflash.LAUNCHES.items() if v}
    for k in ("flops_by_dtype", "bytes", "collective_bytes_by_kind",
              "kernels", "collectives"):
        if card[k] != dry[k]:
            raise AssertionError(f"path P: OpCost's {k} on the card "
                                 f"{card[k]} differs from the dry run's "
                                 f"{dry[k]}")
    if card_launch != dry_launch or card_args != dry_args:
        raise AssertionError(f"path P: launches {card_launch} / "
                             f"{dry_launch}, argument bytes {card_args} / "
                             f"{dry_args}")
    pre_ms = _event_ms(lambda: pre(*c_args), 3, warmup=1)
    rt = roofline.times(card, 1)
    coll_s = card["collective_bytes"] / D / roofline.NIC_BW
    print(f"  OpCost of the FSDP prefill on the card equals its dry run on "
          f"meta: FLOPs by dtype {card['flops_by_dtype']}, bytes "
          f"{card['bytes']}, {card['ops']} ops / {dry['ops']}, K8 launches "
          f"{card_launch} (the dry run's calls), collective "
          f"bytes {card['collective_bytes_by_kind']}; argument bytes a "
          f"position {card_args} (the dry run's {dry_args})")
    print(f"  roofline of the whole mesh's prefill on this card: compute "
          f"{rt['compute_s']:.6f} s, memory {rt['memory_s']:.6f} s; "
          f"collectives as if each position a card {coll_s:.6f} s a card; "
          f"measured prefill {pre_ms / 1e3:.6f} s (CUDA events, 3 calls): "
          f"roofline fraction {rt['compute_s'] / (pre_ms / 1e3):.4f}")
    print(f"  temporaries: the dry run's peak of live meta storage above "
          f"the arguments {dry_temp['temp_bytes']} bytes (one position's "
          f"{dry_temp['temp_bytes_position']}); the card's rise of "
          f"max_memory_allocated {rise} bytes")
    del pre, c_args, glob

    # ---- the index service's cell on the card -----------------------------
    gc.collect()
    torch.cuda.empty_cache()
    h.reset_counters()
    (summary, meta, (idx, q, ranks)), t_idx = _sync_time(
        lambda: dryrun.lower_index_service(dev))
    n_idx = h.counters()["sharded_lookup"]
    want_r = torch.empty_like(ranks)
    dest = torch.searchsorted(idx.splits, q)
    for s_ in range(idx.n_shards):
        part = idx.parts[s_]
        v_ = int(idx.valid[s_])
        m_ = dest == s_
        local = torch.searchsorted(part.keys[0, :v_].contiguous(), q[m_])
        want_r[m_] = (torch.clamp_max(local, v_) + s_ * idx.cap).to(
            want_r.dtype)
    _check_equal("path P index service", ranks, want_r)
    if n_idx != 2 * dryrun.INDEX_SHARDS or \
            summary["kernels"]["sharded_lookup"]["calls"] != \
            dryrun.INDEX_SHARDS:
        raise AssertionError(f"path P index service launches {n_idx}, "
                             f"{summary['kernels']}")
    rows["sharded_lookup"]["launches"] += n_idx
    rows["sharded_lookup"]["path_p_launches"] = n_idx
    print(f"  index service cell ({dryrun.INDEX_KEYS} keys, "
          f"{dryrun.INDEX_SHARDS} shards a position each, "
          f"{dryrun.INDEX_QUERIES} queries): answers equal torch."
          f"searchsorted; stacked K1 launches {n_idx} (a call a position, "
          f"two calls); a chip's {summary['flops']} FLOPs, "
          f"{summary['bytes']} bytes, all-to-all "
          f"{summary['collective_bytes_by_kind']}; {t_idx:.3f} s")
    del idx, q, ranks

    # ---- the production cell -------------------------------------------
    print(f"  dry cell {P_DRY_CELL[0]} {P_DRY_CELL[1]} single ("
          f"{cell['chips']} chips): {t_cell:.3f} s wall; a chip's FLOPs "
          f"{cell['flops_by_dtype']}, bytes {cell['bytes_per_chip']}, "
          f"collectives {cell['collective']['bytes_by_kind']}, memory "
          f"{cell['memory']}, roofline {cell['roofline']}")
    print(f"  path P wall {time.perf_counter() - t_path:.1f} s")


def _path_o(args, dev, rows, h) -> None:
    """Phase 20, path O: training on a mesh (O1, then O2), counted."""
    t0 = time.perf_counter()
    _o_dense(args, dev, rows, h)
    gc.collect()
    import torch
    torch.cuda.empty_cache()
    _o_moe(args, dev, rows, h)
    print(f"  path O wall {time.perf_counter() - t0:.1f} s")


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
    # K8's bias tile keeps 96 f32 output accumulators a thread at D = 384
    # (its wgmma m64n192 slice) beside S's 32: none may spill; and it runs
    # its products as wgmma (HGMMA), with no warp-level mma.sync (HMMA)
    if "flash" in reports:
        bias_spills = _spills(_entry_report(reports["flash"],
                                            "flash_bias_kernel"))
        if bias_spills:
            raise AssertionError(f"ptxas spills in flash_bias_kernel: "
                                 f"{bias_spills}")
        print("  flash_bias_kernel (D 64, 384): no spills")
    bias_sass = _sass_functions(sass, "flash_bias_kernel")
    n_hg = sum(f.count("HGMMA") for f in bias_sass)
    n_hm = sum(f.count("HMMA") for f in bias_sass)
    print(f"  flash_bias_kernel: {len(bias_sass)} functions, {n_hg} HGMMA, "
          f"{n_hm} HMMA instructions")
    if len(bias_sass) != 2 or n_hg == 0 or n_hm:
        raise AssertionError("flash_bias_kernel's SASS must hold HGMMA "
                             "(wgmma) and no HMMA (mma.sync) at D 64 and 384")
    # K8's other tiles at every head dim they take (the CUDA-core tile at
    # its padded widths 16-256, the tensor-core tile at D 64, 80, 96 and
    # 128, the split-KV tile at 64, 128 and 256): no spills, and HGMMA in
    # every instantiation of the tensor-core tile
    if "flash" in reports:
        for kern in ("flash_cc_kernel", "flash_tc_kernel",
                     "flash_split_kernel"):
            bad = _spills(_entry_report(reports["flash"], kern))
            if bad:
                raise AssertionError(f"ptxas spills in {kern}: {bad}")
        print("  flash_cc_kernel, flash_tc_kernel, flash_split_kernel (every "
              "head dim): no spills")
    tc_sass = _sass_functions(sass, "flash_tc_kernel")
    tc_hg = [f.count("HGMMA") for f in tc_sass]
    print(f"  flash_tc_kernel: {len(tc_sass)} functions (D 64, 80, 96, 128), "
          f"HGMMA {tc_hg}")
    if len(tc_sass) != 4 or not all(tc_hg):
        raise AssertionError("every flash_tc_kernel instantiation must run "
                             "its products as wgmma (HGMMA)")

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
    _census(h, "phase 3", {"Index.find": lambda: ix.find(q64),
                           "Index.find_range": lambda: ix.find_range(lo, hi)})
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

    # ---- phase 13: the static analyzer, held against the card -------------
    _phase13(reports, h)
    print(f"  wall {time.perf_counter() - t_start:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # ---- phase 14: path I (LM training), counted ---------------------------
    _path_i(args, dev, rows, h)
    print(f"  wall {time.perf_counter() - t_start:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # ---- phase 15: path J (the recurrent families served), counted --------
    _path_j(args, dev, rows, h)
    print(f"  wall {time.perf_counter() - t_start:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # ---- phase 16: path K (the recurrent families trained), counted -------
    _path_k(args, dev, rows, h)
    print(f"  wall {time.perf_counter() - t_start:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # ---- phase 17: path L (embedding-input and M-RoPE families), counted --
    _path_l(args, dev, rows, h)
    print(f"  wall {time.perf_counter() - t_start:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # ---- phase 18: path M (tensor-parallel, sequence-sharded), counted ----
    _path_m(args, dev, rows, h)
    print(f"  wall {time.perf_counter() - t_start:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # ---- phase 19: path N (MoE and Mamba under TP, long_500k), counted ----
    _path_n(args, dev, rows, h)
    print(f"  wall {time.perf_counter() - t_start:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # ---- phase 20: path O (training on a mesh), counted --------------------
    _path_o(args, dev, rows, h)
    print(f"  wall {time.perf_counter() - t_start:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # ---- phase 21: path P (the launch cost tools), counted ----------------
    _path_p(args, dev, rows, h)
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
