"""tracelint for the PyTorch/CUDA port -- static analysis of the port's own
contracts (counterpart of ``repro.analysis``: the same module names, rule
ids and pragma grammar; its own copies of the engine and call graph, pure
AST, importing neither ``jax`` nor anything of ``repro``).

The port's load-bearing invariants -- a counted, small number of host
reads a served call, no compiled object rebuilt per call, f32 key casts
only behind the ``f32_exact`` gate, CUDA kernels within the H100's shared
memory and free of contractions where they are held bit for bit -- are
checked at run time only where a test or ``chip_smoke.py`` happens to
exercise them.  This package checks them over the source, so a new hot-path
sync fails before any workload hits it.

Usage::

    PYTHONPATH=src python -m repro_torch.analysis src/repro_torch \\
        chip_smoke.py time_verbs.py examples/index_service_torch.py
    PYTHONPATH=src python -m repro_torch.analysis --list-rules
    PYTHONPATH=src python -m repro_torch.analysis --smem-budget 101376 \\
        src/repro_torch

Exit status is non-zero iff any *unsuppressed* finding (or malformed
pragma) remains.  Findings print as ``path:line: [rule-id] message``.
``.cu`` files under the given directories are read too.

Rules (one module each under ``repro_torch.analysis.rules``):

``hot-sync``
    Host synchronization inside the serving hot path: every function
    reachable over the project call graph from the front-end's roots
    (``BatchingFrontend._dispatch`` / ``_resolve``, ``TenantPack.find`` /
    ``find_range``) and the single index's serve verbs (``Index.find`` /
    ``Index.find_range``).  Flagged: device-to-host reads (``.item()``,
    ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``, ``int()`` /
    ``float()`` / ``bool()`` of non-metadata), stream drains
    (``torch.cuda.synchronize()``, ``.synchronize()``), ops that size
    their output on the host (``nonzero``, ``unique``, ``masked_select``,
    ``bincount``, ``repeat_interleave`` without ``output_size``, boolean
    mask indexing, ``torch.equal``), host-to-device copies from pageable
    memory (``torch.tensor`` / ``as_tensor`` with a ``device``,
    ``.to(device)``, ``.cuda()``, ``.copy_()``), numpy materialization, and
    the truth of ``.any()`` / ``.all()``.  ``.shape`` / ``.numel()`` /
    ``.dim()`` / ``.device`` / ``.dtype`` / ``len()`` are metadata and
    exempt.

    **The port's sync contract** differs from the reference's "one sync a
    batch": the port reads on purpose at a few counted sites -- the
    epilogues' one read a step for all their scalars (``kernels.ops``),
    the exchange's slice lengths (``core.distributed._exchange``), the
    front-end's answers (``BatchingFrontend._resolve``) -- and each such
    site carries a pragma with its reason, so the suppressed findings are
    the map of the port's host reads.  ``chip_smoke.py`` (phase 13) holds
    that map against the syncs the CUDA runtime itself reports.

``retrace``
    Compiled objects rebuilt per call: ``torch.compile``,
    ``torch.jit.script`` / ``trace``, ``torch.cuda.CUDAGraph`` /
    ``torch.cuda.graph`` or ``ctypes.CDLL`` on a lambda, inside a loop, or
    in a def that is not memoized (``functools.lru_cache`` / ``cache``, or
    a module-level dict cache such as ``kernels/build.py``'s ``_LIBS``).

``kernel``
    The CUDA sources: per ``__global__`` instantiation, static
    ``__shared__`` bytes within 48 KiB; at each launch, static plus
    dynamic bytes within the H100's opt-in limit (232,448 bytes,
    ``--smem-budget``), and above 48 KiB of dynamic bytes a
    ``cudaFuncSetAttribute(..., cudaFuncAttributeMaxDynamicSharedMemorySize,
    ...)`` of that kernel first; no explicit FMA in the sources held bit
    for bit against XLA's unfused rounding (``lookup.cu``, ``hist.cu``,
    ``linfit.cu``, ``ksdist.cu``), no ``double`` in ``lookup.cu``, and
    ``-fmad=false`` in ``kernels/build.py``'s ``NVCC_FLAGS``.  Sizes come
    from the sources' ``constexpr``, ``#define`` and ``enum`` constants; a
    dimension that names a template parameter, a runtime argument or a
    struct is skipped, so each figure is a lower bound, and the checks
    fire on lower bounds.

``f32-cast``
    dtype exactness: an f32 cast of a *key-like* tensor (``.to(float32)``,
    ``.float()``, ``torch.tensor`` / ``as_tensor(..., dtype=float32)``,
    and the reference's numpy spellings) is legal only inside
    ``repro_torch.kernels`` (every kernel wrapper sits behind the
    ``f32_exact`` gate), in ``chip_smoke.py`` (its casts build reference
    answers and f32-exact queries), or inside functions that implement or
    consult an ``f32_exact`` guard.

``donation`` has no counterpart: no torch API consumes an argument's
buffer; where the reference donates, the port writes in place (the KV
caches, ``serve/step.py``; the restack slice cache,
``core.distributed.scatter_rows_``).  The port defines no rule id the
reference lacks, so either analyzer accepts the other's pragmas.

Pragma grammar (inline suppression -- there is **no** baseline file; every
suppression is an annotation at the offending line and MUST carry a
non-empty reason)::

    # tracelint: ok[<rule-id>](<reason>)     -- suppress <rule-id> here
    # sync: ok(<reason>)                     -- alias for ok[hot-sync]
    // tracelint: ok[kernel](<reason>)       -- the same, in a .cu file

A pragma suppresses findings of that rule on any line of the statement it
annotates (trailing comment) or on the statement directly below it (own
line).  A pragma with an empty reason, an unknown rule id, or a malformed
spelling is itself reported (rule id ``pragma``) and cannot be
suppressed.
"""
from .engine import Config, Finding, Project, analyze, main

__all__ = ["Config", "Finding", "Project", "analyze", "main"]
