"""Dry run of one (arch x shape x mesh) cell on ``meta`` positions (the
counterpart of ``repro.launch.dryrun``): per-chip FLOPs, bytes,
collective traffic and memory, with no allocation and no card.

The reference lowers and compiles each cell with ``ShapeDtypeStruct``
stand-ins on 256 or 512 host devices and reads the compiled HLO.  The port
builds ``launch.mesh.make_production_mesh(devices="meta")``, cuts global
meta trees of the reference's shapes (``serve.step.serve_shapes``,
``train.step.batch_shapes``, ``auto_microbatch``) onto its positions by
the step's ``in_specs``, and runs the step once under
``launch.op_cost.OpCost``; the kernel wrappers' meta branches return empty
outputs and hand over each kernel's work (``kernels.cost``).  Decode runs
with ``cache_len = seq_len - 1``: the whole cache, which the reference's
compiled program covers.

Depth: the model is counted at one superblock and at two, and every count
is reported as ``c1 + (n_sb - 1) (c2 - c1)`` (``depth_counted: [1, 2]``).
This is exact wherever the superblocks are identical, as they are in
every registered arch (their leaves stack), and mirrors ``hlo_cost.py``'s
loop body times its trip count.  It is the dry run's one assumption.

``memory`` (a chip's, as the reference's ``memory_analysis``):
``argument_bytes`` from position 0's shards of the full-depth arguments
(storages it shares with other positions counted once), ``output_bytes``
of position 0's results, ``alias_bytes`` of those written in place (the
caches; the parameters, optimizer state and residual of a train step),
``temp_bytes`` the peak over the positions of the live meta storage each
holds above the arguments while the step runs (``OpCost(track_memory=)``;
``temp_bytes_all_positions`` is every position's together), and
``peak_bytes_est = argument + output + temp - alias``.

The ``index_service`` cell (the reference's ``lower_index_service``) runs
for real on the entry point's device (CUDA unless ``device="cpu"``):
``core.distributed.build_sharded`` over 2^20 ``linspace`` keys (rounded
to f32, so that the kernel path serves them) in the production mesh's 16
``data`` shards, one a position, ``n_leaves=256``, and one
``make_lookup_fn`` call on 2^16 f64 queries (uniform draws rounded to
f32; stacked K1; ``--tag cap2``
gives ``capacity_factor=2.0``); the exchange is its ``all-to-all``.

JSON keys follow the reference's where the meaning is the same, without
its ``hlo_`` / ``xla_`` prefixes; ``lower_s`` / ``compile_s`` are
``trace_s``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
      --shape decode_32k --mesh single --out experiments/dryrun_torch/
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from ..configs import SHAPES, get_arch, list_archs
from ..models import model as M
from ..serve import step as serve_step
from ..train import grad_compress, optimizer
from ..train.step import auto_microbatch, batch_shapes, make_train_step
from . import roofline
from .mesh import make_production_mesh
from .op_cost import OpCost

META = torch.device("meta")
DEPTHS = (1, 2)
INDEX_KEYS = 1 << 20
INDEX_QUERIES = 1 << 16
INDEX_LEAVES = 256
INDEX_SHARDS = 16            # the production mesh's data axis


def _empty(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _tree_bytes(tree, seen: set) -> int:
    """Bytes of the distinct storages of a tree's tensors (``seen`` keeps
    the storages already counted)."""
    total = 0
    for t in _tensors(tree):
        key = t.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def owners_of(args: tuple, n: int) -> dict:
    """Each argument storage's positions: ``args`` lists over ``n``
    positions (the step's arguments; other entries are skipped)."""
    out: dict = {}
    for a in args:
        if not isinstance(a, list) or len(a) != n:
            continue
        for r, tree in enumerate(a):
            for t in _tensors(tree):
                key = t.untyped_storage()._cdata
                out[key] = out.get(key, frozenset()) | {r}
    return out


def _cut(cfg, n_sb: int):
    """``cfg`` at ``n_sb`` superblocks (the same superblock)."""
    n = n_sb * cfg.sb
    return dataclasses.replace(cfg, n_layers=n, pattern=cfg.pattern[:n],
                               sb=cfg.sb)


def _meta_params(cfg, mesh) -> dict:
    return M.init_params(cfg, torch.Generator(), device=META, mesh=mesh)


def _serve_step(cfg, shape, mesh, replicate_weights: bool) -> tuple:
    """(fn, args, meta, in-place argument indices) of a prefill or decode
    cell, the arguments cut onto ``mesh``'s positions."""
    B, S = shape.global_batch, shape.seq_len
    cut = serve_step.shard_tree
    if shape.kind == "prefill":
        fn = serve_step.make_prefill(cfg, mesh,
                                     replicate_weights=replicate_weights)
        caches = M.cache_shapes(cfg, B, S, local=False)
        tok = ((B, S, cfg.d_model), torch.bfloat16) if cfg.embed_input \
            else ((B, S), torch.int32)
        pos = ((3, B, S) if cfg.rope == "mrope" else (B, S), torch.int32)
        meta = {}
        extra = ()
    else:
        sh = serve_step.serve_shapes(cfg, shape, mesh)
        fn = serve_step.make_decode_step(
            cfg, mesh, batch_sharded=sh["batch_sharded"],
            seq_shard=sh["seq_shard"], replicate_weights=replicate_weights)
        caches, tok, pos = sh["caches"], sh["tokens"], sh["pos"]
        meta = {"batch_sharded": sh["batch_sharded"],
                "seq_shard": sh["seq_shard"], "cache_len": S - 1}
        extra = (S - 1,)
    specs = fn.in_specs
    cache_tree = {p: {k: _empty(*v) for k, v in leaves.items()}
                  for p, leaves in caches.items()}
    args = (cut(_meta_params(cfg, mesh), specs[0], mesh),
            cut(cache_tree, specs[1], mesh, share=False),
            cut(_empty(*tok), specs[2], mesh),
            cut(_empty(*pos), specs[3], mesh)) + extra
    return fn, args, meta, (1,)


def _train_step(cfg, shape, mesh, *, compress_pod: bool, microbatch,
                psum_bf16: bool) -> tuple:
    B, S = shape.global_batch, shape.seq_len
    if microbatch is None:
        microbatch = auto_microbatch(cfg, B, S, mesh=mesh)
    fn = make_train_step(cfg, mesh, compress_pod=compress_pod,
                         microbatch=microbatch,
                         psum_dtype=torch.bfloat16 if psum_bf16 else None)
    specs = fn.in_specs
    cut = serve_step.shard_tree
    params = cut(_meta_params(cfg, mesh), specs[0], mesh)
    opt = optimizer.init(params)
    res = grad_compress.init_residual(params) if compress_pod else None
    b = batch_shapes(cfg, B, S)
    args = (params, opt, res) + tuple(
        cut(_empty(*b[k]), s, mesh)
        for k, s in zip(("inputs", "labels", "pos"), specs[3:], strict=True))
    return fn, args, {"microbatch": microbatch}, (0, 1, 2)


def _build(cfg, shape, mesh, opts) -> tuple:
    if shape.kind == "train":
        return _train_step(cfg, shape, mesh, compress_pod=opts["compress_pod"],
                           microbatch=opts["microbatch"],
                           psum_bf16=opts["psum_bf16"])
    return _serve_step(cfg, shape, mesh, opts["replicate_weights"])


def count_step(fn, args: tuple, chips: int, *,
               track_memory: bool = True) -> tuple:
    """(``OpCost`` summary, memory of the temporaries, results) of one run
    of ``fn(*args)`` under ``OpCost``."""
    n = len(args[0])
    with OpCost(chips, track_memory=track_memory,
                owners=owners_of(args, n) if track_memory else None) as c:
        out = fn(*args)
    return c.summary(), c.memory(), out


def _extrapolate(c1, c2, n: int):
    """``c1 + (n - 1) (c2 - c1)`` through dicts of numbers."""
    if isinstance(c1, dict):
        keys = list(dict.fromkeys([*c1, *c2]))
        return {k: _extrapolate(c1.get(k, 0), c2.get(k, 0), n) for k in keys}
    if isinstance(c1, bool) or not isinstance(c1, (int, float)):
        return c1
    return c1 + (n - 1) * (c2 - c1)


def _memory(cfg, shape, mesh, opts, temp: dict, position_out) -> dict:
    """A chip's memory at full depth: the arguments from position 0's
    shards (built on meta at ``cfg``'s depth), the outputs and aliases of
    position 0, the temporaries extrapolated."""
    _, args, _, inplace = _build(cfg, shape, mesh, opts)
    arg_bytes = _tree_bytes([_pos0(a) for a in args], set())
    alias = _tree_bytes([_pos0(args[i]) for i in inplace], set())
    out_bytes = alias + position_out
    return {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
            "temp_bytes": temp["temp_bytes_position"],
            "alias_bytes": alias,
            "temp_bytes_all_positions": temp["temp_bytes"],
            "peak_bytes_est": arg_bytes + out_bytes
            + temp["temp_bytes_position"] - alias}


def _pos0(a):
    return a[0] if isinstance(a, list) else a


def _new_output_bytes(out, args, inplace) -> int:
    """Bytes of position 0's results that are not its in-place
    arguments (the logits, the ids, a train step's metrics)."""
    old = {t.untyped_storage()._cdata
           for i in inplace for t in _tensors(_pos0(args[i]))}
    seen = set(old)
    first = [_pos0(o) if isinstance(o, list) else o for o in
             (out if isinstance(out, tuple) else (out,))]
    return _tree_bytes(first, seen)


def lower_cell(arch: str, shape_name: str, mesh, *, compress_pod=False,
               microbatch: int | None = None, psum_bf16: bool = False,
               replicate_weights: bool = False) -> dict:
    """Count one LM cell on ``mesh`` (meta positions) at one and two
    superblocks and extrapolate to the arch's depth."""
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    opts = dict(compress_pod=compress_pod, microbatch=microbatch,
                psum_bf16=psum_bf16, replicate_weights=replicate_weights)
    meta = {"arch": arch, "shape": shape_name, "kind": shape.kind,
            "psum_bf16": psum_bf16, "replicate_weights": replicate_weights}
    counts, temps, outs = [], [], []
    for d in DEPTHS:
        fn, args, m, inplace = _build(_cut(cfg, d), shape, mesh, opts)
        meta.update(m)
        s, temp, out = count_step(fn, args, mesh.size)
        counts.append(s)
        temps.append(temp)
        outs.append(_new_output_bytes(out, args, inplace))
        del fn, args, out
    n = cfg.n_sb
    summary = _extrapolate(counts[0], counts[1], n)
    temp = _extrapolate(temps[0], temps[1], n)
    meta["memory"] = _memory(cfg, shape, mesh, opts, temp, outs[0])
    meta["n_sb"] = n
    return summary, meta


def lower_index_service(device=None, capacity_factor=None) -> tuple:
    """The index service's cell, run for real on ``device``."""
    from ..core import distributed
    dev = torch.device("cuda" if device is None else device)
    mesh = distributed.ShardMesh(INDEX_SHARDS, axis="data",
                                 devices=(dev,) * INDEX_SHARDS)
    keys = np.linspace(0.0, 1.0, INDEX_KEYS).astype(np.float32) \
        .astype(np.float64)
    idx = distributed.build_sharded(keys, mesh, axis="data",
                                    n_leaves=INDEX_LEAVES)
    fn = distributed.make_lookup_fn(idx, capacity_factor=capacity_factor,
                                    path="kernel")
    # f64 queries on f32 values: the kernel's f32 search answers them as an
    # f64 search would
    q = torch.as_tensor(np.random.default_rng(0).random(INDEX_QUERIES)
                        .astype(np.float32).astype(np.float64),
                        device=mesh.devices[0])
    fn(q)                                   # tables and descriptors built
    with OpCost(INDEX_SHARDS) as c:
        ranks = fn(q)
    # a position's arguments: its shard's f64 keys and the batch; the
    # temporaries are not followed on a real device
    arg = idx.parts[0].keys.numel() * 8 + q.numel() * q.element_size()
    out = ranks.numel() * ranks.element_size()
    meta = {"arch": "index_service", "shape": "lookup_64k", "kind": "index",
            "capacity_factor": capacity_factor, "device": str(dev),
            "memory": {"argument_bytes": int(arg), "output_bytes": int(out),
                       "temp_bytes": None, "alias_bytes": 0,
                       "peak_bytes_est": int(arg + out)}}
    return c.summary(), meta, (idx, q, ranks)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str | None = None, compress_pod: bool = False,
             microbatch: int | None = None, tag: str = "",
             psum_bf16: bool = False, replicate_weights: bool = False,
             device=None) -> dict:
    """One cell's row: counted, its roofline, written to ``out_dir``."""
    mesh = make_production_mesh(multi_pod=multi_pod, devices=META)
    t0 = time.time()
    if arch == "index_service":
        summary, meta, _ = lower_index_service(
            device, capacity_factor=2.0 if tag == "cap2" else None)
        chips = INDEX_SHARDS
    else:
        summary, meta = lower_cell(arch, shape_name, mesh,
                                   compress_pod=compress_pod,
                                   microbatch=microbatch,
                                   psum_bf16=psum_bf16,
                                   replicate_weights=replicate_weights)
        chips = mesh.size
        meta["depth_counted"] = list(DEPTHS)
    trace_s = time.time() - t0
    result = dict(
        meta, mesh="multi" if multi_pod else "single", chips=chips,
        trace_s=round(trace_s, 1), flops_per_chip=summary["flops"],
        bytes_per_chip=summary["bytes"],
        flops_by_dtype=summary["flops_by_dtype"],
        collective={"bytes_by_kind": summary["collective_bytes_by_kind"],
                    "counts": summary["collective_counts"],
                    "total_bytes": summary["collective_bytes"]},
        kernels=summary["kernels"], ops=summary["ops"],
        roofline=roofline.times(summary, chips))
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"__{tag}" if tag else ""
        fname = f"{arch}__{shape_name}__{result['mesh']}{suffix}.json"
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(result, f, indent=1)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help=f"one of {list_archs()} or index_service")
    ap.add_argument("--shape", default="train_4k",
                    choices=[*SHAPES, "lookup_64k"])
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--out", default="experiments/dryrun_torch",
                    help="directory of the row's JSON ('' writes none)")
    ap.add_argument("--compress-pod", action="store_true")
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--tag", default="")
    ap.add_argument("--psum-bf16", action="store_true")
    ap.add_argument("--replicate-weights", action="store_true")
    ap.add_argument("--device", default=None,
                    help="the index_service cell's device (default cuda)")
    args = ap.parse_args(argv)
    res = run_cell(args.arch, args.shape, args.mesh == "multi",
                   args.out or None,
                   compress_pod=args.compress_pod,
                   microbatch=args.microbatch, tag=args.tag,
                   psum_bf16=args.psum_bf16,
                   replicate_weights=args.replicate_weights,
                   device=args.device)
    json.dump(res, sys.stdout, indent=1)
    print()


if __name__ == "__main__":
    main()
