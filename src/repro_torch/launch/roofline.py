"""Roofline aggregation over the dry run's rows (the counterpart of
``repro.launch.roofline``), with the H100's constants.

Per (arch x shape x mesh), a chip's:
  compute_s    = sum over dtypes of FLOPs / that dtype's peak
  memory_s     = bytes / HBM rate
  collective_s = collective bytes / the slowest link a group crosses
  dominant     = argmax of the three
  MODEL_FLOPS  = 6*N*D (train) | 2*N*D (prefill) | 2*N_active*B (decode)
  useful       = MODEL_FLOPS / (FLOPs a chip * chips)

Constants: NVIDIA H100 SXM5 80GB, the 700 W data sheet (dense rates).
bf16 (and f16) run on the tensor cores at 989e12 FLOP/s; f32 products at
67e12 (the train step's f32 backward GEMMs: ROADMAP queue 1b item 4); f64
at 34e12.  HBM3 3.35e12 B/s and 80e9 B a card.  Links: NVLink 4 at 450e9
B/s a direction between the 8 cards of an HGX node; a group that spans
nodes goes over one 400 Gb/s NDR NIC a card, 50e9 B/s.  Positions fill
nodes in row-major order, so every ``model`` and ``data`` group of the
production meshes (16 x 16, 2 x 16 x 16) spans nodes.

  PYTHONPATH=src python -m repro_torch.launch.roofline \\
      --dir experiments/dryrun_torch
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from ..configs import SHAPES, get_arch

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
              "float64": 34e12}
HBM_BW = 3.35e12
HBM_PER_CHIP = 80e9
NVLINK_BW = 450e9            # a direction, inside an 8-card node
NIC_BW = 50e9                # one 400 Gb/s NDR NIC a card, across nodes
NODE_CARDS = 8


def link_bw(chips: int) -> float:
    """The slowest link a group of a ``chips``-position mesh crosses:
    NVLink inside one node, the NIC once the mesh spans nodes."""
    return NVLINK_BW if chips <= NODE_CARDS else NIC_BW


def times(summary: dict, chips: int) -> dict:
    """compute_s, memory_s, collective_s and the dominant one of an
    ``OpCost`` summary (a chip's counts)."""
    compute = sum(f / PEAK_FLOPS.get(dt, PEAK_FLOPS["float32"])
                  for dt, f in summary["flops_by_dtype"].items())
    r = {"compute_s": compute, "memory_s": summary["bytes"] / HBM_BW,
         "collective_s": summary["collective_bytes"] / link_bw(chips)}
    r["dominant"] = max(("compute_s", "memory_s", "collective_s"),
                        key=lambda k: r[k])
    return r


def model_flops(arch: str, shape_name: str) -> float:
    if arch == "index_service":
        return 0.0
    cfg = get_arch(arch)
    n_active = cfg.param_count(active_only=True)
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch      # decode: 1 token/seq


def load(dir_: str) -> list[dict]:
    rows = []
    for path in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        if os.path.basename(path).startswith("_"):
            continue
        with open(path) as f:
            r = json.load(f)
        mf = model_flops(r["arch"], r.get("shape", "train_4k"))
        total = r["flops_per_chip"] * r["chips"]
        r["model_flops"] = mf
        r["useful_ratio"] = mf / total if total else 0.0
        rr = r["roofline"]
        bound = max(rr["compute_s"], rr["memory_s"], rr["collective_s"])
        # how much of the bound step time is the ideal compute time
        r["roofline_fraction"] = rr["compute_s"] / bound if bound else 0.0
        r["hbm_ok"] = r["memory"]["peak_bytes_est"] <= HBM_PER_CHIP
        rows.append(r)
    return rows


def fmt_table(rows: list[dict]) -> str:
    hdr = ("| arch | shape | mesh | compute_s | memory_s | collective_s | "
           "dominant | useful | roofline_frac | HBM GB/chip | fits |")
    sep = "|" + "---|" * 11
    out = [hdr, sep]
    for r in rows:
        rr = r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {rr['compute_s']:.3e} | {rr['memory_s']:.3e} "
            f"| {rr['collective_s']:.3e} | {rr['dominant'][:-2]} "
            f"| {r['useful_ratio']:.2f} | {r['roofline_fraction']:.2f} "
            f"| {r['memory']['peak_bytes_est']/1e9:.2f} "
            f"| {'Y' if r['hbm_ok'] else 'NO'} |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    rows = load(args.dir)
    print(fmt_table(rows))
    single = [r for r in rows if r["mesh"] == "single"
              and r["arch"] != "index_service"]
    if single:
        worst = min(single, key=lambda r: r["roofline_fraction"])
        coll = max(single, key=lambda r: r["roofline"]["collective_s"] /
                   max(sum(r["roofline"][k] for k in
                           ("compute_s", "memory_s", "collective_s")), 1e-30))
        print(f"\nworst roofline fraction: {worst['arch']} {worst['shape']} "
              f"({worst['roofline_fraction']:.2f})")
        print(f"most collective-bound:   {coll['arch']} {coll['shape']}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
