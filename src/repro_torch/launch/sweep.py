"""Dry-run sweep (the counterpart of ``repro.launch.sweep``): every (arch x
shape x mesh) cell as a subprocess of ``python -m
repro_torch.launch.dryrun``, with a timeout each (a cell that fails or
runs over is recorded, and the sweep goes on), resumable: existing result
JSONs are skipped.

  PYTHONPATH=src python -m repro_torch.launch.sweep --out experiments/dryrun_torch
  PYTHONPATH=src python -m repro_torch.launch.sweep --mesh single --arch qwen3-4b
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from ..configs import SHAPES, get_arch, list_archs


def cells(meshes=("single", "multi")):
    out = []
    for arch in list_archs():
        cfg = get_arch(arch)
        for shape in SHAPES.values():
            if shape.name == "long_500k" and not cfg.subquadratic:
                continue  # pure full-attention archs skip
            for mesh in meshes:
                out.append((arch, shape.name, mesh))
    for mesh in meshes:
        out.append(("index_service", "lookup_64k", mesh))
    return out


def run(out_dir: str, meshes, timeout: int, only_arch=None) -> list:
    todo = []
    for arch, shape, mesh in cells(meshes):
        if only_arch and arch != only_arch:
            continue
        path = os.path.join(out_dir, f"{arch}__{shape}__{mesh}.json")
        if os.path.exists(path):
            continue
        todo.append((arch, shape, mesh))
    print(f"[sweep] {len(todo)} cells to run")
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    results = []
    for i, (arch, shape, mesh) in enumerate(todo):
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", mesh, "--out", out_dir]
        t0 = time.time()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=timeout,
                                  env=dict(os.environ, PYTHONPATH=src))
            ok = proc.returncode == 0
            err = proc.stderr.strip().splitlines()[-1] if (
                proc.stderr and not ok) else ""
        except subprocess.TimeoutExpired:
            ok, err = False, f"timeout>{timeout}s"
        dt = time.time() - t0
        status = "ok" if ok else f"FAIL ({err[:120]})"
        print(f"[{i + 1}/{len(todo)}] {arch} {shape} {mesh}: {status} "
              f"({dt:.0f}s)", flush=True)
        results.append({"arch": arch, "shape": shape, "mesh": mesh,
                        "ok": ok, "seconds": round(dt, 1), "error": err})
        with open(os.path.join(out_dir, "_sweep_log.json"), "w") as f:
            json.dump(results, f, indent=1)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--timeout", type=int, default=2400)
    args = ap.parse_args(argv)
    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    os.makedirs(args.out, exist_ok=True)
    run(args.out, meshes, args.timeout, only_arch=args.arch)


if __name__ == "__main__":
    main()
