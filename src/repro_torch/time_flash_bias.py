"""Time K8's bias tile (``flash_bias_kernel`` of ``kernels/csrc/flash.cu``)
on one CUDA card beside other sources of the same library, at the shapes
of ``chip_smoke.py``'s paths J and K.

    PYTHONPATH=src python -m repro_torch.time_flash_bias [--seed 25]
        [--source NAME=PATH ...]

Each ``--source`` is a ``flash.cu`` with this one's C interface: an
earlier design unpacked with ``git archive``, say, or this design with one
element taken out, kept under the ignored ``build/``.  Inputs: bf16 q, k, v and the mLSTM's bias terms drawn on
the card from ``--seed`` as ``chip_smoke.py``'s first ``J_BIAS_EDGES``
case draws them (fq = F_t, fk = i_s - F_s, F the running sum of
log_sigmoid(N(0.3, 1)) forget gates, i ~ N(0, 1)) at xlstm-125m's mLSTM
shape, S 2,048, H 4, dh 384: B 4 without ``lse`` (path J's prefill) and B
8 with it (path K's training forward).  Every source's output is printed
in bf16 ulps of the magnitude (the attention of |v|) against the plain
version, then every source is timed by CUDA events in two turns, in order
and then in reverse, and the mean printed beside the two turns and the
ptxas registers and spills of its ``flash_bias_kernel`` entries.
"""
from __future__ import annotations

import argparse
import functools
import re
import subprocess

import torch

from .kernels import build
from .kernels import flash as tflash
from .models import layers as tlayers
from .time_lookup import _event_ms

SHAPES = ((4, False), (8, True))          # (B, with lse): paths J and K
S, H, DH = 2048, 4, 384


def _inputs(g, B):
    dev = g.device
    rn = lambda *shape: torch.randn(shape, generator=g, device=dev)
    q = rn(B, S, H, DH).to(torch.bfloat16)
    k = (rn(B, S, H, DH) / DH ** 0.5).to(torch.bfloat16)
    v = rn(B, S, H, DH).to(torch.bfloat16)
    f_cum = torch.cumsum(tlayers.log_sigmoid(rn(B, S, H) + 0.3), 1)
    return q, k, v, f_cum.contiguous(), (rn(B, S, H) - f_cum).contiguous()


def _ptxas(report: str) -> str:
    """The registers and spills ptxas reports for flash_bias_kernel."""
    out, mine = [], False
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            mine = "flash_bias_kernel" in m[1]
            if mine:
                out.append("D " + re.search(r"ILi(\d+)E", m[1])[1] + ":")
        elif mine and ("registers" in line or "spill" in line):
            out.append(line.split(":", 1)[-1].strip())
    return " ".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=25)
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=PATH")
    args = ap.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    sources = {"this": str(build.CSRC / "flash.cu")}
    sources.update(s.split("=", 1) for s in args.source)
    libs = build.build_sources("flash", sources)
    for name, (_, report) in libs.items():
        print(f"{name}: {_ptxas(report)}")
    g = torch.Generator(device="cuda")
    g.manual_seed(args.seed)
    orig = build.library

    def use(name):
        build.library = lambda lib: libs[name][0] if lib == "flash" else \
            orig(lib)

    try:
        for B, with_lse in SHAPES:
            q, k, v, fq, fk = _inputs(g, B)
            kw = dict(q_offset=0, bias_qk=(fq, fk))
            call = functools.partial(
                tflash.flash_attention_lse if with_lse else
                tflash.flash_attention, q, k, v, **kw)
            want = tflash.flash_attention_plain(q, k, v, **kw)
            # tracelint: ok[f32-cast](attention operands, not index keys)
            mag = tflash.flash_attention_plain(q.float(), k.float(),
                                               v.float().abs(), **kw)
            ulp = torch.exp2(torch.floor(torch.log2(
                mag.abs().clamp_min(2.0 ** -126))) - 7)
            for name in libs:
                use(name)
                got = call()[0] if with_lse else call()
                err = ((got.float() - want.float()).abs() / ulp).max()
                print(f"B {B}, lse {with_lse}: {name} - plain "
                      f"{float(err):.6f} ulps")
            del want, mag, ulp
            times = {name: [] for name in libs}
            for name in list(libs) + list(libs)[::-1]:
                use(name)
                times[name].append(_event_ms(call, 20))
            for name, ts in times.items():
                print(f"B {B}, lse {with_lse}: {name} {sum(ts) / 2:.6f} ms "
                      f"({ts[0]:.6f} / {ts[1]:.6f})")
    finally:
        build.library = orig

if __name__ == "__main__":
    main()
