"""K5: per-bucket moment sums -- wrapper, plain PyTorch version and launch
counter (the CUDA kernel is ``csrc/linfit.cu``).

    S[b] = [count, Sum x, Sum y, Sum x*y, Sum x*x]      (n_buckets, 5) f32

over the keys of bucket b, for pre-scaled f32 ``x`` and ``y``.  A bucket
outside [0, n_buckets) adds nothing, as in the reference's Pallas kernel
(``repro.kernels.linfit.linfit_sums_pallas``).  Both versions form the
products in f64 and sum in f64, rounding to f32 once at the end: at least
as exact as the TPU kernel's f32 per-tile sums.
"""
from __future__ import annotations

import torch

from . import build

LAUNCHES = {"linfit": 0}

_F64 = torch.float64
_PLAIN_ROWS = 1 << 24       # keys per index_add_ of the plain version


def reset_launches() -> None:
    LAUNCHES["linfit"] = 0


def _check(x, y, buckets) -> None:
    if x.dim() != 1 or x.shape != y.shape or x.shape != buckets.shape:
        raise ValueError("linfit_sums takes x, y and buckets of one shape "
                         "(N,)")
    if len({x.device, y.device, buckets.device}) != 1:
        raise ValueError("linfit_sums inputs on several devices")
    if not (x.is_floating_point() and y.is_floating_point()) \
            or buckets.is_floating_point():
        raise TypeError("linfit_sums takes float x, y and integer buckets")


def linfit_sums_plain(x, y, buckets, n_buckets: int) -> torch.Tensor:
    """Plain version of K5: (n_buckets, 5) f32, summed in f64 in key order
    (``_PLAIN_ROWS`` keys at a time, so the (rows, 5) features stay
    bounded)."""
    _check(x, y, buckets)
    dev = x.device
    acc = torch.zeros((n_buckets + 1, 5), dtype=_F64, device=dev)
    for s in range(0, x.shape[0], _PLAIN_ROWS):
        xv = x[s:s + _PLAIN_ROWS].to(torch.float32).to(_F64)
        yv = y[s:s + _PLAIN_ROWS].to(torch.float32).to(_F64)
        b = buckets[s:s + _PLAIN_ROWS]
        ok = (b >= 0) & (b < n_buckets)
        feats = torch.stack([torch.ones_like(xv), xv, yv, xv * yv, xv * xv],
                            1)
        acc.index_add_(0, torch.where(ok, b, n_buckets).long(), feats)
    return acc[:n_buckets].to(torch.float32)


def linfit_sums(x, y, buckets, n_buckets: int) -> torch.Tensor:
    """K5 (replaces ``repro.kernels.linfit.linfit_sums_pallas``): the
    (n_buckets, 5) f32 moment sums ``[n, Sum x, Sum y, Sum xy, Sum x^2]``
    of (N,) ``x`` and ``y`` (cast to f32) per int ``buckets``."""
    _check(x, y, buckets)
    if n_buckets < 0:
        raise ValueError("n_buckets must be non-negative")
    if x.device.type != "cuda":
        return linfit_sums_plain(x, y, buckets, n_buckets)
    xf = x.to(torch.float32).contiguous()
    yf = y.to(torch.float32).contiguous()
    bk = buckets.to(torch.int32).contiguous()
    sums = torch.empty((n_buckets, 5), dtype=_F64, device=x.device)
    out = torch.empty((n_buckets, 5), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = build.library("linfit").repro_linfit_sums(
            xf.data_ptr(), yf.data_ptr(), bk.data_ptr(), xf.shape[0],
            n_buckets, sums.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "linfit")
    if xf.shape[0]:
        LAUNCHES["linfit"] += 1
    return out
