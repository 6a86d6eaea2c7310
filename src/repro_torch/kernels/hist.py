"""K6: the streaming relative-frequency histogram -- wrapper, plain PyTorch
version and launch counter (the CUDA kernel is ``csrc/hist.cu``).

The semantics are those of the reference's Pallas kernel
(``repro.kernels.hist.hist_pallas``), not of its oracle
``repro.kernels.ref.hist_ref``, which divides by the span where the kernel
multiplies by its reciprocal (the two can put a key at a bin edge into
different bins).  For keys cast to f32:

    lo32     = f32(lo)
    inv_span = 1 / max(f32(hi) - lo32, 1e-30)         in f32
    bin      = clip(int32(ceil((k - lo32) * inv_span * m)) - 1, 0, m - 1)
    out      = counts * f32(1 / n)                     (f32)

Right-closed bins; keys outside [lo, hi] land in the edge bins.  The int32
conversion saturates (NaN -> 0) and the ``- 1`` wraps, as in XLA: a key so
far below ``lo`` that ``ceil`` saturates at INT32_MIN lands in the last
bin.  The division by the static length ``n`` is a multiplication by its
f32 reciprocal, as XLA rewrites it.  Counts are exact integers; the TPU
kernel's f32 accumulator agrees with them while every bin holds fewer than
2**24 keys.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.cdf import ceil_to_bin
from . import build

LAUNCHES = {"hist": 0}

MAX_BINS = 12288            # 48 KB of 32-bit shared-memory counters a block
_BLOCKS_PER_SM = 8
_THREADS = 256


def reset_launches() -> None:
    LAUNCHES["hist"] = 0


def hist_params(m: int, lo, hi, n: int) -> tuple[float, float, float]:
    """(lo32, inv_span, inv_n) as the reference computes them, in f32."""
    lo32 = np.float32(lo)
    span = np.maximum(np.float32(hi) - lo32, np.float32(1e-30))
    return (float(lo32), float(np.float32(1.0) / span),
            float(np.float32(1.0) / np.float32(n)) if n else float("inf"))


def bins_plain(keys: torch.Tensor, m: int, lo32: float,
               inv_span: float) -> torch.Tensor:
    """Bin of each f32 key, int64 (the kernel's ``bin_of``)."""
    k = keys.to(torch.float32)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=k.device)
    x = (k - f32(lo32)) * f32(inv_span)
    return ceil_to_bin(torch.ceil(x * f32(float(m))), m)


def hist_plain(keys: torch.Tensor, m: int, lo, hi) -> torch.Tensor:
    """Plain version of K6: (m,) f32 relative frequencies."""
    n = keys.shape[0]
    lo32, inv_span, inv_n = hist_params(m, lo, hi, n)
    counts = torch.bincount(bins_plain(keys, m, lo32, inv_span), minlength=m)
    return counts.to(torch.float32) * torch.tensor(
        inv_n, dtype=torch.float32, device=keys.device)


def hist(keys: torch.Tensor, m: int, lo, hi) -> torch.Tensor:
    """K6 (replaces ``repro.kernels.hist.hist_pallas``): (m,) f32 relative
    frequencies of 1-D ``keys`` (any float dtype, cast to f32) over m
    right-closed bins of [lo, hi]."""
    if keys.dim() != 1 or not keys.is_floating_point():
        raise TypeError("hist takes a 1-D float tensor of keys")
    if not 1 <= m <= MAX_BINS:
        raise ValueError(f"hist takes 1 <= m <= {MAX_BINS} bins, got {m}")
    if keys.device.type != "cuda":
        return hist_plain(keys, m, lo, hi)
    k = keys.to(torch.float32).contiguous()
    n = k.shape[0]
    lo32, inv_span, inv_n = hist_params(m, lo, hi, n)
    counts = torch.empty((m,), dtype=torch.int64, device=k.device)
    out = torch.empty((m,), dtype=torch.float32, device=k.device)
    sms = torch.cuda.get_device_properties(k.device).multi_processor_count
    blocks = max(1, min(-(-n // _THREADS), sms * _BLOCKS_PER_SM))
    with torch.cuda.device(k.device):
        rc = build.library("hist").repro_hist(
            k.data_ptr(), n, m, lo32, inv_span, inv_n, blocks,
            counts.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(k.device).cuda_stream)
    build.check(rc, "hist")
    LAUNCHES["hist"] += 1
    return out
