// K7: the batched Algorithm-2 histogram distance for Hopper (sm_90a), with a
// plain C interface loaded through ctypes (see kernels/build.py).  Its
// wrapper and plain PyTorch version are in kernels/ksdist.py; the two agree
// bit for bit.
//
// Replaces repro/kernels/ksdist.py ksdist_pallas (_ksdist_kernel):
//
//   d[l, p] = max( max_k (A_S[p,k] - P_T[l,k]),  max_k (A_T[l,k] - P_S[p,k]) )
//
// for L target rows (RMI leaves / RMRT level nodes) against P pool rows,
// where A = H + P are the inclusive and P the exclusive prefix tables
// (the wrapper computes the target tables; the pool tables are built once
// per pool).
//
// What bounds it on the card: every output costs 2m subtractions and 2m
// maxima over 4m table reads, and the tables are tiny (L*m + P*m floats)
// next to the L*P output.  At the pool's shapes (P ~ 1.2k, m = 64) it is
// bound by f32 operations, not by bytes.  The design keeps every operand
// out of device memory after its first read: one block per 64 x 64 output
// tile stages the four operand tiles in shared memory, 32 bins at a time,
// and each of its 256 threads keeps a 4 x 4 block of running maxima in
// registers, so each staged value is read from shared memory by 16 threads
// and from device memory once per tile.
//
// Numerics: subtraction and max are exact in f32, so the result is
// independent of order.  max propagates NaN as jnp.max / jnp.maximum do
// (fmaxf would drop it).  No padding is needed: the kernel bounds-checks
// rows, columns and bins.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;     // output tile: kTile target rows x kTile pool rows
constexpr int kChunk = 32;    // histogram bins staged per pass
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float max_nan(float acc, float v) {
  return (v > acc || v != v) ? v : acc;
}

__global__ void __launch_bounds__(kThreads)
ksdist_kernel(const float* __restrict__ ta, const float* __restrict__ tp,
              int L, const float* __restrict__ pa,
              const float* __restrict__ pp, int P, int m,
              float* __restrict__ out) {
  __shared__ float s_ta[kTile][kChunk + 1];
  __shared__ float s_tp[kTile][kChunk + 1];
  __shared__ float s_pa[kTile][kChunk + 1];
  __shared__ float s_pp[kTile][kChunk + 1];
  const int l0 = blockIdx.y * kTile;
  const int p0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  float up[4][4], dn[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      up[i][j] = -__int_as_float(0x7f800000);
      dn[i][j] = -__int_as_float(0x7f800000);
    }

  for (int k0 = 0; k0 < m; k0 += kChunk) {
    const int kw = min(kChunk, m - k0);
    for (int e = tid; e < kTile * kChunk; e += kThreads) {
      const int r = e / kChunk, c = e % kChunk;
      const bool col = c < kw;
      const int l = l0 + r, p = p0 + r;
      const size_t lo = static_cast<size_t>(l) * m + k0 + c;
      const size_t po = static_cast<size_t>(p) * m + k0 + c;
      s_ta[r][c] = (col && l < L) ? ta[lo] : 0.0f;
      s_tp[r][c] = (col && l < L) ? tp[lo] : 0.0f;
      s_pa[r][c] = (col && p < P) ? pa[po] : 0.0f;
      s_pp[r][c] = (col && p < P) ? pp[po] : 0.0f;
    }
    __syncthreads();
    for (int c = 0; c < kw; ++c) {
      float at[4], pt[4], as[4], ps[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        at[i] = s_ta[ty + 16 * i][c];
        pt[i] = s_tp[ty + 16 * i][c];
        as[i] = s_pa[tx + 16 * i][c];
        ps[i] = s_pp[tx + 16 * i][c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          up[i][j] = max_nan(up[i][j], __fsub_rn(as[j], pt[i]));
          dn[i][j] = max_nan(dn[i][j], __fsub_rn(at[i], ps[j]));
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int l = l0 + ty + 16 * i;
    if (l >= L) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + tx + 16 * j;
      if (p < P)
        out[static_cast<size_t>(l) * P + p] = max_nan(up[i][j], dn[i][j]);
    }
  }
}

}  // namespace

// Launches on the caller's stream, allocates nothing, does not synchronise,
// and returns cudaGetLastError() after the launch.  All tables row-major
// f32: ta/tp (L, m), pa/pp (P, m); out (L, P).
extern "C" int repro_ksdist(const void* ta, const void* tp, int L,
                            const void* pa, const void* pp, int P, int m,
                            void* out, void* stream) {
  dim3 grid((P + kTile - 1) / kTile, (L + kTile - 1) / kTile);
  ksdist_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ta), static_cast<const float*>(tp), L,
      static_cast<const float*>(pa), static_cast<const float*>(pp), P, m,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
