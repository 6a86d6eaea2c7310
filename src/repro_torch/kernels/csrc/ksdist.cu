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
// where A = H + P are the inclusive and P the exclusive prefix tables.  The
// pool's tables are built once per pool; the targets' come from the table
// kernel below, so a wrapper call is two launches and no host arithmetic.
//
// Table kernel (ksdist_tables_staged_kernel up to 128 bins, staged through
// shared memory so that device memory is read and written coalesced;
// ksdist_tables_kernel in place for wider rows): one thread a target row
// turns the raw (L, m) histogram (f32 or f64, rounded to f32 first) into
// A_T and P_T in the order of core/cdf.py prefix_sum, which is XLA:CPU's
// jnp.cumsum: a row of width <= 16 is summed in order; a wider one in
// zero-padded blocks of 16, each summed in order, the block totals
// prefix-summed by the same rule (recursively) and each block's exclusive
// total added to its entries.  A_T is the separate f32 add H + P_T, as the
// reference computes it, not the inclusive prefix.  The level totals live
// in the A_T row until the last pass overwrites them.
//
// Distance kernel (ksdist_kernel): what bounds it on the card is
// instructions.  Each output costs 2m subtractions and 2m maxima, and the
// tables are tiny (L*m + P*m floats) next to the L*P output.  A subtraction
// issues at 128 lanes a clock an SM, an f32 max (FMNMX) at 64, so even a
// perfect f32 loop sits near half of the FMA-counted 67 TFLOP/s bound.  One
// block per 128 x 64 output tile stages the four operand tiles in shared
// memory bin-major ([k][row]), all 64 bins of the main path at once, and
// each of its 256 threads keeps a 4 x 8 block of running maxima in
// registers, reading its 24 operands a bin in six 128-bit loads.  When the
// whole of m fits one pass and every staged value is finite, the two maxima
// a term become one three-way integer max of the f32 bit patterns (vimax3,
// a Hopper DPX instruction): with +0 as the start, the bit patterns of the
// terms above +0 order as their values, and an output that stays +0 (no
// term above it) is recomputed in f32.  Otherwise the loop takes the f32
// NaN-propagating max, the single PTX instruction max.NaN.f32.  The tile is
// written out through shared memory, so every output row is stored
// coalesced whatever P is.
//
// Numerics: subtraction and max are exact in f32, so the result does not
// depend on order.  max.NaN propagates NaN as jnp.max / jnp.maximum do
// (fmaxf would drop it); the integer path runs only on finite operands,
// whose differences are never NaN.  No padding is needed: the kernel
// bounds-checks rows, columns and bins.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// ---------------------------------------------------------------------------
// Target tables
// ---------------------------------------------------------------------------
constexpr int kBlock = 16;       // XLA's cumsum block
constexpr int kMaxLevels = 8;    // ceil(m / 16^k) <= 16 for some k < 8
constexpr int kTableThreads = 64;     // target rows a block, one a thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(double v) {
  return __double2float_rn(v);
}

// In-order local sums of src[0, w) in blocks of 16, written to dst[0, w);
// each block's total (zero padding added in order, as XLA pads) to tot[j].
// src may equal dst.  With w <= 16 this is the whole prefix of the level.
template <typename Src>
__device__ void local_sums(const Src* src, float* dst, int w, float* tot) {
  for (int j0 = 0; j0 < w; j0 += kBlock) {
    float v[kBlock];
#pragma unroll
    for (int t = 0; t < kBlock; ++t)
      v[t] = j0 + t < w ? to_f32(src[j0 + t]) : 0.0f;
    float s = v[0];
    dst[j0] = s;
#pragma unroll
    for (int t = 1; t < kBlock; ++t) {
      s = __fadd_rn(s, v[t]);
      if (j0 + t < w) dst[j0 + t] = s;
    }
    if (tot != nullptr) tot[j0 / kBlock] = s;
  }
}

// The tables of one row: x (m values, rounded to f32), a and p (m floats
// each; generic pointers, so the row may sit in device or shared memory).
template <typename T>
__device__ void row_tables(const T* x, float* a, float* p, int m) {
  // Bottom-up: level 0's local sums into p, its block totals (level 1)
  // into a[0, w1), level 1's local sums in place and its totals (level 2)
  // after them, ... until a level is at most 16 wide.
  int off[kMaxLevels], wid[kMaxLevels];
  int depth = 0;
  wid[0] = m;
  off[0] = 0;
  local_sums(x, p, m, m > kBlock ? a : nullptr);
  while (wid[depth] > kBlock) {
    const int w = (wid[depth] + kBlock - 1) / kBlock;
    const int o = depth == 0 ? 0 : off[depth] + wid[depth];
    ++depth;
    wid[depth] = w;
    off[depth] = o;
    local_sums(a + o, a + o, w, w > kBlock ? a + o + w : nullptr);
  }
  // Top-down: level d's inclusive prefix is its local sum plus the
  // exclusive prefix of level d + 1 (+0 for the first block); the deepest
  // level's local sums already are its prefix.
  for (int d = depth - 1; d >= 1; --d) {
    float* cur = a + off[d];
    const float* up = a + off[d + 1];
    for (int k = 0; k < wid[d]; ++k) {
      const int j = k / kBlock;
      cur[k] = __fadd_rn(cur[k], j == 0 ? 0.0f : up[j - 1]);
    }
  }
  // Level 0, descending so that each write lands on a slot no later entry
  // reads: P_T[k] = inc[k - 1] (P_T[0] = 0), A_T[k] = H[k] + P_T[k].
  const float* up = a + off[depth > 0 ? 1 : 0];
  for (int k = m - 1; k >= 0; --k) {
    float e = 0.0f;
    if (k > 0) {
      e = p[k - 1];
      if (depth > 0) {
        const int j = (k - 1) / kBlock;
        e = __fadd_rn(e, j == 0 ? 0.0f : up[j - 1]);
      }
    }
    p[k] = e;
    a[k] = __fadd_rn(to_f32(x[k]), e);
  }
}

// Up to kStagedBins bins: a block of kTableThreads rows is staged in shared
// memory (coalesced reads, rounded to f32 on the way), each thread builds
// its row there, and the tables go out coalesced.  Row stride m | 1 (odd),
// so the threads' rows fall in distinct banks.
constexpr int kStagedBins = 128;

__host__ __device__ constexpr int staged_stride(int m) { return m | 1; }

template <typename T>
__global__ void __launch_bounds__(kTableThreads)
ksdist_tables_staged_kernel(const T* __restrict__ h, int L, int m,
                            float* __restrict__ ta, float* __restrict__ tp) {
  extern __shared__ float s_rows[];
  const int s = staged_stride(m);
  float* s_x = s_rows;                      // [kTableThreads][s] each
  float* s_a = s_x + kTableThreads * s;
  float* s_p = s_a + kTableThreads * s;
  const int row0 = blockIdx.x * kTableThreads;
  const int rows = min(kTableThreads, L - row0);
  const size_t base = static_cast<size_t>(row0) * m;
  for (int e = threadIdx.x; e < rows * m; e += kTableThreads)
    s_x[(e / m) * s + e % m] = to_f32(h[base + e]);
  __syncthreads();
  const int r = threadIdx.x;
  if (r < rows) row_tables(s_x + r * s, s_a + r * s, s_p + r * s, m);
  __syncthreads();
  for (int e = threadIdx.x; e < rows * m; e += kTableThreads) {
    const int o = (e / m) * s + e % m;
    ta[base + e] = s_a[o];
    tp[base + e] = s_p[o];
  }
}

// Wider rows: each thread builds its row in place in device memory.
template <typename T>
__global__ void __launch_bounds__(kTableThreads)
ksdist_tables_kernel(const T* __restrict__ h, int L, int m,
                     float* __restrict__ ta, float* __restrict__ tp) {
  const int row = blockIdx.x * kTableThreads + threadIdx.x;
  if (row >= L) return;
  const size_t o = static_cast<size_t>(row) * m;
  row_tables(h + o, ta + o, tp + o, m);  // level totals in the A_T row
}

template <typename T>
int launch_tables(const T* h, int L, int m, float* ta, float* tp,
                  cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((L + kTableThreads - 1LL) / kTableThreads);
  if (blocks == 0) return 0;
  if (m <= kStagedBins) {
    const int bytes = 3 * kTableThreads * staged_stride(m) * sizeof(float);
    const cudaError_t err = cudaFuncSetAttribute(
        ksdist_tables_staged_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    ksdist_tables_staged_kernel<T><<<blocks, kTableThreads, bytes, stream>>>(
        h, L, m, ta, tp);
  } else {
    ksdist_tables_kernel<T><<<blocks, kTableThreads, 0, stream>>>(h, L, m,
                                                                  ta, tp);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Distances
// ---------------------------------------------------------------------------
constexpr int kTL = 128;       // output tile: kTL target rows x kTP pool rows
constexpr int kTP = 64;
constexpr int kRI = 4;         // register block: kRI target rows x 8 pool rows
constexpr int kThreads = kTL / kRI * (kTP / 8);
constexpr int kMinBlocks = 2;  // blocks an SM
constexpr int kKC = 64;        // bins staged a pass (all of the main path's)
constexpr int kSL = kTL + 4;   // padded shared row strides in floats (16-B
constexpr int kSP = kTP + 4;   // aligned for the 128-bit loads)
constexpr int kSO = kTP + 1;   // output tile stride
constexpr int kExpMask = 0x7f800000;

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__host__ __device__ constexpr int smem_floats(int kc) {
  return kc * 2 * (kSL + kSP) > kTL * kSO ? kc * 2 * (kSL + kSP)
                                          : kTL * kSO;
}

// Four consecutive floats of a shared row into v[0, 4).
__device__ __forceinline__ void load4(const float* src, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(src);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

// Pool row of the thread's register column j.
__device__ __forceinline__ int pool_col(int c0, int j) {
  return c0 + (j < 4 ? j : j + 28);
}

// The bins [0, kw) of the staged pass into the thread's kRI x 8 running
// maxima, its operands of a bin (A_T, P_T of its target rows, A_S, P_S of
// its pool rows) in six 128-bit loads.  kKeys: the maxima are the int32 bit
// patterns of finite terms, three at a time by vimax3; else f32 maxima
// that propagate NaN.
template <bool kKeys>
__device__ __forceinline__ void bins(float (&acc)[kRI][8], const float* s_ta,
                                     const float* s_tp, const float* s_pa,
                                     const float* s_pp, int kw, int r0,
                                     int c0) {
#pragma unroll 2
  for (int c = 0; c < kw; ++c) {
    float at[kRI], pt[kRI], as[8], ps[8];
#pragma unroll
    for (int q = 0; q < kRI; q += 4) {
      load4(s_ta + c * kSL + r0 + q, at + q);
      load4(s_tp + c * kSL + r0 + q, pt + q);
    }
    load4(s_pa + c * kSP + c0, as);
    load4(s_pa + c * kSP + c0 + 32, as + 4);
    load4(s_pp + c * kSP + c0, ps);
    load4(s_pp + c * kSP + c0 + 32, ps + 4);
#pragma unroll
    for (int i = 0; i < kRI; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float up = __fsub_rn(as[j], pt[i]);
        const float dn = __fsub_rn(at[i], ps[j]);
        if (kKeys)
          acc[i][j] = __int_as_float(__vimax3_s32(
              __float_as_int(acc[i][j]), __float_as_int(up),
              __float_as_int(dn)));
        else
          acc[i][j] = max_nan(acc[i][j], max_nan(up, dn));
      }
  }
}

__device__ __forceinline__ int nonfinite(float v) {
  return (__float_as_int(v) & kExpMask) == kExpMask;
}

// Stage bins [k0, k0 + kw) of R table rows from row0 (of n) into shared
// memory bin-major, s[c * S + r]; rows past n read row n - 1 (no branch
// around the load) and stage 0.  Returns whether a staged value is NaN or
// infinite.  vec (m a multiple of 8, the tables 16-byte aligned): 128-bit
// loads, a warp taking 16 rows x 2 float4 so that each row's 32 bytes come
// in one sector and the transposed stores hit 32 distinct banks.
template <int R, int S>
__device__ __forceinline__ int stage(const float* __restrict__ a,
                                     const float* __restrict__ t, int row0,
                                     int n, int m, int k0, int kw, int vec,
                                     float* s_a, float* s_t) {
  int special = 0;
  if (vec) {
    const int kq = kw >> 2;
#pragma unroll 4
    for (int e = threadIdx.x; e < R * kq; e += kThreads) {
      const int r = (e & 15) + 16 * (e / (16 * kq)), q = (e >> 4) % kq;
      const size_t o =
          static_cast<size_t>(min(row0 + r, n - 1)) * m + k0 + 4 * q;
      float4 va = __ldg(reinterpret_cast<const float4*>(a + o));
      float4 vt = __ldg(reinterpret_cast<const float4*>(t + o));
      if (row0 + r >= n) va = vt = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      special |= nonfinite(va.x) | nonfinite(va.y) | nonfinite(va.z) |
                 nonfinite(va.w) | nonfinite(vt.x) | nonfinite(vt.y) |
                 nonfinite(vt.z) | nonfinite(vt.w);
      float* da = s_a + 4 * q * S + r;
      float* dt = s_t + 4 * q * S + r;
      da[0] = va.x;
      da[S] = va.y;
      da[2 * S] = va.z;
      da[3 * S] = va.w;
      dt[0] = vt.x;
      dt[S] = vt.y;
      dt[2 * S] = vt.z;
      dt[3 * S] = vt.w;
    }
  } else {
    for (int e = threadIdx.x; e < R * kw; e += kThreads) {
      const int r = e / kw, c = e % kw;
      const size_t o =
          static_cast<size_t>(min(row0 + r, n - 1)) * m + k0 + c;
      float va = __ldg(a + o), vt = __ldg(t + o);
      if (row0 + r >= n) va = vt = 0.0f;
      special |= nonfinite(va) | nonfinite(vt);
      s_a[c * S + r] = va;
      s_t[c * S + r] = vt;
    }
  }
  return special;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
ksdist_kernel(const float* __restrict__ ta, const float* __restrict__ tp,
              int L, const float* __restrict__ pa,
              const float* __restrict__ pp, int P, int m, int p_tiles,
              int vec, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int kc = min(m, kKC);
  float* s_ta = smem;              // [kc][kSL]
  float* s_tp = s_ta + kc * kSL;
  float* s_pa = s_tp + kc * kSL;   // [kc][kSP]
  float* s_pp = s_pa + kc * kSP;
  const int l0 = static_cast<int>(blockIdx.x / p_tiles) * kTL;
  const int p0 = static_cast<int>(blockIdx.x % p_tiles) * kTP;
  const int tid = threadIdx.x;
  const int r0 = (tid >> 3) * kRI;  // target rows r0 .. r0 + kRI - 1
  const int c0 = (tid & 7) * 4;     // pool rows c0 .. c0 + 3, c0 + 32 .. + 35

  float acc[kRI][8];
#pragma unroll
  for (int i = 0; i < kRI; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = -__int_as_float(kExpMask);

  for (int k0 = 0; k0 < m; k0 += kc) {
    const int kw = min(kc, m - k0);
    const int special =
        stage<kTL, kSL>(ta, tp, l0, L, m, k0, kw, vec, s_ta, s_tp) |
        stage<kTP, kSP>(pa, pp, p0, P, m, k0, kw, vec, s_pa, s_pp);
    // Block-uniform: all of m in this one pass and every operand finite.
    // Then no term is NaN, and the max of the terms above +0 is the max of
    // their f32 bit patterns as int32 (a negative term's pattern is a
    // negative int), three at a time by the Hopper DPX instruction
    // vimax3, which issues once where two FMNMX would; a result of +0
    // (every term <= +0) is recomputed in f32 below.
    const bool keys = !__syncthreads_or(special) && kw == m;
    if (keys) {
#pragma unroll
      for (int i = 0; i < kRI; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
      bins<true>(acc, s_ta, s_tp, s_pa, s_pp, kw, r0, c0);
#pragma unroll
      for (int i = 0; i < kRI; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int r = r0 + i, q = pool_col(c0, j);
          if (__float_as_int(acc[i][j]) != 0 || l0 + r >= L || p0 + q >= P)
            continue;                 // above +0, or a padded row / column
          float v = -__int_as_float(kExpMask);
#pragma unroll 1
          for (int c = 0; c < kw; ++c)
            v = max_nan(v, max_nan(
                __fsub_rn(s_pa[c * kSP + q], s_tp[c * kSL + r]),
                __fsub_rn(s_ta[c * kSL + r], s_pp[c * kSP + q])));
          acc[i][j] = v;
        }
    } else {
      bins<false>(acc, s_ta, s_tp, s_pa, s_pp, kw, r0, c0);
    }
    __syncthreads();
  }

  float* s_out = smem;             // [kTL][kSO], after the last pass
#pragma unroll
  for (int i = 0; i < kRI; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      s_out[(r0 + i) * kSO + pool_col(c0, j)] = acc[i][j];
  __syncthreads();
  for (int e = tid; e < kTL * kTP; e += kThreads) {
    const int r = e / kTP, c = e % kTP, l = l0 + r, p = p0 + c;
    if (l < L && p < P)
      out[static_cast<size_t>(l) * P + p] = s_out[r * kSO + c];
  }
}

}  // namespace

// Both entry points launch on the caller's stream, allocate nothing, do not
// synchronise, and return cudaGetLastError() after the launch.

// Target tables: h (L, m) row-major f32 (is_f64 = 0) or f64 (is_f64 = 1);
// ta, tp (L, m) f32.  m >= 1.
extern "C" int repro_ksdist_tables(const void* h, int is_f64, int L, int m,
                                   void* ta, void* tp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* a = static_cast<float*>(ta);
  auto* p = static_cast<float*>(tp);
  return is_f64 ? launch_tables(static_cast<const double*>(h), L, m, a, p, s)
                : launch_tables(static_cast<const float*>(h), L, m, a, p, s);
}

// Distances: ta/tp (L, m), pa/pp (P, m) row-major f32; out (L, P).  One
// block a (kTL x kTP) tile, the pool tiles of one target tile in turn.
extern "C" int repro_ksdist(const void* ta, const void* tp, int L,
                            const void* pa, const void* pp, int P, int m,
                            void* out, void* stream) {
  const int p_tiles = static_cast<int>((P + kTP - 1LL) / kTP);
  const long long tiles = (L + kTL - 1LL) / kTL * p_tiles;
  if (tiles == 0) return 0;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = sizeof(float) * smem_floats(m < kKC ? m : kKC);
  const auto aligned = [](const void* q) {
    return (reinterpret_cast<uintptr_t>(q) & 15) == 0;
  };
  const int vec = m % 8 == 0 && aligned(ta) && aligned(tp) && aligned(pa) &&
                  aligned(pp);
  cudaError_t err = cudaFuncSetAttribute(
      ksdist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  ksdist_kernel<<<static_cast<unsigned>(tiles), kThreads, bytes,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ta), static_cast<const float*>(tp), L,
      static_cast<const float*>(pa), static_cast<const float*>(pp), P, m,
      p_tiles, vec, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
