// K8: blockwise causal flash attention (forward) for Hopper (sm_90a), with a
// plain C interface loaded through ctypes (see kernels/build.py).  Its
// wrapper and plain PyTorch version are in kernels/flash.py.
//
// Replaces repro/kernels/flash.py flash_attention_pallas (_flash_kernel), in
// the general form the LM layers call (repro/models/layers.py
// flash_attention without bias_qk): q (B, Sq, H, D), k/v (B, Skv, Hkv, D),
// f32 or bf16, query head h reading KV head h / (H / Hkv), and
//
//   s    = (q * scale) . k                    (f32; scale = 1 / sqrt(D) in f32)
//   mask = k_pos <= q_offset + i  and  k_pos < kv_valid
//   online softmax over key tiles: m = max(m, rowmax(s)) floored at -1e30,
//   p = exp(s - m), corr = exp(m_old - m), l = l * corr + sum(p),
//   acc = acc * corr + p . v
//   out  = acc / max(l, 1e-30), rounded once to q's dtype.
//
// A masked entry has s = -inf and contributes exactly 0, as in the jnp
// reference.  Key tiles past min(kv_valid, q_offset + last row + 1) are
// skipped: a fully masked tile leaves m, l and acc unchanged.  expf (not
// __expf) and -fmad=false keep the softmax arithmetic as the reference
// writes it; the two dot products accumulate with explicit fmaf in key and
// feature order, so they round differently from XLA's dot (within the
// tolerances stated in the tests).
//
// Design.  The H / Hkv = G query heads that share a KV head are put on the
// rows of one tile: row r of a block is query position r / G, head
// hkv * G + r % G.  So one K/V tile in shared memory serves G heads, and a
// decode step (Sq = 1) fills G rows of an 8-row tile instead of one row of
// a 64-row tile.  One block of 128 threads (8 row groups x 16 lanes) per
// (row tile, KV head, batch):
//   * the Q tile (q * scale, f32) is staged once, transposed ([D][rows]);
//   * each 64-key tile of K (transposed, [D][64]) and V ([64][D]) is staged
//     in f32 through shared memory;
//   * S = Q K^T in registers, a thread owning RPT rows x 4 keys;
//   * the online softmax per row in registers, the row max and sum reduced
//     over the row's 16 lanes by shuffles;
//   * acc += P V, a thread owning RPT rows x D/16 columns; P moves between
//     lanes by shuffles, never through memory.
// Only the output returns to device memory.  Row tiles are issued heaviest
// first (causal rows near the end see the most keys).
//
// What bounds it: for prefill, f32 operations on the CUDA cores (4 D per
// (query, valid key) pair: the QK and PV products); for decode, the bytes
// of the KV cache.  This first design uses no tensor cores, no TMA and no
// asynchronous copies: loads and compute of a tile alternate, with two
// blocks on an SM overlapping each other.  wgmma with bf16 operands is the
// redesign that the tensor-core bound in PERF.md points to.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // 8 row groups x 16 lanes
constexpr int kBK = 64;         // keys per tile
constexpr float kFloor = -1e30f;

__device__ __forceinline__ void load_chunk(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}

// 8 bf16 values: a bf16 is the high half of the f32 with the same bits.
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p, float* o) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store_val(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_val(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Column `cc` of the COLS = D / 16 output columns lane `tx` owns: float4
// groups 64 apart for D >= 64, a contiguous run below.
template <int D>
__device__ __forceinline__ int col_of(int tx, int cc) {
  constexpr int COLS = D / 16;
  if constexpr (D >= 64) return (cc / 4) * 64 + tx * 4 + (cc % 4);
  return tx * COLS + cc;
}

template <typename T, int D, int RPT>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int Sq, int Skv,
             int H, int Hkv, int G, int q_offset, int kv_valid,
             float scale) {
  constexpr int BR = 8 * RPT;              // rows a block
  constexpr int VEC = 16 / sizeof(T);      // values a 16-byte load
  constexpr int NCH = D / VEC;             // 16-byte chunks a row
  constexpr int COLS = D / 16;             // output columns a lane
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);   // [D][BR], q * scale
  float* sK = sQ + D * BR;                        // [D][kBK]
  float* sV = sK + D * kBK;                       // [kBK][D]

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15, lane = tid & 31;
  const int hkv = blockIdx.y, b = blockIdx.z;
  const int rows = Sq * G;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BR;

  for (int idx = tid; idx < BR * NCH; idx += kThreads) {
    const int r = idx % BR, ch = idx / BR, rr = r0 + r;
    float f[VEC];
    if (rr < rows) {
      const int i = rr / G, g = rr % G;
      load_chunk(q + ((static_cast<size_t>(b) * Sq + i) * H + hkv * G + g) *
                         D + ch * VEC, f);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      sQ[(ch * VEC + e) * BR + r] = __fmul_rn(f[e], scale);
  }

  float m[RPT], l[RPT], acc[RPT][COLS];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    m[r] = kFloor;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[r][c] = 0.0f;
  }

  const int i_last = (min(r0 + BR, rows) - 1) / G;
  const int kend = max(0, min(kv_valid, q_offset + i_last + 1));
  const int ntiles = (kend + kBK - 1) / kBK;
  const size_t kv_row = static_cast<size_t>(Hkv) * D;
  const T* kb = k + static_cast<size_t>(b) * Skv * kv_row + hkv * D;
  const T* vb = v + static_cast<size_t>(b) * Skv * kv_row + hkv * D;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();                 // the previous tile's reads are done
    for (int idx = tid; idx < kBK * NCH; idx += kThreads) {
      const int j = idx % kBK, ch = idx / kBK;
      float f[VEC];
      if (k0 + j < Skv) {
        load_chunk(kb + (k0 + j) * kv_row + ch * VEC, f);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) f[e] = 0.0f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) sK[(ch * VEC + e) * kBK + j] = f[e];
    }
    for (int idx = tid; idx < kBK * NCH; idx += kThreads) {
      const int j = idx / NCH, ch = idx % NCH;
      float f[VEC];
      if (k0 + j < Skv) {
        load_chunk(vb + (k0 + j) * kv_row + ch * VEC, f);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) f[e] = 0.0f;
      }
      float4* dst = reinterpret_cast<float4*>(sV + j * D + ch * VEC);
#pragma unroll
      for (int e = 0; e < VEC / 4; ++e)
        dst[e] = make_float4(f[4 * e], f[4 * e + 1], f[4 * e + 2],
                             f[4 * e + 3]);
    }
    __syncthreads();

    // S = (q * scale) K^T: rows ty * RPT + r, keys tx * 4 + c
    float s[RPT][4];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RPT];
      if constexpr (RPT % 4 == 0) {
#pragma unroll
        for (int g4 = 0; g4 < RPT / 4; ++g4) {
          const float4 t4 = *reinterpret_cast<const float4*>(
              sQ + d * BR + ty * RPT + 4 * g4);
          qv[4 * g4] = t4.x; qv[4 * g4 + 1] = t4.y;
          qv[4 * g4 + 2] = t4.z; qv[4 * g4 + 3] = t4.w;
        }
      } else {
#pragma unroll
        for (int r = 0; r < RPT; ++r) qv[r] = sQ[d * BR + ty * RPT + r];
      }
      const float4 k4 =
          *reinterpret_cast<const float4*>(sK + d * kBK + tx * 4);
      const float kv4[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          s[r][c] = __fmaf_rn(qv[r], kv4[c], s[r][c]);
    }

    // mask and online softmax, one row at a time (16 lanes a row)
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int q_pos = q_offset + (r0 + ty * RPT + r) / G;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = k0 + tx * 4 + c;
        if (!(kp <= q_pos && kp < kv_valid)) s[r][c] = -INFINITY;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(fmaxf(m[r], mx), kFloor);
      const float corr = expf(__fsub_rn(m[r], m_new));
      float ps = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = expf(__fsub_rn(s[r][c], m_new));    // -inf -> 0
        ps = __fadd_rn(ps, s[r][c]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        ps = __fadd_rn(ps, __shfl_xor_sync(0xffffffffu, ps, o));
      l[r] = __fadd_rn(__fmul_rn(l[r], corr), ps);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < COLS; ++c) acc[r][c] = __fmul_rn(acc[r][c], corr);
    }

    // acc += P V: p of key 4 jj + c lives in lane jj of this half-warp
#pragma unroll 2
    for (int jj = 0; jj < kBK / 4; ++jj) {
      const int src = (lane & 16) | jj;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = jj * 4 + c;
        float pj[RPT];
#pragma unroll
        for (int r = 0; r < RPT; ++r)
          pj[r] = __shfl_sync(0xffffffffu, s[r][c], src);
        float vv[COLS];
        if constexpr (D >= 64) {
#pragma unroll
          for (int g4 = 0; g4 < D / 64; ++g4) {
            const float4 t4 = *reinterpret_cast<const float4*>(
                sV + j * D + g4 * 64 + tx * 4);
            vv[4 * g4] = t4.x; vv[4 * g4 + 1] = t4.y;
            vv[4 * g4 + 2] = t4.z; vv[4 * g4 + 3] = t4.w;
          }
        } else {
#pragma unroll
          for (int cc = 0; cc < COLS; ++cc) vv[cc] = sV[j * D + tx * COLS + cc];
        }
#pragma unroll
        for (int r = 0; r < RPT; ++r)
#pragma unroll
          for (int cc = 0; cc < COLS; ++cc)
            acc[r][cc] = __fmaf_rn(pj[r], vv[cc], acc[r][cc]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int rr = r0 + ty * RPT + r;
    if (rr >= rows) continue;
    const int i = rr / G, g = rr % G;
    T* dst = out + ((static_cast<size_t>(b) * Sq + i) * H + hkv * G + g) * D;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int cc = 0; cc < COLS; ++cc)
      store_val(dst + col_of<D>(tx, cc), __fdiv_rn(acc[r][cc], den));
  }
}

template <typename T, int D, int RPT>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Skv, int H, int Hkv, int q_offset, int kv_valid,
           float scale, cudaStream_t stream) {
  constexpr int BR = 8 * RPT;
  const int smem = static_cast<int>((D * BR + 2 * D * kBK) * sizeof(float));
  auto kern = flash_kernel<T, D, RPT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = H / Hkv;
  const dim3 grid((Sq * G + BR - 1) / BR, Hkv, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, H, Hkv, G,
      q_offset, kv_valid, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int RPT>
int by_dim(int D, const void* q, const void* k, const void* v, void* out,
           int B, int Sq, int Skv, int H, int Hkv, int q_offset, int kv_valid,
           float scale, cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16, RPT>(q, k, v, out, B, Sq, Skv, H, Hkv,
                                       q_offset, kv_valid, scale, st);
    case 32: return launch<T, 32, RPT>(q, k, v, out, B, Sq, Skv, H, Hkv,
                                       q_offset, kv_valid, scale, st);
    case 64: return launch<T, 64, RPT>(q, k, v, out, B, Sq, Skv, H, Hkv,
                                       q_offset, kv_valid, scale, st);
    case 128: return launch<T, 128, RPT>(q, k, v, out, B, Sq, Skv, H, Hkv,
                                         q_offset, kv_valid, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// One launch over contiguous q (B, Sq, H, D), k/v (B, Skv, Hkv, D) and out
// (B, Sq, H, D), all f32 (bf16 = 0) or all bf16 (bf16 = 1), 16-byte
// aligned, D in {16, 32, 64, 128}; `decode` picks the 8-row tile (for
// Sq * H / Hkv <= 8) over the 64-row one.  Returns the first CUDA error.
extern "C" int repro_flash(const void* q, const void* k, const void* v,
                           void* out, int B, int Sq, int Skv, int H, int Hkv,
                           int D, int q_offset, int kv_valid, int bf16,
                           int decode, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return decode ? by_dim<__nv_bfloat16, 1>(D, q, k, v, out, B, Sq, Skv, H,
                                             Hkv, q_offset, kv_valid, scale,
                                             st)
                  : by_dim<__nv_bfloat16, 8>(D, q, k, v, out, B, Sq, Skv, H,
                                             Hkv, q_offset, kv_valid, scale,
                                             st);
  }
  return decode ? by_dim<float, 1>(D, q, k, v, out, B, Sq, Skv, H, Hkv,
                                   q_offset, kv_valid, scale, st)
                : by_dim<float, 8>(D, q, k, v, out, B, Sq, Skv, H, Hkv,
                                   q_offset, kv_valid, scale, st);
}
