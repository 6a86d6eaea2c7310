// K8: blockwise causal flash attention (forward) for Hopper (sm_90a), with a
// plain C interface loaded through ctypes (see kernels/build.py).  Its
// wrapper, dispatch and plain PyTorch versions are in kernels/flash.py.
//
// Replaces repro/kernels/flash.py flash_attention_pallas (_flash_kernel), in
// the general form the LM layers call (repro/models/layers.py
// flash_attention; bias_qk in tile 4 only): q (B, Sq, H, D), k/v (B, Skv,
// Hkv, D),
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
// skipped: a fully masked tile leaves m, l and acc unchanged.  The library
// is built with -fmad=false; every fused multiply-add below is an explicit
// __fmaf_rn.
//
// Positions and the mask (tiles 1-3; tile 4 takes by-value ints, causal):
// q_offset and kv_valid arrive by value, or, where the `pos` pointer is not
// null, from device memory (int32 pos[0] = q_offset, pos[1] = kv_valid:
// the reference's traced positions, so that a call reads no host value and
// a decode step can be captured in a CUDA graph).  Every block reads them
// at its start (read_positions): kv_valid is clamped into [0, Skv], as the
// reference's masks bound it, and q_offset may be negative (a
// sequence-sharded chunk past `length`: no key is seen).  With `causal` 0
// (the TPU kernel's causal=False) every query sits past every key
// (q_offset = kUnmasked): the diagonal test and the k_pos <= q_pos test
// always pass and the keys end at kv_valid.
//
// Head dims: tiles 1 and 2 take D in {64, 80, 96, 128} and {64, 80, 96,
// 128, 256}, tile 3 any D from 1 to 256.  Each is built at a padded width
// (64 or 128 in tile 1, 64, 128 or 256 in tile 2, 16, 32, 64, 128 or 256 in
// tile 3) and keeps the columns past D zero in shared memory, so that they
// add exact zeros; global rows keep their stride D, and only D columns are
// written.
//
// Every tile puts the G = H / Hkv query heads that share a KV head on the
// rows of one tile: row r is query position r / G, head hkv * G + r % G, so
// one K/V tile serves G heads.  Four tiles, chosen by the wrapper from the
// dtype, D, the rows Sq * G and bias_qk (it raises where none applies):
//
// 1. flash_tc_kernel: bf16, D in {64, 80, 96, 128}, Sq * G > 8 (prefill).
//    At D 80 and 96, S takes D / 16 k-steps and P.V runs at N = 128 over V
//    tiles whose columns past D the TMA fills with zeros.  What
//    bounds it is the operations (4 D a (query, valid key) pair), so it
//    runs them on the tensor cores.  A block of two consumer warpgroups
//    (64 rows each, 128 rows a block) and one producer warp; row tiles are
//    issued heaviest first over the whole grid.  Q stays in shared memory
//    as bf16 (128-byte swizzle); 64-key K and V tiles arrive by TMA
//    (cp.async.bulk.tensor, zero fill past Skv) into a 3-stage ring that
//    mbarriers guard, so the next tiles load while this one computes (and
//    the first ones while the consumers load Q).  A warpgroup issues S of
//    tile t and P.V of tile t - 1 as one group, then the softmax of S(t);
//    the two warpgroups run unsynchronised, so one's softmax overlaps the
//    other's MMAs.
//      S = Q K^T: wgmma m64n64k16, Q and K from shared memory, f32
//        accumulators.  The scale goes on the f32 S, after the product:
//        bf16(q * scale) would carry 2^-9 relative error into s, while the
//        reference's f32(q) * scale . k and scale * (q . k) differ by f32
//        rounding only (the bf16 products are exact in f32).
//      Softmax in the accumulator's registers (a row lives in the 4 lanes
//        of a quad): the mask only on tiles that cross the diagonal or
//        kv_valid; p = exp2(fma(S, scale * log2(e), -m * log2(e))) by
//        ex2.approx.ftz (relative error about 2^-22; a p below 2^-126,
//        against the row maximum's 1, flushes to 0).  The folded exponent
//        carries an absolute error of a few 2^-24 |s| (the roundings of
//        scale * log2(e), m * log2(e) and the fma), a relative error of p
//        below 1e-5 for |s| < 50, far under the bf16 ulp of the output.
//      P.V with P kept above bf16: P = P_hi + P_lo, each bf16 (P_lo =
//        bf16(P - P_hi), the subtraction exact), two register-A wgmma
//        m64nDk16 against the same V tile, V read MN-major through the
//        descriptor's transpose bit.  P_hi + P_lo is within 2^-16 of P
//        (P rounded once to bf16: 2^-8, which is how SDPA misses the
//        one-ulp check); the cost is 1.5x the MMA work.  The split keeps
//        the k16 register-A layout that S's accumulator converts into.
// 2. flash_split_kernel + flash_combine_kernel: bf16, D in {64, 80, 96,
//    128, 256}, Sq * G <= 8 (decode).  What bounds it is the bytes of the
//    KV cache, and B * Hkv blocks cannot fill the card, so the keys are cut
//    into n_split runs of whole 64-key tiles (the wrapper picks n_split so
//    that B * Hkv * n_split >= 2 x the SM count): runs over the valid keys
//    [0, kend) for by-value positions; over the cache's Skv keys for
//    positions in device memory, where the launch's shape must not depend
//    on them, a run that starts at or past kend writing the empty partial
//    at once.  A block of 4
//    warps streams its run through a 2-stage cp.async ring of bf16 tiles
//    (16-byte vectors, masked keys never read), each warp with its own
//    online softmax over 16 keys of every tile on the CUDA cores (q * scale
//    staged in f32, as the reference rounds it), merged across the warps
//    at the end; it writes a partial (m, l, acc) in f32.  The combine
//    kernel: M = max m_i, out = sum acc_i e^(m_i - M) / max(sum l_i
//    e^(m_i - M), 1e-30).  A run whose keys are all masked has m = -1e30,
//    l = 0, acc = 0 and weighs 0; kv_valid = 0 gives 0.
// 3. flash_cc_kernel: f32 inputs, and bf16 at any D the other tiles do not
//    take (bf16 prefill at D 256 among them: tile 1's 128-row Q tile and
//    K/V ring would not fit shared memory there): the first design,
//    on the CUDA cores, an f32 staging of Q, K and V in shared memory and
//    explicit fmaf loops; a 64-row tile (32 rows at width 256), or an 8-row
//    one for Sq * G <= 8.  expf and f32 dots in key and feature order.
// 4. flash_bias_kernel: bias_qk given (the mLSTM's parallel form), bf16, D
//    in {64, 384}: the per-query and per-key terms added to each score.
//    Tile 1's pieces (64-key K and V tiles by TMA into an mbarrier ring, S
//    and P.V by wgmma, P in bf16 hi + lo) with the exponent taken of s - m;
//    at D = 384 the two warpgroups hold the same 64 rows and split the 384
//    output columns, each computing S itself, in three 48 KB ring slots
//    beside Q (section 4 below).
//
// Training: tiles 1, 3 and 4 take an optional `lse` pointer (f32, (B, H,
// Sq)).  Where it is not null, each block's epilogue also writes every row's
// log-sum-exp m + log(l) of its scaled (tile 4: scaled and biased) scores,
// from the m and l it holds in registers, for the backward
// (kernels/flash.py flash_attention_bwd).  Serving passes null: the main
// loop, the output and the wgmma sequence are the same either way.
//
// The kernels sum their dot products in other orders than XLA's dot, so
// they agree with the reference to f32 rounding (within the tolerances
// stated in the tests), not bit for bit.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Values ch * VEC .. + VEC - 1 of a row of dh values, zero past dh: one
// 16-byte load where the row's chunks are whole (dh a multiple of VEC, so
// that every row starts 16-byte aligned), else a value at a time.
template <typename T>
__device__ __forceinline__ void load_padded(const T* row, int ch, int dh,
                                            float* o) {
  constexpr int VEC = 16 / sizeof(T);
  if (dh % VEC == 0 && (ch + 1) * VEC <= dh) {
    load_chunk(row + ch * VEC, o);
    return;
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const int d = ch * VEC + e;
    o[e] = d < dh ? to_float(row[d]) : 0.0f;
  }
}

// A query position past every key (q_offset without the causal mask).
constexpr int kUnmasked = 1 << 30;

// The positions of a call (see the top of the file): from `pos` where it is
// not null, kv_valid clamped into [0, Skv], q_offset into [-kUnmasked,
// kUnmasked] (so that q_offset + a row stays an int), and kUnmasked without
// the causal mask.
__device__ __forceinline__ void read_positions(const int* pos, int causal,
                                               int Skv, int& q_offset,
                                               int& kv_valid) {
  if (pos != nullptr) {
    q_offset = pos[0];
    kv_valid = pos[1];
  }
  kv_valid = min(max(kv_valid, 0), Skv);
  q_offset = causal ? min(max(q_offset, -kUnmasked), kUnmasked) : kUnmasked;
}

// The bit of the current device in `done` where it is not set yet, else 0:
// a launcher sets its kernel's shared memory attribute on the first call
// on each device only, so that later calls, a stream capture's among them,
// make no attribute call.
unsigned unset_device_bit(unsigned done) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1u;
  const unsigned bit = 1u << (dev % 32);
  return (done & bit) ? 0u : bit;
}

// ===========================================================================
// 3. The CUDA-core tile (f32 at any D; bf16 where tiles 1 and 2 do not take
//    D)
// ===========================================================================
// One block of 128 threads (8 row groups x 16 lanes) per (row tile, KV
// head, batch): the Q tile (q * scale, f32) staged once, transposed; each
// 64-key tile of K (transposed) and V staged in f32; S = Q K^T in
// registers, a thread owning RPT rows x 4 keys; the online softmax per row,
// reduced over the row's 16 lanes by shuffles; acc += P V, a thread owning
// RPT rows x D/16 columns, P moving between lanes by shuffles.  D is the
// padded width (16, 32, 64, 128 or 256) and dh <= D the head dim: rows are
// dh values apart in global memory, the columns past dh are staged as 0.
constexpr int kCcThreads = 128;
constexpr int kCcBK = 64;

// Column `cc` of the COLS = D / 16 output columns lane `tx` owns: float4
// groups 64 apart for D >= 64, a contiguous run below.
template <int D>
__device__ __forceinline__ int col_of(int tx, int cc) {
  constexpr int COLS = D / 16;
  if constexpr (D >= 64) return (cc / 4) * 64 + tx * 4 + (cc % 4);
  return tx * COLS + cc;
}

template <typename T, int D, int RPT>
__global__ void __launch_bounds__(kCcThreads)
flash_cc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ out,
                float* __restrict__ lse, const int* __restrict__ pos,
                int Sq, int Skv, int H, int Hkv, int G, int dh, int q_offset,
                int kv_valid, int causal, float scale) {
  constexpr int kBK = kCcBK;
  constexpr int kThreads = kCcThreads;
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
  read_positions(pos, causal, Skv, q_offset, kv_valid);

  for (int idx = tid; idx < BR * NCH; idx += kThreads) {
    const int r = idx % BR, ch = idx / BR, rr = r0 + r;
    float f[VEC];
    if (rr < rows) {
      const int i = rr / G, g = rr % G;
      load_padded(q + ((static_cast<size_t>(b) * Sq + i) * H + hkv * G + g) *
                          dh, ch, dh, f);
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
  const size_t kv_row = static_cast<size_t>(Hkv) * dh;
  const T* kb = k + static_cast<size_t>(b) * Skv * kv_row + hkv * dh;
  const T* vb = v + static_cast<size_t>(b) * Skv * kv_row + hkv * dh;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();                 // the previous tile's reads are done
    for (int idx = tid; idx < kBK * NCH; idx += kThreads) {
      const int j = idx % kBK, ch = idx / kBK;
      float f[VEC];
      if (k0 + j < Skv) {
        load_padded(kb + (k0 + j) * kv_row, ch, dh, f);
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
        load_padded(vb + (k0 + j) * kv_row, ch, dh, f);
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
    T* dst = out + ((static_cast<size_t>(b) * Sq + i) * H + hkv * G + g) * dh;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int cc = 0; cc < COLS; ++cc)
      if (col_of<D>(tx, cc) < dh)
        store_val(dst + col_of<D>(tx, cc), __fdiv_rn(acc[r][cc], den));
    // the row's log-sum-exp, m and l being the same in its 16 lanes
    if (lse != nullptr && tx == 0)
      lse[(static_cast<size_t>(b) * H + hkv * G + g) * Sq + i] =
          __fadd_rn(m[r], logf(l[r]));
  }
}

// The arguments every tile-3 launch passes on.
struct CcArgs {
  const void *q, *k, *v;
  void* out;
  float* lse;
  const int* pos;
  int B, Sq, Skv, H, Hkv, dh, q_offset, kv_valid, causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, int RPT>
int launch_cc(const CcArgs& a) {
  constexpr int BR = 8 * RPT;
  constexpr int smem = (D * BR + 2 * D * kCcBK) * sizeof(float);
  auto kern = flash_cc_kernel<T, D, RPT>;
  static unsigned set = 0;
  if (const unsigned bit = unset_device_bit(set)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    set |= bit;
  }
  const int G = a.H / a.Hkv;
  const dim3 grid((a.Sq * G + BR - 1) / BR, a.Hkv, a.B);
  kern<<<grid, kCcThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.out), a.lse, a.pos, a.Sq,
      a.Skv, a.H, a.Hkv, G, a.dh, a.q_offset, a.kv_valid, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// Head dim 1 to 256 at the padded width 16, 32, 64, 128 or 256; the
// prefill tile's 64 rows (32 at width 256, which keeps its 64 accumulators
// a thread), or the decode tile's 8 (RPT 1).
template <typename T>
int cc_by_dim(const CcArgs& a, int decode) {
  if (a.dh < 1 || a.dh > 256) return static_cast<int>(cudaErrorInvalidValue);
  if (a.dh <= 16) return decode ? launch_cc<T, 16, 1>(a)
                                : launch_cc<T, 16, 8>(a);
  if (a.dh <= 32) return decode ? launch_cc<T, 32, 1>(a)
                                : launch_cc<T, 32, 8>(a);
  if (a.dh <= 64) return decode ? launch_cc<T, 64, 1>(a)
                                : launch_cc<T, 64, 8>(a);
  if (a.dh <= 128) return decode ? launch_cc<T, 128, 1>(a)
                                 : launch_cc<T, 128, 8>(a);
  return decode ? launch_cc<T, 256, 1>(a) : launch_cc<T, 256, 4>(a);
}

// ===========================================================================
// Hopper pieces: mbarriers, TMA, wgmma (inline PTX)
// ===========================================================================
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// One box of a 4-d tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand (layout
// type 1): start address, leading and stride byte offsets, all >> 4.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Named barrier 1 over the two consumer warpgroups (256 threads).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

// Pin registers that an asynchronous wgmma reads or writes: no access to
// them moves across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

#define K8_F8(d, i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),                \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define K8_F32(d) K8_F8(d, 0), K8_F8(d, 8), K8_F8(d, 16), K8_F8(d, 24)
#define K8_R32                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"

// d (64 x 64, f32) = [d +] A (64 x 16) B (16 x 64): A and B bf16 in shared
// memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " K8_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}"
      : K8_F32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, bf16 in registers) B (16 x 64): B bf16 in
// shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " K8_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
      : K8_F32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The same at N = 128.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}"
      : K8_F32(d), K8_F8(d, 32), K8_F8(d, 40), K8_F8(d, 48), K8_F8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The same at N = 192 (the bias tile's column slice at D = 384).
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96],
                                              const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, "
      "%71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, "
      "%85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}"
      ", {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}"
      : K8_F32(d), K8_F8(d, 32), K8_F8(d, 40), K8_F8(d, 48), K8_F8(d, 56),
        K8_F8(d, 64), K8_F8(d, 72), K8_F8(d, 80), K8_F8(d, 88)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x N, N / 2 accumulators a thread) += A B at N = 64, 128 or 192.
template <int N>
__device__ __forceinline__ void wgmma_pv(float (&o)[N / 2],
                                         const uint32_t* a, uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(o, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(o, a, db);
  else wgmma_rs_n192(o, a, db);
}

// 2^x by the special function unit (ex2.approx.ftz.f32: relative error
// about 2^-22, results below 2^-126 flushed to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x, y -> (hi, lo): bf16x2 words with x = hi.x + lo.x and y = hi.y + lo.y
// to within 2^-16 relative (the lower-indexed value in the low half).
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(__fsub_rn(x, hf.x), __fsub_rn(y, hf.y));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The Q rows r0 .. r0 + ROWS - 1 of (b, hkv) (row r: query r / G, head
// hkv * G + r % G) into sQ [D/64][ROWS][128 B], each 16-byte chunk c of row
// r at chunk c ^ (r % 8) (the 128-byte swizzle), zero past the last row and
// past the head dim dh <= D (a multiple of 8, the rows' stride in q), by the
// 256 consumer threads: every load issued before any store.
template <int D, int ROWS>
__device__ __forceinline__ void stage_q(uint8_t* sQ,
                                        const __nv_bfloat16* __restrict__ q,
                                        int tid, int r0, int rows, int b,
                                        int Sq, int H, int hkv, int G,
                                        int dh) {
  constexpr int NCH = D / 8;
  constexpr int PER = ROWS * NCH / 256;
  uint4 val[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int idx = tid + u * 256;
    const int r = idx / NCH, c = idx % NCH, rr = r0 + r;
    val[u] = make_uint4(0u, 0u, 0u, 0u);
    if (rr < rows && c * 8 < dh) {
      const int i = rr / G, g = rr % G;
      val[u] = *reinterpret_cast<const uint4*>(
          q + ((static_cast<size_t>(b) * Sq + i) * H + hkv * G + g) * dh +
          c * 8);
    }
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int idx = tid + u * 256;
    const int r = idx / NCH, c = idx % NCH;
    *reinterpret_cast<uint4*>(sQ + (c / 8) * (ROWS * 128) + r * 128 +
                              (((c % 8) ^ (r & 7)) << 4)) = val[u];
  }
}

// S (64 x 64, f32) = Q K^T over the first D columns (D / 16 k-steps),
// unscaled, by wgmma from shared memory: Q's 64 rows at q_addr in a
// [D/64][ROWS][128 B] tile, K at k_addr in [D/64][64 keys][128 B] (D/64
// rounded up), both swizzled as stage_q stores them.
template <int D, int ROWS>
__device__ __forceinline__ void wgmma_qk(float (&sc)[32], uint32_t q_addr,
                                         uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = desc_sw128(
        q_addr + (kk / 4) * (ROWS * 128) + (kk % 4) * 32, 16, 1024);
    const uint64_t db = desc_sw128(
        k_addr + (kk / 4) * (64 * 128) + (kk % 4) * 32, 16, 1024);
    wgmma_ss_n64(sc, da, db, kk > 0);
  }
}

// The epilogue of a consumer thread: its rows rA and rB = rA + 8 (absolute
// rows of (b, hkv)) hold N output columns from c0 in the accumulators o,
// their m and their partial l (summed over the quad here); out = o /
// max(l, 1e-30) in bf16 (the columns below D, the rows' stride in out), and
// where lse is not null each row's m + log(l).
template <int N>
__device__ __forceinline__ void store_rows(
    const float (&o)[N / 2], float mA, float mB, float lA, float lB,
    __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int rA, int t4,
    int c0, int rows, int b, int Sq, int H, int D, int hkv, int G) {
#pragma unroll
  for (int o_ = 1; o_ < 4; o_ <<= 1) {
    lA = __fadd_rn(lA, __shfl_xor_sync(0xffffffffu, lA, o_));
    lB = __fadd_rn(lB, __shfl_xor_sync(0xffffffffu, lB, o_));
  }
  const float dA = fmaxf(lA, 1e-30f), dB = fmaxf(lB, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int rr = rA + 8 * half;
    if (rr >= rows) continue;
    const float den = half ? dB : dA;
    const int i = rr / G, g = rr % G;
    __nv_bfloat16* dst =
        out + ((static_cast<size_t>(b) * Sq + i) * H + hkv * G + g) * D + c0;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      if (c0 + 8 * j < D)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + 2 * t4) =
            __floats2bfloat162_rn(__fdiv_rn(o[4 * j + 2 * half], den),
                                  __fdiv_rn(o[4 * j + 2 * half + 1], den));
    // the row's log-sum-exp, m and l being the same in its quad
    if (lse != nullptr && t4 == 0)
      lse[(static_cast<size_t>(b) * H + hkv * G + g) * Sq + i] =
          __fadd_rn(half ? mB : mA, logf(half ? lB : lA));
  }
}

// ===========================================================================
// 1. The tensor-core prefill tile (bf16, D in {64, 80, 96, 128}, Sq * G > 8)
// ===========================================================================
constexpr int kTcBM = 64;                 // rows a consumer warpgroup
constexpr int kTcWG = 2;                  // consumer warpgroups a block
constexpr int kTcBR = kTcBM * kTcWG;      // rows a block
constexpr int kTcBK = 64;                 // keys a tile
constexpr int kTcStages = 3;              // K/V ring
constexpr int kTcThreads = kTcWG * 128 + 32;   // + the producer warp
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct TcSmem {
  static constexpr int kQ = kTcBR * D * 2;   // the Q tile, bytes
  static constexpr int kKV = kTcBK * D * 2;  // one K or V tile, bytes
  // + 1,024 to align the base for the 128-byte swizzle
  static constexpr int kBytes = kQ + kTcStages * 2 * kKV + 1024;
};

// Shared memory layout: every operand is cut into D / 64 column blocks of
// 64 bf16 (128 bytes a row), row-major in a block, each 16-byte chunk c of
// row r at chunk c ^ (r % 8) (TMA's and wgmma's 128-byte swizzle):
//   sQ [D/64][kTcBR rows][128 B], sK and sV [stage][D/64][kTcBK keys][128 B].
// The head dim DH is D, or at D = 128 also 80 or 96: the columns past DH
// are zero (stage_q; the TMA's fill past the map's DH features), S takes
// DH / 16 k-steps and P.V all D columns, of which DH are stored.
template <int DH>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_tc_kernel(__grid_constant__ const CUtensorMap kmap,
                __grid_constant__ const CUtensorMap vmap,
                const __nv_bfloat16* __restrict__ q,
                __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                const int* __restrict__ pos, int B, int Sq, int Skv, int H,
                int Hkv, int G, int q_offset, int kv_valid, int causal,
                float scale) {
  constexpr int D = (DH + 63) / 64 * 64;
  using S = TcSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kTcStages], empty[kTcStages];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* sQ = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint8_t* sK = sQ + S::kQ;
  uint8_t* sV = sK + kTcStages * S::kKV;

  const int tid = threadIdx.x;
  const int groups = Hkv * B;
  const int ntx = gridDim.x / groups;
  const int r0 = (ntx - 1 - static_cast<int>(blockIdx.x) / groups) * kTcBR;
  const int hkv = (blockIdx.x % groups) % Hkv;
  const int b = (blockIdx.x % groups) / Hkv;
  const int rows = Sq * G;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kTcWG * 4);      // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  read_positions(pos, causal, Skv, q_offset, kv_valid);
  const int i_last = (min(r0 + kTcBR, rows) - 1) / G;
  const int kend = max(0, min(kv_valid, q_offset + i_last + 1));
  const int ntiles = (kend + kTcBK - 1) / kTcBK;

  if (tid >= kTcWG * 128) {
    // producer: one thread keeps the ring full
    if (tid == kTcWG * 128) {
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kTcStages;
        if (t >= kTcStages) mbar_wait(&empty[s], ((t / kTcStages) + 1) & 1);
        mbar_expect_tx(&full[s], 2 * S::kKV);
#pragma unroll
        for (int h = 0; h < D / 64; ++h) {
          tma_load_4d(sK + s * S::kKV + h * kTcBK * 128, &kmap, &full[s],
                      h * 64, hkv, t * kTcBK, b);
          tma_load_4d(sV + s * S::kKV + h * kTcBK * 128, &vmap, &full[s],
                      h * 64, hkv, t * kTcBK, b);
        }
      }
    }
    return;
  }

  // the Q tile while the first K/V tiles load
  stage_q<D, kTcBR>(sQ, q, tid, r0, rows, b, Sq, H, hkv, G, DH);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  consumers_sync();

  // consumers: warpgroup wg owns rows wg * 64 .. + 63 of the block; a
  // thread owns rows rA and rB = rA + 8, and of every 8 columns of an
  // accumulator the two at 2 * t4
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int rA = wg * kTcBM + warp * 16 + g8, rB = rA + 8;
  const int posA = q_offset + (r0 + rA) / G;
  const int posB = q_offset + (r0 + rB) / G;
  const int pos_lo = q_offset + (r0 + wg * kTcBM) / G;
  const float c2 = __fmul_rn(scale, kLog2e);
  const uint32_t q_addr = smem_u32(sQ) + wg * kTcBM * 128;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float mA = kFloor, mB = kFloor, lA = 0.0f, lB = 0.0f;
  uint32_t ph[16], pl[16];     // the previous tile's P, bf16 hi and lo
  float sc[32];                // this tile's S, then P

  // S(t) = Q K_t^T, unscaled, f32
  auto issue_s = [&](int t) {
    wgmma_qk<DH, kTcBR>(sc, q_addr, smem_u32(sK + (t % kTcStages) * S::kKV));
  };
  // O += P_hi(t) V_t + P_lo(t) V_t
  auto issue_pv = [&](int t) {
    const uint32_t v_addr = smem_u32(sV + (t % kTcStages) * S::kKV);
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) {
      const uint64_t dv = desc_sw128(v_addr + kk * 16 * 128, kTcBK * 128,
                                     1024);
      wgmma_pv<D>(o, ph + 4 * kk, dv);
      wgmma_pv<D>(o, pl + 4 * kk, dv);
    }
  };
  // mask and online softmax of S(t); O rescaled; P(t) into ph, pl
  auto softmax = [&](int t) {
    const int k0 = t * kTcBK;
    if (k0 + kTcBK - 1 > pos_lo || k0 + kTcBK > kv_valid) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * j + 2 * t4 + e;
          if (!(key <= posA && key < kv_valid)) sc[4 * j + e] = -INFINITY;
          if (!(key <= posB && key < kv_valid)) sc[4 * j + 2 + e] = -INFINITY;
        }
    }
    // m in the reference's units (scale * S)
    float xA = -INFINITY, xB = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      xA = fmaxf(xA, fmaxf(sc[4 * j], sc[4 * j + 1]));
      xB = fmaxf(xB, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int o_ = 1; o_ < 4; o_ <<= 1) {
      xA = fmaxf(xA, __shfl_xor_sync(0xffffffffu, xA, o_));
      xB = fmaxf(xB, __shfl_xor_sync(0xffffffffu, xB, o_));
    }
    const float nA = fmaxf(fmaxf(mA, __fmul_rn(xA, scale)), kFloor);
    const float nB = fmaxf(fmaxf(mB, __fmul_rn(xB, scale)), kFloor);
    const float corrA = ex2(__fmul_rn(__fsub_rn(mA, nA), kLog2e));
    const float corrB = ex2(__fmul_rn(__fsub_rn(mB, nB), kLog2e));
    const float bA = -__fmul_rn(nA, kLog2e), bB = -__fmul_rn(nB, kLog2e);
    mA = nA;
    mB = nB;
    float sumA = 0.0f, sumB = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * j + e] = ex2(__fmaf_rn(sc[4 * j + e], c2, bA));
        sc[4 * j + 2 + e] = ex2(__fmaf_rn(sc[4 * j + 2 + e], c2, bB));
        sumA = __fadd_rn(sumA, sc[4 * j + e]);
        sumB = __fadd_rn(sumB, sc[4 * j + 2 + e]);
      }
    }
    lA = __fadd_rn(__fmul_rn(lA, corrA), sumA);
    lB = __fadd_rn(__fmul_rn(lB, corrB), sumB);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] = __fmul_rn(o[4 * j], corrA);
      o[4 * j + 1] = __fmul_rn(o[4 * j + 1], corrA);
      o[4 * j + 2] = __fmul_rn(o[4 * j + 2], corrB);
      o[4 * j + 3] = __fmul_rn(o[4 * j + 3], corrB);
    }
    // k-step kk (keys 16 kk .. + 15) takes a0..a3 = (rA, 2 t4), (rB, 2 t4),
    // (rA, 8 + 2 t4), (rB, 8 + 2 t4): S's accumulator pairs 8 kk + 2 i, + 1
#pragma unroll
    for (int i = 0; i < 16; ++i)
      split_bf16x2(sc[2 * i], sc[2 * i + 1], ph[i], pl[i]);
  };

  // Phase t issues S(t) and P(t-1) V_(t-1) as one group, then (both
  // complete) the softmax of S(t): phase 0 only S(0), phase ntiles only
  // the last P V, so that no wgmma sits on a divergent path (ptxas would
  // serialise them).
  if (ntiles > 0) {
    mbar_wait(&full[0], 0);
    wgmma_fence();
    issue_s(0);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sc);
    softmax(0);
    for (int t = 1; t < ntiles; ++t) {
      mbar_wait(&full[t % kTcStages], (t / kTcStages) & 1);
      fence_regs(o);
      wgmma_fence();
      issue_s(t);
      issue_pv(t - 1);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sc);
      fence_regs(o);
      if (lane == 0) mbar_arrive(&empty[(t - 1) % kTcStages]);
      softmax(t);
    }
    fence_regs(o);
    wgmma_fence();
    issue_pv(ntiles - 1);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(o);
  }

  store_rows<D>(o, mA, mB, lA, lB, out, lse, r0 + rA, t4, 0, rows, b, Sq, H,
                DH, hkv, G);
}

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of k or v (B, Skv, Hkv, D) bf16: boxes of 64 features x
// one head x kTcBK keys x one batch row, 128-byte swizzle, zero past Skv.
int kv_map(CUtensorMap* map, const void* base, int B, int Skv, int Hkv,
           int D) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(Hkv),
                              static_cast<cuuint64_t>(Skv),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(Hkv) * D * 2,
                                 static_cast<cuuint64_t>(Skv) * Hkv * D * 2};
  const cuuint32_t box[4] = {64, 1, kTcBK, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The map's features are the head dim DH (a box past it is zero-filled).
template <int DH>
int launch_tc(const void* q, const void* k, const void* v, void* out,
              float* lse, const int* pos, int B, int Sq, int Skv, int H,
              int Hkv, int q_offset, int kv_valid, int causal, float scale,
              cudaStream_t stream) {
  constexpr int kBytes = TcSmem<(DH + 63) / 64 * 64>::kBytes;
  CUtensorMap kmap, vmap;
  int rc = kv_map(&kmap, k, B, Skv, Hkv, DH);
  if (rc == 0) rc = kv_map(&vmap, v, B, Skv, Hkv, DH);
  if (rc != 0) return rc;
  auto kern = flash_tc_kernel<DH>;
  static unsigned set = 0;
  if (const unsigned bit = unset_device_bit(set)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    set |= bit;
  }
  const int G = H / Hkv;
  const int ntx = (Sq * G + kTcBR - 1) / kTcBR;
  kern<<<ntx * Hkv * B, kTcThreads, kBytes, stream>>>(
      kmap, vmap, static_cast<const __nv_bfloat16*>(q),
      static_cast<__nv_bfloat16*>(out), lse, pos, B, Sq, Skv, H, Hkv, G,
      q_offset, kv_valid, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// ===========================================================================
// 2. The split-KV decode tile (bf16, D in {64, 80, 96, 128, 256},
//    Sq * G <= 8)
// ===========================================================================
constexpr int kSkThreads = 128;           // 4 warps
constexpr int kSkBK = 64;                 // keys a tile, 16 a warp

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

template <int D, int R>
struct SkSmem {
  // sq [R][D] f32, sp [4 warps][R][16] f32, sK and sV [2][kSkBK][D] bf16
  static constexpr int kFloats = R * D + 4 * R * 16;
  static constexpr int kBytes = kFloats * 4 + 2 * 2 * kSkBK * D * 2;
};

// Block (split, hkv, b) covers the 64-key tiles split * tiles_per .. +
// tiles_per - 1 of [0, kend) and writes the partial of rows 0 .. rows - 1
// at ((b * Hkv + hkv) * n_split + split) * rows + r (acc's rows dh values
// apart); a block whose first tile lies at or past kend writes the empty
// partial (m = -1e30, l = 0, acc = 0) and returns.  R >= rows (4 or 8).
// D is the padded width (64, 128 or 256) and dh <= D the head dim, a
// multiple of 8: rows are dh values apart in global memory, and the
// columns past dh are staged as 0.
template <int D, int R>
__global__ void __launch_bounds__(kSkThreads)
flash_split_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   float* __restrict__ m_part, float* __restrict__ l_part,
                   float* __restrict__ acc_part, const int* __restrict__ pos,
                   int Sq, int Skv, int H, int Hkv, int G, int dh,
                   int q_offset, int kv_valid, int causal, float scale,
                   int tiles_per) {
  constexpr int NCH = D / 8;          // 16-byte chunks a row
  constexpr int HC = NCH / 2;         // chunks a half row
  constexpr int COLS = D / 32;        // output columns a lane
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);
  float* sp = sq + R * D;
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(sp + 4 * R * 16);
  __nv_bfloat16* sV = sK + 2 * kSkBK * D;

  const int split = blockIdx.x, hkv = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rows = Sq * G;
  read_positions(pos, causal, Skv, q_offset, kv_valid);
  const int kend = max(0, min(kv_valid, q_offset + Sq));
  const int t0 = split * tiles_per;
  const int t1 = min(t0 + tiles_per, (kend + kSkBK - 1) / kSkBK);
  const size_t pbase =
      ((static_cast<size_t>(b) * Hkv + hkv) * n_split + split) * rows;
  if (t0 >= t1) {
    for (int idx = tid; idx < rows * dh; idx += kSkThreads) {
      acc_part[pbase * dh + idx] = 0.0f;
      if (idx % dh == 0) {
        m_part[pbase + idx / dh] = kFloor;
        l_part[pbase + idx / dh] = 0.0f;
      }
    }
    return;
  }

  for (int idx = tid; idx < R * D; idx += kSkThreads) {
    const int r = idx / D, d = idx % D;
    float x = 0.0f;
    if (r < rows && d < dh)
      x = __fmul_rn(__bfloat162float(
                        q[((static_cast<size_t>(b) * Sq + r / G) * H +
                           hkv * G + r % G) * dh + d]),
                    scale);
    sq[idx] = x;
  }

  const size_t kv_row = static_cast<size_t>(Hkv) * dh;
  const __nv_bfloat16* kb = k + static_cast<size_t>(b) * Skv * kv_row +
                            hkv * dh;
  const __nv_bfloat16* vb = v + static_cast<size_t>(b) * Skv * kv_row +
                            hkv * dh;
  // K rows keep chunk cg at cg ^ (key % 8): the S loop's 8 lanes of a
  // quarter-warp read 8 keys' same chunk from 8 distinct bank groups;
  // chunks past dh and keys past kend are filled with zeros, not read
  auto load = [&](int t, int st) {
    for (int idx = tid; idx < kSkBK * NCH; idx += kSkThreads) {
      const int j = idx / NCH, cg = idx % NCH, key = t * kSkBK + j;
      const bool ok = key < kend && cg * 8 < dh;
      const size_t off = ok ? key * kv_row + cg * 8 : 0;
      cp_async16(sK + (st * kSkBK + j) * D + ((cg ^ (j & 7)) * 8), kb + off,
                 ok);
      cp_async16(sV + (st * kSkBK + j) * D + cg * 8, vb + off, ok);
    }
    cp_async_commit();
  };

  float m[R], l[R], acc[R][COLS];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kFloor;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[r][c] = 0.0f;
  }
  const int jl = lane & 15, h = lane >> 4, j = warp * 16 + jl;

  if (t0 < t1) load(t0, 0);
  for (int t = t0; t < t1; ++t) {
    const int st = (t - t0) & 1;
    if (t + 1 < t1) {
      load(t + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // s = (q * scale) . k for key j: lane half h sums features h * D/2 ..
    const __nv_bfloat16* krow = sK + (st * kSkBK + j) * D;
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < HC; ++c) {
      const int cg = h * HC + c;
      float kf[8];
      load_chunk(krow + ((cg ^ (j & 7)) * 8), kf);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 qa = *reinterpret_cast<const float4*>(sq + r * D +
                                                           cg * 8);
        const float4 qb = *reinterpret_cast<const float4*>(sq + r * D +
                                                           cg * 8 + 4);
        const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) s[r] = __fmaf_rn(qv[e], kf[e], s[r]);
      }
    }
    const int key = t * kSkBK + j;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      s[r] = __fadd_rn(s[r], __shfl_xor_sync(0xffffffffu, s[r], 16));
      if (!(key <= q_offset + r / G && key < kv_valid)) s[r] = -INFINITY;
      float mx = s[r];
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(fmaxf(m[r], mx), kFloor);
      const float corr = expf(__fsub_rn(m[r], m_new));
      const float p = expf(__fsub_rn(s[r], m_new));     // -inf -> 0
      float ps = p;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        ps = __fadd_rn(ps, __shfl_xor_sync(0xffffffffu, ps, o));
      l[r] = __fadd_rn(__fmul_rn(l[r], corr), ps);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < COLS; ++c) acc[r][c] = __fmul_rn(acc[r][c], corr);
      if (lane < 16) sp[(warp * R + r) * 16 + jl] = p;
    }
    __syncwarp();

    // acc += P V over the warp's 16 keys; lane owns columns COLS * lane ..
#pragma unroll
    for (int j4 = 0; j4 < 4; ++j4) {
      float4 pr[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        pr[r] = *reinterpret_cast<const float4*>(sp + (warp * R + r) * 16 +
                                                 4 * j4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat16* vrow =
            sV + (st * kSkBK + warp * 16 + 4 * j4 + e) * D + lane * COLS;
        float vv[COLS];
        if constexpr (COLS == 8) {
          const uint4 w = *reinterpret_cast<const uint4*>(vrow);
          const unsigned ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            vv[2 * c] = __uint_as_float(ws[c] << 16);
            vv[2 * c + 1] = __uint_as_float(ws[c] & 0xffff0000u);
          }
        } else if constexpr (COLS == 4) {
          const uint2 w = *reinterpret_cast<const uint2*>(vrow);
          vv[0] = __uint_as_float(w.x << 16);
          vv[1] = __uint_as_float(w.x & 0xffff0000u);
          vv[2] = __uint_as_float(w.y << 16);
          vv[3] = __uint_as_float(w.y & 0xffff0000u);
        } else {
          const unsigned w = *reinterpret_cast<const unsigned*>(vrow);
          vv[0] = __uint_as_float(w << 16);
          vv[1] = __uint_as_float(w & 0xffff0000u);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float pe = e == 0 ? pr[r].x : e == 1 ? pr[r].y
                         : e == 2 ? pr[r].z : pr[r].w;
#pragma unroll
          for (int c = 0; c < COLS; ++c)
            acc[r][c] = __fmaf_rn(pe, vv[c], acc[r][c]);
        }
      }
    }
    __syncthreads();       // stage st and sp are free for the next tile
  }

  // merge the four warps' states into the block's partial
  float* mw = reinterpret_cast<float*>(sK);     // [4][R]
  float* lw = mw + 4 * R;                       // [4][R]
  float* aw = lw + 4 * R;                       // [4][R][D]
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (lane == 0) {
      mw[warp * R + r] = m[r];
      lw[warp * R + r] = l[r];
    }
#pragma unroll
    for (int c = 0; c < COLS; ++c)
      aw[(warp * R + r) * D + lane * COLS + c] = acc[r][c];
  }
  __syncthreads();
  for (int idx = tid; idx < rows * dh; idx += kSkThreads) {
    const int r = idx / dh, d = idx % dh;
    float M = mw[r];
#pragma unroll
    for (int w = 1; w < 4; ++w) M = fmaxf(M, mw[w * R + r]);
    float L = 0.0f, A = 0.0f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float e = expf(__fsub_rn(mw[w * R + r], M));
      L = __fadd_rn(L, __fmul_rn(lw[w * R + r], e));
      A = __fadd_rn(A, __fmul_rn(aw[(w * R + r) * D + d], e));
    }
    acc_part[(pbase + r) * dh + d] = A;
    if (d == 0) {
      m_part[pbase + r] = M;
      l_part[pbase + r] = L;
    }
  }
}

// The n_split partials of (b, hkv, r) combined: M = max_i m_i, L = sum_i
// l_i e^(m_i - M), ACC = sum_i acc_i e^(m_i - M).  Block (hkv, b, r),
// thread d.  Normalised (kPartial false): out[b, r / G, hkv * G + r % G,
// d] = ACC / max(L, 1e-30), rounded once to bf16.  Unnormalised
// (kPartial true, K8's return_partial form, repro/models/layers.py:163-164,
// the partial each position of a sequence-sharded decode combines with
// the others): no division, M, L at m_out / l_out[(b * H + h) * Sq + i]
// and ACC at acc_out[((b * H + h) * Sq + i) * D + d] with h = hkv * G +
// r % G and i = r / G (the reference's (B, H, Sq) and (B, H, Sq, D)
// layout); a query whose runs see no key keeps M = -1e30, L = 0, ACC = 0.
template <bool kPartial>
__global__ void __launch_bounds__(128)
flash_combine_kernel(const float* __restrict__ m_part,
                     const float* __restrict__ l_part,
                     const float* __restrict__ acc_part,
                     __nv_bfloat16* __restrict__ out,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     float* __restrict__ acc_out, int Sq, int H, int Hkv,
                     int G, int D, int n_split) {
  const int hkv = blockIdx.x, b = blockIdx.y, r = blockIdx.z;
  const int rows = Sq * G;
  const size_t base =
      (static_cast<size_t>(b) * Hkv + hkv) * n_split * rows + r;
  float M = kFloor;
  for (int i = 0; i < n_split; ++i)
    M = fmaxf(M, m_part[base + static_cast<size_t>(i) * rows]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float L = 0.0f, A = 0.0f;
    for (int i = 0; i < n_split; ++i) {
      const size_t p = base + static_cast<size_t>(i) * rows;
      const float e = expf(__fsub_rn(m_part[p], M));
      L = __fadd_rn(L, __fmul_rn(l_part[p], e));
      A = __fadd_rn(A, __fmul_rn(acc_part[p * D + d], e));
    }
    if constexpr (kPartial) {
      const size_t row =
          (static_cast<size_t>(b) * H + hkv * G + r % G) * Sq + r / G;
      acc_out[row * D + d] = A;
      if (d == 0) {
        m_out[row] = M;
        l_out[row] = L;
      }
    } else {
      out[((static_cast<size_t>(b) * Sq + r / G) * H + hkv * G + r % G) *
              D + d] = __float2bfloat16_rn(__fdiv_rn(A, fmaxf(L, 1e-30f)));
    }
  }
}

// The arguments every split-KV launch passes on.
struct SplitArgs {
  const void *q, *k, *v;
  float *m_part, *l_part, *acc_part;
  const int* pos;
  int B, Sq, Skv, H, Hkv, dh, q_offset, kv_valid, causal;
  float scale;
  int n_split, tiles_per;
  cudaStream_t stream;
};

template <int D, int R>
int launch_split(const SplitArgs& a) {
  constexpr int smem = SkSmem<D, R>::kBytes;
  auto kern = flash_split_kernel<D, R>;
  static unsigned set = 0;
  if (const unsigned bit = unset_device_bit(set)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    set |= bit;
  }
  const dim3 grid(a.n_split, a.Hkv, a.B);
  kern<<<grid, kSkThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), a.m_part, a.l_part, a.acc_part,
      a.pos, a.Sq, a.Skv, a.H, a.Hkv, a.H / a.Hkv, a.dh, a.q_offset,
      a.kv_valid, a.causal, a.scale, a.tiles_per);
  return static_cast<int>(cudaGetLastError());
}

// ===========================================================================
// 4. The bias tile (bf16, D in {64, 384}): the mLSTM's parallel form
// ===========================================================================
// flash_attention(..., bias_qk=(fq, fk)) of repro/models/layers.py, which
// repro/models/xlstm.py mlstm_block calls with fq = F_t and fk = i_s - F_s
// (f32, (B, Sq, H) and (B, Skv, H)):
//
//   s = (scale * (q . k) + fq[b, i, h]) + fk[b, j, h]
//
// the two additions in that order, each an f32 rounding, then the mask and
// the online softmax of the other tiles.  The two bias terms reach +-1.4e3
// at S = 2,048 and cancel, so each score keeps its f32 roundings: the dot
// product of the bf16 inputs is exact product by product and summed in f32
// by the tensor cores, scaled after the product (as in tile 1: the
// reference's f32(q) * scale . k differs from it by f32 rounding only),
// then the two bias terms added one at a time.  Tile 1's folded exponent
// (its error bound holds for |s| < 50) is not taken: s - m is rounded
// first, then p = ex2(f32(s - m) * log2(e)), a relative error of p below
// 6e-6 over the range where p is not 0.  xlstm-125m's head dim is 384
// (expand 2 x d_model 768 / 4 heads), the reduced configs' 64.
//
// What bounds it: 4 D operations a (query, valid key) pair on the bf16
// tensor cores, 0.052 ms at xlstm's prefill shape.  The design is tile 1's
// (its TMA, mbarrier and wgmma pieces): a block of two consumer warpgroups
// and a producer warpgroup (one warp loads; setmaxnreg moves its registers
// to the consumers), row tiles issued heaviest first.
//   K and V: 64-key tiles by TMA (the 4-d maps of kv_map, zero fill past
//     Skv, 128-byte swizzle) into a ring of slots that K(t) and V(t) take
//     in turn (item n = 2 t or 2 t + 1 in slot n % kSlots), each slot
//     guarded by a full and an empty mbarrier.  With K(t) the producer warp
//     also stages the tile's fk for the block's G heads by plain loads:
//     G floats a key are under TMA's 16-byte box-row minimum at G = 1
//     (xlstm).  Q is staged once by the consumers (plain loads, swizzled
//     stores, as tile 1).
//   S = Q K^T by wgmma m64n64k16 from shared memory (D / 16 k-steps); the
//     scale on the f32 accumulator, then fq and fk added in the
//     accumulator's quad layout, then the mask.
//   P.V by register-A wgmma with P = P_hi + P_lo (bf16 each, two MMAs
//     against the same V tile), V read MN-major through the descriptor's
//     transpose bit.
//   A warpgroup runs S(t), the softmax of S(t) and P(t).V(t) in turn,
//     waiting on each; the two warpgroups run unsynchronised, so one's
//     softmax overlaps the other's MMAs.  A K slot is released once its fk
//     is read, a V slot once its P.V is done.
// At D = 384 a row's output is 384 f32, 192 registers a thread for one
// warpgroup: the two warpgroups hold the same 64 rows, each its 192 output
// columns (wgmma m64n192k16, 96 accumulators a thread), and each computes
// the rows' S itself: 8 D operations a pair, twice the bound (0.104 ms at
// xlstm's shape), and nothing passes between them.  Shared memory at D =
// 384: Q 48 KB, a 64-key K or V tile 48 KB, so a two-stage K + V ring (192
// KB) beside Q does not fit the 232,448 bytes; three slots do (K, V, K in
// flight: 192 KB in all).  64-key tiles were taken over 32-key tiles in
// three full stages (also 192 KB): at 32 keys S's wgmma is m64n32k16,
// which reads 3 KB of shared memory for 16 cycles of MMA, above the SM's
// 128 bytes a cycle; at 64 keys 4 KB for 32 cycles.  Each load has about
// one tile's compute to land: K(t + 1) is issued once P(t - 1).V(t - 1)
// frees its slot, V(t + 1) once S(t)'s fk is read.  At D = 64 each
// warpgroup owns 64 rows of its own (128 a block, as tile 1) over six
// slots.
constexpr int kBiasBK = kTcBK;              // keys a tile (kv_map's box)
// Two consumer warpgroups and a producer warpgroup, one warp of which
// loads.  A block of 384 threads gets 168 registers a thread (65,536 over
// 12 warps in units of 4), and dh 384's consumers need more (96 output
// accumulators and S's 32): the producer gives them up by setmaxnreg, 40
// left to it and 232 to each consumer thread, (168 - 40) x 128 = (232 -
// 168) x 256 registers.
constexpr int kBiasThreads = (kTcWG + 1) * 128;
constexpr int kBiasProducerRegs = 40;
constexpr int kBiasConsumerRegs = 232;

template <int D>
struct BiasTile {
  static constexpr int kSlices = D > 128 ? 2 : 1;     // warpgroups a row
  static constexpr int kRows = kTcBM * kTcWG / kSlices;   // rows a block
  static constexpr int kCols = D / kSlices;   // output columns a warpgroup
  static constexpr int kSlots = D > 128 ? 3 : 6;      // K / V ring slots
  static constexpr int kQBytes = kRows * D * 2;
  static constexpr int kTileBytes = kBiasBK * D * 2;  // one K or V tile
  // + 1,024 to align the base for the 128-byte swizzle; the ring's full
  // and empty mbarriers after the tiles, then fk (kSlots x G x kBiasBK f32)
  static constexpr int kFixedBytes =
      1024 + kQBytes + kSlots * kTileBytes + 2 * kSlots * 8;
};

// Shared memory: sQ [D/64][kRows][128 B] and every ring slot [D/64][kBiasBK
// keys][128 B] (tile 1's swizzled layout), full[kSlots], empty[kSlots],
// sFk [kSlots][G][kBiasBK].
template <int D>
__global__ void __launch_bounds__(kBiasThreads, 1)
flash_bias_kernel(__grid_constant__ const CUtensorMap kmap,
                  __grid_constant__ const CUtensorMap vmap,
                  const __nv_bfloat16* __restrict__ q,
                  const float* __restrict__ fq, const float* __restrict__ fk,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                  int B, int Sq, int Skv, int H, int Hkv, int G, int q_offset,
                  int kv_valid, float scale) {
  using T = BiasTile<D>;
  constexpr int kBK = kBiasBK, kSlots = T::kSlots;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* sQ = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint8_t* sKV = sQ + T::kQBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(sKV + kSlots * T::kTileBytes);
  uint64_t* empty = full + kSlots;
  float* sFk = reinterpret_cast<float*>(empty + kSlots);

  const int tid = threadIdx.x;
  const int groups = Hkv * B;
  const int ntx = gridDim.x / groups;
  const int r0 = (ntx - 1 - static_cast<int>(blockIdx.x) / groups) * T::kRows;
  const int hkv = (blockIdx.x % groups) % Hkv;
  const int b = (blockIdx.x % groups) / Hkv;
  const int rows = Sq * G;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(&full[s], 32);              // the producer warp's lanes
      mbar_init(&empty[s], kTcWG * 4);      // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int i_last = (min(r0 + T::kRows, rows) - 1) / G;
  const int kend = max(0, min(kv_valid, q_offset + i_last + 1));
  const int ntiles = (kend + kBK - 1) / kBK;

  if (tid >= kTcWG * 128) {
    // producer warpgroup: its first warp loads, lane 0 issuing the TMA
    // boxes of item n, lanes 1-31 staging a K item's fk; all 32 arrive on
    // the slot's full barrier
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;"
                 :: "n"(kBiasProducerRegs));
    if (tid >= kTcWG * 128 + 32) return;
    const int lane = tid % 32;
    for (int n = 0; n < 2 * ntiles; ++n) {
      const int s = n % kSlots, t = n / 2;
      if (n >= kSlots) mbar_wait(&empty[s], ((n / kSlots) + 1) & 1);
      if (lane == 0) {
        mbar_expect_tx(&full[s], T::kTileBytes);
        uint8_t* dst = sKV + s * T::kTileBytes;
#pragma unroll
        for (int h = 0; h < D / 64; ++h) {
          if (n % 2 == 0)
            tma_load_4d(dst + h * kBK * 128, &kmap, &full[s], h * 64, hkv,
                        t * kBK, b);
          else
            tma_load_4d(dst + h * kBK * 128, &vmap, &full[s], h * 64, hkv,
                        t * kBK, b);
        }
      } else {
        if (n % 2 == 0) {
          float* dst = sFk + s * G * kBK;
          for (int idx = lane - 1; idx < G * kBK; idx += 31) {
            const int j = idx / G, g = idx % G, kp = t * kBK + j;
            dst[g * kBK + j] =
                kp < Skv ? fk[(static_cast<size_t>(b) * Skv + kp) * H +
                              hkv * G + g]
                         : 0.0f;
          }
        }
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;"
               :: "n"(kBiasConsumerRegs));
  stage_q<D, T::kRows>(sQ, q, tid, r0, rows, b, Sq, H, hkv, G, D);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  consumers_sync();

  // consumers: warpgroup wg holds rows row0 .. row0 + 63 of the block and
  // output columns c0 .. c0 + kCols - 1; a thread owns rows rA and rB = rA
  // + 8, and of every 8 columns of an accumulator the two at 2 * t4
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int row0 = T::kSlices == 2 ? 0 : wg * kTcBM;
  const int c0 = T::kSlices == 2 ? wg * T::kCols : 0;
  const int rA = r0 + row0 + warp * 16 + g8, rB = rA + 8;
  const int gA = rA % G, gB = rB % G;
  const int posA = q_offset + rA / G, posB = q_offset + rB / G;
  const int pos_lo = q_offset + (r0 + row0) / G;
  const float fqA = rA < rows
      ? fq[(static_cast<size_t>(b) * Sq + rA / G) * H + hkv * G + gA] : 0.0f;
  const float fqB = rB < rows
      ? fq[(static_cast<size_t>(b) * Sq + rB / G) * H + hkv * G + gB] : 0.0f;
  const uint32_t q_addr = smem_u32(sQ) + row0 * 128;
  const uint32_t kv_addr = smem_u32(sKV);

  float o[T::kCols / 2];
#pragma unroll
  for (int i = 0; i < T::kCols / 2; ++i) o[i] = 0.0f;
  float mA = kFloor, mB = kFloor, lA = 0.0f, lB = 0.0f;
  uint32_t ph[16], pl[16];     // P of this tile, bf16 hi and lo
  float sc[32];                // S of this tile, then P

  // S(t) = Q K_t^T, unscaled, f32
  auto issue_s = [&](int s) {
    wgmma_qk<D, T::kRows>(sc, q_addr, kv_addr + s * T::kTileBytes);
  };
  // O += P_hi(t) V_t + P_lo(t) V_t over the warpgroup's columns
  auto issue_pv = [&](int s) {
    const uint32_t v_addr =
        kv_addr + s * T::kTileBytes + (c0 / 64) * (kBK * 128);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t dv = desc_sw128(v_addr + kk * 16 * 128, kBK * 128,
                                     1024);
      wgmma_pv<T::kCols>(o, ph + 4 * kk, dv);
      wgmma_pv<T::kCols>(o, pl + 4 * kk, dv);
    }
  };
  // the scores of S(t) (scale, fq, fk), its K slot released, the mask and
  // the online softmax; O rescaled; P(t) into ph, pl
  auto softmax = [&](int t, int s) {
    const int k0 = t * kBK;
    const float* fkA = sFk + (s * G + gA) * kBK + 2 * t4;
    const float* fkB = sFk + (s * G + gB) * kBK + 2 * t4;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * j + e] = __fadd_rn(
            __fadd_rn(__fmul_rn(sc[4 * j + e], scale), fqA), fkA[8 * j + e]);
        sc[4 * j + 2 + e] = __fadd_rn(
            __fadd_rn(__fmul_rn(sc[4 * j + 2 + e], scale), fqB),
            fkB[8 * j + e]);
      }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (k0 + kBK - 1 > pos_lo || k0 + kBK > kv_valid) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * j + 2 * t4 + e;
          if (!(key <= posA && key < kv_valid)) sc[4 * j + e] = -INFINITY;
          if (!(key <= posB && key < kv_valid)) sc[4 * j + 2 + e] = -INFINITY;
        }
    }
    float xA = -INFINITY, xB = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      xA = fmaxf(xA, fmaxf(sc[4 * j], sc[4 * j + 1]));
      xB = fmaxf(xB, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int o_ = 1; o_ < 4; o_ <<= 1) {
      xA = fmaxf(xA, __shfl_xor_sync(0xffffffffu, xA, o_));
      xB = fmaxf(xB, __shfl_xor_sync(0xffffffffu, xB, o_));
    }
    const float nA = fmaxf(fmaxf(mA, xA), kFloor);
    const float nB = fmaxf(fmaxf(mB, xB), kFloor);
    const float corrA = ex2(__fmul_rn(__fsub_rn(mA, nA), kLog2e));
    const float corrB = ex2(__fmul_rn(__fsub_rn(mB, nB), kLog2e));
    mA = nA;
    mB = nB;
    float sumA = 0.0f, sumB = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {        // -inf -> 0
        sc[4 * j + e] = ex2(__fmul_rn(__fsub_rn(sc[4 * j + e], nA), kLog2e));
        sc[4 * j + 2 + e] =
            ex2(__fmul_rn(__fsub_rn(sc[4 * j + 2 + e], nB), kLog2e));
        sumA = __fadd_rn(sumA, sc[4 * j + e]);
        sumB = __fadd_rn(sumB, sc[4 * j + 2 + e]);
      }
    }
    lA = __fadd_rn(__fmul_rn(lA, corrA), sumA);
    lB = __fadd_rn(__fmul_rn(lB, corrB), sumB);
#pragma unroll
    for (int j = 0; j < T::kCols / 8; ++j) {
      o[4 * j] = __fmul_rn(o[4 * j], corrA);
      o[4 * j + 1] = __fmul_rn(o[4 * j + 1], corrA);
      o[4 * j + 2] = __fmul_rn(o[4 * j + 2], corrB);
      o[4 * j + 3] = __fmul_rn(o[4 * j + 3], corrB);
    }
    // k-step kk takes S's accumulator pairs 8 kk + 2 i, + 1 (as tile 1)
#pragma unroll
    for (int i = 0; i < 16; ++i)
      split_bf16x2(sc[2 * i], sc[2 * i + 1], ph[i], pl[i]);
  };

  for (int t = 0; t < ntiles; ++t) {
    const int nk = 2 * t, nv = nk + 1;
    mbar_wait(&full[nk % kSlots], (nk / kSlots) & 1);
    wgmma_fence();
    issue_s(nk % kSlots);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sc);
    softmax(t, nk % kSlots);
    mbar_wait(&full[nv % kSlots], (nv / kSlots) & 1);
    fence_regs(o);
    wgmma_fence();
    issue_pv(nv % kSlots);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(o);
    if (lane == 0) mbar_arrive(&empty[nv % kSlots]);
  }

  // m and l are the same in both column slices: the first writes lse
  store_rows<T::kCols>(o, mA, mB, lA, lB, out, c0 == 0 ? lse : nullptr, rA,
                       t4, c0, rows, b, Sq, H, D, hkv, G);
}

// The registers a thread of flash_bias_kernel<D> starts with (-1 when the
// runtime cannot say).
template <int D>
int bias_regs() {
  cudaFuncAttributes fa;
  return cudaFuncGetAttributes(&fa, flash_bias_kernel<D>) == cudaSuccess
             ? fa.numRegs : -1;
}

template <int D>
int launch_bias(const void* q, const void* k, const void* v, const float* fq,
                const float* fk, void* out, float* lse, int B, int Sq,
                int Skv, int H, int Hkv, int q_offset, int kv_valid,
                float scale, cudaStream_t stream) {
  using T = BiasTile<D>;
  // setmaxnreg.inc waits for the registers the producer's dec frees: with
  // fewer at launch than that takes, the consumers would wait forever
  static const int regs = bias_regs<D>();
  if ((regs - kBiasProducerRegs) * 128 <
      (kBiasConsumerRegs - regs) * kTcWG * 128)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  CUtensorMap kmap, vmap;
  int rc = kv_map(&kmap, k, B, Skv, Hkv, D);
  if (rc == 0) rc = kv_map(&vmap, v, B, Skv, Hkv, D);
  if (rc != 0) return rc;
  const int G = H / Hkv;
  const int smem = T::kFixedBytes +
                   T::kSlots * G * kBiasBK * static_cast<int>(sizeof(float));
  auto kern = flash_bias_kernel<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ntx = (Sq * G + T::kRows - 1) / T::kRows;
  kern<<<ntx * Hkv * B, kBiasThreads, smem, stream>>>(
      kmap, vmap, static_cast<const __nv_bfloat16*>(q), fq, fk,
      static_cast<__nv_bfloat16*>(out), lse, B, Sq, Skv, H, Hkv, G, q_offset,
      kv_valid, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All entry points take contiguous q (B, Sq, H, D), k/v (B, Skv, Hkv, D)
// and out (B, Sq, H, D), 16-byte aligned, and return the first CUDA error
// (0 when the launch went through).

// `lse`, where not null, is f32 (B, H, Sq): each row's log-sum-exp of its
// scaled scores, m + log(l), for the backward (training passes it; serving
// passes null and the tiles write nothing more).

// `pos`, where not null, is int32 (q_offset, kv_valid) in device memory,
// read in place of the by-value q_offset and kv_valid; `causal` 0 drops the
// causal mask (the top of the file).

// The CUDA-core tile: all f32 (bf16 = 0) or all bf16 (bf16 = 1), D from 1
// to 256; `decode` picks the 8-row tile (Sq * H / Hkv <= 8).
extern "C" int repro_flash_cc(const void* q, const void* k, const void* v,
                              void* out, void* lse, const void* pos, int B,
                              int Sq, int Skv, int H, int Hkv, int D,
                              int q_offset, int kv_valid, int causal,
                              int bf16, int decode, float scale,
                              void* stream) {
  const CcArgs a{q, k, v, out, static_cast<float*>(lse),
                 static_cast<const int*>(pos), B, Sq, Skv, H, Hkv, D,
                 q_offset, kv_valid, causal, scale,
                 static_cast<cudaStream_t>(stream)};
  return bf16 ? cc_by_dim<__nv_bfloat16>(a, decode)
              : cc_by_dim<float>(a, decode);
}

// The tensor-core prefill tile: bf16, D in {64, 80, 96, 128}.
extern "C" int repro_flash_tc(const void* q, const void* k, const void* v,
                              void* out, void* lse, const void* pos, int B,
                              int Sq, int Skv, int H, int Hkv, int D,
                              int q_offset, int kv_valid, int causal,
                              float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ls = static_cast<float*>(lse);
  const int* ps = static_cast<const int*>(pos);
  switch (D) {
    case 64: return launch_tc<64>(q, k, v, out, ls, ps, B, Sq, Skv, H, Hkv,
                                  q_offset, kv_valid, causal, scale, st);
    case 80: return launch_tc<80>(q, k, v, out, ls, ps, B, Sq, Skv, H, Hkv,
                                  q_offset, kv_valid, causal, scale, st);
    case 96: return launch_tc<96>(q, k, v, out, ls, ps, B, Sq, Skv, H, Hkv,
                                  q_offset, kv_valid, causal, scale, st);
    case 128: return launch_tc<128>(q, k, v, out, ls, ps, B, Sq, Skv, H, Hkv,
                                    q_offset, kv_valid, causal, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

namespace {

// The split-KV tile's first launch (the runs' partials, laid out as
// repro_flash_decode says), by padded width and rows.
int split_runs(const SplitArgs& a) {
  const bool r4 = a.Sq * (a.H / a.Hkv) <= 4;
  if (a.dh <= 64) return r4 ? launch_split<64, 4>(a) : launch_split<64, 8>(a);
  if (a.dh <= 128)
    return r4 ? launch_split<128, 4>(a) : launch_split<128, 8>(a);
  return r4 ? launch_split<256, 4>(a) : launch_split<256, 8>(a);
}

}  // namespace

// The split-KV decode tile and its combine pass, two launches: bf16, D in
// {64, 80, 96, 128, 256}, Sq * H / Hkv <= 8.  `part` is f32 scratch of B *
// Hkv * n_split * rows * (D + 2) values: the partials m, l (B, Hkv,
// n_split, rows) and acc (B, Hkv, n_split, rows, D), block `split` of the
// first launch covering key tiles split * tiles_per .. + tiles_per - 1.
// With `out` the combine writes the normalised bf16 output (B, Sq, H, D);
// with `out` null it is the return_partial form (flash-decoding across
// positions) and writes the run-combined, unnormalised f32 m_out, l_out
// (B, H, Sq) and acc_out (B, H, Sq, D).
extern "C" int repro_flash_decode(const void* q, const void* k,
                                  const void* v, void* part, void* out,
                                  void* m_out, void* l_out, void* acc_out,
                                  const void* pos, int B, int Sq, int Skv,
                                  int H, int Hkv, int D, int q_offset,
                                  int kv_valid, int causal, float scale,
                                  int n_split, int tiles_per, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = Sq * (H / Hkv);
  if (rows > 8 || n_split < 1 ||
      (D != 64 && D != 80 && D != 96 && D != 128 && D != 256) ||
      (out == nullptr && (m_out == nullptr || l_out == nullptr ||
                          acc_out == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  float* m_part = static_cast<float*>(part);
  float* l_part = m_part + static_cast<size_t>(B) * Hkv * n_split * rows;
  float* acc_part = l_part + static_cast<size_t>(B) * Hkv * n_split * rows;
  const int rc = split_runs(SplitArgs{
      q, k, v, m_part, l_part, acc_part, static_cast<const int*>(pos), B, Sq,
      Skv, H, Hkv, D, q_offset, kv_valid, causal, scale, n_split, tiles_per,
      st});
  if (rc != 0) return rc;
  const dim3 grid(Hkv, B, rows);
  float* mo = static_cast<float*>(m_out);
  float* lo = static_cast<float*>(l_out);
  float* ao = static_cast<float*>(acc_out);
  if (out != nullptr)
    flash_combine_kernel<false><<<grid, 128, 0, st>>>(
        m_part, l_part, acc_part, static_cast<__nv_bfloat16*>(out), mo, lo,
        ao, Sq, H, Hkv, H / Hkv, D, n_split);
  else
    flash_combine_kernel<true><<<grid, 128, 0, st>>>(
        m_part, l_part, acc_part, nullptr, mo, lo, ao, Sq, H, Hkv, H / Hkv,
        D, n_split);
  return static_cast<int>(cudaGetLastError());
}

// The combine across positions: n partials of (B, H, Sq) rows, stacked as
// m and l (B, H, n, Sq) and acc (B, H, n, Sq, D), f32 and contiguous, into
// out (B, Sq, H, D) bf16: out = sum_i acc_i e^(m_i - M) / max(sum_i l_i
// e^(m_i - M), 1e-30), M = max_i m_i, rounded once.  flash_combine_kernel
// with every head its own group (Hkv = H, G = 1) and the n partials as its
// runs (the reference's pmax, two psums and division across the data
// positions, repro/models/layers.py:249-254); a launch's time at decode.
extern "C" int repro_flash_merge(const void* m, const void* l,
                                 const void* acc, void* out, int B, int Sq,
                                 int H, int D, int n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  flash_combine_kernel<false><<<dim3(H, B, Sq), 128, 0, st>>>(
      static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(acc), static_cast<__nv_bfloat16*>(out),
      nullptr, nullptr, nullptr, Sq, H, H, 1, D, n);
  return static_cast<int>(cudaGetLastError());
}

// The bias tile (the mLSTM's parallel form): bf16 q, k, v with D in {64,
// 384}, f32 fq (B, Sq, H) and fk (B, Skv, H), both contiguous; `lse` as
// above (the biased scores' log-sum-exp), or null.
extern "C" int repro_flash_bias(const void* q, const void* k, const void* v,
                                const void* fq, const void* fk, void* out,
                                void* lse, int B, int Sq, int Skv, int H,
                                int Hkv, int D, int q_offset, int kv_valid,
                                float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fqp = static_cast<const float*>(fq);
  const float* fkp = static_cast<const float*>(fk);
  float* ls = static_cast<float*>(lse);
  switch (D) {
    case 64: return launch_bias<64>(q, k, v, fqp, fkp, out, ls, B, Sq, Skv,
                                    H, Hkv, q_offset, kv_valid, scale, st);
    case 384: return launch_bias<384>(q, k, v, fqp, fkp, out, ls, B, Sq, Skv,
                                      H, Hkv, q_offset, kv_valid, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
