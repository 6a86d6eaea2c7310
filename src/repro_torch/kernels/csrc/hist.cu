// K6: the streaming relative-frequency histogram for Hopper (sm_90a), with a
// plain C interface loaded through ctypes (see kernels/build.py).  Its
// wrapper and plain PyTorch version are in kernels/hist.py; the two agree
// bit for bit.
//
// Replaces repro/kernels/hist.py hist_pallas (_hist_kernel): for n keys,
// cast to f32,
//
//   x   = (k - lo32) * inv_span            (inv_span = 1 / max(hi - lo, 1e-30))
//   bin = clip(int32(ceil(x * m)) - 1, 0, m - 1)
//   out = counts * (1 / n)                 (f32)
//
// with the reference's integer semantics: the conversion saturates (NaN ->
// 0) and the "- 1" wraps in int32, so a key so far below lo that ceil(x*m)
// saturates at INT32_MIN lands in the last bin, exactly as XLA computes it.
//
// What bounds it on the card: one 4-byte read per key and a few f32
// operations, so bytes (n * 4 at 3.35 TB/s).  The design keeps the counts
// out of device memory: each block owns a private shared-memory histogram
// of m 32-bit counters, walks a grid-stride range of keys, and flushes its
// counters once with 64-bit integer atomics into a global (m,) array.
// Keys pile into few bins (lognormal keys over [min, max] put ~96% in bin
// 0), and shared-memory atomics on one address serialise, so each warp
// first groups its lanes by bin with __match_any_sync and one leader lane
// adds the group's size: one shared atomic per distinct bin per warp step.
// A second tiny kernel converts the integer counts to f32 frequencies.
//
// Counting in integers makes the result exact: the TPU kernel adds counts
// in an f32 accumulator, which rounds once a bin holds 2^24 keys (the two
// agree bit for bit below that, ROADMAP queue 3).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int bin_of(float k, float lo, float inv_span,
                                      float fm, int m) {
  const float x = __fmul_rn(__fsub_rn(k, lo), inv_span);
  // cvt.rzi saturates and maps NaN to 0, as XLA's convert does; ceil has
  // already made the value integral.
  int v = __float2int_rz(ceilf(__fmul_rn(x, fm)));
  v = static_cast<int>(static_cast<unsigned>(v) - 1u);   // int32 wrap
  return min(max(v, 0), m - 1);
}

__global__ void __launch_bounds__(kThreads)
hist_kernel(const float* __restrict__ keys, long long n, int m, float lo,
            float inv_span, unsigned long long* __restrict__ counts) {
  extern __shared__ unsigned int s_hist[];
  for (int i = threadIdx.x; i < m; i += blockDim.x) s_hist[i] = 0u;
  __syncthreads();
  const float fm = static_cast<float>(m);
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // `base` is the same for every thread of the block, so every lane of a
  // warp runs each iteration and __match_any_sync sees the full warp.
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x;
       base < n; base += stride) {
    const long long i = base + threadIdx.x;
    const int b = i < n ? bin_of(__ldg(keys + i), lo, inv_span, fm, m) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    if (b >= 0 && lane == __ffs(peers) - 1)
      atomicAdd(s_hist + b, static_cast<unsigned>(__popc(peers)));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < m; i += blockDim.x)
    if (s_hist[i]) atomicAdd(counts + i,
                             static_cast<unsigned long long>(s_hist[i]));
}

__global__ void hist_finish_kernel(const unsigned long long* __restrict__ counts,
                                   int m, float inv_n, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < m) out[i] = __fmul_rn(__ull2float_rn(counts[i]), inv_n);
}

}  // namespace

// Launches on the caller's stream, allocates nothing, does not synchronise,
// and returns the first CUDA error.  keys (n,) f32; counts (m,) u64 scratch
// (zeroed here); out (m,) f32.  m <= 12288 (48 KB of shared counters).
extern "C" int repro_hist(const void* keys, long long n, int m, float lo,
                          float inv_span, float inv_n, int n_blocks,
                          void* counts, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* c = static_cast<unsigned long long*>(counts);
  cudaError_t err = cudaMemsetAsync(c, 0, sizeof(unsigned long long) * m, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  hist_kernel<<<n_blocks, kThreads, sizeof(unsigned int) * m, s>>>(
      static_cast<const float*>(keys), n, m, lo, inv_span, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  hist_finish_kernel<<<(m + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      c, m, inv_n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
