// K5: per-bucket moment sums for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (see kernels/build.py).  Its wrapper and plain
// PyTorch version are in kernels/linfit.py.
//
// Replaces repro/kernels/linfit.py linfit_sums_pallas (_linfit_kernel): for
// pre-scaled f32 x, y and int32 buckets, the (n_buckets, 5) f32 sums
//
//   S[b] = [count, Sum x, Sum y, Sum x*y, Sum x*x]
//
// over the keys of bucket b.  A bucket outside [0, n_buckets) adds nothing
// (the TPU kernel matches its one-hot against in-range columns only and
// pads with -1).
//
// What bounds it on the card: 12 bytes read per key (x, y, bucket) and a
// handful of f64 operations, so bytes (n * 12 at 3.35 TB/s).  The TPU's
// one-hot matmul has no use here.  The RMI's buckets are non-decreasing with
// hundreds of keys a bucket, so the kernel reduces runs of equal buckets
// before it touches memory: a block takes 4,096 consecutive keys, each of
// its 256 threads 16 of them read with 128-bit loads (scalar loads for a
// misaligned head or tail, or when x, y and buckets are misaligned against
// each other).  A thread sums its run of equal buckets in f64 registers and
// flushes a run that starts and ends inside it at once; the runs that cross
// thread boundaries are joined by one segmented scan over the block (a
// shuffle scan a warp, then across the warps through shared memory), and
// each run that ends inside the block, and the two cut by the block's
// edges, is added to the f64 sums by one atomicAdd a moment.  At the main
// path's ~763 keys a bucket that is about 6 buckets x 5 atomics a block;
// unsorted buckets make every key a run of its own and stay correct.
//
// Numerics: products of the f32 inputs are formed in f64 (exactly) and
// summed in f64, then rounded to f32 once by a second tiny kernel.  That is
// at least as exact as the TPU's f32 per-tile sums, and the atomic order
// changes only the f64 rounding, so kernel and f64 plain version agree to
// within one f32 ulp of each sum's magnitude.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 16;                     // keys a thread
constexpr int kChunk = kThreads * kPer;      // keys a block
constexpr int kMoments = 5;
constexpr unsigned kFull = 0xffffffffu;

// The partial moments of a run: the count as an int (a block holds at most
// 4,096 keys), the four sums in f64.
struct Run {
  int n;
  double sx, sy, sxy, sxx;
};

__device__ __forceinline__ Run zero_run() { return Run{0, 0.0, 0.0, 0.0, 0.0}; }

__device__ __forceinline__ Run key_run(float xf, float yf) {
  const double xv = static_cast<double>(xf), yv = static_cast<double>(yf);
  return Run{1, xv, yv, __dmul_rn(xv, yv), __dmul_rn(xv, xv)};
}

__device__ __forceinline__ Run join(const Run& a, const Run& b) {
  return Run{a.n + b.n, __dadd_rn(a.sx, b.sx), __dadd_rn(a.sy, b.sy),
             __dadd_rn(a.sxy, b.sxy), __dadd_rn(a.sxx, b.sxx)};
}

__device__ __forceinline__ Run shfl_up(const Run& r, int o) {
  return Run{__shfl_up_sync(kFull, r.n, o), __shfl_up_sync(kFull, r.sx, o),
             __shfl_up_sync(kFull, r.sy, o), __shfl_up_sync(kFull, r.sxy, o),
             __shfl_up_sync(kFull, r.sxx, o)};
}

__device__ __forceinline__ void flush(double* __restrict__ sums, int nb, int b,
                                      const Run& r) {
  if (b < 0 || b >= nb || r.n == 0) return;
  double* row = sums + static_cast<size_t>(b) * kMoments;
  atomicAdd(row, static_cast<double>(r.n));
  atomicAdd(row + 1, r.sx);
  atomicAdd(row + 2, r.sy);
  atomicAdd(row + 3, r.sxy);
  atomicAdd(row + 4, r.sxx);
}

// Keys are numbered from -off, so that with vec every thread's 16 keys
// start 16-byte aligned in all three arrays; keys outside [0, n) get bucket
// -1 and add nothing.
__global__ void __launch_bounds__(kThreads, 2)
linfit_kernel(const float* __restrict__ x, const float* __restrict__ y,
              const int* __restrict__ buckets, long long n, int nb, int off,
              int vec, double* __restrict__ sums) {
  __shared__ int s_head[kWarps], s_tail[kWarps], s_reset[kWarps];
  __shared__ Run s_tot[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long i0 = static_cast<long long>(blockIdx.x) * kChunk +
                       static_cast<long long>(tid) * kPer - off;

  float xs[kPer], ys[kPer];
  int bs[kPer];
  if (vec && i0 >= 0 && i0 + kPer <= n) {
#pragma unroll
    for (int q = 0; q < kPer / 4; ++q) {
      const float4 xv = __ldg(reinterpret_cast<const float4*>(x + i0) + q);
      const float4 yv = __ldg(reinterpret_cast<const float4*>(y + i0) + q);
      const int4 bv = __ldg(reinterpret_cast<const int4*>(buckets + i0) + q);
      xs[4 * q] = xv.x; xs[4 * q + 1] = xv.y;
      xs[4 * q + 2] = xv.z; xs[4 * q + 3] = xv.w;
      ys[4 * q] = yv.x; ys[4 * q + 1] = yv.y;
      ys[4 * q + 2] = yv.z; ys[4 * q + 3] = yv.w;
      bs[4 * q] = bv.x; bs[4 * q + 1] = bv.y;
      bs[4 * q + 2] = bv.z; bs[4 * q + 3] = bv.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const long long i = i0 + j;
      const bool in = i >= 0 && i < n;
      xs[j] = in ? __ldg(x + i) : 0.0f;
      ys[j] = in ? __ldg(y + i) : 0.0f;
      bs[j] = in ? __ldg(buckets + i) : -1;
    }
  }

  // The thread's own runs: the head run (its first key's), flushed by the
  // scan below when it ends inside the thread (split), whole runs flushed
  // here, and the tail run (its last key's) carried into the scan.
  const int head_b = bs[0];
  bool split = false;
  Run head = zero_run();
  Run cur = key_run(xs[0], ys[0]);
  int cur_b = head_b;
#pragma unroll
  for (int j = 1; j < kPer; ++j) {
    const Run k = key_run(xs[j], ys[j]);
    if (bs[j] == cur_b) {
      cur = join(cur, k);
    } else {
      if (split) flush(sums, nb, cur_b, cur);
      else head = cur;
      split = true;
      cur = k;
      cur_b = bs[j];
    }
  }
  const int tail_b = cur_b;

  // Neighbours' buckets across the block.
  if (lane == 0) s_head[warp] = head_b;
  if (lane == 31) s_tail[warp] = tail_b;
  __syncthreads();
  int prev_tail = __shfl_up_sync(kFull, tail_b, 1);
  int next_head = __shfl_down_sync(kFull, head_b, 1);
  if (lane == 0 && warp > 0) prev_tail = s_tail[warp - 1];
  if (lane == 31 && warp < kWarps - 1) next_head = s_head[warp + 1];
  const bool joins_prev = tid > 0 && head_b == prev_tail;
  const bool ends_here = tid == kThreads - 1 || next_head != tail_b;

  // Segmented inclusive scan of the tail runs: c = the run holding this
  // thread's last key, from its start in the block to this thread's end.
  int reset = split || !joins_prev;
  Run c = cur;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const Run u = shfl_up(c, o);
    const int ur = __shfl_up_sync(kFull, reset, o);
    if (lane >= o) {
      if (!reset) c = join(u, c);
      reset |= ur;
    }
  }
  if (lane == 31) {
    s_reset[warp] = reset;
    s_tot[warp] = c;
  }
  __syncthreads();
  Run carry = zero_run();          // the scan's value at the previous warp's end
  for (int w = 0; w < warp; ++w)
    carry = s_reset[w] ? s_tot[w] : join(carry, s_tot[w]);
  if (!reset) c = join(carry, c);
  Run before = shfl_up(c, 1);      // the previous thread's c
  if (lane == 0) before = carry;

  if (split) flush(sums, nb, head_b, joins_prev ? join(before, head) : head);
  if (ends_here) flush(sums, nb, tail_b, c);
}

__global__ void linfit_finish_kernel(const double* __restrict__ sums,
                                     long long count, float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i < count) out[i] = __double2float_rn(sums[i]);
}

}  // namespace

// Launches on the caller's stream, allocates nothing, does not synchronise,
// and returns the first CUDA error.  x, y (n,) f32; buckets (n,) int32;
// sums (nb, 5) f64 scratch (zeroed here); out (nb, 5) f32.
extern "C" int repro_linfit_sums(const void* x, const void* y,
                                 const void* buckets, long long n, int nb,
                                 void* sums, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* acc = static_cast<double*>(sums);
  const long long count = static_cast<long long>(nb) * kMoments;
  cudaError_t err = cudaMemsetAsync(acc, 0, sizeof(double) * count, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    // element offset of each array inside its 16-byte group
    const int ox = static_cast<int>((reinterpret_cast<uintptr_t>(x) >> 2) & 3);
    const int oy = static_cast<int>((reinterpret_cast<uintptr_t>(y) >> 2) & 3);
    const int ob =
        static_cast<int>((reinterpret_cast<uintptr_t>(buckets) >> 2) & 3);
    const int vec = ox == oy && ox == ob;
    const int off = vec ? ox : 0;
    const long long blocks = (n + off + kChunk - 1) / kChunk;
    linfit_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<const int*>(buckets), n, nb, off, vec, acc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (count > 0) {
    const long long blocks = (count + kThreads - 1) / kThreads;
    linfit_finish_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        acc, count, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
