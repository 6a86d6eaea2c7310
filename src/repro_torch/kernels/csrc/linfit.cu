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
// one-hot matmul has no use here; one thread takes one key.  The RMI's
// buckets are non-decreasing with hundreds of keys a bucket, so a warp
// first reduces each run of equal buckets among its lanes with a segmented
// shuffle scan, and the run's last lane issues one f64 atomicAdd per
// moment: about five atomics per 32 keys on sorted input, five per key in
// the worst case of unsorted buckets (still correct).
//
// Numerics: products of the f32 inputs are formed in f64 (exactly) and
// summed in f64, then rounded to f32 once by a second tiny kernel.  That is
// at least as exact as the TPU's f32 per-tile sums, and the atomic order
// changes only the f64 rounding, so kernel and f64 plain version agree to
// within one f32 ulp of each sum's magnitude.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMoments = 5;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
linfit_kernel(const float* __restrict__ x, const float* __restrict__ y,
              const int* __restrict__ buckets, long long n, int nb,
              double* __restrict__ sums) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int b = i < n ? __ldg(buckets + i) : -1;
  const bool in = i < n && b >= 0 && b < nb;
  const double xv = in ? static_cast<double>(__ldg(x + i)) : 0.0;
  const double yv = in ? static_cast<double>(__ldg(y + i)) : 0.0;
  double v[kMoments] = {in ? 1.0 : 0.0, xv, yv, __dmul_rn(xv, yv),
                        __dmul_rn(xv, xv)};

  // Segmented inclusive scan over runs of equal buckets: after it, each
  // lane holds the sum from its run's first lane to itself.
  const int prev = __shfl_up_sync(kFull, b, 1);
  int flag = (lane == 0 || prev != b) ? 1 : 0;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    double u[kMoments];
#pragma unroll
    for (int k = 0; k < kMoments; ++k) u[k] = __shfl_up_sync(kFull, v[k], o);
    const int uf = __shfl_up_sync(kFull, flag, o);
    if (lane >= o) {
      if (!flag) {
#pragma unroll
        for (int k = 0; k < kMoments; ++k) v[k] = __dadd_rn(v[k], u[k]);
      }
      flag |= uf;
    }
  }
  const int next = __shfl_down_sync(kFull, b, 1);
  const bool last = lane == 31 || next != b;
  if (last && in) {
    double* row = sums + static_cast<size_t>(b) * kMoments;
#pragma unroll
    for (int k = 0; k < kMoments; ++k) atomicAdd(row + k, v[k]);
  }
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
    const long long blocks = (n + kThreads - 1) / kThreads;
    linfit_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<const int*>(buckets), n, nb, acc);
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
