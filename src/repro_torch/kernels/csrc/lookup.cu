// Learned-index lookup kernels K1-K3 for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (see kernels/build.py).  The packed-table
// row meaning is documented at the top of kernels/lookup.py; each kernel
// here has a plain PyTorch version beside its wrapper there, and the two
// agree bit for bit.
//
// Replaces (repro/kernels/lookup.py):
//   lookup_kernel          <- lookup_pallas          (_lookup_kernel)
//   dynamic_lookup_kernel  <- dynamic_lookup_pallas  (_dynamic_lookup_kernel)
//   dynamic_range_kernel   <- dynamic_range_pallas   (_dynamic_range_kernel)
//
// What bounds them on the card: each query is a chain of dependent 4-byte
// gathers -- the root, one leaf row, then `iters` window probes (plus
// `d_iters` delta probes for K2/K3) -- so the kernels are latency-bound
// random reads, far below both the memory and the arithmetic roofline.
// The design answers that with one thread per query (per endpoint pair for
// K3) and enough queries in flight to cover the latency: leaf tables and
// keys are read straight from global memory through the read-only path
// (__ldg) and L2, and the window search runs once over the global key array
// with the reference's static depth.  The TPU's per-tile min-merge
// (lookup.py _tile_search_merge) existed to fit VMEM and is not copied.
//
// Numerics mirror the reference's f32 arithmetic exactly:
//   * products and sums use explicit round-to-nearest intrinsics, so nvcc
//     cannot contract a*q + b into an FMA (the file is also built with
//     -fmad=false);
//   * the routing ratio n_leaves / route_n is rounded to f32 by the caller;
//   * float->int32 uses __float2int_rz, which saturates and maps NaN to 0,
//     as XLA's convert does (a key beyond the root's range lands in leaf
//     L-1, never in leaf 0);
//   * jnp.clip propagates NaN, so clip_nan does too before the conversion;
//   * the window clamps n_keys - 1 and n_keys arrive pre-rounded to f32.
#include <cuda_runtime.h>

namespace {

constexpr int kRootLanes = 128;  // packed root block is (8, 128) row-major
constexpr int kThreads = 256;

struct Tables {
  const float* root;   // (8, 128): [0,0] = a, [3,0] = b
  const float* mat;    // (3H, lp): row 0 = leaf slope
  const float* vec;    // (8, lp):  row 0 = intercept, 1 = err_lo, 2 = err_hi
  int lp;
  int n_leaves;
  float ratio;         // f32(n_leaves / route_n)
  const float* keys;   // (n_keys,) sorted f32
  int n_keys;
  float lo_max;        // f32(n_keys - 1)
  float hi_max;        // f32(n_keys)
  int iters;
};

__device__ __forceinline__ float clip_nan(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// Stages 1-3: root routing, leaf predict, error-bound window.
__device__ __forceinline__ void route_window(const Tables& t, float q,
                                             int& lo, int& hi) {
  float rpred = __fadd_rn(__fmul_rn(__ldg(t.root), q),
                          __ldg(t.root + 3 * kRootLanes));
  int b = __float2int_rz(__fmul_rn(rpred, t.ratio));
  b = min(max(b, 0), t.n_leaves - 1);
  float pred = __fadd_rn(__fmul_rn(__ldg(t.mat + b), q), __ldg(t.vec + b));
  float flo = floorf(__fadd_rn(pred, __ldg(t.vec + t.lp + b)));
  float fhi = __fadd_rn(ceilf(__fadd_rn(pred, __ldg(t.vec + 2 * t.lp + b))),
                        1.0f);
  lo = __float2int_rz(clip_nan(flo, 0.0f, t.lo_max));
  hi = __float2int_rz(clip_nan(fhi, 1.0f, t.hi_max));
}

// Stage 4: branchless search of [lo, hi) at static depth.  Left boundary
// (first key >= q) or, with kRight, right boundary (first key > q).
// Positions at or past n_keys read as +inf, as the reference's padding does.
template <bool kRight>
__device__ __forceinline__ int window_search(const Tables& t, float q,
                                             int lo, int hi) {
  int l = lo, h = hi;
  for (int it = 0; it < t.iters; ++it) {
    if (h > l) {
      int mid = (l + h) >> 1;
      float kv = mid < t.n_keys ? __ldg(t.keys + mid) : __int_as_float(0x7f800000);
      bool below = kRight ? (kv <= q) : (kv < q);
      if (below) l = mid + 1; else h = mid;
    }
  }
  return l < hi ? l : min(hi, t.n_keys);
}

// Full-depth search of the +inf-padded delta tier (nd entries).
template <bool kRight>
__device__ __forceinline__ int full_probe(const float* dk, int nd, float q,
                                          int d_iters) {
  int l = 0, h = nd;
  for (int it = 0; it < d_iters; ++it) {
    if (h > l) {
      int mid = (l + h) >> 1;
      float kv = __ldg(dk + mid);
      bool below = kRight ? (kv <= q) : (kv < q);
      if (below) l = mid + 1; else h = mid;
    }
  }
  return l;
}

__global__ void __launch_bounds__(kThreads)
lookup_kernel(Tables t, const float* __restrict__ q, int nq,
              int* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  float x = q[i];
  int lo, hi;
  route_window(t, x, lo, hi);
  out[i] = window_search<false>(t, x, lo, hi);
}

__global__ void __launch_bounds__(kThreads)
dynamic_lookup_kernel(Tables t, const float* __restrict__ q, int nq,
                      const float* __restrict__ dk, int nd, int d_iters,
                      int* __restrict__ out, int* __restrict__ dout) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  float x = q[i];
  int lo, hi;
  route_window(t, x, lo, hi);
  out[i] = window_search<false>(t, x, lo, hi);
  dout[i] = full_probe<false>(dk, nd, x, d_iters);
}

__global__ void __launch_bounds__(kThreads)
dynamic_range_kernel(Tables t, const float* __restrict__ qlo,
                     const float* __restrict__ qhi, int nq,
                     const float* __restrict__ dk, int nd, int d_iters,
                     int* __restrict__ blo, int* __restrict__ bhi,
                     int* __restrict__ dlo, int* __restrict__ dhi) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  float xl = qlo[i], xh = qhi[i];
  int lo, hi;
  route_window(t, xl, lo, hi);
  blo[i] = window_search<false>(t, xl, lo, hi);
  route_window(t, xh, lo, hi);
  bhi[i] = window_search<true>(t, xh, lo, hi);
  dlo[i] = full_probe<false>(dk, nd, xl, d_iters);
  dhi[i] = full_probe<true>(dk, nd, xh, d_iters);
}

Tables make_tables(const void* root, const void* mat, const void* vec, int lp,
                   int n_leaves, float ratio, const void* keys, int n_keys,
                   float lo_max, float hi_max, int iters) {
  Tables t;
  t.root = static_cast<const float*>(root);
  t.mat = static_cast<const float*>(mat);
  t.vec = static_cast<const float*>(vec);
  t.lp = lp;
  t.n_leaves = n_leaves;
  t.ratio = ratio;
  t.keys = static_cast<const float*>(keys);
  t.n_keys = n_keys;
  t.lo_max = lo_max;
  t.hi_max = hi_max;
  t.iters = iters;
  return t;
}

inline int blocks(int nq) { return (nq + kThreads - 1) / kThreads; }

}  // namespace

// Each entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() after the launch.
extern "C" int repro_lookup(const void* q, int nq, const void* root,
                            const void* mat, const void* vec, int lp,
                            int n_leaves, float ratio, const void* keys,
                            int n_keys, float lo_max, float hi_max, int iters,
                            void* out, void* stream) {
  Tables t = make_tables(root, mat, vec, lp, n_leaves, ratio, keys, n_keys,
                         lo_max, hi_max, iters);
  lookup_kernel<<<blocks(nq), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<const float*>(q), nq, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_dynamic_lookup(const void* q, int nq, const void* root,
                                    const void* mat, const void* vec, int lp,
                                    int n_leaves, float ratio,
                                    const void* keys, int n_keys, float lo_max,
                                    float hi_max, int iters, const void* dk,
                                    int nd, int d_iters, void* out, void* dout,
                                    void* stream) {
  Tables t = make_tables(root, mat, vec, lp, n_leaves, ratio, keys, n_keys,
                         lo_max, hi_max, iters);
  dynamic_lookup_kernel<<<blocks(nq), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<const float*>(q), nq, static_cast<const float*>(dk), nd,
      d_iters, static_cast<int*>(out), static_cast<int*>(dout));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_dynamic_range(const void* qlo, const void* qhi, int nq,
                                   const void* root, const void* mat,
                                   const void* vec, int lp, int n_leaves,
                                   float ratio, const void* keys, int n_keys,
                                   float lo_max, float hi_max, int iters,
                                   const void* dk, int nd, int d_iters,
                                   void* blo, void* bhi, void* dlo, void* dhi,
                                   void* stream) {
  Tables t = make_tables(root, mat, vec, lp, n_leaves, ratio, keys, n_keys,
                         lo_max, hi_max, iters);
  dynamic_range_kernel<<<blocks(nq), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<const float*>(qlo), static_cast<const float*>(qhi), nq,
      static_cast<const float*>(dk), nd, d_iters, static_cast<int*>(blo),
      static_cast<int*>(bhi), static_cast<int*>(dlo), static_cast<int*>(dhi));
  return static_cast<int>(cudaGetLastError());
}
