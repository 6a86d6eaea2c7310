// Learned-index lookup kernels K1-K4 for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (see kernels/build.py).  The packed-table
// row meaning is documented at the top of kernels/lookup.py; each kernel
// here has a plain PyTorch version beside its wrapper there, and the two
// agree bit for bit.
//
// Replaces (repro/kernels/lookup.py):
//   lookup_kernel          <- lookup_pallas          (_lookup_kernel)
//   dynamic_lookup_kernel  <- dynamic_lookup_pallas  (_dynamic_lookup_kernel)
//   dynamic_range_kernel   <- dynamic_range_pallas   (_dynamic_range_kernel)
//   rmrt_lookup_kernel     <- rmrt_lookup_pallas     (_rmrt_lookup_kernel,
//                                                     _rmrt_route_window)
//
// K1-K3 are templated on the root kind and the leaf kind (linear or the
// paper's 1x4 MLP), K4 on the node model kind; the linear/linear
// instantiation is the kernel the linear-only port had.
//
// What bounds them on the card: each query is a chain of dependent 4-byte
// gathers -- the root, one leaf row (one node row per RMRT level), then
// `iters` window probes (plus `d_iters` delta probes for K2/K3) -- so the
// kernels are latency-bound random reads, far below both the memory and
// the arithmetic roofline.  The design answers that with one thread per
// query (per endpoint pair for K3) and enough queries in flight to cover
// the latency: tables and keys are read straight from global memory
// through the read-only path (__ldg) and L2, and the window search runs
// once over the global key array with the reference's static depth.  The
// TPU's per-tile min-merge (lookup.py _tile_search_merge) existed to fit
// VMEM and is not copied.
//
// Numerics mirror the reference's f32 arithmetic exactly:
//   * products, sums and the RMRT re-bucket quotient use explicit
//     round-to-nearest intrinsics, so nvcc cannot contract a*q + b into an
//     FMA (the file is also built with -fmad=false);
//   * the MLP root's 4-term sum runs in XLA:CPU's order for the eager
//     oracle's jnp.sum: sequential from 0, then + b2;
//   * relu is jnp.maximum(x, 0), which propagates NaN (fmaxf would not);
//   * the routing ratio n_leaves / route_n is rounded to f32 by the caller;
//   * float->int32 uses __float2int_rz, which saturates and maps NaN to 0,
//     as XLA's convert does (a key beyond the root's range lands in leaf
//     L-1, never in leaf 0);
//   * jnp.clip propagates NaN, so clip_nan does too before the conversion;
//   * the window clamps n_keys - 1 and n_keys arrive pre-rounded to f32.
#include <cuda_runtime.h>

namespace {

constexpr int kRootLanes = 128;  // packed root block is (8, 128) row-major
constexpr int kH = 4;            // the paper's hidden width
constexpr int kThreads = 256;

struct Tables {
  const float* root;   // (8, 128): linear [0,0] = a, [3,0] = b; MLP rows
                       //   0/1/2 = w1/b1/w2 over H lanes, [3,0] = b2
  const float* mat;    // (3H, lp): rows w1, b1, w2 (a linear slope in row 0)
  const float* vec;    // (8, lp):  row 0 = b2 / intercept, 1 = err_lo,
                       //   2 = err_hi (RMRT nodes: 3 y_start, 4 y_end,
                       //   5 child_base, 6 is_leaf)
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

__device__ __forceinline__ float relu_nan(float x) {
  return x != x ? x : fmaxf(x, 0.0f);
}

// Model predict of lane `j` of packed (3H, lp) / (8, lp) tables: a linear
// model a*q + b, or the MLP b2 + sum_k relu(q*w1_k + b1_k) * w2_k in the
// reference's order (b2 first, then k = 0..3).
template <bool kMlp>
__device__ __forceinline__ float predict(const float* mat, const float* vec,
                                         int lp, int j, float q) {
  if (!kMlp)
    return __fadd_rn(__fmul_rn(__ldg(mat + j), q), __ldg(vec + j));
  float pred = __ldg(vec + j);
#pragma unroll
  for (int k = 0; k < kH; ++k) {
    float h = relu_nan(__fadd_rn(__fmul_rn(q, __ldg(mat + k * lp + j)),
                                 __ldg(mat + (kH + k) * lp + j)));
    pred = __fadd_rn(pred, __fmul_rn(h, __ldg(mat + (2 * kH + k) * lp + j)));
  }
  return pred;
}

// Stage 1: the root's prediction for q.
template <bool kMlpRoot>
__device__ __forceinline__ float root_predict(const float* root, float q) {
  if (!kMlpRoot)
    return __fadd_rn(__fmul_rn(__ldg(root), q), __ldg(root + 3 * kRootLanes));
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < kH; ++k) {
    float h = relu_nan(__fadd_rn(__fmul_rn(q, __ldg(root + k)),
                                 __ldg(root + kRootLanes + k)));
    s = __fadd_rn(s, __fmul_rn(h, __ldg(root + 2 * kRootLanes + k)));
  }
  return __fadd_rn(s, __ldg(root + 3 * kRootLanes));
}

// Stage 3: the error-bound window of lane j around pred.
__device__ __forceinline__ void window(const Tables& t, int j, float pred,
                                       int& lo, int& hi) {
  float flo = floorf(__fadd_rn(pred, __ldg(t.vec + t.lp + j)));
  float fhi = __fadd_rn(ceilf(__fadd_rn(pred, __ldg(t.vec + 2 * t.lp + j))),
                        1.0f);
  lo = __float2int_rz(clip_nan(flo, 0.0f, t.lo_max));
  hi = __float2int_rz(clip_nan(fhi, 1.0f, t.hi_max));
}

// Stages 1-3: root routing, leaf predict, error-bound window.
template <bool kMlpRoot, bool kMlpLeaf>
__device__ __forceinline__ void route_window(const Tables& t, float q,
                                             int& lo, int& hi) {
  float rpred = root_predict<kMlpRoot>(t.root, q);
  int b = __float2int_rz(__fmul_rn(rpred, t.ratio));
  b = min(max(b, 0), t.n_leaves - 1);
  window(t, b, predict<kMlpLeaf>(t.mat, t.vec, t.lp, b, q), lo, hi);
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

template <bool kMlpRoot, bool kMlpLeaf>
__global__ void __launch_bounds__(kThreads)
lookup_kernel(Tables t, const float* __restrict__ q, int nq,
              int* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  float x = q[i];
  int lo, hi;
  route_window<kMlpRoot, kMlpLeaf>(t, x, lo, hi);
  out[i] = window_search<false>(t, x, lo, hi);
}

template <bool kMlpRoot, bool kMlpLeaf>
__global__ void __launch_bounds__(kThreads)
dynamic_lookup_kernel(Tables t, const float* __restrict__ q, int nq,
                      const float* __restrict__ dk, int nd, int d_iters,
                      int* __restrict__ out, int* __restrict__ dout) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  float x = q[i];
  int lo, hi;
  route_window<kMlpRoot, kMlpLeaf>(t, x, lo, hi);
  out[i] = window_search<false>(t, x, lo, hi);
  dout[i] = full_probe<false>(dk, nd, x, d_iters);
}

template <bool kMlpRoot, bool kMlpLeaf>
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
  route_window<kMlpRoot, kMlpLeaf>(t, xl, lo, hi);
  blo[i] = window_search<false>(t, xl, lo, hi);
  route_window<kMlpRoot, kMlpLeaf>(t, xh, lo, hi);
  bhi[i] = window_search<true>(t, xh, lo, hi);
  dlo[i] = full_probe<false>(dk, nd, xl, d_iters);
  dhi[i] = full_probe<true>(dk, nd, xh, d_iters);
}

// K4: fixed-depth masked descent over the packed RMRT node tables (per
// level: node predict, re-bucket by fanout over [y_start, y_end], stop at
// is_leaf), then the leaf's error window and K1's window search.
template <bool kMlp>
__global__ void __launch_bounds__(kThreads)
rmrt_lookup_kernel(Tables t, int fanout, int depth,
                   const float* __restrict__ q, int nq,
                   int* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  const float x = q[i];
  const float ffan = static_cast<float>(fanout);
  const float* ys_row = t.vec + 3 * t.lp;
  const float* ye_row = t.vec + 4 * t.lp;
  const float* cb_row = t.vec + 5 * t.lp;
  const float* leaf_row = t.vec + 6 * t.lp;
  int node = 0;
  for (int d = 0; d < depth; ++d) {
    float pred = predict<kMlp>(t.mat, t.vec, t.lp, node, x);
    float ys = __ldg(ys_row + node);
    float span = __fsub_rn(__ldg(ye_row + node), ys);
    int child = __float2int_rz(
        __fdiv_rn(__fmul_rn(__fsub_rn(pred, ys), ffan), span));
    child = min(max(child, 0), fanout - 1);
    int nxt = __float2int_rz(__ldg(cb_row + node)) + child;
    if (!(__ldg(leaf_row + node) > 0.5f)) node = nxt;
  }
  int lo, hi;
  window(t, node, predict<kMlp>(t.mat, t.vec, t.lp, node, x), lo, hi);
  out[i] = window_search<false>(t, x, lo, hi);
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
// root_mlp / leaf_mlp (0 or 1) pick the template instantiation.
#define REPRO_DISPATCH(KERNEL, ...)                                        \
  do {                                                                     \
    dim3 g(blocks(nq)), b(kThreads);                                       \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                    \
    if (root_mlp && leaf_mlp) KERNEL<true, true><<<g, b, 0, s>>>(__VA_ARGS__);   \
    else if (root_mlp) KERNEL<true, false><<<g, b, 0, s>>>(__VA_ARGS__);         \
    else if (leaf_mlp) KERNEL<false, true><<<g, b, 0, s>>>(__VA_ARGS__);         \
    else KERNEL<false, false><<<g, b, 0, s>>>(__VA_ARGS__);                      \
  } while (0)

extern "C" int repro_lookup(const void* q, int nq, const void* root,
                            const void* mat, const void* vec, int lp,
                            int n_leaves, float ratio, const void* keys,
                            int n_keys, float lo_max, float hi_max, int iters,
                            int root_mlp, int leaf_mlp, void* out,
                            void* stream) {
  Tables t = make_tables(root, mat, vec, lp, n_leaves, ratio, keys, n_keys,
                         lo_max, hi_max, iters);
  REPRO_DISPATCH(lookup_kernel, t, static_cast<const float*>(q), nq,
                 static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_dynamic_lookup(const void* q, int nq, const void* root,
                                    const void* mat, const void* vec, int lp,
                                    int n_leaves, float ratio,
                                    const void* keys, int n_keys, float lo_max,
                                    float hi_max, int iters, int root_mlp,
                                    int leaf_mlp, const void* dk, int nd,
                                    int d_iters, void* out, void* dout,
                                    void* stream) {
  Tables t = make_tables(root, mat, vec, lp, n_leaves, ratio, keys, n_keys,
                         lo_max, hi_max, iters);
  REPRO_DISPATCH(dynamic_lookup_kernel, t, static_cast<const float*>(q), nq,
                 static_cast<const float*>(dk), nd, d_iters,
                 static_cast<int*>(out), static_cast<int*>(dout));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_dynamic_range(const void* qlo, const void* qhi, int nq,
                                   const void* root, const void* mat,
                                   const void* vec, int lp, int n_leaves,
                                   float ratio, const void* keys, int n_keys,
                                   float lo_max, float hi_max, int iters,
                                   int root_mlp, int leaf_mlp, const void* dk,
                                   int nd, int d_iters, void* blo, void* bhi,
                                   void* dlo, void* dhi, void* stream) {
  Tables t = make_tables(root, mat, vec, lp, n_leaves, ratio, keys, n_keys,
                         lo_max, hi_max, iters);
  REPRO_DISPATCH(dynamic_range_kernel, t, static_cast<const float*>(qlo),
                 static_cast<const float*>(qhi), nq,
                 static_cast<const float*>(dk), nd, d_iters,
                 static_cast<int*>(blo), static_cast<int*>(bhi),
                 static_cast<int*>(dlo), static_cast<int*>(dhi));
  return static_cast<int>(cudaGetLastError());
}

// K4.  mat (3H, npad) / vec (8, npad) are pack_rmrt's node tables.
extern "C" int repro_rmrt_lookup(const void* q, int nq, const void* mat,
                                 const void* vec, int npad, int fanout,
                                 int depth, int mlp, const void* keys,
                                 int n_keys, float lo_max, float hi_max,
                                 int iters, void* out, void* stream) {
  Tables t = make_tables(nullptr, mat, vec, npad, 0, 0.0f, keys, n_keys,
                         lo_max, hi_max, iters);
  dim3 g(blocks(nq)), b(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mlp)
    rmrt_lookup_kernel<true><<<g, b, 0, s>>>(
        t, fanout, depth, static_cast<const float*>(q), nq,
        static_cast<int*>(out));
  else
    rmrt_lookup_kernel<false><<<g, b, 0, s>>>(
        t, fanout, depth, static_cast<const float*>(q), nq,
        static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
