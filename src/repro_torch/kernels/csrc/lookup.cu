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
// `iters` window probes (plus `d_iters` delta probes for K2/K3) -- each in
// a 32-byte sector of its own, far below both the memory and the
// arithmetic roofline.  K1 and K4 answer that with one thread per query
// and enough queries in flight to cover the latency: tables and keys are
// read straight from global memory through the read-only path (__ldg) and
// L2, and the window search runs once over the global key array with the
// reference's static depth.  K2 and K3 were redesigned for Hopper (their
// section below).  The TPU's per-tile min-merge (lookup.py
// _tile_search_merge) existed to fit VMEM and is not copied.
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

#include <cstdint>

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

// ---------------------------------------------------------------------------
// K2 and K3, redesigned for Hopper.
//
// An endpoint (a query of K2, either end of a K3 pair) runs two independent
// searches ("chains"): the window search of the base tier (`iters` trips)
// and the full-depth probe of the delta tier (`d_iters` trips).  Each chain
// is the reference's static loop -- mid = (l + h) >> 1, a no-op once the
// window is empty -- and ends where that loop ends, for any trip count and
// any window, converged or not.
//
// What bounds them: every trip of every lane reads its own 32-byte sector,
// the base tier's from HBM (800 MB of keys), the delta tier's from L2, so
// the kernels run at the rate the memory system serves scattered sectors,
// and only fewer sectors or better overlap make them faster.  The design:
//   * interleaved chains: one loop advances both chains of a lane by one
//     trip, both loads issued before either is used; a warp leaves the loop
//     once no lane has a live chain (__any_sync), never later than the
//     static loop's last trip;
//   * sector finish: once a live window lies in one aligned 32-byte sector
//     that lies wholly in [0, n) of its tier, the chain loads that sector
//     (two 16-byte loads) and runs its remaining trips -- the same
//     midpoints, at most four, since a window of at most 8 keys empties in
//     at most 4 -- on the register copy.  A window whose sector reaches
//     past either end of the tier takes binary trips, so no load leaves the
//     tier.  Both of K2's chains finish so; K3's base chain takes binary
//     trips to its end (measured faster there: its last probes hit lines
//     the earlier ones brought in);
//   * K3 puts a pair's left and right endpoints in neighbouring lanes, so
//     the two searches' common sectors are fetched once;
//   * K2 with MLP leaves reads a leaf's 15 parameters from a leaf-major
//     64-byte row (`rows`, built by the wrapper at each call from the
//     packed tables: kernels/lookup.py leaf_rows) in four 16-byte loads
//     instead of 15 lane-major gathers;
//   * 128-thread blocks, one warp tile of 32 endpoints each.
// Tried on the card and dropped (PERF.md section 6): a 12-level delta fence
// in shared memory, a persistent grid with static or atomic-counter tiles,
// four chains a thread for K3, leaf-major rows for linear leaves and for
// K3, a register cap.

constexpr int kK23Threads = 128;
constexpr unsigned kFull = 0xffffffffu;

// One static search loop: window [l, h), trips left r.
struct Chain {
  int l, h, r;
  __device__ __forceinline__ bool live() const { return r > 0 && h > l; }
};

// A chain's keys: the array, its length (positions at or past n read as
// +inf) and the array's offset in its 32-byte sector, in floats.
struct Tier {
  const float* keys;
  int n;
  unsigned a8;
};

__device__ __forceinline__ Tier tier_of(const float* keys, int n) {
  return Tier{keys, n,
              static_cast<unsigned>(reinterpret_cast<uintptr_t>(keys) >> 2) &
                  7u};
}

// What the first half of a trip loaded: nothing (mode 0), the key at the
// midpoint (1), or the sector at position sb that holds the whole window
// (2).
struct Probe {
  int mode, sb;
  float kv;
  float4 s0, s1;
};

__device__ __forceinline__ bool is_below(float kv, float q, bool right) {
  return right ? kv <= q : kv < q;
}

// Element j (0..7) of a sector held in two float4s, by selects (a dynamic
// index into a register array would go to local memory).
__device__ __forceinline__ float pick8(const float4& a, const float4& b,
                                       int j) {
  const float x0 = (j & 1) ? a.y : a.x;
  const float x1 = (j & 1) ? a.w : a.z;
  const float x2 = (j & 1) ? b.y : b.x;
  const float x3 = (j & 1) ? b.w : b.z;
  const float y0 = (j & 2) ? x1 : x0;
  const float y1 = (j & 2) ? x3 : x2;
  return (j & 4) ? y1 : y0;
}

// First half of a trip: issue the chain's load (kSector: the window's
// sector, once the window lies in one inside [0, n)).
template <bool kSector>
__device__ __forceinline__ Probe issue(const Chain& c, const Tier& k) {
  Probe p{0, 0, 0.0f, make_float4(0.0f, 0.0f, 0.0f, 0.0f),
          make_float4(0.0f, 0.0f, 0.0f, 0.0f)};
  if (!c.live()) return p;
  const unsigned ul = static_cast<unsigned>(c.l);
  const unsigned uh = static_cast<unsigned>(c.h);
  if (kSector && uh - ul <= 8u &&
      ((k.a8 + ul) >> 3) == ((k.a8 + uh - 1u) >> 3)) {
    p.sb = c.l - static_cast<int>((k.a8 + ul) & 7u);
    if (p.sb >= 0 && p.sb + 8 <= k.n) {
      p.mode = 2;
      const float4* s = reinterpret_cast<const float4*>(k.keys + p.sb);
      p.s0 = __ldg(s);
      p.s1 = __ldg(s + 1);
      return p;
    }
  }
  p.mode = 1;
  const int mid = (c.l + c.h) >> 1;
  p.kv = mid < k.n ? __ldg(k.keys + mid) : __int_as_float(0x7f800000);
  return p;
}

// Second half: the static loop's step on what was loaded; a sector runs
// the chain to its end.
__device__ __forceinline__ void retire(Chain& c, const Probe& p, float q,
                                       bool right) {
  if (p.mode == 1) {
    const int mid = (c.l + c.h) >> 1;
    if (is_below(p.kv, q, right)) c.l = mid + 1; else c.h = mid;
    --c.r;
  } else if (p.mode == 2) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (c.live()) {
        const int mid = (c.l + c.h) >> 1;
        if (is_below(pick8(p.s0, p.s1, mid - p.sb), q, right)) c.l = mid + 1;
        else c.h = mid;
        --c.r;
      }
    }
  }
}

// Stages 1-3 for MLP leaves from leaf-major rows (w1, b1, w2 over H lanes,
// b2, err_lo, err_hi, pad: 64 bytes a leaf): the four loads issued
// together, then predict<true> and window() in the same f32 order.
template <bool kMlpRoot>
__device__ __forceinline__ void route_window_rows(const Tables& t,
                                                  const float4* rows,
                                                  float q, int& lo, int& hi) {
  float rpred = root_predict<kMlpRoot>(t.root, q);
  int b = __float2int_rz(__fmul_rn(rpred, t.ratio));
  b = min(max(b, 0), t.n_leaves - 1);
  const float4* r = rows + 4 * b;
  const float4 w1 = __ldg(r), b1 = __ldg(r + 1), w2 = __ldg(r + 2),
               v = __ldg(r + 3);
  const float w1k[kH] = {w1.x, w1.y, w1.z, w1.w};
  const float b1k[kH] = {b1.x, b1.y, b1.z, b1.w};
  const float w2k[kH] = {w2.x, w2.y, w2.z, w2.w};
  float pred = v.x;
#pragma unroll
  for (int k = 0; k < kH; ++k) {
    const float h = relu_nan(__fadd_rn(__fmul_rn(q, w1k[k]), b1k[k]));
    pred = __fadd_rn(pred, __fmul_rn(h, w2k[k]));
  }
  const float flo = floorf(__fadd_rn(pred, v.y));
  const float fhi = __fadd_rn(ceilf(__fadd_rn(pred, v.z)), 1.0f);
  lo = __float2int_rz(clip_nan(flo, 0.0f, t.lo_max));
  hi = __float2int_rz(clip_nan(fhi, 1.0f, t.hi_max));
}

// One endpoint's two chains, interleaved: the window search of x over the
// base tier's [lo, hi) and the delta probe, left (kv < x) or right
// (kv <= x) boundaries.  Called by every lane of the warp (`valid` false
// past the end of the work).  kBaseSector: the base chain finishes from a
// sector too.
template <bool kBaseSector>
__device__ __forceinline__ void endpoint(const Tables& t, const float* dk,
                                         int nd, int d_iters, float x,
                                         bool right, bool valid, int lo,
                                         int hi, int& bpos, int& dpos) {
  const Tier base = tier_of(t.keys, t.n_keys), delta = tier_of(dk, nd);
  Chain b{lo, hi, valid ? t.iters : 0}, d{0, nd, valid ? d_iters : 0};
  while (__any_sync(kFull, b.live() || d.live())) {
    const Probe pb = issue<kBaseSector>(b, base);
    const Probe pd = issue<true>(d, delta);
    retire(b, pb, x, right);
    retire(d, pd, x, right);
  }
  bpos = b.l < hi ? b.l : min(hi, t.n_keys);
  dpos = d.l;
}

// The first of the 32 work items of this thread's warp.
__device__ __forceinline__ long long warp_tile() {
  return (static_cast<long long>(blockIdx.x) * (kK23Threads / 32) +
          (threadIdx.x >> 5)) * 32;
}

// K2.  kMlpLeaf reads the leaves from `rows`, not from t.mat / t.vec.
template <bool kMlpRoot, bool kMlpLeaf>
__global__ void __launch_bounds__(kK23Threads)
dynamic_lookup_kernel(Tables t, const float4* __restrict__ rows,
                      const float* __restrict__ q, int nq,
                      const float* __restrict__ dk, int nd, int d_iters,
                      int* __restrict__ out, int* __restrict__ dout) {
  const long long w = warp_tile();
  if (w >= nq) return;                  // whole warps only
  const int i = static_cast<int>(w) + (threadIdx.x & 31);
  const bool valid = i < nq;
  const float x = valid ? q[i] : 0.0f;
  int lo = 0, hi = 0, bpos, dpos;
  if (valid) {
    if (kMlpLeaf) route_window_rows<kMlpRoot>(t, rows, x, lo, hi);
    else route_window<kMlpRoot, false>(t, x, lo, hi);
  }
  endpoint<true>(t, dk, nd, d_iters, x, false, valid, lo, hi, bpos, dpos);
  if (valid) {
    out[i] = bpos;
    dout[i] = dpos;
  }
}

// K3: work item 2p is the left boundary of qlo[p], 2p + 1 the right
// boundary of qhi[p].
template <bool kMlpRoot, bool kMlpLeaf>
__global__ void __launch_bounds__(kK23Threads)
dynamic_range_kernel(Tables t, const float* __restrict__ qlo,
                     const float* __restrict__ qhi, int nq,
                     const float* __restrict__ dk, int nd, int d_iters,
                     int* __restrict__ blo, int* __restrict__ bhi,
                     int* __restrict__ dlo, int* __restrict__ dhi) {
  const long long w = warp_tile();
  if (w >= 2LL * nq) return;            // whole warps only
  const long long j = w + (threadIdx.x & 31);
  const bool valid = j < 2LL * nq, right = j & 1;
  const int i = static_cast<int>(j >> 1);
  const float x = valid ? (right ? qhi[i] : qlo[i]) : 0.0f;
  int lo = 0, hi = 0, bpos, dpos;
  if (valid) route_window<kMlpRoot, kMlpLeaf>(t, x, lo, hi);
  endpoint<false>(t, dk, nd, d_iters, x, right, valid, lo, hi, bpos, dpos);
  if (valid) {
    (right ? bhi : blo)[i] = bpos;
    (right ? dhi : dlo)[i] = dpos;
  }
}

// Launch a K2/K3 kernel over `items` work items, one a thread.
template <typename Kernel, typename... Args>
int launch_k23(Kernel kernel, long long items, void* stream, Args... args) {
  const unsigned grid =
      static_cast<unsigned>((items + kK23Threads - 1) / kK23Threads);
  kernel<<<grid, kK23Threads, 0, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
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

// The instantiation of a K2/K3 kernel for root_mlp / leaf_mlp.
#define REPRO_PICK(KERNEL)                                                 \
  (root_mlp ? (leaf_mlp ? KERNEL<true, true> : KERNEL<true, false>)        \
            : (leaf_mlp ? KERNEL<false, true> : KERNEL<false, false>))

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

// K2.  With leaf_mlp the leaves are read from `rows` alone (leaf-major,
// 16 floats a leaf: kernels/lookup.py leaf_rows), which must then be given;
// mat / vec are read for linear leaves, and `rows` is not.
extern "C" int repro_dynamic_lookup(const void* q, int nq, const void* root,
                                    const void* mat, const void* vec, int lp,
                                    int n_leaves, float ratio,
                                    const void* keys, int n_keys, float lo_max,
                                    float hi_max, int iters, int root_mlp,
                                    int leaf_mlp, const void* rows,
                                    const void* dk, int nd, int d_iters,
                                    void* out, void* dout, void* stream) {
  if (leaf_mlp && rows == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Tables t = make_tables(root, mat, vec, lp, n_leaves, ratio, keys, n_keys,
                         lo_max, hi_max, iters);
  return launch_k23(REPRO_PICK(dynamic_lookup_kernel), nq, stream, t,
                    static_cast<const float4*>(rows),
                    static_cast<const float*>(q), nq,
                    static_cast<const float*>(dk), nd, d_iters,
                    static_cast<int*>(out), static_cast<int*>(dout));
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
  return launch_k23(REPRO_PICK(dynamic_range_kernel), 2LL * nq, stream, t,
                    static_cast<const float*>(qlo),
                    static_cast<const float*>(qhi), nq,
                    static_cast<const float*>(dk), nd, d_iters,
                    static_cast<int*>(blo), static_cast<int*>(bhi),
                    static_cast<int*>(dlo), static_cast<int*>(dhi));
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
