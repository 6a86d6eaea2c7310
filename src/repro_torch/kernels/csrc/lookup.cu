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
// paper's 1x4 MLP), K4 on the node model kind.  K1-K3 also have a
// shard-stacked entry (section at the end): one launch over the queries of
// many indexes, each lane reading its index's tables from an array of
// descriptors; the same item bodies run in both.
//
// What bounds them on the card: each query reads a chain of scattered
// 32-byte sectors -- the root, one leaf row (one node row per RMRT level),
// then the window probes (plus the delta probes of K2/K3) -- far below both
// the memory and the arithmetic roofline, at the rate the memory system
// serves scattered sectors.  Only fewer sectors, or better overlap, make
// them faster.  All four kernels were redesigned for Hopper around that
// (sections below); the TPU's per-tile min-merge (lookup.py
// _tile_search_merge) existed to fit VMEM and is not copied: the search
// runs once over the global key array.
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
//   * the window clamps n_keys - 1 and n_keys arrive pre-rounded to f32;
//   * K4's re-bucket divides by the node's own span (__fdiv_rn), never by a
//     reciprocal.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRootLanes = 128;  // packed root block is (8, 128) row-major
constexpr int kH = 4;            // the paper's hidden width
constexpr int kTileThreads = 128;  // four warp tiles of 32 work items
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFenceShift = 6;   // a fence entry every 64 keys

struct Tables {
  const float* root;   // (8, 128): linear [0,0] = a, [3,0] = b; MLP rows
                       //   0/1/2 = w1/b1/w2 over H lanes, [3,0] = b2
  const float* mat;    // (3H, lp): rows w1, b1, w2 (a linear slope in row 0)
  const float* vec;    // (8, lp):  row 0 = b2 / intercept, 1 = err_lo,
                       //   2 = err_hi
  int lp;
  int n_leaves;
  float ratio;         // f32(n_leaves / route_n)
  const float* keys;   // (n_keys,) sorted f32
  int n_keys;
  float lo_max;        // f32(n_keys - 1)
  float hi_max;        // f32(n_keys)
  int iters;
  const float* fence;  // (nf,) keys[0], keys[64], ... (K1 and K4 only)
  int nf;              // ceil(n_keys / 64)
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

// The same MLP predict from a row's registers.
__device__ __forceinline__ float mlp_predict(float b2, const float4& w1,
                                             const float4& b1,
                                             const float4& w2, float q) {
  const float w1k[kH] = {w1.x, w1.y, w1.z, w1.w};
  const float b1k[kH] = {b1.x, b1.y, b1.z, b1.w};
  const float w2k[kH] = {w2.x, w2.y, w2.z, w2.w};
  float pred = b2;
#pragma unroll
  for (int k = 0; k < kH; ++k) {
    const float h = relu_nan(__fadd_rn(__fmul_rn(q, w1k[k]), b1k[k]));
    pred = __fadd_rn(pred, __fmul_rn(h, w2k[k]));
  }
  return pred;
}

// Stage 1: the root's prediction for q, and the leaf it routes q to.
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

template <bool kMlpRoot>
__device__ __forceinline__ int route_bucket(const Tables& t, float q) {
  const int b = __float2int_rz(__fmul_rn(root_predict<kMlpRoot>(t.root, q),
                                         t.ratio));
  return min(max(b, 0), t.n_leaves - 1);
}

// Stage 3: the error-bound window around pred, clamped to [0, n_keys).
__device__ __forceinline__ void bounds(const Tables& t, float pred,
                                       float err_lo, float err_hi, int& lo,
                                       int& hi) {
  const float flo = floorf(__fadd_rn(pred, err_lo));
  const float fhi = __fadd_rn(ceilf(__fadd_rn(pred, err_hi)), 1.0f);
  lo = __float2int_rz(clip_nan(flo, 0.0f, t.lo_max));
  hi = __float2int_rz(clip_nan(fhi, 1.0f, t.hi_max));
}

// Stages 1-3 from the lane-major tables: root routing, leaf predict,
// error-bound window (K2 with linear leaves, K3).
template <bool kMlpRoot, bool kMlpLeaf>
__device__ __forceinline__ void route_window(const Tables& t, float q,
                                             int& lo, int& hi) {
  const int b = route_bucket<kMlpRoot>(t, q);
  bounds(t, predict<kMlpLeaf>(t.mat, t.vec, t.lp, b, q),
         __ldg(t.vec + t.lp + b), __ldg(t.vec + 2 * t.lp + b), lo, hi);
}

// ---------------------------------------------------------------------------
// Leaf-major and node-major rows (kernels/lookup.py leaf_rows / node_rows,
// cached in the index beside its packed tables, never built per call on the
// index paths): a leaf's or a node's words side by side, read with 16-byte
// loads issued together instead of one 4-byte gather -- one sector -- from
// each lane-major table row.
//   linear leaf (K1):     1 float4   (a, b, err_lo, err_hi)
//   MLP leaf (K1, K2):    4 float4s  w1, b1, w2 (H each), (b2, err_lo,
//                                    err_hi, 0)
//   linear node (K4):     2 float4s  (a, b, err_lo, err_hi), (y_start,
//                                    y_end, child_base, is_leaf): a sector
//   MLP node (K4):        5 float4s  (0, b2, err_lo, err_hi), (y_start,
//                                    y_end, child_base, is_leaf), w1, b1, w2
// The predicts and windows run the lane-major tables' f32 steps in the same
// order, so the rows change which bytes are read, not what is computed.

// Stages 1-3 from leaf rows.
template <bool kMlpRoot, bool kMlpLeaf>
__device__ __forceinline__ void route_window_rows(const Tables& t,
                                                  const float4* rows,
                                                  float q, int& lo, int& hi) {
  const int b = route_bucket<kMlpRoot>(t, q);
  if (!kMlpLeaf) {
    const float4 r = __ldg(rows + b);
    bounds(t, __fadd_rn(__fmul_rn(r.x, q), r.y), r.z, r.w, lo, hi);
    return;
  }
  const float4* r = rows + 4 * b;
  const float4 w1 = __ldg(r), b1 = __ldg(r + 1), w2 = __ldg(r + 2),
               v = __ldg(r + 3);
  bounds(t, mlp_predict(v.x, w1, b1, w2, q), v.y, v.z, lo, hi);
}

// ---------------------------------------------------------------------------
// The window search: the reference's static loop -- mid = (l + h) >> 1 on
// [lo, hi), positions at or past n reading +inf, `iters` trips, a no-op once
// the window is empty -- run so that it ends where that loop ends, for any
// trip count and any window, converged or not.
//
// What bounds it: every trip of every lane reads its own 32-byte sector of
// an 800 MB key array.  So:
//   * a warp leaves the loop once no lane has a live window (__any_sync),
//     never later than the static loop's last trip;
//   * sector finish: once a live window lies in one aligned 32-byte sector
//     that lies wholly in [0, n) of its tier, the chain loads that sector
//     (two 16-byte loads) and runs its remaining trips -- the same
//     midpoints, at most four, since a window of at most 8 keys empties in
//     at most 4 -- on the register copy.  A window whose sector reaches
//     past either end of the tier takes binary trips, so no load leaves the
//     tier.
// Both replay the static loop's own midpoints, so they are exact on every
// window, also one that the static depth does not converge (an empty
// leaf's sentinel full-array window, or `iters` cut).
//
// K1 and K4 add a fence: every 64th key of the base tier (positions 0, 64,
// ...: 12.5 MB at 200M keys, a quarter of the 50 MB L2), cached beside the
// f32 keys (kernels/lookup.py key_fence).  A window the static loop
// converges (hi - lo < 2^iters) is searched on the fence first, then within
// one 64-key interval of the keys, so that its first probes hit L2 instead
// of scattered HBM sectors.  Exact because, when it converges, the static
// loop ends on the first position in [lo, hi) whose key is not below q
// (positions >= n read +inf), or on hi -- as any exact lower-bound search
// of a sorted array does, for NaN and +-inf too (no key is below NaN: the
// answer is lo).  If J is the first fence entry in the window that is not
// below q (jl <= J <= jh, the entries ceil(lo / 64) .. ceil(hi / 64) - 1
// below nf), that position lies in (64 (J - 1), 64 J] (clipped to
// [lo, hi]): keys[64 (J - 1)] is below q, keys[64 J] is not.  A window the
// static depth does not converge replays the static loop's midpoints.

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

// The window-clamped left boundary of x in the base tier's [lo, hi):
// K1's and K4's search, one chain a lane -- with kFence on the fence and
// then on the keys for a converged window, on the keys alone for another;
// with kSector finishing from sectors.  Called by every lane of the warp
// (`valid` false past the end of the work).
template <bool kFence, bool kSector>
__device__ __forceinline__ int leaf_search(const Tables& t, float x,
                                           bool valid, int lo, int hi) {
  const Tier keys = tier_of(t.keys, t.n_keys), fence = tier_of(t.fence, t.nf);
  constexpr int kAll = 32;               // trips enough for any window
  bool on_fence = kFence && valid && (t.iters >= 31 ||
                            (t.iters > 0 && static_cast<unsigned>(hi - lo) <
                                                (1u << t.iters)));
  const int jl = static_cast<int>((static_cast<unsigned>(lo) + 63u) >>
                                  kFenceShift);
  const int jh = max(min(static_cast<int>((static_cast<unsigned>(hi) + 63u) >>
                                          kFenceShift),
                         t.nf),
                     jl);
  Chain c = on_fence ? Chain{jl, jh, kAll}
                     : Chain{lo, hi, valid ? t.iters : 0};
  while (__any_sync(kFull, c.live() || on_fence)) {
    if (on_fence && !c.live()) {         // the fence's interval of the keys
      const int j = c.l;
      c = Chain{j > jl ? ((j - 1) << kFenceShift) + 1 : lo,
                j < jh ? j << kFenceShift : hi, kAll};
      on_fence = false;
    }
    // the tier picked field by field: a reference to either Tier would
    // put both in local memory
    const Tier tier{on_fence ? fence.keys : keys.keys,
                    on_fence ? fence.n : keys.n, on_fence ? fence.a8 : keys.a8};
    retire(c, issue<kSector>(c, tier), x, false);
  }
  return c.l < hi ? c.l : min(hi, t.n_keys);
}

// The first of the 32 work items of this thread's warp.
__device__ __forceinline__ long long warp_tile() {
  return (static_cast<long long>(blockIdx.x) * (kTileThreads / 32) +
          (threadIdx.x >> 5)) * 32;
}

// ---------------------------------------------------------------------------
// K1, redesigned for Hopper: the leaf from its row (one 16-byte load for a
// linear leaf instead of 4 gathers, four for an MLP leaf instead of 15),
// then leaf_search from the fence in binary trips.  Measured at 200M
// lognormal keys (PERF.md section 6, PR 18): the fence cuts K1 by 10%
// (linear leaves) and 24% (MLP leaves); the sector finish slows it by
// 0.5-6%.
//
// One work item: query i of the warp tile (`valid` false past the end of
// the work; every lane of the warp calls it).
template <bool kMlpRoot, bool kMlpLeaf>
__device__ __forceinline__ void lookup_item(const Tables& t,
                                            const float4* rows,
                                            const float* q, int i,
                                            bool valid, int* out) {
  const float x = valid ? q[i] : 0.0f;
  int lo = 0, hi = 0;
  if (valid) route_window_rows<kMlpRoot, kMlpLeaf>(t, rows, x, lo, hi);
  const int pos = leaf_search<true, false>(t, x, valid, lo, hi);
  if (valid) out[i] = pos;
}

template <bool kMlpRoot, bool kMlpLeaf>
__global__ void __launch_bounds__(kTileThreads)
lookup_kernel(Tables t, const float4* __restrict__ rows,
              const float* __restrict__ q, int nq, int* __restrict__ out) {
  const long long w = warp_tile();
  if (w >= nq) return;                  // whole warps only
  const int i = static_cast<int>(w) + (threadIdx.x & 31);
  lookup_item<kMlpRoot, kMlpLeaf>(t, rows, q, i, i < nq, out);
}

// ---------------------------------------------------------------------------
// K2 and K3, redesigned for Hopper.
//
// An endpoint (a query of K2, either end of a K3 pair) runs two independent
// chains: the window search of the base tier (`iters` trips) and the
// full-depth probe of the delta tier (`d_iters` trips), the base tier's
// sectors from HBM (800 MB of keys), the delta tier's from L2.  The design:
//   * interleaved chains: one loop advances both chains of a lane by one
//     trip, both loads issued before either is used; a warp leaves the loop
//     once no lane has a live chain, never later than the static loop's
//     last trip;
//   * the sector finish on both of K2's chains; K3's base chain takes
//     binary trips to its end (measured faster there: its last probes hit
//     lines the earlier ones brought in);
//   * K3 puts a pair's left and right endpoints in neighbouring lanes, so
//     the two searches' common sectors are fetched once;
//   * K2 with MLP leaves reads them from leaf rows (route_window_rows);
//     with linear leaves, and K3 with either, from the lane-major tables.
// Tried on the card and dropped (PERF.md section 6): a 12-level delta fence
// in shared memory, a persistent grid with static or atomic-counter tiles,
// four chains a thread for K3, leaf rows for linear leaves of K2 and for
// K3 (built per call), a register cap.

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

// K2.  kMlpLeaf reads the leaves from `rows`, not from t.mat / t.vec.
// One work item, as lookup_item.
template <bool kMlpRoot, bool kMlpLeaf>
__device__ __forceinline__ void dynamic_lookup_item(
    const Tables& t, const float4* rows, const float* q, int i, bool valid,
    const float* dk, int nd, int d_iters, int* out, int* dout) {
  const float x = valid ? q[i] : 0.0f;
  int lo = 0, hi = 0, bpos, dpos;
  if (valid) {
    if (kMlpLeaf) route_window_rows<kMlpRoot, true>(t, rows, x, lo, hi);
    else route_window<kMlpRoot, false>(t, x, lo, hi);
  }
  endpoint<true>(t, dk, nd, d_iters, x, false, valid, lo, hi, bpos, dpos);
  if (valid) {
    out[i] = bpos;
    dout[i] = dpos;
  }
}

template <bool kMlpRoot, bool kMlpLeaf>
__global__ void __launch_bounds__(kTileThreads)
dynamic_lookup_kernel(Tables t, const float4* __restrict__ rows,
                      const float* __restrict__ q, int nq,
                      const float* __restrict__ dk, int nd, int d_iters,
                      int* __restrict__ out, int* __restrict__ dout) {
  const long long w = warp_tile();
  if (w >= nq) return;                  // whole warps only
  const int i = static_cast<int>(w) + (threadIdx.x & 31);
  dynamic_lookup_item<kMlpRoot, kMlpLeaf>(t, rows, q, i, i < nq, dk, nd,
                                          d_iters, out, dout);
}

// K3: work item 2p is the left boundary of qlo[p], 2p + 1 the right
// boundary of qhi[p].  One work item j, as lookup_item.
template <bool kMlpRoot, bool kMlpLeaf>
__device__ __forceinline__ void dynamic_range_item(
    const Tables& t, const float* qlo, const float* qhi, long long j,
    bool valid, const float* dk, int nd, int d_iters, int* blo, int* bhi,
    int* dlo, int* dhi) {
  const bool right = j & 1;
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

template <bool kMlpRoot, bool kMlpLeaf>
__global__ void __launch_bounds__(kTileThreads)
dynamic_range_kernel(Tables t, const float* __restrict__ qlo,
                     const float* __restrict__ qhi, int nq,
                     const float* __restrict__ dk, int nd, int d_iters,
                     int* __restrict__ blo, int* __restrict__ bhi,
                     int* __restrict__ dlo, int* __restrict__ dhi) {
  const long long w = warp_tile();
  if (w >= 2LL * nq) return;            // whole warps only
  const long long j = w + (threadIdx.x & 31);
  dynamic_range_item<kMlpRoot, kMlpLeaf>(t, qlo, qhi, j, j < 2LL * nq, dk,
                                         nd, d_iters, blo, bhi, dlo, dhi);
}

// ---------------------------------------------------------------------------
// K4, redesigned for Hopper: the RMRT descent over node rows (per level:
// node predict, re-bucket by fanout over [y_start, y_end], stay at
// is_leaf), then the leaf's error window and leaf_search from the fence,
// finishing from sectors.  The search is most of K4's time: its windows
// span about 2^12 keys at 200M keys (a leaf holds up to 10^6), and the
// fence takes K4 from 0.31 to 0.12 ms there (PERF.md section 6, PR 18).
//
// A level is one node row: two 16-byte loads of one sector for a linear
// node instead of 6 gathers; the row the descent ends on also gives the
// window.  Every lane runs the reference's `depth` levels, a lane at its
// leaf re-reading that row from L1: a descent that stopped at the leaf
// (a warp vote a level) measured 0.7-1.1% slower at 200M keys, where every
// warp walks both levels of the tree.

// A node row in registers (w1, b1, w2 only for MLP nodes).
struct NodeRow {
  float4 m;            // (a, b, err_lo, err_hi) / (0, b2, err_lo, err_hi)
  float4 r;            // (y_start, y_end, child_base, is_leaf)
  float4 w1, b1, w2;
};

template <bool kMlp>
__device__ __forceinline__ void load_node(const float4* rows, int node,
                                          NodeRow& n) {
  const float4* p = rows + (kMlp ? 5 : 2) * static_cast<long long>(node);
  n.m = __ldg(p);
  n.r = __ldg(p + 1);
  if (kMlp) {
    n.w1 = __ldg(p + 2);
    n.b1 = __ldg(p + 3);
    n.w2 = __ldg(p + 4);
  }
}

template <bool kMlp>
__device__ __forceinline__ float node_predict(const NodeRow& n, float q) {
  return kMlp ? mlp_predict(n.m.y, n.w1, n.b1, n.w2, q)
              : __fadd_rn(__fmul_rn(n.m.x, q), n.m.y);
}

template <bool kMlp>
__global__ void __launch_bounds__(kTileThreads)
rmrt_lookup_kernel(Tables t, const float4* __restrict__ rows, int fanout,
                   int depth, const float* __restrict__ q, int nq,
                   int* __restrict__ out) {
  const long long w = warp_tile();
  if (w >= nq) return;                  // whole warps only
  const int i = static_cast<int>(w) + (threadIdx.x & 31);
  const bool valid = i < nq;
  const float x = valid ? q[i] : 0.0f;
  const float ffan = static_cast<float>(fanout);
  int lo = 0, hi = 0;
  if (valid) {
    NodeRow n;
    load_node<kMlp>(rows, 0, n);
    int node = 0;
    for (int d = 0; d < depth; ++d) {
      const float ys = n.r.x;
      const float span = __fsub_rn(n.r.y, ys);
      int child = __float2int_rz(__fdiv_rn(
          __fmul_rn(__fsub_rn(node_predict<kMlp>(n, x), ys), ffan), span));
      child = min(max(child, 0), fanout - 1);
      if (!(n.r.w > 0.5f)) node = __float2int_rz(n.r.z) + child;
      load_node<kMlp>(rows, node, n);
    }
    bounds(t, node_predict<kMlp>(n, x), n.m.z, n.m.w, lo, hi);
  }
  const int pos = leaf_search<true, true>(t, x, valid, lo, hi);
  if (valid) out[i] = pos;
}

// ---------------------------------------------------------------------------
// Shard-stacked K1-K3: one launch answers the queries of many indexes (the
// shards of core/distributed.py, stacked on one card).  Each query carries
// the id of its index; each lane reads that index's descriptor -- its
// Tables, leaf rows and delta tier -- from a small device array and runs the
// single-index item body on it.  A warp whose lanes belong to several
// indexes is right as it is: every chain of the item bodies is a lane's
// own, and a warp vote only asks whether any lane still has work.  K3's
// two lanes of a pair share the pair's index.  A lane whose id lies outside
// [0, n_tabs) reads no tables and answers -1.
struct ShardTables {
  Tables t;
  const float4* rows;  // leaf rows (K1; K2 with MLP leaves), or null
  const float* dk;     // the delta tier (K2, K3), or null
  int nd;
  int d_iters;
};

template <bool kMlpRoot, bool kMlpLeaf>
__global__ void __launch_bounds__(kTileThreads)
sharded_lookup_kernel(const ShardTables* __restrict__ tabs, int n_tabs,
                      const int* __restrict__ shard,
                      const float* __restrict__ q, int nq,
                      int* __restrict__ out) {
  const long long w = warp_tile();
  if (w >= nq) return;                  // whole warps only
  const int i = static_cast<int>(w) + (threadIdx.x & 31);
  const int id = i < nq ? shard[i] : 0;
  const bool known = id >= 0 && id < n_tabs;
  const ShardTables s = tabs[known ? id : 0];
  lookup_item<kMlpRoot, kMlpLeaf>(s.t, s.rows, q, i, i < nq && known, out);
  if (i < nq && !known) out[i] = -1;
}

template <bool kMlpRoot, bool kMlpLeaf>
__global__ void __launch_bounds__(kTileThreads)
sharded_dynamic_lookup_kernel(const ShardTables* __restrict__ tabs,
                              int n_tabs, const int* __restrict__ shard,
                              const float* __restrict__ q, int nq,
                              int* __restrict__ out, int* __restrict__ dout) {
  const long long w = warp_tile();
  if (w >= nq) return;                  // whole warps only
  const int i = static_cast<int>(w) + (threadIdx.x & 31);
  const int id = i < nq ? shard[i] : 0;
  const bool known = id >= 0 && id < n_tabs;
  const ShardTables s = tabs[known ? id : 0];
  dynamic_lookup_item<kMlpRoot, kMlpLeaf>(s.t, s.rows, q, i, i < nq && known,
                                          s.dk, s.nd, s.d_iters, out, dout);
  if (i < nq && !known) out[i] = dout[i] = -1;
}

template <bool kMlpRoot, bool kMlpLeaf>
__global__ void __launch_bounds__(kTileThreads)
sharded_dynamic_range_kernel(const ShardTables* __restrict__ tabs,
                             int n_tabs, const int* __restrict__ shard,
                             const float* __restrict__ qlo,
                             const float* __restrict__ qhi, int nq,
                             int* __restrict__ blo, int* __restrict__ bhi,
                             int* __restrict__ dlo, int* __restrict__ dhi) {
  const long long w = warp_tile();
  if (w >= 2LL * nq) return;            // whole warps only
  const long long j = w + (threadIdx.x & 31);
  const bool valid = j < 2LL * nq;
  const int id = valid ? shard[j >> 1] : 0;
  const bool known = id >= 0 && id < n_tabs;
  const ShardTables s = tabs[known ? id : 0];
  dynamic_range_item<kMlpRoot, kMlpLeaf>(s.t, qlo, qhi, j, valid && known,
                                         s.dk, s.nd, s.d_iters, blo, bhi, dlo,
                                         dhi);
  if (valid && !known) {
    const int p = static_cast<int>(j >> 1);
    (j & 1 ? bhi : blo)[p] = -1;
    (j & 1 ? dhi : dlo)[p] = -1;
  }
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
  t.fence = nullptr;
  t.nf = 0;
  return t;
}

// The fence of n_keys keys (kernels/lookup.py key_fence): ceil(n / 64)
// entries.
void set_fence(Tables& t, const void* fence) {
  t.fence = static_cast<const float*>(fence);
  t.nf = static_cast<int>((static_cast<long long>(t.n_keys) + 63) >>
                          kFenceShift);
}

// Launch a kernel over `items` work items, one a thread, in warp tiles.
template <typename Kernel, typename... Args>
int launch_tiles(Kernel kernel, long long items, void* stream,
                 Args... args) {
  const unsigned grid =
      static_cast<unsigned>((items + kTileThreads - 1) / kTileThreads);
  kernel<<<grid, kTileThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() after the launch (or
// cudaErrorInvalidValue, without launching, when rows it must read are
// missing).  root_mlp / leaf_mlp (0 or 1) pick the template instantiation.
#define REPRO_PICK(KERNEL)                                                 \
  (root_mlp ? (leaf_mlp ? KERNEL<true, true> : KERNEL<true, false>)        \
            : (leaf_mlp ? KERNEL<false, true> : KERNEL<false, false>))

// K1.  The leaves are read from `rows` alone (kernels/lookup.py leaf_rows of
// the leaf kind), mat / vec are not read; `fence` is key_fence(keys).
extern "C" int repro_lookup(const void* q, int nq, const void* root,
                            const void* mat, const void* vec, int lp,
                            int n_leaves, float ratio, const void* keys,
                            int n_keys, float lo_max, float hi_max, int iters,
                            int root_mlp, int leaf_mlp, const void* rows,
                            const void* fence, void* out, void* stream) {
  if (rows == nullptr || fence == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Tables t = make_tables(root, mat, vec, lp, n_leaves, ratio, keys, n_keys,
                         lo_max, hi_max, iters);
  set_fence(t, fence);
  return launch_tiles(REPRO_PICK(lookup_kernel), nq, stream, t,
                      static_cast<const float4*>(rows),
                      static_cast<const float*>(q), nq,
                      static_cast<int*>(out));
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
  return launch_tiles(REPRO_PICK(dynamic_lookup_kernel), nq, stream, t,
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
  return launch_tiles(REPRO_PICK(dynamic_range_kernel), 2LL * nq, stream, t,
                      static_cast<const float*>(qlo),
                      static_cast<const float*>(qhi), nq,
                      static_cast<const float*>(dk), nd, d_iters,
                      static_cast<int*>(blo), static_cast<int*>(bhi),
                      static_cast<int*>(dlo), static_cast<int*>(dhi));
}

// K4.  The nodes are read from `rows` alone (kernels/lookup.py node_rows of
// the node kind, mlp 0 or 1: 8 floats a linear node, 20 an MLP node),
// pack_rmrt's lane-major mat (3H, npad) / vec (8, npad) are not read;
// `fence` is key_fence(keys).
extern "C" int repro_rmrt_lookup(const void* q, int nq, const void* mat,
                                 const void* vec, int npad, const void* rows,
                                 const void* fence, int fanout, int depth,
                                 int mlp, const void* keys, int n_keys,
                                 float lo_max, float hi_max, int iters,
                                 void* out, void* stream) {
  if (rows == nullptr || fence == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Tables t = make_tables(nullptr, mat, vec, npad, 0, 0.0f, keys, n_keys,
                         lo_max, hi_max, iters);
  set_fence(t, fence);
  return launch_tiles(mlp ? rmrt_lookup_kernel<true>
                          : rmrt_lookup_kernel<false>,
                      nq, stream, t, static_cast<const float4*>(rows), fanout,
                      depth, static_cast<const float*>(q), nq,
                      static_cast<int*>(out));
}

// ---------------------------------------------------------------------------
// Shard-stacked K1-K3.  `tabs` is a device array of n_tabs ShardTables,
// one an index, filled on the host by repro_set_shard_tables into a buffer
// of repro_shard_tables_size() bytes an index and copied to the card;
// `shard` the (nq,) int32 index of each query (of each pair, for K3).  The caller
// checks what each kernel reads: rows and fences for K1, rows for K2 with
// MLP leaves, the delta tier for K2 and K3.
extern "C" int repro_shard_tables_size() {
  return static_cast<int>(sizeof(ShardTables));
}

extern "C" int repro_set_shard_tables(void* buf, int s, const void* root,
                                      const void* mat, const void* vec,
                                      int lp, int n_leaves, float ratio,
                                      const void* keys, int n_keys,
                                      float lo_max, float hi_max, int iters,
                                      const void* rows, const void* fence,
                                      const void* dk, int nd, int d_iters) {
  ShardTables& d = static_cast<ShardTables*>(buf)[s];
  d.t = make_tables(root, mat, vec, lp, n_leaves, ratio, keys, n_keys,
                    lo_max, hi_max, iters);
  if (fence != nullptr) set_fence(d.t, fence);
  d.rows = static_cast<const float4*>(rows);
  d.dk = static_cast<const float*>(dk);
  d.nd = nd;
  d.d_iters = d_iters;
  return 0;
}

extern "C" int repro_sharded_lookup(const void* q, const void* shard, int nq,
                                    const void* tabs, int n_tabs,
                                    int root_mlp, int leaf_mlp, void* out,
                                    void* stream) {
  return launch_tiles(REPRO_PICK(sharded_lookup_kernel), nq, stream,
                      static_cast<const ShardTables*>(tabs), n_tabs,
                      static_cast<const int*>(shard),
                      static_cast<const float*>(q), nq,
                      static_cast<int*>(out));
}

extern "C" int repro_sharded_dynamic_lookup(const void* q, const void* shard,
                                            int nq, const void* tabs,
                                            int n_tabs, int root_mlp,
                                            int leaf_mlp, void* out,
                                            void* dout, void* stream) {
  return launch_tiles(REPRO_PICK(sharded_dynamic_lookup_kernel), nq, stream,
                      static_cast<const ShardTables*>(tabs), n_tabs,
                      static_cast<const int*>(shard),
                      static_cast<const float*>(q), nq,
                      static_cast<int*>(out), static_cast<int*>(dout));
}

extern "C" int repro_sharded_dynamic_range(const void* qlo, const void* qhi,
                                           const void* shard, int nq,
                                           const void* tabs, int n_tabs,
                                           int root_mlp, int leaf_mlp,
                                           void* blo, void* bhi, void* dlo,
                                           void* dhi, void* stream) {
  return launch_tiles(REPRO_PICK(sharded_dynamic_range_kernel), 2LL * nq,
                      stream, static_cast<const ShardTables*>(tabs), n_tabs,
                      static_cast<const int*>(shard),
                      static_cast<const float*>(qlo),
                      static_cast<const float*>(qhi), nq,
                      static_cast<int*>(blo), static_cast<int*>(bhi),
                      static_cast<int*>(dlo), static_cast<int*>(dhi));
}
