"""Fused learned-index lookup: host-side table packing, the four kernel
wrappers (K1-K4) and each kernel's plain PyTorch version.

Each lookup runs four stages per query: root routing, leaf predict from
the packed tables, the error-bound window clamped to [0, n_keys), and a
branchless search of that window at a static depth.  The CUDA kernels are
in ``csrc/lookup.cu``; on a CUDA tensor a wrapper launches its kernel (or
raises), on a CPU tensor it runs the plain version, which computes the
same f32 arithmetic in the same order, so the two agree bit for bit.

Packed tables (the reference's row meaning, ``repro/kernels/lookup.py``):

  root (8, 128) f32    linear root: [0,0] = a, [3,0] = b
                       mlp root: rows 0/1/2 = w1/b1/w2 over H lanes,
                       [3,0] = b2
  mat  (3H, Lp) f32    rows [0, H) w1, [H, 2H) b1, [2H, 3H) w2; a linear
                       leaf rides in w1[0] (its slope)
  vec  (8, Lp)  f32    row 0 b2 / intercept, row 1 err_lo, row 2 err_hi

with leaves on the last axis, padded to Lp (a multiple of 128).  Padded
lanes are never read: buckets are clipped to n_leaves - 1.  RMRT node
tables (:func:`pack_rmrt`) use the same layout with nodes on the last
axis, plus vec rows 3 y_start, 4 y_end, 5 child_base (f32-exact: fewer
than 2**24 nodes) and 6 is_leaf (0.0 / 1.0).

The kernels read leaves and nodes from row-major copies of these tables
(:func:`leaf_rows`, :func:`node_rows`: a leaf's or node's words side by
side, so that they come in one or two 32-byte sectors) and K1 and K4
search a window first on :func:`key_fence`, every 64th key; the
indexes cache all three beside their packed tables and f32 keys.  The
plain versions read the packed tables: the rows change what the kernels
load, not what they compute.

K1-K3 also have shard-stacked entries (:func:`sharded_lookup`,
:func:`sharded_dynamic_lookup`, :func:`sharded_dynamic_range`): S indexes'
tables stacked on a leading axis, each query tagged with its index, one
launch for all of them.  Their plain versions loop over the indexes,
calling the single-index plain versions.

An MLP predicts ``b2 + relu(q*w1_0 + b1_0)*w2_0 + ... + relu(...)*w2_3``
in that order (the reference's leaf order); the MLP root sums its four
terms sequentially from 0 and adds b2 last, the order XLA:CPU uses for
the eager oracle's ``jnp.sum`` (:func:`mlp_root_predict`).

Semantics kept from the reference: f32 key space; +inf capacity padding;
left boundaries (``kv < q``) and right boundaries (``kv <= q``); the
static search depth from :func:`search_iters`; float->int32 conversions
that saturate (NaN -> 0); window clamps at ``n_keys - 1`` and ``n_keys``
rounded to f32 (at ``n_keys = 2**28`` both are 2**28).  The TPU's query
tiling and per-key-tile min-merge are not copied: the search runs once
over the global key array.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..core.bounds import clamped_depth, window_widths
from . import build

H = 4              # the paper's hidden width
ROOT_ROWS = 8      # packed root block rows
ROOT_LANES = 128   # packed root block lanes

KINDS = ("linear", "mlp")
FENCE = 64         # keys a fence entry stands for (csrc/lookup.cu kFenceShift)

# Launches of each CUDA kernel; incremented only where a kernel launches.
LAUNCHES = {"lookup": 0, "dynamic_lookup": 0, "dynamic_range": 0,
            "rmrt_lookup": 0, "sharded_lookup": 0,
            "sharded_dynamic_lookup": 0, "sharded_dynamic_range": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def search_iters(err_lo, err_hi, n_keys: int) -> int:
    """Static search depth for an index with the given leaf bounds (§4):
    ceil(log2(widest live window)) + 1, not ceil(log2(n_keys)) + 1."""
    return clamped_depth(window_widths(err_lo, err_hi), n_keys)


def full_iters(n_keys: int) -> int:
    """Unclamped depth: the classic ceil(log2(n)) + 1."""
    return int(math.ceil(math.log2(max(n_keys, 2)))) + 1


def pack_root(root_kind: str, params, route_scale: float = 1.0
              ) -> torch.Tensor:
    """(ROOT_ROWS, ROOT_LANES) f32 block holding the root model, with a
    routing rescale folded in (``route_scale``, f64 product then f32; the
    output layer of an MLP root)."""
    f64, f32 = torch.float64, torch.float32
    if root_kind == "linear":
        blk = torch.zeros((ROOT_ROWS, ROOT_LANES), dtype=f32,
                          device=params.a.device)
        blk[0, 0] = (params.a.to(f64) * route_scale).to(f32)
        blk[3, 0] = (params.b.to(f64) * route_scale).to(f32)
        return blk
    blk = torch.zeros((ROOT_ROWS, ROOT_LANES), dtype=f32,
                      device=params.w1.device)
    blk[0, :H] = params.w1.to(f32)
    blk[1, :H] = params.b1.to(f32)
    blk[2, :H] = (params.w2.to(f64) * route_scale).to(f32)
    blk[3, 0] = (params.b2.to(f64) * route_scale).to(f32)
    return blk


def pack_leaves(w1, b1, w2, b2, err_lo, err_hi):
    """Lane-major leaf tables: (3H, Lp) params + (8, Lp) scalars, Lp the
    128-multiple pad of L.  w1/b1/w2: (L, H); b2/err_lo/err_hi: (L,)."""
    L = w1.shape[0]
    lp = -(-L // 128) * 128
    dev = w1.device
    mat = torch.zeros((3 * H, lp), dtype=torch.float32, device=dev)
    for i, a in enumerate((w1, b1, w2)):
        mat[i * H:(i + 1) * H, :L] = a.to(torch.float32).T
    vec = torch.zeros((8, lp), dtype=torch.float32, device=dev)
    for row, a in ((0, b2), (1, err_lo), (2, err_hi)):
        vec[row, :L] = a.to(torch.float32)
    return mat, vec


def pad_packed_leaves(mat, vec, n_live: int, lp_to: int):
    """Re-pad packed leaf tables to ``lp_to`` lanes, replicating the last
    live leaf into every lane past ``n_live - 1`` (an overshot routing
    bucket then sees exactly the window of the last leaf)."""
    lane = torch.clamp(torch.arange(lp_to, device=mat.device),
                       max=max(n_live - 1, 0))
    return mat[..., lane], vec[..., lane]


def _pow2ceil(v: int) -> int:
    return 1 << max(int(v) - 1, 1).bit_length()


def capacity_class(n: int, floor: int = 128) -> int:
    """Pow2 capacity bucket of a tier holding ``n`` finite entries (floor:
    one 128-entry lane tile); tier shapes change only on pow2 crossings."""
    return max(_pow2ceil(max(int(n), 1)), floor)


def pad_capacity(keys: torch.Tensor, cap: int) -> torch.Tensor:
    """+inf-pad a sorted tier to its capacity class."""
    pad = torch.full((cap - keys.shape[0],), math.inf, dtype=keys.dtype,
                     device=keys.device)
    return torch.cat([keys, pad])


def pad_delta(delta_keys: torch.Tensor,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """+inf-pad the delta tier to a 128-multiple (floor 128), in ``dtype``."""
    nd = delta_keys.shape[0]
    ndp = max(-(-max(nd, 1) // 128) * 128, 128)
    pad = torch.full((ndp - nd,), math.inf, dtype=dtype,
                     device=delta_keys.device)
    return torch.cat([delta_keys.to(dtype), pad])


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the kernel stages (same f32 ops, same order).
# ---------------------------------------------------------------------------
def trunc_clip(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """``clip(x.astype(int32), lo, hi)`` with XLA's saturating conversion
    (NaN -> 0, out-of-range -> INT32 extremes).  Torch's own conversion
    does not saturate (+inf -> INT32_MIN on the CPU), so clamp in floating
    point to [lo - 1, hi + 1] first; the integer clip makes that
    equivalent."""
    x = torch.where(torch.isnan(x), torch.zeros_like(x),
                    x.clamp(lo - 1, hi + 1))
    return x.to(torch.int32).clamp(lo, hi)


def clip_to_i32(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip(x, lo, hi).astype(int32)`` for window bounds: NaN
    propagates through the clip and converts to 0."""
    x = x.clamp(lo, hi)
    return torch.where(torch.isnan(x), torch.zeros_like(x), x).to(torch.int32)


def _f32(v: float) -> float:
    """A Python float rounded to f32, as JAX rounds a weakly typed scalar
    meeting an f32 array."""
    return float(np.float32(v))


def relu(x: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum(x, 0)``: NaN propagates."""
    return torch.where(x < 0, torch.zeros_like(x), x)


def mlp_root_predict(q, root):
    """The MLP root's f32 prediction from the packed block: the four
    hidden terms summed sequentially from 0, then + b2 -- XLA:CPU's order
    for the reference oracle's ``jnp.sum(h * w2, axis=1) + b2``."""
    s = torch.zeros_like(q)
    for k in range(H):
        s = s + relu(q * root[0, k] + root[1, k]) * root[2, k]
    return s + root[3, 0]


def route_bucket(q, root, *, n_leaves: int, route_n: int,
                 root_kind: str = "linear"):
    """Stage 1: each query's leaf, int32 in [0, n_leaves)."""
    if root_kind == "linear":
        rpred = root[0, 0] * q + root[3, 0]
    else:
        rpred = mlp_root_predict(q, root)
    return trunc_clip(rpred * _f32(n_leaves / route_n), 0, n_leaves - 1)


def lane_predict(q, mat, vec, j, kind: str):
    """Model predict of lanes ``j`` (int64, one per query) of packed
    (3H, lp) / (8, lp) tables, f32 in the kernels' order."""
    lp = mat.shape[1]
    fm, fv = mat.reshape(-1), vec.reshape(-1)
    if kind == "linear":
        return fm[j] * q + fv[j]
    pred = fv[j]
    for k in range(H):
        h = relu(q * fm[j + k * lp] + fm[j + (H + k) * lp])
        pred = pred + h * fm[j + (2 * H + k) * lp]
    return pred


def lane_window(pred, vec, j, n_keys: int):
    """Stage 3: the error-bound window of lanes ``j`` around ``pred``,
    clamped to [0, n_keys) with f32-rounded clamps: (lo, hi) int32."""
    lp = vec.shape[1]
    fv = vec.reshape(-1)
    lo = clip_to_i32(torch.floor(pred + fv[j + lp]), 0.0, _f32(n_keys - 1))
    hi = clip_to_i32(torch.ceil(pred + fv[j + 2 * lp]) + 1.0, 1.0,
                     _f32(n_keys))
    return lo, hi


def route_window(q, root, mat, vec, *, n_keys: int, n_leaves: int,
                 route_n: int, root_kind: str = "linear",
                 leaf_kind: str = "linear"):
    """Stages 1-3: (lo, hi) int32 windows."""
    b = route_bucket(q, root, n_leaves=n_leaves, route_n=route_n,
                     root_kind=root_kind).long()
    return lane_window(lane_predict(q, mat, vec, b, leaf_kind), vec, b,
                       n_keys)


def window_search(keys, q, lo, hi, iters: int, right: bool = False):
    """Branchless search of ``keys[lo:hi)`` at static depth ``iters``:
    the left boundary (first key >= q) or, with ``right``, the right
    boundary (first key > q).  Positions at or past ``len(keys)`` read as
    +inf.  Returns the raw converged ``lo`` (callers apply their own
    window-miss convention)."""
    n = keys.shape[0]
    inf = torch.tensor(math.inf, dtype=keys.dtype, device=keys.device)
    l, h = lo, hi
    for _ in range(iters):
        active = h > l
        mid = torch.div(l + h, 2, rounding_mode="floor")
        kv = torch.where(mid < n, keys[mid.clamp(0, n - 1).long()], inf)
        below = kv <= q if right else kv < q
        l = torch.where(active & below, mid + 1, l)
        h = torch.where(active & ~below, mid, h)
    return l


def _window_result(l, hi, n_keys: int):
    """A window miss returns min(hi, n_keys), as the reference's merge."""
    return torch.where(l < hi, l, torch.clamp(hi, max=n_keys))


def full_probe(dk, q, right: bool = False):
    """Full-depth search of the +inf-padded delta tier ``dk``."""
    nd = dk.shape[0]
    lo = torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    hi = torch.full(q.shape, nd, dtype=torch.int32, device=q.device)
    return window_search(dk, q, lo, hi, full_iters(nd), right=right)


def lookup_plain(queries, root, mat, vec, keys, *, n_leaves: int,
                 route_n: int | None = None, iters: int | None = None,
                 root_kind: str = "linear", leaf_kind: str = "linear"):
    """Plain version of K1: window-clamped left boundaries (Q,) int32."""
    S = keys.shape[0]
    iters = full_iters(S) if iters is None else iters
    lo, hi = route_window(queries, root, mat, vec, n_keys=S,
                          n_leaves=n_leaves, route_n=route_n or S,
                          root_kind=root_kind, leaf_kind=leaf_kind)
    return _window_result(window_search(keys, queries, lo, hi, iters), hi, S)


def dynamic_lookup_plain(queries, root, mat, vec, keys, delta_keys, *,
                         n_leaves: int, route_n: int | None = None,
                         iters: int | None = None, root_kind: str = "linear",
                         leaf_kind: str = "linear"):
    """Plain version of K2: (base_pos, delta_pos)."""
    base = lookup_plain(queries, root, mat, vec, keys, n_leaves=n_leaves,
                        route_n=route_n, iters=iters, root_kind=root_kind,
                        leaf_kind=leaf_kind)
    return base, full_probe(delta_keys, queries)


def dynamic_range_plain(q_lo, q_hi, root, mat, vec, keys, delta_keys, *,
                        n_leaves: int, route_n: int | None = None,
                        iters: int | None = None, root_kind: str = "linear",
                        leaf_kind: str = "linear"):
    """Plain version of K3: (base_lo, base_hi, delta_lo, delta_hi) -- left
    boundaries of ``q_lo``, right boundaries of ``q_hi``, both tiers."""
    S = keys.shape[0]
    iters = full_iters(S) if iters is None else iters
    win = dict(n_keys=S, n_leaves=n_leaves, route_n=route_n or S,
               root_kind=root_kind, leaf_kind=leaf_kind)
    lo, hi = route_window(q_lo, root, mat, vec, **win)
    blo = _window_result(window_search(keys, q_lo, lo, hi, iters), hi, S)
    lo, hi = route_window(q_hi, root, mat, vec, **win)
    bhi = _window_result(window_search(keys, q_hi, lo, hi, iters, right=True),
                         hi, S)
    return (blo, bhi, full_probe(delta_keys, q_lo),
            full_probe(delta_keys, q_hi, right=True))


# ---------------------------------------------------------------------------
# Wrappers: kernel on CUDA tensors, plain version on CPU tensors.
# ---------------------------------------------------------------------------
def _prepare(tensors: dict, *, n_leaves: int, route_n, iters, root_kind,
             leaf_kind):
    """Validate what the kernels take.  Returns (on_cuda, route_n, iters)
    with the defaults filled in: ``route_n`` the key count, ``iters`` the
    full search depth."""
    if root_kind not in KINDS or leaf_kind not in KINDS:
        raise ValueError(f"model kinds must be in {KINDS}, got "
                         f"{root_kind!r}/{leaf_kind!r}")
    devs = {t.device for t in tensors.values()}
    if len(devs) != 1:
        raise ValueError(f"lookup inputs on several devices: {devs}")
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    root, mat, vec, keys = (tensors[k] for k in ("root", "mat", "vec",
                                                  "keys"))
    if tuple(root.shape) != (ROOT_ROWS, ROOT_LANES):
        raise ValueError(f"root must be {(ROOT_ROWS, ROOT_LANES)}, got "
                         f"{tuple(root.shape)}")
    if mat.dim() != 2 or mat.shape[0] != 3 * H or vec.dim() != 2 \
            or vec.shape[0] != 8 or vec.shape[1] != mat.shape[1]:
        raise ValueError("mat/vec must be packed (3H, Lp)/(8, Lp) tables")
    if not 1 <= n_leaves <= mat.shape[1]:
        raise ValueError(f"n_leaves={n_leaves} outside [1, {mat.shape[1]}]")
    if keys.dim() != 1 or not 0 < keys.shape[0] < 2 ** 31 - 1:
        raise ValueError("keys must be a non-empty 1-D tensor with int32 "
                         "positions")
    S = keys.shape[0]
    return (next(iter(devs)).type == "cuda", route_n or S,
            full_iters(S) if iters is None else iters)


def _table_args(root, mat, vec, keys, *, n_leaves, route_n, iters,
                root_kind, leaf_kind):
    S = keys.shape[0]
    return (root.data_ptr(), mat.data_ptr(), vec.data_ptr(), mat.shape[1],
            n_leaves, _f32(n_leaves / route_n), keys.data_ptr(), S,
            _f32(S - 1), _f32(S), iters, int(root_kind == "mlp"),
            int(leaf_kind == "mlp"))


def leaf_rows(mat: torch.Tensor, vec: torch.Tensor,
              kind: str = "mlp") -> torch.Tensor:
    """Leaf-major copy of packed leaf tables, one row a leaf, in a fresh
    (so 16-byte aligned) allocation: linear leaves (Lp, 4) f32, 16 bytes
    holding a, b, err_lo, err_hi; MLP leaves (Lp, 16), 64 bytes holding w1,
    b1, w2 (H each), b2, err_lo, err_hi and a zero pad.  K1 reads a leaf
    with one 16-byte load (four for an MLP leaf) instead of 4 (15)
    lane-major gathers, K2 its MLP leaves.  The index caches them beside
    its packed tables (``RMIIndex.leaf_rows``)."""
    if kind == "linear":
        return torch.stack([mat[0], vec[0], vec[1], vec[2]], 1).contiguous()
    return torch.cat([mat.T, vec[:3].T, torch.zeros_like(vec[:1].T)],
                     1).contiguous()


def node_rows(mat: torch.Tensor, vec: torch.Tensor,
              kind: str) -> torch.Tensor:
    """Node-major copy of ``pack_rmrt`` tables for K4, one row a node, in a
    fresh allocation: linear nodes (Np, 8) f32, 32 bytes -- one sector --
    holding a, b, err_lo, err_hi, y_start, y_end, child_base, is_leaf; MLP
    nodes (Np, 20), 80 bytes holding 0, b2, err_lo, err_hi, y_start, y_end,
    child_base, is_leaf, then w1, b1, w2 (H each).  The RMRT caches them
    beside its packed tables (``RMRTIndex.node_rows``)."""
    head = mat[0] if kind == "linear" else torch.zeros_like(mat[0])
    cols = [head, *vec[:7]]
    if kind != "linear":
        cols += list(mat)
    return torch.stack(cols, 1).contiguous()


def key_fence(keys: torch.Tensor) -> torch.Tensor:
    """Every FENCE-th key of sorted f32 ``keys`` (positions 0, 64, ...):
    (ceil(S / 64),) f32 in a fresh allocation, 12.5 MB at 200M keys.  K1
    and K4 search a converged window on it first, so that the window's
    first probes hit L2.  The index caches it beside its f32 keys."""
    return keys[::FENCE].contiguous()


def _row_words(kind: str, nodes: bool) -> int:
    if nodes:
        return 8 if kind == "linear" else 8 + 3 * H
    return 4 if kind == "linear" else 4 * H


def _check_rows(rows, mat, kind: str, nodes: bool = False) -> None:
    """Raise unless ``rows`` is what :func:`leaf_rows` (:func:`node_rows`)
    gives for these tables: shape, dtype, contiguity, device, and the
    16-byte alignment of the kernels' vector loads."""
    want = (mat.shape[1], _row_words(kind, nodes))
    if tuple(rows.shape) != want or rows.dtype != torch.float32:
        raise ValueError(f"rows must be {want} float32 ({kind} "
                         f"{'nodes' if nodes else 'leaves'}), got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    if not rows.is_contiguous() or rows.data_ptr() % 16:
        raise ValueError("rows must be contiguous and 16-byte aligned")
    if rows.device != mat.device:
        raise ValueError(f"rows on {rows.device}, tables on {mat.device}")


def _check_fence(fence, keys) -> None:
    """Raise unless ``fence`` has the shape, dtype and device of
    :func:`key_fence` of ``keys`` and is contiguous."""
    want = (-(-keys.shape[0] // FENCE),)
    if tuple(fence.shape) != want or fence.dtype != torch.float32 \
            or not fence.is_contiguous() or fence.device != keys.device:
        raise ValueError(f"fence must be a contiguous {want} float32 tensor "
                         f"on {keys.device} (key_fence of the keys), got "
                         f"{tuple(fence.shape)} {fence.dtype} on "
                         f"{fence.device}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def lookup(queries, root, mat, vec, keys, *, n_leaves: int,
           route_n: int | None = None, iters: int | None = None,
           root_kind: str = "linear", leaf_kind: str = "linear", rows=None,
           fence=None):
    """K1 (replaces ``repro.kernels.lookup.lookup_pallas``): window-clamped
    left boundaries of f32 ``queries`` in sorted f32 ``keys``, (Q,) int32.
    ``iters`` is the static window search depth (:func:`search_iters`);
    ``route_n`` the routing scale (defaults to ``len(keys)``).  The kernel
    reads the leaves from ``rows`` (:func:`leaf_rows` of these tables) and
    searches ``fence`` (:func:`key_fence` of ``keys``) first, as the index
    caches them; the wrapper builds what it is not given."""
    on_cuda, route_n, iters = _prepare(
        dict(queries=queries, root=root, mat=mat, vec=vec, keys=keys),
        n_leaves=n_leaves, route_n=route_n, iters=iters, root_kind=root_kind,
        leaf_kind=leaf_kind)
    if rows is not None:
        _check_rows(rows, mat, leaf_kind)
    if fence is not None:
        _check_fence(fence, keys)
    kinds = dict(root_kind=root_kind, leaf_kind=leaf_kind)
    if not on_cuda:
        return lookup_plain(queries, root, mat, vec, keys, n_leaves=n_leaves,
                            route_n=route_n, iters=iters, **kinds)
    out = torch.empty(queries.shape, dtype=torch.int32, device=queries.device)
    nq = queries.shape[0]
    if nq:
        if rows is None:
            rows = leaf_rows(mat, vec, leaf_kind)
        if fence is None:
            fence = key_fence(keys)
        with torch.cuda.device(queries.device):
            rc = build.library("lookup").repro_lookup(
                queries.data_ptr(), nq,
                *_table_args(root, mat, vec, keys, n_leaves=n_leaves,
                             route_n=route_n, iters=iters, **kinds),
                rows.data_ptr(), fence.data_ptr(), out.data_ptr(),
                _stream(queries))
        build.check(rc, "lookup")
        LAUNCHES["lookup"] += 1
    return out


def dynamic_lookup(queries, root, mat, vec, keys, delta_keys, *,
                   n_leaves: int, route_n: int | None = None,
                   iters: int | None = None, root_kind: str = "linear",
                   leaf_kind: str = "linear", rows=None):
    """K2 (replaces ``dynamic_lookup_pallas``): (base_pos, delta_pos) --
    K1 over the base tier at the frozen ``route_n`` plus a full-depth left
    boundary probe of the +inf-padded f32 delta tier.  MLP leaves are read
    from ``rows`` (:func:`leaf_rows`, built here when not given), linear
    ones from the lane-major tables."""
    on_cuda, route_n, iters = _prepare(
        dict(queries=queries, root=root, mat=mat, vec=vec, keys=keys,
             delta_keys=delta_keys),
        n_leaves=n_leaves, route_n=route_n, iters=iters, root_kind=root_kind,
        leaf_kind=leaf_kind)
    if rows is not None:
        _check_rows(rows, mat, leaf_kind)
    kinds = dict(root_kind=root_kind, leaf_kind=leaf_kind)
    if not on_cuda:
        return dynamic_lookup_plain(queries, root, mat, vec, keys, delta_keys,
                                    n_leaves=n_leaves, route_n=route_n,
                                    iters=iters, **kinds)
    out = torch.empty(queries.shape, dtype=torch.int32, device=queries.device)
    dout = torch.empty_like(out)
    nq, nd = queries.shape[0], delta_keys.shape[0]
    if nq:
        if leaf_kind == "linear":
            rows = None
        elif rows is None:
            rows = leaf_rows(mat, vec)
        with torch.cuda.device(queries.device):
            rc = build.library("lookup").repro_dynamic_lookup(
                queries.data_ptr(), nq,
                *_table_args(root, mat, vec, keys, n_leaves=n_leaves,
                             route_n=route_n, iters=iters, **kinds),
                None if rows is None else rows.data_ptr(),
                delta_keys.data_ptr(), nd, full_iters(nd), out.data_ptr(),
                dout.data_ptr(), _stream(queries))
        build.check(rc, "dynamic_lookup")
        LAUNCHES["dynamic_lookup"] += 1
    return out, dout


def dynamic_range(q_lo, q_hi, root, mat, vec, keys, delta_keys, *,
                  n_leaves: int, route_n: int | None = None,
                  iters: int | None = None, root_kind: str = "linear",
                  leaf_kind: str = "linear"):
    """K3 (replaces ``dynamic_range_pallas``): (base_lo, base_hi, delta_lo,
    delta_hi) of endpoint pairs in one pass -- left boundaries of ``q_lo``,
    right boundaries of ``q_hi``, on both tiers."""
    if q_lo.shape != q_hi.shape:
        raise ValueError("endpoint arrays must pair up")
    on_cuda, route_n, iters = _prepare(
        dict(q_lo=q_lo, q_hi=q_hi, root=root, mat=mat, vec=vec, keys=keys,
             delta_keys=delta_keys),
        n_leaves=n_leaves, route_n=route_n, iters=iters, root_kind=root_kind,
        leaf_kind=leaf_kind)
    kinds = dict(root_kind=root_kind, leaf_kind=leaf_kind)
    if not on_cuda:
        return dynamic_range_plain(q_lo, q_hi, root, mat, vec, keys,
                                   delta_keys, n_leaves=n_leaves,
                                   route_n=route_n, iters=iters, **kinds)
    outs = [torch.empty(q_lo.shape, dtype=torch.int32, device=q_lo.device)
            for _ in range(4)]
    nq, nd = q_lo.shape[0], delta_keys.shape[0]
    if nq:
        with torch.cuda.device(q_lo.device):
            rc = build.library("lookup").repro_dynamic_range(
                q_lo.data_ptr(), q_hi.data_ptr(), nq,
                *_table_args(root, mat, vec, keys, n_leaves=n_leaves,
                             route_n=route_n, iters=iters, **kinds),
                delta_keys.data_ptr(), nd, full_iters(nd),
                *(o.data_ptr() for o in outs), _stream(q_lo))
        build.check(rc, "dynamic_range")
        LAUNCHES["dynamic_range"] += 1
    return tuple(outs)


# ---------------------------------------------------------------------------
# K4: the RMRT lookup over packed node tables.
# ---------------------------------------------------------------------------
def pack_rmrt(kind: str, params, is_leaf, child_base, y_start, y_end,
              err_lo, err_hi):
    """Lane-major RMRT node tables: (3H, Np) params + (8, Np) scalars, Np
    the 128-multiple pad of the node count N (row meaning at the top of
    this module).  ``child_base`` rides in f32, so N must stay below
    2**24."""
    N = int(is_leaf.shape[0])
    if N >= 1 << 24:        # raise (not assert): must survive python -O
        raise ValueError(
            f"RMRT node count {N} exceeds f32 integer resolution (2^24): "
            "child_base pointers in the packed f32 tables would be rounded "
            "silently -- raise leaf_cap or shard the tree")
    dev = is_leaf.device
    if kind == "linear":
        w1 = torch.zeros((N, H), dtype=torch.float32, device=dev)
        w1[:, 0] = params.a.to(torch.float32)
        zeros = torch.zeros_like(w1)
        b1, w2, b2 = zeros, zeros, params.b
    else:
        w1, b1, w2, b2 = params.w1, params.b1, params.w2, params.b2
    mat, vec = pack_leaves(w1, b1, w2, b2, err_lo, err_hi)
    for r, a in ((3, y_start), (4, y_end), (5, child_base), (6, is_leaf)):
        vec[r, :N] = a.to(torch.float32)
    return mat, vec


def rmrt_route_window(q, mat, vec, *, n_keys: int, fanout: int, depth: int,
                      kind: str = "linear"):
    """Stages 1-3 of K4: the depth-``depth`` masked descent over the node
    tables (per level: predict, re-bucket by ``fanout`` over [y_start,
    y_end], stop at ``is_leaf``), then the leaf's window: (lo, hi)."""
    npad = mat.shape[1]
    fv = vec.reshape(-1)
    node = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    ffan = float(fanout)
    for _ in range(depth):
        pred = lane_predict(q, mat, vec, node, kind)
        ys = fv[node + 3 * npad]
        span = fv[node + 4 * npad] - ys
        child = trunc_clip((pred - ys) * ffan / span, 0, fanout - 1)
        nxt = fv[node + 5 * npad].long() + child     # f32-exact ints
        node = torch.where(fv[node + 6 * npad] > 0.5, node, nxt)
    return lane_window(lane_predict(q, mat, vec, node, kind), vec, node,
                       n_keys)


def rmrt_lookup_plain(queries, mat, vec, keys, *, fanout: int, depth: int,
                      kind: str = "linear", iters: int | None = None):
    """Plain version of K4: window-clamped left boundaries (Q,) int32."""
    S = keys.shape[0]
    iters = full_iters(S) if iters is None else iters
    lo, hi = rmrt_route_window(queries, mat, vec, n_keys=S, fanout=fanout,
                               depth=depth, kind=kind)
    return _window_result(window_search(keys, queries, lo, hi, iters), hi, S)


def rmrt_lookup(queries, mat, vec, keys, *, fanout: int, depth: int,
                kind: str = "linear", iters: int | None = None, rows=None,
                fence=None):
    """K4 (replaces ``repro.kernels.lookup.rmrt_lookup_pallas``): the RMRT
    descent over ``pack_rmrt`` tables and the window-clamped left-boundary
    search of f32 ``queries`` in sorted f32 ``keys``, (Q,) int32.  The
    kernel reads the nodes from ``rows`` (:func:`node_rows` of these
    tables) and searches ``fence`` (:func:`key_fence` of ``keys``), as the
    RMRT caches them; the wrapper builds what it is not given."""
    tensors = dict(queries=queries, mat=mat, vec=vec, keys=keys)
    devs = {t.device for t in tensors.values()}
    if len(devs) != 1:
        raise ValueError(f"rmrt_lookup inputs on several devices: {devs}")
    for name, t in tensors.items():
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"{name} must be contiguous float32")
    if kind not in KINDS:
        raise ValueError(f"kind must be in {KINDS}, got {kind!r}")
    if mat.dim() != 2 or mat.shape[0] != 3 * H or vec.dim() != 2 \
            or vec.shape[0] != 8 or vec.shape[1] != mat.shape[1]:
        raise ValueError("mat/vec must be packed (3H, Np)/(8, Np) tables")
    if keys.dim() != 1 or not 0 < keys.shape[0] < 2 ** 31 - 1:
        raise ValueError("keys must be a non-empty 1-D tensor with int32 "
                         "positions")
    if fanout < 1 or depth < 1:
        raise ValueError("fanout and depth must be positive")
    if rows is not None:
        _check_rows(rows, mat, kind, nodes=True)
    if fence is not None:
        _check_fence(fence, keys)
    S = keys.shape[0]
    iters = full_iters(S) if iters is None else iters
    if next(iter(devs)).type != "cuda":
        return rmrt_lookup_plain(queries, mat, vec, keys, fanout=fanout,
                                 depth=depth, kind=kind, iters=iters)
    out = torch.empty(queries.shape, dtype=torch.int32, device=queries.device)
    nq = queries.shape[0]
    if nq:
        if rows is None:
            rows = node_rows(mat, vec, kind)
        if fence is None:
            fence = key_fence(keys)
        with torch.cuda.device(queries.device):
            rc = build.library("lookup").repro_rmrt_lookup(
                queries.data_ptr(), nq, mat.data_ptr(), vec.data_ptr(),
                mat.shape[1], rows.data_ptr(), fence.data_ptr(), fanout, depth,
                int(kind == "mlp"),
                keys.data_ptr(), S, _f32(S - 1), _f32(S), iters,
                out.data_ptr(), _stream(queries))
        build.check(rc, "rmrt_lookup")
        LAUNCHES["rmrt_lookup"] += 1
    return out


# ---------------------------------------------------------------------------
# Shard-stacked K1-K3: the tables of S indexes stacked on a leading axis
# (roots (S, 8, 128), mats (S, 3H, Lp), vecs (S, 8, Lp), keys (S, n), delta
# tiers (S, nd), leaf rows (S, Lp, w), fences (S, ceil(n / 64))), each
# query tagged with the int32 index ``shard`` of its tables; positions are
# within the query's own row, and a query whose index lies outside [0, S)
# answers -1.  Every index routes at the one
# ``route_n`` (an index folds its own scale into its root) and searches at
# the one depth ``iters``.
# ---------------------------------------------------------------------------
def _shard_members(shard, S: int) -> list:
    """The query positions of each shard (host loop: the plain versions)."""
    return [torch.nonzero(shard == s).squeeze(1) for s in range(S)]


def sharded_lookup_plain(queries, shard, roots, mats, vecs, keys, *,
                         n_leaves: int, route_n: int | None = None,
                         iters: int | None = None, root_kind: str = "linear",
                         leaf_kind: str = "linear"):
    """Plain version of the shard-stacked K1: :func:`lookup_plain` of each
    query on its shard's tables."""
    out = torch.full(queries.shape, -1, dtype=torch.int32,
                     device=queries.device)
    for s, m in enumerate(_shard_members(shard, keys.shape[0])):
        if m.numel():
            out[m] = lookup_plain(queries[m], roots[s], mats[s], vecs[s],
                                  keys[s], n_leaves=n_leaves, route_n=route_n,
                                  iters=iters, root_kind=root_kind,
                                  leaf_kind=leaf_kind)
    return out


def sharded_dynamic_lookup_plain(queries, shard, roots, mats, vecs, keys,
                                 delta_keys, *, n_leaves: int,
                                 route_n: int | None = None,
                                 iters: int | None = None,
                                 root_kind: str = "linear",
                                 leaf_kind: str = "linear"):
    """Plain version of the shard-stacked K2: (base_pos, delta_pos)."""
    out = torch.full(queries.shape, -1, dtype=torch.int32,
                     device=queries.device)
    dout = out.clone()
    for s, m in enumerate(_shard_members(shard, keys.shape[0])):
        if m.numel():
            out[m], dout[m] = dynamic_lookup_plain(
                queries[m], roots[s], mats[s], vecs[s], keys[s],
                delta_keys[s], n_leaves=n_leaves, route_n=route_n,
                iters=iters, root_kind=root_kind, leaf_kind=leaf_kind)
    return out, dout


def sharded_dynamic_range_plain(q_lo, q_hi, shard, roots, mats, vecs, keys,
                                delta_keys, *, n_leaves: int,
                                route_n: int | None = None,
                                iters: int | None = None,
                                root_kind: str = "linear",
                                leaf_kind: str = "linear"):
    """Plain version of the shard-stacked K3: (base_lo, base_hi, delta_lo,
    delta_hi), ``shard`` the index of each pair."""
    outs = [torch.full(q_lo.shape, -1, dtype=torch.int32, device=q_lo.device)
            for _ in range(4)]
    for s, m in enumerate(_shard_members(shard, keys.shape[0])):
        if m.numel():
            res = dynamic_range_plain(
                q_lo[m], q_hi[m], roots[s], mats[s], vecs[s], keys[s],
                delta_keys[s], n_leaves=n_leaves, route_n=route_n,
                iters=iters, root_kind=root_kind, leaf_kind=leaf_kind)
            for o, r in zip(outs, res, strict=True):
                o[m] = r
    return tuple(outs)


def _prepare_sharded(tensors: dict, shard, nq: int, *, n_leaves: int,
                     root_kind: str, leaf_kind: str) -> bool:
    """Validate the stacked tables and the shard ids of a shard-stacked
    call; returns whether they lie on a CUDA device."""
    if root_kind not in KINDS or leaf_kind not in KINDS:
        raise ValueError(f"model kinds must be in {KINDS}, got "
                         f"{root_kind!r}/{leaf_kind!r}")
    devs = {t.device for t in tensors.values()} | {shard.device}
    if len(devs) != 1:
        raise ValueError(f"sharded lookup inputs on several devices: {devs}")
    for name, t in tensors.items():
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"{name} must be contiguous float32")
    roots, mats, vecs, keys = (tensors[k] for k in ("roots", "mats", "vecs",
                                                     "keys"))
    S = keys.shape[0] if keys.dim() == 2 else -1
    if S < 1 or not 0 < keys.shape[1] < 2 ** 31 - 1:
        raise ValueError("keys must be a (S, n) stack with int32 positions")
    if tuple(roots.shape) != (S, ROOT_ROWS, ROOT_LANES) \
            or mats.dim() != 3 or tuple(mats.shape[:2]) != (S, 3 * H) \
            or tuple(vecs.shape) != (S, 8, mats.shape[2]):
        raise ValueError("roots/mats/vecs must stack S packed tables")
    if not 1 <= n_leaves <= mats.shape[2]:
        raise ValueError(f"n_leaves={n_leaves} outside [1, {mats.shape[2]}]")
    dk = tensors.get("delta_keys")
    if dk is not None and (dk.dim() != 2 or dk.shape[0] != S
                           or dk.shape[1] % 128):
        raise ValueError("delta_keys must be a (S, nd) stack, nd a multiple "
                         "of 128")
    if shard.dtype != torch.int32 or tuple(shard.shape) != (nq,) \
            or not shard.is_contiguous():
        raise ValueError(f"shard must be a contiguous ({nq},) int32 tensor")
    return next(iter(devs)).type == "cuda"


def shard_tables(roots, mats, vecs, keys, *, n_leaves: int,
                 route_n: int | None = None, iters: int | None = None,
                 rows=None, fences=None, delta_keys=None) -> torch.Tensor:
    """The device array of per-shard descriptors (``ShardTables`` of
    ``csrc/lookup.cu``) the shard-stacked kernels read: each one the
    single-index ``Tables`` pointed at its shard's rows of the stacks.
    Built on the host by the library, copied to the card (a few hundred
    bytes a shard).  It points into the given tensors: it stays valid while
    they are alive and not reallocated (an in-place row write keeps it)."""
    lib = build.library("lookup")
    S, n = keys.shape
    route_n = n if route_n is None else route_n
    iters = full_iters(n) if iters is None else iters
    size = lib.repro_shard_tables_size()
    buf = ctypes.create_string_buffer(S * size)
    nd = 0 if delta_keys is None else delta_keys.shape[1]
    ptr = lambda t, s: None if t is None else t[s].data_ptr()
    for s in range(S):
        build.check(lib.repro_set_shard_tables(
            buf, s, roots[s].data_ptr(), mats[s].data_ptr(),
            vecs[s].data_ptr(), mats.shape[2], n_leaves,
            _f32(n_leaves / route_n), keys[s].data_ptr(), n, _f32(n - 1),
            _f32(n), iters, ptr(rows, s), ptr(fences, s),
            ptr(delta_keys, s), nd, full_iters(nd) if nd else 0),
            "shard_tables")
    return torch.frombuffer(bytearray(buf.raw), dtype=torch.uint8) \
        .to(keys.device)


def stacked_leaf_rows(mats, vecs, kind: str) -> torch.Tensor:
    """(S, Lp, w) :func:`leaf_rows` of each stacked table."""
    return torch.stack([leaf_rows(m, v, kind) for m, v in zip(mats, vecs, strict=True)])


def stacked_fences(keys) -> torch.Tensor:
    """(S, ceil(n / 64)) :func:`key_fence` of each row of a (S, n) stack."""
    return keys[:, ::FENCE].contiguous()


def sharded_lookup(queries, shard, roots, mats, vecs, keys, *,
                   n_leaves: int, route_n: int | None = None,
                   iters: int | None = None,
                   root_kind: str = "linear", leaf_kind: str = "linear",
                   rows=None, fences=None, tabs=None):
    """Shard-stacked K1: window-clamped left boundaries of f32 ``queries``,
    each in the keys of its shard, (Q,) int32 -- one launch.  ``rows``
    (:func:`stacked_leaf_rows`), ``fences`` (:func:`stacked_fences`) and
    ``tabs`` (:func:`shard_tables` of these tensors) are built when not
    given; an index caches them."""
    on_cuda = _prepare_sharded(
        dict(queries=queries, roots=roots, mats=mats, vecs=vecs, keys=keys),
        shard, queries.shape[0], n_leaves=n_leaves, root_kind=root_kind,
        leaf_kind=leaf_kind)
    kinds = dict(root_kind=root_kind, leaf_kind=leaf_kind)
    if not on_cuda:
        return sharded_lookup_plain(queries, shard, roots, mats, vecs, keys,
                                    n_leaves=n_leaves, route_n=route_n,
                                    iters=iters, **kinds)
    out = torch.empty(queries.shape, dtype=torch.int32, device=queries.device)
    nq = queries.shape[0]
    if nq:
        if tabs is None:
            if rows is None:
                rows = stacked_leaf_rows(mats, vecs, leaf_kind)
            if fences is None:
                fences = stacked_fences(keys)
            tabs = shard_tables(roots, mats, vecs, keys, n_leaves=n_leaves,
                                route_n=route_n, iters=iters, rows=rows,
                                fences=fences)
        with torch.cuda.device(queries.device):
            rc = build.library("lookup").repro_sharded_lookup(
                queries.data_ptr(), shard.data_ptr(), nq, tabs.data_ptr(),
                keys.shape[0], int(root_kind == "mlp"),
                int(leaf_kind == "mlp"), out.data_ptr(), _stream(queries))
        build.check(rc, "sharded_lookup")
        LAUNCHES["sharded_lookup"] += 1
    return out


def sharded_dynamic_lookup(queries, shard, roots, mats, vecs, keys,
                           delta_keys, *, n_leaves: int,
                           route_n: int | None = None,
                           iters: int | None = None, root_kind: str = "linear",
                           leaf_kind: str = "linear", rows=None, tabs=None):
    """Shard-stacked K2: (base_pos, delta_pos) of each query in its shard's
    tiers -- one launch.  ``delta_keys`` stacks +inf-padded f32 delta
    tiers; ``rows`` (MLP leaves only) and ``tabs`` as in
    :func:`sharded_lookup`."""
    on_cuda = _prepare_sharded(
        dict(queries=queries, roots=roots, mats=mats, vecs=vecs, keys=keys,
             delta_keys=delta_keys),
        shard, queries.shape[0], n_leaves=n_leaves, root_kind=root_kind,
        leaf_kind=leaf_kind)
    kinds = dict(root_kind=root_kind, leaf_kind=leaf_kind)
    if not on_cuda:
        return sharded_dynamic_lookup_plain(
            queries, shard, roots, mats, vecs, keys, delta_keys,
            n_leaves=n_leaves, route_n=route_n, iters=iters, **kinds)
    out = torch.empty(queries.shape, dtype=torch.int32, device=queries.device)
    dout = torch.empty_like(out)
    nq = queries.shape[0]
    if nq:
        if tabs is None:
            if leaf_kind == "mlp" and rows is None:
                rows = stacked_leaf_rows(mats, vecs, leaf_kind)
            tabs = shard_tables(roots, mats, vecs, keys, n_leaves=n_leaves,
                                route_n=route_n, iters=iters,
                                rows=rows if leaf_kind == "mlp" else None,
                                delta_keys=delta_keys)
        with torch.cuda.device(queries.device):
            rc = build.library("lookup").repro_sharded_dynamic_lookup(
                queries.data_ptr(), shard.data_ptr(), nq, tabs.data_ptr(),
                keys.shape[0], int(root_kind == "mlp"),
                int(leaf_kind == "mlp"), out.data_ptr(), dout.data_ptr(),
                _stream(queries))
        build.check(rc, "sharded_dynamic_lookup")
        LAUNCHES["sharded_dynamic_lookup"] += 1
    return out, dout


def sharded_dynamic_range(q_lo, q_hi, shard, roots, mats, vecs, keys,
                          delta_keys, *, n_leaves: int,
                          route_n: int | None = None,
                          iters: int | None = None, root_kind: str = "linear",
                          leaf_kind: str = "linear", tabs=None):
    """Shard-stacked K3: (base_lo, base_hi, delta_lo, delta_hi) of endpoint
    pairs, ``shard`` the index of each pair -- one launch."""
    if q_lo.shape != q_hi.shape:
        raise ValueError("endpoint arrays must pair up")
    on_cuda = _prepare_sharded(
        dict(q_lo=q_lo, q_hi=q_hi, roots=roots, mats=mats, vecs=vecs,
             keys=keys, delta_keys=delta_keys),
        shard, q_lo.shape[0], n_leaves=n_leaves, root_kind=root_kind,
        leaf_kind=leaf_kind)
    kinds = dict(root_kind=root_kind, leaf_kind=leaf_kind)
    if not on_cuda:
        return sharded_dynamic_range_plain(
            q_lo, q_hi, shard, roots, mats, vecs, keys, delta_keys,
            n_leaves=n_leaves, route_n=route_n, iters=iters, **kinds)
    outs = [torch.empty(q_lo.shape, dtype=torch.int32, device=q_lo.device)
            for _ in range(4)]
    nq = q_lo.shape[0]
    if nq:
        if tabs is None:
            tabs = shard_tables(roots, mats, vecs, keys, n_leaves=n_leaves,
                                route_n=route_n, iters=iters,
                                delta_keys=delta_keys)
        with torch.cuda.device(q_lo.device):
            rc = build.library("lookup").repro_sharded_dynamic_range(
                q_lo.data_ptr(), q_hi.data_ptr(), shard.data_ptr(), nq,
                tabs.data_ptr(), keys.shape[0], int(root_kind == "mlp"),
                int(leaf_kind == "mlp"), *(o.data_ptr() for o in outs),
                _stream(q_lo))
        build.check(rc, "sharded_dynamic_range")
        LAUNCHES["sharded_dynamic_range"] += 1
    return tuple(outs)
