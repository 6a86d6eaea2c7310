"""Durable snapshots of the dynamic index, single-host and sharded, with
restore and elastic reshard (counterpart of ``repro.core.persist``).

The file format is the reference's: the same directory and file names,
npz array names, dtypes and shapes, manifest keys, ``kind`` strings and
schema number, so either package restores the other's snapshot.  A sharded
snapshot (``kind`` "sharded-dynamic-index") holds one ``shard_<s>.npz`` a
shard in the single-host schema, ``index.npz`` (splits, the counter table,
the skew mutes) and the shared pool.

    <dir>/step_00000042/            one committed snapshot
        manifest.json               commit record, written last
        shard_00000.npz             both tiers, tombstone bitmaps, fitted
                                    root/leaf params, error bounds, Lemma
                                    4.1 counters, window widths, drift
                                    histograms
        pool.npz                    optional: the model pool

    manifest.json = {"schema": 1, "kind": "dynamic-index", "step": int,
                     "time": float, "meta": {...},
                     "files": {fname: {"md5": hex,
                                       "arrays": {name: {shape, dtype}}}}}

Durability contract:

  * **Atomic commit**: a snapshot is written into ``step_*.tmp`` and
    ``os.replace``-renamed into place after every file and the manifest
    are on disk; a write killed mid-file leaves only a ``.tmp`` directory
    that readers never list.
  * **Checksummed restore**: every file's md5 is recorded at write time
    (over the exact bytes handed to the OS); restore re-hashes what it
    reads and raises :class:`SnapshotCorruption` on any mismatch, torn
    manifest, unknown schema or missing file.
  * **Latest-complete fallback**: :func:`restore_dynamic` walks the
    snapshots newest to oldest and serves the first that verifies.
  * **Surfaced async errors**: the background writer records a failure and
    re-raises it from ``wait()`` or the next ``save()``; transient
    ``OSError``s retry with exponential backoff first.

The writer thread sees host numpy only: :func:`snapshot_dynamic` copies
every device tensor to the host, and the host-mutable counters, before it
returns, so churn may continue at once.  Restore puts the arrays on the
requested device; everything derived (tombstone prefix sums, the clamped
search depth, the packed kernel tables and leaf rows, the f32 keys and
their fence, the packed root) is recomputed from the restored arrays, so
the restored index answers bit for bit as the live one did.

npz has no bf16: such arrays are stored as their 16-bit words (uint16)
and tagged "bfloat16" in the manifest, as the reference does; a loaded
one comes back as a torch bf16 tensor, since numpy has no bf16 dtype.

:func:`restore_sharded` restores onto any shard count: a snapshot of N
shards restored onto M != N is cut at balanced, run-snapped live ranks
(:func:`reshard_sharded`), each new shard anchored on its largest piece
(shed on a clone, no refit) with the other pieces riding its delta tier;
``ReshardStats.full_rebuilds`` stays 0.  ``on_corrupt="quarantine"``
serves a snapshot with damaged shard files, those shards empty.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import queue
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import resolve_device
from . import drift as drift_mod
from . import models
from . import rmi as rmi_mod
from .adapt import DomainSpec
from .bounds import clamped_depth
from .distributed import ShardedDynamicIndex, _n_shards
from .reuse import ModelPool
from .updates import DynamicRMI, _psum, _to_host

SCHEMA = 1
_STEP_FMT = "step_{:08d}"
# threads that encode and checksum (or read, check and decode) a snapshot's
# files side by side: md5, crc32 and file I/O release the GIL
_IO_THREADS = min(8, os.cpu_count() or 1)


class SnapshotError(IOError):
    """Base error of the persist layer."""


class SnapshotCorruption(SnapshotError):
    """A snapshot failed verification (torn manifest, checksum mismatch,
    missing file, unknown schema)."""


# ---------------------------------------------------------------------------
# Tree walkers (dicts + NamedTuples, None-skipping).
# ---------------------------------------------------------------------------
def tree_paths(tree, prefix: str = "") -> list:
    """Stable dotted path for every leaf (dicts + NamedTuples; ``None``
    subtrees are skipped)."""
    out = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            out += tree_paths(tree[k], f"{prefix}{k}.")
    elif hasattr(tree, "_fields"):
        for k in tree._fields:
            out += tree_paths(getattr(tree, k), f"{prefix}{k}.")
    elif tree is None:
        pass
    else:
        out.append((prefix[:-1], tree))
    return out


def set_tree_path(tree, path: str, value):
    """Set ``path`` (dotted) in a dict/NamedTuple tree; returns a
    replacement node when an immutable (NamedTuple) root was rebuilt."""
    keys = path.split(".")

    def rec(node, i):
        k = keys[i]
        if isinstance(node, dict):
            if i == len(keys) - 1:
                node[k] = value
            else:
                repl = rec(node[k], i + 1)
                if repl is not None:       # immutable child replaced
                    node[k] = repl
            return None
        if hasattr(node, "_fields"):       # NamedTuple: immutable
            if i == len(keys) - 1:
                return node._replace(**{k: value})
            repl = rec(getattr(node, k), i + 1)
            return node._replace(**{k: repl}) if repl is not None else None
        return None

    return rec(tree, 0)


def get_tree_path(tree, path: str):
    node = tree
    for k in path.split("."):
        node = node[k] if isinstance(node, dict) else getattr(node, k)
    return node


# ---------------------------------------------------------------------------
# Array codec: host numpy in, host numpy (or a bf16 tensor) out.
# ---------------------------------------------------------------------------
def _encode_array(arr) -> tuple[np.ndarray, str]:
    """(what npz stores, the manifest's dtype tag)."""
    if isinstance(arr, torch.Tensor) and arr.dtype == torch.bfloat16:
        return _to_host(arr.view(torch.int16)).view(np.uint16), "bfloat16"
    arr = _to_host(arr)
    if arr.dtype.kind == "V" or str(arr.dtype) == "bfloat16":
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def _decode_array(arr: np.ndarray, dtype: str):
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)) \
            .view(torch.bfloat16)
    return arr


def _npz_key(name: str) -> str:
    # np.savez keywords cannot carry dots reliably; names round-trip via
    # the manifest, so the on-disk key just needs to be collision-free.
    return name.replace(".", "__")


def _encode_file(fname: str, arrays: dict) -> tuple:
    """(the manifest's entry of one snapshot file, its bytes): a ``.npy``
    of its one array or an npz of them, and the md5 of the bytes."""
    buf = io.BytesIO()
    entry = {"arrays": {}}
    enc = {}
    for name, arr in arrays.items():
        store, tag = _encode_array(arr)
        enc[_npz_key(name)] = store
        entry["arrays"][name] = {"shape": list(store.shape), "dtype": tag}
    if fname.endswith(".npy"):
        (store,) = enc.values()
        np.save(buf, store)
    else:
        np.savez(buf, **enc)
    data = buf.getvalue()
    entry["md5"] = hashlib.md5(data).hexdigest()
    return entry, data


def _write_bytes(path: str, data: bytes) -> None:
    """The single seam every snapshot byte passes through on its way to
    disk (fault injection replaces it to kill writes mid-file or raise
    transient OSErrors)."""
    with open(path, "wb") as f:
        f.write(data)


# ---------------------------------------------------------------------------
# The generic store.
# ---------------------------------------------------------------------------
@dataclass
class SnapshotStore:
    """Checksummed, atomically committed snapshot directory with an async
    writer whose failures are surfaced, never swallowed.

    ``save`` takes ``files``: {fname: {array_name: array}}; a fname ending
    in ``.npy`` holds exactly one array (under name ``""``), any other an
    npz of its dict.  ``retries`` extra attempts per file on a transient
    ``OSError``, with ``backoff * 2**attempt`` sleeps; the final failure is
    raised (blocking save) or recorded and re-raised from ``wait()`` or
    the next ``save()`` (async)."""
    directory: str
    keep: int = 3
    retries: int = 0
    backoff: float = 0.05
    kind: str = "tree"
    write_retries: int = 0              # transient attempts that were retried
    _q: queue.Queue = None
    _thread: threading.Thread = None
    _error: BaseException = None
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._q = queue.Queue(maxsize=2)

    # -- write -------------------------------------------------------------
    def save(self, step: int, files: dict, meta: dict | None = None, *,
             blocking: bool = False) -> None:
        """Write one snapshot.  Async by default: the caller-side cost is
        materializing ``files``; a prior async failure is re-raised here
        so a failed snapshot can never be mistaken for durability."""
        self.raise_pending()
        if blocking:
            self._write(step, files, meta or {})
            return
        if self._thread is None:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()
        self._q.put((step, files, meta or {}))

    def wait(self) -> None:
        """Block until queued snapshots are on disk; re-raise any writer
        failure."""
        if self._thread is not None:
            self._q.join()
        self.raise_pending()

    def raise_pending(self) -> None:
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise SnapshotError(
                f"async snapshot write failed: {err!r}") from err

    def _worker(self):
        while True:
            step, files, meta = self._q.get()
            try:
                self._write(step, files, meta)
            except BaseException as e:
                # recorded for wait()/save() to raise: the writer thread
                # itself has no caller to raise to
                with self._lock:
                    self._error = e
            self._q.task_done()

    def _write(self, step: int, files: dict, meta: dict) -> None:
        self._write_once(step, files, meta)
        self._gc()

    def _retried_write(self, path: str, data: bytes) -> None:
        """Per-file retry with exponential backoff on transient
        ``OSError``s; the final failure propagates."""
        for attempt in range(self.retries + 1):
            try:
                _write_bytes(path, data)
                return
            except OSError:
                if attempt >= self.retries:
                    raise
                self.write_retries += 1
                time.sleep(self.backoff * (2 ** attempt))

    def _write_once(self, step: int, files: dict, meta: dict) -> None:
        d = os.path.join(self.directory, _STEP_FMT.format(step) + ".tmp")
        shutil.rmtree(d, ignore_errors=True)    # stale tmp from a retry
        os.makedirs(d, exist_ok=True)
        manifest = {"schema": SCHEMA, "kind": self.kind, "step": step,
                    "time": time.time(), "meta": meta, "files": {}}
        # the files are encoded and hashed in threads, and written one
        # after another in their order
        with ThreadPoolExecutor(_IO_THREADS) as ex:
            encoded = ex.map(lambda kv: _encode_file(*kv), files.items())
            for fname, (entry, data) in zip(files, encoded, strict=True):
                self._retried_write(os.path.join(d, fname), data)
                manifest["files"][fname] = entry
                del data
        self._retried_write(os.path.join(d, "manifest.json"),
                            json.dumps(manifest).encode())
        final = os.path.join(self.directory, _STEP_FMT.format(step))
        shutil.rmtree(final, ignore_errors=True)   # re-save of same step
        os.replace(d, final)                       # atomic commit

    # -- read --------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, _STEP_FMT.format(step))

    def steps(self) -> list:
        """Committed snapshot steps, ascending (``.tmp`` dirs, torn
        writes, are never listed)."""
        out = []
        for s in os.listdir(self.directory):
            if s.startswith("step_") and not s.endswith(".tmp"):
                try:
                    out.append(int(s.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def _gc(self) -> None:
        for s in self.steps()[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def read_manifest(self, step: int) -> dict:
        """Parse + validate a snapshot's manifest; any defect (missing,
        torn JSON, unknown schema, bad structure) is SnapshotCorruption."""
        path = os.path.join(self._step_dir(step), "manifest.json")
        try:
            with open(path, "rb") as f:
                manifest = json.loads(f.read())
        except (OSError, ValueError) as e:
            raise SnapshotCorruption(
                f"step {step}: unreadable manifest: {e!r}") from e
        if not isinstance(manifest, dict) or \
                manifest.get("schema") != SCHEMA or \
                not isinstance(manifest.get("files"), dict):
            raise SnapshotCorruption(
                f"step {step}: manifest schema mismatch "
                f"(got {manifest.get('schema')!r}, want {SCHEMA})")
        return manifest

    def load_files(self, step: int, fnames, manifest: dict | None = None,
                   *, verify: bool = True) -> dict:
        """``load_file`` of each of ``fnames``, all at once in threads:
        {fname: a future of its arrays}, whose ``result()`` raises what
        that file's load raised (read them in the order the caller would
        have loaded them, and the same error surfaces first)."""
        if manifest is None:
            manifest = self.read_manifest(step)
        with ThreadPoolExecutor(_IO_THREADS) as ex:
            return {f: ex.submit(self.load_file, step, f, manifest,
                                 verify=verify) for f in fnames}

    def load_file(self, step: int, fname: str, manifest: dict | None = None,
                  *, verify: bool = True) -> dict:
        """Load one snapshot file as {array_name: np.ndarray}, re-hashing
        the bytes read against the manifest md5 (any mismatch, missing
        file, or undecodable payload is SnapshotCorruption)."""
        if manifest is None:
            manifest = self.read_manifest(step)
        entry = manifest["files"].get(fname)
        if entry is None:
            raise SnapshotCorruption(
                f"step {step}: {fname} not in manifest")
        try:
            with open(os.path.join(self._step_dir(step), fname), "rb") as f:
                data = f.read()
        except OSError as e:
            raise SnapshotCorruption(
                f"step {step}: missing file {fname}: {e!r}") from e
        if verify and hashlib.md5(data).hexdigest() != entry["md5"]:
            raise SnapshotCorruption(
                f"step {step}: checksum mismatch for {fname}")
        try:
            if fname.endswith(".npy"):
                (name, spec), = entry["arrays"].items()
                arr = np.load(io.BytesIO(data), allow_pickle=False)
                return {name: _decode_array(arr, spec["dtype"])}
            z = np.load(io.BytesIO(data), allow_pickle=False)
            return {name: _decode_array(z[_npz_key(name)], spec["dtype"])
                    for name, spec in entry["arrays"].items()}
        except Exception as e:
            # whatever numpy raises on a payload that passed its checksum
            # but does not decode is corruption to the caller
            raise SnapshotCorruption(
                f"step {step}: undecodable payload in {fname}: {e!r}") from e


# ---------------------------------------------------------------------------
# Dynamic index snapshots.
# ---------------------------------------------------------------------------
KIND_SHARDED = "sharded-dynamic-index"
KIND_DYNAMIC = "dynamic-index"
_SHARD_FMT = "shard_{:05d}.npz"

_SHARD_SCALARS = (
    "eps", "route_n", "base_n", "base_dead_count", "delta_live",
    "delta_dead_count", "delta_compactions", "rebuilds", "deleted",
    "capacity_shrinks")
_IDX_COUNTERS = (
    "rebalances", "migrations_incremental", "migrations_full",
    "restack_full", "restack_rows", "capacity_shrinks",
    "swaps_committed")


def _params_to(arrays: dict, prefix: str, params) -> None:
    for path, arr in tree_paths(params):
        arrays[prefix + path] = _to_host(arr)


def _params_from(arrays: dict, prefix: str, kind: str, dev):
    cls = models.LinearParams if kind == "linear" else models.MLPParams
    return cls(*(torch.as_tensor(arrays[prefix + k], device=dev)
                 for k in cls._fields))


def _shard_arrays(d: DynamicRMI) -> tuple[dict, dict]:
    """(arrays, meta) of one ``DynamicRMI``, all on the host: device
    tensors copied, the host-mutable counters copied (the async writer
    races later churn).  Tombstone prefix sums, packed kernel tables and
    rows, the f32 keys and their fence are derived state, recomputed on
    restore from the same inputs."""
    idx = d.index
    arrays = {
        "base_keys": idx.keys,
        "base_dead": d.base_dead,
        "err_lo": idx.err_lo,
        "err_hi": idx.err_hi,
        "reused_mask": idx.reused_mask,
        "leaf_sim": idx.leaf_sim,
        "delta_keys": d.delta_keys,
        "delta_leaf": d.delta_leaf,
        "delta_dead": d.delta_dead,
    }
    arrays = {k: _to_host(v) for k, v in arrays.items()}
    arrays.update(n_inserts=d.n_inserts.copy(), budget=d.budget.copy(),
                  win=d._win.copy())
    _params_to(arrays, "root.", idx.root)
    _params_to(arrays, "leaves.", idx.leaves)
    meta = {k: _json_scalar(getattr(d, k)) for k in _SHARD_SCALARS}
    meta.update(root_kind=idx.root_kind, leaf_kind=idx.leaf_kind,
                n_leaves=int(idx.n_leaves),
                compact_dead_ratio=_json_scalar(d.compact_dead_ratio),
                reuse_on_rebuild=d.reuse_on_rebuild,
                build_kwargs=d.build_kwargs,
                swap_on_drift=bool(d.swap_on_drift),
                swaps_committed=int(d.swaps_committed),
                swap_rejects=int(d.swap_rejects))
    if d.drift is not None:
        # Raw counts are the drift monitor's whole state; score and latch
        # are scalars synced here so restore needs no recompute pass.
        arrays["drift.ref"] = _to_host(d.drift.ref)
        arrays["drift.acc"] = _to_host(d.drift.acc)
        meta["drift"] = {
            "m": int(d.drift.m), "lo": float(d.drift.lo),
            "hi": float(d.drift.hi),
            "thresh_hi": float(d.drift.thresh_hi),
            "thresh_lo": float(d.drift.thresh_lo),
            "score": float(d.drift.score),
            "drifted": bool(d.drift.drifted),
            "updates": int(d.drift.updates),
            "rebaselines": int(d.drift.rebaselines)}
    return arrays, meta


def _json_scalar(v):
    if v is None or isinstance(v, (bool, str)):
        return v
    if isinstance(v, (int, np.integer)):
        return int(v)
    return float(v)


def _restore_shard(arrays: dict, meta: dict, pool, dev) -> DynamicRMI:
    """Rebuild one ``DynamicRMI`` on ``dev`` from its snapshot arrays.
    Everything derived (psums, clamped depth, and lazily the packed
    tables, leaf rows, f32 keys and fence) is recomputed from the
    serialized state, which the bit-exactness contract relies on."""
    def t(k):
        return torch.as_tensor(arrays[k], device=dev)

    index = rmi_mod.RMIIndex(
        keys=t("base_keys"), root_kind=meta["root_kind"],
        root=_params_from(arrays, "root.", meta["root_kind"], dev),
        leaf_kind=meta["leaf_kind"],
        leaves=_params_from(arrays, "leaves.", meta["leaf_kind"], dev),
        err_lo=t("err_lo"), err_hi=t("err_hi"),
        n_leaves=int(meta["n_leaves"]), reused_mask=t("reused_mask"),
        leaf_sim=t("leaf_sim"))
    base_dead, delta_dead = t("base_dead"), t("delta_dead")
    d = DynamicRMI(
        index=index, pool=pool, eps=float(meta["eps"]),
        route_n=int(meta["route_n"]),
        delta_keys=t("delta_keys"), delta_leaf=t("delta_leaf"),
        delta_dead=delta_dead, delta_psum=_psum(delta_dead),
        delta_live=int(meta["delta_live"]),
        delta_dead_count=int(meta["delta_dead_count"]),
        compact_dead_ratio=meta["compact_dead_ratio"],
        delta_compactions=int(meta["delta_compactions"]),
        base_n=int(meta["base_n"]), base_dead=base_dead,
        base_psum=_psum(base_dead),
        base_dead_count=int(meta["base_dead_count"]),
        n_inserts=np.array(arrays["n_inserts"], np.int64),
        budget=np.array(arrays["budget"], np.float64),
        rebuilds=int(meta["rebuilds"]), deleted=int(meta["deleted"]),
        reuse_on_rebuild=meta["reuse_on_rebuild"],
        build_kwargs=dict(meta["build_kwargs"]))
    # meta.get: snapshots predating these fields restore with them off,
    # as in the reference
    d.capacity_shrinks = int(meta.get("capacity_shrinks", 0))
    d.swap_on_drift = bool(meta.get("swap_on_drift", False))
    d.swaps_committed = int(meta.get("swaps_committed", 0))
    d.swap_rejects = int(meta.get("swap_rejects", 0))
    dm = meta.get("drift")
    if dm is not None:
        d.drift = drift_mod.DriftState(
            m=int(dm["m"]), lo=float(dm["lo"]), hi=float(dm["hi"]),
            thresh_hi=float(dm["thresh_hi"]),
            thresh_lo=float(dm["thresh_lo"]),
            ref=t("drift.ref"), acc=t("drift.acc"),
            score=torch.tensor(float(dm["score"]), dtype=torch.float64,
                               device=dev),
            drifted=torch.tensor(bool(dm["drifted"]), device=dev),
            updates=int(dm["updates"]), rebaselines=int(dm["rebaselines"]))
    d._win = np.array(arrays["win"], np.float64)
    index._iters = clamped_depth(d._win, index.n)
    return d


def _pool_files(pool: ModelPool) -> tuple[dict, dict]:
    arrays = {"hists": _to_host(pool.hists),
              "err_lo": _to_host(pool.err_lo),
              "err_hi": _to_host(pool.err_hi)}
    _params_to(arrays, "params.", pool.params)
    _params_to(arrays, "domains.", pool.domains)
    meta = {"eps": float(pool.eps), "m": int(pool.m), "kind": pool.kind,
            "reuse_count": int(pool.reuse_count),
            "trained_count": int(pool.trained_count)}
    return arrays, meta


def _restore_pool(arrays: dict, meta: dict, dev) -> ModelPool:
    domains = DomainSpec(*(torch.as_tensor(arrays["domains." + k],
                                           device=dev)
                           for k in DomainSpec._fields))
    return ModelPool(
        eps=meta["eps"], m=meta["m"], kind=meta["kind"],
        hists=torch.as_tensor(arrays["hists"], device=dev),
        params=_params_from(arrays, "params.", meta["kind"], dev),
        err_lo=torch.as_tensor(arrays["err_lo"], device=dev),
        err_hi=torch.as_tensor(arrays["err_hi"], device=dev),
        domains=domains, reuse_count=meta["reuse_count"],
        trained_count=meta["trained_count"])


def snapshot_dynamic(store: SnapshotStore, step: int, d: DynamicRMI, *,
                     blocking: bool = False,
                     include_pool: bool = True) -> None:
    """Snapshot a ``DynamicRMI`` (the ``api.Index`` backend): both tiers,
    tombstones, fitted params, Lemma 4.1 counters, window widths and the
    drift monitor, checksummed and atomically committed by ``store``.
    Async by default; every array is on the host before this returns."""
    store.kind = KIND_DYNAMIC
    arrays, m = _shard_arrays(d)
    files = {_SHARD_FMT.format(0): arrays}
    meta = {"shard": m}
    if include_pool and d.pool is not None:
        parr, pm = _pool_files(d.pool)
        files["pool.npz"] = parr
        meta["pool"] = pm
    store.save(step, files, meta, blocking=blocking)


def restore_dynamic(store: SnapshotStore, *, step: int | None = None,
                    on_corrupt: str = "fallback", device=None):
    """Restore a ``DynamicRMI`` on ``device`` (CUDA unless
    ``device="cpu"``) from the newest verifiable :func:`snapshot_dynamic`
    snapshot, or exactly ``step``.  ``on_corrupt="fallback"`` skips damaged
    snapshots, ``"raise"`` raises on the first; a given ``step`` never
    falls back.  Returns (index, restored step)."""
    if on_corrupt not in ("fallback", "raise"):
        raise ValueError(f"unknown on_corrupt={on_corrupt!r}")
    dev = resolve_device(device)
    candidates = [step] if step is not None else \
        list(reversed(store.steps()))
    if not candidates:
        raise SnapshotError(f"no snapshots in {store.directory}")
    last_err = None
    for cand in candidates:
        try:
            manifest = store.read_manifest(cand)
            if manifest.get("kind") != KIND_DYNAMIC:
                raise SnapshotCorruption(
                    f"step {cand}: kind {manifest.get('kind')!r} is not "
                    f"{KIND_DYNAMIC!r}")
            meta = manifest["meta"]
            pool = None
            if "pool" in meta:
                pool = _restore_pool(
                    store.load_file(cand, "pool.npz", manifest),
                    meta["pool"], dev)
            d = _restore_shard(
                store.load_file(cand, _SHARD_FMT.format(0), manifest),
                meta["shard"], pool, dev)
            return d, cand
        except SnapshotCorruption as e:
            last_err = e
            if on_corrupt == "raise" or step is not None:
                raise
    raise SnapshotCorruption(
        f"no verifiable snapshot among steps "
        f"{sorted(candidates)}: last error: {last_err}")


# ---------------------------------------------------------------------------
# Sharded dynamic index snapshots.
# ---------------------------------------------------------------------------
def snapshot_sharded(store: SnapshotStore, step: int, idx, *,
                     blocking: bool = False,
                     include_pool: bool = True) -> None:
    """Snapshot a ``ShardedDynamicIndex``: one npz a shard, the global
    arrays and (optionally) the shared pool, checksummed and atomically
    committed by ``store``.  Async by default; every array is on the host
    before this returns, so churn may continue at once."""
    store.kind = KIND_SHARDED
    files = {"index.npz": {
        "splits": np.asarray(idx.splits, np.float64).copy(),
        "counts": _to_host(idx._counts),
        "muted": _to_host(idx._muted)}}
    shard_meta = []
    for s, d in enumerate(idx.shards):
        arrays, m = _shard_arrays(d)
        files[_SHARD_FMT.format(s)] = arrays
        shard_meta.append(m)
    meta = {
        "axis": idx.axis, "eps": float(idx.eps),
        "n_leaves": int(idx.n_leaves), "n_shards": int(idx.n_shards),
        "rebalance_ratio": _json_scalar(idx.rebalance_ratio),
        "rebalance_skew": float(idx.rebalance_skew),
        "migrate_headroom_factor": float(idx.migrate_headroom_factor),
        "build_kwargs": idx.build_kwargs,
        "counters": {k: int(getattr(idx, k)) for k in _IDX_COUNTERS},
        "shards": shard_meta,
    }
    if include_pool and idx.pool is not None:
        arrays, pm = _pool_files(idx.pool)
        files["pool.npz"] = arrays
        meta["pool"] = pm
    store.save(step, files, meta, blocking=blocking)


@dataclass
class ReshardStats:
    """Work accounting of one elastic N -> M reshard.  ``full_rebuilds``
    (from-scratch builds of non-empty shards) is always 0: only empty
    shards are built anew (``empty_builds``); ``leaf_refits`` counts the
    Lemma 4.1 leaf rebuilds the delta-riding merges triggered."""
    n_from: int = 0
    n_to: int = 0
    pieces: int = 0             # (old shard, new shard) overlaps cut out
    delta_merges: int = 0       # donor segments merged through the delta
    moved_keys: int = 0         # live keys that changed owning structure
    leaf_refits: int = 0        # Lemma 4.1 leaf rebuilds in the merges
    empty_builds: int = 0       # empty shards built
    full_rebuilds: int = 0      # from-scratch builds of non-empty shards


@dataclass
class RestoreReport:
    """What :func:`restore_sharded` did."""
    step: int = -1
    n_shards_from: int = 0      # shard count in the snapshot
    n_shards: int = 0           # shard count served (the target mesh)
    quarantined: list = field(default_factory=list)
    skipped: list = field(default_factory=list)   # [(step, reason), ...]
    reshard: ReshardStats | None = None


def _empty_shard(eps, n_leaves, pool, build_kwargs, dev) -> DynamicRMI:
    # a shard's recorded build_kwargs may already pin n_leaves (DynamicRMI
    # keeps it among its build arguments): the explicit one wins
    kw = dict(build_kwargs)
    kw["n_leaves"] = n_leaves
    return DynamicRMI.build(torch.zeros((0,), dtype=torch.float64),
                            pool=None if pool is None else pool.replica(dev),
                            eps=eps, device=dev, **kw)


def _reshard_pieces(shards: list, n_to: int, *, eps, n_leaves, pool,
                    build_kwargs, devs: list) -> tuple:
    """Cut N fitted shards into M at duplicate-run-safe boundaries, new
    shard t on ``devs[t]``.

    Cuts are balanced live-count positions snapped to run starts.  Each new
    shard keeps its largest overlapping piece as its *anchor*, cut out by
    ``shed_prefix`` / ``shed_suffix`` (on a clone when the source shard
    feeds other new shards too) and moved to the new shard's device when
    its source lies elsewhere; the other overlapping pieces' live keys
    merge into the anchor's delta tier through ``insert_batch``, refitting
    only the leaves whose Lemma 4.1 budgets trip.  The input shards are
    consumed.  Returns (new shards, new splits, stats)."""
    n_from = len(shards)
    stats = ReshardStats(n_from=n_from, n_to=n_to)
    lc = np.asarray([d.live_count for d in shards], np.int64)
    total = int(lc.sum())
    if total == 0:
        stats.empty_builds = n_to
        return ([_empty_shard(eps, n_leaves, pool, build_kwargs, devs[t])
                 for t in range(n_to)],
                np.full((n_to - 1,), -np.inf, np.float64), stats)
    glive = np.concatenate([d.live_keys() for d in shards])
    offs = np.concatenate([[0], np.cumsum(lc)])
    cuts = np.empty((n_to + 1,), np.int64)
    cuts[0], cuts[-1] = 0, total
    for t in range(1, n_to):
        p = min(round(total * t / n_to), total)
        if 0 < p < total:
            # snap to the start of the equal-key run: a duplicate run never
            # straddles a seam
            p = int(np.searchsorted(glive, glive[p], side="left"))
        cuts[t] = p
    cuts = np.maximum.accumulate(cuts)
    splits = np.asarray([glive[cuts[t] - 1] if cuts[t] > 0 else -np.inf
                         for t in range(1, n_to)], np.float64)

    new_shards = []
    for t in range(n_to):
        lo, hi = int(cuts[t]), int(cuts[t + 1])
        if hi <= lo:
            new_shards.append(_empty_shard(eps, n_leaves, pool,
                                           build_kwargs, devs[t]))
            stats.empty_builds += 1
            continue
        over = [s for s in range(n_from)
                if lc[s] > 0 and offs[s] < hi and offs[s + 1] > lo]
        stats.pieces += len(over)
        counts = {s: int(min(offs[s + 1], hi) - max(offs[s], lo))
                  for s in over}
        s_star = max(over, key=counts.__getitem__)
        a_lo = int(max(offs[s_star], lo))
        a_hi = int(min(offs[s_star + 1], hi))
        # a whole-shard anchor is consumed as it is; a partial one is cut
        # out of a clone so that its siblings keep their own pieces
        anchor = shards[s_star] if counts[s_star] == int(lc[s_star]) \
            else shards[s_star].clone()
        anchor = anchor.to(devs[t])
        if a_lo > offs[s_star]:
            anchor.shed_prefix(float(glive[a_lo - 1]))
        if a_hi < offs[s_star + 1]:
            anchor.shed_suffix(float(glive[a_hi - 1]))
        rb0 = anchor.rebuilds
        for seg_lo, seg_hi in ((lo, a_lo), (a_hi, hi)):
            if seg_hi > seg_lo:
                anchor.insert_batch(glive[seg_lo:seg_hi])
                stats.delta_merges += 1
                stats.moved_keys += seg_hi - seg_lo
        stats.leaf_refits += anchor.rebuilds - rb0
        new_shards.append(anchor)
    return new_shards, splits, stats


def _shard_devices(positions: tuple, n: int) -> list:
    """The device of each of ``n`` shards laid out on ``positions``."""
    return [positions[s * len(positions) // n] for s in range(n)]


def reshard_sharded(idx, mesh, axis: str | None = None):
    """Elastic N -> M reshard of a live ``ShardedDynamicIndex`` onto
    ``mesh`` without a from-scratch rebuild (:func:`_reshard_pieces`): a
    change of the shard count, of the mesh's positions, or both; the new
    shards land on ``mesh``'s devices (with ``devices`` None, on the
    index's home device).  The input index is consumed.  Returns (new
    index, ReshardStats)."""
    axis = axis or idx.axis
    n_to = _n_shards(mesh, axis)
    positions = mesh.positions(idx.device if mesh.devices is None
                               else None)
    pool = idx.pool
    if pool is not None:
        pool = pool.replica(positions[0])
    shards, splits, stats = _reshard_pieces(
        idx.shards, n_to, eps=idx.eps, n_leaves=idx.n_leaves, pool=pool,
        build_kwargs=idx.build_kwargs,
        devs=_shard_devices(positions, n_to))
    out = ShardedDynamicIndex(
        mesh=mesh, axis=axis, splits=splits, shards=shards, eps=idx.eps,
        n_leaves=idx.n_leaves, pool=pool,
        rebalance_ratio=idx.rebalance_ratio,
        rebalance_skew=idx.rebalance_skew,
        migrate_headroom_factor=idx.migrate_headroom_factor,
        build_kwargs=idx.build_kwargs)
    out._init_maintenance()
    return out, stats


def restore_sharded(store: SnapshotStore, mesh, axis: str = "data", *,
                    step: int | None = None, on_corrupt: str = "fallback",
                    device=None):
    """Restore a ``ShardedDynamicIndex`` onto ``mesh``'s devices (with
    ``mesh.devices`` None, onto ``device``: CUDA unless ``device="cpu"``)
    from the newest verifiable snapshot in ``store`` (or exactly ``step``),
    resharded onto ``mesh``'s shard count when it differs from the
    snapshot's.  Either package's snapshots restore onto any mesh: the
    file format carries no placement.

    ``on_corrupt``:
      * ``"fallback"`` (default): a snapshot failing verification anywhere
        is skipped (``report.skipped``) and the next older one tried;
        raises :class:`SnapshotCorruption` when none verifies.
      * ``"raise"``: the newest (or requested) snapshot must verify.
      * ``"quarantine"``: a torn manifest or global file still falls back,
        but damaged *shard files* restore as empty shards, listed in
        ``report.quarantined`` and ``index.quarantined``; queries routed
        to their ranges answer found False.

    Returns (index, :class:`RestoreReport`)."""
    if on_corrupt not in ("fallback", "raise", "quarantine"):
        raise ValueError(f"unknown on_corrupt={on_corrupt!r}")
    positions = mesh.positions(device)
    report = RestoreReport()
    candidates = [step] if step is not None else \
        list(reversed(store.steps()))
    if not candidates:
        raise SnapshotError(f"no snapshots in {store.directory}")
    last_err = None
    for cand in candidates:
        try:
            idx, rep = _restore_one(store, cand, mesh, axis, on_corrupt,
                                    positions)
            rep.skipped = report.skipped
            return idx, rep
        except SnapshotCorruption as e:
            last_err = e
            report.skipped.append((cand, str(e)))
            if on_corrupt == "raise" or step is not None:
                raise
    raise SnapshotCorruption(
        f"no verifiable snapshot among steps "
        f"{sorted(candidates)}: last error: {last_err}")


def _restore_one(store: SnapshotStore, step: int, mesh, axis: str,
                 on_corrupt: str, positions: tuple):
    dev = positions[0]
    manifest = store.read_manifest(step)
    if manifest.get("kind") != KIND_SHARDED:
        raise SnapshotCorruption(
            f"step {step}: kind {manifest.get('kind')!r} is not "
            f"{KIND_SHARDED!r}")
    meta = manifest["meta"]
    n_from = int(meta["n_shards"])
    names = ["index.npz"] + (["pool.npz"] if "pool" in meta else []) + \
        [_SHARD_FMT.format(s) for s in range(n_from)]
    loaded = store.load_files(step, names, manifest)
    glob = loaded["index.npz"].result()
    pool = None
    if "pool" in meta:
        pool = _restore_pool(loaded["pool.npz"].result(), meta["pool"], dev)
    n_to = _n_shards(mesh, axis)
    report = RestoreReport(step=step, n_shards_from=n_from, n_shards=n_to)
    # a snapshot's shard s restores onto the position that would hold it on
    # a mesh of its own width: where a reshard keeps most of its keys
    shards = []
    for s, sdev in enumerate(_shard_devices(positions, n_from)):
        sm = meta["shards"][s]
        spool = None if pool is None else pool.replica(sdev)
        try:
            shards.append(_restore_shard(
                loaded.pop(_SHARD_FMT.format(s)).result(), sm, spool, sdev))
        except SnapshotCorruption as e:
            if on_corrupt != "quarantine":
                raise
            shards.append(_empty_shard(
                float(sm["eps"]), int(sm["n_leaves"]), pool,
                dict(sm["build_kwargs"]), sdev))
            report.quarantined.append((s, str(e)))
    quarantined_ids = [s for s, _ in report.quarantined]

    if n_to == n_from:
        splits = np.asarray(glob["splits"], np.float64).copy()
    else:
        shards, splits, stats = _reshard_pieces(
            shards, n_to, eps=float(meta["eps"]),
            n_leaves=int(meta["n_leaves"]), pool=pool,
            build_kwargs=dict(meta["build_kwargs"]),
            devs=_shard_devices(positions, n_to))
        report.reshard = stats
    idx = ShardedDynamicIndex(
        mesh=mesh, axis=axis, splits=splits, shards=shards,
        eps=float(meta["eps"]), n_leaves=int(meta["n_leaves"]), pool=pool,
        rebalance_ratio=meta["rebalance_ratio"],
        rebalance_skew=float(meta["rebalance_skew"]),
        migrate_headroom_factor=float(meta["migrate_headroom_factor"]),
        build_kwargs=dict(meta["build_kwargs"]))
    for k, v in meta.get("counters", {}).items():
        if hasattr(idx, k):
            setattr(idx, k, int(v))
    idx._init_maintenance()
    if n_to == n_from:
        # a same-width restore is verbatim: the counter table recomputed
        # from the restored scalars equals the saved one; the mutes restore
        # as saved (quarantined rows re-armed)
        muted = torch.as_tensor(np.asarray(glob["muted"], np.int64),
                                device=dev)
        idx._muted = muted
        if quarantined_ids:
            idx._mute(quarantined_ids, -1)
        idx.quarantined = list(quarantined_ids)
    else:
        idx.quarantined = []
    return idx, report
