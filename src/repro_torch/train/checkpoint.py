"""Fault-tolerant tree checkpoints on the snapshot store (a port of
``repro.train.checkpoint``).

A thin adapter over ``core.persist.SnapshotStore(kind="tree")``, which owns
the durability mechanics (atomic rename commit, checksummed manifest, an
async writer whose failures are surfaced, retries on transient
``OSError``s, keep-N garbage collection); this module maps a params /
optimizer-state tree onto it:

  * every leaf is its own ``.npy`` file, named by the md5 of its dotted
    path (recorded in the manifest meta),
  * bf16 leaves ride the store's uint16 codec and restore exactly.

The file format is the reference's, so either package restores the
other's checkpoint.  ``save`` copies every leaf to host memory before it
returns (the train step then updates the device tensors in place); the
write itself is async by default, and a failed write re-raises from
``wait()`` or the next ``save()``.

On a ``models.sharding.ModelMesh`` (``mesh`` and ``specs``): ``save``
takes the positions' trees and writes the GLOBAL leaves, put together on
the host (``serve.step.gather_tree``), so the files are the reference's
whatever mesh wrote them; ``restore`` reads the global leaves to the host
and cuts them onto any mesh whose axes divide them (``shard_tree``; the
reference's ``device_put`` with a ``NamedSharding``): the elastic
restart's resharding.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import resolve_device
from ..core.persist import SnapshotStore, tree_paths


def _leaf_fname(path: str) -> str:
    return hashlib.md5(path.encode()).hexdigest()[:16] + ".npy"


def _host_copy(leaf):
    """A host copy of a leaf the caller may overwrite at once: bf16 stays
    a (CPU) torch tensor for the store's codec, the rest numpy."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        return t if t.dtype == torch.bfloat16 else t.numpy()
    return np.array(leaf)


def _rebuild(tree, value_of, prefix: str = ""):
    """A new tree of ``tree``'s structure with ``value_of(path)`` at every
    leaf (the paths of ``tree_paths``); the template is not written."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, value_of, f"{prefix}{k}.")
                for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, k), value_of,
                                     f"{prefix}{k}.") for k in tree._fields))
    if tree is None:
        return None
    return value_of(prefix[:-1])


@dataclass
class Checkpointer:
    directory: str
    keep: int = 3
    retries: int = 0                    # transient-OSError attempts per write
    backoff: float = 0.05               # base of the exponential backoff
    _store: SnapshotStore = field(init=False)

    def __post_init__(self):
        self._store = SnapshotStore(self.directory, keep=self.keep,
                                    retries=self.retries,
                                    backoff=self.backoff, kind="tree")

    # -- write -------------------------------------------------------------
    def save(self, step: int, tree, *, blocking: bool = False, mesh=None,
             specs=None) -> None:
        """Copy every leaf to the host now, then hand the copies to the
        store (async by default; a prior async failure re-raises here).
        With ``mesh`` and ``specs``, ``tree`` is a list of the positions'
        trees and the global leaves are written."""
        if (mesh is None) != (specs is None):
            raise ValueError("save(mesh=, specs=): both or neither")
        if mesh is not None:
            from ..serve.step import gather_tree
            tree = gather_tree(tree, specs, mesh, device="cpu")
        files, leaves = {}, {}
        for path, leaf in tree_paths(tree):
            fname = _leaf_fname(path)
            files[fname] = {"": _host_copy(leaf)}
            leaves[path] = fname
        self._store.save(step, files, {"leaves": leaves}, blocking=blocking)

    def wait(self) -> None:
        """Block until queued snapshots are durable; re-raise any writer
        failure."""
        self._store.wait()

    @property
    def write_retries(self) -> int:
        return self._store.write_retries

    # -- read --------------------------------------------------------------
    def latest_step(self) -> int | None:
        return self._store.latest_step()

    def restore(self, step: int, template, *, verify: bool = True,
                mesh=None, specs=None, device=None, share: bool = True):
        """A new tree of ``template``'s structure with every leaf read from
        snapshot ``step`` (checksums verified) onto ``device`` (CUDA unless
        ``device="cpu"``); the template itself is left as it was.  With
        ``mesh`` and ``specs`` (a tree of ``template``'s structure, a
        PartitionSpec tuple a leaf) the global leaves are read to the host
        and cut onto the mesh's positions (``shard_tree``, ``share`` as
        its): a list of trees, one a position."""
        if (mesh is None) != (specs is None):
            raise ValueError("restore(mesh=, specs=): both or neither")
        dev = torch.device("cpu") if mesh is not None \
            else resolve_device(device)
        manifest = self._store.read_manifest(step)
        names = manifest["meta"]["leaves"]
        # the template's leaves, read, checked and decoded in threads
        loaded = self._store.load_files(
            step, [names[p] for p, _ in tree_paths(template) if p in names],
            manifest, verify=verify)

        def value_of(path):
            arr = loaded[names[path]].result()[""]
            if not isinstance(arr, torch.Tensor):
                if not (arr.flags.c_contiguous and arr.flags.writeable):
                    arr = np.array(arr, order="C")      # keeps 0-d arrays
                arr = torch.from_numpy(arr)
            return arr.to(dev)

        out = _rebuild(template, value_of)
        if mesh is None:
            return out
        from ..serve.step import shard_tree
        return shard_tree(out, specs, mesh, share=share)
