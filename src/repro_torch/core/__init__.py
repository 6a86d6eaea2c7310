"""Core of the port (counterparts of ``repro.core``).

  synth.generate_pool(eps)            synthetic corpus (Table 2 enumeration)
  reuse.build_pool(corpus, kind)      batched pool pre-training (Q_MP)
  rmi.build_rmi / rmi.lookup          RMI, RMI-MR, RMI-NN, RMI-NN-MR
  rmrt.build_rmrt / rmrt.lookup       the paper's RMRT
  updates.DynamicRMI                  §4 insert handling (Lemma 4.1)
  distributed.ShardedDynamicIndex     the range-partitioned index, its
                                      shards stacked a mesh position on
                                      the position's device (ShardMesh,
                                      build_sharded, make_lookup_fn)
  drift                               online KS drift monitoring and
                                      bound-checked pool hot-swaps
  paths.resolve_path                  the path="auto"|"kernel"|"jnp" policy
  persist                             snapshots, restore and reshard
  btree / pgm / radix_spline          baselines from the paper's roster

The front door over the dynamic index is ``repro_torch.api.Index``.

Import the modules by name (``from repro_torch.core import persist``):
``kernels`` imports ``core.bounds`` and ``core.cdf`` while ``core.updates``
imports ``kernels.lookup``, so loading every module here would make the two
packages import each other.
"""
__all__ = ["adapt", "bounds", "btree", "cdf", "distributed", "drift",
           "models", "paths", "persist", "pgm", "radix_spline", "reuse", "rmi",
           "rmrt", "synth", "updates"]

