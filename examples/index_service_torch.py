"""Multi-tenant learned-index service on the PyTorch port's batching
front-end (the counterpart of ``examples/index_service.py``).

Two dynamic sharded indexes of different build sizes, each of 4 shards on
the positions of one mesh (``--positions``, each position on ``--device``:
4 is one shard a position, as the reference places them, 1 one stack),
serve as tenants of one ``repro_torch.serve.frontend.BatchingFrontend``:
requests coalesce up to a 2 ms latency budget, pad to pow2 capacity
classes, and every batch's finds over both tenants are one launch of the
shard-stacked K2 a position that holds queries.  An
insert rides the queue as a typed ``Request``; a short open-loop Poisson
drive reports the sustained QPS and p50/p99 latency; then the indexed
data-pipeline demo (agile reuse on every new shard).

    PYTHONPATH=src python examples/index_service_torch.py                # card
    PYTHONPATH=src python examples/index_service_torch.py --device cpu
    PYTHONPATH=src python examples/index_service_torch.py --positions 2

The tenants' keys are rounded to f32 (the reference example's are not), so
that on the card the front-end takes the kernels; the dataset's keys are
the reference's and take the exact f64 path.  On the CPU every path is
the plain one, and the numbers printed are the CPU's.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.api import Index
from repro_torch.core.distributed import ShardMesh
from repro_torch.data.indexed_dataset import IndexedDataset
from repro_torch.kernels import lookup as tlk
from repro_torch.serve.frontend import BatchingFrontend, Request, ServeConfig


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--rate", type=float, default=300.0,
                   help="offered point lookups a second")
    p.add_argument("--duration", type=float, default=2.0,
                   help="seconds of the Poisson drive")
    p.add_argument("--n", type=int, default=1 << 16,
                   help="keys of the larger tenant (the other: n / 4)")
    p.add_argument("--positions", type=int, default=1, choices=(1, 2, 4),
                   help="mesh positions the 4 shards lie on, each on "
                        "--device")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    mesh = ShardMesh(4, devices=(dev,) * args.positions)
    rng = np.random.default_rng(3)

    # --- multi-tenant serving front-end -----------------------------------
    # Tenants build through the facade (repro_torch.api.Index): mesh=
    # selects the sharded backend, and .backend is the front-end's tenant.
    tenants, live = [], []
    for i, (n, n_leaves) in enumerate(((args.n, 256), (args.n // 4, 64))):
        raw = rng.lognormal(0, 1, n) * 1e6 + i * 1e9
        keys = np.unique(np.sort(raw).astype(np.float32)).astype(np.float64)
        tenants.append(Index.build(keys, mesh=mesh, n_leaves=n_leaves,
                                   device=dev).backend)
        live.append(keys)

    with BatchingFrontend(tenants,
                          config=ServeConfig(latency_budget_s=2e-3)) as fe:
        fe.warmup((1, 128))

        # one insert riding the same queue as the finds (it applies before
        # the coalesced batch's finds), submitted as a typed Request
        extra = np.asarray([live[1][-1] + 64.0, live[1][-1] + 128.0])
        fe.submit(Request(1, "insert", extra)).result(timeout=300.0)
        found, _ = fe.lookup(1, extra)
        assert found.all(), "inserted keys must be visible to the next find"

        # open-loop Poisson drive of point lookups across the tenants
        k0 = tlk.LAUNCHES["sharded_dynamic_lookup"]
        b0 = fe.stats.batches
        gaps = rng.exponential(1.0 / args.rate,
                               size=int(args.rate * args.duration * 2) + 1)
        arrivals = np.cumsum(gaps)
        arrivals = arrivals[arrivals < args.duration]
        reqs, t0 = [], fe.clock()
        for dt in arrivals:
            lag = (t0 + dt) - fe.clock()
            if lag > 0:
                time.sleep(lag)
            tid = int(rng.random() < 0.3)
            reqs.append((t0 + dt, tid, fe.submit_find(
                tid, rng.choice(live[tid], 1))))
        for _, tid, r in reqs:
            f, _ = r.result(timeout=60.0)
            assert f.all(), "every drawn key is live"
        lats = np.asarray([r.done_at - sched for sched, _, r in reqs]) * 1e3
        span = max(r.done_at for _, _, r in reqs) - t0
        st = fe.stats
        batches = st.batches - b0
        launches = tlk.LAUNCHES["sharded_dynamic_lookup"] - k0
        out = dict(requests=len(reqs), qps=len(reqs) / span,
                   p50_ms=float(np.percentile(lats, 50)),
                   p99_ms=float(np.percentile(lats, 99)), batches=batches,
                   launches=launches)
        print(f"serving front-end on {_device_name(dev)}: {len(reqs)} "
              f"requests, {out['qps']:.0f} QPS sustained (offered "
              f"{args.rate:.0f}), p50={out['p50_ms']:.1f}ms "
              f"p99={out['p99_ms']:.1f}ms")
        print(f"  {batches} stacked dispatches over {fe.pack.n_tenants} "
              f"tenants x {fe.pack.n_shards} shards on {args.positions} "
              f"positions ({launches} launches of the stacked K2), "
              f"capacity classes {sorted(st.qcaps)}, pad fraction "
              f"{st.pad_fraction:.0%}")

    # --- indexed data pipeline ----------------------------------------------
    ds = IndexedDataset.create(eps=0.9, kind="linear", n_leaves=128,
                               device=dev)
    for shard in range(4):
        sk = np.sort(rng.lognormal(0, 0.6, 100_000)) * 1e6 + shard * 1e12
        info = ds.add_shard(sk)
        print(f"shard {shard}: indexed with {info.reuse_fraction:.0%} leaf "
              f"reuse")
    sample = rng.choice(ds.shards[2].keys, 1000)
    sid, off = ds.locate(sample)
    assert (sid == 2).all()
    assert np.allclose(ds.shards[2].keys[off], sample)
    print(f"pipeline locate(): exact; mean reuse {ds.mean_reuse:.0%}")
    out["mean_reuse"] = ds.mean_reuse
    return out


if __name__ == "__main__":
    main()
