"""The launch cost tools of the port (ROADMAP item 14c:
``kernels.cost``, ``launch.op_cost.OpCost``, ``launch.dryrun``,
``launch.roofline``, ``launch.sweep``) and serving from FSDP-stored
weights (``serve.step.make_prefill(cfg, mesh)`` /
``make_decode_step(..., replicate_weights=False)``), on the CPU.

The reference runs in ONE subprocess of 4 host devices, started when this
module starts (``repro.launch.dryrun`` is never imported in this process:
its first lines set ``XLA_FLAGS`` to 512 host devices).  For qwen3-4b cut
by ``reduce_cfg`` (2 layers, d_model 64, vocab 256) with 2 KV heads at tp
2, ``tp_shard``, on (1, 2, 2) -- the layout ``test_torch_train_mesh.py``
uses -- it draws the weights (norm scales and biases randomised as in
``test_torch_tp.py``), runs ``make_prefill`` and three steps of
``make_decode_step(replicate_weights=False)`` compiled with
``xla_allow_excess_precision`` off, and reads ``HloCost(...).summary()``
of the compiled prefill, decode and train steps (4 x 32 tokens,
microbatch 1); it also lists ``roofline.model_flops`` of every arch and
shape and ``sweep.cells()``.

Checks:

* ``OpCost`` on ``tests/test_hlo_cost.py``'s four programs, exactly: 8
  looped 256^3 products, 3 x 5 nested loops of 128^3, one 64 x 512 x 32
  product, and 4 ``tp_psum`` of 1,024 f32 over n CPU positions (4 x 2 x
  4096 (n - 1) / n bytes a chip).
* ``model_flops`` and ``cells()`` equal the reference's.
* The reduced cells run on CPU positions and dry on meta positions give
  identical ``OpCost`` summaries (a train step, and a prefill and a
  decode step, on (1, 2, 2)).
* The two-depth extrapolation equals the count at full depth exactly, on
  a 4-superblock cut (a train and a decode cell on meta).
* ``kernels.cost`` reproduces ``PERF.md``'s K8 bounds at their printed
  digits (path D's prefill 0.139035 ms, path I's 0.069518 ms, path O's
  4.297e9 operations).
* The meta branches: empty outputs of the kernels' shapes and dtypes, no
  launch in ``LAUNCHES`` (which counts launches only), one call a tile and
  its work handed to ``OpCost``.  With no counter a wrapper computes no
  work.
* FSDP-stored prefill and decode equal the replicated form bit for bit,
  and the reference's within ``test_torch_tp.py``'s tolerances (logits
  ``LOGIT_TOL``, caches ``CACHE_ULPS`` bf16 ulps, ids where the top-2
  margin exceeds twice ``LOGIT_TOL``).
* Collective bytes a chip by kind against the reference's ``HloCost`` of
  the same cells.  Measured on these cells: the prefill's and decode's
  ``all-reduce`` within 0.4% (decode: one 4-byte all-reduce more in the
  reference), tolerance ``COLL_RTOL`` = 2%.  Two kinds differ by more,
  each accounted for by the HLO op named (ROADMAP queue 3): XLA:CPU
  gathers the bf16 weights as f32 (``all-gather(%convert_bitcast_fusion)``
  of ``f32[...]``), and scatters their f32 gradients, so its
  ``all-gather`` of the weights and its ``reduce-scatter`` are exactly
  twice the port's bf16 ones; in the train step its ``all-reduce`` also
  holds f32 tuples of weight gradients and cotangents
  (``transpose(jvp())/.../psum_invariant``) where the port sums the
  block outputs' bf16 cotangents and syncs replicated leaves once: 2.91
  times the port's bytes, held to within ``TRAIN_AR`` of that reading.
* ``sweep.run`` skips existing JSONs (the subprocess stubbed);
  ``roofline.load`` / ``fmt_table`` read a dry run's JSON and judge
  ``hbm_ok`` against 80e9 bytes; the ``index_service`` cell on the CPU
  (stacked K1's plain version, answers against numpy), raising without a
  card unless ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import SHAPES, get_arch, list_archs
from repro_torch.configs.base import ShapeCfg
from repro_torch.configs.reduced import reduce_cfg
from repro_torch.kernels import cost
from repro_torch.kernels import flash as tflash
from repro_torch.kernels import lookup as tlk
from repro_torch.launch import dryrun, roofline, sweep
from repro_torch.launch.op_cost import OpCost
from repro_torch.models import model as TM
from repro_torch.models import sharding as tsh
from repro_torch.serve import step as tstep
from repro_torch.train import optimizer as topt
from repro_torch.train import step as trs

LOGIT_TOL = 0.04
CACHE_ULPS = 8
COLL_RTOL = 0.02
TRAIN_AR = (2.85, 2.97)      # reference / port train all-reduce (2.913)
REDUCE = dict(n_layers=2, d_model=64, vocab=256)
OVER = dict(tp=2, n_kv_heads=2, tp_shard=True)
MESH = (1, 2, 2)
B, S, S_MAX, STEPS = 4, 12, 16, 3
TRAIN_B, TRAIN_S = 4, 32


def _cfg(**kw):
    return dataclasses.replace(reduce_cfg(get_arch("qwen3-4b"),
                                          **dict(REDUCE, **kw)), **OVER)


_REF_SCRIPT = r"""
import os, pickle, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
import repro  # noqa: F401
from repro.configs import SHAPES, get_arch, list_archs
from repro.configs.reduced import reduce_cfg
from repro.launch import roofline, sweep
from repro.launch.hlo_cost import HloCost
from repro.models import model as JM
from repro.serve import step as JS
from repro.train import optimizer as JO
from repro.train import step as JT

EXACT = {"xla_allow_excess_precision": False}
with open(%(inp)r, "rb") as fh:
    c = pickle.load(fh)
jc = dataclasses.replace(reduce_cfg(get_arch("qwen3-4b"), **c["reduce"]),
                         **c["over"])
m = jax.make_mesh(c["mesh"], ("pod", "data", "model"),
                  axis_types=(jax.sharding.AxisType.Auto,) * 3)


def export(t):
    if isinstance(t, dict):
        return {k: export(v) for k, v in t.items()}
    if hasattr(t, "_fields"):
        return {f: export(getattr(t, f)) for f in t._fields
                if getattr(t, f) is not None}
    return np.array(t)


def randomize(t, rng):
    if isinstance(t, dict):
        return {k: randomize(v, rng) for k, v in t.items()}
    f = t.astype(np.float32)
    if (f == 1.0).all():
        return (1 + 0.2 * rng.normal(size=t.shape)).astype(t.dtype)
    if (f == 0.0).all():
        return (0.2 * rng.normal(size=t.shape)).astype(t.dtype)
    return t


def to_jax(t, like):
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: to_jax(t[k], v) for k, v in like.items()}
    if hasattr(like, "_fields"):
        return type(like)(*(None if getattr(like, f) is None
                            else to_jax(t[f], getattr(like, f))
                            for f in like._fields))
    return jnp.asarray(t)


jp = JM.init_params(jc, jax.random.PRNGKey(3))
tree = randomize(export(jp), np.random.default_rng(4))
jp = to_jax(tree, jp)
out = dict(params=tree, costs={})
pre = JS.make_prefill(jc, m)[0].lower(
    jp, JM.init_cache(jc, c["B"], c["S_max"], local=False),
    jnp.asarray(c["toks"]), jnp.asarray(c["pos"])).compile(
        compiler_options=EXACT)
out["costs"]["prefill"] = HloCost(pre.as_text()).summary()
logits, caches = pre(jp, JM.init_cache(jc, c["B"], c["S_max"], local=False),
                     jnp.asarray(c["toks"]), jnp.asarray(c["pos"]))
out.update(prefill=np.array(logits), prefill_cache=export(caches))
dec = None
ids = []
for t, p, L in c["steps"]:
    a = (jp, caches, jnp.asarray(t), jnp.asarray(p), jnp.asarray(L, jnp.int32))
    if dec is None:
        dec = JS.make_decode_step(jc, m, replicate_weights=False)[0].lower(
            *a).compile(compiler_options=EXACT)
        out["costs"]["decode"] = HloCost(dec.as_text()).summary()
    nx, caches = dec(*a)
    ids.append(np.array(nx))
out.update(ids=ids, cache=export(caches))
x = jnp.zeros((c["TB"], c["TS"]), jnp.int32)
pos = jnp.broadcast_to(jnp.arange(c["TS"], dtype=jnp.int32)[None], x.shape)
tr = JT.make_train_step(jc, m, lr=1e-2, donate=False, microbatch=1)[0]
tr = tr.lower(jp, JO.init(jp), jnp.zeros(()), x, x, pos).compile(
    compiler_options=EXACT)
out["costs"]["train"] = HloCost(tr.as_text()).summary()
out["model_flops"] = {(a, s): roofline.model_flops(a, s)
                      for a in [*list_archs(), "index_service"]
                      for s in SHAPES}
out["cells"] = sweep.cells()
with open(%(out)r, "wb") as fh:
    pickle.dump(out, fh)
print("COST_REF_OK")
"""


def _inputs() -> dict:
    rng = np.random.default_rng(21)
    cfg = _cfg()
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    steps = [(rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32),
              np.full((B, 1), S + i, np.int32), S + i) for i in range(STEPS)]
    return dict(reduce=REDUCE, over=OVER, mesh=MESH, B=B, S_max=S_MAX,
                toks=toks, pos=pos, steps=steps, TB=TRAIN_B, TS=TRAIN_S)


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    """The reference's records, from one subprocess of 4 host devices
    started when the module starts (None without JAX)."""
    try:
        import jax  # noqa: F401
    except ImportError:
        yield None
        return
    tmp = tmp_path_factory.mktemp("cost_ref")
    with open(tmp / "in.pkl", "wb") as fh:
        pickle.dump(_inputs(), fh)
    env = dict(os.environ, PYTHONPATH="src")
    env.pop("XLA_FLAGS", None)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-c", _REF_SCRIPT % {
            "inp": str(tmp / "in.pkl"), "out": str(tmp / "out.pkl")}],
        env=env, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    box = {}

    def result():
        if "out" not in box:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0 and "COST_REF_OK" in out, err[-4000:]
            with open(tmp / "out.pkl", "rb") as fh:
                box["out"] = pickle.load(fh)
        return box["out"]
    yield result
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def _ref(reference):
    if reference is None:
        pytest.skip("the reference (JAX) is not installed")
    return reference()


# ---------------------------------------------------------------- OpCost --
def test_op_cost_loop_trip_counts():
    x = torch.randn(256, 256)
    with OpCost() as c:
        y = x
        for _ in range(8):
            y = y @ y
    assert c.summary()["flops"] == 8 * 2 * 256 ** 3
    assert c.summary()["flops_by_dtype"] == {"float32": 8 * 2 * 256 ** 3}


def test_op_cost_nested_loops():
    x = torch.randn(128, 128)
    with OpCost() as c:
        for _ in range(5):
            y = x
            for _ in range(3):
                y = y @ y
    assert c.summary()["flops"] == 15 * 2 * 128 ** 3


def test_op_cost_dot_plain():
    a, b = torch.randn(64, 512), torch.randn(512, 32)
    with OpCost() as c:
        a @ b
    s = c.summary()
    assert s["flops"] == 2 * 64 * 512 * 32
    assert s["bytes"] == (64 * 512 + 512 * 32 + 64 * 32) * 4
    assert s["ops"] == 1


@pytest.mark.parametrize("n", [2, 4])
def test_op_cost_collectives_counted_with_trips(n):
    mesh = tsh.ModelMesh((1, 1, n), devices="cpu")
    xs = [torch.randn(1024) for _ in range(n)]
    with OpCost(chips=n) as c:
        for _ in range(4):
            xs = mesh.tp_psum(xs)
    s = c.summary()
    assert s["collective_bytes"] == 4 * 2 * 1024 * 4 * (n - 1) / n
    assert s["collective_bytes_by_kind"] == {
        "all-reduce": s["collective_bytes"]}
    assert s["collective_counts"] == {"all-reduce": 4}


def test_model_flops_and_cells_match_reference(reference):
    ref = _ref(reference)
    got = {(a, s): roofline.model_flops(a, s)
           for a in [*list_archs(), "index_service"] for s in SHAPES}
    assert got == ref["model_flops"]
    assert sweep.cells() == ref["cells"]
    assert sweep.cells(("single",)) == [c for c in ref["cells"]
                                        if c[2] == "single"]


# ------------------------------------------------- the same on every device --
def _serve_costs(cfg, dev, fsdp: bool = True) -> tuple:
    """OpCost summaries of a prefill and a decode step on (1, 2, 2)
    positions of ``dev``."""
    mesh = tsh.ModelMesh(MESH, devices=dev)
    glob = TM.init_params(cfg, torch.Generator().manual_seed(0), device=dev,
                          mesh=mesh)
    pre = tstep.make_prefill(cfg, mesh, replicate_weights=not fsdp)
    dec = tstep.make_decode_step(cfg, mesh, replicate_weights=not fsdp)
    params = tstep.shard_tree(glob, pre.in_specs[0], mesh)
    caches = tstep.shard_tree(TM.init_cache(cfg, B, S_MAX, local=False,
                                            device=dev),
                              pre.in_specs[1], mesh, share=False)
    toks = torch.zeros((B, S), dtype=torch.int32, device=dev)
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(
        B, S).contiguous()
    with OpCost(mesh.size) as c1:
        _, caches = pre(params, caches,
                        tstep.shard_tree(toks, pre.in_specs[2], mesh),
                        tstep.shard_tree(pos, pre.in_specs[3], mesh))
    t1 = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    with OpCost(mesh.size) as c2:
        dec(params, caches, tstep.shard_tree(t1, dec.in_specs[2], mesh),
            tstep.shard_tree(t1, dec.in_specs[3], mesh), S)
    return c1.summary(), c2.summary()


def _train_cost(cfg, dev) -> dict:
    mesh = tsh.ModelMesh(MESH, devices=dev)
    glob = TM.init_params(cfg, torch.Generator().manual_seed(0), device=dev,
                          mesh=mesh)
    fn = trs.make_train_step(cfg, mesh, lr=1e-2)
    params = tstep.shard_tree(glob, fn.in_specs[0], mesh)
    opt = topt.init(params)
    x = torch.zeros((TRAIN_B, TRAIN_S), dtype=torch.int32, device=dev)
    pos = torch.arange(TRAIN_S, dtype=torch.int32, device=dev)[None].expand(
        TRAIN_B, TRAIN_S).contiguous()
    a = [tstep.shard_tree(t, s, mesh)
         for t, s in zip((x, x, pos), fn.in_specs[3:], strict=True)]
    with OpCost(mesh.size) as c:
        fn(params, opt, None, *a)
    return c.summary()


@pytest.fixture(scope="module")
def counted():
    cfg = _cfg()
    return {"serve": {d: _serve_costs(cfg, d) for d in ("cpu", "meta")},
            "train": {d: _train_cost(cfg, d) for d in ("cpu", "meta")}}


def test_cpu_positions_equal_meta_positions(counted):
    """Every number of the summaries (FLOPs by dtype, bytes, the kernels'
    calls and work, collectives, the count of ops) is the same on CPU
    positions, where the plain versions run, and in the dry run."""
    for what in ("serve", "train"):
        assert counted[what]["cpu"] == counted[what]["meta"], what
    pre, dec = counted["serve"]["meta"]
    assert pre["kernels"]["flash_cc"]["calls"] == 2 * 4   # a layer a position
    assert dec["kernels"]["flash_cc"]["calls"] == 2 * 4
    tr = counted["train"]["meta"]
    assert tr["kernels"]["flash_cc"]["calls"] == 2 * 2 * 4   # + remat
    assert tr["flops_by_dtype"]["float32"] > 0


def test_depth_extrapolation_exact():
    """One superblock and two, extrapolated to four, equal the count of
    the 4-superblock cut (a train and a decode cell on meta)."""
    full = _cfg(n_layers=4)
    assert full.n_sb == 4
    mesh = tsh.ModelMesh(MESH, devices="meta")
    opts = dict(compress_pod=False, microbatch=1, psum_bf16=False,
                replicate_weights=False)
    for shape in (ShapeCfg("t", TRAIN_S, TRAIN_B, "train"),
                  ShapeCfg("d", S_MAX, B, "decode")):
        c = {}
        for d in (1, 2, 4):
            fn, args, _, _ = dryrun._build(dryrun._cut(full, d), shape, mesh,
                                           opts)
            c[d] = dryrun.count_step(fn, args, mesh.size,
                                     track_memory=False)[0]
        assert dryrun._extrapolate(c[1], c[2], 4) == c[4], shape.name
        assert c[4]["ops"] > c[2]["ops"] > c[1]["ops"]


# ------------------------------------------------------------ kernels.cost --
def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _ms(work: cost.Work) -> float:
    rate = roofline.PEAK_FLOPS["bfloat16" if work.unit == cost.BF16
                               else "float32"]
    return max(work.ops / rate, work.bytes / roofline.HBM_BW) * 1e3


def test_cost_reproduces_perf_k8_bounds():
    # path D's prefill: qwen3-4b one-card, 4 x 2,048 prompt, 32 / 8 heads
    w = tflash.tile_work(_meta(4, 2048, 32, 128), _meta(4, 2080, 8, 128), 0,
                         2048, "flash")
    assert f"{_ms(w):.6f}" == "0.139035"
    # path I: 8 x 2,048, 16 / 8 heads at dh 64, with lse
    w = tflash.tile_work(_meta(8, 2048, 16, 64), _meta(8, 2048, 8, 64), 0,
                         2048, "flash", lse=True)
    assert f"{_ms(w):.6f}" == "0.069518"
    # path O: B 2, S 2,048, 2 / 1 heads at dh 128, with lse
    w = tflash.tile_work(_meta(2, 2048, 2, 128), _meta(2, 2048, 1, 128), 0,
                         2048, "flash", lse=True)
    assert f"{w.ops:.3e}" == "4.297e+09" and f"{_ms(w):.6f}" == "0.004345"
    assert w.unit == cost.BF16
    assert tflash.tile_work(_meta(1, 1, 2, 64), _meta(1, 64, 1, 64), 63, 64,
                            "flash_decode").unit == cost.F32


def test_meta_branches_stand_in_for_the_launches():
    tflash.reset_launches()
    q, k = _meta(2, 64, 4, 64), _meta(2, 64, 2, 64)
    with OpCost() as c:
        out = tflash.flash_attention(q, k, k, q_offset=0)
        o2, lse = tflash.flash_attention_lse(q, k, k, q_offset=0)
        dq = _meta(2, 1, 4, 64)
        od = tflash.flash_attention(dq, k, k, q_offset=63)
        m, l, acc = tflash.flash_attention(dq, k, k, q_offset=63,
                                           return_partial=True)
        mg = tflash.flash_merge(_meta(2, 4, 3, 1, dtype=torch.float32),
                                _meta(2, 4, 3, 1, dtype=torch.float32),
                                _meta(2, 4, 3, 1, 64, dtype=torch.float32))
    assert out.shape == o2.shape == q.shape and out.dtype == torch.bfloat16
    assert out.device.type == "meta"
    assert lse.shape == (2, 4, 64) and lse.dtype == torch.float32
    assert od.shape == dq.shape
    assert (m.shape, l.shape, acc.shape) == ((2, 4, 1), (2, 4, 1),
                                             (2, 4, 1, 64))
    assert mg.shape == (2, 1, 4, 64) and mg.dtype == torch.bfloat16
    # nothing was launched: the counts stay at 0, OpCost counts the calls
    assert not any(tflash.LAUNCHES.values())
    assert not any(tflash.LSE_LAUNCHES.values())
    k_ = c.summary()["kernels"]
    assert {n: v["calls"] for n, v in k_.items()} == {
        "flash": 2, "flash_decode": 1, "flash_partial": 1, "flash_merge": 1}
    assert k_["flash"]["flops"] == 2 * tflash.tile_work(q, k, 0, 64,
                                                        "flash").ops
    assert c.summary()["ops"] == 0          # nothing but the kernels
    # a head dim no tile takes raises on meta, as on a card
    with pytest.raises(ValueError):
        tflash.flash_attention(_meta(1, 4, 2, 384), _meta(1, 4, 2, 384),
                               _meta(1, 4, 2, 384), q_offset=0)
    tflash.reset_launches()
    tlk.reset_launches()
    qs = torch.empty(4096, dtype=torch.float32, device="meta")
    with OpCost() as c:
        r = tlk.sharded_lookup(
            qs, torch.empty(4096, dtype=torch.int32, device="meta"),
            _meta(2, 8, 128, dtype=torch.float32),
            _meta(2, 12, 128, dtype=torch.float32),
            _meta(2, 8, 128, dtype=torch.float32),
            _meta(2, 1024, dtype=torch.float32), n_leaves=64, iters=5)
    assert r.shape == (4096,) and r.dtype == torch.int32
    assert not any(tlk.LAUNCHES.values())
    assert c.summary()["kernels"]["sharded_lookup"] == {
        "calls": 1, "flops": 4096 * (12 + 10),
        "bytes": 4096 * (8 + 4 + 16 + 20)}
    tlk.reset_launches()


def test_counted_computes_no_work_without_a_counter(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("work computed with no counter")
    monkeypatch.setattr(cost, "flash_work", boom)
    monkeypatch.setattr(cost, "merge_work", boom)
    monkeypatch.setattr(cost, "gemm_work", boom)
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 4, 2, 16, generator=g).to(torch.bfloat16)
    k = torch.randn(1, 4, 1, 16, generator=g).to(torch.bfloat16)
    out = tflash.flash_attention(q, k, k, q_offset=0)
    m, l, acc = tflash.flash_attention(q[:, :1], k, k, q_offset=3,
                                       return_partial=True)
    tflash.flash_merge(m[:, :, None], l[:, :, None], acc[:, :, None])
    from repro_torch.models import layers as TL
    TL._mm_f32(q[0, :, 0], k[0, :, 0].T)
    assert out.shape == q.shape and not cost.inside()
    with OpCost(), pytest.raises(AssertionError, match="no counter"):
        tflash.flash_attention(q, k, k, q_offset=0)
    assert not cost.inside() and not cost.COUNTERS


# ----------------------------------------------- serving from FSDP storage --
def _t(a) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def _ulps(got, want) -> np.ndarray:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    m = np.maximum(np.abs(got), np.abs(want)).max(-1, keepdims=True)
    m = np.maximum(m, np.float32(2.0 ** -126))
    return np.abs(got - want) / np.exp2(np.floor(np.log2(m)) - 7)


def _serve(cfg, tree, c, replicate: bool) -> dict:
    """The port's prefill and decode steps on CPU positions, weights in
    FSDP storage (or replicated), gathered."""
    mesh = tsh.ModelMesh(MESH, devices="cpu")
    params = convert.lm_params_from_arrays(tree, cfg, device="cpu",
                                           mesh=mesh, fsdp=not replicate)
    pre = tstep.make_prefill(cfg, mesh, replicate_weights=replicate)
    dec = tstep.make_decode_step(cfg, mesh, replicate_weights=replicate)
    _, c_spec, t_spec, p_spec = pre.in_specs
    caches = tstep.shard_tree(TM.init_cache(cfg, B, S_MAX, local=False,
                                            device="cpu"),
                              c_spec, mesh, share=False)
    tsh.reset_collectives()
    logits, caches = pre(params, caches,
                         tstep.shard_tree(torch.from_numpy(c["toks"]),
                                          t_spec, mesh),
                         tstep.shard_tree(torch.from_numpy(c["pos"]),
                                          p_spec, mesh))
    out = dict(gathers=tsh.COLLECTIVES["fsdp_gather"]["calls"],
               prefill=tstep.gather_tree(logits, pre.out_specs[0], mesh),
               prefill_cache=tstep.gather_tree(caches, c_spec, mesh),
               ids=[], margins=[])
    for t, p, L in c["steps"]:
        tl = tstep.shard_tree(torch.from_numpy(t), t_spec, mesh)
        pl = tstep.shard_tree(torch.from_numpy(p), p_spec, mesh)
        x, _ = TM.forward(params, cfg, tl, pos=pl, mode="decode",
                          caches=[{q: {k: v.clone() for k, v in d.items()}
                                   for q, d in cr.items()} for cr in caches],
                          cache_len=L, mesh=mesh, fsdp=not replicate)
        lg = mesh.all_gather([g[:, 0] for g in TM.lm_logits(
            params, cfg, x, True, mesh=mesh, fsdp=not replicate)],
            "model", dim=1)
        lg = tstep.gather_tree(lg, (dec.out_specs[0][0], None), mesh)
        top2 = np.sort(lg[:, :cfg.vocab_size].numpy(), -1)[:, -2:]
        out["margins"].append(top2[:, 1] - top2[:, 0])
        nx, caches = dec(params, caches, tl, pl, L)
        out["ids"].append(tstep.gather_tree(nx, dec.out_specs[0], mesh))
    out["cache"] = tstep.gather_tree(caches, c_spec, mesh)
    return out


def _equal_trees(a, b) -> bool:
    if isinstance(a, dict):
        return all(_equal_trees(a[k], b[k]) for k in a)
    return torch.equal(a, b)


def test_fsdp_serving_matches_replicated_and_reference(reference):
    ref = _ref(reference)
    c = _inputs()
    cfg = _cfg()
    fs = _serve(cfg, ref["params"], c, replicate=False)
    rp = _serve(cfg, ref["params"], c, replicate=True)
    # one gather a leaf with a data axis, a superblock, plus the table and
    # the head, on each of the two data groups; none when replicated
    assert fs["gathers"] > 0 and rp["gathers"] == 0
    assert torch.equal(fs["prefill"], rp["prefill"])
    assert _equal_trees(fs["prefill_cache"], rp["prefill_cache"])
    assert all(torch.equal(a, b) for a, b in zip(fs["ids"], rp["ids"],
                                                 strict=True))
    assert _equal_trees(fs["cache"], rp["cache"])
    # against the reference's FSDP-stored steps
    np.testing.assert_allclose(fs["prefill"].numpy(), ref["prefill"],
                               atol=LOGIT_TOL, rtol=0)
    for got, want in ((fs["prefill_cache"], ref["prefill_cache"]),
                      (fs["cache"], ref["cache"])):
        for pos, leaves in got.items():
            for k, t in leaves.items():
                assert _ulps(t.float().numpy(), np.asarray(
                    want[pos][k], np.float32)).max() <= CACHE_ULPS, (pos, k)
    for ids, want, margin in zip(fs["ids"], ref["ids"], fs["margins"],
                                 strict=True):
        sure = margin > 2 * LOGIT_TOL
        assert (ids.numpy()[sure] == np.asarray(want)[sure]).all()


def test_collective_bytes_against_reference(reference, counted):
    """A chip's collective bytes by kind against the reference's HloCost
    of the same cells (see the module docstring for the kinds that
    differ, and the HLO ops that account for them)."""
    ref = _ref(reference)["costs"]
    pre, dec = counted["serve"]["meta"]
    tr = counted["train"]["meta"]
    per = lambda s, k: s["collectives"].get(k, {}).get("bytes", 0) / s[
        "chips"]
    for name, got in (("prefill", pre), ("decode", dec)):
        want = ref[name]["collective_bytes_by_kind"]
        ar = got["collective_bytes_by_kind"]["all-reduce"]
        assert abs(ar - want["all-reduce"]) <= COLL_RTOL * want["all-reduce"]
        # XLA:CPU's all-gather of f32 convert fusions of the bf16 weights:
        # twice the port's bf16 gather; the logits' gather (decode) as is
        assert want["all-gather"] == 2 * per(got, "fsdp_gather") + per(
            got, "all_gather"), name
        assert got["collective_counts"]["all-gather"] == ref[name][
            "collective_counts"]["all-gather"]
    want = ref["train"]["collective_bytes_by_kind"]
    got = tr["collective_bytes_by_kind"]
    assert want["all-gather"] == 2 * got["all-gather"]
    assert want["reduce-scatter"] == 2 * got["reduce-scatter"]
    ratio = want["all-reduce"] / got["all-reduce"]
    assert TRAIN_AR[0] <= ratio <= TRAIN_AR[1], ratio


# ------------------------------------------------- dryrun, roofline, sweep --
def test_sweep_run_skips_existing(tmp_path, monkeypatch, capsys):
    done = ("qwen3_4b", "decode_32k", "single")     # list_archs()' names
    (tmp_path / f"{'__'.join(done)}.json").write_text("{}")
    calls = []

    class Proc:
        returncode, stderr = 0, ""

    def fake_run(cmd, **kw):
        calls.append(cmd)
        assert kw["timeout"] == 7
        return Proc()
    monkeypatch.setattr(sweep.subprocess, "run", fake_run)
    res = sweep.run(str(tmp_path), ("single",), 7, only_arch="qwen3_4b")
    shapes = [s for a, s, m in sweep.cells(("single",)) if a == "qwen3_4b"]
    assert [c[c.index("--shape") + 1] for c in calls] == [
        s for s in shapes if s != "decode_32k"]
    assert all(c[1:3] == ["-m", "repro_torch.launch.dryrun"] for c in calls)
    assert all(r["ok"] for r in res)
    log = json.loads((tmp_path / "_sweep_log.json").read_text())
    assert len(log) == len(shapes) - 1


def test_dryrun_row_and_roofline_table(tmp_path, monkeypatch):
    """A cell written by ``run_cell`` (a reduced qwen3-4b on a (2, 2)
    meta mesh in place of the production one), read back by ``load``,
    tabulated, and ``hbm_ok`` judged against 80e9 bytes."""
    cfg = _cfg(n_layers=3)
    monkeypatch.setattr(dryrun, "get_arch", lambda name: cfg)
    monkeypatch.setattr(dryrun, "make_production_mesh",
                        lambda multi_pod, devices: tsh.ModelMesh(
                            (2, 2), ("data", "model"), devices))
    monkeypatch.setitem(dryrun.SHAPES, "tiny",
                        ShapeCfg("tiny", 32, 4, "decode"))
    r = dryrun.run_cell("qwen3-4b", "tiny", False, str(tmp_path))
    assert r["depth_counted"] == [1, 2] and r["n_sb"] == 3
    assert r["kernels"]["flash_cc"]["calls"] == 3 * 4
    assert r["memory"]["peak_bytes_est"] == (
        r["memory"]["argument_bytes"] + r["memory"]["output_bytes"]
        + r["memory"]["temp_bytes"] - r["memory"]["alias_bytes"])
    assert r["memory"]["alias_bytes"] > 0 and r["memory"]["temp_bytes"] > 0
    assert r["roofline"]["collective_s"] == \
        r["collective"]["total_bytes"] / roofline.NVLINK_BW
    big = dict(r, shape="decode_32k", memory=dict(r["memory"],
                                                  peak_bytes_est=81e9))
    (tmp_path / "qwen3-4b__decode_32k__single.json").write_text(
        json.dumps(big))
    (tmp_path / "_sweep_log.json").write_text("[]")
    rows = roofline.load(str(tmp_path))
    assert [(x["shape"], x["hbm_ok"]) for x in rows] == [
        ("decode_32k", False), ("tiny", True)]
    assert rows[0]["model_flops"] == roofline.model_flops("qwen3-4b",
                                                          "decode_32k")
    table = roofline.fmt_table(rows)
    assert table.splitlines()[2].startswith("| qwen3-4b | decode_32k |")
    assert table.splitlines()[2].endswith("| 81.00 | NO |")
    assert roofline.link_bw(256) == roofline.NIC_BW


def test_index_service_cell_on_cpu():
    summary, meta, (idx, q, ranks) = dryrun.lower_index_service("cpu")
    assert meta["device"] == "cpu"
    assert summary["kernels"]["sharded_lookup"]["calls"] == 16
    assert summary["collective_bytes_by_kind"]["all-to-all"] > 0
    # the answers: a query's left boundary in its shard, plus shard * cap
    splits = idx.splits.numpy()
    cap = idx.cap
    keys = torch.cat([p.keys for p in idx.parts]).numpy()
    qn = q.numpy()
    dest = np.searchsorted(splits, qn, side="left")
    valid = idx.valid.numpy()
    want = np.array([min(np.searchsorted(keys[s][:valid[s]], x), valid[s])
                     + s * cap for s, x in zip(dest, qn, strict=True)])
    np.testing.assert_array_equal(ranks.numpy(), want)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dryrun.lower_index_service()
