"""MoE and Mamba under tensor parallelism on the port (ROADMAP item 14d,
the rest: ``layers.moe_block(..., mesh=)`` with its experts over
``model``, ``ssm.mamba_block(..., mesh=)`` with ``d_inner`` over
``model``, and jamba's sequence-sharded decode through both) held against
the reference's ``shard_map`` steps on the CPU.

As ``test_torch_tp.py``: ONE reference subprocess of 4 host devices,
started when this module starts, draws each case's weights
(``init_params``, norm scales and biases randomised), runs
``make_prefill`` and ``make_decode_step`` compiled with
``xla_allow_excess_precision`` off and pickles the global weights,
logits, ids and caches; the port carries the weights across
(``convert.lm_params_from_arrays(..., mesh=)``), runs its steps on CPU
positions from the same inputs (decode teacher-forced with the same ids)
and gathers the results.  Cases, all ``reduce_cfg`` cuts with ``tp_shard``
on and ``vocab=256``:

* jamba at tp 2 on (1, 1, 2) (7 Mamba layers at d_inner 128, 64 a
  position; 4 MoE layers of 8 experts, 4 a position), then
  sequence-sharded decode on (1, 2, 2) from its prefill's caches: 32
  positions in chunks of 16, the prompt 14 long, four steps, the write
  crossing into chunk 1 on the third; the Mamba states replicated over
  ``data``;
* qwen2-moe with 6 experts at tp 4 on (1, 1, 4): padded to 8, two a
  position, so position 3 holds only padding; one shared expert, 8 of its
  columns a position;
* granite-moe at tp 2 on (1, 2, 2): the batch over ``data``, so each
  position's capacity C counts its data shard's tokens.  Row 0 repeats one
  token, so that assignments are dropped for capacity (asserted).

Tolerances, measured on these inputs (largest value seen in brackets):
prefill logits within ``LOGIT_TOL`` = 0.04 of the reference's (granite
0.0096, where one cache entry's bf16 rounding flips; jamba 4.8e-7,
qwen2-moe 2.4e-7), the K/V and Mamba ``conv`` caches within ``CACHE_ULPS``
= 8 bf16 ulps of their vector's largest entry (1.0, granite; jamba 0),
the Mamba ``h`` within ``H_RTOL`` = 1e-4 of its vector's largest entry
(3.1e-5, jamba after four decode steps), decode ids equal wherever the
port's top-2 margin exceeds twice ``LOGIT_TOL`` (every id equal, the
sequence-sharded ones too).  The port-only tests hold the mesh programs
against the port's one-card form on the same global weights within
``ONE_CARD_TOL`` = 1e-5 (0.0: the psums of two or four positions' f32
partials round as the one product here), jamba's only after each Mamba
``in_proj`` is regrouped into the one-card form's halves; the tree as it
stands differs by more than ``HALVES_MIN`` = 0.1 (4.28 in the prefill
logits, at a scale of 2.69).
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.configs.reduced import reduce_cfg
from repro_torch.models import layers as tlayers
from repro_torch.models import model as TM
from repro_torch.models import sharding as tsh
from repro_torch.models import ssm as tssm
from repro_torch.serve import step as tstep

LOGIT_TOL = 0.04
ONE_CARD_TOL = 1e-5
CACHE_ULPS = 8
H_RTOL = 1e-4
HALVES_MIN = 0.1
REDUCE = dict(n_layers=2, d_model=64, vocab=256)

# name: (arch, config overrides, MoE overrides, mesh of prefill and decode,
#        batch, prompt, S_max, mesh of the sequence-sharded decode or None)
CASES = {
    "jamba-seq": ("jamba-v0.1-52b", dict(tp=2), {}, (1, 1, 2), 2, 14, 32,
                  (1, 2, 2)),
    "qwen2-moe-padded": ("qwen2-moe-a2.7b", dict(tp=4), dict(n_experts=6),
                         (1, 1, 4), 2, 12, 16, None),
    "granite-data": ("granite-moe-1b-a400m", dict(tp=2), {}, (1, 2, 2), 4,
                     12, 16, None),
}
STEPS = 4


def _cfg(name):
    arch, over, moe, *_ = CASES[name]
    cfg = reduce_cfg(get_arch(arch), **REDUCE)
    cfg = dataclasses.replace(cfg, tp_shard=True, **over)
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    return cfg


def _inputs(name) -> dict:
    """The case's prompt and teacher-forced decode inputs, numpy."""
    arch, over, moe, mesh, B, S, S_max, seq = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    toks = rng.integers(0, 256, (B, S)).astype(np.int32)
    if name == "granite-data":
        toks[0] = toks[0, 0]          # one token 12 times: over capacity
    steps_in = [rng.integers(0, 256, (B, 1)).astype(np.int32)
                for _ in range(STEPS)]
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    return dict(arch=arch, over=dict(over, tp_shard=True), moe=moe,
                mesh=mesh, B=B, S=S, S_max=S_max, seq=seq, toks=toks,
                pos=pos, steps=[(t, np.full((B, 1), S + i, np.int32), S + i)
                                for i, t in enumerate(steps_in)])


_REF_SCRIPT = r"""
import os, pickle, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
import repro  # noqa: F401
from repro.configs import get_arch
from repro.configs.reduced import reduce_cfg
from repro.models import model as JM
from repro.serve import step as JS

EXACT = {"xla_allow_excess_precision": False}


def mesh(shape):
    return jax.make_mesh(shape, ("pod", "data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)


def compiled(fn):
    made = []
    def call(*a):
        if not made:
            made.append(fn.lower(*a).compile(compiler_options=EXACT))
        return made[0](*a)
    return call


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


with open(%(inp)r, "rb") as fh:
    cases = pickle.load(fh)
out = {}
for name, c in cases.items():
    jc = dataclasses.replace(reduce_cfg(get_arch(c["arch"]), **c["reduce"]),
                             **c["over"])
    if c["moe"]:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe,
                                                             **c["moe"]))
    jp = JM.init_params(jc, jax.random.PRNGKey(3))
    tree = randomize(export(jp), np.random.default_rng(4))
    jp = to_jax(tree, jp)
    m = mesh(c["mesh"])
    pre = compiled(JS.make_prefill(jc, m)[0])
    caches = JM.init_cache(jc, c["B"], c["S_max"], local=False)
    logits, caches = pre(jp, caches, jnp.asarray(c["toks"]),
                         jnp.asarray(c["pos"]))
    rec = dict(params=tree, prefill=np.array(logits),
               prefill_cache=export(caches))
    dec = compiled(JS.make_decode_step(jc, m)[0])
    ids = []
    for t, p, L in c["steps"]:
        nx, caches = dec(jp, caches, jnp.asarray(t), jnp.asarray(p),
                         jnp.asarray(L, jnp.int32))
        ids.append(np.array(nx))
    rec.update(ids=ids, cache=export(caches))
    if c["seq"] is not None:
        ms = mesh(c["seq"])
        sdec = compiled(JS.make_decode_step(jc, ms, batch_sharded=False,
                                            seq_shard=True)[0])
        caches = to_jax(rec["prefill_cache"], rec["prefill_cache"])
        sids, scaches = [], []
        for t, p, L in c["steps"]:
            nx, caches = sdec(jp, caches, jnp.asarray(t), jnp.asarray(p),
                              jnp.asarray(L, jnp.int32))
            sids.append(np.array(nx))
            scaches.append(export(caches))
        rec.update(seq_ids=sids, seq_caches=scaches)
    out[name] = rec
with open(%(out)r, "wb") as fh:
    pickle.dump(out, fh)
print("TP_REF_OK")
"""


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    """The reference's records of every case, from one subprocess of 4
    host devices started when the module starts (None without JAX)."""
    try:
        import jax  # noqa: F401
    except ImportError:
        yield None
        return
    tmp = tmp_path_factory.mktemp("tp_moe_ref")
    inp = {name: dict(_inputs(name), reduce=REDUCE) for name in CASES}
    with open(tmp / "in.pkl", "wb") as fh:
        pickle.dump(inp, fh)
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
            assert proc.returncode == 0 and "TP_REF_OK" in out, err[-4000:]
            with open(tmp / "out.pkl", "rb") as fh:
                box["out"] = pickle.load(fh)
        return box["out"]
    yield result
    if proc.poll() is None:
        proc.kill()
        proc.wait()


# ---------------------------------------------------------------- helpers --
def _np(t) -> np.ndarray:
    return t.detach().float().numpy()


def ulps(got, want) -> np.ndarray:
    """|got - want| in bf16 ulps of the largest entry of their last axis."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    m = np.maximum(np.abs(got), np.abs(want)).max(-1, keepdims=True)
    m = np.maximum(m, np.float32(2.0 ** -126))
    return np.abs(got - want) / np.exp2(np.floor(np.log2(m)) - 7)


def _caches_close(got: dict, want: dict, what: str) -> dict:
    """K/V and Mamba conv in bf16 ulps (``CACHE_ULPS``), Mamba h within
    ``H_RTOL`` of its vector's largest entry; the worst of each."""
    worst = {"ulps": 0.0, "h": 0.0}
    for pos, leaves in got.items():
        for k, t in leaves.items():
            w = np.asarray(want[pos][k], np.float32)
            if k == "h":
                scale = np.maximum(np.abs(w).max(-1, keepdims=True), 1e-30)
                r = float((np.abs(_np(t) - w) / scale).max())
                worst["h"] = max(worst["h"], r)
                assert r <= H_RTOL, (what, pos, k, r)
            else:
                u = float(ulps(_np(t), w).max())
                worst["ulps"] = max(worst["ulps"], u)
                assert u <= CACHE_ULPS, (what, pos, k, u)
    return worst


def _margin(logits: np.ndarray, vocab: int) -> np.ndarray:
    top2 = np.sort(logits[:, :vocab], -1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def _decode_logits(cfg, mesh, dec, params, caches, tok, pos, L,
                   seq) -> np.ndarray:
    """The port's gathered decode logits on copies of the caches."""
    caches = [{p: {k: t.clone() for k, t in v.items()} for p, v in c.items()}
              for c in caches]
    x, _ = TM.forward(params, cfg, tok, pos=pos, caches=caches,
                      mode="decode", cache_len=L, seq_sharded=seq, mesh=mesh)
    lg = [t[:, 0] for t in TM.lm_logits(params, cfg, x, True, mesh=mesh)]
    return _np(tstep.gather_tree(mesh.all_gather(lg, "model", dim=1),
                                 (dec.out_specs[0][0], None), mesh))


def _run_port(name, rec) -> dict:
    """The port's prefill and decode steps of the case on CPU positions
    from the reference's weights, gathered; the MoE routes of the prefill
    recorded (each position's ``moe_route`` call)."""
    c = _inputs(name)
    cfg = _cfg(name)
    mesh = tsh.ModelMesh(c["mesh"], devices="cpu")
    params = convert.lm_params_from_arrays(rec["params"], cfg, device="cpu",
                                           mesh=mesh)
    pre = tstep.make_prefill(cfg, mesh, replicate_weights=True)
    dec = tstep.make_decode_step(cfg, mesh,
                                 replicate_weights=True)
    _, c_spec, t_spec, p_spec = pre.in_specs
    caches = tstep.shard_tree(
        TM.init_cache(cfg, c["B"], c["S_max"], local=False, device="cpu"),
        c_spec, mesh, share=False)
    routes, real = [], tlayers.moe_route

    def recording(logits, cfg_, cf):
        out = real(logits, cfg_, cf)
        routes.append((logits.shape[0], out[1], out[2], out[3]))
        return out
    tlayers.moe_route = recording
    try:
        logits, caches = pre(
            params, caches, tstep.shard_tree(torch.from_numpy(c["toks"]),
                                             t_spec, mesh),
            tstep.shard_tree(torch.from_numpy(c["pos"]), p_spec, mesh))
    finally:
        tlayers.moe_route = real
    out = dict(cfg=cfg, mesh=mesh, params=params, routes=routes,
               prefill=_np(tstep.gather_tree(logits, pre.out_specs[0], mesh)),
               prefill_cache=tstep.gather_tree(caches, c_spec, mesh),
               ids=[], margins=[])
    for t, p, L in c["steps"]:
        tl = tstep.shard_tree(torch.from_numpy(t), t_spec, mesh)
        pl = tstep.shard_tree(torch.from_numpy(p), p_spec, mesh)
        out["margins"].append(_margin(_decode_logits(
            cfg, mesh, dec, params, caches, tl, pl, L, False),
            cfg.vocab_size))
        nx, caches = dec(params, caches, tl, pl, L)
        out["ids"].append(tstep.gather_tree(nx, dec.out_specs[0], mesh)
                          .numpy())
    out["cache"] = tstep.gather_tree(caches, c_spec, mesh)
    return out


@pytest.fixture(scope="module")
def port_runs(reference):
    if reference is None:
        pytest.skip("the reference (JAX) is not installed")
    ref = reference()
    return ref, {name: _run_port(name, ref[name]) for name in CASES}


def _one_card_tree(glob: dict, one, tp: int, regroup: bool) -> dict:
    """The one-card form's tree on the TP layout's global weights: the
    padded experts dropped, Mamba's ``in_proj`` regrouped if asked."""
    E = one.n_experts_padded

    def blk(b):
        core, ffn = b["core"], b["ffn"]
        if isinstance(core, tssm.MambaParams) and regroup:
            core = core._replace(in_proj=tssm.one_card_in_proj(core.in_proj,
                                                               tp))
        if isinstance(ffn, tlayers.MoEParams):
            ffn = ffn._replace(w_gate=ffn.w_gate[:, :E], w_up=ffn.w_up[:, :E],
                               w_down=ffn.w_down[:, :E])
        return {"core": core, "ffn": ffn}
    return dict(glob, sb={k: blk(v) for k, v in glob["sb"].items()})


def _mesh_prefill(cfg, mesh, glob, toks, pos, S_max):
    pre = tstep.make_prefill(cfg, mesh, replicate_weights=True)
    caches = tstep.shard_tree(TM.init_cache(cfg, toks.shape[0], S_max,
                                            local=False, device="cpu"),
                              pre.in_specs[1], mesh, share=False)
    per = tstep.shard_tree(glob, tstep.serve_param_specs(cfg), mesh)
    lg, _ = pre(per, caches, tstep.shard_tree(toks, pre.in_specs[2], mesh),
                tstep.shard_tree(pos, pre.in_specs[3], mesh))
    return tstep.gather_tree(lg, pre.out_specs[0], mesh)


def _one_prefill(one, tree, toks, pos, S_max):
    lg, _ = tstep.make_prefill(one)(
        tree, TM.init_cache(one, toks.shape[0], S_max, device="cpu"), toks,
        pos)
    return lg


# ------------------------------------------------ tests in this process --
def test_moe_tp_equals_one_card():
    """qwen2-moe's expert-parallel block (6 experts padded to 8 over 4
    positions, one shared expert) on (1, 1, 4) equals the one-card block
    on the same global weights within ``ONE_CARD_TOL``, block and prefill
    logits; position 3 (only padded experts) adds nothing routed, and the
    layout refuses a model axis that does not divide the shared width."""
    cfg = _cfg("qwen2-moe-padded")
    one = dataclasses.replace(cfg, tp=1, tp_shard=False)
    assert (cfg.n_experts_padded, one.n_experts_padded) == (8, 6)
    mesh = tsh.ModelMesh((1, 1, 4), devices="cpu")
    g = torch.Generator().manual_seed(7)
    glob = TM.init_params(cfg, g, "cpu", mesh=mesh)
    tree1 = _one_card_tree(glob, one, 4, regroup=False)
    # the block alone, on one input
    x = torch.randn(2, 12, cfg.d_model, generator=g).to(torch.bfloat16)
    ffn = TM.unstack(glob["sb"], cfg.n_sb)[0]["pos0"]["ffn"]
    specs = tstep.serve_param_specs(cfg)["sb"]["pos0"]["ffn"]
    specs = TM.tree_map(lambda s: s[1:], specs)     # one layer: unstacked
    per = tstep.shard_tree(ffn, specs, mesh)
    got = tlayers.moe_block(per, [x] * 4, cfg, tp_shard=True, mesh=mesh)
    one_ffn = TM.unstack(tree1["sb"], cfg.n_sb)[0]["pos0"]["ffn"]
    want = tlayers.moe_block(one_ffn, x, one, tp_shard=False)
    assert all(torch.equal(t, got[0]) for t in got)
    assert float((got[0].float() - want.float()).abs().max()) <= ONE_CARD_TOL
    bare = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            n_shared=0))
    pad = tlayers._moe_partial(per[3], x, bare, rank=3,
                               capacity_factor=1.25)
    assert not pad.any()
    # the whole prefill
    toks = torch.randint(0, 256, (2, 12), generator=g, dtype=torch.int32)
    pos = torch.arange(12, dtype=torch.int32)[None].expand(2, 12)
    d = float((_mesh_prefill(cfg, mesh, glob, toks, pos, 16)
               - _one_prefill(one, tree1, toks, pos, 16)).abs().max())
    assert d <= ONE_CARD_TOL, d
    with pytest.raises(ValueError, match="n_shared"):
        TM.build_tree(dataclasses.replace(cfg, tp=3),
                      tsh.ModelMesh((1, 1, 3), devices="cpu"))


def test_mamba_tp_needs_the_halves_regrouped():
    """jamba at tp 2 on (1, 1, 2) is the one-card form's function only
    with each Mamba ``in_proj`` regrouped (``ssm.one_card_in_proj``): the
    reference's per-rank halves.  Regrouped, the Mamba block and the
    prefill logits equal the one-card form within ``ONE_CARD_TOL``; as it
    stands the tree differs by more than ``HALVES_MIN``.  The block's
    states are each position's channels."""
    cfg = _cfg("jamba-seq")
    one = dataclasses.replace(cfg, tp=1, tp_shard=False)
    mesh = tsh.ModelMesh((1, 1, 2), devices="cpu")
    g = torch.Generator().manual_seed(8)
    glob = TM.init_params(cfg, g, "cpu", mesh=mesh)
    # the block alone, prefill into a state then one decode step
    core = TM.unstack(glob["sb"], cfg.n_sb)[0]["pos0"]["core"]
    specs = TM.tree_map(lambda s: s[1:],
                        tstep.serve_param_specs(cfg)["sb"]["pos0"]["core"])
    per = tstep.shard_tree(core, specs, mesh)
    x = torch.randn(2, 8, cfg.d_model, generator=g).to(torch.bfloat16)
    x1 = torch.randn(2, 1, cfg.d_model, generator=g).to(torch.bfloat16)
    B, di, ds = 2, cfg.d_inner, cfg.d_state

    def zero(n):
        return tssm.MambaState(
            conv=torch.zeros(B, cfg.d_conv - 1, di // n, dtype=torch.bfloat16),
            h=torch.zeros(B, di // n, ds))
    o, st = tssm.mamba_block(per, [x, x], cfg, state=[zero(2), zero(2)],
                             tp_shard=True, mesh=mesh)
    assert tuple(st[1].h.shape) == (B, di // 2, ds)
    o1, _ = tssm.mamba_block(per, [x1, x1], cfg, state=st, tp_shard=True,
                             mesh=mesh)
    for regroup, close in ((True, True), (False, False)):
        c1 = core._replace(in_proj=tssm.one_card_in_proj(core.in_proj, 2)) \
            if regroup else core
        w, ws = tssm.mamba_block(c1, x, one, state=zero(1), tp_shard=False)
        w1, _ = tssm.mamba_block(c1, x1, one, state=ws, tp_shard=False)
        d = max(float((o[0].float() - w.float()).abs().max()),
                float((o1[0].float() - w1.float()).abs().max()))
        assert (d <= ONE_CARD_TOL) if close else (d > HALVES_MIN), (regroup,
                                                                     d)
        if close:       # rank r's states are channels r of the one card's
            h_mesh = torch.cat([s_.h for s_ in st], 1)
            assert float((h_mesh - ws.h).abs().max()) <= ONE_CARD_TOL
    # the whole prefill (7 Mamba layers, 4 MoE layers)
    toks = torch.randint(0, 256, (2, 14), generator=g, dtype=torch.int32)
    pos = torch.arange(14, dtype=torch.int32)[None].expand(2, 14)
    lg = _mesh_prefill(cfg, mesh, glob, toks, pos, 32)
    for regroup, close in ((True, True), (False, False)):
        d = float((lg - _one_prefill(one, _one_card_tree(glob, one, 2,
                                                         regroup),
                                     toks, pos, 32)).abs().max())
        assert (d <= ONE_CARD_TOL) if close else (d > HALVES_MIN), (regroup,
                                                                     d)
    with pytest.raises(NotImplementedError, match="item 14d"):
        tssm.mamba_block(core, x, cfg, state=None, tp_shard=True)


# ----------------------------- tests against the reference subprocess --
@pytest.mark.parametrize("name", list(CASES))
def test_prefill_matches_reference(port_runs, name):
    ref, runs = port_runs
    got, want = runs[name], ref[name]
    cfg = got["cfg"]
    assert got["prefill"].shape == (CASES[name][4], cfg.vocab_padded)
    d = np.abs(got["prefill"] - np.asarray(want["prefill"], np.float32))
    assert d.max() <= LOGIT_TOL, d.max()
    _caches_close(got["prefill_cache"], want["prefill_cache"],
                  f"{name} prefill")
    # every position routes all of its tokens: T the local batch's
    T = CASES[name][4] * CASES[name][5] // got["mesh"].axis_size("data")
    assert got["routes"] and all(r[0] == T for r in got["routes"])


@pytest.mark.parametrize("name", list(CASES))
def test_decode_matches_reference(port_runs, name):
    ref, runs = port_runs
    got, want = runs[name], ref[name]
    for ids, jids, margin in zip(got["ids"], want["ids"], got["margins"],
                                 strict=True):
        assert ids.dtype == np.int32
        sure = margin > 2 * LOGIT_TOL
        np.testing.assert_array_equal(ids[sure], np.asarray(jids)[sure])
    _caches_close(got["cache"], want["cache"], f"{name} decode")


def test_capacity_counts_the_data_shard(port_runs):
    """granite on (1, 2, 2): each position's C counts its data shard's 24
    tokens (C = 7), not the global 48 (C = 15), and row 0's repeated token
    sends assignments past C that the global count would keep; the prefill
    logits above equal the reference's all the same."""
    _, runs = port_runs
    got = runs["granite-data"]
    cfg = got["cfg"]
    k, E = cfg.moe.top_k, cfg.moe.n_experts
    T = 2 * CASES["granite-data"][5]
    assert {r[3] for r in got["routes"]} == {max(int(T * k * 1.25 / E), 4)}
    C_global = max(int(2 * T * k * 1.25 / E), 4)
    dropped = sum(int((r[2] >= r[3]).sum()) for r in got["routes"])
    kept_globally = sum(int(((r[2] >= r[3]) & (r[2] < C_global)).sum())
                        for r in got["routes"])
    assert dropped > 0 and kept_globally > 0, (dropped, kept_globally)


def test_seq_sharded_decode_matches_reference(port_runs):
    """jamba's sequence-sharded decode on (1, 2, 2) from the prefill's
    caches: the K/V time axis in chunks of 16, the Mamba states replicated
    over ``data`` (each data position steps its own copy); the first two
    steps leave chunk 1 empty, the third writes across the boundary; ids
    and every cache after each step against the reference, and the
    replicas' Mamba states equal."""
    ref, runs = port_runs
    name = "jamba-seq"
    got, want = runs[name], ref[name]
    c = _inputs(name)
    cfg = got["cfg"]
    mesh = tsh.ModelMesh(c["seq"], devices="cpu")
    dec = tstep.make_decode_step(cfg, mesh, batch_sharded=False,
                                 seq_shard=True, replicate_weights=True)
    params = convert.lm_params_from_arrays(want["params"], cfg, device="cpu",
                                           mesh=mesh)
    _, c_spec, t_spec, p_spec, _ = dec.in_specs
    assert c_spec["pos0"] == {"conv": (None, None, None, "model"),
                              "h": (None, None, "model", None)}
    # a position's cache: its time chunk of K/V, its channels of the states
    a = f"pos{cfg.pattern.index('attn')}"
    shapes = TM.cache_shapes(cfg, 1, c["S_max"], seq_shard=2)
    assert shapes[a]["k"][0][2] == c["S_max"] // 2
    assert shapes["pos0"]["h"][0] == (cfg.n_sb, 1, cfg.d_inner // 2,
                                      cfg.d_state)
    caches = convert.lm_caches_from_arrays(
        want["prefill_cache"], cfg, device="cpu", mesh=mesh,
        batch_sharded=False, seq_shard=True)
    S_l = c["S_max"] // mesh.axis_size("data")
    owners = []
    for i, (t, p, L) in enumerate(c["steps"]):
        tl = tstep.shard_tree(torch.from_numpy(t), t_spec, mesh)
        pl = tstep.shard_tree(torch.from_numpy(p), p_spec, mesh)
        margin = _margin(_decode_logits(cfg, mesh, dec, params, caches, tl,
                                        pl, L, True), cfg.vocab_size)
        nx, caches = dec(params, caches, tl, pl, L)
        ids = tstep.gather_tree(nx, dec.out_specs[0], mesh).numpy()
        sure = margin > 2 * LOGIT_TOL
        np.testing.assert_array_equal(ids[sure],
                                      np.asarray(want["seq_ids"][i])[sure])
        _caches_close(tstep.gather_tree(caches, c_spec, mesh),
                      want["seq_caches"][i], f"{name} seq step {i}")
        for r in range(mesh.size):
            twin = mesh.position(data=1 - mesh.axis_index("data", r),
                                 model=mesh.axis_index("model", r))
            assert torch.equal(caches[r]["pos0"]["h"],
                               caches[twin]["pos0"]["h"])
        owners.append(L // S_l)
    assert owners == [0, 0, 1, 1]
