"""Tensor-parallel and sequence-sharded serving on the port (ROADMAP item
14d: ``models.sharding.ModelMesh``, ``serve.step.make_prefill(cfg,
mesh)`` / ``make_decode_step(cfg, mesh, ...)``, ``shard_tree`` /
``gather_tree``, K8's ``return_partial`` form and ``flash_merge``) held
against the reference's ``shard_map`` steps on the CPU.

The reference runs in ONE subprocess of 4 host devices, started when this
module starts and read by the tests that need it: per case it draws its
weights (``init_params``, norm scales and biases randomised as in
``test_torch_lm.py``), runs ``make_prefill`` and ``make_decode_step``
compiled with ``xla_allow_excess_precision`` off (the bf16 roundings the
code writes), and pickles the global weights, logits, ids and caches.  The
port carries the weights across (``convert.lm_params_from_arrays(...,
mesh=)``), runs its steps on a mesh of CPU positions from the same inputs
(decode teacher-forced with the same ids) and gathers the results
(``gather_tree``).  Cases, all ``reduce_cfg`` cuts with ``tp_shard`` on,
``vocab=256``:

* qwen3-4b with 2 KV heads at tp 2 (KV heads sharded) on (1, 2, 2): the
  batch over ``data``, the heads over ``model``;
* qwen3-4b with 1 KV head at tp 2 (the replicated-KV slice) on (1, 1, 2),
  then sequence-sharded decode on (1, 2, 2) from its prefill's caches: the
  cache's 32 positions in chunks of 16, the prompt 14 long, four steps
  (chunk 1 empty for the first two, the write crossing into chunk 1 on the
  third); the same with 2 KV heads;
* qwen3-4b with 6 query and 2 KV heads at tp 4 on (1, 1, 4): 8 padded
  query heads, the replicated-KV slice ``g`` computed over the padded
  count (``n_heads_padded``), a psum over four positions;
* command-r-plus (parallel block: attention and MLP partials share one
  psum), musicgen-large (frame-embedding inputs, no token table) and
  qwen2-vl-72b (M-RoPE ids, at head dim 32 with sections (4, 6, 6) so
  that the h and w sections act) at tp 2 on (1, 1, 2).

Tolerances, measured on these inputs (largest value seen in brackets):
prefill logits within ``LOGIT_TOL`` = 0.04 of the reference's (0.0124,
qwen3-kv1's second batch row; every other case within 4.8e-7, the model-4
case included: XLA's dots sum bf16 products in another order than the
port's, which here flips one bf16 rounding of one cache entry), caches
within ``CACHE_ULPS`` = 8 bf16 ulps of their head vector's largest entry
(1.0), decode ids equal wherever the port's top-2 margin exceeds twice
``LOGIT_TOL`` (every id equal); the mesh program's prefill logits within
``ONE_CARD_TOL`` = 1e-5 of the port's one-device prefill of the same
weights, where the layout computes that function (0.0: the positions'
psum of f32 partials rounds as the one product here).  K8's
``return_partial`` against the reference's ``layers.flash_attention(...,
return_partial=True)`` at negative, in-chunk and past-chunk offsets: each
of m, l and acc within ``PART_TOL`` = 2e-6 of its scale (the same
blockwise algorithm: f32 summation order only).

On a card (``gpu`` marker, skipped here): the return_partial tile and the
combine across positions against their plain versions and an f64 oracle,
the empty chunk and a negative ``q_offset`` included, with their launch
counters.  The reference is imported inside the fixtures, so ``pytest -m
gpu`` runs this file where JAX is absent.
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
from repro_torch.configs.base import SHAPES
from repro_torch.configs.reduced import reduce_cfg
from repro_torch.kernels import flash as tflash
from repro_torch.launch.mesh import make_mesh_for, make_production_mesh
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models import layers as tlayers
from repro_torch.models import model as TM
from repro_torch.models import sharding as tsh
from repro_torch.serve import step as tstep

LOGIT_TOL = 0.04
ONE_CARD_TOL = 1e-5
CACHE_ULPS = 8
PART_TOL = 2e-6
REDUCE = dict(n_layers=2, d_model=64, vocab=256)

# name: (arch, config overrides, mesh of prefill and decode, batch, prompt,
#        S_max, mesh of the sequence-sharded decode or None)
CASES = {
    "qwen3-kv2": ("qwen3-4b", dict(tp=2, n_kv_heads=2), (1, 2, 2), 4, 12,
                  16, None),
    "qwen3-kv1-seq": ("qwen3-4b", dict(tp=2, n_kv_heads=1), (1, 1, 2), 2,
                      14, 32, (1, 2, 2)),
    "qwen3-kv2-seq": ("qwen3-4b", dict(tp=2, n_kv_heads=2), (1, 1, 2), 2,
                      14, 32, (1, 2, 2)),
    "qwen3-padded": ("qwen3-4b", dict(tp=4, n_heads=6, n_kv_heads=2),
                     (1, 1, 4), 2, 12, 16, None),
    "command-r": ("command-r-plus-104b", dict(tp=2), (1, 1, 2), 2, 12, 16,
                  None),
    "musicgen": ("musicgen-large", dict(tp=2), (1, 1, 2), 2, 12, 16, None),
    "qwen2-vl": ("qwen2-vl-72b", dict(tp=2, head_dim=32,
                                      mrope_sections=(4, 6, 6)),
                 (1, 1, 2), 2, 12, 16, None),
}
STEPS = 4
# the layouts that compute their one-card form's function (KV heads
# sharded, or one KV head for all; nothing padded)
ONE_CARD = ("qwen3-kv2", "qwen3-kv1-seq", "qwen3-kv2-seq", "command-r",
            "musicgen", "qwen2-vl")


def _cfg(name):
    arch, over, *_ = CASES[name]
    return dataclasses.replace(reduce_cfg(get_arch(arch), **REDUCE),
                               tp_shard=True, **over)


def _inputs(name) -> dict:
    """The case's prompt and teacher-forced decode inputs, numpy."""
    arch, over, mesh, B, S, S_max, seq = CASES[name]
    cfg = _cfg(name)
    rng = np.random.default_rng(sum(map(ord, name)))
    if cfg.embed_input:
        toks = rng.normal(0, 1, (B, S, cfg.d_model)).astype(np.float32)
        steps_in = [rng.normal(0, 1, (B, 1, cfg.d_model)).astype(np.float32)
                    for _ in range(STEPS)]
    else:
        toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        steps_in = [rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
                    for _ in range(STEPS)]
    ar = np.arange(S, dtype=np.int32)
    if cfg.rope == "mrope":       # distinct t, h and w ids
        pos = np.stack([ar, ar // 2, ar % 5])[:, None, :].repeat(B, 1)
        step_pos = [np.full((3, B, 1), S + i, np.int32)
                    for i in range(STEPS)]
    else:
        pos = np.broadcast_to(ar[None], (B, S)).copy()
        step_pos = [np.full((B, 1), S + i, np.int32) for i in range(STEPS)]
    return dict(arch=arch, over=dict(over, tp_shard=True), mesh=mesh, B=B,
                S=S, S_max=S_max, seq=seq, toks=toks, pos=pos.astype(np.int32),
                steps=[(t, p, S + i) for i, (t, p) in
                       enumerate(zip(steps_in, step_pos, strict=True))],
                embed=cfg.embed_input)


_REF_SCRIPT = r"""
import os, pickle, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp, ml_dtypes
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


def data(a, embed):
    return jnp.asarray(a.astype(ml_dtypes.bfloat16)) if embed \
        else jnp.asarray(a)


with open(%(inp)r, "rb") as fh:
    cases = pickle.load(fh)
out = {}
for name, c in cases.items():
    jc = dataclasses.replace(reduce_cfg(get_arch(c["arch"]), **c["reduce"]),
                             **c["over"])
    jp = JM.init_params(jc, jax.random.PRNGKey(3))
    tree = randomize(export(jp), np.random.default_rng(4))
    jp = to_jax(tree, jp)
    m = mesh(c["mesh"])
    pre = compiled(JS.make_prefill(jc, m)[0])
    caches = JM.init_cache(jc, c["B"], c["S_max"], local=False)
    logits, caches = pre(jp, caches, data(c["toks"], c["embed"]),
                         jnp.asarray(c["pos"]))
    rec = dict(params=tree, prefill=np.array(logits),
               prefill_cache=export(caches))
    dec = compiled(JS.make_decode_step(jc, m)[0])
    ids = []
    for t, p, L in c["steps"]:
        nx, caches = dec(jp, caches, data(t, c["embed"]), jnp.asarray(p),
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
            nx, caches = sdec(jp, caches, data(t, c["embed"]),
                              jnp.asarray(p), jnp.asarray(L, jnp.int32))
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
    tmp = tmp_path_factory.mktemp("tp_ref")
    inp = {}
    for name in CASES:
        c = _inputs(name)
        inp[name] = dict(c, reduce=REDUCE)
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
def _t(a) -> torch.Tensor:
    """A numpy array as a CPU tensor; ml_dtypes bf16 through its words."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bf16_in(a, embed) -> torch.Tensor:
    if not embed:
        return torch.from_numpy(a)
    import ml_dtypes
    return _t(a.astype(ml_dtypes.bfloat16))


def _np(t) -> np.ndarray:
    return t.detach().float().numpy()


def ulps(got, want) -> np.ndarray:
    """|got - want| in bf16 ulps of the largest entry of their last axis."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    m = np.maximum(np.abs(got), np.abs(want)).max(-1, keepdims=True)
    m = np.maximum(m, np.float32(2.0 ** -126))
    return np.abs(got - want) / np.exp2(np.floor(np.log2(m)) - 7)


def _caches_close(got: dict, want: dict, what: str) -> float:
    worst = 0.0
    for pos, leaves in got.items():
        for k, t in leaves.items():
            u = ulps(_np(t), np.asarray(want[pos][k], np.float32)).max()
            worst = max(worst, float(u))
            assert u <= CACHE_ULPS, (what, pos, k, u)
    return worst


def _margin(logits: np.ndarray, vocab: int) -> np.ndarray:
    top2 = np.sort(logits[:, :vocab], -1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def _decode_logits(cfg, mesh, dec, params, caches, tok, pos, L,
                   seq) -> np.ndarray:
    """The port's gathered decode logits on copies of the caches (the
    margins the ids are held by)."""
    caches = [{p: {k: t.clone() for k, t in v.items()} for p, v in c.items()}
              for c in caches]
    x, _ = TM.forward(params, cfg, tok, pos=pos, caches=caches,
                      mode="decode", cache_len=L, seq_sharded=seq, mesh=mesh)
    lg = [t[:, 0] for t in TM.lm_logits(params, cfg, x, True, mesh=mesh)]
    return _np(tstep.gather_tree(mesh.all_gather(lg, "model", dim=1),
                                 (dec.out_specs[0][0], None), mesh))


def _run_port(name, rec) -> dict:
    """The port's prefill and decode steps of the case on CPU positions
    from the reference's weights, gathered."""
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
    logits, caches = pre(
        params, caches,
        tstep.shard_tree(_bf16_in(c["toks"], c["embed"]), t_spec, mesh),
        tstep.shard_tree(torch.from_numpy(c["pos"]), p_spec, mesh))
    out = dict(cfg=cfg, mesh=mesh, params=params,
               prefill=_np(tstep.gather_tree(logits, pre.out_specs[0], mesh)),
               prefill_cache=tstep.gather_tree(caches, c_spec, mesh),
               ids=[], margins=[])
    for t, p, L in c["steps"]:
        tl = tstep.shard_tree(_bf16_in(t, c["embed"]), t_spec, mesh)
        pl = tstep.shard_tree(torch.from_numpy(p), p_spec, mesh)
        out["margins"].append(_margin(_decode_logits(
            cfg, mesh, dec, params, caches, tl, pl, L, False),
            cfg.vocab_size))
        nx, caches = dec(params, caches, tl, pl, L)
        out["ids"].append(tstep.gather_tree(nx, dec.out_specs[0], mesh)
                          .numpy())
    out["cache"] = tstep.gather_tree(caches, c_spec, mesh)
    if name in ONE_CARD:
        one = dataclasses.replace(cfg, tp=1, tp_shard=False)
        logits, _ = tstep.make_prefill(one)(
            convert.lm_params_from_arrays(rec["params"], one, device="cpu"),
            TM.init_cache(one, c["B"], c["S_max"], device="cpu"),
            _bf16_in(c["toks"], c["embed"]), torch.from_numpy(c["pos"]))
        out["one_card"] = _np(logits)
    return out


@pytest.fixture(scope="module")
def port_runs(reference):
    if reference is None:
        pytest.skip("the reference (JAX) is not installed")
    ref = reference()
    return ref, {name: _run_port(name, ref[name]) for name in CASES}


# ------------------------------------------------ tests in this process --
def test_partial_matches_reference():
    """``flash_attention(return_partial=True)`` against the reference's at
    a negative offset (a chunk past the query: no key, m = -1e30, l = 0,
    acc = 0), inside the chunk and past it (every key seen), decode and
    prefill shapes, GQA groups 1 and 2."""
    pytest.importorskip("jax")
    from repro.models import layers as jlayers
    import jax.numpy as jnp
    rng = np.random.default_rng(11)
    for B, Sq, Skv, H, Hkv, off in ((1, 1, 48, 2, 1, -5), (1, 1, 48, 2, 1, 20),
                                    (2, 1, 48, 4, 2, 60), (1, 3, 40, 2, 2, 7),
                                    (2, 2, 130, 4, 2, 129)):
        q, k, v = (rng.normal(0, 1, (B, s, h, 16)).astype(np.float32)
                   for s, h in ((Sq, H), (Skv, Hkv), (Skv, Hkv)))
        got = tlayers.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                      q_offset=off, return_partial=True)
        want = jlayers.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v),
                                       q_offset=jnp.asarray(off, jnp.int32),
                                       return_partial=True)
        for g, w in zip(got, want, strict=True):
            w = np.asarray(w)
            assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
            # the scale of the entries (m's -1e30 floor must be equal)
            scale = max(1.0, float(np.abs(w[np.abs(w) < 1e29]).max(
                initial=0.0)))
            assert np.abs(_np(g) - w).max() <= PART_TOL * scale, (off, g.shape)
        if off < 0:
            assert (got[0] == -1e30).all() and not got[1].any() and \
                not got[2].any()
    with pytest.raises(ValueError, match="bias_qk"):
        tlayers.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                q_offset=0, return_partial=True,
                                bias_qk=(torch.zeros(B, Sq, H),
                                         torch.zeros(B, Skv, H)))


def test_merge_plain_is_the_combined_softmax():
    """Four positions' partials of one attention (chunks of the keys, one
    empty) merged by ``flash_merge`` (the plain version on the CPU) equal
    the attention over all keys within one bf16 ulp of the magnitude."""
    g = torch.Generator().manual_seed(2)
    B, Sq, H, Hkv, dh, S_l = 2, 1, 4, 2, 64, 32
    q = torch.randn(B, Sq, H, dh, generator=g).to(torch.bfloat16)
    k = torch.randn(B, 4 * S_l, Hkv, dh, generator=g).to(torch.bfloat16)
    v = torch.randn(B, 4 * S_l, Hkv, dh, generator=g).to(torch.bfloat16)
    L = 2 * S_l + 5                      # chunk 3 empty, chunk 2 the owner's
    parts = [tflash.flash_attention(q, k[:, i * S_l:(i + 1) * S_l],
                                    v[:, i * S_l:(i + 1) * S_l],
                                    q_offset=L - i * S_l, return_partial=True)
             for i in range(4)]
    assert (parts[3][0] == -1e30).all() and not parts[3][1].any()
    m, l, acc = (torch.stack([p[j] for p in parts], 2) for j in range(3))
    got = tflash.flash_merge(m, l, acc)
    want = tflash.flash_attention_plain(q, k, v, q_offset=L)
    mag = tflash.flash_attention_plain(q.float(), k.float(), v.float().abs(),
                                       q_offset=L)
    ulp = torch.exp2(torch.floor(torch.log2(mag.abs().clamp_min(2**-126)))
                     - 7)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert ((got.float() - want.float()).abs() <= ulp).all()
    with pytest.raises(ValueError, match="flash_merge"):
        tflash.flash_merge(m, l[:, :, :2], acc)


def test_shard_and_gather_round_trip():
    """``shard_tree`` then ``gather_tree`` gives the global tree back bit
    for bit on every mesh of the tests, for the weights (positions of one
    device share a shard) and the caches (a copy a position); each
    position's shard is the slice its axis indices name."""
    cfg = _cfg("qwen3-padded")
    for shape in ((1, 1, 4), (1, 2, 2), (2, 1, 2)):
        mesh = tsh.ModelMesh(shape, devices="cpu")
        tcfg = dataclasses.replace(cfg, tp=shape[2])
        g = torch.Generator().manual_seed(0)
        glob = TM.init_params(tcfg, g, "cpu", mesh=mesh)
        specs = tstep.serve_param_specs(tcfg)
        per = tstep.shard_tree(glob, specs, mesh)
        back = tstep.gather_tree(per, specs, mesh)
        TM.tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0,
                                                            atol=0),
                    glob, back)
        wq = glob["sb"]["pos0"]["core"].wq
        n = shape[2]
        for r in range(mesh.size):
            m = mesh.axis_index("model", r)
            k = wq.shape[-1] // n
            assert torch.equal(per[r]["sb"]["pos0"]["core"].wq,
                               wq[..., m * k:(m + 1) * k])
        # the data replicas of one model shard are one tensor
        same = mesh.position(data=1 % shape[1], model=0)
        assert per[same]["lm_head"] is per[0]["lm_head"]
        cache = TM.init_cache(tcfg, 2 * shape[0] * shape[1], 16, local=False,
                              device="cpu")
        cache = TM.tree_map(lambda t: t.normal_(generator=g), cache)
        cs = tstep._cache_specs(tcfg, mesh, batch_sharded=True,
                                seq_shard=False)
        cper = tstep.shard_tree(cache, cs, mesh, share=False)
        assert cper[0]["pos0"]["k"].shape[3] == 1       # one KV slot a rank
        assert cper[0]["pos0"]["k"] is not cper[1]["pos0"]["k"]
        TM.tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0,
                                                            atol=0),
                    cache, tstep.gather_tree(cper, cs, mesh))


def test_mesh_rules_and_collectives():
    """Mesh factories and axis arithmetic; the collectives' sums in
    position order and their byte counts; the layouts the port refuses."""
    assert make_smoke_mesh(devices="cpu").size == 1
    prod = make_production_mesh(devices="cpu")
    assert prod.shape == (16, 16) and prod.axis_names == ("data", "model")
    assert tsh.batch_axes_for(prod) == ("data",)
    assert make_production_mesh(multi_pod=True, devices="cpu").size == 512
    assert make_mesh_for(24, devices="cpu").shape == (1, 2, 12)
    assert make_mesh_for(64, devices="cpu").shape == (1, 4, 16)
    assert make_mesh_for(512, devices="cpu").shape == (2, 16, 16)
    mesh = tsh.ModelMesh((1, 2, 4), devices="cpu")
    assert mesh.coords(6) == {"pod": 0, "data": 1, "model": 2}
    assert mesh.position(data=1, model=2) == 6
    assert mesh.groups("model") == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert mesh.groups("data") == [[0, 4], [1, 5], [2, 6], [3, 7]]
    xs = [torch.full((3,), float(r)) for r in range(8)]
    tsh.reset_collectives()
    s = mesh.tp_psum(xs)
    assert s[0].tolist() == [6.0] * 3 and s[5].tolist() == [22.0] * 3
    assert tsh.COLLECTIVES["tp_psum"] == {"calls": 2, "bytes": 2 * 2 * 3 * 12}
    ag = mesh.all_gather(xs, "model", dim=0)
    assert ag[4].tolist() == sum(([float(r)] * 3 for r in range(4, 8)), [])
    assert tsh.COLLECTIVES["all_gather"]["bytes"] == 2 * 4 * 3 * 12
    st = mesh.gather_stack(xs, "data", dim=0)
    assert tuple(st[2].shape) == (2, 3) and st[2][1, 0] == 6.0
    with pytest.raises(ValueError, match="devices"):
        tsh.ModelMesh((1, 2, 2), devices=("cpu",) * 3)
    # the reference's decode cells: decode_32k batch-sharded, long_500k
    # (batch 1) sequence-sharded; global cache shapes (tp one-slot ranks)
    cfg = _cfg("qwen3-kv1-seq")
    mesh = tsh.ModelMesh((1, 2, 2), devices="cpu")
    long = tstep.serve_shapes(cfg, SHAPES["long_500k"], mesh)
    assert long["seq_shard"] and not long["batch_sharded"]
    assert long["caches"]["pos0"]["k"] == ((cfg.n_sb, 1, 524288, 2, 16),
                                           torch.bfloat16)
    assert long["tokens"] == ((1, 1), torch.int32)
    assert tstep.serve_shapes(cfg, SHAPES["decode_32k"], mesh)[
        "batch_sharded"]
    assert tstep._cache_specs(cfg, mesh, batch_sharded=False,
                              seq_shard=True)["pos0"]["k"] == (
        None, None, "data", "model", None)
    with pytest.raises(ValueError, match="batch_sharded=False"):
        tstep.make_decode_step(cfg, mesh, seq_shard=True)
    # MoE and Mamba build under tp_shard (test_torch_tp_moe_mamba.py runs
    # them); the xLSTM blocks, which the reference replicates, do not
    for arch in ("jamba-v0.1-52b", "qwen2-moe-a2.7b", "granite-moe-1b-a400m"):
        cfg = dataclasses.replace(reduce_cfg(get_arch(arch), **REDUCE),
                                  tp=2, tp_shard=True)
        assert TM.build_tree(cfg, tsh.ModelMesh((1, 1, 2), devices="cpu"))
    cfg = dataclasses.replace(reduce_cfg(get_arch("xlstm-125m"), **REDUCE),
                              tp=2, tp_shard=True)
    with pytest.raises(NotImplementedError, match="item 14d"):
        TM.build_tree(cfg, tsh.ModelMesh((1, 1, 2), devices="cpu"))
    cfg = _cfg("qwen3-kv2")
    with pytest.raises(NotImplementedError, match="14d.*|single_card"):
        TM.build_tree(cfg)
    with pytest.raises(ValueError, match="does not divide"):
        TM.build_tree(cfg, tsh.ModelMesh((1, 1, 3), devices="cpu"))
    # training runs on a mesh (test_torch_train_mesh.py); without one a
    # tensor-parallel loss is refused as the layers are
    with pytest.raises(ValueError, match="no caches"):
        TM.forward([{}], cfg, [torch.zeros(1, 2, dtype=torch.int32)],
                   pos=[torch.zeros(1, 2, dtype=torch.int32)], mode="train",
                   caches=[{}], mesh=tsh.ModelMesh((1, 1, 2), devices="cpu"))
    with pytest.raises(NotImplementedError, match="single_card"):
        TM.lm_loss({}, cfg, torch.zeros(1, 2, 64), torch.zeros(1, 2), True)


def test_tp16_layout_is_single_card_gqa():
    """qwen3-4b's published layout (tp 16, KV heads replicated) on a
    16-wide model axis computes the one-card form's function: at reduced
    width with 32 query and 8 KV heads, TP-16 prefill logits on 16 CPU
    positions equal the one-card form's on the same global weights within
    ``LOGIT_TOL`` (sums over 16 positions against one product), and the
    greedy decode ids agree."""
    base = reduce_cfg(get_arch("qwen3-4b"), n_layers=2, d_model=64,
                      vocab=256)
    cfg = dataclasses.replace(base, n_heads=32, n_kv_heads=8, tp=16,
                              tp_shard=True, head_dim=16)
    one = dataclasses.replace(cfg, tp=1, tp_shard=False)
    mesh = tsh.ModelMesh((1, 1, 16), devices="cpu")
    assert cfg.n_heads_padded == 32 and not cfg.kv_sharded
    g = torch.Generator().manual_seed(5)
    glob = TM.init_params(one, g, "cpu")
    per = tstep.shard_tree(glob, tstep.serve_param_specs(cfg), mesh)
    B, S = 2, 10
    toks = torch.randint(0, 256, (B, S), generator=g, dtype=torch.int32)
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    pre = tstep.make_prefill(cfg, mesh, replicate_weights=True)
    caches = tstep.shard_tree(TM.init_cache(cfg, B, 16, local=False,
                                            device="cpu"),
                              pre.in_specs[1], mesh, share=False)
    lg, caches = pre(per, caches, tstep.shard_tree(toks, pre.in_specs[2],
                                                   mesh),
                     tstep.shard_tree(pos, pre.in_specs[3], mesh))
    lg = tstep.gather_tree(lg, pre.out_specs[0], mesh)
    want, _ = tstep.make_prefill(one)(glob, TM.init_cache(one, B, 16,
                                                          device="cpu"),
                                      toks, pos)
    assert float((lg - want).abs().max()) <= 1e-4
    cache_k = tstep.gather_tree(caches, pre.in_specs[1], mesh)["pos0"]["k"]
    assert cache_k.shape[3] == 16       # one slot a rank: KV head r // 2


# ----------------------------- tests against the reference subprocess --
@pytest.mark.parametrize("name", list(CASES))
def test_prefill_matches_reference(port_runs, name):
    ref, runs = port_runs
    got, want = runs[name], ref[name]
    cfg = got["cfg"]
    assert got["prefill"].shape == (CASES[name][3], cfg.vocab_padded)
    d = np.abs(got["prefill"] - np.asarray(want["prefill"], np.float32))
    assert d.max() <= LOGIT_TOL, d.max()
    _caches_close(got["prefill_cache"], want["prefill_cache"],
                  f"{name} prefill")


@pytest.mark.parametrize("name", ONE_CARD)
def test_prefill_equals_one_card_form(port_runs, name):
    """Where the layout is its one-card form's function, the mesh program's
    prefill logits equal the port's one-device prefill on the same global
    weights within ``ONE_CARD_TOL``: the psum of the positions' f32
    partials against one product."""
    _, runs = port_runs
    d = np.abs(runs[name]["prefill"] - runs[name]["one_card"]).max()
    assert d <= ONE_CARD_TOL, d


@pytest.mark.parametrize("name", list(CASES))
def test_decode_matches_reference(port_runs, name):
    ref, runs = port_runs
    got, want = runs[name], ref[name]
    tol = LOGIT_TOL
    for ids, jids, margin in zip(got["ids"], want["ids"], got["margins"],
                                 strict=True):
        assert ids.dtype == np.int32
        sure = margin > 2 * tol
        np.testing.assert_array_equal(ids[sure], np.asarray(jids)[sure])
    _caches_close(got["cache"], want["cache"], f"{name} decode")


@pytest.mark.parametrize("name", [n for n in CASES if CASES[n][6]])
def test_seq_sharded_decode_matches_reference(port_runs, name):
    """Sequence-sharded decode on (1, 2, 2) from the prefill's caches: the
    first two steps leave chunk 1 empty (its partial m = -1e30, l = 0),
    the third writes across the boundary into chunk 1; ids, and every
    chunk of the caches after each step, against the reference."""
    ref, runs = port_runs
    got, want = runs[name], ref[name]
    c = _inputs(name)
    cfg = got["cfg"]
    mesh = tsh.ModelMesh(c["seq"], devices="cpu")
    dec = tstep.make_decode_step(cfg, mesh, batch_sharded=False,
                                 seq_shard=True, replicate_weights=True)
    params = convert.lm_params_from_arrays(want["params"], cfg, device="cpu",
                                           mesh=mesh)
    _, c_spec, t_spec, p_spec, _ = dec.in_specs
    caches = convert.lm_caches_from_arrays(
        want["prefill_cache"], cfg, device="cpu", mesh=mesh,
        batch_sharded=False, seq_shard=True)
    S_l = c["S_max"] // mesh.axis_size("data")
    owners = []
    for i, (t, p, L) in enumerate(c["steps"]):
        tl = tstep.shard_tree(_bf16_in(t, c["embed"]), t_spec, mesh)
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
        owners.append(L // S_l)
    assert owners == [0, 0, 1, 1]


# ------------------------------------------------------------- on a card --
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("off", [-3, 0, 100, 4000, 8191, 9000])
def test_cuda_partial_matches_plain(off):
    """The return_partial tile (split-KV runs, then the run combine without
    the division) at path M's per-position decode shape (1 query, 2 heads
    over 1 KV slot, dh 128, a chunk of 8,192 keys) against its plain
    version: m to 1e-5, l and acc within 1e-5 of their scale; an empty
    chunk (negative offset) gives m = -1e30, l = 0, acc = 0."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn(1, 1, 2, 128, device=dev, generator=g).to(torch.bfloat16)
    k = torch.randn(1, 8192, 1, 128, device=dev, generator=g).to(
        torch.bfloat16)
    v = torch.randn(1, 8192, 1, 128, device=dev, generator=g).to(
        torch.bfloat16)
    tflash.reset_launches()
    got = tflash.flash_attention(q, k, v, q_offset=off, return_partial=True)
    assert tflash.LAUNCHES["flash_partial"] == 1
    n_split, _ = tflash.decode_plan(q, k, q_offset=off, kv_valid=8192)
    want = tflash.flash_decode_split_plain(q, k, v, q_offset=off,
                                           n_split=n_split,
                                           return_partial=True)
    for a, b in zip(got, want, strict=True):
        scale = float(b.abs().max().clamp_min(1.0))
        assert float((a - b).abs().max()) <= 1e-5 * scale
    if off < 0:
        assert bool((got[0] == -1e30).all()) and not bool(got[1].any())


@pytest.mark.gpu
@pytest.mark.parametrize("D", [1, 4])
def test_cuda_merge_matches_plain(D):
    """The combine across positions against its plain version and an f64
    merge, within one bf16 ulp of the magnitude, with an empty position
    among the D."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(2)
    B, H, Sq, dh = 4, 2, 1, 128
    m = torch.randn(B, H, D, Sq, device=dev, generator=g) * 3
    l = torch.rand(B, H, D, Sq, device=dev, generator=g) * 50 + 1
    acc = torch.randn(B, H, D, Sq, dh, device=dev, generator=g) * 10
    if D > 1:
        m[:, :, -1], l[:, :, -1], acc[:, :, -1] = -1e30, 0.0, 0.0
    tflash.reset_launches()
    got = tflash.flash_merge(m, l, acc)
    assert tflash.LAUNCHES["flash_merge"] == 1
    want = tflash.flash_merge_plain(m, l, acc)
    w = torch.exp(m.double() - m.double().amax(2, keepdim=True))
    f64 = ((acc.double() * w[..., None]).sum(2)
           / (l.double() * w).sum(2)[..., None]).transpose(1, 2)
    mag = ((acc.double().abs() * w[..., None]).sum(2)
           / (l.double() * w).sum(2)[..., None]).transpose(1, 2)
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(2**-126))) - 7)
    assert bool(((got.double() - want.double()).abs() <= ulp).all())
    assert bool(((got.double() - f64).abs() <= ulp).all())
