"""The LM serving slice of the port (configs, layers, decoder, serving
steps, paged KV cache, serving entry point) held against the reference on
qwen3-4b cut to ``reduce_cfg(get_arch("qwen3-4b"), n_layers=2, d_model=64,
vocab=256)``, with the reference's weights carried across bit for bit
(``convert.lm_params_from_arrays``) and every norm scale and bias drawn at
random first, so that no multiplication by one hides an order of rounding.

Tolerances, each measured on this configuration (largest value seen in
brackets):

* Single layers against the reference run op by op: bf16 outputs within
  one bf16 ulp of each entry (0: equal), f32 outputs within 2e-6 of their
  scale (the projections sum bf16 products in f32 in another order).
* The whole slice against the reference's jitted serving steps
  (``make_prefill`` / ``make_decode_step`` on the smoke mesh): logits
  within ``LOGIT_TOL`` = 0.08 (0.038 prefill, 0.048 over three decode
  steps, for logits up to 3.4 in magnitude), cache entries within
  ``CACHE_ULPS`` = 8 bf16 ulps of the largest entry of their head's
  vector (4.6).  XLA
  compiles the steps with excess precision allowed (its default), so
  inside the jit it skips roundings to bf16 that the reference's code
  writes (ROADMAP queue 3): the first layer's keys already differ by up
  to 2 ulps at every position past 0; the port rounds where the code
  says.  With that flag off (``--xla_allow_excess_precision=false``), or
  run op by op, the reference's first layer equals the port's bit for bit.
* Greedy token ids equal wherever the reference's top-2 logit margin
  exceeds twice ``LOGIT_TOL``; in the serving entry point, where the port's
  logits along the reference's tokens stand in for the reference's, past
  four times ``LOGIT_TOL``.
* The learned page table's answers equal bit for bit.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import repro  # noqa: F401  (enables x64 for the reference)
import jax
import jax.numpy as jnp
from repro.configs import get_arch as jget_arch
from repro.configs import list_archs as jlist_archs
from repro.configs.reduced import reduce_cfg as jreduce
from repro.launch import serve as jserve
from repro.launch.mesh import make_smoke_mesh
from repro.models import layers as jlayers
from repro.models import model as JM
from repro.models import sharding as jsharding
from repro.serve import kvcache as jkv
from repro.serve import step as jstep

from repro_torch import convert
from repro_torch.configs import get_arch, list_archs, single_card
from repro_torch.configs.reduced import reduce_cfg
from repro_torch.kernels import flash as tflash
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as tlayers
from repro_torch.models import model as TM
from repro_torch.serve import kvcache as tkv
from repro_torch.serve import step as tstep
from torch_export import export_lm_params

LOGIT_TOL = 0.08
CACHE_ULPS = 8
B, S, S_MAX = 2, 24, 32


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().float().numpy()
    return np.asarray(a).astype(np.float32)


def _bf16_t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)) \
        .view(torch.bfloat16)


def ulps(got, want, row: bool = False) -> np.ndarray:
    """|got - want| in bf16 ulps of the larger magnitude of the two entries
    or, with ``row``, of the largest entry of their last axis (a head's
    vector: rounding errors scale with it, and entries near zero come from
    cancellation)."""
    got, want = _np(got), _np(want)
    m = np.maximum(np.abs(got), np.abs(want))
    if row:
        m = m.max(-1, keepdims=True)
    m = np.maximum(m, np.float32(2.0 ** -126))
    return np.abs(got - want) / np.exp2(np.floor(np.log2(m)) - 7)


@contextlib.contextmanager
def no_fsdp_gather():
    """Run reference layers outside a mesh: its FSDP gather is the
    identity (a trace-time switch, put back afterwards)."""
    saved = jsharding._FSDP_GATHER_ON
    jsharding.set_fsdp_gather(False)
    try:
        yield
    finally:
        jsharding.set_fsdp_gather(saved)


def _randomize(tree, rng):
    """Norm scales 1 + 0.2 N(0, 1) and biases 0.2 N(0, 1), in the leaves'
    dtype; other leaves unchanged."""
    if isinstance(tree, dict):
        return {k: _randomize(v, rng) for k, v in tree.items()}
    a = np.asarray(tree)
    f = a.astype(np.float32)
    if (f == 1.0).all():
        return (1 + 0.2 * rng.normal(size=a.shape)).astype(a.dtype)
    if (f == 0.0).all():
        return (0.2 * rng.normal(size=a.shape)).astype(a.dtype)
    return a


def _to_jax(tree, like):
    if like is None:                    # a layer without an FFN stage
        return None
    if isinstance(like, dict):
        return {k: _to_jax(tree[k], v) for k, v in like.items()}
    if hasattr(like, "_fields"):
        return type(like)(*(None if getattr(like, f) is None
                            else _to_jax(tree[f], getattr(like, f))
                            for f in like._fields))
    return jnp.asarray(tree)


def carried(arch: str, seed: int = 0, **kw):
    """(reference cfg, port cfg, reference params, port params): the
    reference's random weights with random norm scales and biases, carried
    across bit for bit."""
    jc = jreduce(jget_arch(arch), **kw)
    tc = reduce_cfg(get_arch(arch), **kw)
    jp = JM.init_params(jc, jax.random.PRNGKey(seed))
    tree = _randomize(export_lm_params(jp), np.random.default_rng(seed + 1))
    return jc, tc, _to_jax(tree, jp), convert.lm_params_from_arrays(
        tree, tc, device="cpu")


@pytest.fixture(scope="module")
def qwen():
    jc, tc, jp, tp = carried("qwen3-4b", n_layers=2, d_model=64, vocab=256)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 256, (B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    return dict(jc=jc, tc=tc, jp=jp, tp=tp, toks=toks, pos=pos)


def _ref_logits_fn(jc):
    """The reference's decode forward and logits, jitted outside a mesh:
    its logits, which ``make_decode_step`` reduces to an argmax."""
    def f(params, caches, tokens, pos, cache_len):
        x, nc = JM.forward(params, jc, tokens, pos=pos, caches=caches,
                           mode="decode", cache_len=cache_len)
        return JM.lm_logits(params, jc, x, False)[:, 0, :]
    return jax.jit(f)


@pytest.fixture(scope="module")
def slice_run(qwen):
    """Prefill and three greedy decode steps through both packages' serving
    steps, from the same tokens (the reference's ids are fed to both)."""
    jc, tc, jp, tp = qwen["jc"], qwen["tc"], qwen["jp"], qwen["tp"]
    mesh = make_smoke_mesh()
    jpre, _ = jstep.make_prefill(jc, mesh)
    jdec, _ = jstep.make_decode_step(jc, mesh)
    jlog = _ref_logits_fn(jc)
    tpre, tdec = tstep.make_prefill(tc), tstep.make_decode_step(tc)
    toks, pos = qwen["toks"], qwen["pos"]
    jl, jcache = jpre(jp, JM.init_cache(jc, B, S_MAX), jnp.asarray(toks),
                      jnp.asarray(pos))
    tl, tcache = tpre(tp, TM.init_cache(tc, B, S_MAX, device="cpu"),
                      torch.from_numpy(toks), torch.from_numpy(pos))
    out = dict(prefill=(np.asarray(jl), _np(tl)),
               prefill_cache=(jax.tree.map(np.asarray, jcache),
                              {k: {n: t.clone() for n, t in v.items()}
                               for k, v in tcache.items()}),
               steps=[])
    tok = np.argmax(np.asarray(jl)[:, :jc.vocab_size], -1).astype(np.int32)
    for i in range(3):
        L = S + i
        args = (jnp.asarray(tok[:, None]), jnp.full((B, 1), L, jnp.int32),
                jnp.asarray(L, jnp.int32))
        with no_fsdp_gather():
            jlogits = np.asarray(jlog(jp, jcache, *args))
        jn, jcache = jdec(jp, jcache, *args)
        t_in = torch.from_numpy(tok[:, None].copy())
        t_pos = torch.full((B, 1), L, dtype=torch.int32)
        x, _ = TM.forward(tp, tc, t_in, pos=t_pos,
                          caches={k: {n: t.clone() for n, t in v.items()}
                                  for k, v in tcache.items()},
                          mode="decode", cache_len=L)
        tlogits = _np(TM.lm_logits(tp, tc, x, False)[:, 0])
        tn, tcache = tdec(tp, tcache, t_in, t_pos, L)
        out["steps"].append((np.asarray(jn), tn.numpy(), jlogits, tlogits))
        tok = np.asarray(jn)
    out["cache"] = (jax.tree.map(np.asarray, jcache), tcache)
    return out


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
_PROPS = ("n_sb", "n_heads_padded", "kv_sharded", "n_kv_padded",
          "vocab_padded", "n_experts_padded", "d_inner", "dt_rank")


@pytest.mark.parametrize("form", ["published", "single_card", "reduced"])
@pytest.mark.parametrize("arch", jlist_archs())
def test_arch_config_matches(arch, form):
    """Every field and derived property of every config, in its published,
    one-card and reduced forms."""
    assert list_archs() == jlist_archs()
    j, t = jget_arch(arch), get_arch(arch)
    if form == "single_card":
        j, t = dataclasses.replace(j, tp=1, tp_shard=False), single_card(t)
    elif form == "reduced":
        j, t = jreduce(j), reduce_cfg(t)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for p in _PROPS:
        assert getattr(t, p) == getattr(j, p), p
    assert [t.moe_at(i) for i in range(t.n_layers)] == \
        [j.moe_at(i) for i in range(j.n_layers)]
    assert t.param_count() == j.param_count()
    assert t.param_count(active_only=True) == j.param_count(active_only=True)


def test_single_card_qwen3_keeps_every_head():
    c = single_card(get_arch("qwen3-4b"))
    assert (c.n_heads, c.n_kv_heads, c.head_dim, c.n_layers) == (32, 8, 128,
                                                                 36)
    assert (c.n_heads_padded, c.n_kv_padded, c.vocab_padded) == (32, 8,
                                                                 151936)
    assert c.param_count() == 4_411_412_480
    # the published form slices one KV head per TP rank
    assert not get_arch("qwen3-4b").kv_sharded


# ---------------------------------------------------------------------------
# parameters and caches
# ---------------------------------------------------------------------------
def _shapes(tree, prefix=""):
    if tree is None:
        return {}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}/{k}"))
        return out
    if hasattr(tree, "_fields") and not isinstance(tree, TM.Leaf):
        out = {}
        for f in tree._fields:
            out.update(_shapes(getattr(tree, f), f"{prefix}/{f}"))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


@pytest.mark.parametrize("arch", ["qwen3-4b", "command-r-plus-104b",
                                  "qwen1.5-4b", "yi-9b",
                                  "granite-moe-1b-a400m", "qwen2-moe-a2.7b",
                                  "jamba-v0.1-52b", "xlstm-125m",
                                  "qwen2-vl-72b", "musicgen-large"])
def test_params_and_caches_match_reference_shapes(arch):
    """``init_params`` and ``init_cache`` give the reference's shapes and
    dtypes, reduced and (without allocating) at published widths.  The
    reference's ``init_params`` is traced for its shapes and dtypes
    (``jax.eval_shape``), not run: its random draws cost seconds and the
    test reads only the shapes."""
    jc = jreduce(jget_arch(arch), n_layers=2)
    tc = reduce_cfg(get_arch(arch), n_layers=2)
    g = torch.Generator()
    g.manual_seed(0)
    got = _shapes(TM.init_params(tc, g, "cpu"))
    assert got == _shapes(jax.eval_shape(lambda k: JM.init_params(jc, k),
                                         jax.random.PRNGKey(0)))
    got = _shapes(TM.init_cache(tc, 3, 40, device="cpu"))
    assert got == _shapes(JM.init_cache(jc, 3, 40))
    jc = dataclasses.replace(jget_arch(arch), tp=1, tp_shard=False)
    tc = single_card(get_arch(arch))
    tree = TM.build_tree(tc)
    meta = {k: TM.tree_map(lambda l, _s=(tc.n_sb,) if k == "sb" else ():
                           torch.empty(_s + l.shape, dtype=torch.bfloat16,
                                       device="meta"), v)
            for k, v in tree.items()}
    assert _shapes(meta) == _shapes(JM.param_shapes(jc))


def test_params_carried_bit_for_bit(qwen):
    """``lm_params_from_arrays`` keeps every bf16 word of every leaf."""
    tree = export_lm_params(qwen["jp"])
    pairs = []

    def walk(t, node):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, node[k])
        elif hasattr(t, "_fields"):
            for f in t._fields:
                if getattr(t, f) is not None:
                    walk(getattr(t, f), node[f])
        else:
            pairs.append((t, node))

    walk(qwen["tp"], tree)
    assert len(pairs) == len(jax.tree.leaves(qwen["jp"]))
    for t, a in pairs:
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      np.asarray(a).view(np.int16))
    with pytest.raises(ValueError, match="shape"):
        bad = dict(tree, lm_head=tree["lm_head"][:, :8])
        convert.lm_params_from_arrays(bad, qwen["tc"], device="cpu")


# ---------------------------------------------------------------------------
# layers against the reference run op by op
# ---------------------------------------------------------------------------
def _bf16_np(rng, *shape, scale=1.0):
    import ml_dtypes
    return (scale * rng.normal(size=shape)).astype(ml_dtypes.bfloat16)


def test_rms_norm_rope_embed(qwen):
    rng = np.random.default_rng(11)
    x = _bf16_np(rng, B, S, 4, 16, scale=3.0)
    sc = (1 + 0.2 * rng.normal(size=16)).astype(x.dtype)
    got = tlayers.rms_norm(_bf16_t(x), _bf16_t(sc), 1e-6)
    want = jlayers.rms_norm(jnp.asarray(x), jnp.asarray(sc), 1e-6)
    assert got.dtype == torch.bfloat16 and ulps(got, want).max() <= 1
    pos = qwen["pos"] + 1000
    got = tlayers.apply_rope(_bf16_t(x), torch.from_numpy(pos), 1e6)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    assert got.dtype == torch.bfloat16 and ulps(got, want).max() <= 1
    np.testing.assert_array_equal(
        tlayers.rope_freqs(128, 1e4).numpy(),
        np.asarray(jlayers.rope_freqs(128, 1e4)))
    toks = qwen["toks"].copy()
    toks[0, :3] = [-1, 256, 255]                # outside the table: zeros
    got = TM.embed_tokens(qwen["tp"], qwen["tc"], torch.from_numpy(toks),
                          False)
    with no_fsdp_gather():
        want = JM.embed_tokens(qwen["jp"], qwen["jc"], jnp.asarray(toks),
                               False)
    np.testing.assert_array_equal(_np(got), _np(want))
    assert not _np(got)[0, :2].any()


@pytest.mark.parametrize("with_cache", [False, True])
def test_attention_block(qwen, with_cache):
    """Both cache branches: no cache (attend over the call's own K/V), and
    a cache filled to ``length`` (the new K/V written there, in place)."""
    jc, tc = qwen["jc"], qwen["tc"]
    jpc = jax.tree.map(lambda t: t[1], qwen["jp"]["sb"])["pos0"]["core"]
    tpc = TM.tree_map(lambda t: t[1], qwen["tp"]["sb"])["pos0"]["core"]
    rng = np.random.default_rng(12)
    x = _bf16_np(rng, B, 5, jc.d_model)
    pos = np.broadcast_to(np.arange(9, 14)[None], (B, 5)).astype(np.int32)
    jcache = tcache = None
    if with_cache:
        kc = _bf16_np(rng, B, S_MAX, 2, 16)
        vc = _bf16_np(rng, B, S_MAX, 2, 16)
        jcache = {"k": jnp.asarray(kc), "v": jnp.asarray(vc),
                  "length": jnp.asarray(9, jnp.int32)}
        tcache = {"k": _bf16_t(kc).clone(), "v": _bf16_t(vc).clone(),
                  "length": 9}
    with no_fsdp_gather():
        want, wc = jlayers.attention_block(jpc, jnp.asarray(x), jc,
                                           pos=jnp.asarray(pos),
                                           cache=jcache, tp_shard=False)
        want_f32, _ = jlayers.attention_block(
            jpc, jnp.asarray(x), jc, pos=jnp.asarray(pos),
            cache=None if jcache is None else dict(jcache), tp_shard=False,
            reduce=False)
    got, gc = tlayers.attention_block(tpc, _bf16_t(x), tc,
                                      pos=torch.from_numpy(pos),
                                      cache=tcache, tp_shard=False)
    assert got.dtype == torch.bfloat16 and ulps(got, want).max() <= 1
    got_f32, _ = tlayers.attention_block(
        tpc, _bf16_t(x), tc, pos=torch.from_numpy(pos),
        cache=None if tcache is None else dict(tcache), tp_shard=False,
        reduce=False)
    assert got_f32.dtype == torch.float32
    np.testing.assert_allclose(_np(got_f32), _np(want_f32), rtol=0,
                               atol=2e-6 * np.abs(_np(want_f32)).max())
    if with_cache:
        assert gc["k"] is tcache["k"]          # written in place
        for n in ("k", "v"):
            assert ulps(gc[n], wc[n]).max() <= 1
    else:
        assert gc is None and wc is None


def test_mlp_block_and_logits(qwen):
    jc, tc = qwen["jc"], qwen["tc"]
    jpf = jax.tree.map(lambda t: t[0], qwen["jp"]["sb"])["pos0"]["ffn"]
    tpf = TM.tree_map(lambda t: t[0], qwen["tp"]["sb"])["pos0"]["ffn"]
    rng = np.random.default_rng(13)
    x = _bf16_np(rng, B, 7, jc.d_model)
    with no_fsdp_gather():
        want = jlayers.mlp_block(jpf, jnp.asarray(x), jc, tp_shard=False)
        want_f32 = jlayers.mlp_block(jpf, jnp.asarray(x), jc, tp_shard=False,
                                     reduce=False)
        want_l = JM.lm_logits(qwen["jp"], jc, jnp.asarray(x), False)
    got = tlayers.mlp_block(tpf, _bf16_t(x), tc, tp_shard=False)
    assert got.dtype == torch.bfloat16 and ulps(got, want).max() <= 1
    got_f32 = tlayers.mlp_block(tpf, _bf16_t(x), tc, tp_shard=False,
                                reduce=False)
    np.testing.assert_allclose(_np(got_f32), _np(want_f32), rtol=0,
                               atol=2e-6 * np.abs(_np(want_f32)).max())
    got_l = TM.lm_logits(qwen["tp"], tc, _bf16_t(x), False)
    assert got_l.dtype == torch.float32 and got_l.shape == (B, 7, 256)
    np.testing.assert_allclose(_np(got_l), _np(want_l), rtol=0,
                               atol=2e-6 * np.abs(_np(want_l)).max())


@pytest.mark.parametrize("arch,flag", [("command-r-plus-104b",
                                        "parallel_block"),
                                       ("qwen1.5-4b", "qkv_bias")])
def test_block_variants(arch, flag):
    """Cohere's parallel block (attention and FFN from the same input, one
    rounding of their sum) and QKV biases, one block against the
    reference's ``_run_block``."""
    jc, tc, jp, tp = carried(arch, n_layers=1, d_model=64, vocab=256)
    assert getattr(tc, flag)
    rng = np.random.default_rng(14)
    x = _bf16_np(rng, B, 6, 64)
    pos = np.broadcast_to(np.arange(6)[None], (B, 6)).astype(np.int32)
    with no_fsdp_gather():
        want, _ = JM._run_block(jc, 0, "attn",
                                jax.tree.map(lambda t: t[0], jp["sb"])["pos0"],
                                jnp.asarray(x), pos=jnp.asarray(pos),
                                cache=None, tp_shard=False)
    got, _ = TM._run_block(tc, 0, "attn",
                           TM.tree_map(lambda t: t[0], tp["sb"])["pos0"],
                           _bf16_t(x), pos=torch.from_numpy(pos), cache=None,
                           tp_shard=False)
    assert ulps(got, want).max() <= 1


# ---------------------------------------------------------------------------
# the whole slice against the reference's jitted serving steps
# ---------------------------------------------------------------------------
def _margin(logits, vocab):
    top2 = np.sort(logits[:, :vocab], -1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def _check_cache(jcache, tcache):
    for name, kv in tcache.items():
        for n, t in kv.items():
            u = ulps(t, jcache[name][n], row=True)
            assert t.dtype == torch.bfloat16 and u.max() <= CACHE_ULPS, \
                (name, n, u.max())


def test_prefill_matches_make_prefill(qwen, slice_run):
    jl, tl = slice_run["prefill"]
    assert tl.shape == jl.shape == (B, qwen["tc"].vocab_padded)
    assert np.abs(tl - jl).max() <= LOGIT_TOL
    sure = _margin(jl, qwen["jc"].vocab_size) > 2 * LOGIT_TOL
    v = qwen["jc"].vocab_size
    np.testing.assert_array_equal(np.argmax(tl[:, :v], -1)[sure],
                                  np.argmax(jl[:, :v], -1)[sure])
    _check_cache(*slice_run["prefill_cache"])


def test_decode_steps_match_make_decode_step(qwen, slice_run):
    v = qwen["jc"].vocab_size
    for jn, tn, jlogits, tlogits in slice_run["steps"]:
        assert tn.dtype == np.int32 and tn.shape == (B,)
        np.testing.assert_array_equal(np.argmax(jlogits[:, :v], -1), jn)
        assert np.abs(tlogits - jlogits).max() <= LOGIT_TOL
        sure = _margin(jlogits, v) > 2 * LOGIT_TOL
        np.testing.assert_array_equal(tn[sure], jn[sure])
    _check_cache(*slice_run["cache"])


def test_serve_reduced_matches_reference_serve(monkeypatch):
    """``launch.serve.serve(reduced=True)`` against the reference's
    ``serve()`` on the same weights: equal greedy tokens up to a request's
    first token whose margin is too small to call."""
    kw = dict(requests=2, prompt_len=12, new_tokens=5, d_model=128, seed=3)
    want = jserve.serve("qwen3-4b", reduced=True, **kw)
    jc = jreduce(jget_arch("qwen3-4b"), d_model=128, vocab=2048)
    tc = reduce_cfg(get_arch("qwen3-4b"), d_model=128, vocab=2048)
    jp = JM.init_params(jc, jax.random.PRNGKey(3))
    tp = convert.lm_params_from_arrays(export_lm_params(jp), tc,
                                       device="cpu")
    monkeypatch.setattr(tserve.M, "init_params", lambda *a, **k: tp)
    got = tserve.serve("qwen3-4b", reduced=True, device="cpu", **kw)
    assert got.tokens.shape == want.shape == (2, 6)
    assert got.tokens.dtype == np.int32 and got.pages == 2 * 2
    assert got.prefill_s > 0 and got.decode_s > 0
    # the port's logits along the reference's tokens, for the margins
    prompts = np.random.default_rng(3).integers(0, 2048, (2, 12))
    caches = TM.init_cache(tc, 2, 17, device="cpu")
    pos = torch.arange(12, dtype=torch.int32)[None].expand(2, 12)
    logits, caches = tstep.make_prefill(tc)(
        tp, caches, torch.from_numpy(prompts).to(torch.int32), pos)
    margins = [_margin(_np(logits), 2048)]
    for i in range(5):
        x, caches = TM.forward(tp, tc, torch.from_numpy(want[:, i:i + 1]),
                               pos=None, caches=caches, mode="decode",
                               cache_len=12 + i)
        margins.append(_margin(_np(TM.lm_logits(tp, tc, x, False)[:, 0]),
                               2048))
    margins = np.stack(margins, 1)
    for r in range(2):
        for t in range(6):
            if got.tokens[r, t] != want[r, t]:
                assert margins[r, t] <= 4 * LOGIT_TOL, (r, t, margins[r, t])
                break


def test_learned_page_table_matches_reference():
    """Page ids from the port's learned table (K1 semantics and the f64
    path) equal the reference's, bit for bit, on every key and on
    non-member queries; 4 requests keep the packed keys f32-exact."""
    table = {}
    page = 0
    for r in range(4):
        for b in range(40 + 7 * r):
            table[(r, b)] = (page * 7919) % 1000
            page += 1
    jlook, jkeys, jpages = jkv.learned_page_table(table)
    # non-members: between and around the requests' block runs, all
    # f32-exact (integers below 2^24), where both search paths agree
    gaps = [(r << 22) + 100 for r in range(4)] + \
        [(r << 22) - 1 for r in range(1, 4)]
    q = np.concatenate([np.asarray(jkeys), np.asarray(gaps, np.float64),
                        [0.5, -3.0, 16_777_000.0]])
    want = np.asarray(jlook(jnp.asarray(q)))
    for path in ("auto", "kernel", "jnp"):
        tlook, tkeys, tpages = tkv.learned_page_table(table, path=path,
                                                      device="cpu")
        np.testing.assert_array_equal(tkeys.numpy(), np.asarray(jkeys))
        np.testing.assert_array_equal(tpages.numpy(), np.asarray(jpages))
        got = tlook(torch.from_numpy(q))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    big = {(r, b): r for r in range(6) for b in range(3)}  # not f32-exact
    with pytest.raises(ValueError, match="f32-exact"):
        tkv.learned_page_table(big, path="kernel", device="cpu")
    pkv = tkv.PagedKVCache(n_pages=8, page_size=4, n_kv_heads=2, head_dim=16,
                           n_layers=1, device="cpu")
    pages = pkv.allocate_batch(0, [0, 1, 2])
    kv = torch.ones(3, 2, 16, dtype=torch.bfloat16)
    pkv.write(0, pages, 1, kv, 2 * kv)
    k, v = pkv.gather(0, pkv.pages_for(0, 3))
    assert k[:, 1].eq(1).all() and v[:, 1].eq(2).all() and not k[:, 0].any()
    pkv.release(0)
    assert len(pkv.free) == 8 and not pkv.table


def test_device_and_unported_rules():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tserve.serve("qwen3-4b", reduced=True, requests=1, prompt_len=4,
                         new_tokens=1)
    tc = reduce_cfg(get_arch("qwen3-4b"))
    with pytest.raises(NotImplementedError, match="item 14"):
        TM.forward({}, tc, torch.zeros(1, 2, dtype=torch.int32),
                   pos=torch.zeros(1, 2, dtype=torch.int32), mode="decode",
                   seq_sharded=True)
    # served and trained: the recurrent families, M-RoPE (3-D ids) and
    # frame embeddings (no token table)
    for arch in ("jamba-v0.1-52b", "xlstm-125m", "qwen2-vl-72b",
                 "musicgen-large"):
        rc = reduce_cfg(get_arch(arch), d_model=64, vocab=256)
        assert TM.build_tree(rc)["sb"]
        assert ("embed" in TM.build_tree(rc)) is not rc.embed_input
        g = torch.Generator()
        g.manual_seed(0)
        inputs = torch.zeros(1, 2, 64) if rc.embed_input else \
            torch.zeros(1, 2, dtype=torch.int32)
        pos = torch.zeros((3, 1, 2) if rc.rope == "mrope" else (1, 2),
                          dtype=torch.int32)
        x, _ = TM.forward(TM.init_params(rc, g, "cpu"), rc, inputs, pos=pos,
                          mode="train")
        assert tuple(x.shape) == (1, 2, 64) and x.dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="single_card"):
        TM.build_tree(get_arch("qwen3-4b"))
    with pytest.raises(NotImplementedError, match="item 14"):
        tlayers.moe_block(None, None, tc, tp_shard=True)
    with pytest.raises(NotImplementedError, match="item 14"):
        tlayers.attention_block(None, torch.zeros(1, 1, 64), tc, pos=None,
                                tp_shard=True)


def test_cli_reaches_full_width(monkeypatch):
    """``--no-reduced`` reaches the published widths (the reference's flag
    cannot be turned off)."""
    seen = {}
    monkeypatch.setattr(tserve, "serve",
                        lambda arch, **kw: seen.update(kw, arch=arch))
    tserve.main(["--no-reduced", "--requests", "2", "--device", "cpu"])
    assert seen["reduced"] is False and seen["device"] == "cpu"
    tserve.main([])
    assert seen["reduced"] is True and seen["device"] is None


@pytest.mark.gpu
def test_cuda_serve_reduced_runs_the_kernels():
    """On a card the reduced serving entry point goes through K8 (its head
    dim 16 takes the CUDA-core tile, in prefill and in every decode step)
    and, for the page table, K1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import lookup as tlk
    tflash.reset_launches()
    tlk.reset_launches()
    res = tserve.serve("qwen3-4b", reduced=True, requests=4, prompt_len=40,
                       new_tokens=6)
    assert res.tokens.shape == (4, 7)
    assert tflash.LAUNCHES == {**dict.fromkeys(tflash.LAUNCHES, 0),
                               "flash_cc": 7}
    assert tlk.LAUNCHES["lookup"] >= 1
