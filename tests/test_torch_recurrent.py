"""The recurrent families of the LM path (``models/ssm.py``: Mamba, jamba's
hybrid; ``models/xlstm.py``: mLSTM and sLSTM, xlstm-125m) and K8's
``bias_qk`` form, held against the reference on the CPU: reduced configs
(``reduce_cfg``: xlstm-125m at 4 layers, d_model 64, mLSTM head dim 64;
jamba-v0.1-52b at 8 layers, d_model 64, 8 experts), the reference's
weights carried across with ``convert.lm_params_from_arrays``, norm scales
and biases (and Mamba's ``a_log`` and ``d_skip``, initialised to ones)
drawn at random first, as in ``test_torch_lm.py``; inputs from numpy
seeds.

Tolerances, each measured on these inputs (largest value seen in
brackets); "ulps of the row" are bf16 ulps of the largest magnitude of an
entry's last axis:

* Plain K8 with ``bias_qk`` against ``repro.models.layers.flash_attention``
  (bf16 inputs, biases F_t and i_s - F_s of a gated cumsum, up to 1.7e3 in
  magnitude, so that they cancel), at head dims 64 and 384, with
  ``kv_valid < Skv`` and a key count that is not a multiple of 128: within
  one bf16 ulp of the magnitude (the attention of |v|) (0: equal); both
  against a dense f64 softmax within one ulp of the magnitude (0.50).
* ``mlstm_block``, ``slstm_block`` and ``mamba_block`` against the
  reference run op by op (``jax.disable_jit()``), with no state, prefill
  into a random state and a one-token decode from it: bf16 outputs within
  ``BLOCK_ULPS`` = 2 ulps of the row (1.0: f32 sums of another order
  rounded to bf16); every f32 state leaf within ``STATE_RTOL`` = 4e-6 of
  its largest entry (5.3e-7); Mamba's bf16 conv state equal.
* Jamba's MoE position (Mamba + MoE FFN) through ``_run_block``, op by op:
  within ``BLOCK_ULPS`` of the row (1.0), its state as above.
* The whole slice (prefill and three greedy decode steps through the
  serving steps) against the reference's jitted ``make_prefill`` /
  ``make_decode_step`` on the smoke mesh, compiled without excess precision
  (``compiler_options={"xla_allow_excess_precision": False}``, so that
  the jit keeps the bf16 roundings the code writes): logits within
  ``LOGIT_TOL`` = 0.1 (xlstm 0.016, jamba 0.041, for logits up to 3.5),
  bf16 cache leaves within ``CACHE_ULPS`` = 16 ulps of the row (jamba's
  K/V behind four Mamba and two MoE layers 9.75, conv states 4.0), f32
  leaves within ``CACHE_RTOL`` = 0.06 of their largest entry (xlstm 0.012,
  jamba 0.028: a bf16 ulp of a layer's output, where the jit contracts an
  FMA or sums in another order, moves the next layers' exp-gated and
  selective-scan states over 24 steps); greedy ids equal where the top-2
  margin exceeds twice the tolerance.  xlstm also against the steps as the
  reference compiles them (excess precision on, ROADMAP queue 3): logits
  within ``JIT_LOGIT_TOL`` = 0.1 (0.044), states within ``JIT_CACHE_RTOL``
  = 0.1 (0.047).  Jamba is not held against that compile: from its first
  MoE layer on the skipped roundings move tokens across expert routes and
  capacity, and those steps are 1.86 away from the reference's own op-by-op
  run in the prefill logits (the port 0.012 from it).
* ``serve(reduced=True)`` against the reference's ``serve()`` on the same
  weights: tokens equal up to a request's first token whose margin along
  the reference's tokens is at most four times ``LOGIT_TOL``.
* Caches carried across (``convert.lm_caches_from_arrays``) and page-table
  answers: bit for bit.

The reference is imported at first use, not at import, so that the
``gpu`` test runs on a card without JAX.
"""
from __future__ import annotations

import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_arch, single_card
from repro_torch.configs.reduced import reduce_cfg
from repro_torch.kernels import flash as tflash
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as tlayers
from repro_torch.models import model as TM
from repro_torch.models import ssm as tssm
from repro_torch.models import xlstm as txl
from repro_torch.serve import step as tstep

ARCHS = ("xlstm-125m", "jamba-v0.1-52b")
REDUCED = {"xlstm-125m": dict(n_layers=4, d_model=64, vocab=256),
           "jamba-v0.1-52b": dict(d_model=64, vocab=256)}
BLOCK_ULPS = 2
STATE_RTOL = 4e-6
LOGIT_TOL = 0.1
CACHE_ULPS = 16
CACHE_RTOL = 0.06
JIT_LOGIT_TOL = 0.1
JIT_CACHE_RTOL = 0.1
B, S, S_MAX = 2, 24, 32
MAMBA_CHUNK = 8                 # op-by-op blocks: S = 16 in two chunks


@functools.lru_cache(maxsize=None)
def _ref():
    """The reference's modules and ``test_torch_lm``'s helpers."""
    import jax
    import jax.numpy as jnp
    import test_torch_lm as lm
    from repro.launch import serve as jserve
    from repro.launch.mesh import make_smoke_mesh
    from repro.models import layers as jlayers
    from repro.models import model as JM
    from repro.models import ssm as jssm
    from repro.models import xlstm as jxl
    from repro.serve import step as jstep
    return types.SimpleNamespace(jax=jax, jnp=jnp, lm=lm, jserve=jserve,
                                 mesh=make_smoke_mesh, jlayers=jlayers,
                                 JM=JM, jssm=jssm, jxl=jxl, jstep=jstep)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().float().numpy()
    return np.asarray(a).astype(np.float32)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def models():
    R = _ref()
    return {a: R.lm.carried(a, **REDUCED[a]) for a in ARCHS}


# ---------------------------------------------------------------------------
# K8's bias form (plain version)
# ---------------------------------------------------------------------------
def _bias_inputs(seed, Bq, Sq, Skv, H, dh):
    """bf16 q, k, v and the mLSTM's bias terms of random gates: fq = F_t,
    fk = i_s - F_s with F the cumsum of log_sigmoid(f) over time, the
    forget gates f ~ N(-1,200 / S, 1) so that F reaches about -1.2e3, as
    at S = 2,048 with f ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(Bq, Sq, H, dh)).astype(np.float32)
    k = (rng.normal(size=(Bq, Skv, H, dh)) / np.sqrt(dh)).astype(np.float32)
    v = rng.normal(size=(Bq, Skv, H, dh)).astype(np.float32)
    n = max(Sq, Skv)
    fg = rng.normal(size=(Bq, n, H)) - 1200.0 / n
    f_cum = np.cumsum(-np.logaddexp(0.0, -fg), 1).astype(np.float32)
    ig = rng.normal(size=(Bq, n, H)).astype(np.float32)
    return q, k, v, f_cum[:, :Sq], (ig - f_cum)[:, :Skv]


def _dense_bias_f64(q, k, v, fq, fk, kv_valid):
    dh = q.shape[-1]
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) / np.sqrt(dh)
    s = s + fq.transpose(0, 2, 1)[..., None] + fk.transpose(0, 2, 1)[
        :, :, None, :]
    qp, kp = np.arange(q.shape[1])[:, None], np.arange(k.shape[1])[None]
    s = np.where((kp <= qp) & (kp < kv_valid), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v.astype(np.float64))


def _bf16_ulp(mag):
    m = np.maximum(np.abs(mag), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(m)) - 7)


@pytest.mark.parametrize("dh,Sq,Skv,kv_valid", [(64, 300, 300, 300),
                                                 (64, 150, 170, 160),
                                                 (384, 200, 200, 200),
                                                 (384, 70, 90, 77)])
def test_plain_bias_matches_reference(dh, Sq, Skv, kv_valid):
    R = _ref()
    jnp = R.jnp
    q, k, v, fq, fk = _bias_inputs(dh + Sq, 2, Sq, Skv, 2, dh)
    assert np.abs(fq).max() > 500            # the terms cancel
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = tflash.flash_attention(tq, tk, tv, q_offset=0, kv_valid=kv_valid,
                                 bias_qk=(torch.from_numpy(fq),
                                          torch.from_numpy(fk)))
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    want = R.jlayers.flash_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
        q_offset=jnp.zeros((), jnp.int32),
        kv_valid=jnp.asarray(kv_valid, jnp.int32),
        bias_qk=(jnp.asarray(fq), jnp.asarray(fk)))
    qb, kb, vb = (_np(t) for t in (tq, tk, tv))
    mag = _np(tflash.flash_attention_plain(
        tq.float(), tk.float(), tv.float().abs(), q_offset=0,
        kv_valid=kv_valid, bias_qk=(torch.from_numpy(fq),
                                    torch.from_numpy(fk))))
    tol = _bf16_ulp(mag)
    assert (np.abs(_np(got) - _np(want)) <= tol).all()
    exact = _dense_bias_f64(qb, kb, vb, fq, fk, kv_valid)
    assert (np.abs(_np(got) - exact) <= tol).all()


def test_bias_rules():
    """The bias form: shapes and dtypes checked; under autograd it goes
    through ``FlashAttention`` (its gradients are held in
    ``test_torch_train_recurrent.py``); the card's tile takes bf16 at head
    dims 64 and 384 only; ``return_partial`` takes no bias."""
    q, k, v, fq, fk = (torch.from_numpy(a) for a in _bias_inputs(
        0, 1, 8, 8, 2, 64))
    with pytest.raises(ValueError, match="bias_qk"):
        tflash.flash_attention(q, k, v, q_offset=0, bias_qk=(fq[:, :4], fk))
    with pytest.raises(ValueError, match="bias_qk"):
        tflash.flash_attention(q, k, v, q_offset=0,
                               bias_qk=(fq.double(), fk))
    out = tlayers.flash_attention(q.requires_grad_(), k, v, q_offset=0,
                                  bias_qk=(fq, fk))
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    with pytest.raises(ValueError, match="bias_qk"):
        tlayers.flash_attention(q.detach(), k, v, q_offset=0,
                                bias_qk=(fq, fk), return_partial=True)
    assert tflash.bias_tile_of(torch.bfloat16, 64) == "flash_bias"
    assert tflash.bias_tile_of(torch.bfloat16, 384) == "flash_bias"
    for dt, dh in ((torch.bfloat16, 128), (torch.bfloat16, 192),
                   (torch.float32, 64)):
        with pytest.raises(ValueError, match="bias tile"):
            tflash.bias_tile_of(dt, dh)


# ---------------------------------------------------------------------------
# the blocks against the reference run op by op
# ---------------------------------------------------------------------------
def _random_state(tc, pos, rng):
    """A random state of layer position ``pos`` (one layer's slice of
    ``cache_shapes``) as numpy arrays; mLSTM and sLSTM stabilisers and
    normalisers drawn where the recurrences keep them."""
    import ml_dtypes
    out = {}
    for name, (shape, dt) in TM.cache_shapes(tc, B, S_MAX)[pos].items():
        a = 0.5 * rng.normal(size=shape[1:])
        if name == "n":
            a = np.abs(a) + 0.5
        out[name] = a.astype(ml_dtypes.bfloat16 if dt == torch.bfloat16
                             else np.float32)
    return out


def _t(a):
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _check_state(got, want, what):
    assert (got is None) == (want is None), what
    if want is None:
        return
    for f in want._fields:
        g, w = getattr(got, f), getattr(want, f)
        assert tuple(g.shape) == w.shape, (what, f)
        if g.dtype == torch.bfloat16:
            np.testing.assert_array_equal(_np(g), _np(w))
        else:
            assert g.dtype == torch.float32
            assert _rel(g, w) <= STATE_RTOL, (what, f, _rel(g, w))


_BLOCKS = [("xlstm-125m", 0, "mlstm"), ("xlstm-125m", 1, "slstm"),
           ("jamba-v0.1-52b", 0, "mamba")]


@pytest.mark.parametrize("mode", ["no state", "prefill", "decode"])
@pytest.mark.parametrize("arch,pos,kind", _BLOCKS)
def test_block_matches_reference_op_by_op(models, arch, pos, kind, mode):
    R = _ref()
    jax, jnp = R.jax, R.jnp
    jc, tc, jp, tp = models[arch]
    jpc = jax.tree.map(lambda t: t[1 % jc.n_sb], jp["sb"])[f"pos{pos}"]
    tpc = TM.tree_map(lambda t: t[1 % tc.n_sb], tp["sb"])[f"pos{pos}"]
    rng = np.random.default_rng(20 + pos)
    x = R.lm._bf16_np(rng, B, 1 if mode == "decode" else 16, jc.d_model)
    st = None if mode == "no state" else _random_state(tc, f"pos{pos}", rng)
    jfn, tfn, jst, tst = {
        "mlstm": (R.jxl.mlstm_block, txl.mlstm_block, R.jxl.MLSTMState,
                  txl.MLSTMState),
        "slstm": (R.jxl.slstm_block, txl.slstm_block, R.jxl.SLSTMState,
                  txl.SLSTMState),
        "mamba": (R.jssm.mamba_block, tssm.mamba_block, R.jssm.MambaState,
                  tssm.MambaState)}[kind]
    kw = {"chunk": MAMBA_CHUNK} if kind == "mamba" else {}
    with jax.disable_jit(), R.lm.no_fsdp_gather():
        want, wst = jfn(jpc["core"], jnp.asarray(x), jc, tp_shard=False,
                        state=None if st is None else jst(
                            **{k: jnp.asarray(a) for k, a in st.items()}),
                        **kw)
    got, gst = tfn(tpc["core"], _t(x), tc, tp_shard=False,
                   state=None if st is None else tst(
                       **{k: _t(a) for k, a in st.items()}), **kw)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    assert R.lm.ulps(got, want, row=True).max() <= BLOCK_ULPS
    _check_state(gst, wst, (kind, mode))


def test_mamba_chunk_rule(models):
    """The scan's chunk must divide the sequence (the reference asserts)."""
    jc, tc, jp, tp = models["jamba-v0.1-52b"]
    p = TM.tree_map(lambda t: t[0], tp["sb"])["pos0"]["core"]
    x = torch.zeros((1, 12, tc.d_model), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of the scan chunk"):
        tssm.mamba_block(p, x, tc, state=None, tp_shard=False, chunk=8)


@pytest.mark.parametrize("with_state", [False, True])
def test_jamba_moe_position(models, with_state):
    """Jamba's position 1: a Mamba layer with the MoE FFN (every 2nd layer
    from offset 1), through ``_run_block`` against the reference's."""
    R = _ref()
    jax, jnp = R.jax, R.jnp
    jc, tc, jp, tp = models["jamba-v0.1-52b"]
    assert tc.moe_at(1) and not tc.moe_at(0)
    jpb = jax.tree.map(lambda t: t[0], jp["sb"])["pos1"]
    tpb = TM.tree_map(lambda t: t[0], tp["sb"])["pos1"]
    assert isinstance(tpb["ffn"], tlayers.MoEParams)
    rng = np.random.default_rng(31)
    x = R.lm._bf16_np(rng, B, 16, jc.d_model)
    st = _random_state(tc, "pos1", rng) if with_state else None
    with jax.disable_jit(), R.lm.no_fsdp_gather():
        want, wc = R.JM._run_block(
            jc, 1, "mamba", jpb, jnp.asarray(x), pos=None, tp_shard=False,
            cache=None if st is None else {k: jnp.asarray(a)
                                           for k, a in st.items()})
    got, gc = TM._run_block(tc, 1, "mamba", tpb, _t(x), pos=None,
                            tp_shard=False,
                            cache=None if st is None else {
                                k: _t(a) for k, a in st.items()})
    assert R.lm.ulps(got, want, row=True).max() <= BLOCK_ULPS
    assert (gc is None) == (wc is None)
    if wc is not None:
        _check_state(tssm.MambaState(**gc), R.jssm.MambaState(**wc),
                     "moe position")


# ---------------------------------------------------------------------------
# parameters and caches
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_cache_shapes(arch):
    """``cache_shapes`` of the one-card form equals the reference's
    ``init_cache(shapes_only=True)``; the mLSTM's head dim is 384."""
    R = _ref()
    jc = dataclasses.replace(R.lm.jget_arch(arch), tp=1, tp_shard=False)
    tc = single_card(get_arch(arch))
    want = R.JM.init_cache(jc, 4, 2080, shapes_only=True)
    got = TM.cache_shapes(tc, 4, 2080)
    assert set(got) == set(want)
    for pos, leaves in got.items():
        assert set(leaves) == set(want[pos])
        for name, (shape, dt) in leaves.items():
            w = want[pos][name]
            assert shape == tuple(w.shape), (pos, name)
            assert str(dt).split(".")[-1] == str(w.dtype), (pos, name)
    if arch == "xlstm-125m":
        assert got["pos0"]["c"][0] == (6, 4, 4, 384, 384)
        assert got["pos1"]["h"][0] == (6, 4, 4, 192)


def test_caches_carried_bit_for_bit(models):
    R = _ref()
    for arch in ARCHS:
        jc, tc = models[arch][:2]
        rng = np.random.default_rng(7)
        tree = {pos: _random_state(tc, pos, rng) for pos in
                TM.cache_shapes(tc, B, S_MAX)}
        tree = {pos: {k: np.stack([a] * tc.n_sb) for k, a in v.items()}
                for pos, v in tree.items()}
        got = convert.lm_caches_from_arrays(tree, tc, device="cpu")
        for pos, v in tree.items():
            for k, a in v.items():
                t = got[pos][k]
                if a.dtype.name == "bfloat16":
                    np.testing.assert_array_equal(
                        t.view(torch.int16).numpy(), a.view(np.int16))
                else:
                    np.testing.assert_array_equal(t.numpy(), a)
        ref = R.jax.tree.map(np.asarray, R.JM.init_cache(jc, B, S_MAX))
        empty = convert.lm_caches_from_arrays(ref, tc, device="cpu")
        assert {p: {k: tuple(t.shape) for k, t in v.items()}
                for p, v in empty.items()} == \
            {p: {k: a.shape for k, a in v.items()} for p, v in ref.items()}
        pos, name = next((p, k) for p, v in tree.items() for k in v)
        bad = {p: dict(v) for p, v in tree.items()}
        bad[pos][name] = bad[pos][name][:, :1]
        with pytest.raises(ValueError, match=pos):
            convert.lm_caches_from_arrays(bad, tc, device="cpu")


# ---------------------------------------------------------------------------
# the whole slice against the reference's jitted serving steps
# ---------------------------------------------------------------------------
def _margin(logits, vocab):
    top2 = np.sort(logits[:, :vocab], -1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def _check_caches(jcache, tcache, rtol):
    R = _ref()
    for pos, leaves in tcache.items():
        for name, t in leaves.items():
            w = jcache[pos][name]
            if t.dtype == torch.bfloat16:
                u = R.lm.ulps(t, w, row=True).max()
                assert u <= CACHE_ULPS, (pos, name, u)
            else:
                assert _rel(t, w) <= rtol, (pos, name, _rel(t, w))


# XLA compiles without excess precision: the bf16 roundings the code writes
EXACT = {"xla_allow_excess_precision": False}


def _ref_steps(jc, mesh, options):
    """The reference's jitted ``make_prefill`` / ``make_decode_step`` (and
    the decode forward's logits, jitted outside a mesh), each compiled at
    its first call with the XLA ``options``."""
    R = _ref()
    fns = [R.jstep.make_prefill(jc, mesh)[0],
           R.jstep.make_decode_step(jc, mesh)[0], R.lm._ref_logits_fn(jc)]

    def compiled(fn):
        cache = []

        def call(*args):
            if not cache:
                cache.append(fn.lower(*args).compile(
                    compiler_options=options))
            return cache[0](*args)
        return call
    return [compiled(f) for f in fns]


@pytest.fixture(scope="module")
def slice_runs(models):
    """Per arch: prefill and three greedy decode steps through the port's
    serving steps and the reference's jitted ones on the smoke mesh,
    compiled without excess precision (both archs) and as the reference
    compiles them (xlstm), from the same tokens (the reference's ids fed
    to the port)."""
    R = _ref()
    jax, jnp = R.jax, R.jnp
    mesh = R.mesh()
    np_tree = functools.partial(jax.tree.map, np.asarray)
    out = {}
    for arch in ARCHS:
        jc, tc, jp, tp = models[arch]
        refs = {"exact": _ref_steps(jc, mesh, EXACT)}
        if arch == "xlstm-125m":
            refs["default"] = _ref_steps(jc, mesh, {})
        tpre, tdec = tstep.make_prefill(tc), tstep.make_decode_step(tc)
        rng = np.random.default_rng(5)
        toks = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
        pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
        run = {"prefill": {}, "prefill_cache": {}, "steps": {}, "cache": {}}
        jcache = {}
        for name, (jpre, _, _) in refs.items():
            jl, jcache[name] = jpre(jp, R.JM.init_cache(jc, B, S_MAX),
                                    jnp.asarray(toks), jnp.asarray(pos))
            run["prefill"][name] = np.asarray(jl)
            run["prefill_cache"][name] = np_tree(jcache[name])
        tl, tcache = tpre(tp, TM.init_cache(tc, B, S_MAX, device="cpu"),
                          torch.from_numpy(toks), torch.from_numpy(pos))
        run["prefill"]["port"] = _np(tl)
        run["prefill_cache"]["port"] = {
            p: {n: t.clone() for n, t in v.items()} for p, v in tcache.items()}
        tok = np.argmax(run["prefill"]["exact"][:, :jc.vocab_size],
                        -1).astype(np.int32)
        for i in range(3):
            L = S + i
            args = (jnp.asarray(tok[:, None]), jnp.full((B, 1), L, jnp.int32),
                    jnp.asarray(L, jnp.int32))
            step = {}
            for name, (_, jdec, jlog) in refs.items():
                with R.lm.no_fsdp_gather():
                    logits = np.asarray(jlog(jp, jcache[name], *args))
                jn, jcache[name] = jdec(jp, jcache[name], *args)
                step[name] = (np.asarray(jn), logits)
            t_in = torch.from_numpy(tok[:, None].copy())
            t_pos = torch.full((B, 1), L, dtype=torch.int32)
            x, _ = TM.forward(tp, tc, t_in, pos=t_pos, mode="decode",
                              caches={p: {n: t.clone() for n, t in v.items()}
                                      for p, v in tcache.items()},
                              cache_len=L)
            tlogits = _np(TM.lm_logits(tp, tc, x, False)[:, 0])
            tn, tcache = tdec(tp, tcache, t_in, t_pos, L)
            step["port"] = (tn.numpy(), tlogits)
            run["steps"][i] = step
            tok = step["exact"][0]
        run["cache"] = {name: np_tree(c) for name, c in jcache.items()}
        run["cache"]["port"] = tcache
        out[arch] = run
    return out


_TOLS = {"exact": (LOGIT_TOL, CACHE_RTOL),
         "default": (JIT_LOGIT_TOL, JIT_CACHE_RTOL)}


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_make_prefill(models, slice_runs, arch):
    tc = models[arch][1]
    run = slice_runs[arch]
    tl = run["prefill"]["port"]
    assert tl.shape == (B, tc.vocab_padded) and np.isfinite(tl).all()
    v = tc.vocab_size
    for name, jl in run["prefill"].items():
        if name == "port":
            continue
        logit_tol, rtol = _TOLS[name]
        assert np.abs(tl - jl).max() <= logit_tol, name
        sure = _margin(jl, v) > 2 * logit_tol
        np.testing.assert_array_equal(np.argmax(tl[:, :v], -1)[sure],
                                      np.argmax(jl[:, :v], -1)[sure])
        _check_caches(run["prefill_cache"][name],
                      run["prefill_cache"]["port"], rtol)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_make_decode_step(models, slice_runs, arch):
    v = models[arch][1].vocab_size
    run = slice_runs[arch]
    for step in run["steps"].values():
        tn, tlogits = step["port"]
        assert tn.dtype == np.int32 and tn.shape == (B,)
        for name, (jn, jlogits) in step.items():
            if name == "port":
                continue
            logit_tol, _ = _TOLS[name]
            np.testing.assert_array_equal(np.argmax(jlogits[:, :v], -1), jn)
            assert np.abs(tlogits - jlogits).max() <= logit_tol, name
            sure = _margin(jlogits, v) > 2 * logit_tol
            np.testing.assert_array_equal(tn[sure], jn[sure])
    for name, cache in run["cache"].items():
        if name != "port":
            _check_caches(cache, run["cache"]["port"], _TOLS[name][1])


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_reduced_matches_reference_serve(monkeypatch, arch):
    """``launch.serve.serve(reduced=True)`` against the reference's
    ``serve()`` on the same weights (jamba's prompt is one Mamba chunk)."""
    R = _ref()
    kw = dict(requests=2, prompt_len=16, new_tokens=4, d_model=64, seed=3)
    want = R.jserve.serve(arch, reduced=True, **kw)
    jc = R.lm.jreduce(R.lm.jget_arch(arch), d_model=64, vocab=2048)
    tc = reduce_cfg(get_arch(arch), d_model=64, vocab=2048)
    jp = R.JM.init_params(jc, R.jax.random.PRNGKey(3))
    tp = convert.lm_params_from_arrays(R.lm.export_lm_params(jp), tc,
                                       device="cpu")
    monkeypatch.setattr(tserve.M, "init_params", lambda *a, **k: tp)
    got = tserve.serve(arch, reduced=True, device="cpu", **kw)
    assert got.tokens.shape == want.shape == (2, 5)
    assert got.tokens.dtype == np.int32 and got.pages == 2 * 2
    prompts = np.random.default_rng(3).integers(0, 2048, (2, 16))
    caches = TM.init_cache(tc, 2, 20, device="cpu")
    pos = torch.arange(16, dtype=torch.int32)[None].expand(2, 16)
    logits, caches = tstep.make_prefill(tc)(
        tp, caches, torch.from_numpy(prompts).to(torch.int32), pos)
    margins = [_margin(_np(logits), 2048)]
    for i in range(4):
        x, caches = TM.forward(tp, tc, torch.from_numpy(want[:, i:i + 1]),
                               pos=None, caches=caches, mode="decode",
                               cache_len=16 + i)
        margins.append(_margin(_np(TM.lm_logits(tp, tc, x, False)[:, 0]),
                               2048))
    margins = np.stack(margins, 1)
    for r in range(2):
        for t in range(5):
            if got.tokens[r, t] != want[r, t]:
                assert margins[r, t] <= 4 * LOGIT_TOL, (r, t, margins[r, t])
                break


def test_recurrent_rules(models, monkeypatch):
    """Training through a recurrent layer runs (held against the reference
    in ``test_torch_train_recurrent.py``); tensor-parallel layouts and TF32
    on the card raise; the CLI reaches xlstm-125m at full width."""
    tc = models["xlstm-125m"][1]
    x, caches = TM.forward(models["xlstm-125m"][3], tc,
                           torch.zeros(1, 2, dtype=torch.int32),
                           pos=torch.zeros(1, 2, dtype=torch.int32),
                           mode="train")
    assert caches is None and tuple(x.shape) == (1, 2, tc.d_model)
    with pytest.raises(NotImplementedError, match="item 14"):
        txl.slstm_block(None, torch.zeros(1, 1, 64), tc, state=None,
                        tp_shard=True)
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="allow_tf32"):
            tlayers.no_tf32(torch.device("cuda"))
        tlayers.no_tf32(torch.device("cpu"))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    seen = {}
    monkeypatch.setattr(tserve, "serve",
                        lambda arch, **kw: seen.update(kw, arch=arch))
    tserve.main(["--arch", "xlstm-125m", "--no-reduced", "--device", "cpu"])
    assert seen["arch"] == "xlstm-125m" and seen["reduced"] is False
    c = single_card(get_arch("xlstm-125m"))
    assert c.expand * c.d_model // c.xl_heads == 384


@pytest.mark.gpu
def test_cuda_serve_reduced_runs_the_kernels():
    """On a card the reduced serving entry point goes through K8's bias
    tile once a prefill per mLSTM layer (xlstm, head dim 128 / 2 = 64 at
    d_model 64: the bias tile's dh 64) and never in decode; jamba's
    attention layer (head dim 16) through the CUDA-core tile, in prefill
    and every decode step; the page table through K1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import lookup as tlk
    for arch, want in (("xlstm-125m", dict(flash_bias=1)),
                       ("jamba-v0.1-52b", dict(flash_cc=1 + 6))):
        tflash.reset_launches()
        tlk.reset_launches()
        res = tserve.serve(arch, reduced=True, requests=4, prompt_len=32,
                           new_tokens=6, d_model=64)
        assert res.tokens.shape == (4, 7)
        assert tflash.LAUNCHES == {**dict.fromkeys(tflash.LAUNCHES, 0),
                                   **want}, (arch, tflash.LAUNCHES)
        assert tlk.LAUNCHES["lookup"] >= 1


