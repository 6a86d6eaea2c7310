"""K8's last forms held against the reference at small sizes: the TPU
kernel's ``causal=False``, head dims other than 16, 32, 64 and 128, and
positions as 0-d tensors (the reference's traced ``q_offset``, ``kv_valid``
and decode ``cache_len``) through the wrapper and the decode step.

Tolerances (largest value seen over seeds 0-4 in brackets):

* ``flash_attention(..., causal=)`` against ``flash_attention_pallas(...,
  causal=)`` in interpret mode (GQA broadcast for it): ``causal=False`` at
  dh 40 and 256 (64 queries over 200 keys), causal at dh 40, 80, 96 and
  256 (150 queries, 200 keys), f32 and bf16, GQA 2, lengths off the
  128-key blocks; ``tests/test_torch_flash.py``'s tolerances for that
  comparison, f32 atol 1e-5 (6.0e-7), bf16 atol 2e-2 (2.0e-3).
* Tensor positions against ints, bit for bit: the plain version (causal
  and not, negative ``q_offset``, ``kv_valid`` a tensor, an int or None,
  out of range tensors clamped as the tiles clamp), the split-KV plain
  version at the tensor form's plan (``plan_keys = Skv``); and against the
  reference's jitted ``models.layers.flash_attention`` with int32 array
  positions, as ``test_torch_flash.py`` holds the eager one: f32 atol 2e-6
  (1.4e-6), bf16 within one bf16 ulp of the magnitude (the attention of
  |v|) (0.0625 ulps).
* The one-card decode step with a tensor ``cache_len`` (weights from the
  port's init carried across, ``test_torch_train_recurrent.carried``):
  equal to the int form bit for bit (ids and every cache leaf, three steps
  of ``make_decode_step``); and, one step at a time from the same random
  state, against the reference's jitted decode forward (``jax.jit`` of
  ``models.model.forward(mode="decode")`` with a traced ``cache_len``,
  compiled without excess precision as ``test_torch_recurrent.py``
  compiles it): logits within ``test_torch_lm.py``'s and
  ``test_torch_recurrent.py``'s ``LOGIT_TOL`` (qwen3-4b 0.08 (4.8e-7),
  jamba 0.1 (0.054: its MoE and Mamba layers)), bf16 cache leaves within
  their ``CACHE_ULPS`` of the row (8 (0.0625) and 16 (5.0)), f32 leaves
  within ``CACHE_RTOL`` 0.06 of their largest entry (0.023).
* The sequence-sharded decode step on (1, 2, 1) CPU positions, the port
  alone: the tensor form equal to the int form bit for bit as
  ``cache_len`` crosses the chunks' seam (the write ``_write_chunk``
  selects by ``mine`` where the int form branches on the host).

On a card (``gpu`` marker): every new form through the tile ``tile_of``
names (by counter), against its plain version and the dense f64 oracle
(bf16 within one bf16 ulp of the magnitude, f32 atol 1e-5); tensor
positions equal to ints bit for bit on the tensor-core and CUDA-core
tiles, and on the split-KV tile against the plain version at the fixed
plan; a call with tensor positions under ``set_sync_debug_mode("error")``;
and a CUDA graph of a call replayed with new positions equal to the
uncaptured call bit for bit.  The reference is imported only where JAX is
installed, so ``pytest -m gpu`` runs this file on the card's machine.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

try:    # the reference; the card's machine has no JAX, and runs -m gpu
    import repro  # noqa: F401  (enables x64 for the reference)
    import jax
    import jax.numpy as jnp
    from repro.kernels.flash import flash_attention_pallas
    from repro.models import layers as jlayers
except ImportError:
    jax = jnp = flash_attention_pallas = jlayers = None

from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.configs.reduced import reduce_cfg
from repro_torch.kernels import cost
from repro_torch.kernels import flash as tflash
from repro_torch.models import model as TM
from repro_torch.models import sharding as tsh
from repro_torch.serve import step as tstep
from test_torch_flash import _dense_f64, _inputs, _np, bf16_ulp, magnitude

I32 = torch.int32


def _t(x, device="cpu"):
    return torch.tensor(x, dtype=I32, device=device)


# ---------------------------------------------------------------------------
# against the TPU kernel in interpret mode
# ---------------------------------------------------------------------------
# (dh, causal, B, Sq, Skv, H, Hkv)
_PALLAS = [(40, False, 1, 64, 200, 2, 1), (256, False, 1, 64, 200, 2, 1)] + \
    [(dh, True, 1, 150, 200, 2, 1) for dh in (40, 80, 96, 256)]


@pytest.fixture(scope="module")
def pallas_refs():
    """Every case's ``flash_attention_pallas`` output, once a module."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        for n, (dh, causal, B, Sq, Skv, H, Hkv) in enumerate(_PALLAS):
            (q, k, v), jqkv = _inputs(n, B, Sq, Skv, H, Hkv, dh, dtype)
            jq, jk, jv = jqkv
            G = H // Hkv
            want = flash_attention_pallas(jq, jnp.repeat(jk, G, axis=2),
                                          jnp.repeat(jv, G, axis=2),
                                          causal=causal)
            out[dtype, n] = ((q, k, v), np.asarray(want, np.float32))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", range(len(_PALLAS)))
def test_forms_match_pallas(pallas_refs, dtype, n):
    dh, causal = _PALLAS[n][:2]
    (q, k, v), want = pallas_refs[dtype, n]
    got = tflash.flash_attention(q, k, v, q_offset=0, causal=causal)
    assert got.dtype == q.dtype and got.shape == q.shape
    atol = 2e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(_np(got), want, atol=atol)
    # the same call with the positions as tensors, bit for bit
    same = tflash.flash_attention(q, k, v, q_offset=_t(0),
                                  kv_valid=_t(k.shape[1]), causal=causal)
    assert torch.equal(same, got)


# ---------------------------------------------------------------------------
# tensor positions
# ---------------------------------------------------------------------------
# (B, Sq, Skv, H, Hkv, dh, q_offset, kv_valid): prefill into a cache,
# decode, a negative q_offset (a chunk past ``length``: no key seen, or
# some), kv_valid 0, and kv_valid = None
_POSITIONS = [(2, 24, 64, 4, 2, 40, 30, 54), (2, 1, 150, 8, 2, 80, 120, 121),
              (1, 8, 96, 4, 1, 96, -5, 96), (1, 8, 96, 4, 1, 96, -20, 96),
              (1, 7, 200, 4, 2, 256, 100, 0), (2, 5, 70, 2, 2, 16, 3, None)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", _POSITIONS)
def test_tensor_positions_equal_ints(case, causal):
    B, Sq, Skv, H, Hkv, dh, qo, kvv = case
    (q, k, v), _ = _inputs(Skv + Sq, B, Sq, Skv, H, Hkv, dh, "bfloat16")
    want = tflash.flash_attention(q, k, v, q_offset=qo, kv_valid=kvv,
                                  causal=causal)
    tkv = None if kvv is None else _t(kvv)
    for pos in ((_t(qo), tkv), (_t(qo), kvv), (qo, tkv)):
        if pos == (qo, None):
            continue
        got = tflash.flash_attention(q, k, v, q_offset=pos[0],
                                     kv_valid=pos[1], causal=causal)
        assert torch.equal(got, want), pos
    # the split-KV plain version: the tensor form's plan (every key) is
    # the int form's at plan_keys = Skv
    if Sq * H // Hkv <= tflash.DECODE_ROWS:
        kw = dict(kv_valid=kvv, n_split=3, causal=causal)
        want = tflash.flash_decode_split_plain(q, k, v, q_offset=qo,
                                               plan_keys=Skv, **kw)
        got = tflash.flash_decode_split_plain(
            q, k, v, q_offset=_t(qo), **{**kw, "kv_valid": tkv})
        assert torch.equal(got, want)
        part = tflash.flash_decode_split_plain(
            q, k, v, q_offset=_t(qo), return_partial=True,
            **{**kw, "kv_valid": tkv})
        ref = tflash.flash_decode_split_plain(q, k, v, q_offset=qo,
                                              plan_keys=Skv,
                                              return_partial=True, **kw)
        assert all(torch.equal(a, b) for a, b in zip(part, ref, strict=True))


def test_tensor_kv_valid_clamped():
    """A tensor kv_valid outside [0, Skv] is clamped, as the tiles clamp
    it (ints outside raise)."""
    (q, k, v), _ = _inputs(3, 1, 4, 40, 2, 1, 32, "float32")
    for bad, good in ((50, 40), (-3, 0)):
        got = tflash.flash_attention(q, k, v, q_offset=_t(36),
                                     kv_valid=_t(bad))
        assert torch.equal(got, tflash.flash_attention(
            q, k, v, q_offset=36, kv_valid=good))
        with pytest.raises(ValueError):
            tflash.flash_attention(q, k, v, q_offset=36, kv_valid=bad)


# (B, Sq, Skv, H, Hkv, dh, q_offset, kv_valid) against the jitted
# reference; q_offset negative in the last two
_JITTED = [(2, 24, 64, 4, 2, 40, 30, 54), (2, 1, 150, 8, 2, 80, 120, 121),
           (1, 9, 300, 4, 2, 96, 200, 209), (1, 8, 96, 4, 1, 256, -3, 96),
           (1, 6, 64, 4, 2, 64, -10, 64)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tensor_positions_match_jitted_reference(dtype):
    fn = jax.jit(jlayers.flash_attention)
    for n, (B, Sq, Skv, H, Hkv, dh, qo, kvv) in enumerate(_JITTED):
        (q, k, v), (jq, jk, jv) = _inputs(n, B, Sq, Skv, H, Hkv, dh, dtype)
        want = np.asarray(fn(jq, jk, jv, q_offset=jnp.asarray(qo, jnp.int32),
                             kv_valid=jnp.asarray(kvv, jnp.int32)),
                          np.float32)
        got = _np(tflash.flash_attention(q, k, v, q_offset=_t(qo),
                                         kv_valid=_t(kvv)))
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
        else:
            tol = bf16_ulp(magnitude(q, k, v, qo, kvv))
            assert (np.abs(got - want) <= tol).all(), n


def test_tensor_positions_under_a_gradient_and_meta():
    """``FlashAttention`` takes tensor positions (forward equal to the int
    form, gradients within f32 rounding of it: the tensor form's backward
    goes over every key); on meta the wrappers return the kernels' shapes
    and count the keys the grid covers (every key, every row)."""
    (q, k, v), _ = _inputs(5, 2, 6, 70, 4, 2, 32, "float32")
    outs = []
    for qo, kvv in ((40, 46), (_t(40), _t(46))):
        qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
        out = tflash.flash_attention(qs, ks, vs, q_offset=qo, kv_valid=kvv)
        out.square().sum().backward()
        outs.append((out.detach(), qs.grad, ks.grad, vs.grad))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1:], outs[1][1:], strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-6)
    # meta: the kernels' shapes, nothing launched, the grid's keys counted
    qm, km, vm = (torch.empty(s, dtype=torch.bfloat16, device="meta")
                  for s in ((2, 6, 4, 64), (2, 70, 2, 64), (2, 70, 2, 64)))
    pos = torch.zeros((), dtype=I32, device="meta")
    before = dict(tflash.LAUNCHES)
    assert tflash.flash_attention(qm, km, vm, q_offset=pos,
                                  kv_valid=pos).shape == qm.shape
    m, l, acc = tflash.flash_attention(qm[:, :1], km, vm, q_offset=pos,
                                       return_partial=True)
    assert (m.shape, l.shape, acc.shape) == ((2, 4, 1), (2, 4, 1),
                                             (2, 4, 1, 64))
    assert tflash.LAUNCHES == before
    work = cost.flash_work(qm, km, pos, 3)
    assert work.ops == 4 * 64 * 2 * 4 * 6 * 70
    # every key for every row: as an int call without the causal mask
    assert work == cost.flash_work(qm, km, 0, 70, causal=False)
    assert cost.flash_work(qm, km, 0, 70).ops < work.ops


def test_form_rules():
    """``causal=False`` raises under autograd and in the bias form, and so
    does a tensor position in the bias form; positions are 0-d integer
    tensors on q's device; head dims 1 to 256 have a tile, others raise."""
    (q, k, v), _ = _inputs(0, 1, 4, 8, 4, 2, 16, "float32")
    with pytest.raises(ValueError, match="no backward"):
        tflash.flash_attention(q.clone().requires_grad_(), k, v, q_offset=0,
                               causal=False)
    fq, fk = torch.zeros(1, 4, 4), torch.zeros(1, 8, 4)
    for kw in (dict(q_offset=0, causal=False), dict(q_offset=_t(0)),
               dict(q_offset=0, kv_valid=_t(8))):
        for fn in (tflash.flash_attention, tflash.flash_attention_lse,
                   tflash.flash_attention_plain):
            with pytest.raises(ValueError, match="bias_qk"):
                fn(q, k, v, bias_qk=(fq, fk), **kw)
    for bad in (torch.zeros(1, dtype=I32), torch.zeros(()),
                torch.zeros((), dtype=torch.bool),
                torch.zeros((), dtype=I32, device="meta")):
        with pytest.raises(ValueError, match="q_offset"):
            tflash.flash_attention(q, k, v, q_offset=bad)
    bf = torch.bfloat16
    assert [tflash.tile_of(bf, dh, 64) for dh in (64, 80, 96, 128, 256)] == \
        ["flash"] * 4 + ["flash_cc"]
    assert [tflash.tile_of(bf, dh, 8) for dh in (64, 80, 96, 128, 256)] == \
        ["flash_decode"] * 5
    assert {tflash.tile_of(dt, dh, r) for dt in (bf, torch.float32)
            for dh in (1, 33, 40, 100, 200) for r in (1, 64)} == {"flash_cc"}
    for dh in (0, 257, 384):
        with pytest.raises(ValueError, match="1 to 256"):
            tflash.tile_of(bf, dh, 64)


# ---------------------------------------------------------------------------
# the decode step
# ---------------------------------------------------------------------------
# (arch, reduce_cfg's arguments, LOGIT_TOL, CACHE_ULPS): test_torch_lm's
# and test_torch_recurrent's configs and tolerances
_ARCHS = {"qwen3-4b": (dict(n_layers=2, d_model=64, vocab=256), 0.08, 8),
          "jamba-v0.1-52b": (dict(d_model=64, vocab=256), 0.1, 16)}
CACHE_RTOL = 0.06
B, S_MAX, L0 = 2, 32, 20


def _random_caches(jc, rng) -> dict:
    """A decode state of the reference's layout as numpy arrays, drawn
    with numpy: K/V (bf16, N(0, 1) over the filled prefix ``L0``, zero past
    it) and every recurrent leaf N(0, 0.5) in its dtype."""
    from repro.models import model as JM
    tree = {}
    for pos, leaves in JM.init_cache(jc, B, S_MAX).items():
        tree[pos] = {}
        for name, a in leaves.items():
            x = rng.normal(0, 1 if name in ("k", "v") else 0.5, a.shape)
            if name in ("k", "v"):
                x[:, :, L0:] = 0
            tree[pos][name] = np.asarray(jnp.asarray(x, a.dtype))
    return tree


def _ref_decode(jc):
    """The reference's decode forward and logits, jitted outside a mesh
    with a traced ``cache_len``, compiled at its first call without excess
    precision: (logits (B, V_padded), new caches)."""
    import test_torch_lm as lm
    from repro.models import model as JM

    def f(params, caches, tokens, pos, cache_len):
        x, nc = JM.forward(params, jc, tokens, pos=pos, caches=caches,
                           mode="decode", cache_len=cache_len)
        return JM.lm_logits(params, jc, x, False)[:, 0, :], nc
    compiled = []

    def call(*args):
        with lm.no_fsdp_gather():
            if not compiled:
                compiled.append(jax.jit(f).lower(*args).compile(
                    compiler_options={"xla_allow_excess_precision": False}))
            return compiled[0](*args)
    return call


@pytest.mark.parametrize("arch", list(_ARCHS))
def test_decode_step_tensor_cache_len(arch):
    import test_torch_lm as lm
    from test_torch_train_recurrent import carried
    kw, logit_tol, cache_ulps = _ARCHS[arch]
    jc, tc, jp, tp = carried(arch, **kw)
    rng = np.random.default_rng(11)
    state = _random_caches(jc, rng)
    ref = _ref_decode(jc)
    toks = rng.integers(0, jc.vocab_size, (3, B, 1)).astype(np.int32)
    dec = tstep.make_decode_step(tc)
    by_int = convert.lm_caches_from_arrays(state, tc, device="cpu")
    by_tensor = convert.lm_caches_from_arrays(state, tc, device="cpu")
    for i in range(3):
        L = L0 + i
        tok = torch.from_numpy(toks[i])
        pos = torch.full((B, 1), L, dtype=I32)
        # the serving step: the tensor form equals the int form bit for bit
        a, by_int = dec(tp, by_int, tok, pos, L)
        b, by_tensor = dec(tp, by_tensor, tok, pos, _t(L))
        assert torch.equal(a, b)
        for p, leaves in by_int.items():
            for n, t in leaves.items():
                assert torch.equal(t, by_tensor[p][n]), (i, p, n)
        # one step from the reference's state against its jit
        jl, jnc = ref(jp, jax.tree.map(jnp.asarray, state),
                      jnp.asarray(toks[i]), jnp.full((B, 1), L, jnp.int32),
                      jnp.asarray(L, jnp.int32))
        mine = convert.lm_caches_from_arrays(state, tc, device="cpu")
        x, mine = TM.forward(tp, tc, tok, pos=pos, caches=mine,
                             mode="decode", cache_len=_t(L))
        tl = _np(TM.lm_logits(tp, tc, x, False)[:, 0])
        assert np.abs(tl - np.asarray(jl)).max() <= logit_tol, i
        state = jax.tree.map(np.asarray, jnc)
        for p, leaves in mine.items():
            for n, t in leaves.items():
                w = state[p][n]
                if t.dtype == torch.bfloat16:
                    assert lm.ulps(t, w, row=True).max() <= cache_ulps, \
                        (i, p, n)
                else:
                    rel = np.abs(_np(t) - w).max() / max(np.abs(w).max(),
                                                         1e-30)
                    assert rel <= CACHE_RTOL, (i, p, n, rel)


def test_seq_sharded_decode_tensor_cache_len():
    """The sequence-sharded step (the caches' time axis over data) on (1,
    2, 1) CPU positions: the tensor form equals the int form bit for bit,
    ids and caches, as ``cache_len`` crosses from the first chunk into the
    second."""
    cfg = reduce_cfg(get_arch("qwen3-4b"), n_layers=2, d_model=64, vocab=256)
    mesh = tsh.ModelMesh((1, 2, 1), devices="cpu")
    glob = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    dec = tstep.make_decode_step(cfg, mesh, batch_sharded=False,
                                 seq_shard=True, replicate_weights=True)
    p_spec, c_spec, t_spec, pos_spec, _ = dec.in_specs
    params = tstep.shard_tree(glob, p_spec, mesh)
    rng = np.random.default_rng(3)
    caches = TM.init_cache(cfg, B, S_MAX, local=False, device="cpu")
    for leaves in caches.values():
        for name, t in leaves.items():
            x = rng.normal(0, 1, t.shape).astype(np.float32)
            x[:, :, S_MAX // 2 - 3:] = 0
            t.copy_(torch.from_numpy(x))
    runs = [tstep.shard_tree(caches, c_spec, mesh, share=False)
            for _ in range(2)]
    for i in range(5):
        L = S_MAX // 2 - 3 + i
        tok = tstep.shard_tree(torch.from_numpy(
            rng.integers(0, 256, (B, 1)).astype(np.int32)), t_spec, mesh)
        pos = tstep.shard_tree(torch.full((B, 1), L, dtype=I32), pos_spec,
                               mesh)
        a, runs[0] = dec(params, runs[0], tok, pos, L)
        b, runs[1] = dec(params, runs[1], tok, pos, _t(L))
        assert all(torch.equal(x, y) for x, y in zip(a, b, strict=True)), i
    ga, gb = (tstep.gather_tree(r, c_spec, mesh) for r in runs)
    for p, leaves in ga.items():
        for n, t in leaves.items():
            assert torch.equal(t, gb[p][n]), (p, n)
    # the steps wrote the new keys where the int form's host branch does
    assert ga["pos0"]["k"][:, :, S_MAX // 2 - 3:S_MAX // 2 + 2].abs() \
        .amax((0, 1, 3, 4)).min() > 0


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------
# (tile, dtype, dh, B, Sq, Skv, H, Hkv, q_offset, kv_valid, causal)
_CUDA_FORMS = [
    ("flash", "bfloat16", 80, 2, 200, 230, 8, 2, 0, 200, True),
    ("flash", "bfloat16", 96, 1, 100, 180, 8, 1, 60, 150, True),
    ("flash", "bfloat16", 80, 2, 70, 260, 8, 8, 190, 250, True),
    ("flash", "bfloat16", 128, 2, 130, 300, 4, 2, 0, 250, False),
    ("flash", "bfloat16", 96, 1, 64, 200, 4, 2, 0, 200, False),
    ("flash_decode", "bfloat16", 256, 2, 1, 300, 8, 2, 150, 151, True),
    ("flash_decode", "bfloat16", 80, 1, 1, 2080, 4, 1, 2060, 2061, True),
    ("flash_decode", "bfloat16", 96, 2, 2, 200, 8, 2, 127, 200, True),
    ("flash_decode", "bfloat16", 128, 3, 1, 300, 8, 2, 0, 270, False),
    ("flash_decode", "bfloat16", 256, 1, 2, 500, 4, 1, 0, 333, False),
    ("flash_cc", "bfloat16", 256, 2, 200, 230, 4, 2, 0, 200, True),
    ("flash_cc", "bfloat16", 40, 2, 37, 300, 8, 2, 100, 137, True),
    ("flash_cc", "float32", 40, 2, 70, 260, 8, 8, 190, 250, True),
    ("flash_cc", "float32", 256, 1, 100, 180, 4, 2, 60, 150, True),
    ("flash_cc", "float32", 33, 2, 40, 90, 4, 2, 50, 90, True),
    ("flash_cc", "bfloat16", 100, 2, 1, 300, 8, 2, 150, 151, True),
    ("flash_cc", "float32", 64, 2, 130, 300, 4, 2, 0, 250, False),
    ("flash_cc", "bfloat16", 200, 1, 3, 90, 2, 1, 0, 77, False),
]


def _cuda_check(n, got, q, k, v, qo, kvv, causal, dtype):
    want = tflash.flash_attention_plain(q, k, v, q_offset=qo, kv_valid=kvv,
                                        causal=causal)
    torch.cuda.synchronize()
    qp = qo if causal else 10 ** 9
    oracle = _dense_f64(q.cpu(), k.cpu(), v.cpu(), qp, kvv)
    tol = bf16_ulp(_np(tflash.flash_attention_plain(
        q.float(), k.float(), v.float().abs(), q_offset=qo, kv_valid=kvv,
        causal=causal)))
    for what, ref in (("plain", _np(want)), ("f64 oracle", oracle)):
        diff = np.abs(_np(got) - ref)
        if dtype == "float32":
            assert diff.max() <= 1e-5, (n, what, diff.max())
        else:
            assert (diff <= tol).all(), (n, what, (diff / tol).max())


@pytest.mark.gpu
def test_cuda_forms_match_plain():
    """Every new form on the card through the tile ``tile_of`` names, by
    counter, against its plain version and the dense f64 oracle; with
    tensor positions bit for bit the int form's on the tensor-core and
    CUDA-core tiles, and on the split-KV tile (every key in its plan)
    against the plain version at that plan."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    for n, (tile, dtype, dh, B, Sq, Skv, H, Hkv, qo, kvv,
            causal) in enumerate(_CUDA_FORMS):
        (q, k, v), _ = _inputs(n, B, Sq, Skv, H, Hkv, dh, dtype)
        q, k, v = q.cuda(), k.cuda(), v.cuda()
        assert tflash.tile_of(q.dtype, dh, Sq * H // Hkv) == tile, n
        before = dict(tflash.LAUNCHES)
        got = tflash.flash_attention(q, k, v, q_offset=qo, kv_valid=kvv,
                                     causal=causal)
        done = {key: tflash.LAUNCHES[key] - before[key] for key in before}
        want = dict.fromkeys(before, 0)
        want[tile] = 1
        if tile == "flash_decode":
            want["flash_combine"] = 1
        assert done == want, (n, done)
        _cuda_check(n, got, q, k, v, qo, kvv, causal, dtype)
        pos = dict(q_offset=_t(qo, dev), kv_valid=_t(kvv, dev))
        got_t = tflash.flash_attention(q, k, v, causal=causal, **pos)
        if tile == "flash_decode":
            n_split, _ = tflash.decode_plan(q, k, causal=causal, **pos)
            fixed = tflash.flash_decode_split_plain(
                q, k, v, n_split=n_split, causal=causal, **pos)
            tol = bf16_ulp(magnitude(q, k, v, qo, kvv) if causal else
                           _np(tflash.flash_attention_plain(
                               q.float(), k.float(), v.float().abs(),
                               q_offset=qo, kv_valid=kvv, causal=False)))
            assert (np.abs(_np(got_t) - _np(fixed)) <= tol).all(), n
            _cuda_check(n, got_t, q, k, v, qo, kvv, causal, dtype)
        else:
            assert torch.equal(got_t, got), n


@pytest.mark.gpu
def test_cuda_tensor_positions_sync_free_and_captured():
    """Tensor positions: the call makes no host sync, and a CUDA graph of
    it replayed with new positions written in place equals the uncaptured
    call bit for bit (the split-KV tile's plan is fixed by Skv)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    for n, (B, Sq, Skv, H, Hkv, dh) in enumerate(((4, 1, 2080, 32, 8, 128),
                                                  (2, 130, 300, 8, 2, 80))):
        (q, k, v), _ = _inputs(n, B, Sq, Skv, H, Hkv, dh, "bfloat16")
        q, k, v = q.cuda(), k.cuda(), v.cuda()
        # the filled prefix ends at ``end``: q_offset end - Sq, kv_valid end
        qo, kvv = _t(Skv - 150 - Sq, dev), _t(Skv - 150, dev)
        tflash.flash_attention(q, k, v, q_offset=qo, kv_valid=kvv)  # warm
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            tflash.flash_attention(q, k, v, q_offset=qo, kv_valid=kvv)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = tflash.flash_attention(q, k, v, q_offset=qo, kv_valid=kvv)
        for end in (Skv, Skv - 64, Skv - 1, Skv - 137):
            qo.fill_(end - Sq)
            kvv.fill_(end)
            graph.replay()
            want = tflash.flash_attention(q, k, v, q_offset=end - Sq,
                                          kv_valid=end)
            fixed = tflash.flash_attention(q, k, v, q_offset=qo.clone(),
                                           kv_valid=kvv.clone())
            torch.cuda.synchronize()
            assert torch.equal(out, fixed), (n, end)
            tol = bf16_ulp(magnitude(q, k, v, end - Sq, end))
            assert (np.abs(_np(out) - _np(want)) <= tol).all(), (n, end)
