"""Kernel K8 (flash attention) of the port, held against the reference at
small sizes.

* ``flash_attention_plain`` against ``flash_attention_pallas`` in
  interpret mode on the reference test's shapes (``tests/test_kernels.py``)
  and tolerances: f32 atol 1e-5, bf16 atol 2e-2.
* ``flash_attention_plain`` against ``repro.models.layers.flash_attention``
  with ``q_offset > 0``, ``kv_valid < Skv``, GQA groups of 1, 2 and 4
  without pre-broadcast and decode shapes (Sq = 1): the same blockwise
  algorithm, so f32 outputs agree to 2e-6 (summation order only), and bf16
  outputs within one bf16 ulp of the magnitude -- the attention of |v|,
  which bounds |out| and sets the scale of the f32 rounding -- since the
  two round nearly equal f32 values once.
* Both against a dense f64 softmax, an oracle independent of the online
  softmax, at atol 2e-6 (f32 inputs, outputs of order one).
* ``flash_decode_split_plain`` (the split-KV decode tile's partials and
  combine) against ``flash_attention_pallas`` in interpret mode (atol
  1e-5, as above) and against ``layers.flash_attention`` on decode shapes
  (f32, atol 2e-6: the same f32 rounding as the blockwise plain version,
  the splits only regroup the sums), for n_split 1, 3 and 7, kv_valid 0,
  1, 63, 64, 65 and Skv, and G 1 and 4.
* The tensor-core prefill tile's arithmetic emulated in plain torch (bf16
  Q, K in an f32 product, the scale after it, exp2 with log2(e) folded, P
  split into bf16 hi + lo, P.V in f32) is within one bf16 ulp of the
  magnitude of the dense f64 oracle on seeded inputs; with P rounded once
  to bf16 (SDPA's scheme) it goes beyond on the same inputs.
* The bias tile's arithmetic emulated in plain torch (the scale after the
  product, fq then fk added one f32 rounding at a time, exp of s - m, P in
  bf16 hi + lo, over 32- or 64-key tiles) at dh 384 with biases near
  +-1.4e3 that cancel is within one bf16 ulp of the magnitude of the dense
  f64 oracle, its lse within 1e-3.
* On a card (``gpu`` marker): each tile against its plain version and the
  dense f64 oracle -- the tensor-core tile (bf16, dh 64 and 128, Sq * G >
  8), the split-KV decode tile (bf16, dh 64 and 128, Sq * G <= 8), the
  CUDA-core tile (f32; bf16 at dh 16) and the bias tile (dh 384 and 64,
  with and without lse) -- bf16 within one bf16 ulp of the magnitude, f32
  within atol 1e-5, with the launch counters per tile.  The reference is
  imported only where JAX is installed, so ``pytest -m gpu`` runs this
  file on the card's machine, which has none.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

try:    # the reference; the card's machine has no JAX, and runs -m gpu
    import repro  # noqa: F401  (enables x64 for the reference)
    import jax.numpy as jnp
    from repro.kernels.flash import flash_attention_pallas
    from repro.models import layers as jlayers
except ImportError:
    jnp = flash_attention_pallas = jlayers = None

from repro_torch.kernels import flash as tflash
from repro_torch.models import layers as tlayers


def _np(a):
    return a.detach().cpu().float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)


def _inputs(seed, B, Sq, Skv, H, Hkv, dh, dtype):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.normal(0, 1, s).astype(np.float32)
    q, k, v = mk(B, Sq, H, dh), mk(B, Skv, Hkv, dh), mk(B, Skv, Hkv, dh)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    # bf16 inputs round once, from the same f32 values, in both packages
    t = [torch.from_numpy(a).to(tdt) for a in (q, k, v)]
    if jnp is None:
        return t, None
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return t, [jnp.asarray(a, jdt) for a in (q, k, v)]


def bf16_ulp(mag: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each magnitude (8 significant bits)."""
    m = np.maximum(np.abs(mag), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(m)) - 7).astype(np.float32)


def magnitude(q, k, v, q_offset, kv_valid, bias=None):
    """The attention of |v| in f32: bounds |out| elementwise."""
    return _np(tflash.flash_attention_plain(
        q.float(), k.float(), v.float().abs(), q_offset=q_offset,
        kv_valid=kv_valid, bias_qk=bias))


@pytest.mark.parametrize("B,Sq,H,dh", [(2, 128, 2, 64), (1, 384, 4, 128),
                                       (2, 100, 2, 64), (1, 256, 1, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas(B, Sq, H, dh, dtype):
    (q, k, v), (jq, jk, jv) = _inputs(B * Sq + dh, B, Sq, Sq, H, H, dh, dtype)
    want = np.asarray(flash_attention_pallas(jq, jk, jv, causal=True),
                      np.float32)
    got = tflash.flash_attention_plain(q, k, v, q_offset=0)
    assert got.dtype == q.dtype and got.shape == q.shape
    atol = 2e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(_np(got), want, atol=atol)
    # the wrapper takes the plain version for a CPU tensor, uncounted
    before = dict(tflash.LAUNCHES)
    assert torch.equal(tflash.flash_attention(q, k, v, q_offset=0), got)
    assert tflash.LAUNCHES == before


# (B, Sq, Skv, H, Hkv, dh, q_offset, kv_valid): offsets into a longer
# cache, under-filled caches, GQA groups 1/2/4, decode (Sq = 1), a cache
# longer than one 1024-key block of the reference, kv_valid below the last
# query's position (later rows see only the valid prefix) and kv_valid = 0
# (every row masked: the output is 0).
_GENERAL = [
    (2, 24, 64, 4, 4, 16, 30, 54),
    (2, 24, 64, 4, 2, 16, 30, 41),
    (1, 8, 32, 4, 2, 16, 5, 0),
    (2, 24, 64, 4, 2, 16, 0, 24),
    (1, 40, 300, 8, 2, 64, 100, 140),
    (2, 1, 96, 8, 2, 128, 70, 71),
    (3, 1, 40, 4, 1, 16, 39, 40),
    (1, 7, 1100, 4, 2, 32, 1090, 1097),
    (1, 130, 200, 2, 1, 64, 0, 200),
]


@pytest.mark.parametrize("case", _GENERAL)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_layers_flash(case, dtype):
    B, Sq, Skv, H, Hkv, dh, qo, kvv = case
    (q, k, v), (jq, jk, jv) = _inputs(Skv + Sq + H, B, Sq, Skv, H, Hkv, dh,
                                      dtype)
    want = np.asarray(jlayers.flash_attention(
        jq, jk, jv, q_offset=jnp.asarray(qo, jnp.int32),
        kv_valid=jnp.asarray(kvv, jnp.int32)), np.float32)
    got = tlayers.flash_attention(q, k, v, q_offset=qo, kv_valid=kvv)
    assert got.dtype == q.dtype and got.shape == q.shape
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=2e-6)
    else:
        diff = np.abs(_np(got) - want)
        assert (diff <= bf16_ulp(magnitude(q, k, v, qo, kvv))).all(), \
            diff.max()


def _dense_f64(q, k, v, q_offset, kv_valid, bias=None, lse=False):
    """A dense f64 softmax attention; with ``bias = (fq, fk)`` each score
    gains fq[b, i, h] + fk[b, j, h]; with ``lse`` also each row's
    log-sum-exp, (B, H, Sq)."""
    q, k, v = (a.double().cpu().numpy() for a in (q, k, v))
    G = q.shape[2] // k.shape[2]
    k, v = np.repeat(k, G, axis=2), np.repeat(v, G, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(q.shape[-1])
    if bias is not None:
        fq, fk = (t.double().cpu().numpy().transpose(0, 2, 1) for t in bias)
        s = s + fq[..., None] + fk[:, :, None, :]
    qp = q_offset + np.arange(q.shape[1])[:, None]
    kp = np.arange(k.shape[1])[None, :]
    keep = (kp <= qp) & (kp < kv_valid)
    s = np.where(keep, s, -np.inf)
    # a row with no valid key attends to nothing: 0, as the reference gives
    mx = np.where(keep.any(-1), s.max(-1), 0.0)
    p = np.exp(s - mx[..., None])
    den = p.sum(-1)
    out = np.einsum("bhqk,bkhd->bqhd", p / np.maximum(den, 1e-300)[..., None],
                    v)
    return (out, mx + np.log(den)) if lse else out


@pytest.mark.parametrize("case", [(2, 160, 160, 2, 2, 64, 0, 160),
                                  (2, 5, 300, 8, 2, 64, 200, 205),
                                  (1, 40, 100, 4, 2, 32, 20, 45),
                                  (2, 1, 300, 8, 2, 128, 250, 251)])
def test_plain_and_reference_match_dense_softmax(case):
    B, Sq, Skv, H, Hkv, dh, qo, kvv = case
    (q, k, v), (jq, jk, jv) = _inputs(7 + Sq, B, Sq, Skv, H, Hkv, dh,
                                      "float32")
    dense = _dense_f64(q, k, v, qo, kvv)
    got = tflash.flash_attention_plain(q, k, v, q_offset=qo, kv_valid=kvv)
    ref = jlayers.flash_attention(jq, jk, jv,
                                  q_offset=jnp.asarray(qo, jnp.int32),
                                  kv_valid=jnp.asarray(kvv, jnp.int32))
    np.testing.assert_allclose(_np(got), dense, atol=2e-6)
    np.testing.assert_allclose(np.asarray(ref), dense, atol=2e-6)


def test_flash_rules():
    """Shapes, dtypes and kv_valid are checked; the softmax scale rounds
    as the reference's; the bias and return_partial forms are taken."""
    (q, k, v), _ = _inputs(0, 1, 4, 8, 4, 2, 16, "float32")
    with pytest.raises(ValueError):
        tflash.flash_attention(q, k, v, q_offset=0, kv_valid=9)
    with pytest.raises(TypeError):
        tflash.flash_attention(q, k.to(torch.bfloat16), v, q_offset=0)
    with pytest.raises(ValueError):
        tflash.flash_attention(q, k[:, :, :1].expand(1, 8, 3, 16)
                               .contiguous(), v, q_offset=0)
    for dh in (16, 32, 64, 128, 256):
        ref = 1.0 / jnp.sqrt(dh).astype(jnp.float32)
        assert np.float32(tflash.softmax_scale(dh)) == np.float32(ref)
        assert np.float32(tflash.softmax_scale(dh)) == np.float32(
            1.0 / float(dh) ** 0.5)
    # bias_qk is served (test_torch_recurrent.py) and trained
    # (test_torch_train_recurrent.py): under autograd FlashAttention takes it
    fq, fk = torch.zeros(1, 4, 4), torch.zeros(1, 8, 4)
    out = tlayers.flash_attention(q.clone().requires_grad_(), k, v,
                                  q_offset=0, bias_qk=(fq, fk))
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    # return_partial (sequence-sharded decode, test_torch_tp.py): the f32
    # (m, l, acc) whose division is the output
    m, l, acc = tlayers.flash_attention(q, k, v, q_offset=0,
                                        return_partial=True)
    assert m.shape == l.shape == (1, 4, 4) and acc.shape == (1, 4, 4, 16)
    torch.testing.assert_close((acc / l[..., None]).transpose(1, 2),
                               tflash.flash_attention_plain(q, k, v,
                                                            q_offset=0),
                               rtol=0, atol=0)


# (B, Sq, Skv, H, Hkv, dh, q_offset) decode shapes, Sq * G <= 8; kv_valid
# and n_split are crossed with them
_SPLIT = [(2, 1, 150, 4, 4, 64, 149), (2, 2, 150, 8, 2, 32, 148)]


@pytest.mark.parametrize("case", _SPLIT)
@pytest.mark.parametrize("kv_valid", [0, 1, 63, 64, 65, 150])
@pytest.mark.parametrize("n_split", [1, 3, 7])
def test_split_plain_matches_layers_flash(case, kv_valid, n_split):
    B, Sq, Skv, H, Hkv, dh, qo = case
    (q, k, v), (jq, jk, jv) = _inputs(Skv + H + kv_valid, B, Sq, Skv, H,
                                      Hkv, dh, "float32")
    want = np.asarray(jlayers.flash_attention(
        jq, jk, jv, q_offset=jnp.asarray(qo, jnp.int32),
        kv_valid=jnp.asarray(kv_valid, jnp.int32)), np.float32)
    got = tflash.flash_decode_split_plain(q, k, v, q_offset=qo,
                                          kv_valid=kv_valid, n_split=n_split)
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=2e-6)
    if kv_valid == 0:
        assert not got.any()


@pytest.mark.parametrize("n_split", [1, 3, 7])
def test_split_plain_matches_pallas(n_split):
    (q, k, v), (jq, jk, jv) = _inputs(n_split, 2, 200, 200, 2, 2, 64,
                                      "float32")
    want = np.asarray(flash_attention_pallas(jq, jk, jv, causal=True),
                      np.float32)
    got = tflash.flash_decode_split_plain(q, k, v, q_offset=0,
                                          n_split=n_split)
    np.testing.assert_allclose(_np(got), want, atol=1e-5)


def test_split_plan():
    """Enough runs for twice the SM count, each at least one 64-key tile;
    path D's decode shape (B 4, Hkv 8, 2,049-2,080 keys) gets 11 runs of 3
    tiles on 132 SMs."""
    assert tflash.split_plan(32, 2049, 132) == (11, 3)
    assert tflash.split_plan(32, 2080, 132) == (11, 3)
    assert tflash.split_plan(2, 129, 132) == (3, 1)
    assert tflash.split_plan(512, 5000, 132) == (1, 79)
    assert tflash.split_plan(8, 0, 132) == (1, 0)
    for blocks, kend in ((1, 1), (4, 64), (4, 65), (32, 2048), (3, 700)):
        n, per = tflash.split_plan(blocks, kend, 132)
        tiles = -(-kend // 64)
        assert (n - 1) * per < tiles <= n * per
        assert blocks * n >= min(264, blocks * tiles)


@pytest.mark.parametrize("dtype,dh,rows,tile", [
    (torch.bfloat16, 128, 9, "flash"), (torch.bfloat16, 64, 8192, "flash"),
    (torch.bfloat16, 128, 8, "flash_decode"),
    (torch.bfloat16, 64, 1, "flash_decode"),
    (torch.float32, 128, 8192, "flash_cc"),
    (torch.float32, 64, 4, "flash_cc"),
    (torch.bfloat16, 16, 8192, "flash_cc"),
    (torch.bfloat16, 32, 1, "flash_cc")])
def test_tile_dispatch(dtype, dh, rows, tile):
    """bf16 at dh 64/128 takes the tensor-core tile above 8 rows and the
    split-KV tile at 8 or fewer; f32 and dh 16/32 take the CUDA-core tile;
    a head dim above 256 raises (``test_torch_k8_forms.py`` holds the
    others)."""
    assert tflash.tile_of(dtype, dh, rows) == tile
    with pytest.raises(ValueError):
        tflash.tile_of(dtype, 257, rows)


_LOG2E = np.float32(1.4426950408889634)


def _tc_emulation(q, k, v, q_offset, kv_valid, split):
    """The tensor-core prefill tile's arithmetic in plain torch: over
    64-key tiles, S = f32(q) . f32(k) (the bf16 products are exact in f32,
    as in wgmma), m = max(m, scale * rowmax(S)) floored at -1e30, p =
    exp2(S * scale * log2(e) - m * log2(e)) (torch rounds the product and
    the difference apart where the kernel fuses them), P.V with P split
    into bf16 hi + lo (``split``) or rounded once to bf16, f32 sums."""
    B, Sq, H, dh = q.shape
    G = H // k.shape[2]
    f32 = torch.float32
    scale = torch.tensor(tflash.softmax_scale(dh), dtype=f32)
    log2e = torch.tensor(_LOG2E)
    q_pos = q_offset + torch.arange(Sq)
    m = torch.full((B, H, Sq), -1e30)
    l = torch.zeros((B, H, Sq))
    acc = torch.zeros((B, H, Sq, dh))
    kend = max(0, min(kv_valid, q_offset + Sq))
    for k0 in range(0, kend, 64):
        kb = k[:, k0:k0 + 64].repeat_interleave(G, 2).to(f32)
        vb = v[:, k0:k0 + 64].repeat_interleave(G, 2).to(f32)
        s = torch.einsum("bqhd,bkhd->bhqk", q.to(f32), kb)
        kp = k0 + torch.arange(kb.shape[1])
        keep = (kp[None] <= q_pos[:, None]) & (kp < kv_valid)[None]
        s = torch.where(keep[None, None], s, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1) * scale).clamp_min(-1e30)
        corr = torch.exp2((m - m_new) * log2e)
        p = torch.exp2(s * (scale * log2e) - (m_new * log2e)[..., None])
        l = l * corr + p.sum(-1)
        hi = p.to(torch.bfloat16).to(f32)
        pv = torch.einsum("bhqk,bkhd->bhqd", hi, vb)
        if split:
            lo = (p - hi).to(torch.bfloat16).to(f32)
            pv = pv + torch.einsum("bhqk,bkhd->bhqd", lo, vb)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


# (seed, B, Sq, Skv, H, Hkv, dh, q_offset, kv_valid): q drawn at 3x the
# spread of k and v, so that some rows' softmax rests on a few keys and P's
# rounding shows in the output
_EMULATED = [(1, 2, 200, 200, 8, 2, 64, 0, 200),
             (1, 1, 192, 224, 8, 2, 128, 32, 210)]


@pytest.mark.parametrize("case", _EMULATED)
@pytest.mark.parametrize("split,within", [(True, True), (False, False)])
def test_tc_arithmetic_needs_p_above_bf16(case, split, within):
    """P split into bf16 hi + lo keeps the prefill tile within one bf16 ulp
    of the magnitude of the f64 oracle; P rounded once to bf16 (SDPA's
    scheme) does not, on the same inputs."""
    seed, B, Sq, Skv, H, Hkv, dh, qo, kvv = case
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(0, 3, (B, Sq, H, dh)).astype(
        np.float32)).to(torch.bfloat16)
    k, v = (torch.from_numpy(rng.normal(0, 1, (B, Skv, Hkv, dh)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    got = _tc_emulation(q, k, v, qo, kvv, split)
    diff = np.abs(_np(got) - _dense_f64(q, k, v, qo, kvv))
    tol = bf16_ulp(magnitude(q, k, v, qo, kvv))
    assert bool((diff <= tol).all()) == within, (diff / tol).max()


K_LSE_ATOL = 1e-3      # lse against f64 (absolute: biases near 1.4e3)


def _bias_inputs(seed, B, Sq, Skv, H, Hkv, dh, lead=2048 - 256):
    """bf16 q, k, v and the mLSTM's bias terms, as ``chip_smoke.py``'s
    ``J_BIAS_EDGES`` draw them: fq = F_t, fk = i_s - F_s, F the running sum
    of log_sigmoid(N(0.3, 1)) forget gates, i ~ N(0, 1); the positions
    taken from ``lead`` steps in, so that F is about -1.2e3 and the two
    terms near +-1.4e3 cancel as at S = 2,048."""
    rng = np.random.default_rng(seed)
    n = max(Sq, Skv)
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    q = f(rng.normal(0, 1, (B, Sq, H, dh))).to(torch.bfloat16)
    k = f(rng.normal(0, 1, (B, Skv, Hkv, dh)) / np.sqrt(dh)).to(
        torch.bfloat16)
    v = f(rng.normal(0, 1, (B, Skv, Hkv, dh))).to(torch.bfloat16)
    gates = rng.normal(0.3, 1, (B, lead + n, H)).astype(np.float32)
    F = np.cumsum(-np.logaddexp(np.float32(0), -gates), 1,
                  dtype=np.float32)[:, lead:]
    ig = rng.normal(0, 1, (B, n, H)).astype(np.float32)
    return q, k, v, f(F[:, :Sq]), f((ig - F)[:, :Skv])


def _bias_emulation(q, k, v, fq, fk, q_offset, kv_valid, key_tile):
    """The bias tile's arithmetic in plain torch, over ``key_tile``-key
    tiles: S = f32(q) . f32(k) (the bf16 products exact in f32, as in
    wgmma), s = (S * scale + fq) + fk one f32 rounding at a time, the mask,
    m = max(m, rowmax(s)) floored at -1e30, p = exp2((s - m) * log2(e))
    (the difference rounded first), P.V with P split into bf16 hi + lo,
    f32 sums; returns (out, lse = m + log(l))."""
    B, Sq, H, dh = q.shape
    G = H // k.shape[2]
    f32 = torch.float32
    scale = torch.tensor(tflash.softmax_scale(dh), dtype=f32)
    log2e = torch.tensor(_LOG2E)
    q_pos = q_offset + torch.arange(Sq)
    fq_t = fq.transpose(1, 2)[..., None]                 # (B, H, Sq, 1)
    m = torch.full((B, H, Sq), -1e30)
    l = torch.zeros((B, H, Sq))
    acc = torch.zeros((B, H, Sq, dh))
    for k0 in range(0, max(0, min(kv_valid, q_offset + Sq)), key_tile):
        kb = k[:, k0:k0 + key_tile].repeat_interleave(G, 2).to(f32)
        vb = v[:, k0:k0 + key_tile].repeat_interleave(G, 2).to(f32)
        s = torch.einsum("bqhd,bkhd->bhqk", q.to(f32), kb)
        s = (s * scale + fq_t) + fk[:, k0:k0 + key_tile].transpose(1, 2)[
            :, :, None, :]
        kp = k0 + torch.arange(kb.shape[1])
        keep = (kp[None] <= q_pos[:, None]) & (kp < kv_valid)[None]
        s = torch.where(keep[None, None], s, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1)).clamp_min(-1e30)
        corr = torch.exp2((m - m_new) * log2e)
        p = torch.exp2((s - m_new[..., None]) * log2e)
        l = l * corr + p.sum(-1)
        hi = p.to(torch.bfloat16).to(f32)
        lo = (p - hi).to(torch.bfloat16).to(f32)
        acc = (acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", hi, vb)
               + torch.einsum("bhqk,bkhd->bhqd", lo, vb))
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype), m + torch.log(l)


@pytest.mark.parametrize("key_tile", [32, 64])
def test_bias_tile_arithmetic_within_one_ulp(key_tile):
    """The bias tile's order (scale after the product, fq then fk added one
    f32 rounding at a time, exp of s - m, P in bf16 hi + lo) at head dim
    384 with biases near +-1.4e3 that cancel is within one bf16 ulp of the
    magnitude of the dense f64 oracle, and its lse within ``K_LSE_ATOL``,
    at either key-tile width the design could take (it takes 64)."""
    B, S, H, dh = 1, 256, 2, 384
    q, k, v, fq, fk = _bias_inputs(28, B, S, S, H, H, dh)
    assert float(fq.abs().max()) > 1.2e3 and float(fk.abs().max()) > 1.2e3
    got, lse = _bias_emulation(q, k, v, fq, fk, 0, S, key_tile)
    want, want_lse = _dense_f64(q, k, v, 0, S, (fq, fk), lse=True)
    tol = bf16_ulp(magnitude(q, k, v, 0, S, (fq, fk)))
    diff = np.abs(_np(got) - want)
    assert (diff <= tol).all(), (diff / tol).max()
    assert np.abs(_np(lse) - want_lse).max() <= K_LSE_ATOL


# (tile, dtype, dh, B, Sq, Skv, H, Hkv, q_offset, kv_valid): each tile's
# cases, with the tile the dispatch must pick
_CUDA = [
    # tensor-core tile: Sq not a multiple of 64, chunked prefill, kv_valid
    # < Skv, G 1 / 3 / 4 / 8, Sq * G = 9 just past the decode line
    ("flash", "bfloat16", 128, 2, 200, 230, 8, 2, 0, 200),
    ("flash", "bfloat16", 128, 2, 37, 300, 8, 2, 100, 137),
    ("flash", "bfloat16", 64, 2, 130, 130, 4, 4, 0, 130),
    ("flash", "bfloat16", 64, 2, 70, 260, 8, 8, 190, 250),
    ("flash", "bfloat16", 128, 1, 100, 180, 8, 1, 60, 150),
    ("flash", "bfloat16", 64, 1, 9, 80, 2, 2, 50, 59),
    ("flash", "bfloat16", 128, 3, 3, 70, 6, 2, 60, 63),
    # more 128-row tiles (252) than SMs
    ("flash", "bfloat16", 64, 2, 1000, 1100, 16, 2, 50, 1040),
    # split-KV decode tile: Sq * G = 8 and below, kv_valid < Skv, a run
    # that holds only keys masked for row 0 (kend 129: the third run is
    # key 128 alone, after row 0's position 127), kv_valid = 0
    ("flash_decode", "bfloat16", 128, 3, 1, 300, 8, 2, 150, 151),
    ("flash_decode", "bfloat16", 64, 1, 1, 64, 4, 1, 63, 64),
    ("flash_decode", "bfloat16", 128, 2, 1, 2080, 8, 1, 2060, 2061),
    ("flash_decode", "bfloat16", 128, 2, 2, 200, 8, 2, 127, 200),
    ("flash_decode", "bfloat16", 64, 4, 8, 90, 2, 2, 70, 75),
    ("flash_decode", "bfloat16", 128, 2, 1, 100, 4, 4, 80, 0),
    # CUDA-core tile: f32 at every head dim, bf16 at dh 16
    ("flash_cc", "float32", 128, 2, 200, 230, 8, 2, 0, 200),
    ("flash_cc", "float32", 64, 3, 1, 300, 8, 2, 150, 151),
    ("flash_cc", "float32", 16, 2, 70, 260, 8, 8, 190, 250),
    ("flash_cc", "bfloat16", 16, 2, 37, 300, 8, 2, 100, 137),
    ("flash_cc", "bfloat16", 16, 1, 1, 64, 4, 1, 63, 64),
]


@pytest.mark.gpu
def test_cuda_flash_matches_plain():
    """K8 on the card, every tile, against its plain version and the dense
    f64 oracle: bf16 within one bf16 ulp of the magnitude, f32 within atol
    1e-5; each case through the tile the dispatch names, by counter."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for n, (tile, dtype, dh, B, Sq, Skv, H, Hkv, qo, kvv) in enumerate(_CUDA):
        (q, k, v), _ = _inputs(n, B, Sq, Skv, H, Hkv, dh, dtype)
        q, k, v = q.cuda(), k.cuda(), v.cuda()
        before = dict(tflash.LAUNCHES)
        got = tflash.flash_attention(q, k, v, q_offset=qo, kv_valid=kvv)
        want = tflash.flash_attention_plain(q, k, v, q_offset=qo,
                                            kv_valid=kvv)
        torch.cuda.synchronize()
        done = {key: tflash.LAUNCHES[key] - before[key] for key in before}
        expect = {key: 0 for key in before}
        expect[tile] = 1
        if tile == "flash_decode":
            expect["flash_combine"] = 1
        assert done == expect, (n, done)
        oracle = _dense_f64(q.cpu(), k.cpu(), v.cpu(), qo, kvv)
        for what, ref in (("plain", _np(want)), ("f64 oracle", oracle)):
            diff = np.abs(_np(got) - ref)
            if dtype == "float32":
                assert diff.max() <= 1e-5, (n, what, diff.max())
            else:
                tol = bf16_ulp(magnitude(q, k, v, qo, kvv))
                assert (diff <= tol).all(), (n, what, (diff / tol).max())
        if kvv == 0:
            assert not got.any()
        if tile == "flash_decode":
            n_split, _ = tflash.decode_plan(q, k, q_offset=qo,
                                            kv_valid=kvv)
            split = tflash.flash_decode_split_plain(
                q, k, v, q_offset=qo, kv_valid=kvv, n_split=n_split)
            diff = np.abs(_np(got) - _np(split))
            assert (diff <= bf16_ulp(magnitude(q, k, v, qo, kvv))).all(), n


# (dh, B, Sq, Skv, H, Hkv, q_offset, kv_valid): the bias tile's cases -- dh
# 384 with Sq not a multiple of its 64-row block, dh 384 with kv_valid <
# Skv, dh 64 with GQA 8 / 4 and a q_offset
_CUDA_BIAS = [(384, 2, 200, 200, 4, 4, 0, 200),
              (384, 1, 256, 256, 4, 4, 0, 150),
              (64, 2, 130, 146, 8, 4, 16, 146)]


@pytest.mark.gpu
@pytest.mark.parametrize("with_lse", [False, True])
def test_cuda_bias_tile_matches_plain(with_lse):
    """K8's bias tile on the card against its plain version and the dense
    f64 oracle, within one bf16 ulp of the magnitude, each call one launch
    of ``LAUNCHES["flash_bias"]``; with ``lse``, the lse within
    ``K_LSE_ATOL`` of plain's and f64's and the output bit-equal to the
    call without it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for n, (dh, B, Sq, Skv, H, Hkv, qo, kvv) in enumerate(_CUDA_BIAS):
        q, k, v, fq, fk = (t.cuda() for t in _bias_inputs(
            n, B, Sq, Skv, H, Hkv, dh))
        bias = (fq, fk)
        before = dict(tflash.LAUNCHES), dict(tflash.LSE_LAUNCHES)
        if with_lse:
            got, lse = tflash.flash_attention_lse(q, k, v, q_offset=qo,
                                                  kv_valid=kvv, bias_qk=bias)
        else:
            got = tflash.flash_attention(q, k, v, q_offset=qo, kv_valid=kvv,
                                         bias_qk=bias)
        want, want_lse = tflash.flash_attention_plain(
            q, k, v, q_offset=qo, kv_valid=kvv, return_lse=True,
            bias_qk=bias)
        torch.cuda.synchronize()
        for counts, old, want_n in ((tflash.LAUNCHES, before[0], 1),
                                    (tflash.LSE_LAUNCHES, before[1],
                                     int(with_lse))):
            done = {c: counts[c] - old[c] for c in old}
            assert done == {**dict.fromkeys(old, 0), "flash_bias": want_n}, \
                (n, done)
        oracle, oracle_lse = _dense_f64(q, k, v, qo, kvv, bias, lse=True)
        tol = bf16_ulp(magnitude(q, k, v, qo, kvv, bias))
        for what, ref in (("plain", _np(want)), ("f64 oracle", oracle)):
            diff = np.abs(_np(got) - ref)
            assert (diff <= tol).all(), (n, what, (diff / tol).max())
        if with_lse:
            for what, ref in (("plain", _np(want_lse)), ("f64", oracle_lse)):
                d = np.abs(_np(lse) - ref)
                assert d.max() <= K_LSE_ATOL, (n, what, d.max())
            bare = tflash.flash_attention(q, k, v, q_offset=qo, kv_valid=kvv,
                                          bias_qk=bias)
            assert torch.equal(got, bare), n
