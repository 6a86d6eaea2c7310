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
* On a card (``gpu`` marker): the CUDA kernel against its plain version on
  dh 16, 64 and 128, both dtypes, prefill and decode shapes, f32 within
  atol 1e-5 and bf16 within one bf16 ulp of the magnitude.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import repro  # noqa: F401  (enables x64 for the reference)
import jax.numpy as jnp
from repro.kernels.flash import flash_attention_pallas
from repro.models import layers as jlayers

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
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    # bf16 inputs round once, from the same f32 values, in both packages
    t = [torch.from_numpy(a).to(tdt) for a in (q, k, v)]
    j = [jnp.asarray(a, jdt) for a in (q, k, v)]
    return t, j


def bf16_ulp(mag: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each magnitude (8 significant bits)."""
    m = np.maximum(np.abs(mag), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(m)) - 7).astype(np.float32)


def magnitude(q, k, v, q_offset, kv_valid):
    """The attention of |v| in f32: bounds |out| elementwise."""
    return _np(tflash.flash_attention_plain(
        q.float(), k.float(), v.float().abs(), q_offset=q_offset,
        kv_valid=kv_valid))


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


def _dense_f64(q, k, v, q_offset, kv_valid):
    q, k, v = (a.double().numpy() for a in (q, k, v))
    G = q.shape[2] // k.shape[2]
    k, v = np.repeat(k, G, axis=2), np.repeat(v, G, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(q.shape[-1])
    qp = q_offset + np.arange(q.shape[1])[:, None]
    kp = np.arange(k.shape[1])[None, :]
    s = np.where((kp <= qp) & (kp < kv_valid), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v)


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
    as the reference's; options the port has not reached raise."""
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
    with pytest.raises(NotImplementedError, match="item 14"):
        tlayers.flash_attention(q, k, v, q_offset=0, bias_qk=(q, k))
    with pytest.raises(NotImplementedError, match="item 14"):
        tlayers.flash_attention(q, k, v, q_offset=0, return_partial=True)


@pytest.mark.gpu
def test_cuda_flash_matches_plain():
    """K8 on the card against its plain version: dh 16/64/128, f32 and
    bf16, prefill (64-row tiles) and decode (8-row tiles) shapes, with
    offsets, under-filled caches and GQA."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cases = [(2, 200, 230, 8, 2, 0, 200), (2, 37, 300, 8, 2, 100, 137),
             (3, 1, 300, 8, 2, 150, 151), (2, 130, 130, 4, 4, 0, 130),
             (1, 1, 64, 4, 1, 63, 64), (2, 70, 260, 8, 8, 190, 250)]
    launches = dict(tflash.LAUNCHES)
    n = 0
    for dh in (16, 64, 128):
        for dtype in ("float32", "bfloat16"):
            for B, Sq, Skv, H, Hkv, qo, kvv in cases:
                (q, k, v), _ = _inputs(n, B, Sq, Skv, H, Hkv, dh, dtype)
                q, k, v = q.cuda(), k.cuda(), v.cuda()
                got = tflash.flash_attention(q, k, v, q_offset=qo,
                                             kv_valid=kvv)
                want = tflash.flash_attention_plain(q, k, v, q_offset=qo,
                                                    kv_valid=kvv)
                torch.cuda.synchronize()
                diff = np.abs(_np(got) - _np(want))
                if dtype == "float32":
                    assert diff.max() <= 1e-5, (dh, B, Sq, Skv)
                else:
                    tol = bf16_ulp(magnitude(q, k, v, qo, kvv))
                    assert (diff <= tol).all(), (dh, B, Sq, Skv)
                n += 1
    done = {k: tflash.LAUNCHES[k] - launches[k] for k in launches}
    assert done == {"flash": 24, "flash_decode": 12}, done
