"""LM training on the port (``models.layers.moe_block``, K8 under a gradient,
``models.model.forward(mode="train")`` and ``lm_loss``, ``train.optimizer``,
``train.step``, ``train.checkpoint``, ``train.elastic``,
``launch.train``, ``data.indexed_dataset.synthetic_token_stream``) held
against the reference on the CPU, from the same numpy inputs made from a
seed, the reference's weights and AdamW state carried across with
``convert.lm_params_from_arrays`` / ``adamw_state_from_arrays`` (norm
scales and biases randomised first, as in ``test_torch_lm.py``).

Tolerances, each measured on these inputs (largest value seen in
brackets); "ulps of the leaf" are bf16 ulps of the largest magnitude in
the compared tensor:

* ``moe_block`` against the reference run op by op
  (``jax.disable_jit()``), reduced granite (top-2 of 8 experts), reduced
  qwen2-moe (a shared expert) and granite with planted router ties, each
  with an expert over its capacity: the top-k ids equal, the output
  within one bf16 ulp of each entry (granite: equal; qwen2-moe: 1, the
  shared expert's f32 product summed in another order); the VJP's input
  gradient and the router, expert and shared-expert weight gradients
  within one ulp of the leaf (0.16 over three seeds: f32 products summed
  in other orders, and autograd adds a tensor's bf16 gradients in another
  order than JAX); the norm scale's within 6 (3.5: XLA sums the bf16
  products over the tokens in bf16, torch in f32).
* K8's ``FlashAttention`` against ``jax.vjp`` of
  ``repro.models.layers.flash_attention`` (GQA, Skv 200): f32 out within
  2e-6 (6e-7), dq/dk/dv within 2e-6 of the leaf's largest entry (4.3e-7:
  the backward recomputes P from ``lse``, XLA differentiates the
  online-softmax scan); bf16 out within one ulp of the leaf (0.0002),
  gradients within 2 ulps of the leaf (1); ``lse`` within 2e-6 of the
  reference's ``m + log(l)`` (``return_partial=True``; 4.8e-7).
* ``lm_loss`` (S = 40 in chunks of 16, labels -1 and out of range) op by
  op: the loss within 2e-6 relative (0: equal), the input gradient
  within one bf16 ulp of each entry (0), ``lm_head``'s within one (1),
  ``final_ln``'s within 4 ulps of the leaf (2: the bf16 sum over tokens).
* ``optimizer.update`` on random trees: bit for bit (the same f32
  operations in the same order); ``global_grad_norm`` within 3e-7
  relative (1 f32 ulp: a leaf's f32 sum in another order).
* Two steps of ``make_train_step`` against the reference's jitted step on
  the smoke mesh (reduced granite and qwen3-4b, 2 layers, microbatch 1
  and 2): the jit drops bf16 roundings (ROADMAP queue 3), so the layers
  are held op by op above and here: loss within 0.03 (0.011), grad norm
  within 4% (2.7%); after step 1 at most 5% of the parameters differ
  (2.7%), each by at most 2 lr + 2 bf16 ulps (a gradient near 0 changes
  sign: AdamW's first step moves every weight by lr sign(g)); after step
  2 every parameter within 4 lr + 2 ulps; the master weights within 2 lr
  and 4 lr (2.000 and 3.998 lr).
* Checkpoints cross packages bit for bit, both ways.
"""
from __future__ import annotations

import contextlib
import os
import tempfile

import numpy as np
import pytest
import torch

import repro  # noqa: F401  (enables x64 for the reference)
import jax
import jax.numpy as jnp
from repro.configs import get_arch as jget_arch
from repro.configs.reduced import reduce_cfg as jreduce
from repro.data.indexed_dataset import \
    synthetic_token_stream as jsynthetic_token_stream
from repro.launch.mesh import make_smoke_mesh
from repro.models import layers as jlayers
from repro.models import model as JM
from repro.models import sharding as jsharding
from repro.train import checkpoint as jckpt
from repro.train import elastic as jelastic
from repro.train import optimizer as jopt
from repro.train import step as jstep

from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.configs.reduced import reduce_cfg
from repro_torch.core import persist as tpersist
from repro_torch.data.indexed_dataset import synthetic_token_stream
from repro_torch.kernels import flash as tflash
from repro_torch.launch import train as tlaunch
from repro_torch.models import layers as tlayers
from repro_torch.models import model as TM
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import elastic as telastic
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep
from test_torch_lm import _bf16_t, _np, _randomize, _to_jax, ulps
from torch_export import export_lm_params

LR = 1e-2
B, S = 4, 40


def leaf_ulps(got, want) -> float:
    """max |got - want| in bf16 ulps of the larger of the two tensors'
    largest magnitudes."""
    got, want = _np(got), _np(want)
    m = max(np.abs(got).max(), np.abs(want).max(), 2.0 ** -126)
    return float((np.abs(got - want) / 2.0 ** (np.floor(np.log2(m)) - 7))
                 .max())


@contextlib.contextmanager
def eager_reference():
    """Reference layers outside a mesh: no FSDP gather, no batch axes to
    psum the loss over (trace-time switches, put back afterwards)."""
    saved = jsharding._FSDP_GATHER_ON, jsharding.batch_axes()
    jsharding.set_fsdp_gather(False)
    jsharding.set_batch_axes(())
    try:
        yield
    finally:
        jsharding.set_fsdp_gather(saved[0])
        jsharding.set_batch_axes(saved[1])


def carried(arch: str, seed: int = 0, **kw):
    """(reference cfg, port cfg, reference params, port params, numpy
    tree): the reference's random weights, norm scales and biases
    randomised, carried across bit for bit."""
    jc = jreduce(jget_arch(arch), **kw)
    tc = reduce_cfg(get_arch(arch), **kw)
    jp = JM.init_params(jc, jax.random.PRNGKey(seed))
    tree = _randomize(export_lm_params(jp), np.random.default_rng(seed + 1))
    return jc, tc, _to_jax(tree, jp), convert.lm_params_from_arrays(
        tree, tc, device="cpu"), tree


def _grad_leaves(tree):
    return TM.tree_map(lambda t: t.detach().clone().requires_grad_(), tree)


# ---------------------------------------------------------------------------
# the MoE block
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,tie", [("granite-moe-1b-a400m", False),
                                      ("qwen2-moe-a2.7b", False),
                                      ("granite-moe-1b-a400m", True)])
def test_moe_block_forward_and_vjp(arch, tie):
    """One MoE layer and its VJP against the reference op by op: an expert
    over its capacity (its late assignments dropped, their tokens on the
    residual only), and with ``tie`` two pairs of router columns equal, so
    every token's logits tie and ``jax.lax.top_k`` takes the lower index."""
    jc, tc, jp, tp, _ = carried(arch, n_layers=1, d_model=64, vocab=256)
    jf = jax.tree.map(lambda t: t[0], jp["sb"])["pos0"]["ffn"]
    tf = TM.tree_map(lambda t: t[0], tp["sb"])["pos0"]["ffn"]
    assert type(tf).__name__ == type(jf).__name__ == "MoEParams"
    assert (tf.sh_gate is not None) == bool(jc.moe.n_shared)
    if tie:
        r = np.asarray(jf.router).copy()
        r[:, 5], r[:, 6] = r[:, 1], r[:, 2]
        jf = jf._replace(router=jnp.asarray(r))
        tf = tf._replace(router=tf.router.clone())
        tf.router[:, 5], tf.router[:, 6] = tf.router[:, 1], tf.router[:, 2]
    rng = np.random.default_rng(7)
    # a direction shared by every token skews the routing past capacity
    x = (rng.normal(size=(2, 24, 64)) + 0.3 * rng.normal(size=64)) \
        .astype(jnp.bfloat16)
    ct = rng.normal(size=(2, 24, 64)).astype(jnp.bfloat16)

    # routing: the top-k ids equal the reference's, ties to the lower
    # index, and some expert is over its capacity C
    h = tlayers.rms_norm(_bf16_t(x), tf.ln, tc.norm_eps).reshape(48, 64)
    logits = tlayers.matmul_f32(h, tf.router)
    _, top = tlayers.top_k(logits, tc.moe.top_k)
    _, jtop = jax.lax.top_k(jnp.asarray(logits.numpy()), tc.moe.top_k)
    np.testing.assert_array_equal(top.numpy(), np.asarray(jtop))
    if tie:
        lg, t = logits.numpy(), top.numpy()
        assert (lg[:, 1] == lg[:, 5]).all() and (lg[:, 2] == lg[:, 6]).all()
        assert np.isin(t, [1, 2]).any()
        for lo, hi in ((1, 5), (2, 6)):     # hi only after lo, as a tie
            assert ((t == lo).any(-1) | ~(t == hi).any(-1)).all()
            first = np.argmax(t == lo, -1) < np.argmax(t == hi, -1)
            assert first[(t == hi).any(-1)].all()
    C = max(int(48 * tc.moe.top_k * 1.25 / tc.moe.n_experts), 4)
    assert np.bincount(top.numpy().ravel(), minlength=8).max() > C

    with eager_reference(), jax.disable_jit():
        want, vjp = jax.vjp(
            lambda p, x: jlayers.moe_block(p, x, jc, tp_shard=False), jf,
            jnp.asarray(x))
        jg, jgx = vjp(jnp.asarray(ct))
    tpf = _grad_leaves(tf)
    tx = _bf16_t(x).clone().requires_grad_()
    got = tlayers.moe_block(tpf, tx, tc, tp_shard=False)
    assert got.dtype == torch.bfloat16
    assert ulps(got, want).max() <= 1
    got.backward(_bf16_t(ct))
    assert leaf_ulps(tx.grad, jgx) <= 1
    for f in tf._fields:
        if getattr(tf, f) is not None:
            g, w = getattr(tpf, f).grad, getattr(jg, f)
            assert leaf_ulps(g, w) <= (6 if f == "ln" else 1), f


# ---------------------------------------------------------------------------
# K8 under a gradient
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_function_matches_reference_vjp(dtype):
    """``FlashAttention`` (the plain forward with ``lse``, the torch-op
    backward) against ``jax.vjp`` of the reference's jnp attention: GQA 4
    over 2 heads, Skv = 200 (not a multiple of 128), dh 16."""
    rng = np.random.default_rng(3)
    shp = {"q": (2, 200, 4, 16), "k": (2, 200, 2, 16), "v": (2, 200, 2, 16),
           "do": (2, 200, 4, 16)}
    arr = {n: rng.normal(size=s).astype(np.float32) for n, s in shp.items()}
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ja = {n: jnp.asarray(a, jdt) for n, a in arr.items()}
    ta = {n: torch.from_numpy(a).to(tdt) for n, a in arr.items()}
    zero = jnp.zeros((), jnp.int32)
    want, vjp = jax.vjp(lambda q, k, v: jlayers.flash_attention(
        q, k, v, q_offset=zero), ja["q"], ja["k"], ja["v"])
    jgrads = vjp(ja["do"])
    m, l, _ = jlayers.flash_attention(ja["q"], ja["k"], ja["v"],
                                      q_offset=zero, return_partial=True)
    q, k, v = (ta[n].clone().requires_grad_() for n in "qkv")
    got = tflash.flash_attention(q, k, v, q_offset=0)
    assert got.grad_fn is not None and got.dtype == tdt
    got.backward(ta["do"])
    _, lse = tflash.flash_attention_lse(ta["q"], ta["k"], ta["v"],
                                        q_offset=0)
    np.testing.assert_allclose(_np(lse), np.asarray(m + jnp.log(l)), rtol=0,
                               atol=2e-6)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=2e-6)
        for t, w in zip((q, k, v), jgrads, strict=True):
            d = np.abs(_np(t.grad) - _np(w)).max()
            assert d <= 2e-6 * np.abs(_np(w)).max(), d
    else:
        assert leaf_ulps(got, want) <= 1
        for t, w in zip((q, k, v), jgrads, strict=True):
            assert t.grad.dtype == torch.bfloat16
            assert leaf_ulps(t.grad, w) <= 2


def test_flash_bwd_blocks_and_masks(monkeypatch):
    """The backward's query blocks are a partition: any ``BWD_Q_BLOCK``
    gives the same gradients, also with ``q_offset`` and ``kv_valid``
    (decode shapes), against f64 autograd of a dense softmax."""
    import math
    rng = np.random.default_rng(4)
    q, k, v, do = (torch.from_numpy(rng.normal(size=s)) for s in (
        (2, 9, 4, 16), (2, 70, 2, 16), (2, 70, 2, 16), (2, 9, 4, 16)))
    qo, kvv = 55, 60
    _, lse = tflash.flash_attention_lse(q.float(), k.float(), v.float(),
                                        q_offset=qo, kv_valid=kvv)
    outs = []
    for block in (2, 5, 256):
        monkeypatch.setattr(tflash, "BWD_Q_BLOCK", block)
        outs.append(tflash.flash_attention_bwd(
            q.float(), k.float(), v.float(), do.float(), lse, q_offset=qo,
            kv_valid=kvv))
    for o in outs[1:]:
        for a, b in zip(o, outs[0], strict=True):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-6)
    qd, kd, vd = (t.clone().requires_grad_() for t in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd.repeat_interleave(2, 2)) \
        / math.sqrt(16)
    keep = (torch.arange(70)[None] <= qo + torch.arange(9)[:, None]) & \
        (torch.arange(70)[None] < kvv)
    p = torch.softmax(s.masked_fill(~keep, float("-inf")), -1)
    torch.einsum("bhqk,bkhd->bqhd", p, vd.repeat_interleave(2, 2)) \
        .backward(do)
    for a, b in zip(outs[0], (qd.grad, kd.grad, vd.grad), strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=2e-5)


# ---------------------------------------------------------------------------
# the loss and the train-mode forward
# ---------------------------------------------------------------------------
def test_lm_loss_and_grad(monkeypatch):
    """``lm_loss`` and its VJP against the reference op by op: S = 40 in
    chunks of 16 (the last padded with label -1), labels of -1 and past the
    vocabulary among them; no product wider than a chunk."""
    jc, tc, jp, tp, _ = carried("granite-moe-1b-a400m", n_layers=1,
                                d_model=64, vocab=256)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(B, S, 64)).astype(jnp.bfloat16)
    lab = rng.integers(-1, 256, (B, S)).astype(np.int32)
    lab[0, :5] = [-1, 255, 256, 300, -1]        # outside the table: no nll
    with eager_reference(), jax.disable_jit():
        want, vjp = jax.vjp(lambda p, x: JM.lm_loss(
            p, jc, x, jnp.asarray(lab), False, seq_chunk=16), jp,
            jnp.asarray(x))
        jg, jgx = vjp(jnp.ones((), jnp.float32))
    widths = []
    real = tlayers.matmul_f32

    def spy(a, w):
        widths.append(a.shape[1])
        return real(a, w)
    monkeypatch.setattr(tlayers, "matmul_f32", spy)
    ps = _grad_leaves(tp)
    tx = _bf16_t(x).clone().requires_grad_()
    got = TM.lm_loss(ps, tc, tx, torch.from_numpy(lab), False, seq_chunk=16)
    got.backward()
    assert got.dtype == torch.float32
    assert abs(float(got.detach()) - float(want)) <= 2e-6 * abs(float(want))
    assert set(widths) == {16}      # the forward and the recompute, by chunk
    assert ulps(tx.grad, jgx).max() <= 1
    assert ulps(ps["lm_head"].grad, jg["lm_head"]).max() <= 1
    assert leaf_ulps(ps["final_ln"].grad, jg["final_ln"]) <= 4
    assert ps["embed"].grad is None


def test_train_forward_remat_bit_equal(monkeypatch):
    """``forward(mode="train")`` with and without remat: the same loss and
    bit-equal gradients; with remat K8's forward runs twice a layer (the
    recompute in the backward), without it once."""
    _, tc, _, tp, _ = carried("granite-moe-1b-a400m", n_layers=2, d_model=64,
                              vocab=256)
    rng = np.random.default_rng(9)
    toks = torch.from_numpy(rng.integers(0, 256, (2, 33)).astype(np.int32))
    pos = torch.arange(32, dtype=torch.int32)[None].expand(2, 32)
    calls = [0]
    real = tflash.flash_attention_lse

    def count(*a, **k):
        calls[0] += 1
        return real(*a, **k)
    monkeypatch.setattr(tflash, "flash_attention_lse", count)
    out = {}
    for remat in (True, False):
        calls[0] = 0
        ps = _grad_leaves(tp)
        x, caches = TM.forward(ps, tc, toks[:, :-1], pos=pos, mode="train",
                               remat=remat)
        assert caches is None and x.dtype == torch.bfloat16
        loss = TM.lm_loss(ps, tc, x, toks[:, 1:], False)
        grads = torch.autograd.grad(loss, topt.leaves(ps))
        out[remat] = (loss.detach(), grads, calls[0])
    assert out[True][2] == 2 * tc.n_layers and out[False][2] == tc.n_layers
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(out[True][1], out[False][1], strict=True):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------
def test_optimizer_update_and_grad_norm():
    """Two AdamW updates (the second clipped) and the global norm against
    the reference's, bit for bit, on a params tree with a stacked leaf."""
    rng = np.random.default_rng(10)

    def tree(f):
        return {"a": f((3, 5)), "sb": {"w": f((2, 4, 6)), "z": f((7,))},
                "b": f((9,))}
    p0 = tree(lambda s: rng.normal(size=s).astype(jnp.bfloat16))
    jp = jax.tree.map(jnp.asarray, p0)
    tp = TM.tree_map(lambda a: _bf16_t(a).clone(), p0)
    jo, to = jopt.init(jp), topt.init(tp)
    for i, scale in enumerate((1.0, 0.37)):
        g = tree(lambda s: (rng.normal(size=s) * 10.0 ** rng.integers(
            -9, 1, s)).astype(jnp.bfloat16))
        jg, tg = jax.tree.map(jnp.asarray, g), TM.tree_map(_bf16_t, g)
        sq = sum(jnp.sum(x.astype(jnp.float32) ** 2)
                 for x in jax.tree.leaves(jg))
        np.testing.assert_allclose(topt.global_grad_norm(tg).numpy(),
                                   np.asarray(jnp.sqrt(sq)), rtol=3e-7)
        jp, jo = jopt.update(jp, jg, jo, lr=LR, scale=jnp.float32(scale))
        tp, to = topt.update(tp, tg, to, lr=LR,
                             scale=torch.tensor(scale, dtype=torch.float32))
        assert int(to.step) == int(jo.step) == i + 1
        for a, b in zip(topt.leaves({"0": tp, "1": to.mu, "2": to.nu,
                                     "3": to.master}),
                        jax.tree.leaves((jp, jo.mu, jo.nu, jo.master)),
                        strict=True):
            np.testing.assert_array_equal(_np(a), _np(b))


# ---------------------------------------------------------------------------
# the train step against the reference's jitted step
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref_steps():
    """The reference's jitted train steps on the smoke mesh, built once a
    (arch, microbatch) and compiled at their first call."""
    mesh = make_smoke_mesh()
    made = {}

    def get(jc, mb):
        key = (jc.name, mb)
        if key not in made:
            made[key] = jstep.make_train_step(jc, mesh, lr=LR, donate=False,
                                              microbatch=mb)[0]
        return made[key]
    yield get
    jsharding.set_fsdp_gather(True)


@pytest.mark.parametrize("microbatch", [1, 2])
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "qwen3-4b"])
def test_train_step_matches_reference(ref_steps, arch, microbatch):
    jc, tc, jp, tp, tree = carried(arch, n_layers=2, d_model=64, vocab=256)
    jo = jopt.init(jp)
    to = convert.adamw_state_from_arrays(export_lm_params(jo), tc,
                                         device="cpu")
    fn = ref_steps(jc, microbatch)
    tfn = tstep.make_train_step(tc, lr=LR, microbatch=microbatch)
    rng = np.random.default_rng(11)
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    res = jnp.zeros(())
    saved = jsharding._FSDP_GATHER_ON, jsharding.batch_axes()
    for i in range(2):
        toks = rng.integers(0, 256, (B, S + 1)).astype(np.int32)
        args = toks[:, :-1], toks[:, 1:], pos
        jp, jo, res, jm = fn(jp, jo, res, *map(jnp.asarray, args))
        tp, to, tm = tfn(tp, to, *map(torch.from_numpy, args))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 0.03
        assert abs(float(tm["grad_norm"]) / float(jm["grad_norm"]) - 1) \
            <= 0.04
        assert int(to.step) == int(jo.step) == i + 1
        moved, n = 0, 0
        for a, b, ma, mb in zip(topt.leaves(tp), jax.tree.leaves(jp),
                                topt.leaves(to.master),
                                jax.tree.leaves(jo.master), strict=True):
            a, b, ma, mb = _np(a), _np(b), _np(ma), _np(mb)
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(b), 2.0 ** -126)))
                          - 7)
            assert (np.abs(a - b) <= 2 * (i + 1) * LR * 1.001 + 2 * ulp).all()
            assert np.abs(ma - mb).max() <= 2 * (i + 1) * LR * 1.001
            moved += int((a != b).sum())
            n += a.size
        if i == 0:
            assert moved <= 0.05 * n, moved / n
    jsharding.set_fsdp_gather(saved[0])
    jsharding.set_batch_axes(saved[1])


def test_step_rules():
    tc = reduce_cfg(get_arch("granite-moe-1b-a400m"))
    # the pod compression and the psum dtype act on a mesh's collectives
    # (test_torch_train_mesh.py)
    with pytest.raises(ValueError, match="mesh="):
        tstep.make_train_step(tc, compress_pod=True)
    with pytest.raises(ValueError, match="mesh="):
        tstep.make_train_step(tc, psum_dtype=torch.bfloat16)
    assert tstep.batch_shapes(tc, 8, 128)["inputs"] == ((8, 128),
                                                        torch.int32)
    from repro.configs.base import SHAPES
    # the reference's shapes and dtypes: frame embeddings (B, S, d) bf16
    # for musicgen, (3, B, S) ids for qwen2-vl's M-RoPE
    for arch in ("musicgen-large", "qwen2-vl-72b", "qwen3-4b"):
        for shape in SHAPES.values():
            want = jstep.batch_shapes(jget_arch(arch), shape)
            got = tstep.batch_shapes(get_arch(arch), shape.global_batch,
                                     shape.seq_len)
            assert set(got) == set(want)
            for k, w in want.items():
                assert got[k][0] == tuple(w.shape), (arch, k)
                assert str(got[k][1]) == f"torch.{w.dtype}", (arch, k)
    for arch in ("granite-moe-1b-a400m", "qwen3-4b", "yi-9b"):
        for shape in SHAPES.values():
            jc = jget_arch(arch)
            want = jstep.auto_microbatch(jc, shape, make_smoke_mesh())
            assert tstep.auto_microbatch(get_arch(arch), shape.global_batch,
                                         shape.seq_len) == want
    with pytest.raises(ValueError, match="multiple"):
        tstep.make_train_step(tc, microbatch=3)(
            None, None, torch.zeros(4, 8, dtype=torch.int32), None, None)


# ---------------------------------------------------------------------------
# data, elastic controller, entry point
# ---------------------------------------------------------------------------
def test_synthetic_token_stream_equal():
    a, b = jsynthetic_token_stream(5, 300, 3, 17), \
        synthetic_token_stream(5, 300, 3, 17)
    for _ in range(3):
        (ja, jl), (ta, tl) = next(a), next(b)
        assert ta.dtype == tl.dtype == np.int32 and ta.shape == (3, 17)
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tl, jl)


def _elastic_run(cls):
    """The reference's fake-clock scenarios (``tests/test_runtime.py``):
    every plan and query, in order."""
    out, t = [], [0.0]
    ctl = cls(n_hosts=4, heartbeat_timeout=10.0, clock=lambda: t[0])
    for h in range(4):
        for _ in range(6):
            ctl.heartbeat(h, step_time=1.0)
    out.append(ctl.plan())
    for _ in range(6):
        ctl.heartbeat(3, step_time=3.5)
    out.append(ctl.plan())
    t[0] = 20.0
    for h in (0, 1, 3):
        ctl.heartbeat(h, step_time=1.0)
    t[0] = 29.0
    out += [ctl.plan(), ctl.generation]
    ctl.heartbeat(2, step_time=1.0)
    out += [ctl.plan(), ctl.plan(), ctl.generation]
    for _ in range(20):
        ctl.heartbeat(0, step_time=9.0)
    t[0] = 45.0
    for h in (1, 2, 3):
        ctl.heartbeat(h, step_time=1.0)
    out += [ctl.stragglers(), ctl.dead_hosts(), ctl.plan(), sorted(ctl.hosts)]
    return out


def test_elastic_controller_matches_reference():
    got = _elastic_run(telastic.ElasticController)
    assert got == _elastic_run(jelastic.ElasticController)
    assert got[1] == {"action": "reassign_data", "hosts": [3]}
    assert got[2]["action"] == "remesh" and got[2]["survivors"] == 3


def test_launch_train_cpu_loss_falls():
    """``launch.train.train`` on the CPU: reduced granite trains, the loss
    falls, every step's numbers come back; on a machine without a card the
    same call without ``device=`` raises."""
    seen = []
    res = tlaunch.train("granite-moe-1b-a400m", steps=8, batch=4, seq=32,
                        lr=1e-2, reduced=True, ckpt_dir=None, d_model=64,
                        n_layers=2, log_every=3, device="cpu",
                        on_step=lambda s, p, o, m: seen.append(s))
    assert seen == list(range(8)) and len(res.losses) == 8
    assert all(np.isfinite(res.losses)) and res.losses[-1] < res.losses[0]
    assert len(res.step_s) == len(res.grad_norms) == 8
    assert res.tokens_per_s > 0 and int(res.opt.step) == 8
    cfg = tlaunch.train_config("granite-moe-1b-a400m", reduced=False,
                               n_layers=4)
    assert (cfg.n_layers, cfg.d_model, cfg.tp_shard) == (4, 1024, False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tlaunch.train("granite-moe-1b-a400m", steps=1, batch=1, seq=8,
                          lr=1e-3, reduced=True, ckpt_dir=None)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def test_checkpoints_cross_packages():
    """A reference ``Checkpointer`` save of reduced params and an AdamW
    state after one update restores in the port bit for bit, and the port's
    save restores in the reference; the template is left as it was.
    qwen2-moe's tree and musicgen's, which has no ``embed`` leaf."""
    for arch in ("qwen2-moe-a2.7b", "musicgen-large"):
        _checkpoint_round_trip(arch)


def _checkpoint_round_trip(arch: str) -> None:
    jc, tc, jp, tp, _ = carried(arch, n_layers=2, d_model=64, vocab=256)
    assert ("embed" in tp) is not tc.embed_input
    rng = np.random.default_rng(12)
    g = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape),
                                           p.dtype), jp)
    jp, jo = jopt.update(jp, g, jopt.init(jp), lr=LR)
    arrays = export_lm_params({"params": jp, "opt": jo})
    tp = convert.lm_params_from_arrays(arrays["params"], tc, device="cpu")
    to = convert.adamw_state_from_arrays(arrays["opt"], tc, device="cpu")
    jleaves = jax.tree.leaves({"params": jp, "opt": jo})
    with tempfile.TemporaryDirectory() as d:
        jckpt.Checkpointer(os.path.join(d, "ref")).save(
            3, {"params": jp, "opt": jo}, blocking=True)
        zeros = TM.tree_map(torch.zeros_like, {"params": tp, "opt": to})
        back = tckpt.Checkpointer(os.path.join(d, "ref")).restore(
            3, zeros, device="cpu")
        assert all(not t.any() for t in topt.leaves(zeros))
        got = topt.leaves(back)
        assert len(got) == len(jleaves)
        for a, b in zip(got, jleaves, strict=True):
            assert a.dtype == {"bfloat16": torch.bfloat16,
                               "float32": torch.float32,
                               "int32": torch.int32}[str(b.dtype)]
            np.testing.assert_array_equal(_np(a), _np(b))
        ck = tckpt.Checkpointer(os.path.join(d, "port"))
        ck.save(4, {"params": tp, "opt": to})
        ck.wait()
        assert ck.latest_step() == 4
        template = jax.tree.map(jnp.zeros_like, {"params": jp, "opt": jo})
        jback = jckpt.Checkpointer(os.path.join(d, "port")).restore(
            4, template)
        for a, b in zip(jax.tree.leaves(jback), jleaves, strict=True):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        # a mesh restore needs both the mesh and the specs
        # (test_torch_train_mesh.py restores onto meshes)
        with pytest.raises(ValueError, match="both or neither"):
            ck.restore(4, zeros, mesh=object())


def test_checkpoint_failure_and_gc(monkeypatch):
    """A failed async write re-raises from ``wait()`` (nothing committed),
    then from nowhere else; only ``keep`` steps stay."""
    x = {"w": torch.arange(8.0), "b": torch.ones(3, dtype=torch.bfloat16)}
    real = tpersist._write_bytes

    def fail(path, data):
        raise OSError(f"injected failure on {path}")
    with tempfile.TemporaryDirectory() as d:
        ck = tckpt.Checkpointer(d)
        monkeypatch.setattr(tpersist, "_write_bytes", fail)
        ck.save(1, x)
        with pytest.raises(IOError, match="async snapshot write failed"):
            ck.wait()
        assert ck.latest_step() is None
        monkeypatch.setattr(tpersist, "_write_bytes", real)
        ck.save(2, x)
        ck.wait()
        assert ck.latest_step() == 2
    with tempfile.TemporaryDirectory() as d:
        ck = tckpt.Checkpointer(d, keep=2)
        for s in (1, 2, 3, 4):
            x["w"] += 1                 # a save copies its leaves at once
            ck.save(s, x)
        ck.wait()
        assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004"]
        back = ck.restore(3, x, device="cpu")
        np.testing.assert_array_equal(back["w"].numpy(),
                                      np.arange(8.0) + 3)
        assert back["b"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_cuda_flash_lse_and_grad():
    """On a card: the tensor-core tile (bf16, dh 64) and the CUDA-core tile
    (f32, dh 16) with their ``lse`` output against the plain version
    (lse within 2e-6 relative, out within one bf16 ulp of the magnitude /
    1e-5), the same tile launched without ``lse`` bit-equal, and the
    gradients against f64 autograd within 2 ulps of the leaf."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import math
    dev = torch.device("cuda")
    for dtype, dh, tile in ((torch.bfloat16, 64, "flash"),
                            (torch.float32, 16, "flash_cc")):
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        q, k, v, do = (torch.randn(s, generator=g, device=dev).to(dtype)
                       for s in ((2, 300, 4, dh), (2, 300, 2, dh),
                                 (2, 300, 2, dh), (2, 300, 4, dh)))
        tflash.reset_launches()
        out, lse = tflash.flash_attention_lse(q, k, v, q_offset=0)
        assert tflash.LSE_LAUNCHES[tile] == tflash.LAUNCHES[tile] == 1
        assert torch.equal(out, tflash.flash_attention(q, k, v, q_offset=0))
        ref, rlse = tflash.flash_attention_plain(q, k, v, q_offset=0,
                                                 return_lse=True)
        assert ((lse - rlse).abs() <= 2e-6 * rlse.abs().clamp_min(1)).all()
        qd, kd, vd = (t.double().requires_grad_() for t in (q, k, v))
        s = torch.einsum("bqhd,bkhd->bhqk", qd, kd.repeat_interleave(2, 2)) \
            / math.sqrt(dh)
        keep = torch.ones(300, 300, dtype=torch.bool, device=dev).tril()
        p = torch.softmax(s.masked_fill(~keep, float("-inf")), -1)
        torch.einsum("bhqk,bkhd->bqhd", p, vd.repeat_interleave(2, 2)) \
            .backward(do.double())
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
        tflash.flash_attention(qg, kg, vg, q_offset=0).backward(do)
        for a, b in ((qg, qd), (kg, kd), (vg, vd)):
            assert a.grad.dtype == dtype
            assert leaf_ulps(a.grad, b.grad) <= 2
