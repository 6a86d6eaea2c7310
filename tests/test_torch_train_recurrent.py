"""Training through the recurrent families on the port: K8's bias form under
a gradient (``kernels.flash.FlashAttention`` with ``bias_qk``), the Mamba
scan's train form (``models.ssm._ssm_scan``: each chunk checkpointed), the
mLSTM and sLSTM blocks under a gradient, JAX's derivatives of the
activations and of ``jnp.cumsum``, and ``make_train_step`` on reduced
xlstm-125m and jamba-v0.1-52b, held against the reference on the CPU from
the same numpy inputs made from a seed, random weights carried into both
packages as numpy arrays (``convert.lm_params_from_arrays``; norm scales
and biases randomised first, as in ``test_torch_lm.py``).

Tolerances, each measured on these inputs (largest value seen in
brackets); "ulps of the leaf" are bf16 ulps of the largest magnitude in
the compared tensor.  The reference runs jitted and compiled without
excess precision (``compiler_options={"xla_allow_excess_precision":
False}``, so that the jit keeps the bf16 roundings the code writes, as
``test_torch_recurrent.py`` compiles the serving steps):

* K8's bias form (bf16 q, k, v; f32 biases F_t and i_s - F_s of a gated
  cumsum, up to 4.3e2, that cancel) against ``jax.vjp`` of
  ``repro.models.layers.flash_attention(bias_qk=)`` and f64 autograd of a
  dense biased softmax, in three cases (GQA 4 over 2 heads; ``kv_valid <
  Skv``; Sq = 300, across two of the backward's 256-row blocks): the
  output within one ulp of the leaf (0.125); dq, dk, dv within
  ``BIAS_GRAD_ULPS`` = 2 ulps of the leaf of the reference's (1.0) and of
  f64's (0.49; the reference's own 0.80); dfq and dfk, the sums of dS over
  keys and over queries (dfq is 0 in exact arithmetic: a row's constant
  cancels in its softmax), within ``BIAS_SUM_RTOL`` = 2e-4 of the largest
  such sum of |dS| from f64's (2.2e-5: P is recomputed from an f32
  ``lse`` of about 4e2; the reference's 4.8e-6); keys at or past
  ``kv_valid`` exactly 0.  ``lse`` within 2e-6 of the reference's ``m +
  log(l)`` relative to its largest entry; the backward's query blocks a
  partition (any ``BWD_Q_BLOCK``: the same gradients within 1e-6).
* ``_ssm_scan``'s train form (S = 24 in chunks of 8) against ``jax.vjp``
  of the reference's: y, the final state and all seven gradients within
  ``SCAN_RTOL`` = 1e-5 of the leaf's largest entry (2.3e-7); with and
  without the chunk checkpoint bit for bit.
* ``mlstm_block`` and ``slstm_block`` (S = 16) under ``jax.vjp`` (Mamba's
  is the scan's above and jamba's train step below): the output within
  ``BLOCK_ULPS`` = 2 ulps of the row (0), as ``test_torch_recurrent.py``
  holds it, and the input's and every weight's gradient within
  ``BLOCK_GRAD_ULPS`` = 4 ulps of the leaf (3.0, a norm scale's: XLA sums
  the bf16 products over the tokens in bf16; the input's 0.25).  ``_SLSTMLoop``'s hand-written
  backward also against autograd of its loop in f64, within 1e-10 of each
  leaf's largest entry.
* ``softplus``, ``log_sigmoid``, ``sigmoid`` and ``silu`` against
  ``jax.nn`` and ``jax.grad``: at 0, -0, +-1e-8, +-30, +-inf and NaN values
  and gradients bit for bit; on 4,000 draws of N(0, 64) values within
  ``ACT_ULPS`` = 4 f32 ulps (2.0) and gradients within ``ACT_GRAD_ULPS`` =
  16 (8.0: XLA:CPU's exp and log1p round differently from torch's).  The
  gradient of ``jnp.cumsum`` (``core.cdf.PrefixSum``) bit for bit at 1 to
  2,049 steps.
* Two steps of ``make_train_step`` against the reference's jitted step on
  the smoke mesh, reduced xlstm-125m (one superblock: an mLSTM and an
  sLSTM layer, d_model 64) and jamba (one superblock of 8 layers, d_model
  64), B 2 x S 32, each step from the same state on both sides: loss
  within ``STEP_LOSS_TOL`` = 0.01 (xlstm 4.8e-7, jamba 8.2e-5), grad norm
  within ``STEP_GNORM_RTOL`` = 2% (1.6e-5, 0.16%); every parameter within
  2 lr + 2 bf16 ulps of the reference's and the master weights within 2
  lr (2.00 and 2.00 lr: a gradient near 0 flips AdamW's move); after the
  first step at most ``STEP_MOVED`` = 5% of the parameters differ (0.03%,
  0.44%).
* ``forward(mode="train")`` with remat against without: loss and
  gradients bit for bit; the recompute runs each sLSTM loop and each
  mLSTM's K8 call (bias form, with ``lse``) a second time.

The file takes 56-60 s alone on an 8-core CPU host: the
reference's jamba step traces in 10 s and compiles in 14.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import repro  # noqa: F401  (enables x64 for the reference)
import jax
import jax.numpy as jnp
from repro.configs import get_arch as jget_arch
from repro.configs.reduced import reduce_cfg as jreduce
from repro.launch.mesh import make_smoke_mesh
from repro.models import layers as jlayers
from repro.models import model as JM
from repro.models import sharding as jsharding
from repro.models import ssm as jssm
from repro.models import xlstm as jxl
from repro.train import optimizer as jopt
from repro.train import step as jstep

from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.configs.reduced import reduce_cfg
from repro_torch.core import cdf as tcdf
from repro_torch.kernels import flash as tflash
from repro_torch.models import layers as tlayers
from repro_torch.models import model as TM
from repro_torch.models import ssm as tssm
from repro_torch.models import xlstm as txl
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep
from test_torch_lm import (_bf16_np, _np, _randomize, _to_jax,
                           no_fsdp_gather, ulps)
from torch_export import export_lm_params

BIAS_GRAD_ULPS = 2
BIAS_SUM_RTOL = 2e-4
SCAN_RTOL = 1e-5
BLOCK_ULPS = 2
BLOCK_GRAD_ULPS = 4
STEP_LOSS_TOL = 0.01
STEP_GNORM_RTOL = 0.02
STEP_MOVED = 0.05
ACT_ULPS = 4
ACT_GRAD_ULPS = 16
LR = 1e-2
REDUCED = {"xlstm-125m": dict(n_layers=2, d_model=64, vocab=256),
           "jamba-v0.1-52b": dict(d_model=64, vocab=256)}
# XLA compiles without excess precision: the bf16 roundings the code writes
EXACT = {"xla_allow_excess_precision": False}


def _exact_jit(fn, *args):
    """``fn`` jitted and compiled without excess precision, called on
    ``args`` as jax arrays."""
    ja = jax.tree.map(jnp.asarray, args)
    return jax.jit(fn).lower(*ja).compile(compiler_options=EXACT)(*ja)


def leaf_ulps(got, want) -> float:
    """max |got - want| in bf16 ulps of the larger of the two tensors'
    largest magnitudes (``test_torch_train.leaf_ulps``)."""
    got, want = _np(got), _np(want)
    m = max(np.abs(got).max(), np.abs(want).max(), 2.0 ** -126)
    return float((np.abs(got - want) / 2.0 ** (np.floor(np.log2(m)) - 7))
                 .max())


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# K8's bias form under a gradient
# ---------------------------------------------------------------------------
def _bias_case(seed, B, Sq, H, Hkv, dh):
    """bf16 q, k, v, do and the mLSTM's bias terms of random gates (fq =
    F_t, fk = i_s - F_s, F the cumsum of log_sigmoid(N(-1, 1)))."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, H, dh))
    k = rng.normal(size=(B, Sq, Hkv, dh)) / np.sqrt(dh)
    v = rng.normal(size=(B, Sq, Hkv, dh))
    do = rng.normal(size=(B, Sq, H, dh))
    f_cum = np.cumsum(-np.logaddexp(0.0, -(rng.normal(size=(B, Sq, H))
                                           - 1.0)), 1)
    ig = rng.normal(size=(B, Sq, H))
    bf = [a.astype(np.float32).astype(jnp.bfloat16) for a in (q, k, v, do)]
    return (*bf, f_cum.astype(np.float32), (ig - f_cum).astype(np.float32))


def _dense_f64(q, k, v, fq, fk, do, kv_valid):
    """f64 autograd of the dense biased softmax: (out, dq, dk, dv, dS)."""
    G = q.shape[2] // k.shape[2]
    t = [torch.from_numpy(np.asarray(a, np.float64)).requires_grad_()
         for a in (q, k, v)]
    s = torch.einsum("bqhd,bkhd->bhqk", t[0], t[1].repeat_interleave(G, 2)) \
        / np.sqrt(q.shape[-1])
    s = s + torch.from_numpy(fq.astype(np.float64)).transpose(1, 2)[..., None] \
        + torch.from_numpy(fk.astype(np.float64)).transpose(1, 2)[:, :, None]
    s.retain_grad()
    Sq, Skv = q.shape[1], k.shape[1]
    keep = (torch.arange(Skv)[None] <= torch.arange(Sq)[:, None]) & \
        (torch.arange(Skv) < kv_valid)[None]
    p = torch.softmax(s.masked_fill(~keep, float("-inf")), -1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, t[2].repeat_interleave(G, 2))
    out.backward(torch.from_numpy(np.asarray(do, np.float64)))
    return out.detach(), t[0].grad, t[1].grad, t[2].grad, s.grad


@pytest.mark.parametrize("B,Sq,H,Hkv,dh,kv_valid", [
    (2, 96, 4, 2, 16, 96),             # GQA
    (2, 120, 2, 2, 16, 90),            # kv_valid < Skv
    (1, 300, 2, 2, 16, 300)])          # Sq across two 256-row blocks
def test_bias_grads_match_reference_vjp(B, Sq, H, Hkv, dh, kv_valid):
    """``FlashAttention`` in the bias form against ``jax.vjp`` of the
    reference and f64: out, dq, dk, dv, dfq, dfk; and
    ``flash_attention_lse(bias_qk=)`` against the reference's ``m +
    log(l)`` (``return_partial=True``)."""
    q, k, v, do, fq, fk = _bias_case(Sq + H, B, Sq, H, Hkv, dh)
    fk[:, kv_valid:] = 0.0

    def ref(*a):
        kw = dict(q_offset=jnp.zeros((), jnp.int32),
                  kv_valid=jnp.asarray(kv_valid, jnp.int32))
        out, vjp = jax.vjp(lambda q_, k_, v_, a_, b_: jlayers.flash_attention(
            q_, k_, v_, bias_qk=(a_, b_), **kw), *a[:5])
        m, l, _ = jlayers.flash_attention(*a[:3], bias_qk=a[3:5],
                                          return_partial=True, **kw)
        return out, vjp(a[5]), m + jnp.log(l)
    want, jg, jlse = _exact_jit(ref, q, k, v, fq, fk, do)
    tq, tk, tv = (torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
                  .clone().requires_grad_() for a in (q, k, v))
    tfq, tfk = (torch.from_numpy(a).clone().requires_grad_()
                for a in (fq, fk))
    got = tflash.flash_attention(tq, tk, tv, q_offset=0, kv_valid=kv_valid,
                                 bias_qk=(tfq, tfk))
    assert type(got.grad_fn).__name__ == "FlashAttentionBackward"
    got.backward(torch.from_numpy(do.view(np.uint16)).view(torch.bfloat16))
    tg = [t.grad for t in (tq, tk, tv, tfq, tfk)]
    assert [t.dtype for t in tg] == [torch.bfloat16] * 3 + [torch.float32] * 2
    assert not tg[4][:, kv_valid:].any()
    _, lse = tflash.flash_attention_lse(tq.detach(), tk.detach(), tv.detach(),
                                        q_offset=0, kv_valid=kv_valid,
                                        bias_qk=(tfq.detach(), tfk.detach()))
    jlse = np.asarray(jlse)
    assert np.abs(_np(lse) - jlse).max() <= 2e-6 * np.abs(jlse).max()
    _, *xg = _dense_f64(q, k, v, fq, fk, do, kv_valid)
    ds = xg.pop()
    assert leaf_ulps(got, want) <= 1
    for a, b, x in zip(tg[:3], jg[:3], xg, strict=True):
        assert leaf_ulps(a, b) <= BIAS_GRAD_ULPS
        assert leaf_ulps(a, x) <= BIAS_GRAD_ULPS
    for a, b, axis in ((tg[3], jg[3], -1), (tg[4], jg[4], -2)):
        x = ds.sum(axis).transpose(1, 2).numpy()
        scale = float(ds.abs().sum(axis).max())
        assert np.abs(_np(a) - x).max() <= BIAS_SUM_RTOL * scale
        assert np.abs(_np(b) - x).max() <= BIAS_SUM_RTOL * scale


def test_bias_bwd_blocks_partition(monkeypatch):
    """The bias backward's query blocks are a partition: any
    ``BWD_Q_BLOCK`` gives the same five gradients."""
    q, k, v, do, fq, fk = _bias_case(7, 2, 40, 2, 2, 16)
    tq, tk, tv, tdo = (torch.from_numpy(a.astype(np.float32)) for a in
                       (q, k, v, do))
    bias = (torch.from_numpy(fq), torch.from_numpy(fk))
    _, lse = tflash.flash_attention_lse(tq, tk, tv, q_offset=0, bias_qk=bias)
    outs = []
    for block in (3, 16, 256):
        monkeypatch.setattr(tflash, "BWD_Q_BLOCK", block)
        outs.append(tflash.flash_attention_bwd(tq, tk, tv, tdo, lse,
                                               q_offset=0, bias_qk=bias))
    for o in outs[1:]:
        assert len(o) == 5
        for a, b in zip(o, outs[0], strict=True):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-6)


# ---------------------------------------------------------------------------
# the Mamba scan's train form
# ---------------------------------------------------------------------------
def test_ssm_scan_train_form_matches_reference_vjp(monkeypatch):
    rng = np.random.default_rng(12)
    B, S, di, ds, chunk = 2, 24, 16, 4, 8
    arr = [rng.normal(size=(B, S, di)), 0.3 * np.abs(rng.normal(
        size=(B, S, di))), rng.normal(size=(B, S, ds)),
        rng.normal(size=(B, S, ds)), -np.abs(rng.normal(size=(di, ds))),
        rng.normal(size=(di,)), rng.normal(size=(B, di, ds))]
    arr = [a.astype(np.float32) for a in arr]
    cot = [rng.normal(size=(B, S, di)).astype(np.float32),
           rng.normal(size=(B, di, ds)).astype(np.float32)]
    def ref(*a):
        out, vjp = jax.vjp(lambda *b: jssm._ssm_scan(*b, chunk), *a[:7])
        return out, vjp(a[7:])
    want, jg = _exact_jit(ref, *arr, *cot)
    got = {}
    for remat in (True, False):
        if not remat:                        # each chunk called directly
            monkeypatch.setattr(tssm, "checkpoint",
                                lambda fn, *a, **kw: fn(*a))
        ts = [torch.from_numpy(a).requires_grad_() for a in arr]
        y, h = tssm._ssm_scan(*ts, chunk)
        torch.autograd.backward((y, h), tuple(map(torch.from_numpy, cot)))
        got[remat] = (y.detach(), h.detach(), *(t.grad for t in ts))
    for a, b in zip(got[True], got[False], strict=True):
        assert torch.equal(a, b)
    for a, b in zip(got[True], (*want, *jg), strict=True):
        assert _rel(a, b) <= SCAN_RTOL


def test_slstm_loop_backward_matches_autograd():
    """``_SLSTMLoop``'s hand-written backward against autograd of the same
    loop of ``_slstm_step`` in f64, every input's gradient (the state's
    too) within 1e-10 of the leaf's largest entry; with a tie planted
    where the backward splits the stabiliser's max (step 0, h0 = 0)."""
    rng = np.random.default_rng(13)
    S, NH, B, dh = 12, 2, 3, 4
    f64 = torch.float64
    gx = torch.from_numpy(rng.normal(size=(S, NH, B, 4 * dh)))
    r = torch.from_numpy(rng.normal(size=(NH, dh, 4 * dh)) / 2)
    st = [torch.from_numpy(rng.normal(size=(NH, B, dh))) for _ in range(4)]
    st[0] = torch.zeros_like(st[0])
    st[2] = st[2].abs() + 0.5
    st[3][0, 0, 1] = 0.0                 # gi == gf + m0 at step 0
    gx[0, 0, 0, dh + 1] = gx[0, 0, 0, 1]
    dys = [torch.from_numpy(rng.normal(size=(S, NH, B, dh)))] + \
        [torch.from_numpy(rng.normal(size=(NH, B, dh))) for _ in range(4)]
    grads = []
    for loop in (True, False):
        ins = [t.clone().to(f64).requires_grad_() for t in (gx, r, *st)]
        if loop:
            outs = txl._SLSTMLoop.apply(*ins)
        else:
            s_ = txl.SLSTMState(*ins[2:])
            hs = []
            for t in range(S):
                s_ = txl._slstm_step(s_, ins[0][t], ins[1])
                hs.append(s_.h)
            outs = (torch.stack(hs), *s_)
        grads.append(torch.autograd.grad(outs, ins, dys))
    for a, b in zip(*grads, strict=True):
        assert float((a - b).abs().max()) <= 1e-10 * float(b.abs().max())


# ---------------------------------------------------------------------------
# the blocks under a gradient, against the reference op by op
# ---------------------------------------------------------------------------
def _arrays(tree):
    """A port parameter tree as nested dicts of numpy arrays, laid out as
    ``torch_export.export_lm_params`` lays out the reference's."""
    if tree is None or isinstance(tree, dict):
        return None if tree is None else {k: _arrays(v)
                                          for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return {f: _arrays(getattr(tree, f)) for f in tree._fields
                if getattr(tree, f) is not None}
    if tree.dtype == torch.bfloat16:
        return tree.view(torch.int16).numpy().view(jnp.bfloat16)
    return tree.numpy()


def carried(arch: str, **kw):
    """(reference cfg, port cfg, reference params, port params): random
    weights from the port's ``init_params`` (the reference's eager or
    jitted init takes 5-6 s a config here), norm scales and biases
    randomised, as numpy arrays carried into both packages bit for bit
    (``convert.lm_params_from_arrays``; the reference's tree shaped by
    ``jax.eval_shape`` of its ``init_params``)."""
    jc = jreduce(jget_arch(arch), **kw)
    tc = reduce_cfg(get_arch(arch), **kw)
    g = torch.Generator()
    g.manual_seed(0)
    tree = _randomize(_arrays(TM.init_params(tc, g, "cpu")),
                      np.random.default_rng(1))
    like = jax.eval_shape(lambda k: JM.init_params(jc, k),
                          jax.random.PRNGKey(0))
    return jc, tc, _to_jax(tree, like), convert.lm_params_from_arrays(
        tree, tc, device="cpu")


@pytest.fixture(scope="module")
def models():
    return {a: carried(a, **kw) for a, kw in REDUCED.items()}


def _flat(tree):
    """(path, leaf) of a params NamedTuple, None leaves left out."""
    return [(f, getattr(tree, f)) for f in tree._fields
            if getattr(tree, f) is not None]


@pytest.mark.parametrize("arch,pos,kind", [("xlstm-125m", 0, "mlstm"),
                                           ("xlstm-125m", 1, "slstm")])
def test_block_grads_match_reference_vjp(models, arch, pos, kind):
    jc, tc, jp, tp = models[arch]
    jpc = jax.tree.map(lambda t: t[0], jp["sb"])[f"pos{pos}"]["core"]
    tpc = TM.tree_map(lambda t: t[0], tp["sb"])[f"pos{pos}"]["core"]
    rng = np.random.default_rng(40 + pos)
    x = _bf16_np(rng, 2, 16, jc.d_model)
    dy = _bf16_np(rng, 2, 16, jc.d_model)
    jfn, tfn = {"mlstm": (jxl.mlstm_block, txl.mlstm_block),
                "slstm": (jxl.slstm_block, txl.slstm_block)}[kind]
    def ref(p_, x_, dy_):
        out, vjp = jax.vjp(lambda a, b: jfn(a, b, jc, state=None,
                                            tp_shard=False)[0], p_, x_)
        return (out, *vjp(dy_))
    with no_fsdp_gather():
        want, jgp, jgx = _exact_jit(ref, jpc, x, dy)
    tps = type(tpc)(*(None if t is None else t.detach().clone()
                      .requires_grad_() for t in tpc))
    tx = torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16).clone() \
        .requires_grad_()
    got, st = tfn(tps, tx, tc, state=None, tp_shard=False)
    assert st is None
    got.backward(torch.from_numpy(dy.view(np.uint16)).view(torch.bfloat16))
    assert ulps(got, want, row=True).max() <= BLOCK_ULPS
    assert tx.grad.dtype == torch.bfloat16
    assert leaf_ulps(tx.grad, jgx) <= BLOCK_GRAD_ULPS
    for name, leaf in _flat(tps):
        assert leaf.grad is not None and leaf.grad.dtype == leaf.dtype, name
        assert leaf_ulps(leaf.grad, getattr(jgp, name)) <= BLOCK_GRAD_ULPS, \
            name


# ---------------------------------------------------------------------------
# JAX's derivatives of the activations and of the cumsum
# ---------------------------------------------------------------------------
EDGES = np.array([0.0, -0.0, 1e-8, -1e-8, 30.0, -30.0, np.inf, -np.inf,
                  np.nan], np.float32)


def _f32_ulps(got, want) -> float:
    """max |got - want| in f32 ulps of each ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float32)
    return float((np.abs(got - want) / np.spacing(np.abs(want))).max())


@pytest.mark.parametrize("name", ["softplus", "log_sigmoid", "sigmoid",
                                  "silu"])
def test_activation_grads_match_jax_on_edges(name):
    """Values and gradients against ``jax.nn``'s and ``jax.grad``: on the
    edges bit for bit (softplus' 0.5 at 0, 1 at +inf, 0 at -inf: JAX's
    custom JVP of ``logaddexp``); on a normal sample (N(0, 64)) within
    ``ACT_ULPS`` f32 ulps, the gradients within ``ACT_GRAD_ULPS`` (XLA:CPU's
    exp and log1p round differently from torch's)."""
    jf = getattr(jax.nn, name)
    sample = (np.random.default_rng(0).normal(size=4000) * 8).astype(
        np.float32)
    xs = np.concatenate([EDGES, sample])
    want = np.asarray(jf(jnp.asarray(xs)))
    jgrad = np.asarray(jax.vmap(jax.grad(jf))(jnp.asarray(xs)))
    x = torch.from_numpy(xs.copy()).requires_grad_()
    y = getattr(tlayers, name)(x)
    y.backward(torch.ones_like(y))
    n = len(EDGES)
    np.testing.assert_array_equal(_np(y)[:n], want[:n])
    np.testing.assert_array_equal(_np(x.grad)[:n], jgrad[:n])
    assert _f32_ulps(_np(y)[n:], want[n:]) <= ACT_ULPS
    assert _f32_ulps(_np(x.grad)[n:], jgrad[n:]) <= ACT_GRAD_ULPS
    with torch.no_grad():                  # the serving path: no Function
        np.testing.assert_array_equal(
            _np(getattr(tlayers, name)(torch.from_numpy(xs))), _np(y))
    if name == "softplus":
        assert x.grad[:n].tolist()[:2] == [0.5, 0.5]
        assert x.grad[6] == 1.0 and x.grad[7] == 0.0


@pytest.mark.parametrize("S", [1, 16, 17, 300, 2049])
def test_cumsum_grad_matches_jax(S):
    rng = np.random.default_rng(S)
    x = (rng.normal(size=(2, 3, S)) * 50).astype(np.float32)
    g = (rng.normal(size=(2, 3, S)) * 10).astype(np.float32)
    g.flat[:: 7] = 0.0
    want, vjp = jax.vjp(lambda a: jnp.cumsum(a, axis=-1), jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    y = tcdf.PrefixSum.apply(t)
    y.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(_np(y), np.asarray(want))
    np.testing.assert_array_equal(_np(t.grad),
                                  np.asarray(vjp(jnp.asarray(g))[0]))


# ---------------------------------------------------------------------------
# the train-mode forward and the train step
# ---------------------------------------------------------------------------
def test_train_forward_remat_recomputes_the_loops(models, monkeypatch):
    """With remat the superblock's recompute runs every sLSTM loop and
    every mLSTM's K8 call (bias form, with ``lse``) a second time; loss and
    gradients equal the run without remat bit for bit."""
    _, tc, _, tp = models["xlstm-125m"]
    rng = np.random.default_rng(9)
    toks = torch.from_numpy(rng.integers(0, 256, (2, 17)).astype(np.int32))
    pos = torch.arange(16, dtype=torch.int32)[None].expand(2, 16)
    calls = {"lse": 0, "slstm": 0}
    real_lse, real_step = tflash.flash_attention_lse, txl._slstm_step

    def lse(*a, **k):
        calls["lse"] += k.get("bias_qk") is not None
        return real_lse(*a, **k)

    def step(*a):
        calls["slstm"] += 1
        return real_step(*a)
    monkeypatch.setattr(tflash, "flash_attention_lse", lse)
    monkeypatch.setattr(txl, "_slstm_step", step)
    out = {}
    for remat in (True, False):
        calls.update(lse=0, slstm=0)
        ps = TM.tree_map(lambda t: t.detach().clone().requires_grad_(), tp)
        x, _ = TM.forward(ps, tc, toks[:, :-1], pos=pos, mode="train",
                          remat=remat)
        loss = TM.lm_loss(ps, tc, x, toks[:, 1:], False)
        grads = torch.autograd.grad(loss, topt.leaves(ps))
        out[remat] = (loss.detach(), grads, dict(calls))
    n_m, n_s = tc.pattern.count("mlstm"), tc.pattern.count("slstm")
    assert out[False][2] == {"lse": n_m, "slstm": 16 * n_s}
    assert out[True][2] == {"lse": 2 * n_m, "slstm": 2 * 16 * n_s}
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(out[True][1], out[False][1], strict=True):
        assert torch.equal(a, b)


def _carry(jp, jo, tc):
    """The reference's parameters and AdamW state as the port's."""
    return (convert.lm_params_from_arrays(export_lm_params(jp), tc,
                                          device="cpu"),
            convert.adamw_state_from_arrays(export_lm_params(jo), tc,
                                            device="cpu"))


def step_figures(arch, models):
    """Two steps of the port's and the reference's train step, the second
    from the reference's state after the first carried across: per step
    (|loss diff|, grad norm ratio - 1, largest |param diff| less 2 bf16
    ulps in lr, largest |master diff| in lr, share of parameters that
    differ)."""
    jc, tc, jp, _ = models[arch]
    jo = jopt.init(jp)
    tp, to = _carry(jp, jo, tc)
    B, S = 2, 32
    fn = jstep.make_train_step(jc, make_smoke_mesh(), lr=LR, donate=False)[0]
    tfn = tstep.make_train_step(tc, lr=LR)
    rng = np.random.default_rng(11)
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    res = jnp.zeros(())
    saved = jsharding._FSDP_GATHER_ON, jsharding.batch_axes()
    compiled, out = None, []
    try:
        for i in range(2):
            toks = rng.integers(0, jc.vocab_size, (B, S + 1)).astype(np.int32)
            args = toks[:, :-1], toks[:, 1:], pos
            jargs = (jp, jo, res, *map(jnp.asarray, args))
            if compiled is None:
                compiled = fn.lower(*jargs).compile(compiler_options=EXACT)
            jp, jo, res, jm = compiled(*jargs)
            tp, to, tm = tfn(tp, to, *map(torch.from_numpy, args))
            assert int(to.step) == int(jo.step) == i + 1
            over, master, moved, n = 0.0, 0.0, 0, 0
            for a, b, ma, mb in zip(topt.leaves(tp), jax.tree.leaves(jp),
                                    topt.leaves(to.master),
                                    jax.tree.leaves(jo.master), strict=True):
                a, b, ma, mb = _np(a), _np(b), _np(ma), _np(mb)
                ulp = 2.0 ** (np.floor(np.log2(np.maximum(
                    np.abs(b), 2.0 ** -126))) - 7)
                over = max(over, float((np.abs(a - b) - 2 * ulp).max() / LR))
                master = max(master, float(np.abs(ma - mb).max() / LR))
                moved += int((a != b).sum())
                n += a.size
            out.append((abs(float(tm["loss"]) - float(jm["loss"])),
                        abs(float(tm["grad_norm"]) / float(jm["grad_norm"])
                            - 1), over, master, moved / n))
            tp, to = _carry(jp, jo, tc)
    finally:
        jsharding.set_fsdp_gather(saved[0])
        jsharding.set_batch_axes(saved[1])
    return out


@pytest.mark.parametrize("arch", list(REDUCED))
def test_train_steps_match_reference(models, arch):
    """Two steps, each from the same state on both sides (the second from
    the reference's state after the first, carried across: a sign flip of
    AdamW's first move in one package would otherwise compound)."""
    figures = step_figures(arch, models)
    for loss, gnorm, over, master, _ in figures:
        assert loss <= STEP_LOSS_TOL
        assert gnorm <= STEP_GNORM_RTOL
        assert over <= 2 * 1.001 and master <= 2 * 1.001
    assert figures[0][4] <= STEP_MOVED
