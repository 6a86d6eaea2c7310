"""The embedding-input and M-RoPE families on the port (qwen2-vl-72b's
M-RoPE, ``models.layers.apply_mrope``; musicgen-large's frame embeddings,
``cfg.embed_input``) held against the reference on the CPU, from the same
numpy inputs made from a seed, the reference's weights carried across bit
for bit (``convert.lm_params_from_arrays``; norm scales and biases
randomised first, as in ``test_torch_lm.py``).

qwen2-vl runs at ``dataclasses.replace(reduce_cfg(..., n_layers=2,
d_model=64, vocab=256), head_dim=32, mrope_sections=(4, 6, 6))``: at
``reduce_cfg``'s head dim 16 the published sections (16, 24, 24) sum past
the 8 frequency slots and every slot takes the t id, so the h and w
sections would never act.  Its ids are laid out like an image
(``image_ids``): a text prefix (t = h = w), then a grid of patches at one
t with h the row and w the column, then text resuming at the largest id +
1; each batch row has its own prefix and grid.  musicgen runs at
``reduce_cfg(..., n_layers=2, d_model=64, vocab=256)`` on N(0, 1) frame
embeddings rounded to bf16.

Tolerances, each measured on these inputs (largest value seen in
brackets).  The reference runs as ``test_torch_lm.py`` and
``test_torch_train.py`` run it (its serving and train steps jitted with
XLA's default excess precision), so the tolerances are theirs:

* ``apply_mrope`` against the reference run op by op, at head dim 128 with
  (16, 24, 24), at 16 with (16, 24, 24) (the sections cut: equal to
  ``apply_rope`` at the t ids) and at 16 with (2, 2, 2) (the last section
  repeated over the 2 slots left): the output within ``MROPE_ULPS`` = 1
  bf16 ulp of each entry (0: equal in all three) and its VJP against
  ``jax.vjp`` within one ulp of the leaf (7.6e-6 at head dim 128, one
  entry near 0 rounded the other way; 0 at 16).
* The slice against the reference's jitted serving steps (``make_prefill``
  / ``make_decode_step`` on the smoke mesh): logits within ``LOGIT_TOL`` =
  0.08 (qwen2-vl 0.0360 prefill, 0.0393 over three decode steps; musicgen
  0.0291 and 0.0251), caches within ``CACHE_ULPS`` = 8 bf16 ulps of the
  largest entry of their head's vector (qwen2-vl 3.0, musicgen 2.25),
  greedy ids equal wherever the reference's top-2 margin exceeds twice
  ``LOGIT_TOL``.
* Two steps of ``make_train_step`` against the reference's jitted step on
  the smoke mesh at microbatch 1 and 2: loss within ``LOSS_TOL`` = 0.03
  (qwen2-vl 0.0021, musicgen 0.0015), grad norm within ``GNORM_RTOL`` = 4%
  (0.58%, 0.086%); after step 1 at most ``MOVED`` = 5% of the parameters
  differ (0.44%, 0.38%), each by at most 2 lr + 2 bf16 ulps (2.0012 lr);
  after step 2 every parameter within 4 lr + 2 ulps (3.69 lr); the master
  weights within 2 lr and 4 lr (2.00 and 3.80 lr).
* The entry points (``launch.serve.serve``, ``launch.train.train``) at
  reduced size against the reference's on the same weights: every input
  of every prefill, decode and train step (ids or embeddings, positions,
  cache lengths, labels) equal bit for bit; prefill logits within
  ``LOGIT_TOL`` (qwen2-vl 0.0184, musicgen 0.0151); a greedy id that
  differs only where the port's top-2 margin is within twice ``LOGIT_TOL``
  (musicgen's decode steps each take a fresh draw, so every step is held;
  qwen2-vl's feed the ids back, so its inputs are held up to the first
  that differs); each step's loss within ``LOSS_TOL`` (0.0004, 0.0019).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import repro  # noqa: F401  (enables x64 for the reference)
import jax
import jax.numpy as jnp
from repro.configs import get_arch as jget_arch
from repro.configs.reduced import reduce_cfg as jreduce
from repro.launch import serve as jserve
from repro.launch import train as jtrain
from repro.launch.mesh import make_smoke_mesh
from repro.models import layers as jlayers
from repro.models import model as JM
from repro.models import sharding as jsharding
from repro.serve import step as jsstep
from repro.train import optimizer as jopt
from repro.train import step as jtstep

from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.configs.reduced import reduce_cfg
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import layers as tlayers
from repro_torch.models import model as TM
from repro_torch.serve import step as tsstep
from repro_torch.train import optimizer as topt
from repro_torch.train import step as ttstep
from test_torch_lm import (CACHE_ULPS, LOGIT_TOL, _bf16_np, _bf16_t, _margin,
                           _np, _randomize, _to_jax, no_fsdp_gather, ulps)
from test_torch_train import leaf_ulps
from torch_export import export_lm_params

MROPE_ULPS = 1
LOSS_TOL = 0.03
GNORM_RTOL = 0.04
MOVED = 0.05
LR = 1e-2
B, S, S_MAX = 4, 24, 32
REDUCED = dict(n_layers=2, d_model=64, vocab=256)
# qwen2-vl at a head dim where all three sections act (4 + 6 + 6 = 16
# slots of 32 / 2)
CUTS = {"qwen2-vl-72b": dict(head_dim=32, mrope_sections=(4, 6, 6)),
        "musicgen-large": {}}
ARCHS = tuple(CUTS)


def image_ids(batch: int, seq: int, seed: int = 0) -> np.ndarray:
    """(3, batch, seq) int32 M-RoPE ids laid out like an image: each row a
    text prefix of its own length (t = h = w = i), a grid of gh x gw
    patches at t = the prefix's length with h = it + the row and w = it +
    the column, then text resuming at the largest id + 1."""
    rng = np.random.default_rng(seed)
    out = np.empty((3, batch, seq), np.int64)
    for b in range(batch):
        n_text = int(rng.integers(1, seq // 4))
        gh = int(rng.integers(2, 5))
        gw = int(rng.integers(2, 5))
        gh = min(gh, (seq - n_text) // gw)
        i = np.arange(n_text)
        out[:, b, :n_text] = i
        r, c = np.divmod(np.arange(gh * gw), gw)
        sl = slice(n_text, n_text + gh * gw)
        out[0, b, sl] = n_text
        out[1, b, sl] = n_text + r
        out[2, b, sl] = n_text + c
        rest = seq - n_text - gh * gw
        out[:, b, n_text + gh * gw:] = out[:, b, :n_text + gh * gw].max() \
            + 1 + np.arange(rest)
    return out.astype(np.int32)


def next_ids(pos3: np.ndarray, step: int) -> np.ndarray:
    """(3, B, 1) ids of decode step ``step`` after the prompt ``pos3``:
    text at each row's largest id + 1 + step."""
    nxt = pos3.max(axis=(0, 2)) + 1 + step
    return np.broadcast_to(nxt[None, :, None], (3, pos3.shape[1], 1)) \
        .astype(np.int32).copy()


def configs(arch: str):
    jc = dataclasses.replace(jreduce(jget_arch(arch), **REDUCED),
                             **CUTS[arch])
    tc = dataclasses.replace(reduce_cfg(get_arch(arch), **REDUCED),
                             **CUTS[arch])
    return jc, tc


def carried(arch: str, seed: int = 0):
    """(reference cfg, port cfg, reference params, port params)."""
    jc, tc = configs(arch)
    jp = JM.init_params(jc, jax.random.PRNGKey(seed))
    tree = _randomize(export_lm_params(jp), np.random.default_rng(seed + 1))
    return jc, tc, _to_jax(tree, jp), convert.lm_params_from_arrays(
        tree, tc, device="cpu")


def embeddings(rng, *shape) -> np.ndarray:
    """N(0, 1) frame embeddings as the reference's launcher rounds them."""
    return np.asarray(jnp.asarray(rng.normal(0, 1, shape), jnp.bfloat16))


def _t(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    return _bf16_t(a) if a.dtype.name == "bfloat16" else torch.from_numpy(a)


# ---------------------------------------------------------------------------
# apply_mrope
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sections,n", [
    ((16, 24, 24), 64), ((16, 24, 24), 8), ((2, 2, 2), 8), ((4, 6, 6), 16),
    ((0, 2, 2), 8), ((2, 0, 2), 8), ((2, 2, 0), 8), ((3, 3, 3), 4)])
def test_section_ids_match_total_repeat_length(sections, n):
    want = jnp.repeat(jnp.arange(3), jnp.asarray(sections),
                      total_repeat_length=n)
    np.testing.assert_array_equal(
        tlayers.mrope_section_ids(sections, n).numpy(), np.asarray(want))


@pytest.mark.parametrize("dh,sections,acts", [
    (128, (16, 24, 24), True),      # qwen2-vl's head dim: all three act
    (16, (16, 24, 24), False),      # cut past dh / 2: every slot on t
    (16, (2, 2, 2), True)])         # short of dh / 2: w repeated
def test_apply_mrope_and_vjp_match_reference(dh, sections, acts):
    rng = np.random.default_rng(dh + sum(sections))
    x = _bf16_np(rng, B, S, 3, dh, scale=3.0)
    pos3 = image_ids(B, S, seed=dh) + 900
    theta = get_arch("qwen2-vl-72b").rope_theta
    xt = _bf16_t(x).requires_grad_()
    got = tlayers.apply_mrope(xt, torch.from_numpy(pos3), theta, sections)
    want, vjp = jax.vjp(lambda a: jlayers.apply_mrope(
        a, jnp.asarray(pos3), theta, sections), jnp.asarray(x))
    assert got.dtype == torch.bfloat16
    assert ulps(got, want).max() <= MROPE_ULPS
    g = _bf16_np(rng, B, S, 3, dh)
    got.backward(_bf16_t(g))
    (gx,) = vjp(jnp.asarray(g))
    assert xt.grad.dtype == torch.bfloat16
    assert leaf_ulps(xt.grad, gx) <= MROPE_ULPS
    # the planted check: the h and w sections act (or, cut, do not)
    rope = tlayers.apply_rope(_bf16_t(x), torch.from_numpy(pos3[0]), theta)
    assert torch.equal(got.detach(), rope) is not acts
    # degenerate ids (the launchers' broadcast text positions): RoPE
    flat = np.broadcast_to(pos3[:1], pos3.shape).copy()
    assert torch.equal(tlayers.apply_mrope(
        _bf16_t(x), torch.from_numpy(flat), theta, sections), rope)


# ---------------------------------------------------------------------------
# the slice against the reference's jitted serving steps
# ---------------------------------------------------------------------------
def _ref_logits_fn(jc):
    def f(params, caches, tokens, pos, cache_len):
        x, _ = JM.forward(params, jc, tokens, pos=pos, caches=caches,
                          mode="decode", cache_len=cache_len)
        return JM.lm_logits(params, jc, x, False)[:, 0, :]
    return jax.jit(f)


def _prompt(arch, jc, rng):
    """(inputs, pos) of the prompt: frame embeddings or token ids, image
    ids or text positions."""
    inputs = embeddings(rng, B, S, jc.d_model) if jc.embed_input else \
        rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    pos = image_ids(B, S, seed=7) if jc.rope == "mrope" else \
        np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    return inputs, pos


def _step_in(jc, rng, tok, pos, i):
    """(inputs, pos) of decode step i."""
    inputs = embeddings(rng, B, 1, jc.d_model) if jc.embed_input else \
        tok[:, None].astype(np.int32)
    p = next_ids(pos, i) if jc.rope == "mrope" else \
        np.full((B, 1), S + i, np.int32)
    return inputs, p


@pytest.fixture(scope="module", params=ARCHS)
def slice_run(request):
    """Prefill and three greedy decode steps of one arch through both
    packages' serving steps, from the same inputs."""
    arch = request.param
    jc, tc, jp, tp = carried(arch)
    mesh = make_smoke_mesh()
    jpre, _ = jsstep.make_prefill(jc, mesh)
    jdec = _compiled_once(jsstep.make_decode_step(jc, mesh)[0])
    jlog = _compiled_once(_ref_logits_fn(jc))
    tpre, tdec = tsstep.make_prefill(tc), tsstep.make_decode_step(tc)
    rng = np.random.default_rng(5)
    inputs, pos = _prompt(arch, jc, rng)
    jl, jcache = jpre(jp, JM.init_cache(jc, B, S_MAX), jnp.asarray(inputs),
                      jnp.asarray(pos))
    tl, tcache = tpre(tp, TM.init_cache(tc, B, S_MAX, device="cpu"),
                      _t(inputs), torch.from_numpy(pos))
    out = dict(arch=arch, jc=jc, prefill=(np.asarray(jl), _np(tl)),
               prefill_cache=(jax.tree.map(np.asarray, jcache),
                              {k: {n: t.clone() for n, t in v.items()}
                               for k, v in tcache.items()}), steps=[])
    tok = np.argmax(np.asarray(jl)[:, :jc.vocab_size], -1).astype(np.int32)
    for i in range(3):
        L = S + i
        x_in, p_in = _step_in(jc, rng, tok, pos, i)
        args = (jnp.asarray(x_in), jnp.asarray(p_in), jnp.asarray(L,
                                                                  jnp.int32))
        with no_fsdp_gather():
            jlogits = np.asarray(jlog(jp, jcache, *args))
        jn, jcache = jdec(jp, jcache, *args)
        t_in, t_pos = _t(x_in), torch.from_numpy(p_in)
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


def _check_cache(jcache, tcache):
    for name, kv in tcache.items():
        for n, t in kv.items():
            u = ulps(t, jcache[name][n], row=True)
            assert t.dtype == torch.bfloat16 and u.max() <= CACHE_ULPS, \
                (name, n, u.max())


def test_prefill_matches_make_prefill(slice_run):
    jc = slice_run["jc"]
    jl, tl = slice_run["prefill"]
    assert tl.shape == jl.shape == (B, jc.vocab_padded)
    assert np.abs(tl - jl).max() <= LOGIT_TOL
    v = jc.vocab_size
    sure = _margin(jl, v) > 2 * LOGIT_TOL
    np.testing.assert_array_equal(np.argmax(tl[:, :v], -1)[sure],
                                  np.argmax(jl[:, :v], -1)[sure])
    _check_cache(*slice_run["prefill_cache"])


def test_decode_steps_match_make_decode_step(slice_run):
    v = slice_run["jc"].vocab_size
    for jn, tn, jlogits, tlogits in slice_run["steps"]:
        assert tn.dtype == np.int32 and tn.shape == (B,)
        np.testing.assert_array_equal(np.argmax(jlogits[:, :v], -1), jn)
        assert np.abs(tlogits - jlogits).max() <= LOGIT_TOL
        sure = _margin(jlogits, v) > 2 * LOGIT_TOL
        np.testing.assert_array_equal(tn[sure], jn[sure])
    _check_cache(*slice_run["cache"])


def test_params_have_no_embed_for_frame_inputs():
    """musicgen's tree has no ``embed`` leaf (the reference's), and its
    size is the config's count without a token table."""
    jc, tc = configs("musicgen-large")
    g = torch.Generator()
    g.manual_seed(0)
    tp = TM.init_params(tc, g, "cpu")
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    assert "embed" not in tp and "embed" not in jp
    assert sorted(tp) == sorted(jp)
    assert sum(t.numel() for t in topt.leaves(tp)) == \
        sum(a.size for a in jax.tree.leaves(jp))


# ---------------------------------------------------------------------------
# the train step against the reference's jitted step
# ---------------------------------------------------------------------------
def _compiled_once(fn):
    """A jitted ``fn`` lowered and compiled at its first call, that
    executable called from then on: the reference's step outputs come back
    with the mesh's shardings, and passing them back into the jit would
    trace and compile it again."""
    made = []

    def call(*args):
        if not made:
            made.append(fn.lower(*args).compile())
        return made[0](*args)
    return call


@pytest.fixture(scope="module")
def ref_steps():
    mesh = make_smoke_mesh()
    made = {}

    def get(jc, mb):
        if (jc.name, mb) not in made:
            made[jc.name, mb] = _compiled_once(jtstep.make_train_step(
                jc, mesh, lr=LR, donate=False, microbatch=mb)[0])
        return made[jc.name, mb]
    saved = jsharding._FSDP_GATHER_ON, jsharding.batch_axes()
    yield get
    jsharding.set_fsdp_gather(saved[0])
    jsharding.set_batch_axes(saved[1])


@pytest.mark.parametrize("microbatch", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(ref_steps, arch, microbatch):
    jc, tc, jp, tp = carried(arch)
    jo = jopt.init(jp)
    to = convert.adamw_state_from_arrays(export_lm_params(jo), tc,
                                         device="cpu")
    fn = ref_steps(jc, microbatch)
    tfn = ttstep.make_train_step(tc, lr=LR, microbatch=microbatch)
    rng = np.random.default_rng(11)
    res = jnp.zeros(())
    for i in range(2):
        inputs, pos = _prompt(arch, jc, rng)
        labels = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
        args = inputs, labels, pos
        jp, jo, res, jm = fn(jp, jo, res, *map(jnp.asarray, args))
        tp, to, tm = tfn(tp, to, *map(_t, args))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_TOL
        assert abs(float(tm["grad_norm"]) / float(jm["grad_norm"]) - 1) \
            <= GNORM_RTOL
        assert int(to.step) == int(jo.step) == i + 1
        moved, n = 0, 0
        for a, b, ma, mb in zip(topt.leaves(tp), jax.tree.leaves(jp),
                                topt.leaves(to.master),
                                jax.tree.leaves(jo.master), strict=True):
            a, b, ma, mb = _np(a), _np(b), _np(ma), _np(mb)
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(b),
                                                      2.0 ** -126))) - 7)
            assert (np.abs(a - b) <= 2 * (i + 1) * LR * 1.001 + 2 * ulp).all()
            assert np.abs(ma - mb).max() <= 2 * (i + 1) * LR * 1.001
            moved += int((a != b).sum())
            n += a.size
        if i == 0:
            assert moved <= MOVED * n, moved / n


# ---------------------------------------------------------------------------
# the entry points against the reference's
# ---------------------------------------------------------------------------
def _recording(make, calls, wrap):
    """``make`` (a step factory) whose steps record their inputs (numpy
    copies) and ``wrap``'s view of their outputs in ``calls``; a jitted
    step is compiled once (``_compiled_once``)."""
    def made(*a, **kw):
        out = make(*a, **kw)
        fn = out[0] if isinstance(out, tuple) else out
        if hasattr(fn, "lower"):
            fn = _compiled_once(fn)

        def step(*args):
            res = fn(*args)
            calls.append(wrap(args, res))
            return res
        return (step, *out[1:]) if isinstance(out, tuple) else step
    return made


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.dtype == torch.bfloat16 \
            else x.detach().numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_reference_serve(monkeypatch, arch):
    """``launch.serve.serve(reduced=True)`` against the reference's on the
    same weights: every prefill and decode input bit for bit, the prefill
    logits within ``LOGIT_TOL``, greedy ids wherever the margin allows."""
    kw = dict(requests=2, prompt_len=12, new_tokens=4, d_model=64, seed=3)
    jc = jreduce(jget_arch(arch), d_model=64, vocab=2048)
    tc = reduce_cfg(get_arch(arch), d_model=64, vocab=2048)
    jp = JM.init_params(jc, jax.random.PRNGKey(3))
    tp = convert.lm_params_from_arrays(export_lm_params(jp), tc,
                                       device="cpu")
    jcalls, tcalls = [], []
    # (the inputs and positions, the cache length), and the logits or ids
    of = lambda args, res: ([_host(a) for a in args[2:4]]
                            + [int(a) for a in args[4:]], _host(res[0]))
    monkeypatch.setattr(jserve.serve_step, "make_prefill", _recording(
        jserve.serve_step.make_prefill, jcalls, of))
    monkeypatch.setattr(jserve.serve_step, "make_decode_step", _recording(
        jserve.serve_step.make_decode_step, jcalls, of))
    want = jserve.serve(arch, reduced=True, **kw)
    monkeypatch.setattr(tserve.M, "init_params", lambda *a, **k: tp)
    monkeypatch.setattr(tserve.serve_step, "make_prefill", _recording(
        tserve.serve_step.make_prefill, tcalls, of))
    monkeypatch.setattr(tserve.serve_step, "make_decode_step", _recording(
        tserve.serve_step.make_decode_step, tcalls, of))
    margins, real_logits = [], TM.lm_logits

    def logits(*a, **k):
        out = real_logits(*a, **k)
        margins.append(out[:, -1])
        return out
    monkeypatch.setattr(TM, "lm_logits", logits)
    got = tserve.serve(arch, reduced=True, device="cpu", **kw)
    assert got.tokens.shape == want.shape == (2, 5)
    assert len(jcalls) == len(tcalls) == 5
    # every input bit for bit: the prefill's, then each decode step's
    # (musicgen: fresh frame draws; qwen2-vl: the fed-back ids up to the
    # first disagreement)
    jl, tl = jcalls[0][1], tcalls[0][1]
    assert np.abs(tl - jl).max() <= LOGIT_TOL
    margins = np.stack([_margin(_np(m), 2048) for m in margins], 1)
    first_diff = 5
    for r in range(2):
        for t in range(5):
            if got.tokens[r, t] != want[r, t]:
                assert margins[r, t] <= 2 * LOGIT_TOL, (r, t, margins[r, t])
                if not jc.embed_input:
                    first_diff = min(first_diff, t)
                    break
    for i, ((ja, _), (ta, _)) in enumerate(zip(jcalls, tcalls)):
        if i == 0 or jc.embed_input or i <= first_diff:
            for a, b in zip(ja, ta, strict=True):
                assert np.asarray(a).dtype == np.asarray(b).dtype
                np.testing.assert_array_equal(a, b, strict=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_matches_reference_train(monkeypatch, arch):
    """``launch.train.train(reduced=True)`` against the reference's on the
    same weights: every step's inputs, labels and positions bit for bit,
    each step's loss within ``LOSS_TOL``."""
    kw = dict(steps=2, batch=2, seq=16, lr=LR, reduced=True, ckpt_dir=None,
              d_model=64, n_layers=2)
    jc = jreduce(jget_arch(arch), d_model=64, n_layers=2, vocab=2048)
    tc = tlaunch.train_config(arch, reduced=True, d_model=64, n_layers=2)
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    tp = convert.lm_params_from_arrays(export_lm_params(jp), tc,
                                       device="cpu")
    jcalls, tcalls = [], []
    of = lambda args, res: [_host(a) for a in args[-3:]]
    monkeypatch.setattr(jtrain, "make_train_step", _recording(
        jtrain.make_train_step, jcalls, of))
    want = jtrain.train(arch, **kw)
    monkeypatch.setattr(tlaunch.M, "init_params", lambda *a, **k: tp)
    monkeypatch.setattr(tlaunch, "make_train_step", _recording(
        tlaunch.make_train_step, tcalls, of))
    got = tlaunch.train(arch, device="cpu", **kw)
    assert len(jcalls) == len(tcalls) == 2
    for ja, ta in zip(jcalls, tcalls, strict=True):
        for a, b in zip(ja, ta, strict=True):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    assert tcalls[0][0].shape == ((2, 16, 64) if jc.embed_input
                                  else (2, 16))
    assert tcalls[0][2].shape == ((3, 2, 16) if jc.rope == "mrope"
                                  else (2, 16))
    assert np.abs(np.asarray(got.losses) - np.asarray(want)).max() \
        <= LOSS_TOL
