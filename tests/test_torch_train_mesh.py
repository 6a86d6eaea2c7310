"""Training on a mesh on the port (ROADMAP item 14e: FSDP storage,
``models.model.forward(mode="train", mesh=)`` and ``lm_loss(..., mesh=)``,
``models.sharding``'s training collectives, ``train.step.
make_train_step(cfg, mesh)``, ``train.grad_compress``, the optimizer over
positions, ``train.checkpoint`` saves and resharding restores,
``train.elastic.remesh``) held against the reference's ``shard_map`` step
on the CPU.

The reference runs in two subprocesses of 4 host devices each (jamba's
and xlstm's cases, and the rest), started together when this module
starts: per case it takes the weights drawn here with numpy from a
seed (bf16; norm scales ``1 + 0.2 N``, biases ``0.2 N``), runs two steps
of ``make_train_step`` compiled with ``xla_allow_excess_precision`` off,
and pickles the loss, the grad norm, the parameters, the AdamW state and
the residual after each step.  It also writes a checkpoint of one case on
(1, 2, 2) and restores onto (1, 2, 2) a checkpoint the port wrote from a
mesh before the subprocess started.  The port carries the weights across
(``convert.lm_params_from_arrays(..., mesh=, fsdp=True)``), runs the same
steps on CPU positions in both storage layouts (``share=True``: the
positions of one device holding one shard share a tensor; ``share=False``:
each position its own copy, as separate cards hold them) and gathers the
results (``gather_tree``).  Cases, all ``reduce_cfg`` cuts at d_model 64
and vocab 256, a global batch of 4 x 32 tokens, lr 1e-2:

* qwen3-4b, 2 KV heads at tp 2 on (1, 2, 2), ``microbatch=2``: FSDP over
  ``data`` and TP over ``model``;
* qwen3-4b, 1 KV head at tp 2 on (1, 1, 2): the replicated-KV slice;
* qwen3-4b, 2 KV heads at tp 2 on (2, 1, 2), ``compress_pod`` off and on:
  the reference's gradient summed over ``pod`` twice (its grad norm twice
  the one-card step's, ``POD_RTOL``) and the int8 residual;
* granite-moe-1b-a400m and jamba-v0.1-52b at tp 2 on (1, 1, 2): MoE and
  Mamba under a gradient;
* xlstm-125m on (1, 2, 1): replicated over ``model``, FSDP only.

Tolerances, each about twice the largest reading on these inputs over
both steps of every case but jamba's (the reading in brackets): the loss
within ``LOSS_RTOL`` = 8e-5 relative (4.1e-5), the grad norm within
``GNORM_RTOL`` = 2e-3 relative (1.0e-3: bf16 gradients summed in another
order), AdamW's ``mu`` within ``MU_ULPS`` = 12 and ``nu`` within
``NU_ULPS`` = 24 bf16 ulps of the leaf's largest entry (6.1, 13.2) and
every leaf's ``mu`` within ``MU_RL2`` = 0.045 relative L2 (0.024: a
gradient's scale confined to one leaf shows here), at most ``MOVED`` =
0.7% of the parameters differing after the first step (0.36%), the pod
double count within ``POD_RTOL`` = 1e-3 (5.1e-4).  Two are bounds of
the arithmetic rather than readings: each parameter and master weight
within ``PARAM_LR`` = 2 lr per step plus 2 bf16 ulps of itself (AdamW
moves a weight by at most about lr a step, and a gradient near zero may
flip its sign; 2.0004 with the ulps), the residual within ``RES_STEPS``
= 1.05 of the leaf's quantisation step (a gradient on the other side of
a rounding tie moves its residual by one step; 1.0007).  jamba's MoE
routes flip with the sum order (ROADMAP queue 3), so its readings are
wider and its bounds, twice them, are ``ROUTED``'s: loss 5e-4 (2.6e-4),
grad norm 1e-2 (5.4e-3), mu 24 ulps (12.6), nu 36 (18.3), mu relative
L2 0.055 (0.028), moved 1.5% (0.71%).  The step counters are equal.

Both storage layouts equal each other bit for bit; the (1, 1, 1) mesh
step equals the one-card step bit for bit.  Checkpoints cross
packages bit for bit, both ways, onto other meshes; the int8 step's state,
residual included, reshards bit for bit.  Port-only: the int8 sum against
numpy bit for bit, ``fsdp_gather`` and its reduce-scatter, the step's
collectives, ``psum_dtype``, remat's recompute seen as a backward
(``flash.in_backward``), and three planted faults (a replicated leaf's
sum over its copies left out; a shared norm scale updated twice; one
small leaf's gradient 5% too large) that the
gates against the reference must catch.
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
from repro_torch.models import model as TM
from repro_torch.models import sharding as tsh
from repro_torch.serve import step as sstep
from repro_torch.train import elastic as telastic
from repro_torch.train import grad_compress as tgc
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep
from repro_torch.train.checkpoint import Checkpointer

LR = 1e-2
B, S = 4, 32
REDUCE = dict(n_layers=2, d_model=64, vocab=256)
LOSS_RTOL = 8e-5
GNORM_RTOL = 2e-3
PARAM_LR = 2
MU_ULPS = 12
NU_ULPS = 24
MU_RL2 = 0.045
RES_STEPS = 1.05
MOVED = 0.007
POD_RTOL = 1e-3
# jamba's MoE routes flip with the sum order of the router's inputs
# (ROADMAP queue 3): its bounds are twice its own readings
ROUTED = {"jamba": dict(loss=5e-4, gnorm=1e-2, mu=24, nu=36, mu_rl2=0.055,
                        moved=0.015)}

# name: (arch, config overrides, mesh, microbatch, compress_pod)
QWEN_KV2 = dict(tp=2, n_kv_heads=2, tp_shard=True)
CASES = {
    "qwen3-fsdp": ("qwen3-4b", QWEN_KV2, (1, 2, 2), 2, False),
    "qwen3-kv1": ("qwen3-4b", dict(tp=2, n_kv_heads=1, tp_shard=True),
                  (1, 1, 2), 1, False),
    "qwen3-pod": ("qwen3-4b", QWEN_KV2, (2, 1, 2), 1, False),
    "qwen3-pod-int8": ("qwen3-4b", QWEN_KV2, (2, 1, 2), 1, True),
    "granite": ("granite-moe-1b-a400m", dict(tp=2, tp_shard=True),
                (1, 1, 2), 1, False),
    "jamba": ("jamba-v0.1-52b", dict(tp=2, tp_shard=True), (1, 1, 2), 1,
              False),
    "xlstm": ("xlstm-125m", {}, (1, 2, 1), 1, False),
}
CKPT_CASE = "qwen3-fsdp"     # the reference's checkpoint, at step 2
# the reference's subprocesses, started together (jamba's compile is the
# longest)
REF_GROUPS = (("jamba", "xlstm"),
              ("qwen3-fsdp", "qwen3-kv1", "qwen3-pod", "qwen3-pod-int8",
               "granite"))


def _cfg(name):
    arch, over, *_ = CASES[name]
    return dataclasses.replace(reduce_cfg(get_arch(arch), **REDUCE), **over)


def _draw(cfg, mesh, seed: int) -> dict:
    """Global bf16 weights of ``cfg`` (numpy, ml_dtypes), drawn from
    ``seed``: N(0, 1) / sqrt(fan_in), norm scales 1 + 0.2 N, biases
    0.2 N."""
    import ml_dtypes
    rng = np.random.default_rng(seed)
    tree = TM.build_tree(cfg, mesh if cfg.tp_shard else None)

    def leaf(desc, stacked):
        shape = ((cfg.n_sb,) if stacked else ()) + desc.shape
        z = rng.normal(size=shape)
        if desc.fan_in == -1:
            w = 1 + 0.2 * z
        elif desc.fan_in == 0:
            w = 0.2 * z
        else:
            w = z / np.sqrt(desc.fan_in)
        return w.astype(np.float32).astype(ml_dtypes.bfloat16)

    def walk(node, stacked):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(v, stacked) for k, v in node.items()}
        if isinstance(node, TM.Leaf):
            return leaf(node, stacked)
        return {f: walk(getattr(node, f), stacked) for f in node._fields
                if getattr(node, f) is not None}
    out = {k: walk(v, False) for k, v in tree.items() if k != "sb"}
    out["sb"] = walk(tree["sb"], True)
    return out


def _batches(name) -> list:
    rng = np.random.default_rng(sum(map(ord, name)))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    out = []
    for _ in range(2):
        toks = rng.integers(0, 256, (B, S + 1)).astype(np.int32)
        out.append((toks[:, :-1].copy(), toks[:, 1:].copy(), pos))
    return out


def _np(t) -> np.ndarray:
    return t.detach().float().numpy()


def _mesh(shape):
    return tsh.ModelMesh(shape, devices="cpu")


def _step(name, k: int, params: dict, opt=None, res=None, *, share: bool,
          mesh_shape=None) -> tuple:
    """Step ``k`` (its batch ``_batches(name)[k]``) of case ``name`` on
    the port from GLOBAL numpy state (the reference's export format:
    ``params``, the AdamW state ``opt`` and the residual ``res``; a fresh
    state where None): (a record of the loss, the grad norm and the
    gathered params, AdamW state and residual; the step's objects)."""
    arch, over, shape, mb, compress = CASES[name]
    cfg = _cfg(name)
    mesh = _mesh(mesh_shape or shape)
    fn = tstep.make_train_step(cfg, mesh, lr=LR, microbatch=mb,
                               compress_pod=compress)
    specs, ospecs, rspecs = fn.in_specs[:3]
    ps = convert.lm_params_from_arrays(params, cfg, mesh=mesh, fsdp=True,
                                       share=share)
    st = topt.init(ps) if opt is None else convert.adamw_state_from_arrays(
        opt, cfg, mesh=mesh, share=share)
    rs = None
    if compress:
        rs = tgc.init_residual(ps) if res is None else \
            convert.lm_params_from_arrays(res, cfg, mesh=mesh, fsdp=True,
                                          share=share)
    args = [sstep.shard_tree(torch.from_numpy(a), sp, mesh)
            for a, sp in zip(_batches(name)[k], fn.in_specs[3:],
                             strict=True)]
    ps, st, rs, m = fn(ps, st, rs, *args)
    rec = dict(loss=float(m["loss"]), gnorm=float(m["grad_norm"]),
               params=sstep.gather_tree(ps, specs, mesh),
               opt=sstep.gather_tree(st, ospecs, mesh),
               res=None if rs is None else sstep.gather_tree(rs, rspecs,
                                                             mesh))
    return rec, dict(fn=fn, mesh=mesh, params=ps, opt=st, res=rs, cfg=cfg)


_REF_SCRIPT = r"""
import os, pickle, dataclasses, time
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
import repro  # noqa: F401
from repro.configs import get_arch
from repro.configs.reduced import reduce_cfg
from repro.models import model as JM
from repro.train import grad_compress as JG
from repro.train import optimizer as JO
from repro.train import step as JT
from repro.train.checkpoint import Checkpointer

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
    inp = pickle.load(fh)
out = {}
for name, c in inp["cases"].items():
    t0 = time.time()
    jc = dataclasses.replace(reduce_cfg(get_arch(c["arch"]), **c["reduce"]),
                             **c["over"])
    jp = to_jax(c["params"], JM.init_params(jc, jax.random.PRNGKey(0)))
    m = mesh(c["mesh"])
    fn = compiled(JT.make_train_step(jc, m, lr=c["lr"], donate=False,
                                     microbatch=c["mb"],
                                     compress_pod=c["compress"])[0])
    jo = JO.init(jp)
    res = JG.init_residual(jp) if c["compress"] else jnp.zeros(())
    recs = []
    for a, b, p in c["batches"]:
        jp, jo, res, met = fn(jp, jo, res, jnp.asarray(a), jnp.asarray(b),
                              jnp.asarray(p))
        recs.append(dict(loss=float(met["loss"]),
                         gnorm=float(met["grad_norm"]), params=export(jp),
                         opt=export(jo),
                         res=export(res) if c["compress"] else None))
    out[name] = recs
    print(name, "%%.1f s" %% (time.time() - t0), flush=True)
    if name == inp["ckpt_case"]:
        Checkpointer(inp["ref_dir"]).save(2, {"params": jp, "opt": jo},
                                          blocking=True)
        specs = JM.param_specs(jc)
        template = {"params": jp, "opt": jo}
        back = Checkpointer(inp["port_dir"]).restore(
            1, template, mesh=m,
            specs={"params": specs, "opt": JO.state_specs(specs)})
        out["port_ckpt"] = export(back)
with open(%(out)r, "wb") as fh:
    pickle.dump(out, fh)
print("TRAIN_MESH_REF_OK")
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The weights of every case, the port's checkpoint of the checkpoint
    case after one step on its mesh, and the reference's records (a
    function; None without JAX)."""
    tmp = tmp_path_factory.mktemp("train_mesh")
    trees = {name: _draw(_cfg(name), _mesh(CASES[name][2]),
                         sum(map(ord, name))) for name in CASES}
    port_dir, ref_dir = str(tmp / "port_ckpt"), str(tmp / "ref_ckpt")
    _, st = _step(CKPT_CASE, 0, trees[CKPT_CASE], share=True)
    per = [{"params": p, "opt": o}
           for p, o in zip(st["params"], st["opt"], strict=True)]
    specs = {"params": st["fn"].in_specs[0], "opt": st["fn"].in_specs[1]}
    ck = Checkpointer(port_dir)
    ck.save(1, per, blocking=True, mesh=st["mesh"], specs=specs)
    ck.wait()
    saved = sstep.gather_tree(per, specs, st["mesh"])
    box = {"trees": trees, "port_dir": port_dir, "ref_dir": ref_dir,
           "port_saved": saved}
    try:
        import jax  # noqa: F401
    except ImportError:
        box["ref"] = None
        yield box
        return
    env = dict(os.environ, PYTHONPATH="src")
    env.pop("XLA_FLAGS", None)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for i, group in enumerate(REF_GROUPS):
        cases = {}
        for name in group:
            arch, over, shape, mb, compress = CASES[name]
            cases[name] = dict(arch=arch, over=over, reduce=REDUCE,
                               mesh=shape, mb=mb, compress=compress, lr=LR,
                               params=trees[name], batches=_batches(name))
        with open(tmp / f"in{i}.pkl", "wb") as fh:
            pickle.dump(dict(cases=cases, ckpt_case=CKPT_CASE,
                             port_dir=port_dir, ref_dir=ref_dir), fh)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _REF_SCRIPT % {
                "inp": str(tmp / f"in{i}.pkl"),
                "out": str(tmp / f"out{i}.pkl")}],
            env=env, cwd=root, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))

    def result():
        if "out" not in box:
            merged = {}
            for i, proc in enumerate(procs):
                out, err = proc.communicate(timeout=600)
                assert proc.returncode == 0 and "TRAIN_MESH_REF_OK" in out, \
                    err[-4000:]
                with open(tmp / f"out{i}.pkl", "rb") as fh:
                    merged.update(pickle.load(fh))
            box["out"] = merged
        return box["out"]
    box["ref"] = result
    yield box
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _ulp(a: np.ndarray) -> np.ndarray:
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126))) - 7)


def _leaves_np(tree) -> list:
    """The numpy leaves of a (port or exported reference) tree, f32, in
    the order of their dotted paths (a NamedTuple exported as a dict
    sorts its fields)."""
    from repro_torch.core.persist import tree_paths
    return [_np(t) if isinstance(t, torch.Tensor) else
            np.asarray(t, np.float32)
            for _, t in sorted(tree_paths(tree), key=lambda kv: kv[0])
            if not (isinstance(t, np.ndarray) and t.dtype == object)]


def _max_ulps(got: list, want: list) -> float:
    """The largest |got - want| over the leaves, each in bf16 ulps of its
    reference leaf's largest magnitude."""
    worst = 0.0
    for a, b in zip(got, want, strict=True):
        m = max(float(np.abs(b).max()), 2.0 ** -126)
        worst = max(worst, float(np.abs(a - b).max()) /
                    2.0 ** (np.floor(np.log2(m)) - 7))
    return worst


def errors(got: dict, want: dict) -> dict:
    """The port's record of one step against the reference's, in the
    units of the tolerances."""
    out = dict(loss=abs(got["loss"] - want["loss"]) / abs(want["loss"]),
               gnorm=abs(got["gnorm"] / want["gnorm"] - 1))
    moved = n = 0
    worst = 0.0
    for a, b in zip(_leaves_np(got["params"]), _leaves_np(want["params"]),
                    strict=True):
        worst = max(worst, float(((np.abs(a - b) - 2 * _ulp(b)) / LR).max()))
        moved += int((a != b).sum())
        n += a.size
    out.update(param_lr=worst, moved=moved / n)
    go, wo = got["opt"], want["opt"]
    out["master_lr"] = max(float(np.abs(a - b).max()) / LR for a, b in zip(
        _leaves_np(go.master), _leaves_np(wo["master"]), strict=True))
    out["mu_ulps"] = _max_ulps(_leaves_np(go.mu), _leaves_np(wo["mu"]))
    out["mu_rl2"] = max(
        float(np.linalg.norm(a - b)) / max(float(np.linalg.norm(b)), 1e-30)
        for a, b in zip(_leaves_np(go.mu), _leaves_np(wo["mu"]),
                        strict=True))
    out["nu_ulps"] = _max_ulps(_leaves_np(go.nu), _leaves_np(wo["nu"]))
    out["step"] = (int(go.step), int(np.asarray(wo["step"])))
    if want["res"] is not None:
        # in quantisation steps: a residual lies within half a step (the
        # scale) of zero, so twice its largest magnitude bounds the step
        out["res_steps"] = max(
            float(np.abs(a - b).max()) / max(2 * float(np.abs(b).max()),
                                             2.0 ** -126)
            for a, b in zip(_leaves_np(got["res"]), _leaves_np(want["res"]),
                            strict=True))
    return out


def _hold(name, k: int, got: dict, want: dict) -> None:
    """The port's record of step ``k`` of case ``name`` against the
    reference's."""
    e = errors(got, want)
    tol = dict(dict(loss=LOSS_RTOL, gnorm=GNORM_RTOL, mu=MU_ULPS,
                    nu=NU_ULPS, mu_rl2=MU_RL2, moved=MOVED),
               **ROUTED.get(name, {}))
    assert e["loss"] <= tol["loss"] and e["gnorm"] <= tol["gnorm"], \
        (name, k, e)
    assert e["param_lr"] <= PARAM_LR * 1.001, (name, k, e)
    assert k > 1 or e["moved"] <= tol["moved"], (name, k, e)
    assert e["master_lr"] <= PARAM_LR * 1.001, (name, k, e)
    assert e["mu_ulps"] <= tol["mu"] and e["nu_ulps"] <= tol["nu"], \
        (name, k, e)
    assert e["mu_rl2"] <= tol["mu_rl2"], (name, k, e)
    assert e["step"] == (k, k), (name, k, e)
    assert e.get("res_steps", 0.0) <= RES_STEPS, (name, k, e)


def _equal_trees(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(topt.leaves(a),
                                                 topt.leaves(b), strict=True))


def _same(a: dict, b: dict, what) -> None:
    """Two records of one step equal bit for bit."""
    assert a["loss"] == b["loss"] and a["gnorm"] == b["gnorm"], what
    for part in ("params", "opt", "res"):
        if a[part] is not None:
            assert _equal_trees(a[part], b[part]), (what, part)


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_step_matches_reference(world, name):
    """Step 1 from the drawn weights and step 2 from the reference's state
    after step 1 (params, AdamW state, residual carried across), each in
    both storage layouts: the layouts equal bit for bit, and each step
    held against the reference's."""
    one, _ = _step(name, 0, world["trees"][name], share=True)
    _same(one, _step(name, 0, world["trees"][name], share=False)[0],
          (name, 1))
    if world["ref"] is None:
        pytest.skip("the reference (JAX) is not installed")
    ref = world["ref"]()[name]
    _hold(name, 1, one, ref[0])
    prev = ref[0]
    two, _ = _step(name, 1, prev["params"], prev["opt"], prev["res"],
                   share=True)
    _same(two, _step(name, 1, prev["params"], prev["opt"], prev["res"],
                     share=False)[0], (name, 2))
    _hold(name, 2, two, ref[1])


def _one_card(cfg, tree):
    """The one-card form of a layout that computes its function (KV heads
    sharded or all replicated, nothing padded) and its weights."""
    one = dataclasses.replace(cfg, tp=1, tp_shard=False)
    return one, convert.lm_params_from_arrays(tree, one, device="cpu")


def test_smoke_mesh_equals_one_card():
    """The (1, 1, 1) mesh step (every collective over one position) equals
    the one-card step bit for bit, with microbatches, over two steps."""
    cfg = reduce_cfg(get_arch("qwen3-4b"), **REDUCE)
    tree = _draw(cfg, None, 7)
    mesh = _mesh((1, 1, 1))
    fn = tstep.make_train_step(cfg, mesh, lr=LR, microbatch=2)
    ps = convert.lm_params_from_arrays(tree, cfg, mesh=mesh, fsdp=True)
    st = topt.init(ps)
    one = convert.lm_params_from_arrays(tree, cfg, device="cpu")
    ost = topt.init(one)
    fn1 = tstep.make_train_step(cfg, lr=LR, microbatch=2)
    for inp, lab, pos in _batches("smoke"):
        ts = [torch.from_numpy(a) for a in (inp, lab, pos)]
        ps, st, _, m = fn(ps, st, None, *([t] for t in ts))
        one, ost, m1 = fn1(one, ost, *ts)
        assert torch.equal(m["loss"], m1["loss"])
        assert torch.equal(m["grad_norm"], m1["grad_norm"])
        assert _equal_trees(ps[0], one) and _equal_trees(st[0], ost)


def test_pod_axis_doubles_the_gradient(world):
    """The reference sums the gradient over ``pod`` twice: on (2, 1, 2) the
    grad norm (before the clip) is twice the one-card step's on the same
    weights and batch, in the port and in the reference alike, and the
    AdamW moments show the doubled gradient."""
    name = "qwen3-pod"
    cfg = _cfg(name)
    one, p1 = _one_card(cfg, world["trees"][name])
    o1 = topt.init(p1)
    ts = [torch.from_numpy(a) for a in _batches(name)[0]]
    _, o1, m1 = tstep.make_train_step(one, lr=LR)(p1, o1, *ts)
    rec, _ = _step(name, 0, world["trees"][name], share=True)
    g1 = float(m1["grad_norm"])
    assert abs(rec["gnorm"] / (2 * g1) - 1) <= POD_RTOL, (rec["gnorm"], g1)
    # mu = (1 - b1) g scale with scale = 1 / gnorm: the doubled gradient
    # over the doubled norm moves nu by 4 before the clip's 1 / 4
    if world["ref"] is not None:
        ref = world["ref"]()[name][0]
        assert abs(ref["gnorm"] / (2 * g1) - 1) <= POD_RTOL, \
            (ref["gnorm"], g1)


def test_compressed_pod_psum_is_the_int8_sum():
    """``compressed_pod_psum`` on two pods of random gradients against the
    formula in numpy, bit for bit: per position the scale max(|g + r|) /
    127 maxed over pod, q = round half to even of (g + r) / scale clipped
    to 127, the residual (g + r) - q scale, the sum over pod of q times
    the scale; the result within half a scale a pod of the exact sum."""
    mesh = _mesh((2, 1, 2))
    g = torch.Generator().manual_seed(5)
    grads = [[torch.randn(6, 5, generator=g).to(torch.bfloat16),
              torch.randn(7, generator=g)] for _ in range(mesh.size)]
    grads[0][1][0] = 2.5 * 127 / 3          # ties to round
    res = [{"a": torch.randn(6, 5, generator=g) * 1e-2,
            "b": torch.randn(7, generator=g) * 1e-2}
           for _ in range(mesh.size)]
    tsh.reset_collectives()
    out, new_r = tgc.compressed_pod_psum(grads, res, mesh)
    assert tsh.COLLECTIVES["pod_psum_int8"]["calls"] == 2 * 2
    assert tsh.COLLECTIVES["pod_pmax"]["calls"] == 2 * 2
    for i, key in enumerate(("a", "b")):
        for grp in mesh.groups("pod"):
            gs = [grads[r][i].float().numpy() + res[r][key].numpy()
                  for r in grp]
            scale = np.float32(max(max(np.abs(x).max(), np.float32(1e-12))
                                   / np.float32(127.0) for x in gs))
            qs = [np.clip(np.round(x / scale), -127, 127) for x in gs]
            total = (sum(q.astype(np.int32) for q in qs).astype(np.float32)
                     * scale)
            for r, x, q in zip(grp, gs, qs, strict=True):
                np.testing.assert_array_equal(out[r][i].numpy(), total)
                np.testing.assert_array_equal(
                    new_r[r][key].numpy(), x - q.astype(np.float32) * scale)
            exact = sum(gs)
            assert (np.abs(total - exact) <= len(gs) * scale / 2 *
                    (1 + 1e-5)).all()


def test_fsdp_gather_and_its_reduce_scatter():
    """``fsdp_gather`` concatenates a ``data`` group's shards on every
    position; its backward gives shard j the sum of slice j of the
    positions' gradients, counted as one reduce-scatter a group."""
    mesh = _mesh((1, 2, 2))
    g = torch.Generator().manual_seed(1)
    full = [torch.randn(4, 3, generator=g) for _ in range(2)]     # model m
    ws = [full[mesh.axis_index("model", r)][
        2 * mesh.axis_index("data", r):2 * mesh.axis_index("data", r) + 2]
        .clone().requires_grad_() for r in range(mesh.size)]
    tsh.reset_collectives()
    got = mesh.fsdp_gather(ws, 0)
    for r in range(mesh.size):
        assert torch.equal(got[r], full[mesh.axis_index("model", r)])
    cts = [torch.randn(4, 3, generator=g) for _ in range(mesh.size)]
    torch.autograd.backward(got, cts)
    for r in range(mesh.size):
        grp = [q for q in mesh.groups("data") if r in q][0]
        d = mesh.axis_index("data", r)
        want = cts[grp[0]][2 * d:2 * d + 2] + cts[grp[1]][2 * d:2 * d + 2]
        assert torch.equal(ws[r].grad, want)
    assert tsh.COLLECTIVES["fsdp_gather"] == {"calls": 2,
                                              "bytes": 2 * 2 * 1 * 24}
    assert tsh.COLLECTIVES["reduce_scatter"]["calls"] == 2


def test_step_collectives_and_specs():
    """The inventory of a (1, 2, 2) step: the FSDP gathers run twice a
    superblock (the forward and remat's recompute) and once for the
    embedding and the head, their reduce-scatters once each, the TP sums'
    transposes in the backward; the specs of the state and the batch."""
    name = "qwen3-fsdp"
    cfg = _cfg(name)
    tree = _draw(cfg, _mesh((1, 2, 2)), 3)
    tsh.reset_collectives()
    _, st = _step(name, 0, tree, share=True)
    c = {k: dict(v) for k, v in tsh.COLLECTIVES.items()}
    n_leaves = sum(1 for spec in optimizer_specs(cfg) if "data" in spec)
    n_sb = sum(1 for spec in optimizer_specs(cfg, sb=True) if "data" in spec)
    # two data groups (one a model index); two microbatches
    per_mb = 2 * (2 * n_sb * cfg.n_sb + 2)
    assert c["fsdp_gather"]["calls"] == 2 * per_mb
    assert c["reduce_scatter"]["calls"] == 2 * 2 * (n_sb * cfg.n_sb + 2)
    assert c["tp_psum"]["calls"] > 0 and c["batch_psum"]["calls"] > 0
    assert c["pmax"]["calls"] > 0 and c["grad_sync"]["calls"] > 0
    assert n_leaves == n_sb + 2
    fn = st["fn"]
    assert fn.in_specs[3] == (("pod", "data"), None)
    assert fn.in_specs[1].step == ()
    assert TM.param_sync_axes(cfg)["final_ln"] == "pod,data,model"
    assert TM.param_sync_axes(cfg)["sb"]["pos0"]["core"].wq == "pod"
    assert tstep.auto_microbatch(cfg, 64, 4096, mesh=_mesh((2, 4, 2)),
                                 budget_bytes=1e5) == 8


def optimizer_specs(cfg, sb: bool = False) -> list:
    specs = TM.param_specs(cfg)
    return topt.leaves(specs["sb"] if sb else specs)


@pytest.mark.parametrize("fault", ["no_sync", "twice", "scaled"])
def test_planted_faults_are_caught(world, fault, monkeypatch):
    """The gates catch a replicated leaf's sum over its copies left out,
    one position's update applied twice to a shared tensor, and one small
    leaf's gradient 5% too large (final_ln's, the only 1-D leaf: the grad
    norm barely moves and the first AdamW step is sign(g) lr whatever the
    scale, so the moments must show it)."""
    if world["ref"] is None:
        pytest.skip("the reference (JAX) is not installed")
    name = "qwen3-fsdp"
    if fault == "no_sync":
        monkeypatch.setattr(tsh.ModelMesh, "grad_sync",
                            lambda self, gs, axes: list(gs))
    elif fault == "scaled":
        real_sync = tsh.ModelMesh.grad_sync

        def scaled(self, gs, axes):
            out = real_sync(self, gs, axes)
            return [g * 1.05 for g in out] if gs[0].dim() == 1 else out
        monkeypatch.setattr(tsh.ModelMesh, "grad_sync", scaled)
    else:
        real, hit = topt._adamw_leaf, []

        def twice(p, *a, **k):
            real(p, *a, **k)
            if p.dim() == 1 and not hit:       # final_ln, shared by all
                hit.append(p)
                real(p, *a, **k)
        monkeypatch.setattr(topt, "_adamw_leaf", twice)
    rec, _ = _step(name, 0, world["trees"][name], share=True)
    with pytest.raises(AssertionError):
        _hold(name, 1, rec, world["ref"]()[name][0])


def test_checkpoints_reshard_across_packages(world, tmp_path):
    """The reference's checkpoint of (1, 2, 2) restored by the port onto
    (2, 1, 2) and (1, 1, 1), in both layouts, gathers back to the
    reference's state bit for bit; the port's, written from (1, 2, 2),
    restored by the reference onto (1, 2, 2), equals what the port saved;
    ``elastic.remesh`` restores onto the survivors' mesh; a step on the
    restored state equals the step on the live one."""
    cfg = _cfg(CKPT_CASE)
    specs = TM.param_specs(cfg)
    all_specs = {"params": specs, "opt": topt.state_specs(specs)}
    glob = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                          mesh=_mesh((1, 1, 2)))
    template = {"params": glob, "opt": topt.init(glob)}
    if world["ref"] is not None:
        ref = world["ref"]()
        want = {k: ref[CKPT_CASE][1][k] for k in ("params", "opt")}
        ck = Checkpointer(world["ref_dir"])
        for shape in ((2, 1, 2), (1, 1, 1)):
            mesh = _mesh(shape)
            for share in (True, False):
                per = ck.restore(2, template, mesh=mesh, specs=all_specs,
                                 share=share)
                back = sstep.gather_tree(per, all_specs, mesh)
                for a, b in zip(_leaves_np(back), _leaves_np(want),
                                strict=True):
                    np.testing.assert_array_equal(a, b)
                assert all(p["opt"].step.dtype == torch.int32 for p in per)
        got = ref["port_ckpt"]
        for a, b in zip(_leaves_np(got), _leaves_np(world["port_saved"]),
                        strict=True):
            np.testing.assert_array_equal(a, b)
    # the port's own: save from one mesh, restore onto another, step on
    ck = Checkpointer(world["port_dir"])
    mesh, per = telastic.remesh(ck, template, all_specs, 2, model_parallel=2,
                                devices="cpu")
    assert mesh.shape == (1, 1, 2)
    back = sstep.gather_tree(per, all_specs, mesh)
    assert _equal_trees(back, world["port_saved"])
    with pytest.raises(ValueError, match="both or neither"):
        ck.restore(1, template, mesh=mesh)
    mesh = _mesh(CASES[CKPT_CASE][2])
    fn = tstep.make_train_step(cfg, mesh, lr=LR, microbatch=2)
    args = [sstep.shard_tree(torch.from_numpy(a), sp, mesh)
            for a, sp in zip(_batches(CKPT_CASE)[1], fn.in_specs[3:],
                             strict=True)]
    outs = []
    for per in (ck.restore(1, template, mesh=mesh, specs=all_specs),
                sstep.shard_tree(world["port_saved"], all_specs, mesh)):
        ps, st, _, m = fn([p["params"] for p in per],
                          [p["opt"] for p in per], None, *args)
        outs.append((m, sstep.gather_tree(ps, specs, mesh)))
    assert torch.equal(outs[0][0]["loss"], outs[1][0]["loss"])
    assert _equal_trees(outs[0][1], outs[1][1])


def test_remat_recompute_is_seen_as_backward():
    """``kernels.flash.in_backward`` (which sorts K8's launches into
    ``REMAT_LAUNCHES``) is False in a checkpointed forward and True in its
    recompute, which the backward runs."""
    from torch.utils.checkpoint import checkpoint
    from repro_torch.kernels import flash as tflash
    seen = []

    def body(x):
        seen.append(tflash.in_backward())
        return (x * 2).sin()
    x = torch.ones(3, requires_grad=True)
    checkpoint(body, x, use_reentrant=False).sum().backward()
    assert seen == [False, True] and not tflash.in_backward()


def test_psum_dtype_is_the_steps_argument():
    """``make_train_step(..., psum_dtype=)`` casts every ``tp_psum``'s
    operands before the sum (the reference's ``set_psum_dtype``, a global
    there): a field of the step's mesh, the mesh passed in untouched."""
    mesh = _mesh((1, 1, 2))
    xs = [torch.tensor([1.0 + 2.0 ** -10, 3.0]), torch.tensor([1.0, 1.0])]
    assert mesh.tp_psum(xs)[0].tolist() == [2.0 + 2.0 ** -10, 4.0]
    bf = dataclasses.replace(mesh, psum_dtype=torch.bfloat16)
    got = bf.tp_psum(xs)
    assert got[0].dtype == torch.bfloat16 and got[1].tolist() == [2.0, 4.0]
    fn = tstep.make_train_step(_cfg("qwen3-kv1"), mesh,
                               psum_dtype=torch.bfloat16)
    assert fn.mesh.psum_dtype == torch.bfloat16 and mesh.psum_dtype is None


def test_residual_checkpoint_reshards(tmp_path):
    """The int8 step's whole state (parameters, AdamW state, residual)
    saved from (2, 1, 2) and restored onto (1, 1, 2) and (2, 2, 1) in both
    layouts gathers back bit for bit."""
    name = "qwen3-pod-int8"
    _, st = _step(name, 0, _draw(_cfg(name), _mesh((2, 1, 2)), 9),
                  share=True)
    specs, ospecs, rspecs = st["fn"].in_specs[:3]
    all_specs = {"params": specs, "opt": ospecs, "res": rspecs}
    per = [{"params": p, "opt": o, "res": r} for p, o, r in
           zip(st["params"], st["opt"], st["res"], strict=True)]
    saved = sstep.gather_tree(per, all_specs, st["mesh"])
    assert any(t.any() for t in topt.leaves(saved["res"]))
    ck = Checkpointer(str(tmp_path))
    ck.save(1, per, mesh=st["mesh"], specs=all_specs, blocking=True)
    for shape in ((1, 1, 2), (2, 2, 1)):
        for share in (True, False):
            mesh = _mesh(shape)
            back = ck.restore(1, saved, mesh=mesh, specs=all_specs,
                              share=share)
            assert _equal_trees(sstep.gather_tree(back, all_specs, mesh),
                                saved)
