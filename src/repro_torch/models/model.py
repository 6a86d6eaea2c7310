"""The decoder of the LM path on one device (a port of
``repro.models.model``: attention, Mamba, mLSTM and sLSTM layers, with a
dense or MoE FFN).

One parameter factory (``build_tree``) gives every leaf's shape and
initialiser; ``init_params`` instantiates it from a ``torch.Generator``
(the reference draws from ``jax.random``, so the two packages' random
weights differ: the parity tests carry the reference's weights across with
``convert.lm_params_from_arrays``).  Superblock leaves are stacked on a
leading axis of length ``cfg.n_sb``, as in the reference; the reference's
scan over superblocks is a loop over that axis.

Forward modes: ``"train"`` (full sequence, loss-ready hidden states; with
``remat`` each superblock is checkpointed, as the reference's
``jax.checkpoint`` of its scan body), ``"prefill"`` (full sequence, into
fresh caches when given) and ``"decode"`` (one token against the caches).
Caches (K/V for attention layers, the recurrent states of the others) are
updated in place and returned.  ``lm_loss`` is the chunked cross-entropy
the train step differentiates; ``"train"`` runs through every layer
kind (the recurrent blocks' training forms: ``models/ssm.py``,
``models/xlstm.py``), and the superblock's checkpoint recomputes the
sLSTM's loop and K8's bias tile in the backward as it does any layer.
Embedding-input archs (``cfg.embed_input``: musicgen's frame embeddings)
have no ``embed`` leaf and take (B, S, d) inputs; M-RoPE archs
(``cfg.rope == "mrope"``: qwen2-vl) take (3, B, S) (t, h, w) ids.

On a mesh (``forward(..., mesh=)``, a ``models.sharding.ModelMesh``) the
decoder runs the reference's manual-SPMD program: every tree and input is
a list with one entry a position (its local shard, ``serve.step.
shard_tree``), each leaf's ``spec`` (``param_specs``) says how the global
leaf is cut, and the blocks end in the reference's collectives.  Tensor-
parallel layouts (``cfg.tp_shard``) run only there: attention, the dense
MLP, the MoE FFN (experts over ``model``) and Mamba (``d_inner`` over
``model``, its states the position's channels, replicated over ``data``
in sequence-sharded decode).  The xLSTM blocks under ``tp_shard`` raise
``not_ported`` (ROADMAP queue 1 item 14d); the reference replicates them.

Training on a mesh (``forward(..., mode="train", mesh=)``, ``lm_loss(...,
mesh=)``) is the reference's ``shard_map`` step: every leaf cut by its
whole spec, ``data`` included (FSDP storage, ``param_specs``), each
superblock's leaves gathered over ``data`` (``ModelMesh.fsdp_gather``)
inside its checkpoint, so that the backward gathers them again rather
than keeping them, the embedding and the head gathered where they are
used, and the loss the vocab-sharded cross-entropy summed over the batch
axes.  ``param_sync_axes`` names the axes each leaf is replicated on,
over which ``train.step`` sums its gradients.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import not_ported, resolve_device
from . import layers, ssm, xlstm
from .sharding import FSDP, TP, batch_axes_for

F32 = torch.float32
BF16 = torch.bfloat16


# ---------------------------------------------------------------------------
# parameter factory
# ---------------------------------------------------------------------------
class Leaf(NamedTuple):
    shape: tuple
    fan_in: int          # init scale (0 -> zeros, -1 -> ones)
    spec: tuple          # PartitionSpec entries (before stacking)


def _supported(cfg) -> None:
    """Block kinds the port runs; under ``tp_shard`` all but the xLSTM
    blocks (the reference replicates xlstm: ``tp_shard=False``)."""
    for kind in set(cfg.pattern):
        if kind not in KINDS:
            raise ValueError(f"unknown block kind {kind!r}")
    if cfg.tp_shard:
        for kind in sorted(set(cfg.pattern) - {"attn", "mamba"}):
            layers.not_under_tp(True, f"the {kind} block")


def _layout(cfg, mesh) -> None:
    """A tensor-parallel layout needs a mesh whose ``model`` axis divides
    its sharded dimensions."""
    if not cfg.tp_shard:
        return
    if mesh is None:
        layers._no_tp(True)
    n = mesh.axis_size(TP)
    dims = {"n_heads_padded": cfg.n_heads_padded,
            "vocab_padded": cfg.vocab_padded, "d_ff": cfg.d_ff}
    if cfg.kv_sharded:
        dims["n_kv_padded"] = cfg.n_kv_padded
    if "mamba" in cfg.pattern:
        dims["d_inner"] = cfg.d_inner
    if cfg.moe is not None and cfg.moe.n_shared:
        dims["n_shared * d_expert"] = cfg.moe.n_shared * cfg.moe.d_expert
    bad = {k: v for k, v in dims.items() if v % n}
    if bad:
        raise ValueError(f"a model axis of {n} does not divide {bad}")


KINDS = ("attn", "mamba", "mlstm", "slstm")
_STATE = {"mamba": ssm.MambaState, "mlstm": xlstm.MLSTMState,
          "slstm": xlstm.SLSTMState}


def _core_leaves(cfg, kind: str):
    d, dh = cfg.d_model, cfg.head_dim
    tp = TP if cfg.tp_shard else None
    no = (None,)
    if kind == "attn":
        H, KV = cfg.n_heads_padded, cfg.n_kv_padded
        kv = TP if cfg.kv_sharded else None
        return layers.AttnParams(
            ln=Leaf((d,), -1, no),
            wq=Leaf((d, H * dh), d, (FSDP, tp)),
            wk=Leaf((d, KV * dh), d, (FSDP, kv)),
            wv=Leaf((d, KV * dh), d, (FSDP, kv)),
            wo=Leaf((H * dh, d), H * dh, (tp, FSDP)),
            bq=Leaf((H * dh,), 0, (tp,)) if cfg.qkv_bias else None,
            bk=Leaf((KV * dh,), 0, (kv,)) if cfg.qkv_bias else None,
            bv=Leaf((KV * dh,), 0, (kv,)) if cfg.qkv_bias else None,
            qn=Leaf((dh,), -1, no) if cfg.qk_norm else None,
            kn=Leaf((dh,), -1, no) if cfg.qk_norm else None,
        )
    if kind == "mamba":
        di, ds, dtr, K = cfg.d_inner, cfg.d_state, cfg.dt_rank, cfg.d_conv
        return ssm.MambaParams(
            ln=Leaf((d,), -1, no),
            in_proj=Leaf((d, 2 * di), d, (FSDP, tp)),
            conv_w=Leaf((K, di), K, (None, tp)),
            conv_b=Leaf((di,), 0, (tp,)),
            x_proj=Leaf((di, dtr + 2 * ds), di, (tp, None)),
            dt_w=Leaf((dtr, di), dtr, (None, tp)),
            dt_b=Leaf((di,), 0, (tp,)),
            a_log=Leaf((di, ds), -1, (tp, None)),
            d_skip=Leaf((di,), -1, (tp,)),
            out_proj=Leaf((di, d), di, (tp, FSDP)),
        )
    NH, ef = cfg.xl_heads, cfg.expand * d
    if kind == "mlstm":
        return xlstm.MLSTMParams(
            ln=Leaf((d,), -1, no),
            w_qkv=Leaf((ef, 3 * ef), ef, (FSDP, tp)),
            w_if=Leaf((d, 2 * NH), d, (FSDP, None)),
            b_if=Leaf((2 * NH,), 0, no),
            w_o=Leaf((d, ef), d, (FSDP, tp)),
            w_up=Leaf((d, 2 * ef), d, (FSDP, tp)),
            w_down=Leaf((ef, d), ef, (tp, FSDP)),
            ln_inner=Leaf((ef,), -1, no),
        )
    dh_s = d // NH
    return xlstm.SLSTMParams(
        ln=Leaf((d,), -1, no),
        w_x=Leaf((d, 4 * NH * dh_s), d, (FSDP, tp)),
        r_h=Leaf((NH, dh_s, 4 * dh_s), dh_s, (None, None, None)),
        b=Leaf((4 * NH * dh_s,), 0, no),
        w_up=Leaf((d, ef), d, (FSDP, tp)),
        w_down=Leaf((ef, d), ef, (tp, FSDP)),
        ln_ff=Leaf((d,), -1, no),
    )


def _block_leaves(cfg, kind: str, pos: int) -> dict:
    d = cfg.d_model
    tp = TP if cfg.tp_shard else None
    out: dict[str, Any] = {"core": _core_leaves(cfg, kind)}
    # the FFN stage: attention and Mamba layers only (xLSTM blocks carry
    # their own up and down projections)
    if kind not in ("attn", "mamba") or cfg.d_ff <= 0:
        out["ffn"] = None
    elif cfg.moe_at(pos):
        mc = cfg.moe
        fe, E = mc.d_expert, cfg.n_experts_padded
        sh = mc.n_shared * mc.d_expert
        out["ffn"] = layers.MoEParams(
            ln=Leaf((d,), -1, (None,)),
            router=Leaf((d, mc.n_experts), d, (FSDP, None)),
            w_gate=Leaf((E, d, fe), d, (tp, FSDP, None)),
            w_up=Leaf((E, d, fe), d, (tp, FSDP, None)),
            w_down=Leaf((E, fe, d), fe, (tp, None, FSDP)),
            sh_gate=Leaf((d, sh), d, (FSDP, tp)) if mc.n_shared else None,
            sh_up=Leaf((d, sh), d, (FSDP, tp)) if mc.n_shared else None,
            sh_down=Leaf((sh, d), sh, (tp, FSDP)) if mc.n_shared else None,
        )
    else:
        out["ffn"] = layers.MLPParams(
            ln=Leaf((d,), -1, (None,)),
            w_gate=Leaf((d, cfg.d_ff), d, (FSDP, tp)),
            w_up=Leaf((d, cfg.d_ff), d, (FSDP, tp)),
            w_down=Leaf((cfg.d_ff, d), cfg.d_ff, (tp, FSDP)),
        )
    return out


def _tree(cfg) -> dict:
    _supported(cfg)
    d = cfg.d_model
    tp = TP if cfg.tp_shard else None
    tree: dict[str, Any] = {}
    if not cfg.embed_input:
        tree["embed"] = Leaf((cfg.vocab_padded, d), d, (tp, FSDP))
    tree["sb"] = {f"pos{i}": _block_leaves(cfg, cfg.pattern[i], i)
                  for i in range(cfg.sb)}
    tree["final_ln"] = Leaf((d,), -1, (None,))
    tree["lm_head"] = Leaf((d, cfg.vocab_padded), d, (FSDP, tp))
    return tree


def build_tree(cfg, mesh=None) -> dict:
    """Leaf-description tree (superblock leaves before stacking; GLOBAL
    shapes, each leaf's ``spec`` saying how a mesh cuts it); no ``embed``
    leaf where ``cfg.embed_input`` (the reference's tree).  A tensor-
    parallel layout (``cfg.tp_shard``) is built only for the ``mesh`` it
    runs on, whose ``model`` axis must divide its sharded dimensions."""
    _layout(cfg, mesh)
    return _tree(cfg)


def param_specs(cfg) -> dict:
    """The PartitionSpec of every leaf as a tuple of mesh axis names (or
    None) a dimension, stacked leaves with a leading None: the
    reference's ``param_specs`` (``repro/models/model.py:165``)."""
    tree = _tree(cfg)
    out = {k: tree_map(lambda l: l.spec, v) for k, v in tree.items()
           if k != "sb"}
    out["sb"] = tree_map(lambda l: (None,) + l.spec, tree["sb"])
    return out


def param_sync_axes(cfg) -> dict:
    """Each leaf's mesh axes it is replicated on (those its spec does not
    name), comma-joined in pod, data, model order: the axes its gradient
    is summed over (the reference's ``param_sync_axes``, ``repro/models/
    model.py:194``)."""
    return tree_map(lambda spec: ",".join(
        a for a in ("pod", "data", "model") if a not in spec),
        param_specs(cfg))


def fsdp_dim(spec) -> int | None:
    """The dimension a leaf's spec cuts over ``data`` (the FSDP
    dimension), or None."""
    return spec.index(FSDP) if FSDP in spec else None


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a tree of dicts and NamedTuples (``None``
    entries stay ``None``), and of trees of the same structure in
    ``rest`` beside it."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(t[k] for t in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields") \
            and not isinstance(tree, Leaf):
        return type(tree)(*(tree_map(fn, v, *(t[i] for t in rest))
                            for i, v in enumerate(tree)))
    return fn(tree, *rest)


def init_params(cfg, generator: torch.Generator, device=None,
                mesh=None) -> dict:
    """Random bf16 weights on ``device`` (CUDA unless ``device="cpu"``):
    each leaf N(0, 1) / sqrt(fan_in) drawn in f32 from ``generator`` and
    rounded to bf16; zeros for biases, ones for norm scales.  Stacked
    leaves are drawn one superblock at a time (bounded f32 scratch).  The
    GLOBAL tree; a tensor-parallel layout names the ``mesh`` it is for
    (``build_tree``), and ``serve.step.shard_tree`` cuts it onto the
    mesh's positions."""
    dev = resolve_device(device)
    tree = build_tree(cfg, mesh)

    def make(leaf: Leaf, stacked: bool):
        shape = ((cfg.n_sb,) if stacked else ()) + leaf.shape
        if leaf.fan_in == 0:
            return torch.zeros(shape, dtype=BF16, device=dev)
        if leaf.fan_in == -1:
            return torch.ones(shape, dtype=BF16, device=dev)
        out = torch.empty(shape, dtype=BF16, device=dev)
        for part in (out if stacked else [out]):
            w = torch.randn(leaf.shape, generator=generator, dtype=F32,
                            device=dev)
            part.copy_(w.div_(leaf.fan_in ** 0.5))
        return out

    params = {k: make(v, False) for k, v in tree.items() if k != "sb"}
    params["sb"] = tree_map(lambda l: make(l, True), tree["sb"])
    return params


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------
def cache_shapes(cfg, batch: int, max_seq: int, *, seq_shard: int = 1,
                 local: bool = True) -> dict:
    """``pos{i}`` -> {name: (shape, dtype)} of each layer position's cache,
    stacked over superblocks (the reference's ``init_cache``): K/V (n_sb,
    batch, max_seq / seq_shard, KV, head_dim) bf16; Mamba ``conv`` (n_sb,
    batch, d_conv - 1, d_inner) bf16 and ``h`` (n_sb, batch, d_inner,
    d_state) f32; mLSTM ``c`` (n_sb, batch, NH, dh, dh), ``n`` (.., NH,
    dh), ``m`` (.., NH) f32 with dh = expand d / NH; sLSTM ``h``, ``c``,
    ``n``, ``m`` (n_sb, batch, NH, d / NH) f32.  KV is ``n_kv_heads``
    outside tensor parallelism; under ``tp_shard`` a position's (``local``)
    ``n_kv_padded / tp`` where the KV heads are sharded and 1 where they
    are replicated (the one slot its query heads read), the global cache
    ``tp`` times that (``local=False``).  ``seq_shard`` > 1 cuts the time
    axis into that many chunks (sequence-sharded decode)."""
    _supported(cfg)
    lead = (cfg.n_sb, batch)
    tp = cfg.tp if (cfg.tp_shard and local) else 1
    out = {}
    for i in range(cfg.sb):
        kind = cfg.pattern[i]
        if kind == "attn":
            if cfg.kv_sharded:
                kvl = cfg.n_kv_padded // tp
            elif cfg.tp_shard:
                kvl = 1 if local else cfg.tp
            else:
                kvl = cfg.n_kv_heads
            kv = (lead + (max_seq // seq_shard, kvl, cfg.head_dim), BF16)
            out[f"pos{i}"] = {"k": kv, "v": kv}
        elif kind == "mamba":
            out[f"pos{i}"] = {
                "conv": (lead + (cfg.d_conv - 1, cfg.d_inner // tp), BF16),
                "h": (lead + (cfg.d_inner // tp, cfg.d_state), F32)}
        elif kind == "mlstm":
            NH = cfg.xl_heads
            dh = cfg.expand * cfg.d_model // NH
            out[f"pos{i}"] = {"c": (lead + (NH, dh, dh), F32),
                              "n": (lead + (NH, dh), F32),
                              "m": (lead + (NH,), F32)}
        else:
            z = (lead + (cfg.xl_heads, cfg.d_model // cfg.xl_heads), F32)
            out[f"pos{i}"] = {k: z for k in ("h", "c", "n", "m")}
    return out


def init_cache(cfg, batch: int, max_seq: int, *, seq_shard: int = 1,
               local: bool = True, device=None) -> dict:
    """The decode-state tree (``cache_shapes``) as zeros on ``device``."""
    dev = resolve_device(device)
    shapes = cache_shapes(cfg, batch, max_seq, seq_shard=seq_shard,
                          local=local)
    return {pos: {k: torch.zeros(shape, dtype=dt, device=dev)
                  for k, (shape, dt) in leaves.items()}
            for pos, leaves in shapes.items()}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _take(w: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    V = w.shape[0]
    ok = (ids >= 0) & (ids < V)
    x = w[ids.clamp(0, V - 1).long()]
    return torch.where(ok[..., None], x, torch.zeros((), dtype=w.dtype,
                                                     device=w.device))


def embed_tokens(params, cfg, tokens: torch.Tensor, tp_shard: bool,
                 mesh=None) -> torch.Tensor:
    """Embedding rows of ``tokens``; an id outside the table gives a zero
    row, as the reference's masked take does.  On a mesh (``params`` and
    ``tokens`` lists over its positions) with ``tp_shard`` each position
    takes the rows of its vocab range ``[m V_l, (m + 1) V_l)``, zero
    outside it, and the positions' rows are summed over ``model`` in f32
    (``tp_psum``), then rounded to bf16."""
    if mesh is None:
        layers._no_tp(tp_shard)
        return _take(params["embed"], tokens)
    xs = []
    for r in range(mesh.size):
        w = params[r]["embed"]
        base = mesh.axis_index(TP, r) * w.shape[0] if tp_shard else 0
        xs.append(_take(w, tokens[r] - base))
    if tp_shard:
        xs = [t.to(BF16) for t in mesh.tp_psum([t.to(F32) for t in xs])]
    return xs


def _run_block_mesh(cfg, kind: str, blk: list, x: list, *, pos: list,
                    cache, mesh) -> tuple:
    """``_run_block`` on a mesh: ``blk``, ``x``, ``pos`` and ``cache``
    lists over its positions.  Attention, Mamba, the dense MLP and the MoE
    FFN each end in their ``tp_psum`` (the parallel block's two partials
    share one, as the reference's ``_run_block`` at ``:277-287``); the
    xLSTM blocks (outside tensor parallelism only) run a position at a
    time."""
    tp = cfg.tp_shard
    ffn = blk[0].get("ffn")
    core = [b["core"] for b in blk]
    ffns = [b["ffn"] for b in blk]
    if kind == "attn" and cfg.parallel_block and \
            isinstance(ffn, layers.MLPParams):
        o, new_cache = layers.attention_block(
            core, x, cfg, pos=pos, cache=cache, tp_shard=tp, reduce=False,
            mesh=mesh)
        m = layers.mlp_block(ffns, x, cfg, tp_shard=tp, reduce=False,
                             mesh=mesh)
        comb = [a + b for a, b in zip(o, m, strict=True)]
        if tp:
            comb = mesh.tp_psum(comb)
        return [xr + c.to(xr.dtype)
                for xr, c in zip(x, comb, strict=True)], new_cache
    if kind == "attn":
        o, new_cache = layers.attention_block(core, x, cfg, pos=pos,
                                              cache=cache, tp_shard=tp,
                                              mesh=mesh)
        x = [xr + orr for xr, orr in zip(x, o, strict=True)]
    elif kind == "mamba":
        st = None if cache is None else [ssm.MambaState(**c) for c in cache]
        o, nst = ssm.mamba_block(core, x, cfg, state=st, tp_shard=tp,
                                 mesh=mesh)
        x = [xr + orr for xr, orr in zip(x, o, strict=True)]
        new_cache = [None if s is None else s._asdict() for s in nst]
    else:
        done = [_run_block(cfg, 0, kind, {"core": c, "ffn": None}, xr,
                           pos=pr, cache=None if cache is None else cache[r],
                           tp_shard=tp)
                for r, (c, xr, pr) in enumerate(zip(core, x, pos,
                                                       strict=True))]
        x = [d[0] for d in done]
        new_cache = [d[1] for d in done]
    if isinstance(ffn, layers.MoEParams):
        m = layers.moe_block(ffns, x, cfg, tp_shard=tp, mesh=mesh)
        x = [xr + mr for xr, mr in zip(x, m, strict=True)]
    elif ffn is not None:
        m = layers.mlp_block(ffns, x, cfg, tp_shard=tp, mesh=mesh)
        x = [xr + mr for xr, mr in zip(x, m, strict=True)]
    return x, new_cache


def _run_block(cfg, pos_idx: int, kind: str, blk_params, x, *, pos, cache,
               tp_shard):
    """One layer: (x, new_cache).  ``cache`` is the layer's K/V dict (with
    ``length``) or its recurrent state's dict; ``new_cache`` the written
    K/V, or the new state's dict where a cache was given (Mamba also
    without one at S = 1), as the reference's ``_run_block``."""
    ffn = blk_params.get("ffn")
    core = blk_params["core"]
    new_cache = None
    if kind == "attn" and cfg.parallel_block and \
            isinstance(ffn, layers.MLPParams):
        # Cohere-style parallel block: attention and FFN read the same input
        o, new_cache = layers.attention_block(
            core, x, cfg, pos=pos, cache=cache, tp_shard=tp_shard,
            reduce=False)
        m = layers.mlp_block(ffn, x, cfg, tp_shard=tp_shard, reduce=False)
        return x + (o + m).to(x.dtype), new_cache
    if kind == "attn":
        o, new_cache = layers.attention_block(core, x, cfg, pos=pos,
                                              cache=cache, tp_shard=tp_shard)
        x = x + o
    else:
        st = _STATE[kind](**cache) if cache is not None else None
        block = {"mamba": ssm.mamba_block, "mlstm": xlstm.mlstm_block,
                 "slstm": xlstm.slstm_block}[kind]
        o, nst = block(core, x, cfg, state=st, tp_shard=tp_shard)
        x = o if kind == "slstm" else x + o   # the sLSTM's output replaces x
        if nst is not None and (cache is not None or kind == "mamba"):
            new_cache = nst._asdict()
    if isinstance(ffn, layers.MoEParams):
        x = x + layers.moe_block(ffn, x, cfg, tp_shard=tp_shard)
    elif ffn is not None:
        x = x + layers.mlp_block(ffn, x, cfg, tp_shard=tp_shard)
    return x, new_cache


def unstack(sb, n_sb: int) -> list:
    """The superblock leaves of each layer: ``torch.unbind`` of every
    stacked leaf, views into it.  Under a gradient the stacked leaf
    receives the layers' gradients as one stack (unbind's backward), not a
    zero-filled full-size tensor a layer as single indexing would."""
    per = tree_map(lambda t: t.unbind(0), sb)
    return [tree_map(lambda ts, _l=layer: ts[_l], per)
            for layer in range(n_sb)]


def _cache_len(cache_len, pos):
    """Decode's filled prefix: an int as an int; a tensor (or, where none
    is given, the first entry of ``pos``) as a 0-d int32 tensor, on the
    device it lies on, read nowhere on the host."""
    if cache_len is None:
        cache_len = pos.reshape(-1)[0]
    if isinstance(cache_len, torch.Tensor):
        return cache_len.reshape(()).to(torch.int32)
    return int(cache_len)


def _decode_pos(cache_len, shape, device) -> torch.Tensor:
    """Every query's position in a decode step: ``cache_len`` over
    ``shape`` (B, S), int32 (a tensor expanded, an int filled)."""
    if isinstance(cache_len, torch.Tensor):
        return cache_len.expand(shape)
    return torch.full(shape, cache_len, dtype=torch.int32, device=device)


def forward(params, cfg, inputs: torch.Tensor, *, pos, caches=None,
            mode: str = "train", remat: bool = True, cache_len=None,
            seq_sharded: bool = False, mesh=None, fsdp: bool = False):
    """inputs: token ids (B, S), or embeddings (B, S, d) where
    ``cfg.embed_input`` (cast to bf16).  pos: (B, S) positions, or (3, B,
    S) (t, h, w) ids for M-RoPE.  Decode takes ``cache_len`` (an int, or a
    0-d int32 tensor on the model's device, the reference's traced
    ``cache_len``, which stays a tensor and is read nowhere on the host;
    default the first entry of ``pos``, as a tensor) as the caches' filled
    prefix and, but for M-RoPE, as every query's position; M-RoPE keeps
    the caller's ids, as the reference does.  Returns (hidden (B, S, d),
    caches) -- the caches written in place (K/V at the filled prefix, each
    recurrent layer's state replaced by its new one), or None without
    caches.
    ``mode="train"`` with ``remat`` (and autograd recording) checkpoints
    each superblock (``torch.utils.checkpoint``, non-reentrant): its
    activations are recomputed in the backward, K8 launched again.

    With ``mesh`` (a ``ModelMesh``) ``params``, ``inputs``, ``pos`` and
    ``caches`` are lists over its positions (``_forward_mesh``), and so is
    the hidden state returned; ``seq_sharded`` decodes against caches
    whose time axis is cut over ``data``; ``mode="train"`` on a mesh takes
    the parameters in FSDP storage, and so do prefill and
    decode with ``fsdp`` (serving from FSDP storage, the reference's
    ``set_fsdp_gather(True)``: each superblock's leaves and the embedding
    gathered over ``data`` at use, ``gather_fsdp``)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"forward(mode={mode!r}): train, prefill or decode")
    if mesh is not None:
        return _forward_mesh(params, cfg, inputs, pos=pos, caches=caches,
                             mode=mode, cache_len=cache_len,
                             seq_sharded=seq_sharded, mesh=mesh, remat=remat,
                             fsdp=fsdp)
    if fsdp:
        raise ValueError("fsdp storage is a mesh's: pass mesh=")
    if seq_sharded:
        raise not_ported("sequence-sharded KV caches without a mesh (pass "
                         "mesh=, a ModelMesh)", "14d")
    _supported(cfg)
    _layout(cfg, None)
    if cfg.embed_input:
        x = inputs.to(BF16)
    else:
        x = embed_tokens(params, cfg, inputs, cfg.tp_shard)
    if mode == "decode":
        cache_len = _cache_len(cache_len, pos)
        if cfg.rope != "mrope":
            pos = _decode_pos(cache_len, inputs.shape[:2], x.device)
    elif caches is not None:           # prefill into fresh caches
        cache_len = 0

    def superblock(x, p_sb, layer):
        for i in range(cfg.sb):
            kind, c = cfg.pattern[i], None
            if caches is not None:
                c = {k: t[layer] for k, t in caches[f"pos{i}"].items()}
                if kind == "attn":
                    c["length"] = cache_len
            x, nc = _run_block(cfg, i, kind, p_sb[f"pos{i}"], x, pos=pos,
                               cache=c, tp_shard=cfg.tp_shard)
            if kind != "attn" and c is not None and nc is not None:
                for k, t in nc.items():       # the new state, in place
                    c[k].copy_(t)
        return x

    ckpt = mode == "train" and remat and caches is None \
        and torch.is_grad_enabled()
    for layer, p_sb in enumerate(unstack(params["sb"], cfg.n_sb)):
        if ckpt:
            x = checkpoint(superblock, x, p_sb, layer, use_reentrant=False)
        else:
            x = superblock(x, p_sb, layer)
    return x, caches


def gather_fsdp(trees: list, specs, mesh) -> list:
    """The positions' trees with every leaf gathered over ``data`` along
    the dimension its spec cuts (``fsdp_dim``; the other leaves as they
    are): the reference's ``fsdp_gather`` at each use, as one collective a
    leaf.  ``specs`` is the trees' spec tree."""
    per = tree_map(lambda spec, *ws: list(ws) if fsdp_dim(spec) is None
                   else mesh.fsdp_gather(list(ws), fsdp_dim(spec)),
                   specs, *trees)
    return [tree_map(lambda ws, _r=r: ws[_r], per) for r in range(len(trees))]


def _forward_mesh(params: list, cfg, inputs: list, *, pos: list, caches,
                  mode: str, cache_len, seq_sharded: bool, mesh,
                  remat: bool = True, fsdp: bool = False) -> tuple:
    """``forward`` on a mesh (the reference's under ``shard_map``,
    ``repro/models/model.py:325-366``): the embedding (``tp_psum`` of the
    vocab shards' rows), then each layer a position at a time between its
    collectives.  In FSDP storage (``mode="train"`` always, prefill and
    decode with ``fsdp``) the embedding is gathered over ``data``
    (``_embed_mesh``), and so are each superblock's leaves
    (``gather_fsdp``), dropped once the superblock has run.  Training runs
    each superblock under ``torch.utils.checkpoint`` with ``remat`` while
    autograd records, so that the backward gathers the leaves and runs the
    layers (K8 included) again."""
    _supported(cfg)
    _layout(cfg, mesh)
    if mode == "train":
        if caches is not None or seq_sharded:
            raise ValueError("mode='train' takes no caches")
        fsdp = True
    elif seq_sharded and (caches is None or mode != "decode"):
        raise ValueError("seq_sharded decodes against sequence-sharded "
                         "caches: mode='decode' with caches")
    D = mesh.size
    x = _embed_mesh(params, cfg, inputs, mesh, fsdp)
    lens = [0] * D                     # each position's cache_len
    if mode == "decode":
        cache_len = _cache_len(cache_len, pos[0])
        lens = [cache_len.to(xr.device) if isinstance(cache_len, torch.Tensor)
                else cache_len for xr in x]
        if cfg.rope != "mrope":
            pos = [_decode_pos(n, t.shape[:2], xr.device)
                   for n, t, xr in zip(lens, inputs, x, strict=True)]
    per = [unstack(params[r]["sb"], cfg.n_sb) for r in range(D)]
    specs = tree_map(lambda l: l.spec, _tree(cfg)["sb"]) if fsdp else None

    def superblock(x, layer):
        blks = [per[r][layer] for r in range(D)]
        if fsdp:
            blks = gather_fsdp(blks, specs, mesh)
        for i in range(cfg.sb):
            kind, c = cfg.pattern[i], None
            if caches is not None:
                c = [{k: t[layer] for k, t in caches[r][f"pos{i}"].items()}
                     for r in range(D)]
                if kind == "attn":
                    for cr, n in zip(c, lens, strict=True):
                        cr.update(length=n, seq_sharded=seq_sharded)
            x, nc = _run_block_mesh(cfg, kind,
                                    [b[f"pos{i}"] for b in blks], x,
                                    pos=pos, cache=c, mesh=mesh)
            if kind != "attn" and c is not None:
                for cr, ncr in zip(c, nc, strict=True):
                    for k, t in (ncr or {}).items():   # the new state
                        cr[k].copy_(t)
        return x

    ckpt = mode == "train" and remat and torch.is_grad_enabled()
    for layer in range(cfg.n_sb):
        x = checkpoint(superblock, x, layer, use_reentrant=False) if ckpt \
            else superblock(x, layer)
    return x, caches


def _embed_mesh(params: list, cfg, inputs: list, mesh, fsdp: bool) -> list:
    """Each position's embedded inputs; in FSDP storage the table gathered
    over ``data`` first."""
    if cfg.embed_input:
        return [t.to(BF16) for t in inputs]
    if fsdp:
        params = [{"embed": w} for w in
                  mesh.fsdp_gather([p["embed"] for p in params], 1)]
    return embed_tokens(params, cfg, inputs, cfg.tp_shard, mesh=mesh)


def _heads_mesh(params: list, mesh, fsdp: bool) -> list:
    """Each position's ``lm_head``; in FSDP storage gathered over ``data``."""
    heads = [p["lm_head"] for p in params]
    return mesh.fsdp_gather(heads, 0) if fsdp else heads


def lm_logits(params, cfg, x: torch.Tensor, tp_shard: bool,
              mesh=None, fsdp: bool = False) -> torch.Tensor:
    """(B, S, V_padded) f32 logits.  On a mesh (lists over its positions)
    each position's (B, S, V_padded / model) logits of its vocab shard
    (``tp_shard``) or all of them; with ``fsdp`` the head is gathered over
    ``data`` first (FSDP storage)."""
    if mesh is not None:
        return [layers.matmul_f32(layers.rms_norm(xr, p["final_ln"],
                                                  cfg.norm_eps), w)
                for p, xr, w in zip(params, x, _heads_mesh(params, mesh,
                                                           fsdp),
                                    strict=True)]
    layers._no_tp(tp_shard)
    h = layers.rms_norm(x, params["final_ln"], cfg.norm_eps)
    return layers.matmul_f32(h, params["lm_head"])


def _chunk_loss(hc: torch.Tensor, lc: torch.Tensor, w: torch.Tensor) -> tuple:
    """(sum of the chunk's nll, its valid count), both f32 scalars."""
    logits = layers.matmul_f32(hc, w)                  # (B, ch, V)
    V = w.shape[1]
    # stability offset only; exact under detach (it cancels in the lse)
    mx = logits.amax(-1).detach()
    lse = torch.log(torch.exp(logits - mx[..., None]).sum(-1)) + mx
    ok = (lc >= 0) & (lc < V)
    true = logits.gather(-1, lc.clamp(0, V - 1).long()[..., None])[..., 0]
    true = torch.where(ok, true, true.new_zeros(()))
    valid = (lc >= 0).to(F32)
    return ((lse - true) * valid).sum(), valid.sum()


def lm_loss(params, cfg, x, labels, tp_shard: bool, seq_chunk: int = 512,
            mesh=None):
    """Mean cross-entropy over the labels >= 0, in chunks of ``seq_chunk``
    positions (label -1 pads the last one), so the full (B, S, V) f32
    logits never exist at once; under a gradient each chunk is checkpointed
    (its logits recomputed in the backward), as the reference remats
    ``chunk_loss``.  The chunk totals are added in chunk order.

    With ``mesh`` (``params``, ``x`` and ``labels`` lists over its
    positions, the parameters in FSDP storage): ``_lm_loss_mesh``, a list
    of the loss on every position."""
    if mesh is not None:
        return _lm_loss_mesh(params, cfg, x, labels, tp_shard, seq_chunk,
                             mesh)
    layers._no_tp(tp_shard)
    B, S, d = x.shape
    h = layers.rms_norm(x, params["final_ln"], cfg.norm_eps)
    w = params["lm_head"]
    ch = min(seq_chunk, S)
    nch = -(-S // ch)
    pad = nch * ch - S
    hp = torch.nn.functional.pad(h, (0, 0, 0, pad))
    lp = torch.nn.functional.pad(labels, (0, pad), value=-1)
    tot = torch.zeros((), dtype=F32, device=x.device)
    cnt = torch.zeros((), dtype=F32, device=x.device)
    grad = torch.is_grad_enabled()
    for c in range(nch):
        args = (hp[:, c * ch:(c + 1) * ch], lp[:, c * ch:(c + 1) * ch], w)
        t, n = checkpoint(_chunk_loss, *args, use_reentrant=False) if grad \
            else _chunk_loss(*args)
        tot, cnt = tot + t, cnt + n
    return tot / cnt.clamp_min(1.0)


def _chunk_loss_mesh(hcs: list, lcs: list, ws: list, bases: list, tp_shard,
                     mesh) -> tuple:
    """One chunk of ``_lm_loss_mesh``: each position's (sum of the chunk's
    nll, its valid count).  Under ``tp_shard`` each position holds the
    logits of its vocab range ``[base, base + V_l)``: the stability offset
    is their max over ``model`` (``pmax``, outside the gradient), the
    sum of the exponentials and the true label's logit (zero outside the
    range) are summed over ``model`` (``tp_psum``)."""
    logits = [layers.matmul_f32(hc, w) for hc, w in zip(hcs, ws, strict=True)]
    mx = [lg.amax(-1).detach() for lg in logits]
    if tp_shard:
        mx = mesh.pmax(mx)
    se = [torch.exp(lg - m[..., None]).sum(-1)
          for lg, m in zip(logits, mx, strict=True)]
    if tp_shard:
        se = mesh.tp_psum(se)
    true = []
    for lg, lc, base in zip(logits, lcs, bases, strict=True):
        V = lg.shape[-1]
        loc = lc - base
        ok = (loc >= 0) & (loc < V)
        t = lg.gather(-1, loc.clamp(0, V - 1).long()[..., None])[..., 0]
        true.append(torch.where(ok, t, t.new_zeros(())))
    if tp_shard:
        true = mesh.tp_psum(true)
    tots, cnts = [], []
    for s_, m, t, lc in zip(se, mx, true, lcs, strict=True):
        lse = torch.log(s_) + m
        valid = (lc >= 0).to(F32)
        tots.append(((lse - t) * valid).sum())
        cnts.append(valid.sum())
    return tots, cnts


def _lm_loss_mesh(params: list, cfg, x: list, labels: list, tp_shard: bool,
                  seq_chunk: int, mesh) -> list:
    """``lm_loss`` on a mesh (``repro/models/model.py:384-435``): the head
    gathered over ``data``, each position's chunks (``_chunk_loss_mesh``,
    checkpointed under a gradient) added in chunk order, then the totals
    and counts summed over the batch axes (``batch_psum``).  Every
    position's loss is the same scalar; a step differentiates one of
    them."""
    D = mesh.size
    ws = _heads_mesh(params, mesh, True)
    bases = [mesh.axis_index(TP, r) * ws[r].shape[1] if tp_shard else 0
             for r in range(D)]
    S = x[0].shape[1]
    ch = min(seq_chunk, S)
    nch = -(-S // ch)
    pad = nch * ch - S
    hp = [torch.nn.functional.pad(layers.rms_norm(xr, p["final_ln"],
                                                  cfg.norm_eps),
                                  (0, 0, 0, pad))
          for p, xr in zip(params, x, strict=True)]
    lp = [torch.nn.functional.pad(lb, (0, pad), value=-1) for lb in labels]
    tot = [torch.zeros((), dtype=F32, device=xr.device) for xr in x]
    cnt = [torch.zeros((), dtype=F32, device=xr.device) for xr in x]
    grad = torch.is_grad_enabled()
    for c in range(nch):
        sl = slice(c * ch, (c + 1) * ch)
        args = ([h[:, sl] for h in hp], [lb[:, sl] for lb in lp], ws, bases,
                tp_shard, mesh)
        t, n = checkpoint(_chunk_loss_mesh, *args, use_reentrant=False) \
            if grad else _chunk_loss_mesh(*args)
        tot = [a + b for a, b in zip(tot, t, strict=True)]
        cnt = [a + b for a, b in zip(cnt, n, strict=True)]
    if batch_axes_for(mesh):
        tot, cnt = mesh.batch_psum(tot), mesh.batch_psum(cnt)
    return [a / b.clamp_min(1.0) for a, b in zip(tot, cnt, strict=True)]
