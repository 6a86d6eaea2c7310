"""The decoder of the LM path on one device (a port of
``repro.models.model`` for attention layers with a dense or MoE FFN).

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
Caches are updated in place and returned.  ``lm_loss`` is the chunked
cross-entropy the train step differentiates.  The mamba / mLSTM / sLSTM
kinds, M-RoPE, ``embed_input`` archs and tensor-parallel layouts raise
``not_ported`` (ROADMAP queue 1 item 14).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import not_ported, resolve_device
from . import layers

F32 = torch.float32
BF16 = torch.bfloat16


# ---------------------------------------------------------------------------
# parameter factory
# ---------------------------------------------------------------------------
class Leaf(NamedTuple):
    shape: tuple
    fan_in: int          # init scale (0 -> zeros, -1 -> ones)


def _supported(cfg) -> None:
    if cfg.tp_shard:
        raise not_ported("tensor-parallel layouts (cfg.tp_shard=True; serve "
                         "configs.single_card(cfg) on one card)", "14")
    if cfg.embed_input:
        raise not_ported("embedding-input archs (embed_input)", "14")
    if cfg.rope == "mrope":
        raise not_ported("M-RoPE archs", "14")
    for kind in set(cfg.pattern):
        if kind != "attn":
            raise not_ported(f"{kind!r} blocks", "14")


def _block_leaves(cfg, kind: str, pos: int) -> dict:
    d, dh = cfg.d_model, cfg.head_dim
    H, KV = cfg.n_heads_padded, cfg.n_kv_padded
    out: dict[str, Any] = {"core": layers.AttnParams(
        ln=Leaf((d,), -1),
        wq=Leaf((d, H * dh), d),
        wk=Leaf((d, KV * dh), d),
        wv=Leaf((d, KV * dh), d),
        wo=Leaf((H * dh, d), H * dh),
        bq=Leaf((H * dh,), 0) if cfg.qkv_bias else None,
        bk=Leaf((KV * dh,), 0) if cfg.qkv_bias else None,
        bv=Leaf((KV * dh,), 0) if cfg.qkv_bias else None,
        qn=Leaf((dh,), -1) if cfg.qk_norm else None,
        kn=Leaf((dh,), -1) if cfg.qk_norm else None,
    )}
    if cfg.d_ff <= 0:
        out["ffn"] = None
    elif cfg.moe_at(pos):
        mc = cfg.moe
        fe, E = mc.d_expert, cfg.n_experts_padded
        sh = mc.n_shared * mc.d_expert
        out["ffn"] = layers.MoEParams(
            ln=Leaf((d,), -1),
            router=Leaf((d, mc.n_experts), d),
            w_gate=Leaf((E, d, fe), d),
            w_up=Leaf((E, d, fe), d),
            w_down=Leaf((E, fe, d), fe),
            sh_gate=Leaf((d, sh), d) if mc.n_shared else None,
            sh_up=Leaf((d, sh), d) if mc.n_shared else None,
            sh_down=Leaf((sh, d), sh) if mc.n_shared else None,
        )
    else:
        out["ffn"] = layers.MLPParams(
            ln=Leaf((d,), -1),
            w_gate=Leaf((d, cfg.d_ff), d),
            w_up=Leaf((d, cfg.d_ff), d),
            w_down=Leaf((cfg.d_ff, d), cfg.d_ff),
        )
    return out


def build_tree(cfg) -> dict:
    """Leaf-description tree (superblock leaves before stacking)."""
    _supported(cfg)
    d = cfg.d_model
    return {
        "embed": Leaf((cfg.vocab_padded, d), d),
        "sb": {f"pos{i}": _block_leaves(cfg, cfg.pattern[i], i)
               for i in range(cfg.sb)},
        "final_ln": Leaf((d,), -1),
        "lm_head": Leaf((d, cfg.vocab_padded), d),
    }


def tree_map(fn, tree):
    """``fn`` over the leaves of a tree of dicts and NamedTuples (``None``
    entries stay ``None``)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields") \
            and not isinstance(tree, Leaf):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    return fn(tree)


def init_params(cfg, generator: torch.Generator, device=None) -> dict:
    """Random bf16 weights on ``device`` (CUDA unless ``device="cpu"``):
    each leaf N(0, 1) / sqrt(fan_in) drawn in f32 from ``generator`` and
    rounded to bf16; zeros for biases, ones for norm scales.  Stacked
    leaves are drawn one superblock at a time (bounded f32 scratch)."""
    dev = resolve_device(device)
    tree = build_tree(cfg)

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
def init_cache(cfg, batch: int, max_seq: int, *, device=None) -> dict:
    """KV caches stacked over superblocks: ``pos{i}`` -> ``k``/``v`` of
    (n_sb, batch, max_seq, n_kv_heads, head_dim) bf16 zeros."""
    _supported(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_sb, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {f"pos{i}": {"k": torch.zeros(shape, dtype=BF16, device=dev),
                        "v": torch.zeros(shape, dtype=BF16, device=dev)}
            for i in range(cfg.sb)}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def embed_tokens(params, cfg, tokens: torch.Tensor, tp_shard: bool
                 ) -> torch.Tensor:
    """Embedding rows of ``tokens``; an id outside the table gives a zero
    row, as the reference's masked take does."""
    layers._no_tp(tp_shard)
    w = params["embed"]
    V = w.shape[0]
    ok = (tokens >= 0) & (tokens < V)
    x = w[tokens.clamp(0, V - 1).long()]
    return torch.where(ok[..., None], x, torch.zeros((), dtype=w.dtype,
                                                     device=w.device))


def _run_block(cfg, pos_idx: int, kind: str, blk_params, x, *, pos, cache,
               tp_shard):
    if kind != "attn":
        raise not_ported(f"{kind!r} blocks", "14")
    ffn = blk_params.get("ffn")
    if cfg.parallel_block and isinstance(ffn, layers.MLPParams):
        # Cohere-style parallel block: attention and FFN read the same input
        o, new_cache = layers.attention_block(
            blk_params["core"], x, cfg, pos=pos, cache=cache,
            tp_shard=tp_shard, reduce=False)
        m = layers.mlp_block(ffn, x, cfg, tp_shard=tp_shard, reduce=False)
        return x + (o + m).to(x.dtype), new_cache
    o, new_cache = layers.attention_block(blk_params["core"], x, cfg, pos=pos,
                                          cache=cache, tp_shard=tp_shard)
    x = x + o
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


def forward(params, cfg, inputs: torch.Tensor, *, pos, caches=None,
            mode: str = "train", remat: bool = True, cache_len=None,
            seq_sharded: bool = False):
    """inputs: token ids (B, S).  pos: (B, S) positions (decode takes them
    from ``cache_len``, an int; default ``pos[0, 0]``).  Returns (hidden
    (B, S, d), caches) -- the caches written in place, or None without
    caches.  ``mode="train"`` with ``remat`` (and autograd recording)
    checkpoints each superblock (``torch.utils.checkpoint``, non-reentrant):
    its activations are recomputed in the backward, K8 launched again."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"forward(mode={mode!r}): train, prefill or decode")
    if seq_sharded:
        raise not_ported("sequence-sharded KV caches", "14")
    _supported(cfg)
    x = embed_tokens(params, cfg, inputs, cfg.tp_shard)
    if mode == "decode":
        if cache_len is None:
            cache_len = int(pos.reshape(-1)[0])
        cache_len = int(cache_len)
        pos = torch.full(inputs.shape[:2], cache_len, dtype=torch.int32,
                         device=x.device)
    elif caches is not None:           # prefill into fresh caches
        cache_len = 0

    def superblock(x, p_sb, layer):
        for i in range(cfg.sb):
            c = None
            if caches is not None:
                kv = caches[f"pos{i}"]
                c = {"k": kv["k"][layer], "v": kv["v"][layer],
                     "length": cache_len}
            x, _ = _run_block(cfg, i, cfg.pattern[i], p_sb[f"pos{i}"], x,
                              pos=pos, cache=c, tp_shard=cfg.tp_shard)
        return x

    ckpt = mode == "train" and remat and caches is None \
        and torch.is_grad_enabled()
    for layer, p_sb in enumerate(unstack(params["sb"], cfg.n_sb)):
        if ckpt:
            x = checkpoint(superblock, x, p_sb, layer, use_reentrant=False)
        else:
            x = superblock(x, p_sb, layer)
    return x, caches


def lm_logits(params, cfg, x: torch.Tensor, tp_shard: bool) -> torch.Tensor:
    """(B, S, V_padded) f32 logits."""
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


def lm_loss(params, cfg, x: torch.Tensor, labels: torch.Tensor,
            tp_shard: bool, seq_chunk: int = 512) -> torch.Tensor:
    """Mean cross-entropy over the labels >= 0, in chunks of ``seq_chunk``
    positions (label -1 pads the last one), so the full (B, S, V) f32
    logits never exist at once; under a gradient each chunk is checkpointed
    (its logits recomputed in the backward), as the reference remats
    ``chunk_loss``.  The chunk totals are added in chunk order."""
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
