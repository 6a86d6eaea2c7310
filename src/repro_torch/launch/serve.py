"""Serving entry point: a batched request loop (prefill + greedy decode) on one
device, with paged-KV bookkeeping and the learned page table (a port of
``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --reduced \\
      --requests 4 --new-tokens 16 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --no-reduced \\
      --requests 4 --prompt-len 2048 --new-tokens 32      # on the card

``--no-reduced`` serves the architecture at its published widths in its
one-card form (``configs.single_card``); ``--reduced`` (the default) cuts
it with ``configs.reduced.reduce_cfg`` to one superblock at
``--d-model`` with a 2,048-token vocabulary, as the reference does.
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from . import bf16_draws
from ..configs import get_arch, single_card
from ..configs.reduced import reduce_cfg
from ..models import model as M
from ..serve import step as serve_step
from ..serve.kvcache import PagedKVCache, learned_page_table


class ServeResult(NamedTuple):
    tokens: np.ndarray        # (requests, new_tokens + 1) int32
    prefill_s: float          # prefill wall time (synchronised)
    decode_s: float           # wall time of the new_tokens decode steps
    decode_tok_s: float       # requests * new_tokens / decode_s
    pages: int                # pages the learned page table indexes


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(arch: str, *, reduced: bool, requests: int, prompt_len: int,
          new_tokens: int, d_model: int = 128, seed: int = 0,
          device=None) -> ServeResult:
    """Prefill ``requests`` random prompts of ``prompt_len`` tokens and
    decode ``new_tokens`` greedy tokens each, on ``device`` (CUDA unless
    ``device="cpu"``).  Inputs come from ``numpy.random.default_rng(seed)``
    in the reference's order: token ids, or for an embedding-input arch
    N(0, 1) embeddings (B, S, d) rounded to bf16 and a fresh (B, 1, d)
    draw a decode step (the greedy ids are returned, not fed back);
    positions ``arange``, broadcast to the three (t, h, w) rows for
    M-RoPE.  Weights are random from a ``torch.Generator`` seeded with
    ``seed``."""
    dev = resolve_device(device)
    cfg = get_arch(arch)
    cfg = reduce_cfg(cfg, d_model=d_model, vocab=2048) if reduced \
        else single_card(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = M.init_params(cfg, gen, dev)
    prefill = serve_step.make_prefill(cfg)
    decode = serve_step.make_decode_step(cfg)

    S_max = prompt_len + new_tokens
    rng = np.random.default_rng(seed)
    B = requests
    if cfg.embed_input:
        prompts = bf16_draws(rng.normal(0, 1, (B, prompt_len, cfg.d_model)),
                              dev)
    else:
        prompts = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (B, prompt_len))).to(
            device=dev, dtype=torch.int32)
    pos = torch.arange(prompt_len, dtype=torch.int32,
                       device=dev)[None].expand(B, prompt_len)
    if cfg.rope == "mrope":
        pos = pos[None].expand(3, B, prompt_len)

    caches = M.init_cache(cfg, B, S_max, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = prefill(params, caches, prompts, pos)
    tok = torch.argmax(logits[:, :cfg.vocab_size], -1).to(torch.int32)
    _sync(dev)
    t_pre = time.perf_counter() - t0

    # paged-KV bookkeeping (control plane) alongside the decode loop
    page = 16
    pkv = PagedKVCache(n_pages=B * (S_max // page + 1), page_size=page,
                       n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                       n_layers=1, device=dev)
    for r in range(B):
        for blk in range(S_max // page + 1):
            pkv.allocate(r, blk)

    out = [tok]
    t0 = time.perf_counter()
    for i in range(new_tokens):
        dpos = torch.full((B, 1), prompt_len + i, dtype=torch.int32,
                          device=dev)
        if cfg.rope == "mrope":
            dpos = dpos[None].expand(3, B, 1)
        if cfg.embed_input:
            tok_in = bf16_draws(rng.normal(0, 1, (B, 1, cfg.d_model)), dev)
        else:
            tok_in = tok[:, None]
        # the filled prefix as a device scalar, as the reference's loop
        # passes it (filled on the card: nothing crosses from the host)
        cache_len = torch.full((), prompt_len + i, dtype=torch.int32,
                               device=dev)
        tok, caches = decode(params, caches, tok_in, dpos, cache_len)
        out.append(tok)
    _sync(dev)
    dt = time.perf_counter() - t0
    lookup, keys, pages = learned_page_table(pkv.table, device=dev)
    q = keys[:: max(len(keys) // 16, 1)].contiguous()
    if not bool((lookup(q) == pages[torch.searchsorted(keys, q)]).all()):
        raise AssertionError("learned page table lookup is not exact")
    rate = B * new_tokens / max(dt, 1e-9)
    print(f"[serve] {cfg.name}: prefill {t_pre:.2f}s, {rate:.1f} tok/s "
          f"decode, learned page table exact over {len(pkv.table)} pages")
    return ServeResult(torch.stack(out, 1).cpu().numpy(), t_pre, dt, rate,
                       len(pkv.table))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    serve(args.arch, reduced=args.reduced, requests=args.requests,
          prompt_len=args.prompt_len, new_tokens=args.new_tokens,
          d_model=args.d_model, seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
