"""Training entry point (a port of ``repro.launch.train`` on one device):
config -> synthetic token stream -> train step -> checkpoints -> elastic
controller heartbeat.

  PYTHONPATH=src python -m repro_torch.launch.train --arch \\
      granite-moe-1b-a400m --reduced --steps 50 --batch 8 --seq 128 \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch \\
      granite-moe-1b-a400m --steps 8 --batch 8 --seq 2048     # on the card

Without ``--reduced`` the architecture trains at its published widths in
its one-card form (``configs.single_card``); ``--n-layers`` then cuts its
depth (the reference reads it only with ``--reduced``).  Weights are
random from a ``torch.Generator`` seeded with ``--seed`` (the reference
draws from ``jax.random``, so the two packages' weights differ).  Inputs
are the reference's: token ids and labels from
``synthetic_token_stream``; for an embedding-input arch (musicgen-large)
step i's inputs are ``numpy.random.default_rng(i).normal(0, 1, (B, S,
d))`` rounded to bf16, its labels still the stream's; M-RoPE archs
(qwen2-vl-72b) take the positions broadcast to (3, B, S).

The loss and the gradient norm stay on the device until a logging step
(every ``log_every`` steps and the last): reading them syncs, so step
seconds are each logging interval's wall time over its steps, and tokens
a second follow from them.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from . import bf16_draws
from ..configs import get_arch, single_card
from ..configs.reduced import reduce_cfg
from ..data.indexed_dataset import synthetic_token_stream
from ..models import model as M
from ..train import optimizer
from ..train.checkpoint import Checkpointer
from ..train.elastic import ElasticController
from ..train.step import make_train_step


class TrainResult(NamedTuple):
    losses: list              # a float a step
    grad_norms: list          # a float a step
    step_s: list              # seconds a step (its logging interval's mean)
    tokens_per_s: float       # batch * seq / the median step seconds
    params: dict              # the trained parameters (on the device)
    opt: optimizer.AdamWState


def train_config(arch: str, *, reduced: bool, d_model: int = 128,
                 n_layers: int | None = None):
    """The config ``train`` builds: reduced as the reference reduces it, or
    the one-card form, cut to ``n_layers`` when given."""
    cfg = get_arch(arch)
    if reduced:
        return reduce_cfg(cfg, d_model=d_model, n_layers=n_layers,
                          vocab=2048)
    cfg = single_card(cfg)
    if n_layers is not None and n_layers != cfg.n_layers:
        nl = max(n_layers // cfg.sb, 1) * cfg.sb
        cfg = dataclasses.replace(cfg, n_layers=nl, pattern=cfg.pattern[:nl])
    return cfg


def step_inputs(cfg, toks: np.ndarray, step: int, dev) -> torch.Tensor:
    """Step ``step``'s inputs on ``dev``: the stream's token ids, or for an
    embedding-input arch the reference's N(0, 1) draw (B, S, d) from
    ``default_rng(step)``, rounded to bf16 through f32."""
    if not cfg.embed_input:
        return torch.from_numpy(toks).to(dev)
    return bf16_draws(np.random.default_rng(step).normal(
        0, 1, toks.shape + (cfg.d_model,)), dev)


def train(arch: str, *, steps: int, batch: int, seq: int, lr: float,
          reduced: bool, ckpt_dir: str | None, ckpt_every: int = 50,
          d_model: int = 128, n_layers: int | None = None,
          log_every: int = 10, seed: int = 0, device=None,
          on_step=None) -> TrainResult:
    """Train ``steps`` steps of ``batch`` x ``seq`` tokens on ``device``
    (CUDA unless ``device="cpu"``).  ``on_step(step, params, opt,
    metrics)``, where given, is called after every step (metrics on the
    device)."""
    dev = resolve_device(device)
    cfg = train_config(arch, reduced=reduced, d_model=d_model,
                       n_layers=n_layers)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = M.init_params(cfg, gen, dev)
    opt = optimizer.init(params)
    step_fn = make_train_step(cfg, lr=lr)
    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    elastic = ElasticController(n_hosts=1)
    stream = synthetic_token_stream(seed, cfg.vocab_size, batch, seq)
    pos = torch.arange(seq, dtype=torch.int32, device=dev)[None] \
        .expand(batch, seq)
    if cfg.rope == "mrope":
        pos = pos[None].expand(3, batch, seq)

    print(f"[train] {cfg.name}: {cfg.param_count() / 1e6:.1f}M params "
          f"({cfg.param_count(active_only=True) / 1e6:.1f}M active), "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, batch={batch} "
          f"seq={seq} on {dev}")
    loss_t, gnorm_t, step_s = [], [], []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_log, logged = time.perf_counter(), 0
    for step in range(steps):
        toks, labels = next(stream)
        inputs = step_inputs(cfg, toks, step, dev)
        labels = torch.from_numpy(labels).to(dev)
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, inputs, labels, pos)
        elastic.heartbeat(0, time.perf_counter() - t0)
        loss_t.append(metrics["loss"])
        gnorm_t.append(metrics["grad_norm"])
        if on_step is not None:
            on_step(step, params, opt, metrics)
        if step % log_every == 0 or step == steps - 1:
            # sync: ok(the loss and gradient norm of a logging step)
            loss, gnorm = torch.stack([loss_t[-1], gnorm_t[-1]]).tolist()
            now = time.perf_counter()
            dt = (now - t_log) / (step + 1 - logged)
            step_s += [dt] * (step + 1 - logged)
            t_log, logged = now, step + 1
            print(f"step {step:4d} loss={loss:.4f} gnorm={gnorm:.3f} "
                  f"{dt:.3f} s/step {batch * seq / dt:.0f} tok/s")
        if ckpt and step and step % ckpt_every == 0:
            ckpt.save(step, {"params": params, "opt": opt})
    if ckpt:
        ckpt.save(steps, {"params": params, "opt": opt}, blocking=True)
        ckpt.wait()
    # sync: ok(every step's loss and norm, read once at the end)
    losses = torch.stack(loss_t).tolist() if loss_t else []
    norms = torch.stack(gnorm_t).tolist() if gnorm_t else []
    med = sorted(step_s)[len(step_s) // 2] if step_s else float("nan")
    if losses:
        print(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return TrainResult(losses, norms, step_s, batch * seq / med, params, opt)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="granite-moe-1b-a400m")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    return train(args.arch, steps=args.steps, batch=args.batch,
                 seq=args.seq, lr=args.lr, reduced=args.reduced,
                 ckpt_dir=args.ckpt_dir, d_model=args.d_model,
                 n_layers=args.n_layers, device=args.device)


if __name__ == "__main__":
    main()
