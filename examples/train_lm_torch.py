"""End-to-end LM training on the PyTorch port (the counterpart of
``examples/train_lm.py``): yi-9b's family reduced to d_model 512 and 8
layers (``reduce_cfg``: 4 heads of 16, an FFN of 96, a vocabulary of
2,048; 4.1M parameters) trained on the synthetic
token stream, with checkpoints, a restore of the last one, and a check
that the loss fell.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 200         # card
    PYTHONPATH=src python examples/train_lm_torch.py --steps 20 --device cpu
"""
from __future__ import annotations

import argparse
import tempfile

import torch

from repro_torch.launch.train import train
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.optimizer import leaves


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as ckpt:
        res = train(args.arch, steps=args.steps, batch=4, seq=256, lr=3e-4,
                    reduced=True, d_model=512, n_layers=8, ckpt_dir=ckpt,
                    ckpt_every=max(args.steps // 2, 1), device=args.device)
        assert res.losses[-1] < res.losses[0], "loss did not improve"
        ck = Checkpointer(ckpt)
        last = ck.latest_step()
        back = ck.restore(last, {"params": res.params, "opt": res.opt},
                          device=args.device)
        for a, b in zip(leaves(res.params), leaves(back["params"]),
                        strict=True):
            assert torch.equal(a, b), "restored parameters differ"
        print(f"checkpoint of step {last} restored bit for bit; loss "
              f"{res.losses[0]:.4f} -> {res.losses[-1]:.4f}")


if __name__ == "__main__":
    main()
