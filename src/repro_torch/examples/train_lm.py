"""Train a small LM for a few hundred steps with checkpoint/restart.

AVEC is an inference-offload paper, so the main end-to-end example is
``offload_serving``; this example exercises the training substrate
(optimizer + WSD schedule + async checkpointing + crash resume) at a small
size (~10M params).  Scale ``--dim/--layers`` up on real hardware.  The
checkpoints go to a directory under the system's temporary directory
unless ``--ckpt-dir`` names one; the trainer computes on ``--device`` (the
card unless the caller asks for the CPU).

Run:  python -m repro_torch.examples.train_lm [--steps 200] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import get_arch
from repro_torch.data.pipeline import make_pipeline
from repro_torch.optim.optimizer import OptimizerConfig
from repro_torch.train.trainer import Trainer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the trainer computes (default: the card)")
    args = ap.parse_args(argv)
    run(steps=args.steps, dim=args.dim, layers=args.layers, vocab=args.vocab,
        ckpt_dir=args.ckpt_dir, device=args.device)


def run(*, steps: int = 200, dim: int = 128, layers: int = 4, vocab: int = 4096,
        ckpt_dir: str | None = None, device="cuda", seq_len: int = 64,
        global_batch: int = 16, ckpt_every: int = 50, echo=print) -> dict:
    """The demo -> what it prints, as a dict."""
    cfg = dataclasses.replace(
        get_arch("granite-3-2b"),
        num_layers=layers, d_model=dim, num_heads=4, num_kv_heads=2,
        head_dim=dim // 4, d_ff=dim * 4, vocab_size=vocab,
        remat=False, param_dtype="float32", compute_dtype="float32")
    n = cfg.param_count()
    echo(f"model: {layers}L d={dim} vocab={vocab} "
         f"({n / 1e6:.1f}M params)")

    ckpt_dir = ckpt_dir or os.path.join(tempfile.gettempdir(),
                                        "repro_torch_train_lm")
    data = make_pipeline(cfg.vocab_size, seq_len=seq_len, global_batch=global_batch, seed=0)
    ocfg = OptimizerConfig(lr=3e-3, warmup_steps=20, total_steps=steps,
                           schedule="wsd")
    trainer = Trainer(cfg, ocfg, data, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                      device=device)
    report = trainer.run(steps, resume=True)
    if report.resumed_from:
        echo(f"resumed from checkpoint step {report.resumed_from}")
    k = max(len(report.losses) // 10, 1)
    for i in range(0, len(report.losses), k):
        echo(f"  step {report.steps[i]:4d}  loss {report.losses[i]:.4f}")
    echo(f"final loss {report.losses[-1]:.4f}  ({report.wall_s:.1f}s, "
         f"checkpoints in {ckpt_dir})")
    return {"params": n, "resumed_from": report.resumed_from, "steps": report.steps,
            "losses": report.losses, "wall_s": report.wall_s, "ckpt_dir": ckpt_dir,
            "final_params": trainer._final["params"]}


if __name__ == "__main__":
    main()
