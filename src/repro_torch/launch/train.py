"""Training entry point of the port.

It runs on the card by default (``--device cpu`` for the CPU); reduced
configs unless ``--full``.  Fault tolerance: ``--ckpt-dir`` + ``--ckpt-every``
give crash-resume, in the JAX package's checkpoint format.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
      --steps 100 [--full] [--accum 4] [--ckpt-dir DIR] [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_arch, list_archs, reduced
from repro_torch.data.pipeline import make_pipeline
from repro_torch.optim.optimizer import OptimizerConfig
from repro_torch.train.trainer import Trainer


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b", choices=list_archs())
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--schedule", default="wsd", choices=["wsd", "cosine", "const"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--full", action="store_true",
                    help="use the full (unreduced) config")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = get_arch(args.arch)
    if not args.full:
        cfg = reduced(cfg)
    data = make_pipeline(cfg.vocab_size, args.seq_len, args.batch, seed=0)
    ocfg = OptimizerConfig(name=cfg.optimizer, lr=args.lr,
                           warmup_steps=max(args.steps // 20, 1),
                           total_steps=args.steps, schedule=args.schedule)
    trainer = Trainer(cfg, ocfg, data, accum=args.accum,
                      ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                      device=args.device)
    rep = trainer.run(args.steps, resume=True)
    if rep.resumed_from:
        print(f"resumed from step {rep.resumed_from}")
    print(f"{args.arch}: loss {rep.losses[0]:.4f} -> {rep.losses[-1]:.4f} "
          f"over {len(rep.losses)} steps ({rep.wall_s:.1f}s)")


if __name__ == "__main__":
    main()
