"""Quickstart: build a model from the assigned-architecture registry, train a
few steps on the synthetic pipeline, then serve a couple of requests THROUGH
the AVEC front door — an in-process destination executor behind
``avec.connect``, exactly the same call path a remote TCP destination uses.
The trainer and the destination compute on ``--device`` (the card unless
the caller asks for the CPU).

Run:  python -m repro_torch.examples.quickstart [--arch granite-3-2b] [--device cpu]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch import avec
from repro_torch.configs import get_arch, list_archs, reduced
from repro_torch.core import DestinationExecutor
from repro_torch.core.library import make_model_library
from repro_torch.data.pipeline import make_pipeline
from repro_torch.optim.optimizer import OptimizerConfig
from repro_torch.train.trainer import Trainer
from repro_torch.utils import to_numpy_tree


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b", choices=list_archs())
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default="cuda",
                    help="where the trainer and the destination compute (default: the card)")
    args = ap.parse_args(argv)
    run(args.arch, steps=args.steps, device=args.device)


def run(arch: str = "granite-3-2b", *, steps: int = 30, device="cuda", echo=print) -> dict:
    """The demo on ``reduced(get_arch(arch))`` -> what it prints, as a dict."""
    # reduced() preserves the family (GQA/MoE/SSD/hybrid/...) at CPU scale
    cfg = reduced(get_arch(arch))
    res: dict = {"arch": arch, "family": cfg.family,
                 "full_params": get_arch(arch).param_count()}
    echo(f"arch={arch} family={cfg.family} "
         f"(full config: {res['full_params'] / 1e9:.1f}B params)")

    data = make_pipeline(cfg.vocab_size, seq_len=32, global_batch=8, seed=0)
    ocfg = OptimizerConfig(name=cfg.optimizer, lr=3e-3, warmup_steps=5,
                           total_steps=steps, schedule="wsd")
    trainer = Trainer(cfg, ocfg, data, device=device)
    report = trainer.run(steps)
    res.update(losses=report.losses, train_wall_s=report.wall_s)
    echo(f"train: loss {report.losses[0]:.3f} -> {report.losses[-1]:.3f} "
         f"in {report.wall_s:.1f}s")

    if cfg.family in ("encdec",):
        echo("serving demo targets decoder LMs; done.")
        return res
    params = to_numpy_tree(trainer._final["params"])

    # serve through the facade: connect -> session -> call.  Swapping the
    # in-process executor for "tcp://host:port" is the ONLY change needed
    # to serve from a real edge/cloud destination.
    ex = DestinationExecutor({"lm": make_model_library(cfg, max_cache_len=64, device=device)},
                             name="local-dest", device=device)
    res["tokens"] = []
    try:
        with avec.connect([ex]) as client:
            sess = client.session(cfg, params, "lm")
            rng = np.random.default_rng(0)
            for i in range(3):
                prompt = rng.integers(0, cfg.vocab_size, 6)[None].astype(np.int32)
                out = sess.call("prefill", {"tokens": prompt})
                toks = [int(np.argmax(out["logits"][0, -1, :cfg.vocab_size]))]
                for _ in range(7):
                    out = sess.call("decode", {"tokens": np.asarray(
                        [[toks[-1]]], np.int32)})
                    toks.append(int(np.argmax(out["logits"][0, 0,
                                                            :cfg.vocab_size])))
                res["tokens"].append(toks)
                echo(f"serve: req{i} -> {toks}")
            b = sess.profiler.breakdown()
            res.update(breakdown=b, destination=sess.destination)
            echo(f"profiled {b['cycles']} offload cycles via "
                 f"{sess.destination} (GPU {b['gpu_frac'] * 100:.0f}% / "
                 f"comm {b['communication_frac'] * 100:.0f}%)")
    finally:
        ex.shutdown()
    return res


if __name__ == "__main__":
    sys.exit(main())
