"""Training loop with checkpoint/restart fault tolerance.

A copy of ``repro/train/trainer.py``.  The trainer owns the train step
(with optional gradient accumulation), the data pipeline
(stateless-resumable: batch i is a function of i), periodic async
checkpoints, and crash-resume: ``run`` with ``resume=True`` picks up from
the latest committed checkpoint including the data cursor, so a killed job
replays nothing and skips nothing.  ``fail_at`` injects a crash for the
fault-tolerance tests.  Like the reference, the trainer does not compress
gradients: that is the collectives' job (``distributed.collectives``).
It runs on the card unless the caller passes ``device="cpu"``."""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.models import model as M
from repro_torch.optim.optimizer import OptimizerConfig, init_opt_state
from repro_torch.train.steps import make_train_step
from repro_torch.utils import resolve_device


class InjectedFailure(RuntimeError):
    pass


@dataclass
class TrainerReport:
    steps: list = field(default_factory=list)
    losses: list = field(default_factory=list)
    resumed_from: Optional[int] = None
    wall_s: float = 0.0

    def loss_curve(self):
        return list(zip(self.steps, self.losses))


class Trainer:
    def __init__(self, cfg, ocfg: OptimizerConfig, data: SyntheticTokens, *,
                 accum: int = 1, ckpt_dir: Optional[str] = None,
                 ckpt_every: int = 0, keep: int = 3, seed: int = 0,
                 device="cuda") -> None:
        self.cfg = cfg
        self.ocfg = ocfg
        self.data = data
        self.accum = accum
        self.ckpt_every = ckpt_every
        self.ckpt = Checkpointer(ckpt_dir, keep=keep) if ckpt_dir else None
        self.seed = seed
        self.device = resolve_device(device)
        self._step_fn = make_train_step(cfg, ocfg, accum)

    # ------------------------------------------------------------------
    def init_state(self):
        params = M.init_params(self.cfg, self.seed, device=self.device)
        opt_state = init_opt_state(self.ocfg, params)
        return {"params": params, "opt": opt_state,
                "step": torch.zeros((), dtype=torch.int32)}

    def _template(self):
        """Shapes and dtypes only (tensors on the ``meta`` device)."""
        params = M.abstract_params(self.cfg)
        return {"params": params, "opt": init_opt_state(self.ocfg, params),
                "step": torch.empty((), dtype=torch.int32, device="meta")}

    # ------------------------------------------------------------------
    def run(self, num_steps: int, *, resume: bool = True,
            fail_at: Optional[int] = None, log_every: int = 10) -> TrainerReport:
        report = TrainerReport()
        t0 = time.perf_counter()
        state = None
        start = 0
        if resume and self.ckpt and self.ckpt.latest_step() is not None:
            state, start = self.ckpt.restore(self._template(), device=self.device)
            report.resumed_from = start
        if state is None:
            state = self.init_state()
        params, opt_state = state["params"], state["opt"]

        for step in range(start, num_steps):
            if fail_at is not None and step == fail_at:
                raise InjectedFailure(f"injected failure at step {step}")
            params, opt_state, metrics = self._step_fn(params, opt_state,
                                                       self.data.batch(step), step)
            loss = float(metrics["loss"])
            if not np.isfinite(loss):
                raise FloatingPointError(f"non-finite loss at step {step}")
            report.steps.append(step)
            report.losses.append(loss)
            next_step = step + 1
            if (self.ckpt and self.ckpt_every
                    and next_step % self.ckpt_every == 0):
                self.ckpt.save(next_step, {"params": params, "opt": opt_state,
                                           "step": torch.tensor(next_step, dtype=torch.int32)})
        if self.ckpt:
            self.ckpt.wait()
        report.wall_s = time.perf_counter() - t0
        self._final = {"params": params, "opt": opt_state}
        return report
