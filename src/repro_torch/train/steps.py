"""Train and eval steps: loss and gradients through autograd,
microbatch accumulation, and the optimizer update.

A copy of ``repro/train/steps.py``.  The reference's ``lax.scan`` over
microbatches is a loop that sums the fp32 gradients; its buffer donation is
the in-place update of ``optim.apply_updates``: the returned params and
optimizer state are the objects passed in, updated."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed.dtensor import is_dtensor, like_params
from repro_torch.models import model as M
from repro_torch.optim.optimizer import OptimizerConfig, apply_updates
from repro_torch.utils import tree_flatten, tree_leaves, tree_map, tree_unflatten

#: profiler range around the optimizer update of a train step
#: (``chip_smoke.py --profile`` reads its device time)
UPDATE_SPAN = "apply_updates"


def _on(batch: dict, device) -> dict:
    """A batch of numpy arrays or tensors -> tensors on ``device``."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray)
                else torch.as_tensor(v)).to(device) for k, v in batch.items()}


def loss_and_grads(cfg, params, batch):
    """-> (loss, metrics, grads): ``M.loss_fn`` and its gradient with
    respect to every parameter leaf (zeros for a leaf the loss does not
    reach, as ``jax.grad`` gives), each in its parameter's dtype."""
    leaves, treedef = tree_flatten(params)
    with torch.enable_grad():
        live = [p.detach().requires_grad_() for p in leaves]
        loss, metrics = M.loss_fn(cfg, tree_unflatten(treedef, live), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(treedef, grads))


def make_train_step(cfg, ocfg: OptimizerConfig, accum: int = 1):
    """Returns step(params, opt_state, batch, step_idx) ->
    (params, opt_state, metrics).  ``accum`` > 1 splits the global batch into
    microbatches and averages their fp32 gradients (gradient accumulation).
    ``metrics``: loss, xent, aux, grad_norm, lr (0-d tensors)."""

    def step(params, opt_state, batch, step_idx):
        device = tree_leaves(params)[0].device
        batch = _on(batch, device)
        if accum <= 1:
            loss, metrics, grads = loss_and_grads(cfg, params, batch)
        else:
            mbs = {k: v.reshape((accum, v.shape[0] // accum) + tuple(v.shape[1:]))
                   for k, v in batch.items()}
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params)
            lsum = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(accum):
                loss_i, _, g = loss_and_grads(cfg, params, {k: v[i] for k, v in mbs.items()})
                for a, x in zip(tree_leaves(gsum), tree_leaves(g)):
                    a.add_(x)                      # gsum + x.astype(float32)
                lsum = lsum + loss_i
                del g
            grads = tree_map(lambda g: g / accum, gsum)
            loss = lsum / accum
            metrics = {"loss": loss, "xent": loss,
                       "aux": torch.zeros((), dtype=torch.float32, device=device)}
        if is_dtensor(tree_leaves(params)[0]):
            grads = like_params(grads, params)
        with torch.profiler.record_function(UPDATE_SPAN):
            params, opt_state, om = apply_updates(ocfg, grads, opt_state, params, step_idx)
        return params, opt_state, {**metrics, **om}

    return step


def make_eval_step(cfg):
    def eval_step(params, batch):
        device = tree_leaves(params)[0].device
        with torch.no_grad():
            _, metrics = M.loss_fn(cfg, params, _on(batch, device))
        return metrics
    return eval_step
