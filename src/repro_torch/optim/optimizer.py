"""Optimizers on plain tensors: AdamW and Adafactor, with warmup-cosine /
WSD (warmup-stable-decay, MiniCPM) / constant schedules and global-norm
gradient clipping.

A copy of ``repro/optim/optimizer.py`` written as tensor functions over the
parameter tree (not ``torch.optim``), so the arithmetic matches the
reference's line by line, in float32.  Where the reference is functional
and donates its buffers to the jitted step, :func:`apply_updates` updates
the parameters and the optimizer state IN PLACE and returns the same
objects: on full-width granite-3-2b a second copy of the AdamW moments
would add 20 GB.  Gradient clipping is applied leaf by leaf inside the
update, with the reference's rounding (the clipped gradient is cast back to
its own dtype first), so no clipped copy of the whole gradient tree exists.
``opt_state_specs`` gives the state's ``ParamSpec`` tree, from which the
dry-run derives its shardings.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.utils import tree_flatten, tree_flatten_up_to, tree_map

F32 = torch.float32


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"            # adamw | adafactor
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: str = "cosine"       # cosine | wsd | const
    warmup_steps: int = 100
    total_steps: int = 10000
    final_lr_frac: float = 0.1
    wsd_stable_frac: float = 0.9   # fraction of post-warmup steps held stable
    # adafactor
    factored_min_dim: int = 32
    clip_threshold: float = 1.0


def _f32(x) -> torch.Tensor:
    """A 0-d float32 tensor on the CPU (a step index or a float)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", F32).reshape(())
    return torch.tensor(x, dtype=F32)


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

def schedule_lr(ocfg: OptimizerConfig, step) -> torch.Tensor:
    """The learning rate at ``step``: a 0-d float32 tensor on the CPU."""
    s = _f32(step)
    w = _f32(max(ocfg.warmup_steps, 1))
    total = _f32(max(ocfg.total_steps, 2))
    warm = torch.clamp(s / w, max=1.0)
    if ocfg.schedule == "const":
        post = 1.0
    elif ocfg.schedule == "cosine":
        t = torch.clamp((s - w) / torch.clamp(total - w, min=1.0), 0.0, 1.0)
        post = ocfg.final_lr_frac + (1 - ocfg.final_lr_frac) * 0.5 * (
            1 + torch.cos(math.pi * t))
    elif ocfg.schedule == "wsd":
        # warmup -> stable plateau -> linear decay to final_lr_frac (MiniCPM)
        decay_start = w + ocfg.wsd_stable_frac * (total - w)
        t = torch.clamp((s - decay_start) / torch.clamp(total - decay_start, min=1.0),
                        0.0, 1.0)
        post = 1.0 - (1.0 - ocfg.final_lr_frac) * t
    else:
        raise ValueError(ocfg.schedule)
    return ocfg.lr * warm * post


# ---------------------------------------------------------------------------
# Common helpers
# ---------------------------------------------------------------------------

def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares in fp32
    (taken per leaf as a squared fp32 vector norm: no fp32 copy of a bf16
    leaf)."""
    leaves = tree_flatten(tree)[0]
    return torch.sqrt(sum(torch.linalg.vector_norm(l, dtype=F32).square() for l in leaves))


def _clip_scale(norm, max_norm: float):
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(tree, max_norm: float):
    """-> (clipped tree, norm); each leaf scaled in fp32 and cast back to
    its dtype."""
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), tree), norm


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _zeros_f32(p):
    return torch.zeros(p.shape, dtype=F32, device=p.device)


def _adamw_init(params):
    return {"m": tree_map(_zeros_f32, params), "v": tree_map(_zeros_f32, params)}


def _adamw_update(ocfg, grads, state, params, step, clip):
    lr = schedule_lr(ocfg, step)
    t = _f32(step) + 1.0
    b1, b2 = ocfg.beta1, ocfg.beta2
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    flat_p, tdef = tree_flatten(params)
    for g, m, v, p in zip(tree_flatten_up_to(tdef, grads), tree_flatten_up_to(tdef, state["m"]),
                          tree_flatten_up_to(tdef, state["v"]), flat_p):
        gf = clip(g).float()
        m.mul_(b1).add_((1 - b1) * gf)                       # b1*m + (1-b1)*g
        v.mul_(b2).add_(torch.square(gf).mul_(1 - b2))       # b2*v + (1-b2)*g^2
        del gf
        delta = (m / bc1).div_((v / bc2).sqrt_().add_(ocfg.eps))   # mhat/(sqrt(vhat)+eps)
        if p.ndim >= 2:  # decoupled weight decay on matrices only
            delta.add_(ocfg.weight_decay * p.float())
        p.copy_(p.float() - delta.mul_(lr))
    return lr


# ---------------------------------------------------------------------------
# Adafactor
# ---------------------------------------------------------------------------

def _factored(p, min_dim: int) -> bool:
    return p.ndim >= 2 and p.shape[-1] >= min_dim and p.shape[-2] >= min_dim


def _adafactor_init(params, ocfg):
    def init(p):
        if _factored(p, ocfg.factored_min_dim):
            return {"vr": torch.zeros(p.shape[:-1], dtype=F32, device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=F32, device=p.device)}
        return {"v": _zeros_f32(p)}
    return {"slots": tree_map(init, params)}


def _adafactor_update(ocfg, grads, state, params, step, clip):
    lr = schedule_lr(ocfg, step)
    t = _f32(step) + 1.0
    decay = 1.0 - t ** -0.8
    flat_p, tdef = tree_flatten(params)
    for g, slot, p in zip(tree_flatten_up_to(tdef, grads),
                          tree_flatten_up_to(tdef, state["slots"]), flat_p):
        gf = clip(g).float()
        g2 = torch.square(gf) + 1e-30
        if "vr" in slot:
            vr = decay * slot["vr"] + (1 - decay) * torch.mean(g2, dim=-1)
            vc = decay * slot["vc"] + (1 - decay) * torch.mean(g2, dim=-2)
            denom = torch.clamp(torch.mean(vr, dim=-1, keepdim=True), min=1e-30)
            precond = (vr / denom)[..., None] * vc[..., None, :]
            update = gf * torch.rsqrt(precond + 1e-30)
            slot["vr"].copy_(vr)
            slot["vc"].copy_(vc)
        else:
            v = decay * slot["v"] + (1 - decay) * g2
            update = gf * torch.rsqrt(v + 1e-30)
            slot["v"].copy_(v)
        # RMS update clipping (Adafactor section B)
        rms = torch.sqrt(torch.mean(torch.square(update)) + 1e-30)
        update = update / torch.clamp(rms / ocfg.clip_threshold, min=1.0)
        if p.ndim >= 2:
            update = update + ocfg.weight_decay * p.float()
        p.copy_(p.float() - lr * update)
    return lr


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def init_opt_state(ocfg: OptimizerConfig, params) -> Any:
    if ocfg.name == "adamw":
        return _adamw_init(params)
    if ocfg.name == "adafactor":
        return _adafactor_init(params, ocfg)
    raise ValueError(ocfg.name)


@torch.no_grad()
def apply_updates(ocfg: OptimizerConfig, grads, opt_state, params, step):
    """Returns (params, opt_state, metrics), the first two updated in place
    (see the module docstring); ``metrics`` holds ``grad_norm`` (on the
    gradients' device) and ``lr`` (CPU), 0-d float32 tensors."""
    gnorm = global_norm(grads)
    if ocfg.grad_clip > 0:
        scale = _clip_scale(gnorm, ocfg.grad_clip)

        def clip(g):
            return (g.float() * scale).to(g.dtype)
    else:
        def clip(g):
            return g
    if ocfg.name == "adamw":
        lr = _adamw_update(ocfg, grads, opt_state, params, step, clip)
    elif ocfg.name == "adafactor":
        lr = _adafactor_update(ocfg, grads, opt_state, params, step, clip)
    else:
        raise ValueError(ocfg.name)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}


def opt_state_specs(ocfg: OptimizerConfig, param_spec_tree):
    """``ParamSpec`` tree of the optimizer state, mirroring
    ``init_opt_state``'s structure, the logical axes carried over: AdamW's
    fp32 ``m`` and ``v``; Adafactor's factored ``vr``/``vc`` where both
    trailing dims reach ``factored_min_dim``, else ``v``."""
    from repro_torch.models.params import ParamSpec, is_spec

    def f32(s: ParamSpec) -> ParamSpec:
        return ParamSpec(tuple(s.shape), tuple(s.axes), "zeros", dtype=F32)

    if ocfg.name == "adamw":
        return {"m": tree_map(f32, param_spec_tree, is_leaf=is_spec),
                "v": tree_map(f32, param_spec_tree, is_leaf=is_spec)}

    def adafactor(s: ParamSpec):
        shape, axes = tuple(s.shape), tuple(s.axes)
        if len(shape) >= 2 and shape[-1] >= ocfg.factored_min_dim \
                and shape[-2] >= ocfg.factored_min_dim:
            return {"vr": ParamSpec(shape[:-1], axes[:-1], "zeros", dtype=F32),
                    "vc": ParamSpec(shape[:-2] + shape[-1:], axes[:-2] + axes[-1:], "zeros",
                                    dtype=F32)}
        return {"v": ParamSpec(shape, axes, "zeros", dtype=F32)}

    return {"slots": tree_map(adafactor, param_spec_tree, is_leaf=is_spec)}
