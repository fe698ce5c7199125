"""Unified model API for the dense decoder and pure-SSM (mamba2) families.

Functions (cfg is static; tensors live on the params' device):
  param_specs(cfg)                       -> ParamSpec tree
  init_params(cfg, seed, device)         -> concrete params
  abstract_params(cfg)                   -> shapes/dtypes (meta tensors)
  forward_hidden(cfg, params, batch)     -> (h, aux)
  logits_from_hidden(cfg, params, h)     -> (B,S,V) fp32
  loss_fn(cfg, params, batch)            -> (loss, metrics)
  prefill(cfg, params, batch, cache_len) -> (last_logits, cache)
  decode_step(cfg, params, cache, batch) -> (logits, cache)
  init_cache(cfg, batch, max_len)        -> cache tree

Batch dicts: {"tokens": (B,S) int, "targets": (B,S) int}; decode batches:
{"tokens": (B,1), "pos": () or (B,) int}.
"""
from __future__ import annotations

import torch

from repro_torch.models import params as pm
from repro_torch.models import transformer as tf
from repro_torch.models.layers import unembed
from repro_torch.utils import resolve_device

IGNORE = -1  # target id excluded from the loss


def param_specs(cfg):
    return tf.lm_specs(cfg)


def init_params(cfg, seed: int = 0, device="cuda"):
    return pm.init_params(param_specs(cfg), seed, getattr(torch, cfg.param_dtype),
                          resolve_device(device))


def abstract_params(cfg):
    return pm.abstract_params(param_specs(cfg), getattr(torch, cfg.param_dtype))


def forward_hidden(cfg, params, batch):
    h = tf.lm_hidden(cfg, params, batch["tokens"])
    return h, torch.zeros((), dtype=torch.float32, device=h.device)


def logits_from_hidden(cfg, params, h):
    return unembed(cfg, params["embed"], h)


def _xent_full(cfg, params, h, targets):
    lg = logits_from_hidden(cfg, params, h)              # (B,S,Vp) fp32
    lse = torch.logsumexp(lg, dim=-1)
    tgt = targets.long().clamp(0, cfg.padded_vocab - 1)
    gold = lg.gather(-1, tgt[..., None])[..., 0]
    mask = (targets != IGNORE).float()
    return torch.sum((lse - gold) * mask) / torch.clamp(torch.sum(mask), min=1.0)


def loss_fn(cfg, params, batch):
    if cfg.xent_impl != "full":
        raise NotImplementedError(f"xent_impl={cfg.xent_impl!r} is not ported yet")
    h, aux = forward_hidden(cfg, params, batch)
    xent = _xent_full(cfg, params, h, batch["targets"])
    loss = xent + aux
    return loss, {"loss": loss, "xent": xent, "aux": aux}


def prefill(cfg, params, batch, cache_len: int, cache_dtype=torch.bfloat16):
    """Returns (last-token logits (B,1,V), cache)."""
    h, cache = tf.lm_prefill(cfg, params, batch["tokens"], cache_len,
                             cache_dtype=cache_dtype)
    return logits_from_hidden(cfg, params, h[:, -1:]), cache


def decode_step(cfg, params, cache, batch):
    """batch: {"tokens": (B,1), "pos": () or (B,)}.  Returns (logits (B,1,V),
    cache), the cache updated in place."""
    h, cache = tf.lm_decode_step(cfg, params, cache, batch["tokens"], batch["pos"])
    return logits_from_hidden(cfg, params, h), cache


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device="cuda"):
    return tf.lm_init_cache(cfg, batch, max_len, dtype, resolve_device(device))
