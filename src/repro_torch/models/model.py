"""Unified model API: family dispatch (dense / moe / ssm / hybrid / vlm
through the decoder stack, encdec through ``models.encdec``).

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

Batch dicts: {"tokens": (B,S) int, "targets": (B,S) int} plus family
extras -- vlm: "vision" (B,Tv,d); encdec: "frames" (B,F,d); decode batches:
{"tokens": (B,1), "pos": () or (B,) int} (+ the frozen "vision" context for
vlm, which the reference requires and the cached cross-attention does not
read).
"""
from __future__ import annotations

import torch

from repro_torch.models import encdec as ed
from repro_torch.models import params as pm
from repro_torch.models import transformer as tf
from repro_torch.models.layers import unembed
from repro_torch.utils import resolve_device

IGNORE = -1  # target id excluded from the loss


def param_specs(cfg):
    if cfg.family == "encdec":
        return ed.encdec_specs(cfg)
    return tf.lm_specs(cfg)


def init_params(cfg, seed: int = 0, device="cuda"):
    return pm.init_params(param_specs(cfg), seed, getattr(torch, cfg.param_dtype),
                          resolve_device(device))


def abstract_params(cfg):
    return pm.abstract_params(param_specs(cfg), getattr(torch, cfg.param_dtype))


def _context(cfg, batch):
    if cfg.family == "vlm":
        return batch["vision"]
    return None


def forward_hidden(cfg, params, batch):
    """-> (h (B,S,d), aux loss fp32: the MoE layers' load-balancing term)."""
    if cfg.family == "encdec":
        enc = ed.encode(cfg, params, batch["frames"])
        h = ed.dec_hidden(cfg, params, batch["tokens"], enc)
        return h, torch.zeros((), dtype=torch.float32, device=h.device)
    return tf.lm_hidden(cfg, params, batch["tokens"], context=_context(cfg, batch))


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
    if cfg.family == "encdec":
        enc = ed.encode(cfg, params, batch["frames"])
        h, cache = ed.dec_prefill(cfg, params, batch["tokens"], enc, cache_len, cache_dtype)
    else:
        h, cache = tf.lm_prefill(cfg, params, batch["tokens"], cache_len,
                                 context=_context(cfg, batch), cache_dtype=cache_dtype)
    return logits_from_hidden(cfg, params, h[:, -1:]), cache


def decode_step(cfg, params, cache, batch):
    """batch: {"tokens": (B,1), "pos": () or (B,)} (+ "vision" for vlm).
    Returns (logits (B,1,V), cache), the cache updated in place."""
    if cfg.family == "encdec":
        h, cache = ed.dec_step(cfg, params, cache, batch["tokens"], batch["pos"])
    else:
        h, cache = tf.lm_decode_step(cfg, params, cache, batch["tokens"], batch["pos"],
                                     context=_context(cfg, batch))
    return logits_from_hidden(cfg, params, h), cache


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device="cuda"):
    if cfg.family == "encdec":
        return ed.encdec_init_cache(cfg, batch, max_len, dtype, resolve_device(device))
    return tf.lm_init_cache(cfg, batch, max_len, dtype, resolve_device(device))
