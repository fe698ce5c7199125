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
  input_specs(cfg, shape)                -> batch of meta tensors (dry-run)
  abstract_cache(cfg, batch, max_len)    -> cache tree of meta tensors

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
from repro_torch.models.layers import NEG_INF, unembed
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
    # lse - gold, subtracted before the gold's last axis is dropped: a
    # DTensor gather over a sharded vocab stays masked-partial until reduced
    nll = (lse[..., None] - lg.gather(-1, tgt[..., None]))[..., 0]
    mask = (targets != IGNORE).float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _chunk_logits(hf, W, c0: int, ck: int, tied: bool, vocab: int):
    """fp32 logits of vocab columns [c0, c0+ck), the pad columns at -1e30."""
    if tied:
        lg = hf @ W[c0:c0 + ck].float().T
    else:
        lg = hf @ W[:, c0:c0 + ck].float()
    if c0 + ck > vocab:
        col = torch.arange(c0, c0 + ck, device=lg.device)
        lg = torch.where(col >= vocab, NEG_INF, lg)
    return lg


class _ChunkedXent(torch.autograd.Function):
    """The reference's streaming-logsumexp cross-entropy with a backward
    that recomputes each chunk's logits.  Forward: per chunk of ``ck``
    vocab columns, fp32 logits, the running max ``m`` and sum ``s``, and
    the target's logit ``gold`` from the chunk that holds it.  It saves
    ``h``, the weight, the targets, ``m`` and ``s`` (no (B,S,V) tensor);
    backward forms each chunk's ``softmax - onehot(target)`` from them,
    scaled by the IGNORE mask over the token count, and multiplies it back
    into the gradients of ``h`` and of the weight's chunk."""

    @staticmethod
    def forward(ctx, h, W, targets, tied: bool, vocab: int, ck: int):
        Vp = W.shape[0] if tied else W.shape[1]
        hf = h.float()
        tgt = targets.long().clamp(0, Vp - 1)
        m = hf.new_full(targets.shape, NEG_INF)
        s = hf.new_zeros(targets.shape)
        gold = hf.new_zeros(targets.shape)
        for c0 in range(0, Vp, ck):
            lg = _chunk_logits(hf, W, c0, ck, tied, vocab)
            m_new = torch.maximum(m, lg.amax(dim=-1))
            s = s * torch.exp(m - m_new) + torch.exp(lg - m_new[..., None]).sum(dim=-1)
            in_rng = (tgt >= c0) & (tgt < c0 + ck)
            g = lg.gather(-1, (tgt - c0).clamp(0, ck - 1)[..., None])[..., 0]
            gold = torch.where(in_rng, g, gold)
            m = m_new
        mask = (targets != IGNORE).float()
        nll = m + torch.log(s) - gold
        ctx.save_for_backward(h, W, targets, m, s)
        ctx.shape = (tied, vocab, ck, Vp)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)

    @staticmethod
    def backward(ctx, grad):
        h, W, targets, m, s = ctx.saved_tensors
        tied, vocab, ck, Vp = ctx.shape
        hf = h.float()
        lse = m + torch.log(s)
        mask = (targets != IGNORE).float()
        coef = grad * mask / torch.clamp(torch.sum(mask), min=1.0)        # (B,S)
        tgt = targets.long().clamp(0, Vp - 1)
        dh = torch.zeros_like(hf)
        dW = torch.empty_like(W) if ctx.needs_input_grad[1] else None
        for c0 in range(0, Vp, ck):
            lg = _chunk_logits(hf, W, c0, ck, tied, vocab)
            dlg = torch.exp(lg - lse[..., None]) * coef[..., None]
            # the gold logit's share, from the chunk that holds a real target
            # (a pad column's logit is the constant -1e30)
            gold = (tgt >= c0) & (tgt < c0 + ck) & (tgt < vocab)
            dlg.scatter_add_(-1, (tgt - c0).clamp(0, ck - 1)[..., None],
                             (-coef * gold)[..., None])
            if tied:
                Wc = W[c0:c0 + ck].float()
                dh += dlg @ Wc
                if dW is not None:
                    dW[c0:c0 + ck] = torch.einsum("bsv,bsd->vd", dlg, hf).to(W.dtype)
            else:
                Wc = W[:, c0:c0 + ck].float()
                dh += dlg @ Wc.T
                if dW is not None:
                    dW[:, c0:c0 + ck] = torch.einsum("bsd,bsv->dv", hf, dlg).to(W.dtype)
        dh = dh.to(h.dtype) if ctx.needs_input_grad[0] else None
        return dh, dW, None, None, None, None


def _xent_chunked(cfg, params, h, targets):
    """Streaming-logsumexp cross-entropy over ``cfg.xent_chunk`` vocab
    columns: neither the forward nor the backward holds the (B,S,V)
    logits.  The chunk products are plain ``torch.matmul`` in fp32, as the
    reference computes them outside any kernel; the reference's rule that
    the chunk divide the padded vocab is kept."""
    emb = params["embed"]
    W = emb["tok"] if cfg.tie_embeddings else emb["head"]      # (V,d) or (d,V)
    Vp, ck = cfg.padded_vocab, cfg.xent_chunk
    if Vp % ck != 0:
        raise AssertionError((Vp, ck))
    if cfg.logits_scaling != 1.0:
        raise ValueError("the chunked cross-entropy does not scale the logits")
    return _ChunkedXent.apply(h, W, targets, cfg.tie_embeddings, cfg.vocab_size, ck)


def loss_fn(cfg, params, batch):
    h, aux = forward_hidden(cfg, params, batch)
    if cfg.xent_impl == "chunked":
        xent = _xent_chunked(cfg, params, h, batch["targets"])
    else:
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


# ---------------------------------------------------------------------------
# Dry-run input specs (no storage)
# ---------------------------------------------------------------------------

def input_specs(cfg, shape) -> dict:
    """``meta`` stand-ins for every model input of a shape cell: the
    reference's keys, shapes and dtypes."""
    B, S = shape.global_batch, shape.seq_len
    i32, cdt = torch.int32, getattr(torch, cfg.compute_dtype)

    def meta(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    if shape.kind == "train":
        batch = {"tokens": meta((B, S), i32), "targets": meta((B, S), i32)}
    elif shape.kind == "prefill":
        batch = {"tokens": meta((B, S), i32)}
    else:  # decode: one new token against a seq_len-deep cache
        batch = {"tokens": meta((B, 1), i32), "pos": meta((), i32)}
    if cfg.family == "vlm":
        batch["vision"] = meta((B, cfg.num_vision_tokens, cfg.d_model), cdt)
    if cfg.family == "encdec" and shape.kind != "decode":
        batch["frames"] = meta((B, cfg.num_audio_frames, cfg.d_model), cdt)
    return batch


def abstract_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16):
    return init_cache(cfg, batch, max_len, dtype, device="meta")
