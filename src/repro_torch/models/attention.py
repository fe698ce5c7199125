"""GQA attention: train / prefill / decode paths, and cross-attention.

Layouts follow the JAX package: projections ``wq (d,H,hd)``, ``wk``/``wv
(d,K,hd)``, ``wo (H,hd,d)``; activations ``(B,S,H,hd)``; KV caches
``{"k": (B,S_max,K,hd), "v": (B,S_max,K,hd)}``, cross-attention caches
``{"cross_k": (B,Tc,K,hd), "cross_v": (B,Tc,K,hd)}``.  Prefill and train go
through ``ops.flash_attention`` (causal, or bidirectional for an encoder);
cross-attention over a context of Tc rows goes through it non-causal with
Sq != Sk.  Decode goes through ``ops.decode_attention``: self-attention
with ``kv_len = pos + 1``, cross-attention with ``kv_len = Tc`` for every
row.  What a decode step's self-attention layers read of its position (the
cache row written, ``kv_len``, RoPE's tables) is computed once a step
(:func:`decode_index`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.distributed.dtensor import index_copy_
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, rope_tables
from repro_torch.models.params import ParamSpec


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def attn_specs(cfg) -> dict:
    d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    specs = {
        "wq": ParamSpec((d, H, hd), ("embed", "heads", "head_dim"), "normal", d ** -0.5),
        "wk": ParamSpec((d, K, hd), ("embed", "kv_heads", "head_dim"), "normal", d ** -0.5),
        "wv": ParamSpec((d, K, hd), ("embed", "kv_heads", "head_dim"), "normal", d ** -0.5),
        "wo": ParamSpec((H, hd, d), ("heads", "head_dim", "embed"), "normal",
                        (H * hd) ** -0.5),
    }
    if cfg.use_bias:
        specs["bq"] = ParamSpec((H, hd), ("heads", "head_dim"), "zeros")
        specs["bk"] = ParamSpec((K, hd), ("kv_heads", "head_dim"), "zeros")
        specs["bv"] = ParamSpec((K, hd), ("kv_heads", "head_dim"), "zeros")
        specs["bo"] = ParamSpec((d,), ("embed",), "zeros")
    return specs


# ---------------------------------------------------------------------------
# Projections
# ---------------------------------------------------------------------------

def _heads_proj(x, w):
    """einsum("bsd,dhk->bshk") as one matmul over the flattened heads."""
    d, h, k = w.shape
    B, S, _ = x.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).view(B, S, h, k)


def _project_q(cfg, p, x, positions, rope: bool, tables=None):
    q = _heads_proj(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    return apply_rope(q, positions, cfg.rope_theta, tables) if rope else q


def _project_kv(cfg, p, x, positions, rope: bool, tables=None):
    k = _heads_proj(x, p["wk"])
    v = _heads_proj(x, p["wv"])
    if "bk" in p:
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return (apply_rope(k, positions, cfg.rope_theta, tables) if rope else k), v


def _out_proj(p, o):
    B, S, H, hd = o.shape
    y = o.reshape(B, S, H * hd) @ p["wo"].to(o.dtype).reshape(H * hd, -1)
    if "bo" in p:
        y = y + p["bo"].to(o.dtype)
    return y


# ---------------------------------------------------------------------------
# Self-attention entry points
# ---------------------------------------------------------------------------

def self_attention(cfg, p, x, positions, *, rope: bool = True, causal: bool = True):
    """Full self-attention (train path; bidirectional for encoders).  x: (B,S,d)."""
    q = _project_q(cfg, p, x, positions, rope)
    k, v = _project_kv(cfg, p, x, positions, rope)
    return _out_proj(p, ops.flash_attention(q, k, v, causal=causal, scale=cfg.attn_scale))


def self_attention_prefill(cfg, p, x, positions, cache: dict, *, rope: bool = True):
    """Causal self-attention that also fills the KV cache: ``cache`` holds
    zeroed (B,cache_len,K,hd) buffers in the compute dtype (the dtype the
    reference's prefill cache takes), written in place.  Returns (out,
    cache)."""
    S = x.shape[1]
    q = _project_q(cfg, p, x, positions, rope)
    k, v = _project_kv(cfg, p, x, positions, rope)
    o = ops.flash_attention(q, k, v, causal=True, scale=cfg.attn_scale)
    cache["k"][:, :S] = k
    cache["v"][:, :S] = v
    return _out_proj(p, o), cache


class DecodeIndex(NamedTuple):
    """One decode step's position as each self-attention layer reads it:
    ``pos`` () or (B,) int32, ``positions`` (B, 1), the cache row written
    ``idx`` (int64), ``kv_len`` (B,) int32 and RoPE's ``tables`` (None
    without RoPE)."""
    pos: torch.Tensor
    positions: torch.Tensor
    idx: torch.Tensor
    kv_len: torch.Tensor
    tables: tuple | None


def decode_index(cfg, pos, B: int, S_max: int, device, *, rope: bool = True) -> DecodeIndex:
    """The :class:`DecodeIndex` of a step at ``pos`` (() shared write index,
    or (B,) per-row indices) over caches of ``S_max`` rows: computed once a
    step, not in each layer.

    Write-index semantics match the reference at ``pos >= S_max``: a
    scalar ``pos`` is clamped to ``S_max - 1`` (``dynamic_update_slice``),
    a per-row ``pos`` past the end writes nothing (out-of-bounds scatter
    drops); either way every cache row is visible (``kv_len = S_max``)."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=device)
    positions = pos[:, None] if pos.ndim == 1 else pos.reshape(1, 1).expand(B, 1)
    return DecodeIndex(
        pos, positions, pos.long().clamp(0, S_max - 1),
        (pos + 1).clamp(max=S_max).to(torch.int32).expand(B).contiguous(),
        rope_tables(positions, cfg.head_dim, cfg.rope_theta, device) if rope else None)


def self_attention_decode(cfg, p, x, cache, at: DecodeIndex, *, rope: bool = True):
    """One-token decode.  x: (B,1,d); cache k/v: (B,S_max,K,hd); ``at``:
    the step's :func:`decode_index`.

    The cache is updated IN PLACE (the returned dict holds the same
    tensors): a decode step writes one row per sequence, and copying the
    whole cache per step would cost its full size in memory traffic."""
    B = x.shape[0]
    kc, vc = cache["k"], cache["v"]
    S_max = kc.shape[1]
    q = _project_q(cfg, p, x, at.positions, rope, at.tables)
    k_new, v_new = _project_kv(cfg, p, x, at.positions, rope, at.tables)
    if at.pos.ndim == 1:
        rows = torch.arange(B, device=x.device)
        keep = (at.pos < S_max)[:, None, None]
        kc[rows, at.idx] = torch.where(keep, k_new[:, 0].to(kc.dtype), kc[rows, at.idx])
        vc[rows, at.idx] = torch.where(keep, v_new[:, 0].to(vc.dtype), vc[rows, at.idx])
    else:
        index_copy_(kc, 1, at.idx.reshape(1), k_new.to(kc.dtype))
        index_copy_(vc, 1, at.idx.reshape(1), v_new.to(vc.dtype))
    o = ops.decode_attention(q, kc, vc, at.kv_len, scale=cfg.attn_scale)
    return _out_proj(p, o), {"k": kc, "v": vc}


# ---------------------------------------------------------------------------
# Cross-attention (whisper decoder, llama-vision image layers)
# ---------------------------------------------------------------------------

def cross_kv(cfg, p, context):
    """The context's keys and values, (B,Tc,K,hd) each, without RoPE."""
    k, v = _project_kv(cfg, p, context, None, rope=False)
    return {"cross_k": k, "cross_v": v}


def cross_attention(cfg, p, x, context, kv: dict | None = None):
    """Bidirectional cross-attention; context: (B, Tc, d).  ``kv``: the
    context's ``cross_kv``, when the caller already has it (prefill stores
    the same keys and values in its cache).

    The reference upcasts both sides to fp32 and casts the result to q's
    dtype, so a context in another dtype than x's (fp32 frames against a
    bf16 decoder) is attended in the wider of the two."""
    kv = cross_kv(cfg, p, context) if kv is None else kv
    q = _project_q(cfg, p, x, None, rope=False)
    k, v = kv["cross_k"], kv["cross_v"]
    dt = torch.promote_types(q.dtype, k.dtype)
    o = ops.flash_attention(q.to(dt), k.to(dt), v.to(dt), causal=False, scale=cfg.attn_scale)
    return _out_proj(p, o.to(q.dtype))


def cross_attention_cached(cfg, p, x, cache):
    """Decode-time cross-attention against the cached context KV: every
    row sees all Tc context rows.  x: (B,1,d)."""
    B = x.shape[0]
    ck, cv = cache["cross_k"], cache["cross_v"]
    q = _project_q(cfg, p, x, None, rope=False)
    kv_len = torch.full((B,), ck.shape[1], dtype=torch.int32, device=x.device)
    return _out_proj(p, ops.decode_attention(q, ck, cv, kv_len, scale=cfg.attn_scale))


def init_attn_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                    device="cuda") -> dict:
    K, hd = cfg.num_kv_heads, cfg.head_dim
    return {"k": torch.zeros((batch, max_len, K, hd), dtype=dtype, device=device),
            "v": torch.zeros((batch, max_len, K, hd), dtype=dtype, device=device)}
