"""GQA self-attention: train / prefill / decode paths.

Layouts follow the JAX package: projections ``wq (d,H,hd)``, ``wk``/``wv
(d,K,hd)``, ``wo (H,hd,d)``; activations ``(B,S,H,hd)``; KV caches
``{"k": (B,S_max,K,hd), "v": (B,S_max,K,hd)}``.  Prefill and train go
through ``ops.flash_attention(causal=True)``; decode goes through
``ops.decode_attention`` with ``kv_len = pos + 1``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope
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


def _project_q(cfg, p, x, positions):
    q = _heads_proj(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    return apply_rope(q, positions, cfg.rope_theta)


def _project_kv(cfg, p, x, positions):
    k = _heads_proj(x, p["wk"])
    v = _heads_proj(x, p["wv"])
    if "bk" in p:
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return apply_rope(k, positions, cfg.rope_theta), v


def _out_proj(p, o):
    B, S, H, hd = o.shape
    y = o.reshape(B, S, H * hd) @ p["wo"].to(o.dtype).reshape(H * hd, -1)
    if "bo" in p:
        y = y + p["bo"].to(o.dtype)
    return y


# ---------------------------------------------------------------------------
# Self-attention entry points
# ---------------------------------------------------------------------------

def self_attention(cfg, p, x, positions):
    """Causal self-attention (train path).  x: (B,S,d)."""
    q = _project_q(cfg, p, x, positions)
    k, v = _project_kv(cfg, p, x, positions)
    return _out_proj(p, ops.flash_attention(q, k, v, causal=True))


def self_attention_prefill(cfg, p, x, positions, cache: dict):
    """Causal self-attention that also fills the KV cache: ``cache`` holds
    zeroed (B,cache_len,K,hd) buffers in the compute dtype (the dtype the
    reference's prefill cache takes), written in place.  Returns (out,
    cache)."""
    S = x.shape[1]
    q = _project_q(cfg, p, x, positions)
    k, v = _project_kv(cfg, p, x, positions)
    o = ops.flash_attention(q, k, v, causal=True)
    cache["k"][:, :S] = k
    cache["v"][:, :S] = v
    return _out_proj(p, o), cache


def self_attention_decode(cfg, p, x, cache, pos):
    """One-token decode.  x: (B,1,d); cache k/v: (B,S_max,K,hd); pos: ()
    shared write index, or (B,) per-row indices (continuous batching).

    The cache is updated IN PLACE (the returned dict holds the same
    tensors): a decode step writes one row per sequence, and copying the
    whole cache per step would cost its full size in memory traffic.

    Write-index semantics match the reference at ``pos >= S_max``: a
    scalar ``pos`` is clamped to ``S_max - 1`` (``dynamic_update_slice``),
    a per-row ``pos`` past the end writes nothing (out-of-bounds scatter
    drops); either way every cache row is visible (``kv_len = S_max``)."""
    B = x.shape[0]
    kc, vc = cache["k"], cache["v"]
    S_max = kc.shape[1]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    per_row = pos.ndim == 1
    positions = pos[:, None] if per_row else pos.reshape(1, 1).expand(B, 1)
    q = _project_q(cfg, p, x, positions)
    k_new, v_new = _project_kv(cfg, p, x, positions)
    idx = pos.long().clamp(0, S_max - 1)
    if per_row:
        rows = torch.arange(B, device=x.device)
        keep = (pos < S_max)[:, None, None]
        kc[rows, idx] = torch.where(keep, k_new[:, 0].to(kc.dtype), kc[rows, idx])
        vc[rows, idx] = torch.where(keep, v_new[:, 0].to(vc.dtype), vc[rows, idx])
    else:
        kc.index_copy_(1, idx.reshape(1), k_new.to(kc.dtype))
        vc.index_copy_(1, idx.reshape(1), v_new.to(vc.dtype))
    kv_len = (pos + 1).clamp(max=S_max).to(torch.int32).expand(B).contiguous()
    o = ops.decode_attention(q, kc, vc, kv_len)
    return _out_proj(p, o), {"k": kc, "v": vc}

