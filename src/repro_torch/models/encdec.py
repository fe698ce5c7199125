"""Whisper-style encoder-decoder backbone.

The conv/audio frontend is a stub, as in the JAX package: the encoder
consumes precomputed frame embeddings (B, F, d_model).  Positions are fixed
sinusoidal (Whisper); attention is bidirectional in the encoder (flash,
non-causal, Sq = Sk = F), causal without RoPE plus cross-attention over the
encoder output in the decoder (flash non-causal with Sq != Sk; at decode,
decode attention with ``kv_len = F``).  Layers are stacked (``enc_blocks``,
``dec_blocks``) and applied by a Python loop; the decode cache is
``{"k", "v", "cross_k", "cross_v"}`` stacked over decoder layers and
written in place.  Whisper uses layernorm, so no rmsnorm kernel runs here.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models.blocks import zeros_like_h
from repro_torch.models.layers import (apply_norm, embed_specs, embed_tokens, norm_specs,
                                       sinusoidal_at, sinusoidal_positions)
from repro_torch.models.mlp import apply_mlp, mlp_specs
from repro_torch.models.params import stack_specs
from repro_torch.models.transformer import _positions, _unstack


def _enc_layer_specs(cfg) -> dict:
    return {"mixer_norm": norm_specs(cfg), "attn": attn.attn_specs(cfg),
            "ffn_norm": norm_specs(cfg), "mlp": mlp_specs(cfg)}


def _dec_layer_specs(cfg) -> dict:
    return {"mixer_norm": norm_specs(cfg), "attn": attn.attn_specs(cfg),
            "cross_norm": norm_specs(cfg), "cross": attn.attn_specs(cfg),
            "ffn_norm": norm_specs(cfg), "mlp": mlp_specs(cfg)}


def encdec_specs(cfg) -> dict:
    return {
        "embed": embed_specs(cfg),
        "enc_blocks": stack_specs(_enc_layer_specs(cfg), cfg.enc_layers, "layers"),
        "enc_norm": norm_specs(cfg),
        "dec_blocks": stack_specs(_dec_layer_specs(cfg), cfg.num_layers, "layers"),
        "final_norm": norm_specs(cfg),
    }


def _loop(cfg, body, h, blocks, *extra):
    """Apply ``body(h, p, *extra)`` over the stacked layers, each under
    ``torch.utils.checkpoint`` when ``cfg.remat`` and autograd is
    recording (the reference's ``jax.checkpoint`` around its scan body)."""
    remat = cfg.remat and torch.is_grad_enabled()
    for p in _unstack(blocks):
        h = (checkpoint(body, h, p, *extra, use_reentrant=False, preserve_rng_state=False)
             if remat else body(h, p, *extra))
    return h


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def encode(cfg, params, frames):
    """frames: (B, F, d) stubbed frame embeddings -> encoder output (B, F, d)
    in the frames' dtype (as in the reference, fp32 frames run the encoder
    in fp32)."""
    B, F, d = frames.shape
    h = frames + sinusoidal_positions(F, d, frames.device).to(frames.dtype)[None]
    zeros = torch.zeros((B, F), dtype=torch.int32, device=frames.device)

    def body(hh, p):
        n = apply_norm(cfg, p["mixer_norm"], hh)
        hh = hh + attn.self_attention(cfg, p["attn"], n, zeros, rope=False, causal=False)
        return hh + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ffn_norm"], hh))

    h = _loop(cfg, body, h, params["enc_blocks"])
    return apply_norm(cfg, params["enc_norm"], h)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def _embed_dec(cfg, params, tokens, positions):
    h = embed_tokens(cfg, params["embed"], tokens)
    return h + sinusoidal_at(positions, cfg.d_model).to(h.dtype)


def dec_hidden(cfg, params, tokens, enc_out):
    """Train path: (B,S) tokens + (B,F,d) encoder output -> (B,S,d)."""
    positions = _positions(tokens)
    h = _embed_dec(cfg, params, tokens, positions)

    def body(hh, p):
        n = apply_norm(cfg, p["mixer_norm"], hh)
        hh = hh + attn.self_attention(cfg, p["attn"], n, positions, rope=False)
        n = apply_norm(cfg, p["cross_norm"], hh)
        hh = hh + attn.cross_attention(cfg, p["cross"], n, enc_out)
        return hh + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ffn_norm"], hh))

    h = _loop(cfg, body, h, params["dec_blocks"])
    return apply_norm(cfg, params["final_norm"], h)


def dec_prefill(cfg, params, tokens, enc_out, cache_len: int, cache_dtype=torch.bfloat16):
    """Returns (h, cache).  The cache takes the compute dtype (cross_k /
    cross_v the encoder output's), as the reference's stacked scan outputs
    do; ``cache_dtype`` has no effect there either."""
    del cache_dtype
    B, S = tokens.shape
    positions = _positions(tokens)
    h = _embed_dec(cfg, params, tokens, positions)
    cache = zeros_like_h(encdec_init_cache(cfg, B, cache_len, h.dtype, "meta",
                                           cross_dtype=enc_out.dtype, frames=enc_out.shape[1]), h)
    for p, c in zip(_unstack(params["dec_blocks"]), _unstack(cache)):
        n = apply_norm(cfg, p["mixer_norm"], h)
        mix, _ = attn.self_attention_prefill(cfg, p["attn"], n, positions, c, rope=False)
        h = h + mix
        n = apply_norm(cfg, p["cross_norm"], h)
        kv = attn.cross_kv(cfg, p["cross"], enc_out)
        h = h + attn.cross_attention(cfg, p["cross"], n, enc_out, kv)
        c["cross_k"].copy_(kv["cross_k"])
        c["cross_v"].copy_(kv["cross_v"])
        h = h + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ffn_norm"], h))
    return apply_norm(cfg, params["final_norm"], h), cache


def dec_step(cfg, params, cache, tokens, pos):
    """One-token decode.  tokens: (B,1); pos: () shared or (B,) per-row.
    The cache is updated in place."""
    at = attn.decode_index(cfg, pos, tokens.shape[0], cache["k"].shape[2], tokens.device,
                           rope=False)
    h = _embed_dec(cfg, params, tokens, at.positions)
    for p, c in zip(_unstack(params["dec_blocks"]), _unstack(cache)):
        n = apply_norm(cfg, p["mixer_norm"], h)
        mix, _ = attn.self_attention_decode(cfg, p["attn"], n, c, at, rope=False)
        h = h + mix
        n = apply_norm(cfg, p["cross_norm"], h)
        h = h + attn.cross_attention_cached(cfg, p["cross"], n, c)
        h = h + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ffn_norm"], h))
    return apply_norm(cfg, params["final_norm"], h), cache


def encdec_init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device="cuda",
                      *, cross_dtype=None, frames: int | None = None) -> dict:
    K, hd, L = cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
    F = cfg.num_audio_frames if frames is None else frames
    return {
        "k": torch.zeros((L, batch, max_len, K, hd), dtype=dtype, device=device),
        "v": torch.zeros((L, batch, max_len, K, hd), dtype=dtype, device=device),
        "cross_k": torch.zeros((L, batch, F, K, hd), dtype=cross_dtype or dtype, device=device),
        "cross_v": torch.zeros((L, batch, F, K, hd), dtype=cross_dtype or dtype, device=device),
    }
