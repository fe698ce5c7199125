"""Layer-block assembly for the dense decoder family.

A dense block is one layer; block parameters are stacked with a leading
dimension (``blocks``) as in the reference, and the stack is applied by a
Python loop over it (``models.transformer``).  Other families (moe, ssm,
hybrid, vlm, encdec) are not ported yet and raise ``NotImplementedError``.

Per-layer cache entries (decode): ``{"k", "v"}``.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models.layers import apply_norm, norm_specs
from repro_torch.models.mlp import apply_mlp, mlp_specs


def check_family(cfg) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (dense only)")


def num_blocks(cfg) -> int:
    check_family(cfg)
    return cfg.num_layers


# ---------------------------------------------------------------------------
# Specs / cache
# ---------------------------------------------------------------------------

def block_specs(cfg) -> dict:
    check_family(cfg)
    return {"layers": [{"mixer_norm": norm_specs(cfg), "attn": attn.attn_specs(cfg),
                        "ffn_norm": norm_specs(cfg), "mlp": mlp_specs(cfg)}]}


def stacked_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                  device="cuda") -> dict:
    """Cache stacked over blocks: leaves (L, B, S_max, K, hd)."""
    shape = (num_blocks(cfg), batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"layers": [{"k": torch.zeros(shape, dtype=dtype, device=device),
                        "v": torch.zeros(shape, dtype=dtype, device=device)}]}


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------

def _apply_layer(cfg, p: dict, h, *, positions, mode: str, cache: dict | None, pos):
    """One dense layer.  Returns (h, new_cache)."""
    normed = apply_norm(cfg, p["mixer_norm"], h)
    new_cache: dict = {}
    if mode == "train":
        mix = attn.self_attention(cfg, p["attn"], normed, positions)
    elif mode == "prefill":
        mix, new_cache = attn.self_attention_prefill(cfg, p["attn"], normed, positions, cache)
    else:  # decode
        mix, new_cache = attn.self_attention_decode(cfg, p["attn"], normed, cache, pos)

    if cfg.parallel_block:
        # command-r style: shared-norm parallel attn + ffn residual
        return h + mix + apply_mlp(cfg, p["mlp"], normed), new_cache

    h = h + mix
    fn = apply_norm(cfg, p["ffn_norm"], h)
    return h + apply_mlp(cfg, p["mlp"], fn), new_cache


def apply_block(cfg, p: dict, h, *, positions, mode: str, cache: dict | None, pos=None):
    """Apply one block (list of layers).  Returns (h, new_cache)."""
    new_layers = []
    for j, lp in enumerate(p["layers"]):
        lcache = cache["layers"][j] if cache is not None else None
        h, nc = _apply_layer(cfg, lp, h, positions=positions, mode=mode,
                             cache=lcache, pos=pos)
        new_layers.append(nc)
    return h, {"layers": new_layers}
