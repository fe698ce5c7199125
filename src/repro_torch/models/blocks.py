"""Layer-block assembly for the dense decoder and pure-SSM families.

A block is one layer; block parameters are stacked with a leading
dimension (``blocks``) as in the reference, and the stack is applied by a
Python loop over it (``models.transformer``).  Other families (moe, hybrid,
vlm, encdec) are not ported yet and raise ``NotImplementedError``.

Per-layer cache entries (decode):
  attn layer  -> {"k", "v"}
  mamba layer -> {"conv", "ssm"}
A pure-SSM layer has ``mixer_norm`` and ``mamba`` and no FFN sublayer.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models.layers import apply_norm, norm_specs
from repro_torch.models.mlp import apply_mlp, mlp_specs

FAMILIES = ("dense", "ssm")


def check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet ({', '.join(FAMILIES)} only)")


def num_blocks(cfg) -> int:
    check_family(cfg)
    return cfg.num_layers


# ---------------------------------------------------------------------------
# Specs / cache
# ---------------------------------------------------------------------------

def block_specs(cfg) -> dict:
    check_family(cfg)
    if cfg.family == "ssm":
        return {"layers": [{"mixer_norm": norm_specs(cfg), "mamba": mb.mamba_specs(cfg)}]}
    return {"layers": [{"mixer_norm": norm_specs(cfg), "attn": attn.attn_specs(cfg),
                        "ffn_norm": norm_specs(cfg), "mlp": mlp_specs(cfg)}]}


def stacked_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                  device="cuda") -> dict:
    """Cache stacked over blocks: dense leaves k/v (L, B, S_max, K, hd);
    SSM leaves conv (L, B, ck-1, conv_dim) in ``dtype`` and ssm
    (L, B, H, P, N) fp32 (``max_len`` unused: the SSM state is O(1))."""
    L = num_blocks(cfg)
    if cfg.family == "ssm":
        one = mb.init_mamba_cache(cfg, batch, dtype, device)
        return {"layers": [{k: torch.zeros((L, *v.shape), dtype=v.dtype, device=v.device)
                            for k, v in one.items()}]}
    shape = (L, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"layers": [{"k": torch.zeros(shape, dtype=dtype, device=device),
                        "v": torch.zeros(shape, dtype=dtype, device=device)}]}


def decode_cache(cfg, cache: dict, dtype) -> dict:
    """The stacked cache a decode step writes into.  The reference's mamba
    decode returns its conv window in the compute dtype whatever the
    cache's (``mamba.py`` concatenates ``cache["conv"].astype(pre.dtype)``),
    so an SSM conv leaf in another dtype is converted once here; the
    in-place writes then match it.  KV caches keep their dtype, as the
    reference casts the new keys and values to it."""
    if cfg.family != "ssm":
        return cache
    for layer in cache["layers"]:
        if layer["conv"].dtype != dtype:
            layer["conv"] = layer["conv"].to(dtype)
    return cache


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------

def _apply_layer(cfg, p: dict, h, *, positions, mode: str, cache: dict | None, pos):
    """One layer.  Returns (h, new_cache).  Prefill and decode write into
    ``cache`` (views of the stacked cache) in place."""
    normed = apply_norm(cfg, p["mixer_norm"], h)
    new_cache: dict = {}
    if "mamba" in p:
        if mode == "train":
            mix, _ = mb.mamba_forward(cfg, p["mamba"], normed)
        else:
            if mode == "prefill":
                mix, mc = mb.mamba_forward(cfg, p["mamba"], normed, return_cache=True)
            else:  # decode
                mix, mc = mb.mamba_decode(cfg, p["mamba"], normed, cache)
            cache["conv"].copy_(mc["conv"])
            cache["ssm"].copy_(mc["ssm"])
            new_cache = cache
    elif mode == "train":
        mix = attn.self_attention(cfg, p["attn"], normed, positions)
    elif mode == "prefill":
        mix, new_cache = attn.self_attention_prefill(cfg, p["attn"], normed, positions, cache)
    else:  # decode
        mix, new_cache = attn.self_attention_decode(cfg, p["attn"], normed, cache, pos)

    if cfg.parallel_block and "mlp" in p:
        # command-r style: shared-norm parallel attn + ffn residual
        return h + mix + apply_mlp(cfg, p["mlp"], normed), new_cache

    h = h + mix
    if "mlp" not in p:
        return h, new_cache
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
