"""Layer-block assembly shared by all decoder families.

A *block* is the smallest repeating unit of the stack (1 layer for dense,
moe and ssm, ``attn_every`` layers for the hybrid, ``cross_attn_every``
layers for the VLM).  All blocks of a model share one tree structure, so
block parameters are stacked with a leading dimension (``blocks``) as in the
reference, and the stack is applied by a Python loop over it
(``models.transformer``).

Per-layer cache entries (decode), each stacked over blocks:
  attn layer  -> {"k", "v"}
  mamba layer -> {"conv", "ssm"}
  cross layer -> additionally {"cross_k", "cross_v"}
A pure-SSM layer has ``mixer_norm`` and ``mamba`` and no FFN sublayer.
"""
from __future__ import annotations

import time

import torch

from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models.layers import apply_norm, norm_specs
from repro_torch.models.mlp import apply_mlp, mlp_specs
from repro_torch.models.moe import apply_moe, moe_specs
from repro_torch.models.params import ParamSpec
from repro_torch.obs import trace as _trace
from repro_torch.utils import tree_map


def block_size(cfg) -> int:
    if cfg.family == "hybrid":
        return cfg.attn_every
    if cfg.family == "vlm" and cfg.cross_attn_every > 0:
        return cfg.cross_attn_every
    return 1


def num_blocks(cfg) -> int:
    bs = block_size(cfg)
    assert cfg.num_layers % bs == 0, (cfg.name, cfg.num_layers, bs)
    return cfg.num_layers // bs


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def _layer_specs(cfg, i: int) -> dict:
    """Specs for global layer index i (only i % block_size matters)."""
    kind = cfg.layer_kind(i)
    specs: dict = {"mixer_norm": norm_specs(cfg)}
    if kind == "attn":
        specs["attn"] = attn.attn_specs(cfg)
    else:
        specs["mamba"] = mb.mamba_specs(cfg)
    if cfg.layer_has_cross_attn(i):
        specs["cross_norm"] = norm_specs(cfg)
        specs["cross"] = attn.attn_specs(cfg)
        specs["cross_gate"] = ParamSpec((1,), (None,), "zeros", dtype=torch.float32)
    if kind == "attn" or cfg.family != "ssm":
        # every non-pure-SSM layer has an FFN sublayer
        specs["ffn_norm"] = norm_specs(cfg)
        if cfg.layer_has_moe(i):
            specs["moe"] = moe_specs(cfg)
        else:
            specs["mlp"] = mlp_specs(cfg)
    return specs


def block_specs(cfg) -> dict:
    return {"layers": [_layer_specs(cfg, j) for j in range(block_size(cfg))]}


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------

def _layer_cache(cfg, i: int, batch: int, max_len: int, dtype, device,
                 cross_dtype=None) -> dict:
    if cfg.layer_kind(i) == "attn":
        cache = attn.init_attn_cache(cfg, batch, max_len, dtype, device)
    else:
        cache = mb.init_mamba_cache(cfg, batch, dtype, device)
    if cfg.layer_has_cross_attn(i):
        shape = (batch, cfg.num_vision_tokens, cfg.num_kv_heads, cfg.head_dim)
        cache["cross_k"] = torch.zeros(shape, dtype=cross_dtype or dtype, device=device)
        cache["cross_v"] = torch.zeros(shape, dtype=cross_dtype or dtype, device=device)
    return cache


def block_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device="cuda",
                cross_dtype=None) -> dict:
    """One block's cache: a dict per layer of the block."""
    return {"layers": [_layer_cache(cfg, j, batch, max_len, dtype, device, cross_dtype)
                       for j in range(block_size(cfg))]}


def stacked_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                  device="cuda", cross_dtype=None) -> dict:
    """Cache stacked over blocks (leading dim = num_blocks): k/v
    (nb, B, S_max, K, hd), cross_k/cross_v (nb, B, Tv, K, hd) and conv
    (nb, B, ck-1, conv_dim) in ``dtype`` (the cross leaves in
    ``cross_dtype`` if given); ssm (nb, B, H, P, N) fp32."""
    nb = num_blocks(cfg)
    one = block_cache(cfg, batch, max_len, dtype, "meta", cross_dtype)
    return tree_map(lambda v: torch.zeros((nb, *v.shape), dtype=v.dtype, device=device), one)


def zeros_like_h(template, h):
    """The zero tree shaped as ``template`` (meta tensors), made by
    ``h.new_zeros``: on h's device, and a DTensor (replicated) when h is
    one (the dry-run's prefill writes its cache shard by shard)."""
    return tree_map(lambda t: h.new_zeros(t.shape, dtype=t.dtype), template)


def decode_cache(cfg, cache: dict, dtype) -> dict:
    """The stacked cache a decode step writes into.  The reference's mamba
    decode returns its conv window in the compute dtype whatever the
    cache's (``mamba.py`` concatenates ``cache["conv"].astype(pre.dtype)``),
    so a conv leaf in another dtype is converted once here, in every mamba
    layer of a block (a hybrid block mixes them with attention layers); the
    in-place writes then match it.  KV and cross-attention caches keep their
    dtype, as the reference casts the new keys and values to it."""
    for layer in cache["layers"]:
        if "conv" in layer and layer["conv"].dtype != dtype:
            layer["conv"] = layer["conv"].to(dtype)
    return cache


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------

def _apply_layer(cfg, p: dict, h, *, positions, mode: str, cache: dict | None, pos,
                 context):
    """One layer.  Returns (h, new_cache, aux_loss: a tensor for a MoE
    layer, else 0.0).  Prefill and decode write into ``cache`` (views of
    the stacked cache) in place.  In a traced call (``obs.trace``) the
    mixer and FFN sublayers, each with its norm and residual add, are
    booked as the ``mixer`` and ``ffn`` stages."""
    aux = 0.0
    stages = _trace.CURRENT.stages
    t = time.perf_counter_ns() if stages is not None else 0
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
    else:
        rope = cfg.family != "encdec"
        if mode == "train":
            mix = attn.self_attention(cfg, p["attn"], normed, positions, rope=rope)
        elif mode == "prefill":
            mix, new_cache = attn.self_attention_prefill(cfg, p["attn"], normed, positions,
                                                         cache, rope=rope)
        else:  # decode
            mix, new_cache = attn.self_attention_decode(cfg, p["attn"], normed, cache, pos,
                                                        rope=rope)

    h = h + mix
    if stages is not None:
        t = stages.stage("mixer", t)
    if cfg.parallel_block and "mlp" in p:
        # command-r style: shared-norm parallel attn + ffn residual
        # (cross/moe never combined with parallel_block in assigned archs)
        h = h + apply_mlp(cfg, p["mlp"], normed)
        if stages is not None:
            stages.stage("ffn", t)
        return h, new_cache, aux

    # ---- gated cross-attention (VLM) ---------------------------------------
    if "cross" in p:
        cn = apply_norm(cfg, p["cross_norm"], h)
        if mode == "decode":
            ca = attn.cross_attention_cached(cfg, p["cross"], cn, cache)
        elif mode == "prefill":
            kv = attn.cross_kv(cfg, p["cross"], context)
            ca = attn.cross_attention(cfg, p["cross"], cn, context, kv)
            cache["cross_k"].copy_(kv["cross_k"])
            cache["cross_v"].copy_(kv["cross_v"])
        else:
            ca = attn.cross_attention(cfg, p["cross"], cn, context)
        h = h + torch.tanh(p["cross_gate"]).to(h.dtype) * ca

    # ---- FFN ----------------------------------------------------------------
    if "moe" in p or "mlp" in p:
        if stages is not None:
            t = time.perf_counter_ns()
        if "moe" in p:
            y, aux = apply_moe(cfg, p["moe"], apply_norm(cfg, p["ffn_norm"], h))
        else:
            y = apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ffn_norm"], h))
        h = h + y
        if stages is not None:
            stages.stage("ffn", t)
    return h, new_cache, aux


def apply_block(cfg, p: dict, h, *, positions, mode: str, cache: dict | None, pos=None,
                context=None):
    """Apply one block (list of layers).  Returns (h, new_cache, aux): aux
    summed over the block's MoE layers (0.0 if it has none)."""
    aux = 0.0
    new_layers = []
    for j, lp in enumerate(p["layers"]):
        lcache = cache["layers"][j] if cache is not None else None
        h, nc, a = _apply_layer(cfg, lp, h, positions=positions, mode=mode, cache=lcache,
                                pos=pos, context=context)
        new_layers.append(nc)
        aux = aux + a
    return h, {"layers": new_layers}, aux
