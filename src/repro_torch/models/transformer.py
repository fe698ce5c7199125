"""Decoder-only stack (dense and pure-SSM families): a Python loop over the
stacked block parameters (the reference's ``lax.scan``).  Returns hidden
states; unembedding and losses live in ``repro_torch.models.model``."""
from __future__ import annotations

import torch

from repro_torch.models.blocks import (apply_block, block_specs, decode_cache, num_blocks,
                                       stacked_cache)
from repro_torch.models.layers import apply_norm, embed_specs, embed_tokens, norm_specs
from repro_torch.models.params import stack_specs
from repro_torch.utils import tree_map


def lm_specs(cfg) -> dict:
    return {
        "embed": embed_specs(cfg),
        "blocks": stack_specs(block_specs(cfg), num_blocks(cfg), "layers"),
        "final_norm": norm_specs(cfg),
    }


def _positions(tokens):
    B, S = tokens.shape
    return torch.arange(S, dtype=torch.int32, device=tokens.device)[None].expand(B, S)


def _block(tree, i: int):
    return tree_map(lambda x: x[i], tree)


def lm_hidden(cfg, params, tokens):
    """Train-path forward to final hidden states (B, S, d)."""
    positions = _positions(tokens)
    h = embed_tokens(cfg, params["embed"], tokens)
    for i in range(num_blocks(cfg)):
        h, _ = apply_block(cfg, _block(params["blocks"], i), h,
                           positions=positions, mode="train", cache=None)
    return apply_norm(cfg, params["final_norm"], h)


def lm_prefill(cfg, params, tokens, cache_len: int, *, cache_dtype=torch.bfloat16):
    """Prefill: returns (h (B,S,d), stacked cache).

    The cache takes the COMPUTE dtype, as the reference's does:
    ``lm_prefill`` there uses its ``cache_dtype`` init only for the shape
    and stacks the prefill's own keys and values (or, for an SSM layer,
    conv windows; its ``ssm`` state stays fp32).  ``cache_dtype`` is
    accepted for that reason and has no effect here either."""
    del cache_dtype
    B, _ = tokens.shape
    positions = _positions(tokens)
    h = embed_tokens(cfg, params["embed"], tokens)
    cache = stacked_cache(cfg, B, cache_len, h.dtype, h.device)
    for i in range(num_blocks(cfg)):
        h, _ = apply_block(cfg, _block(params["blocks"], i), h, positions=positions,
                           mode="prefill", cache=_block(cache, i))
    return apply_norm(cfg, params["final_norm"], h), cache


def lm_decode_step(cfg, params, cache, tokens, pos):
    """One-token decode.  tokens: (B,1); pos: () shared or (B,) per-row.
    Returns (h, cache); the cache is updated in place (an SSM conv leaf in
    another dtype than the compute dtype is first converted to it, as the
    reference's decode returns it)."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=tokens.device)
    B = tokens.shape[0]
    positions = pos[:, None] if pos.ndim == 1 else pos.reshape(1, 1).expand(B, 1)
    h = embed_tokens(cfg, params["embed"], tokens)
    cache = decode_cache(cfg, cache, h.dtype)
    for i in range(num_blocks(cfg)):
        h, _ = apply_block(cfg, _block(params["blocks"], i), h, positions=positions,
                           mode="decode", cache=_block(cache, i), pos=pos)
    return apply_norm(cfg, params["final_norm"], h), cache


def lm_init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device="cuda"):
    return stacked_cache(cfg, batch, max_len, dtype, device)
