"""Decoder-only stack (dense and pure-SSM families): a Python loop over the
stacked block parameters (the reference's ``lax.scan``), with optional remat
on the train path.  Returns hidden states; unembedding and losses live in
``repro_torch.models.model``."""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.blocks import (apply_block, block_specs, decode_cache, num_blocks,
                                       stacked_cache)
from repro_torch.models.layers import apply_norm, embed_specs, embed_tokens, norm_specs
from repro_torch.models.params import stack_specs
from repro_torch.utils import tree_flatten, tree_unflatten


def lm_specs(cfg) -> dict:
    return {
        "embed": embed_specs(cfg),
        "blocks": stack_specs(block_specs(cfg), num_blocks(cfg), "layers"),
        "final_norm": norm_specs(cfg),
    }


def _positions(tokens):
    B, S = tokens.shape
    return torch.arange(S, dtype=torch.int32, device=tokens.device)[None].expand(B, S)


def _unstack(tree) -> list:
    """Per-block trees of parameters or cache: one ``torch.unbind`` per
    stacked leaf.  Each block's leaf is a view, so a cache written in place
    through it is written in the stack.  Indexing ``x[i]`` per block would
    give each block's gradient its own ``select`` backward, which
    materialises a zero tensor of the whole stacked leaf; unbind's backward
    stacks the blocks' gradients once."""
    leaves, treedef = tree_flatten(tree)
    per_leaf = [torch.unbind(x, 0) for x in leaves]
    return [tree_unflatten(treedef, [blocks[i] for blocks in per_leaf])
            for i in range(len(per_leaf[0]))]


def _train_block(cfg, bp, h, positions):
    return apply_block(cfg, bp, h, positions=positions, mode="train", cache=None)[0]


def lm_hidden(cfg, params, tokens):
    """Train-path forward to final hidden states (B, S, d).  With
    ``cfg.remat`` and autograd recording, each block runs under
    ``torch.utils.checkpoint`` (the reference wraps its scan body in
    ``jax.checkpoint``): backward recomputes the block's forward, so its
    kernels launch twice per training step."""
    positions = _positions(tokens)
    h = embed_tokens(cfg, params["embed"], tokens)
    remat = cfg.remat and torch.is_grad_enabled()
    for bp in _unstack(params["blocks"]):
        if remat:
            h = checkpoint(_train_block, cfg, bp, h, positions, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            h = _train_block(cfg, bp, h, positions)
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
    for bp, bc in zip(_unstack(params["blocks"]), _unstack(cache)):
        h, _ = apply_block(cfg, bp, h, positions=positions, mode="prefill", cache=bc)
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
    for bp, bc in zip(_unstack(params["blocks"]), _unstack(cache)):
        h, _ = apply_block(cfg, bp, h, positions=positions, mode="decode", cache=bc, pos=pos)
    return apply_norm(cfg, params["final_norm"], h), cache


def lm_init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device="cuda"):
    return stacked_cache(cfg, batch, max_len, dtype, device)
