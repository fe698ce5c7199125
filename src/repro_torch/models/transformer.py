"""Decoder-only stack (families dense / moe / ssm / hybrid / vlm): a Python
loop over the stacked block parameters (the reference's ``lax.scan``), with
optional remat on the train path.  Returns hidden states; unembedding and
losses live in ``repro_torch.models.model``.  ``context`` is the VLM's
vision rows (B, Tv, d), which its cross-attention layers attend to."""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import decode_index
from repro_torch.models.blocks import (apply_block, block_specs, decode_cache, num_blocks,
                                       stacked_cache, zeros_like_h)
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


def _train_block(cfg, bp, h, positions, context):
    h, _, aux = apply_block(cfg, bp, h, positions=positions, mode="train", cache=None,
                            context=context)
    return h, aux


def lm_hidden(cfg, params, tokens, *, context=None):
    """Train-path forward -> (final hidden states (B, S, d), the aux loss
    summed over layers, fp32).  With ``cfg.remat`` and autograd recording,
    each block runs under ``torch.utils.checkpoint`` (the reference wraps
    its scan body in ``jax.checkpoint``): backward recomputes the block's
    forward, so its kernels launch twice per training step."""
    positions = _positions(tokens)
    h = embed_tokens(cfg, params["embed"], tokens)
    remat = cfg.remat and torch.is_grad_enabled()
    auxes = []
    for bp in _unstack(params["blocks"]):
        if remat:
            h, aux = checkpoint(_train_block, cfg, bp, h, positions, context,
                                use_reentrant=False, preserve_rng_state=False)
        else:
            h, aux = _train_block(cfg, bp, h, positions, context)
        if isinstance(aux, torch.Tensor):
            auxes.append(aux)
    aux = (torch.stack(auxes).sum() if auxes
           else torch.zeros((), dtype=torch.float32, device=h.device))
    return apply_norm(cfg, params["final_norm"], h), aux


def lm_prefill(cfg, params, tokens, cache_len: int, *, context=None,
               cache_dtype=torch.bfloat16):
    """Prefill: returns (h (B,S,d), stacked cache).

    The cache takes the COMPUTE dtype, as the reference's does:
    ``lm_prefill`` there uses its ``cache_dtype`` init only for the shape
    and stacks the prefill's own keys and values (or, for an SSM layer,
    conv windows; its ``ssm`` state stays fp32).  ``cache_dtype`` is
    accepted for that reason and has no effect here either.  A VLM's
    cross-attention leaves take its context's dtype, the dtype of the
    reference's ``cross_kv``."""
    del cache_dtype
    B, _ = tokens.shape
    positions = _positions(tokens)
    h = embed_tokens(cfg, params["embed"], tokens)
    cache = zeros_like_h(stacked_cache(cfg, B, cache_len, h.dtype, "meta",
                                       None if context is None else context.dtype), h)
    for bp, bc in zip(_unstack(params["blocks"]), _unstack(cache)):
        h, _, _ = apply_block(cfg, bp, h, positions=positions, mode="prefill", cache=bc,
                              context=context)
    return apply_norm(cfg, params["final_norm"], h), cache


def lm_decode_step(cfg, params, cache, tokens, pos, *, context=None):
    """One-token decode.  tokens: (B,1); pos: () shared or (B,) per-row.
    Returns (h, cache); the cache is updated in place (an SSM conv leaf in
    another dtype than the compute dtype is first converted to it, as the
    reference's decode returns it).  ``context`` is accepted as the
    reference accepts it and unused: cross-attention reads the cached
    context keys and values."""
    del context
    h = embed_tokens(cfg, params["embed"], tokens)
    cache = decode_cache(cfg, cache, h.dtype)
    kv = [layer["k"] for layer in cache["layers"] if "k" in layer]
    at = (decode_index(cfg, pos, tokens.shape[0], kv[0].shape[2], tokens.device,
                       rope=cfg.uses_rope) if kv else None)
    for bp, bc in zip(_unstack(params["blocks"]), _unstack(cache)):
        h, _, _ = apply_block(cfg, bp, h, positions=None, mode="decode", cache=bc, pos=at)
    return apply_norm(cfg, params["final_norm"], h), cache


def lm_init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device="cuda"):
    return stacked_cache(cfg, batch, max_len, dtype, device)
