"""Shared primitive layers: norms, embeddings, rotary embeddings, linear."""
from __future__ import annotations

import torch

from repro_torch.distributed.dtensor import embed_per_shard, is_dtensor
from repro_torch.kernels import ops
from repro_torch.models.params import ParamSpec

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

def norm_specs(cfg) -> dict:
    if cfg.norm == "rmsnorm":
        return {"scale": ParamSpec((cfg.d_model,), ("embed",), "ones", dtype=torch.float32)}
    return {"scale": ParamSpec((cfg.d_model,), ("embed",), "ones", dtype=torch.float32),
            "bias": ParamSpec((cfg.d_model,), ("embed",), "zeros", dtype=torch.float32)}


def apply_norm(cfg, p, x):
    """rmsnorm goes through the kernel (fp32 reduce, cast back to x.dtype);
    layernorm stays plain.  Both at ``cfg.norm_eps``."""
    eps = cfg.norm_eps
    if cfg.norm == "rmsnorm":
        return ops.rmsnorm(x, p["scale"], eps=eps)
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_specs(cfg) -> dict:
    specs = {"tok": ParamSpec((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"),
                              "normal", 0.02)}
    if not cfg.tie_embeddings:
        specs["head"] = ParamSpec((cfg.d_model, cfg.padded_vocab), ("embed", "vocab"),
                                  "normal", cfg.d_model ** -0.5)
    return specs


def embed_tokens(cfg, p, tokens):
    """The tokens' rows in the compute dtype, times ``cfg.embedding_multiplier``."""
    dt = getattr(torch, cfg.compute_dtype)
    if is_dtensor(tokens):
        h = embed_per_shard(p["tok"], tokens).to(dt)
    else:
        h = p["tok"][tokens.long()].to(dt)
    return h * cfg.embedding_multiplier if cfg.embedding_multiplier != 1.0 else h


def unembed(cfg, p, h):
    """Project to padded-vocab fp32 logits, divided by ``cfg.logits_scaling``;
    the pad columns are set to -1e30 (not -inf) so softmax and sampling are
    exact over the real vocab."""
    if cfg.tie_embeddings:
        logits = h @ p["tok"].to(h.dtype).T
    else:
        logits = h @ p["head"].to(h.dtype)
    pad = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab_size
    logits = logits.float()
    if cfg.logits_scaling != 1.0:
        logits = logits / cfg.logits_scaling
    if is_dtensor(logits):          # DTensor has no in-place rule for a partial sum
        return logits.masked_fill(pad, NEG_INF)
    return logits.masked_fill_(pad, NEG_INF)     # in place: no second logits buffer


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponents)


def rope_tables(positions, d: int, theta: float, device=None):
    """RoPE's cos and sin at ``positions`` (B, S) int: (B, S, 1, D/2) fp32
    each."""
    freqs = rope_freqs(d, theta, device)                      # (D/2,)
    angles = positions[..., None].float() * freqs             # (B, S, D/2)
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def apply_rope(x, positions, theta: float, tables=None):
    """x: (B, S, H, D); positions: (B, S) int.  Half-split (not
    interleaved), computed in fp32.  ``tables``: :func:`rope_tables` at
    ``positions``, where the caller computed them once for several calls."""
    cos, sin = rope_tables(positions, x.shape[-1], theta, x.device) if tables is None else tables
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_at(positions, d: int):
    """Whisper-style sinusoidal embeddings evaluated at ``positions`` (any
    int tensor); returns fp32 of shape positions.shape + (d,)."""
    dim = torch.arange(d // 2, dtype=torch.float32, device=positions.device)
    step = torch.log(torch.tensor(10000.0, device=positions.device)) / max(d // 2 - 1, 1)
    inv = torch.exp(-dim * step)                    # fp32 throughout, as the reference
    ang = positions.float()[..., None] * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoidal_positions(n: int, d: int, device=None):
    return sinusoidal_at(torch.arange(n, device=device), d)


# ---------------------------------------------------------------------------
# Linear helpers
# ---------------------------------------------------------------------------

def linear_specs(d_in: int, d_out: int, axes, *, bias: bool, scale=None) -> dict:
    specs = {"w": ParamSpec((d_in, d_out), axes, "normal",
                            scale if scale is not None else d_in ** -0.5)}
    if bias:
        specs["b"] = ParamSpec((d_out,), (axes[1],), "zeros")
    return specs


def apply_linear(p, x):
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y
