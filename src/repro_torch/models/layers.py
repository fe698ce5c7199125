"""Shared primitive layers: norms, embeddings, rotary embeddings, linear."""
from __future__ import annotations

import torch

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


def apply_norm(cfg, p, x, eps: float = 1e-6):
    """rmsnorm goes through the kernel (fp32 reduce, cast back to x.dtype);
    layernorm stays plain."""
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
    return p["tok"][tokens.long()].to(getattr(torch, cfg.compute_dtype))


def unembed(cfg, p, h):
    """Project to padded-vocab fp32 logits; the pad columns are set to -1e30
    (not -inf) so softmax and sampling are exact over the real vocab."""
    if cfg.tie_embeddings:
        logits = h @ p["tok"].to(h.dtype).T
    else:
        logits = h @ p["head"].to(h.dtype)
    logits = logits.float()
    logits[..., cfg.vocab_size:] = NEG_INF
    return logits


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, D); positions: (B, S) int.  Half-split (not
    interleaved), computed in fp32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                    # (D/2,)
    angles = positions[..., None].float() * freqs             # (B, S, D/2)
    cos = torch.cos(angles)[..., None, :]                     # (B, S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Linear helpers
# ---------------------------------------------------------------------------

def apply_linear(p, x):
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y
