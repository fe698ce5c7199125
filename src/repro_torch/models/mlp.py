"""Feed-forward blocks: SwiGLU (llama-family) and GELU (whisper)."""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.models.params import ParamSpec


def mlp_specs(cfg, d_ff: int | None = None) -> dict:
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    if cfg.act == "swiglu":
        specs = {
            "w_gate": ParamSpec((d, f), ("embed", "mlp"), "normal", d ** -0.5),
            "w_up": ParamSpec((d, f), ("embed", "mlp"), "normal", d ** -0.5),
            "w_down": ParamSpec((f, d), ("mlp", "embed"), "normal", f ** -0.5),
        }
    else:
        specs = {
            "w_up": ParamSpec((d, f), ("embed", "mlp"), "normal", d ** -0.5),
            "w_down": ParamSpec((f, d), ("mlp", "embed"), "normal", f ** -0.5),
        }
    if cfg.use_bias:
        specs["b_up"] = ParamSpec((f,), ("mlp",), "zeros")
        specs["b_down"] = ParamSpec((d,), ("embed",), "zeros")
    return specs


def apply_mlp(cfg, p, x):
    dt = x.dtype
    u = x @ p["w_up"].to(dt)
    if "b_up" in p:
        u = u + p["b_up"].to(dt)
    if cfg.act == "swiglu":
        h = F.silu(x @ p["w_gate"].to(dt)) * u
    else:
        h = F.gelu(u, approximate="tanh")      # jax.nn.gelu's default
    y = h @ p["w_down"].to(dt)
    if "b_down" in p:
        y = y + p["b_down"].to(dt)
    return y
