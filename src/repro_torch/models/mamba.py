"""Mamba2 block: gated SSD mixer with causal depthwise conv.

Layout follows the JAX package (Mamba2 reference): separate z/x/B/C/dt
projections, causal depthwise conv over (x, B, C), softplus-discretized dt,
SSD scan, D skip, gated RMSNorm, output projection.

The sequence path's scan goes through ``ops.ssd_scan`` (the CUDA kernel on
the card) where the reference calls ``ssd_chunked``, and the gated norm
through ``ops.rmsnorm``.  The three convs run as one over the concatenated
(x, B, C) channels, with the three weights concatenated: a depthwise conv
is per channel, so the arithmetic is the reference's, and x, B and C reach
the scan as strided views of the one output.  Decode is plain PyTorch (one
``ssd_step``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.params import ParamSpec
from repro_torch.models.ssd import ssd_step


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def mamba_specs(cfg) -> dict:
    d, ssm = cfg.d_model, cfg.ssm
    di = ssm.d_inner(d)
    nh = ssm.n_heads(d)
    gn = ssm.n_groups * ssm.d_state
    ck = ssm.conv_kernel
    return {
        "wz": ParamSpec((d, di), ("embed", "mlp"), "normal", d ** -0.5),
        "wx": ParamSpec((d, di), ("embed", "mlp"), "normal", d ** -0.5),
        "wB": ParamSpec((d, gn), ("embed", None), "normal", d ** -0.5),
        "wC": ParamSpec((d, gn), ("embed", None), "normal", d ** -0.5),
        "wdt": ParamSpec((d, nh), ("embed", "ssm_heads"), "normal", d ** -0.5),
        "dt_bias": ParamSpec((nh,), ("ssm_heads",), "mamba_dt_bias", dtype=torch.float32),
        "A_log": ParamSpec((nh,), ("ssm_heads",), "mamba_a_log", dtype=torch.float32),
        "D": ParamSpec((nh,), ("ssm_heads",), "ones", dtype=torch.float32),
        "conv_x": ParamSpec((ck, di), (None, "mlp"), "normal", ck ** -0.5),
        "conv_B": ParamSpec((ck, gn), (None, None), "normal", ck ** -0.5),
        "conv_C": ParamSpec((ck, gn), (None, None), "normal", ck ** -0.5),
        "conv_bx": ParamSpec((di,), ("mlp",), "zeros"),
        "conv_bB": ParamSpec((gn,), (None,), "zeros"),
        "conv_bC": ParamSpec((gn,), (None,), "zeros"),
        "norm_scale": ParamSpec((di,), ("mlp",), "ones", dtype=torch.float32),
        "wo": ParamSpec((di, d), ("mlp", "embed"), "normal", di ** -0.5),
    }


def _conv_params(p):
    """The x, B and C conv weights (ck, conv_dim) and biases (conv_dim,),
    concatenated in the cache's channel order."""
    return (torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]], dim=1),
            torch.cat([p["conv_bx"], p["conv_bB"], p["conv_bC"]]))


# ---------------------------------------------------------------------------
# Causal depthwise conv (sequence path)
# ---------------------------------------------------------------------------

def _causal_conv(x, w, b):
    """x: (B,S,C); w: (ck,C) depthwise; left-padded causal conv + silu.
    Returns a contiguous (B,S,C) tensor in x.dtype.  (A float32 conv on the
    card runs in TF32 unless ``torch.backends.cudnn.allow_tf32`` is False.)"""
    ck, C = w.shape
    xp = F.pad(x.transpose(1, 2), (ck - 1, 0))                       # (B,C,S+ck-1)
    out = F.conv1d(xp, w.t().unsqueeze(1).to(x.dtype), groups=C)     # (B,C,S)
    return F.silu(out + b.to(x.dtype)[:, None]).transpose(1, 2).contiguous()


def _conv_step(window, w, b):
    """window: (B,ck,C) last ck inputs (current included); returns (B,C)."""
    out = torch.einsum("bkc,kc->bc", window.float(), w.float())
    return F.silu(out + b.float()).to(window.dtype)


def _gated_norm(y, z, scale, eps=1e-6):
    """Mamba2 gated RMSNorm: rmsnorm(y * silu(z)) * scale, in fp32 through
    the rmsnorm kernel, cast back to y.dtype."""
    yf = (y * F.silu(z.float())).float()
    return ops.rmsnorm(yf, scale, eps=eps).to(y.dtype)


def _project(cfg, p, x):
    dt_ = x.dtype
    z = x @ p["wz"].to(dt_)
    xr = x @ p["wx"].to(dt_)
    Br = x @ p["wB"].to(dt_)
    Cr = x @ p["wC"].to(dt_)
    dt = F.softplus((x.float() @ p["wdt"].float()) + p["dt_bias"])
    return z, xr, Br, Cr, dt


# ---------------------------------------------------------------------------
# Sequence forward (train / prefill)
# ---------------------------------------------------------------------------

def mamba_forward(cfg, p, x, *, return_cache: bool = False):
    """x: (B,S,d) -> (out, cache|None).  Cache: {"conv": (B,ck-1,conv_dim)
    in x.dtype, "ssm": (B,H,P,N) fp32}."""
    ssm = cfg.ssm
    B_, S, d = x.shape
    di = ssm.d_inner(d)
    nh = ssm.n_heads(d)
    hd = ssm.head_dim
    g, n = ssm.n_groups, ssm.d_state
    gn = g * n

    z, xr, Br, Cr, dt = _project(cfg, p, x)
    pre = torch.cat([xr, Br, Cr], dim=-1)                         # (B,S,conv_dim), pre-conv
    post = _causal_conv(pre, *_conv_params(p))

    A = -torch.exp(p["A_log"])
    xh = post[..., :di].unflatten(-1, (nh, hd))                   # strided views, no copies
    Bh = post[..., di:di + gn].unflatten(-1, (g, n))
    Ch = post[..., di + gn:].unflatten(-1, (g, n))
    y, final_state = ops.ssd_scan(xh, dt, A, Bh, Ch, chunk=ssm.chunk)
    y = y + (p["D"][None, None, :, None] * xh.float()).to(y.dtype)
    y = y.reshape(B_, S, di)
    y = _gated_norm(y, z, p["norm_scale"])
    out = y @ p["wo"].to(y.dtype)

    if not return_cache:
        return out, None
    ck = ssm.conv_kernel
    pad = max(ck - 1 - S, 0)
    window = F.pad(pre, (0, 0, pad, 0))[:, -(ck - 1):, :]
    return out, {"conv": window, "ssm": final_state}


# ---------------------------------------------------------------------------
# Single-token decode
# ---------------------------------------------------------------------------

def mamba_decode(cfg, p, x, cache):
    """x: (B,1,d); cache {"conv": (B,ck-1,conv_dim), "ssm": (B,H,P,N)}.
    Returns (out, new cache) as new tensors; the caller writes them into
    its stacked cache."""
    ssm = cfg.ssm
    B_, _, d = x.shape
    nh = ssm.n_heads(d)
    hd = ssm.head_dim
    g, n = ssm.n_groups, ssm.d_state
    di = ssm.d_inner(d)
    gn = g * n

    z, xr, Br, Cr, dt = _project(cfg, p, x)
    pre = torch.cat([xr, Br, Cr], dim=-1)                         # (B,1,conv_dim)
    window = torch.cat([cache["conv"].to(pre.dtype), pre], dim=1)
    new_conv = window[:, 1:, :]
    post = _conv_step(window, *_conv_params(p))                   # (B,conv_dim)

    A = -torch.exp(p["A_log"])
    x_t = post[:, :di].reshape(B_, nh, hd)
    y_t, new_state = ssd_step(cache["ssm"], x_t, dt[:, 0], A,
                              post[:, di:di + gn].reshape(B_, g, n),
                              post[:, di + gn:].reshape(B_, g, n))
    y_t = y_t + (p["D"][None, :, None] * x_t.float()).to(y_t.dtype)
    y = _gated_norm(y_t.reshape(B_, 1, di), z, p["norm_scale"])
    out = y @ p["wo"].to(y.dtype)
    return out, {"conv": new_conv, "ssm": new_state}


def init_mamba_cache(cfg, batch: int, dtype=torch.bfloat16, device="cuda") -> dict:
    ssm = cfg.ssm
    d = cfg.d_model
    conv_dim = ssm.d_inner(d) + 2 * ssm.n_groups * ssm.d_state
    return {
        "conv": torch.zeros((batch, ssm.conv_kernel - 1, conv_dim), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, ssm.n_heads(d), ssm.head_dim, ssm.d_state),
                           dtype=torch.float32, device=device),
    }
