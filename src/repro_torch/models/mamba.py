"""Mamba2 block: gated SSD mixer with causal depthwise conv.

Layout follows the JAX package (Mamba2 reference): separate z/x/B/C/dt
projections, causal depthwise conv over (x, B, C), softplus-discretized dt,
SSD scan, D skip, gated RMSNorm, output projection.

The sequence path's scan goes through ``ops.ssd_scan`` (the CUDA kernel on
the card) where the reference calls ``ssd_chunked``, and the gated norm
through ``ops.rmsnorm``.  The three convs run as one over the concatenated
(x, B, C) channels, with the three weights concatenated: a depthwise conv
is per channel, so the arithmetic is the reference's, and x, B and C reach
the scan as strided views of the one output.  A decode step's mixer, from
the input projections to ``wo``, is one ``ops.mamba_step`` (the CUDA kernel
on the card), which writes the new conv window and state into the cache in
place.  On the dry-run's DTensors the conv, the scan and the step run per
shard (``distributed/dtensor.py``; the step through ``kernels/ref.py``
``mamba_mix_step``), with x's, B's and C's channels each placed as its own.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.dtensor import is_dtensor, ssm_per_shard
from repro_torch.kernels import ops
from repro_torch.kernels.ref import mamba_mix_step
from repro_torch.models.params import ParamSpec


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


def _gated_norm(y, z, scale, eps=1e-6):
    """Mamba2 gated RMSNorm: rmsnorm(y * silu(z)) * scale, in fp32 through
    the rmsnorm kernel, cast back to y.dtype."""
    yf = (y * F.silu(z.float())).float()
    return ops.rmsnorm(yf, scale, eps=eps).to(y.dtype)


def _project(p, x):
    """The z, x, B and C projections, in x's dtype."""
    return tuple(x @ p[k].to(x.dtype) for k in ("wz", "wx", "wB", "wC"))


def _dt(p, x):
    """The fp32 dt projection, softplus-discretised."""
    return F.softplus((x.float() @ p["wdt"].float()) + p["dt_bias"])


# ---------------------------------------------------------------------------
# The mixer: the causal conv, the SSD scan or step, the D skip
# ---------------------------------------------------------------------------

def _conv_window(pre, ck: int):
    """The last ck-1 rows of pre (B,S,C), zero-padded on the left when S is
    shorter: the conv cache a prefill leaves."""
    pad = ck - 1 - pre.shape[1]
    return F.pad(pre, (0, 0, pad, 0)) if pad > 0 else pre[:, -(ck - 1):, :]


def _mix(xr, Br, Cr, dt, A, D, wx, wB, wC, bx, bB, bC, *, hd: int, n: int, chunk: int):
    """The causal conv over (x, B, C) as one, the SSD scan and the D skip
    -> (y (B,S,di), final state (B,H,P,N) fp32, the pre-conv (B,S,conv_dim)).
    Head and group counts come from the widths, so a shard's heads work as
    the whole's."""
    di, gn = xr.shape[-1], Br.shape[-1]
    pre = torch.cat([xr, Br, Cr], dim=-1)                         # (B,S,conv_dim), pre-conv
    post = _causal_conv(pre, torch.cat([wx, wB, wC], dim=1), torch.cat([bx, bB, bC]))
    xh = post[..., :di].unflatten(-1, (-1, hd))                   # strided views, no copies
    Bh = post[..., di:di + gn].unflatten(-1, (-1, n))
    Ch = post[..., di + gn:].unflatten(-1, (-1, n))
    y, final_state = ops.ssd_scan(xh, dt, A, Bh, Ch, chunk=chunk)
    y = y + (D[None, None, :, None] * xh.float()).to(y.dtype)
    return y.flatten(2), final_state, pre


# ---------------------------------------------------------------------------
# Per shard (the dry-run's DTensors)
# ---------------------------------------------------------------------------
# Each argument's (batch dim, head dim): x's channels and the heads shard
# together; B's and C's channels (gd) follow the heads only when there are
# several groups (a lone group is replicated).

def _layouts(g: int):
    """(gd, the layouts of A, D and the six conv weights and biases)."""
    gd, gw, gb = (2, 1, 0) if g > 1 else (None, None, None)
    return gd, [(None, 0), (None, 0), (None, 1), (None, gw), (None, gw),
                (None, 0), (None, gb), (None, gb)]


def _mix_shard(cfg, p, x, xr, Br, Cr, dt, A):
    """``_mix``'s y and final state, on each device's shards."""
    ssm = cfg.ssm
    gd, params = _layouts(ssm.n_groups)
    return ssm_per_shard(
        lambda *a: _mix(*a, hd=ssm.head_dim, n=ssm.d_state, chunk=ssm.chunk)[:2],
        x, p["A_log"], ssm.n_groups,
        (xr, Br, Cr, dt, A, p["D"], p["conv_x"], p["conv_B"], p["conv_C"],
         p["conv_bx"], p["conv_bB"], p["conv_bC"]),
        [(0, 2), (0, gd), (0, gd), (0, 2), *params],
        [(0, 2), (0, 1)])


def _mix_step_shard(cfg, p, x, conv, xr, Br, Cr, dt, state, A):
    """``mamba_mix_step``'s y and new state, on each device's shards: the conv
    cache is split into x's, B's and C's channels first (replicated, then
    each placed as its channels)."""
    from torch.distributed.tensor import Replicate, Shard

    ssm = cfg.ssm
    gd, params = _layouts(ssm.n_groups)
    di, gn = xr.shape[-1], Br.shape[-1]
    conv = conv.redistribute(placements=[pl if pl == Shard(0) else Replicate()
                                         for pl in conv.placements])
    cx, cB, cC = conv[..., :di], conv[..., di:di + gn], conv[..., di + gn:]

    def fn(cx, cB, cC, *a):
        y, _, new_state = mamba_mix_step(torch.cat([cx, cB, cC], dim=-1), *a,
                                         hd=ssm.head_dim, n=ssm.d_state)
        return y, new_state

    return ssm_per_shard(
        fn, x, p["A_log"], ssm.n_groups,
        (cx, cB, cC, xr, Br, Cr, dt, state, A, p["D"], p["conv_x"], p["conv_B"],
         p["conv_C"], p["conv_bx"], p["conv_bB"], p["conv_bC"]),
        [(0, 2), (0, gd), (0, gd), (0, 2), (0, gd), (0, gd), (0, 2), (0, 1), *params],
        [(0, 2), (0, 1)])


# ---------------------------------------------------------------------------
# Sequence forward (train / prefill)
# ---------------------------------------------------------------------------

def mamba_forward(cfg, p, x, *, return_cache: bool = False):
    """x: (B,S,d) -> (out, cache|None).  Cache: {"conv": (B,ck-1,conv_dim)
    in x.dtype, "ssm": (B,H,P,N) fp32}."""
    ssm = cfg.ssm
    ck = ssm.conv_kernel
    z, xr, Br, Cr = _project(p, x)
    dt = _dt(p, x)
    A = -torch.exp(p["A_log"])
    if is_dtensor(x):
        # the window outside the shards: each rank's tail of B and C is whole
        # where its conv and scan see only some heads' share of them
        y, final_state = _mix_shard(cfg, p, x, xr, Br, Cr, dt, A)
        window = (torch.cat([_conv_window(t, ck) for t in (xr, Br, Cr)], dim=-1)
                  if return_cache else None)
    else:
        y, final_state, pre = _mix(xr, Br, Cr, dt, A, p["D"], p["conv_x"], p["conv_B"],
                                   p["conv_C"], p["conv_bx"], p["conv_bB"], p["conv_bC"],
                                   hd=ssm.head_dim, n=ssm.d_state, chunk=ssm.chunk)
        window = _conv_window(pre, ck) if return_cache else None
    y = _gated_norm(y, z, p["norm_scale"], cfg.norm_eps)
    out = y @ p["wo"].to(y.dtype)
    if not return_cache:
        return out, None
    return out, {"conv": window, "ssm": final_state}


# ---------------------------------------------------------------------------
# Single-token decode
# ---------------------------------------------------------------------------

def mamba_decode(cfg, p, x, cache):
    """x: (B,1,d); cache {"conv": (B,ck-1,conv_dim), "ssm": (B,H,P,N)}.
    Returns (out, new cache).  On plain tensors the step is one
    ``ops.mamba_step``, which writes the cache leaves in place, and the new
    cache is ``cache`` itself; on the dry-run's DTensors it returns new
    tensors, which the caller writes into its stacked cache."""
    z, xr, Br, Cr = _project(p, x)
    if not is_dtensor(x):
        y = ops.mamba_step(x, z, xr, Br, Cr, p, cache["conv"], cache["ssm"], eps=cfg.norm_eps)
        return y @ p["wo"].to(y.dtype), cache
    dt = _dt(p, x)
    A = -torch.exp(p["A_log"])
    y, new_state = _mix_step_shard(cfg, p, x, cache["conv"], xr, Br, Cr, dt, cache["ssm"], A)
    pre = torch.cat([xr, Br, Cr], dim=-1)               # the window outside, as the prefill's
    new_conv = torch.cat([cache["conv"].to(pre.dtype), pre], dim=1)[:, 1:, :]
    y = _gated_norm(y, z, p["norm_scale"], cfg.norm_eps)
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
