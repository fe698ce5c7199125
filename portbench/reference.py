"""Plain float32 building blocks of the models' references.

Written from the published equations, one sequence at a time, with no
kernel, no cache and no batching.  Nothing here imports the program: the
references under ``configs/`` are built from these pieces and are given
the benchmark's own weights (``weights.py``) and the token streams the host
sent.  On the card, float32 products run in TF32 unless it is switched off,
so :func:`exact_fp32` is called before a reference runs.

:class:`Linear` carries the one choice that separates the reference from
its control: ``fp8=True`` rounds both operands of every projection to
float8 e4m3 (activations per row, weights per output column, each scaled to
the format's largest finite value 448), the step below bfloat16 that a
later change could be tempted to take.  Attention, the scan and the norms
stay in float32 in both.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def exact_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to e4m3 with one scale per slice along ``dim``."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Linear:
    """``x @ w`` in float32, or with both operands rounded to fp8."""

    def __init__(self, fp8: bool = False) -> None:
        self.fp8 = fp8
        self._w: dict = {}

    def weight(self, key, w: torch.Tensor) -> torch.Tensor:
        """w as the product reads it: float32, rounded per output column
        (dim 0 of a (d_in, d_out) matrix) under fp8; rounded once a run."""
        if not self.fp8:
            return w.float()
        if key not in self._w:
            self._w[key] = _fp8_round(w.float(), 0)
        return self._w[key]

    def __call__(self, x: torch.Tensor, key, w: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            x = _fp8_round(x, -1)
        return x @ self.weight(key, w)


def rmsnorm(x, scale, eps: float):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * scale.float()


def rope(x, theta: float):
    """x: (S, heads, D) at positions 0..S-1, rotated by halves (the first
    half of the head dim against the second)."""
    S, _, D = x.shape
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32, device=x.device) / D)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q, k, v, scale: float, block: int = 1024):
    """q: (S, H, D); k, v: (S, K, D), query head h reading KV head
    h // (H // K).  Softmax in float32 over keys 0..i, queries in blocks."""
    S, H, D = q.shape
    G = H // k.shape[1]
    kh = k.repeat_interleave(G, dim=1).transpose(0, 1)          # (H, S, D)
    vh = v.repeat_interleave(G, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    for i0 in range(0, S, block):
        i1 = min(S, i0 + block)
        qb = q[i0:i1].transpose(0, 1)                            # (H, b, D)
        s = (qb @ kh[:, :i1].transpose(1, 2)) * scale            # (H, b, i1)
        iq = torch.arange(i0, i1, device=q.device)[:, None]
        ik = torch.arange(i1, device=q.device)[None, :]
        s = s.masked_fill(ik > iq, float("-inf"))
        out[i0:i1] = (torch.softmax(s, dim=-1) @ vh[:, :i1]).transpose(0, 1)
    return out


def causal_conv(x, w, b):
    """Depthwise causal conv then SiLU.  x: (S, C); w: (ck, C), where
    w[ck-1] multiplies the current position; b: (C,)."""
    ck = w.shape[0]
    xp = F.pad(x, (0, 0, ck - 1, 0))
    out = sum(w[j].float() * xp[j:j + x.shape[0]] for j in range(ck))
    return F.silu(out + b.float())


def ssd(x, dt, A, B, C, chunk: int = 256):
    """The SSD recurrence of Mamba-2 for one sequence:
    ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T``, ``y_t = h_t^T C_t``.
    x: (S, H, P); dt: (S, H) after softplus; A: (H,) negative; B, C:
    (S, G, N), group g serving heads g*H/G .. (g+1)*H/G-1.  Computed exactly
    by chunks: within a chunk the quadratic form, between chunks the
    state carried.  Returns y (S, H, P)."""
    S, H, P = x.shape
    G, N = B.shape[1], B.shape[2]
    Bh = B.repeat_interleave(H // G, dim=1)                      # (S, H, N)
    Ch = C.repeat_interleave(H // G, dim=1)
    state = x.new_zeros(H, P, N)
    y = torch.empty_like(x)
    for t0 in range(0, S, chunk):
        t1 = min(S, t0 + chunk)
        a = torch.cumsum(dt[t0:t1] * A, dim=0)                   # (l, H) inclusive
        seg = a[:, None, :] - a[None, :, :]                      # (l, l, H): i, j
        l = t1 - t0
        tri = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
        decay = torch.exp(seg.masked_fill(~tri[..., None], float("-inf")))
        cb = torch.einsum("ihn,jhn->ijh", Ch[t0:t1], Bh[t0:t1])
        w = cb * decay * dt[t0:t1][None, :, :]                   # (i, j, H)
        yc = torch.einsum("ijh,jhp->ihp", w, x[t0:t1])
        yc += torch.einsum("ihn,hpn->ihp", Ch[t0:t1] * torch.exp(a)[..., None], state)
        y[t0:t1] = yc
        tail = torch.exp(a[-1][None, :] - a) * dt[t0:t1]         # (l, H)
        state = (state * torch.exp(a[-1])[:, None, None]
                 + torch.einsum("jh,jhn,jhp->hpn", tail, Bh[t0:t1], x[t0:t1]))
    return y
