"""Plain PyTorch versions of the ported kernels.

The same math as ``repro/kernels/ref.py``: the CPU tests hold the port
against the JAX package with them, the kernel wrappers use them for tensors
that lie on the CPU, and ``chip_smoke.py`` holds each CUDA kernel against
them on the card.  Ragged ``Sq``/``Sk`` need no padding here: the whole
score matrix is formed and masked.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention(q, k, v, *, causal: bool = True):
    """q: (B,H,Sq,D); k,v: (B,K,Sk,D); H % K == 0.  fp32 softmax."""
    B, H, Sq, D = q.shape
    K, Sk = k.shape[1], k.shape[2]
    G = H // K
    qr = q.reshape(B, K, G, Sq, D).float()
    scores = torch.einsum("bkgqd,bksd->bkgqs", qr, k.float()) * (D ** -0.5)
    if causal:
        iq = torch.arange(Sq, device=q.device)[:, None]
        ik = torch.arange(Sk, device=q.device)[None, :]
        # causal alignment: query i attends to keys <= i + (Sk - Sq)
        scores = scores.masked_fill(~(ik <= iq + (Sk - Sq)), NEG_INF)
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.reshape(B, H, Sq, D).to(q.dtype)


def decode_attention(q, k, v, kv_len):
    """q: (B,K,G,D); k,v: (B,K,S,D); kv_len: (B,) valid lengths.
    Returns (B,K,G,D)."""
    B, K, G, D = q.shape
    S = k.shape[2]
    scores = torch.einsum("bkgd,bksd->bkgs", q.float(), k.float()) * (D ** -0.5)
    valid = torch.arange(S, device=q.device)[None, :] < kv_len.to(q.device)[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgs,bksd->bkgd", p, v.float())
    return o.to(q.dtype)


def rmsnorm(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
