"""Mamba2 state-space duality (SSD) scan algorithms, in fp32 math.

``ssd_chunked``    — the chunked algorithm (Mamba2 Listing 1): quadratic
                     attention-like intra-chunk term + linear inter-chunk
                     recurrence.  It is ``kernels/ref.py`` ``ssd_scan``, the
                     SSD kernel's plain version; the CUDA kernel
                     ``kernels/csrc/ssd_scan.cu`` computes the same schedule.
``ssd_sequential`` — per-timestep linear recurrence (the semantic oracle, and
                     the shape of the single-token decode update).
``ssd_step``       — one decode step (``kernels/ref.py``, where the plain
                     version of the decode-step kernel runs it).

Conventions: x (B,S,H,P), dt (B,S,H) [post-softplus], A (H,) [negative],
B/C (B,S,G,N) with G groups broadcast over H heads.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import repeat_groups, ssd_step
from repro_torch.kernels.ref import ssd_scan as ssd_chunked

__all__ = ["ssd_chunked", "ssd_sequential", "ssd_step"]


def ssd_sequential(x, dt, A, B, C, state0=None):
    """Oracle: step-by-step recurrence.  Returns (y (B,S,H,P), final_state
    (B,H,P,N))."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bh, Ch = repeat_groups(B.float(), rep, 2), repeat_groups(C.float(), rep, 2)  # (b,s,h,n)
    state = (torch.zeros(b, h, p, n, dtype=torch.float32, device=x.device)
             if state0 is None else state0.float())
    ys = []
    for t in range(s):
        da = torch.exp(dtf[:, t] * Af)                               # (b,h)
        state = state * da[..., None, None] + torch.einsum(
            "bh,bhn,bhp->bhpn", dtf[:, t], Bh[:, t], xf[:, t])
        ys.append(torch.einsum("bhn,bhpn->bhp", Ch[:, t], state))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros(b, 0, h, p)
    return y.to(x.dtype), state
