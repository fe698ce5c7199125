"""Plain PyTorch versions of the ported kernels.

The same math as ``repro/kernels/ref.py``: the CPU tests hold the port
against the JAX package with them, the kernel wrappers use them for tensors
that lie on the CPU, and ``chip_smoke.py`` holds each CUDA kernel against
them on the card.  Ragged ``Sq``/``Sk`` need no padding here: the whole
score matrix is formed and masked.  ``ssd_scan`` is the chunked algorithm
the model runs (``models/ssd.py`` binds it as ``ssd_chunked``), not the
per-step oracle of the JAX package's ``ref.ssd_scan``: the same function,
without a Python loop over every position on the card.  ``quantize_int8``
and ``dequantize_int8`` are the per-row int8 codec of ``comm_quant``.
``moe_experts``, the grouped SwiGLU of a dropless MoE
(``kernels/moe_experts.py``), has no counterpart in the JAX package, nor have
``moe_route`` and ``moe_combine``, the routing and combine around it
(``kernels/moe_route.py``: the chain ``models/moe.py`` ran before the kernels,
in the same order and roundings, which it still runs for a prefill), nor has
``mamba_step``, a Mamba-2 layer's decode step between its input projections
and ``wo`` (``kernels/mamba_step.py``): it is the composition the model ran
before the kernel, in the same order and roundings (``mamba_mix_step``, which
the dry-run's per-shard decode also runs, then the gated norm).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def flash_attention(q, k, v, *, causal: bool = True, scale: float | None = None):
    """q: (B,H,Sq,D); k,v: (B,K,Sk,D); H % K == 0.  fp32 softmax of the
    scores times ``scale`` (1/sqrt(D) when None)."""
    B, H, Sq, D = q.shape
    K, Sk = k.shape[1], k.shape[2]
    G = H // K
    qr = q.reshape(B, K, G, Sq, D).float()
    scores = torch.einsum("bkgqd,bksd->bkgqs", qr, k.float()) * (
        D ** -0.5 if scale is None else scale)
    if causal:
        iq = torch.arange(Sq, device=q.device)[:, None]
        ik = torch.arange(Sk, device=q.device)[None, :]
        # causal alignment: query i attends to keys <= i + (Sk - Sq)
        scores = scores.masked_fill(~(ik <= iq + (Sk - Sq)), NEG_INF)
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.reshape(B, H, Sq, D).to(q.dtype)


def decode_attention(q, k, v, kv_len, *, scale: float | None = None):
    """q: (B,K,G,D); k,v: (B,K,S,D); kv_len: (B,) valid lengths; the scores
    times ``scale`` (1/sqrt(D) when None).  Returns (B,K,G,D)."""
    B, K, G, D = q.shape
    S = k.shape[2]
    scores = torch.einsum("bkgd,bksd->bkgs", q.float(), k.float()) * (
        D ** -0.5 if scale is None else scale)
    valid = torch.arange(S, device=q.device)[None, :] < kv_len.to(q.device)[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgs,bksd->bkgd", p, v.float())
    return o.to(q.dtype)


def moe_experts(x, w_gate, w_up, w_down, offs):
    """x: (R, d) rows grouped by expert, expert e's the rows from
    ``offs[e-1]`` (0 for the first) to ``offs[e]``; w_gate, w_up: (E, d, f);
    w_down: (E, f, d).  Each group's SwiGLU ``(silu(x Wg) * (x Wu)) Wd`` in
    x's dtype -> (R, d); rows past ``offs[E-1]`` are zero."""
    out = x.new_zeros(x.shape)
    start = 0
    for e, end in enumerate(offs.tolist()):
        if end > start:
            xe = x[start:end]
            h = F.silu(xe @ w_gate[e].to(x.dtype)) * (xe @ w_up[e].to(x.dtype))
            out[start:end] = h @ w_down[e].to(x.dtype)
        start = end
    return out


def moe_route(x, router, k: int):
    """A dropless MoE's routing of x (T, d) by the router (d, E): the fp32
    softmax of x @ router, then :func:`moe_dispatch`."""
    probs = torch.softmax(x[None].float() @ router.float(), dim=-1)
    return moe_dispatch(x, probs[0], k)


def moe_dispatch(x, probs, k: int):
    """x (T, d) and its router probabilities (T, E) fp32 -> (rows (T*k, d):
    x's rows in stable expert order, ends (E,) int32: each expert's end row,
    w (T*k,): the top-k probabilities over their sum, in x's dtype, in the
    same order, order (T*k,) int32: the sort, row i being assignment
    ``order[i] = t*k + j``)."""
    T, E = probs.shape
    top_p, top_e = torch.topk(probs, k, dim=-1)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    flat_e = top_e.reshape(T * k)
    order = torch.argsort(flat_e, stable=True)
    # each expert's end row, on the device (a search, not a count read back)
    ends = torch.searchsorted(flat_e[order], torch.arange(E, device=x.device), right=True)
    rows = x.index_select(0, order // k)
    w = top_p.reshape(T * k)[order].to(x.dtype)
    return rows, ends.to(torch.int32), w, order.to(torch.int32)


def moe_combine(out, w, order, k: int, shared=None):
    """The experts' output rows out (T*k, d), each weighted by its w and put
    back with its token through ``order`` (:func:`moe_dispatch`), summed over
    k in out's dtype, plus ``shared`` (T, d) where given -> (T, d)."""
    contrib = out * w[:, None]
    y = contrib.new_empty(contrib.shape).index_copy_(0, order.long(), contrib)
    y = y.reshape(-1, k, out.shape[-1]).sum(dim=1)
    return y if shared is None else y + shared


def rmsnorm(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def quantize_int8(x):
    """x: (N, D) -> (q int8 (N, D), scale f32 (N, 1)).  Per-row symmetric:
    ``scale = max(absmax, 1e-12) / 127``, ``q = clip(round(x / scale),
    +-127)`` with IEEE division and round half to even (``torch.round``)."""
    xf = x.float()
    absmax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    # divide by a tensor, not a Python scalar: on CUDA, PyTorch turns a
    # division by a CPU scalar into a multiplication by its reciprocal,
    # which is not the IEEE quotient and moves the scale by an ulp
    scale = torch.clamp(absmax, min=1e-12) / torch.full_like(absmax, 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale, dtype=torch.float32):
    return (q.float() * scale).to(dtype)


def repeat_groups(t, rep: int, dim: int):
    """Broadcast G groups of B/C over H = G * rep heads along ``dim``."""
    return torch.repeat_interleave(t, rep, dim=dim) if rep > 1 else t


def ssd_scan(x, dt, A, B, C, chunk: int, state0=None):
    """Chunked SSD (Mamba2 Listing 1).  x: (B,S,H,P); dt: (B,S,H)
    post-softplus; A: (H,) negative; B, C: (B,S,G,N).  Chunks of ``chunk``
    positions, S zero-padded.  Returns (y (B,S,H,P) in x.dtype, final_state
    (B,H,P,N) fp32)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    pad = (-s) % chunk
    xf = F.pad(x.float(), (0, 0, 0, 0, 0, pad))
    dtf = F.pad(dt.float(), (0, 0, 0, pad))
    Bf = F.pad(B.float(), (0, 0, 0, 0, 0, pad))
    Cf = F.pad(C.float(), (0, 0, 0, 0, 0, pad))
    Af = A.float()
    nc, L = (s + pad) // chunk, chunk

    xc = xf.reshape(b, nc, L, h, p)
    dtc = dtf.reshape(b, nc, L, h)
    Bc = Bf.reshape(b, nc, L, g, n)
    Cc = Cf.reshape(b, nc, L, g, n)

    a = torch.cumsum(dtc * Af, dim=2).transpose(2, 3)               # (b,nc,h,L) inclusive

    # ---- intra-chunk (quadratic, attention-like) -------------------------
    CB = repeat_groups(torch.einsum("bclgn,bcmgn->bcglm", Cc, Bc), rep, 2)   # (b,nc,h,L,L)
    diff = a[..., :, None] - a[..., None, :]
    # exp(diff) overflows above the diagonal: mask before the exp, never
    # multiply a mask into it (inf * 0 is NaN)
    mask = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(diff.masked_fill(~mask, float("-inf")))
    scores = CB * decay * dtc.transpose(2, 3)[..., None, :]
    y_intra = torch.einsum("bchlm,bcmhp->bclhp", scores, xc)

    # ---- per-chunk final states ------------------------------------------
    w = torch.exp(a[..., -1:] - a).transpose(2, 3) * dtc            # (b,nc,L,h)
    states = torch.einsum("bclhn,bclh,bclhp->bchpn", repeat_groups(Bc, rep, 3), w, xc)

    # ---- inter-chunk linear recurrence ------------------------------------
    chunk_decay = torch.exp(a[..., -1])                              # (b,nc,h)
    st = (torch.zeros(b, h, p, n, dtype=torch.float32, device=x.device)
          if state0 is None else state0.float())
    prev = []
    for c in range(nc):
        prev.append(st)                                              # state ENTERING chunk c
        st = st * chunk_decay[:, c, :, None, None] + states[:, c]
    prev = torch.stack(prev, dim=1)                                  # (b,nc,h,p,n)

    # ---- inter-chunk output contribution ----------------------------------
    y_inter = torch.einsum("bclhn,bchpn,bclh->bclhp", repeat_groups(Cc, rep, 3), prev,
                           torch.exp(a).transpose(2, 3))
    y = (y_intra + y_inter).reshape(b, nc * L, h, p)[:, :s]
    return y.to(x.dtype), st


def ssd_step(state, x_t, dt_t, A, B_t, C_t):
    """Single SSD decode step.  state: (B,H,P,N); x_t: (B,H,P); dt_t: (B,H);
    B_t/C_t: (B,G,N).  Returns (y_t (B,H,P), new_state fp32)."""
    rep = x_t.shape[1] // B_t.shape[1]
    dtf = dt_t.float()
    da = torch.exp(dtf * A.float())
    Bh, Ch = repeat_groups(B_t.float(), rep, 1), repeat_groups(C_t.float(), rep, 1)
    sf = state.float() * da[..., None, None] + torch.einsum(
        "bh,bhn,bhp->bhpn", dtf, Bh, x_t.float())
    y = torch.einsum("bhn,bhpn->bhp", Ch, sf)
    return y.to(x_t.dtype), sf


def _conv_step(window, w, b):
    """window: (B,ck,C) last ck inputs (current included); returns (B,C)."""
    out = torch.einsum("bkc,kc->bc", window.float(), w.float())
    return F.silu(out + b.float()).to(window.dtype)


def mamba_mix_step(conv, xr, Br, Cr, dt, state, A, D, wx, wB, wC, bx, bB, bC, *, hd: int,
                   n: int):
    """One decode step of the conv and the SSD recurrence, and the D skip;
    conv (B,ck-1,conv_dim) is the window before this token, dt (B,1,H)
    post-softplus -> (y (B,1,di), new window, new state fp32)."""
    B_, _, di = xr.shape
    gn = Br.shape[-1]
    pre = torch.cat([xr, Br, Cr], dim=-1)                         # (B,1,conv_dim)
    window = torch.cat([conv.to(pre.dtype), pre], dim=1)
    post = _conv_step(window, torch.cat([wx, wB, wC], dim=1), torch.cat([bx, bB, bC]))
    x_t = post[:, :di].reshape(B_, -1, hd)
    y_t, new_state = ssd_step(state, x_t, dt[:, 0], A,
                              post[:, di:di + gn].reshape(B_, -1, n),
                              post[:, di + gn:].reshape(B_, -1, n))
    y_t = y_t + (D[None, :, None] * x_t.float()).to(y_t.dtype)
    return y_t.reshape(B_, 1, di), window[:, 1:, :], new_state


def mamba_step(u, z, x, Bm, Cm, p: dict, conv, ssm, *, eps: float):
    """A Mamba-2 layer's decode step between its input projections and
    ``wo``: u (B,1,d) the layer's normed input (the fp32 ``dt``
    projection's), z and x (B,1,di), Bm and Cm (B,1,G*N); ``p`` the layer's
    parameters; conv (B,ck-1,conv_dim) and ssm (B,H,P,N) fp32, the cache
    leaves, written in place with the new window and state -> the gated,
    normed y (B,1,di) in z's dtype."""
    dt = F.softplus((u.float() @ p["wdt"].float()) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    # a state that autograd records is read through a copy, so the write in
    # place below leaves the tensor it saved as it was
    state = ssm.clone() if ssm.requires_grad else ssm
    y, new_conv, new_state = mamba_mix_step(
        conv, x, Bm, Cm, dt, state, A, p["D"], p["conv_x"], p["conv_B"], p["conv_C"],
        p["conv_bx"], p["conv_bB"], p["conv_bC"], hd=ssm.shape[2], n=ssm.shape[3])
    yf = (y * F.silu(z.float())).float()
    out = rmsnorm(yf, p["norm_scale"], eps=eps).to(y.dtype)
    conv.copy_(new_conv)
    ssm.copy_(new_state)
    return out
