"""A Mamba-2 layer's decode step: one CUDA C++ kernel for Hopper
(``csrc/mamba_step.cu``).

Replaces no TPU kernel: the JAX package's decode step is plain array code
(``repro/models/mamba.py`` ``mamba_decode``), and the port's was too -- some
40 small kernels a layer between the input projections and ``wo`` (the conv
weights concatenated and cast every step, the state moved about nine times).
The kernel does all of it in one launch: the fp32 ``dt`` projection, the
causal conv with its window shifted in place in the cache, the SSD state
update in place, the D skip and the gated RMSNorm, everything between the
inputs and the output in fp32.  On the H100 it is bound by bytes and, at a
B-1 decode, by its launch: the fp32 state is read and written once (4.2 MB a
layer at granite-4.0-h-small's widths).  One block per (head, slice of P,
batch row); :func:`mamba_step_plan` cuts P into slices from the shapes and
the SM count, so that a model with few heads (mamba2-130m's 24) still spreads
over the card.  The norm spans all heads: the row's last block (an integer
counter, reset by that block) sums the blocks' partial sums in a fixed order
and writes the row, so two calls give bit-identical output.  The scratch and
the counters are the device's pool (``_build.scratch``).

``mamba_step_cuda`` launches the kernel (or raises); :func:`mamba_step_plain`
(from ``kernels/ref.py``) is the plain version that ``ops.mamba_step`` takes
for tensors on the CPU.  A call is one kernel launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import mamba_step as mamba_step_plain

__all__ = ["mamba_step_cuda", "mamba_step_plain", "mamba_step_plan", "check_args"]

HEAD_DIMS = (16, 64, 128)
MAX_N = 128
MAX_CK = 4
MIN_SLICE = 16           # rows of P a block takes at least
MAX_VECTORS = 8 * 256    # 16-byte state vectors a block holds (csrc KMAX * NT)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 22 + [_I] * 11 + [_L] * 8 + [ctypes.c_float, _P]
_PARAMS = ("wdt", "dt_bias", "A_log", "D", "conv_x", "conv_B", "conv_C", "conv_bx", "conv_bB",
           "conv_bC", "norm_scale")


def mamba_step_plan(B: int, H: int, P: int, N: int, n_sm: int) -> int:
    """The slices each head's P rows are cut into: the fewest whose blocks
    hold their rows' state (at most ``MAX_VECTORS`` vectors of 4), doubled
    while the B*H*slices blocks fill less than half the card's ``n_sm`` SMs
    and a slice keeps ``MIN_SLICE`` rows.  Every slice reads its head's
    column of wdt again, one 32-byte sector a row, so slices cost where d
    and H are large: on an H100 at B 1, granite-4.0-h-small (H 128, d 4096)
    runs 13.7, 21.1, 35.2 us at 1, 2, 4 slices, mamba2-130m (H 24, d 768)
    10.9, 8.9, 7.9, 12.4 us at 1, 2, 4, 8; the rule picks 1 and 4."""
    s = 1
    while (P // s) * N // 4 > MAX_VECTORS and P % (2 * s) == 0:
        s *= 2
    while B * H * s < n_sm / 2 and P % (2 * s) == 0 and P // (2 * s) >= MIN_SLICE:
        s *= 2
    return s


def mamba_step_cuda(u, z, x, Bm, Cm, p: dict, conv, ssm, *, eps: float):
    """u (B,1,d), z and x (B,1,di), Bm and Cm (B,1,G*N), on the card in one
    dtype (f32 or bf16); ``p`` the layer's parameters (``models.mamba.
    mamba_specs``: wdt and the conv weights and biases in one dtype, the
    rest fp32); conv (B,ck-1,di+2GN) f32 or bf16 and ssm (B,H,P,N) fp32,
    updated in place -> (B,1,di) in z's dtype."""
    w = [p[k] for k in _PARAMS]
    _build.require_cuda("mamba_step", u, z, x, Bm, Cm, conv, ssm, *w)
    B, H, P, N, G, ck, dm = check_args(u, z, x, Bm, Cm, p, conv, ssm)
    out = torch.empty((B, 1, H * P), dtype=z.dtype, device=z.device)
    if B == 0:
        return out
    u, z, x, Bm, Cm = (_build.unit_last(t) for t in (u, z, x, Bm, Cm))
    w = [t.contiguous() for t in w]
    S = mamba_step_plan(B, H, P, N, _build.sm_count(u.device))
    counter, scratch = _build.scratch(u.device, B, B * H * (P + S))
    _build.launch("avec_mamba_step", _ARGTYPES, (
        u.data_ptr(), z.data_ptr(), x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        *(t.data_ptr() for t in w), conv.data_ptr(), ssm.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), scratch.data_ptr() + 4 * B * H * P, counter.data_ptr(),
        _build.dtype_code(z), _build.dtype_code(w[0]), _build.dtype_code(conv), B, H, P, N, G,
        ck, dm, S, u.stride(0), z.stride(0), x.stride(0), Bm.stride(0), Cm.stride(0),
        conv.stride(0), ssm.stride(0), out.stride(0), float(eps), _build.current_stream(u)),
        "mamba_step")
    return out


def check_args(u, z, x, Bm, Cm, p: dict, conv, ssm) -> tuple:
    """(B, H, P, N, G, ck, d) of a step the kernel takes, or raise: head dim
    in ``HEAD_DIMS``, N a multiple of 4 up to ``MAX_N`` whose quarter
    divides 32, G groups dividing H, 1 to ``MAX_CK`` conv taps; the
    activations f32 or bf16, the weights and biases in one dtype, the
    per-head and norm parameters and the state fp32; the cache leaves
    contiguous past their batch stride, the state on 16 bytes."""
    wdt, dt_bias, a_log, d_skip, wx, wb, wc, bx, bb, bc, scale = (p[k] for k in _PARAMS)
    B, H, P, N = ssm.shape
    di, gn, ck, dm = H * P, Bm.shape[-1], wx.shape[0], u.shape[-1]
    G = gn // N if N else 0
    shapes = {"u": (u, (B, 1, dm)), "z": (z, (B, 1, di)), "x": (x, (B, 1, di)),
              "B": (Bm, (B, 1, gn)), "C": (Cm, (B, 1, gn)), "wdt": (wdt, (dm, H)),
              "dt_bias": (dt_bias, (H,)), "A_log": (a_log, (H,)), "D": (d_skip, (H,)),
              "conv_x": (wx, (ck, di)), "conv_B": (wb, (ck, gn)), "conv_C": (wc, (ck, gn)),
              "conv_bx": (bx, (di,)), "conv_bB": (bb, (gn,)), "conv_bC": (bc, (gn,)),
              "norm_scale": (scale, (di,)), "conv": (conv, (B, ck - 1, di + 2 * gn))}
    bad = {k: tuple(t.shape) for k, (t, want) in shapes.items() if tuple(t.shape) != want}
    if (bad or P not in HEAD_DIMS or N % 4 or not 0 < N <= MAX_N or 32 % (N // 4)
            or G * N != gn or G == 0 or H % G or not 1 <= ck <= MAX_CK):
        raise ValueError(f"mamba_step: shapes {bad or ''} state {tuple(ssm.shape)} (head dim "
                         f"in {HEAD_DIMS}, N a multiple of 4 up to {MAX_N} whose quarter "
                         f"divides 32, G dividing H, 1 to {MAX_CK} conv taps)")
    floats = (torch.float32, torch.bfloat16)
    if not (u.dtype == z.dtype == x.dtype == Bm.dtype == Cm.dtype and z.dtype in floats):
        raise TypeError("mamba_step: u, z, x, B and C must share one dtype, f32 or bf16")
    if wdt.dtype not in floats or any(t.dtype != wdt.dtype for t in (wx, wb, wc, bx, bb, bc)):
        raise TypeError("mamba_step: wdt and the conv weights and biases must share a dtype, "
                        "f32 or bf16")
    if conv.dtype not in floats or any(t.dtype != torch.float32
                                       for t in (dt_bias, a_log, d_skip, scale, ssm)):
        raise TypeError("mamba_step: the conv cache must be f32 or bf16; dt_bias, A_log, D, "
                        "norm_scale and the state float32")
    if B and (not (conv[0].is_contiguous() and ssm[0].is_contiguous())
              or ssm.data_ptr() % 16 or ssm.stride(0) % 4):
        raise ValueError("mamba_step: the conv and state caches must be contiguous past "
                         "their batch stride, the state on 16 bytes")
    return B, H, P, N, G, ck, dm
