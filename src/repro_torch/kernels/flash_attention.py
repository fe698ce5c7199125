"""Flash attention (forward, GQA): a CUDA C++ kernel for Hopper
(``csrc/flash_attention.cu``).

Replaces ``src/repro/kernels/flash_attention.py`` ``flash_attention``
(Pallas, ``_flash_kernel``).  On the H100, at the main path's prompt
lengths, it is bound by bytes (q, k, v read once, o written once); the
products grow as ``Sq*Sk*D`` and bound it only for long prompts.  Its design
keeps the online softmax in fp32 and never writes the score matrix to
device memory: one block per (query tile, head, batch row) walks the K/V
tiles in shared memory up to the causal limit.  It masks ragged ``Sq``/``Sk``
tails itself (the Pallas kernel asserted divisible lengths) and reads every
tensor through its strides, so the model's ``(B,S,H,D)`` layout is used in
place.  Head dims 16, 64 and 128; float32 and bfloat16.

``flash_attention_cuda`` launches the kernel (or raises);
:func:`flash_attention_plain` (from ``kernels/ref.py``) is the plain version
that ``ops.flash_attention`` takes for tensors on the CPU.  ``launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention as flash_attention_plain

__all__ = ["flash_attention_cuda", "flash_attention_plain", "launches"]

#: kernel launches so far (reset by ``ops.reset_launch_counts``)
launches = 0
HEAD_DIMS = (16, 64, 128)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = ([_P, _P, _P, _P] + [_I] * 8 + [ctypes.c_float] + [_L] * 12 + [_P])


def flash_attention_cuda(q, k, v, *, causal: bool = True, out=None):
    """q: (B,H,Sq,D); k,v: (B,K,Sk,D), on the card -> (B,H,Sq,D).  ``out``,
    if given, is a (B,H,Sq,D) tensor (any strides) that receives the result."""
    _build.require_cuda("flash_attention", q, k, v)
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    return _launch(q, k, v, causal, out, _build.current_stream(q))


def _launch(q, k, v, causal, out, stream):
    global launches
    B, H, Sq, D = q.shape
    K, Sk = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D or H % K:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype == out.dtype):
        raise TypeError("flash_attention: q, k, v and out must share a dtype")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D} not in {HEAD_DIMS}")
    if tuple(out.shape) != (B, H, Sq, D) or out.stride(-1) != 1:
        raise ValueError("flash_attention: out must be (B,H,Sq,D) with a unit last stride")
    q, k, v = (_build.unit_last(t) for t in (q, k, v))
    fn = _build.function("avec_flash_attention", _ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _build.dtype_code(q),
            B, H, K, Sq, Sk, D, int(bool(causal)), float(D ** -0.5),
            *(t.stride(i) for t in (q, k, v, out) for i in range(3)), stream)
    _build.check(rc, "flash_attention")
    launches += 1
    return out
