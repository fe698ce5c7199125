"""Flash attention (forward, GQA): a CUDA C++ kernel for Hopper
(``csrc/flash_attention.cu``).

Replaces ``src/repro/kernels/flash_attention.py`` ``flash_attention``
(Pallas, ``_flash_kernel``).  On the H100, at the main paths' prompt
lengths, it is bound by bytes (q, k, v read once, o written once); the
products grow as ``Sq*Sk*D`` and bound it only for long prompts.

bfloat16 runs on the tensor cores: one warpgroup per (64 packed query rows,
KV head, batch row), the G query heads of a KV head packed into the rows so
each K/V tile is read once per group; both products are ``wgmma`` (bf16 in,
fp32 accumulate), the online softmax stays in registers, K/V tiles stream
through a two-stage shared-memory ring by 16-byte ``cp.async`` copies.
Those copies need every row on 16 bytes (:func:`_build.rows_aligned`); a
tensor that breaks the rule is copied first (:func:`_build.aligned_rows`),
never sent to another kernel.  float32 keeps a CUDA-core kernel: tensor
cores would round it to TF32, outside the 2e-5 fp32 tolerance.  Both mask
ragged ``Sq``/``Sk`` tails themselves (the Pallas kernel asserted divisible
lengths) and read every tensor through its strides, so the model's
``(B,S,H,D)`` layout is used in place.  Head dims 16, 64 and 128.

``flash_attention_cuda`` launches the kernel (or raises);
:func:`flash_attention_plain` (from ``kernels/ref.py``) is the plain version
that ``ops.flash_attention`` takes for tensors on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention as flash_attention_plain

__all__ = ["flash_attention_cuda", "flash_attention_plain"]

HEAD_DIMS = (16, 64, 128)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = ([_P, _P, _P, _P] + [_I] * 8 + [ctypes.c_float] + [_L] * 12 + [_P])


def flash_attention_cuda(q, k, v, *, causal: bool = True, scale: float | None = None,
                         out=None):
    """q: (B,H,Sq,D); k,v: (B,K,Sk,D), on the card -> (B,H,Sq,D), the scores
    scaled by ``scale`` (1/sqrt(D) when None).  ``out``, if given, is a
    (B,H,Sq,D) tensor (any strides) that receives the result."""
    _build.require_cuda("flash_attention", q, k, v)
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    return _launch(q, k, v, causal, out, _build.current_stream(q), scale)


def kernel_inputs(q, k, v):
    """q, k, v as the kernel reads them: bf16 rows on 16 bytes (copied where
    they are not), f32 with a unit last stride."""
    fix = _build.aligned_rows if q.dtype == torch.bfloat16 else _build.unit_last
    return tuple(fix(t) for t in (q, k, v))


def _launch(q, k, v, causal, out, stream, scale=None):
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
    q, k, v = kernel_inputs(q, k, v)
    dst = out if q.dtype != torch.bfloat16 or _build.rows_aligned(out) else torch.empty_like(
        out, memory_format=torch.contiguous_format)
    _build.launch("avec_flash_attention", _ARGTYPES, (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dst.data_ptr(), _build.dtype_code(q),
        B, H, K, Sq, Sk, D, int(bool(causal)), float(D ** -0.5 if scale is None else scale),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *dst.stride()[:3], stream),
        "flash_attention")
    if dst is not out:
        out.copy_(dst)
    return out
