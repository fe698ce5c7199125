"""Decode attention: a CUDA C++ kernel for Hopper (``csrc/decode_attention.cu``).

Replaces ``src/repro/kernels/decode_attention.py`` ``decode_attention``
(Pallas, ``_decode_kernel``).  On the H100 it is bound by bytes: it reads
the first ``kv_len[b]`` rows of the K and V cache once, with about ``4*G``
flops per byte.  Its design reads each cache row once for all G query heads
of its KV head (one block per (KV head, batch row)), skips the rows past
``kv_len`` without reading them, and reads the model's ``(B,S_max,K,D)``
cache in place through its strides.  Head dims 16, 64 and 128; q and the
cache each float32 or bfloat16 (the library path gives both one dtype).

``decode_attention_cuda`` launches the kernel (or raises);
:func:`decode_attention_plain` (from ``kernels/ref.py``) is the plain version
that ``ops.decode_attention`` takes for tensors on the CPU.  ``launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import decode_attention as decode_attention_plain

__all__ = ["decode_attention_cuda", "decode_attention_plain", "launches"]

#: kernel launches so far (reset by ``ops.reset_launch_counts``)
launches = 0
HEAD_DIMS = (16, 64, 128)
MAX_GROUP = 64

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = ([_P] * 5 + [_I] * 7 + [ctypes.c_float] + [_L] * 12 + [_P])


def decode_attention_cuda(q, k, v, kv_len):
    """q: (B,K,G,D); k,v: (B,K,S,D); kv_len: (B,), on the card -> (B,K,G,D)
    in q's dtype."""
    _build.require_cuda("decode_attention", q, k, v)
    kv_len = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    return _launch(q, k, v, kv_len, out, _build.current_stream(q))


def _launch(q, k, v, kv_len, out, stream):
    global launches
    B, K, G, D = q.shape
    S = k.shape[2]
    if k.shape != v.shape or tuple(k.shape[:2]) != (B, K) or k.shape[3] != D:
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if tuple(kv_len.shape) != (B,) or kv_len.dtype != torch.int32:
        raise ValueError("decode_attention: kv_len must be (B,) int32")
    if k.dtype != v.dtype or out.dtype != q.dtype:
        raise TypeError("decode_attention: k and v must share a dtype, out takes q's")
    if D not in HEAD_DIMS or G > MAX_GROUP:
        raise ValueError(f"decode_attention: head_dim {D} not in {HEAD_DIMS} "
                         f"or group {G} > {MAX_GROUP}")
    if tuple(out.shape) != (B, K, G, D) or out.stride(-1) != 1:
        raise ValueError("decode_attention: out must be (B,K,G,D) with a unit last stride")
    q, k, v = (_build.unit_last(t) for t in (q, k, v))
    fn = _build.function("avec_decode_attention", _ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
            _build.dtype_code(q), _build.dtype_code(k), B, K, G, S, D, float(D ** -0.5),
            *(t.stride(i) for t in (q, k, v, out) for i in range(3)), stream)
    _build.check(rc, "decode_attention")
    launches += 1
    return out
