"""Decode attention: a split-K CUDA C++ kernel for Hopper
(``csrc/decode_attention.cu``).

Replaces ``src/repro/kernels/decode_attention.py`` ``decode_attention``
(Pallas, ``_decode_kernel``).  On the H100 it is bound by bytes: it reads
the first ``kv_len[b]`` rows of the K and V cache once, with about ``4*G``
flops per byte, so it has to keep the card's memory system busy.  The TPU
kernel walks the cache in one sequential pass per (batch row, KV head); at
batch 2 that would fill 16 of 132 SMs.  Here the grid is (KV head, batch
row, split): :func:`split_plan` cuts the cache length ``S`` into splits of
``split_len`` keys from ``S``, ``B*K`` and the SM count alone -- never from
``kv_len``, whose ``.item()`` would add a host sync to every layer.  Each
block reads its split once for all G query heads of its KV head (16-byte
``cp.async`` copies, so cache rows must lie on 16 bytes; the wrapper copies
a cache that breaks the rule) and skips the keys past ``kv_len``; a split
that starts past ``kv_len`` reads nothing.  Partials (m, l, acc) go to fp32
scratch, and the last block of each (b, KV head) -- found by an integer
counter -- merges them in split order: no float atomics, so two calls give
bit-identical output.  The scratch and the counters are the device's pool
(``_build.scratch``).  Head dims 16, 64 and 128; G up to 64; q
and the cache each float32 or bfloat16 (the library path gives both one
dtype).

``decode_attention_cuda`` launches the kernel (or raises);
:func:`decode_attention_plain` (from ``kernels/ref.py``) is the plain version
that ``ops.decode_attention`` takes for tensors on the CPU.  A call is one
kernel launch, so a decode step counts one per layer.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import decode_attention as decode_attention_plain

__all__ = ["decode_attention_cuda", "decode_attention_plain", "split_plan"]

HEAD_DIMS = (16, 64, 128)
MAX_GROUP = 64
SPLIT_UNIT = 32          # keys per tile in the kernel: splits are multiples of it
BLOCKS_PER_SM = 4        # blocks the plan aims for, per SM

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = ([_P] * 7 + [_I] * 9 + [ctypes.c_float] + [_L] * 12 + [_P])


def split_plan(S: int, B: int, K: int, n_sm: int) -> tuple[int, int]:
    """-> (split_len, n_split): split ``s`` covers keys ``[s*split_len,
    min((s+1)*split_len, S))``.  About ``BLOCKS_PER_SM * n_sm`` blocks over
    the B*K (batch row, KV head) pairs, each split a multiple of
    ``SPLIT_UNIT`` keys, at least one split."""
    want = max(1, -(-BLOCKS_PER_SM * n_sm // max(1, B * K)))
    per = max(1, -(-S // want))
    split_len = -(-per // SPLIT_UNIT) * SPLIT_UNIT
    return split_len, max(1, -(-S // split_len))


def decode_attention_cuda(q, k, v, kv_len, *, scale: float | None = None):
    """q: (B,K,G,D); k,v: (B,K,S,D); kv_len: (B,), on the card -> (B,K,G,D)
    in q's dtype, the scores scaled by ``scale`` (1/sqrt(D) when None)."""
    _build.require_cuda("decode_attention", q, k, v)
    kv_len = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    return _launch(q, k, v, kv_len, out, _build.current_stream(q), scale)


def _launch(q, k, v, kv_len, out, stream, scale=None):
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
    q = _build.unit_last(q)
    k, v = _build.aligned_rows(k), _build.aligned_rows(v)
    split_len, n_split = split_plan(S, B, K, _build.sm_count(q.device))
    counter, part = _build.scratch(q.device, B * K, B * K * n_split * G * (D + 2))
    _build.launch("avec_decode_attention", _ARGTYPES, (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
        part.data_ptr(), counter.data_ptr(), _build.dtype_code(q), _build.dtype_code(k),
        B, K, G, S, D, split_len, n_split, float(D ** -0.5 if scale is None else scale),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3], stream),
        "decode_attention")
    return out
