"""Fused RMSNorm: a CUDA C++ kernel for Hopper (``csrc/rmsnorm.cu``).

Replaces ``src/repro/kernels/rmsnorm.py`` ``rmsnorm`` (Pallas,
``_rmsnorm_kernel``).  On the H100 it is bound by bytes: it reads x once
and writes y once, with a few operations per element, so its least time is
``2 * x.nbytes / 3.35 TB/s``.  Its design keeps that single pass: one block
per row, coalesced strided loops over the row, a shuffle reduction in
fp32, and no padding of the row count to a block multiple.

``rmsnorm_cuda`` launches the kernel (or raises); :func:`rmsnorm_plain`
(from ``kernels/ref.py``) is the plain version that ``ops.rmsnorm`` takes
for a tensor on the CPU.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rmsnorm as rmsnorm_plain

__all__ = ["rmsnorm_cuda", "rmsnorm_plain", "launches"]

#: kernel launches so far (reset by ``ops.reset_launch_counts``)
launches = 0

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _I, _L, _I, _L, _L, ctypes.c_float, _P]


def rmsnorm_cuda(x, scale, *, eps: float = 1e-6):
    """x: (..., D) on the card; scale: (D,).  fp32 reduce, cast back to x.dtype."""
    _build.require_cuda("rmsnorm", x, scale)
    return _launch(x, scale, eps, _build.current_stream(x))


def _launch(x, scale, eps, stream):
    global launches
    D = x.shape[-1]
    if tuple(scale.shape) != (D,):
        raise ValueError(f"rmsnorm: scale shape {tuple(scale.shape)} != ({D},)")
    x2 = _build.unit_last(x.reshape(-1, D))
    s = scale.to(torch.float32).contiguous()
    y = torch.empty(x2.shape, dtype=x.dtype, device=x.device)
    fn = _build.function("avec_rmsnorm", _ARGTYPES)
    rc = fn(x2.data_ptr(), s.data_ptr(), y.data_ptr(), _build.dtype_code(x),
            x2.shape[0], D, x2.stride(0), y.stride(0), float(eps), stream)
    _build.check(rc, "rmsnorm")
    launches += 1
    return y.reshape(x.shape)
