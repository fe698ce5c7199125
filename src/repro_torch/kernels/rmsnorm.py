"""Fused RMSNorm: a CUDA C++ kernel for Hopper (``csrc/rmsnorm.cu``).

Replaces ``src/repro/kernels/rmsnorm.py`` ``rmsnorm`` (Pallas,
``_rmsnorm_kernel``).  On the H100 it is bound by bytes: it reads x once
and writes y once, with a few operations per element, so its least time is
``2 * x.nbytes / 3.35 TB/s``.  The kernel reads each row once in 16-byte
vectors held in registers, reduces the sum of squares in fp32, and writes
the row back in 16-byte vectors; ``rmsnorm_plan`` (``rowplan.row_plan``,
shared with the int8 quantize) gives each row a number of threads that
follows D and packs several rows into a block.  The scale is read in its
own type (fp32 or bf16).  A row that does not lie on 16 bytes, or a D that
is not a multiple of the vector, takes a scalar loop in the same kernel.

``rmsnorm_cuda`` launches the kernel (or raises); :func:`rmsnorm_plain`
(from ``kernels/ref.py``) is the plain version that ``ops.rmsnorm`` takes
for a tensor on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rmsnorm as rmsnorm_plain
from repro_torch.kernels.rowplan import Plan, row_plan

__all__ = ["rmsnorm_cuda", "rmsnorm_plain", "rmsnorm_plan", "Plan"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _I, _I, _L, _I, _L, _L, ctypes.c_float, _I, _I, _I, _P]

#: the launch plan (``rowplan.row_plan``): the x rows and the scale on 16
#: bytes make a row ``aligned``
rmsnorm_plan = row_plan


def rmsnorm_cuda(x, scale, *, eps: float = 1e-6):
    """x: (..., D) on the card; scale: (D,) fp32 or bf16 (another type is
    cast to fp32).  fp32 reduce, cast back to x.dtype."""
    _build.require_cuda("rmsnorm", x, scale)
    return _launch(x, scale, eps, _build.current_stream(x))


def _launch(x, scale, eps, stream):
    D = x.shape[-1]
    if tuple(scale.shape) != (D,):
        raise ValueError(f"rmsnorm: scale shape {tuple(scale.shape)} != ({D},)")
    x2 = _build.unit_last(x.reshape(-1, D))
    s = scale if scale.dtype in (torch.float32, torch.bfloat16) else scale.float()
    s = s.contiguous()
    y = torch.empty(x2.shape, dtype=x.dtype, device=x.device)
    plan = rmsnorm_plan(D, x.element_size(),
                        _build.rows_aligned(x2) and s.data_ptr() % 16 == 0)
    _build.launch("avec_rmsnorm", _ARGTYPES, (
        x2.data_ptr(), s.data_ptr(), y.data_ptr(), _build.dtype_code(x), _build.dtype_code(s),
        x2.shape[0], D, x2.stride(0), y.stride(0), float(eps), plan.per, plan.tpr, plan.rpb,
        stream), "rmsnorm")
    return y.reshape(x.shape)
