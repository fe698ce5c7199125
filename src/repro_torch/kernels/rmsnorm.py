"""Fused RMSNorm: a CUDA C++ kernel for Hopper (``csrc/rmsnorm.cu``).

Replaces ``src/repro/kernels/rmsnorm.py`` ``rmsnorm`` (Pallas,
``_rmsnorm_kernel``).  On the H100 it is bound by bytes: it reads x once
and writes y once, with a few operations per element, so its least time is
``2 * x.nbytes / 3.35 TB/s``.  The kernel reads each row once in 16-byte
vectors held in registers, reduces the sum of squares in fp32, and writes
the row back in 16-byte vectors; :func:`rmsnorm_plan` gives each row a
number of threads that follows D and packs several rows into a block.  The
scale is read in its own type (fp32 or bf16).  A row that does not lie on
16 bytes, or a D that is not a multiple of the vector, takes a scalar loop
in the same kernel.

``rmsnorm_cuda`` launches the kernel (or raises); :func:`rmsnorm_plain`
(from ``kernels/ref.py``) is the plain version that ``ops.rmsnorm`` takes
for a tensor on the CPU.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rmsnorm as rmsnorm_plain

__all__ = ["rmsnorm_cuda", "rmsnorm_plain", "rmsnorm_plan", "Plan", "launches"]

#: kernel launches so far (reset by ``ops.reset_launch_counts``)
launches = 0

THREADS = 256            # threads a block aims for
MAX_PER = 8              # 16-byte vectors a thread may hold (D up to 16384 bf16)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _I, _I, _L, _I, _L, _L, ctypes.c_float, _I, _I, _I, _P]


class Plan(NamedTuple):
    """How ``csrc/rmsnorm.cu`` covers the rows: thread ``t`` of block
    ``blk`` serves row ``blk * rpb + t // tpr``; in the vector path
    (``per`` > 0) it holds the row's 16-byte vectors ``t % tpr + k * tpr``
    for ``k < per`` (those below ``D / vec``), in the scalar loop (``per``
    0) the elements ``t % tpr + k * tpr`` below D."""
    per: int       # vectors a thread holds; 0: the scalar loop
    tpr: int       # threads per row: a power of two up to 32, or a multiple of 32
    rpb: int       # rows per block
    vec: int       # elements per 16-byte vector


@functools.lru_cache(maxsize=256)
def rmsnorm_plan(D: int, itemsize: int, aligned: bool) -> Plan:
    """The launch plan for rows of D elements of ``itemsize`` bytes;
    ``aligned``: the x rows and the scale lie on 16 bytes.  The vector path
    takes aligned rows whose D is a multiple of the vector and fits in
    ``MAX_PER`` vectors a thread; every other row takes the scalar loop."""
    vec = 16 // itemsize
    per, units = 0, min(D, THREADS)
    if aligned and D % vec == 0:
        nvec = D // vec
        p = 1
        while p * THREADS < nvec:
            p *= 2
        if p <= MAX_PER:
            per, units = p, -(-nvec // p)
    tpr = 1 << (units - 1).bit_length() if units <= 32 else -(-units // 32) * 32
    return Plan(per, tpr, max(1, THREADS // tpr), vec)


def rmsnorm_cuda(x, scale, *, eps: float = 1e-6):
    """x: (..., D) on the card; scale: (D,) fp32 or bf16 (another type is
    cast to fp32).  fp32 reduce, cast back to x.dtype."""
    _build.require_cuda("rmsnorm", x, scale)
    return _launch(x, scale, eps, _build.current_stream(x))


def _launch(x, scale, eps, stream):
    global launches
    D = x.shape[-1]
    if tuple(scale.shape) != (D,):
        raise ValueError(f"rmsnorm: scale shape {tuple(scale.shape)} != ({D},)")
    x2 = _build.unit_last(x.reshape(-1, D))
    s = scale if scale.dtype in (torch.float32, torch.bfloat16) else scale.float()
    s = s.contiguous()
    y = torch.empty(x2.shape, dtype=x.dtype, device=x.device)
    plan = rmsnorm_plan(D, x.element_size(),
                        _build.rows_aligned(x2) and s.data_ptr() % 16 == 0)
    fn = _build.function("avec_rmsnorm", _ARGTYPES)
    rc = fn(x2.data_ptr(), s.data_ptr(), y.data_ptr(), _build.dtype_code(x),
            _build.dtype_code(s), x2.shape[0], D, x2.stride(0), y.stride(0), float(eps),
            plan.per, plan.tpr, plan.rpb, stream)
    _build.check(rc, "rmsnorm")
    launches += 1
    return y.reshape(x.shape)
