"""Per-row symmetric int8 quantization: CUDA C++ kernels for Hopper
(``csrc/comm_quant.cu``) plus the canonical leaf helpers every consumer
shares.

Replaces ``src/repro/kernels/comm_quant.py`` ``quantize_int8`` and
``dequantize_int8`` (Pallas, ``_quant_kernel`` / ``_dequant_kernel``).  The
AVEC wire codec (``core.serialization``, codec ``int8``) and the gradient
compression (``optim.compression``) both quantize through THIS module, so
the math exists once: ``scale = max(absmax_row, 1e-12) / 127``, ``q =
clip(rint(x / scale), -127, 127)``.  Per element ``|x - q*scale| <=
absmax_row/254`` plus float32 eps.

On the H100 both kernels are bound by bytes (quantize reads 4 B and writes
1 B per element plus 4 B per row; dequantize reads 1 B and writes 4 B).
The quantize reads each row once in 16-byte vectors held in registers,
under the launch plan of ``rowplan.row_plan`` (threads per row follow D,
rows packed per block, at least ``MIN_PER`` vectors a thread; shared with
rmsnorm), reduces the NaN-propagating max of ``|x|`` over the row's threads
and writes ``q`` from the registers.  Rows off 16 bytes or a D that is not
a multiple of the vector take a scalar loop in the same kernel: dispatch by
alignment and shape, counted per branch (``quantize_int8_vec`` /
``quantize_int8_scalar``).  ``q`` is bit-exact with the plain version
(the IEEE quotient, round half to even; the kernel multiplies by a per-row
reciprocal and divides only near a tie, ``csrc/comm_quant.cu``).  The
kernel reads bf16 directly, whose conversion to fp32 is exact, so
:func:`quantize_leaf` makes no fp32 copy of a bf16 gradient on the card.
Dequantize: one warp per row in a grid-stride loop.

Leaf layout: a leaf of any rank is quantized over :func:`leaf_rows` (rank
>= 2 collapses leading axes onto rows of the final axis; rank 0/1 is one
row).  The kernels address rows through a row stride and need a unit last
stride; ``leaf_rows`` of a non-contiguous leaf is a contiguous copy.

``quantize_int8_cuda`` / ``dequantize_int8_cuda`` launch the kernels (or
raise); :func:`quantize_int8_plain` / :func:`dequantize_int8_plain` (from
``kernels/ref.py``) are the plain versions ``ops`` takes for tensors on the
CPU.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import dequantize_int8 as dequantize_int8_plain
from repro_torch.kernels.ref import quantize_int8 as quantize_int8_plain
from repro_torch.kernels.rowplan import Plan, row_plan

__all__ = ["leaf_rows", "quantize_int8_np", "dequantize_int8_np", "quantize_leaf",
           "dequantize_leaf", "quantize_plan", "quantize_int8_cuda", "dequantize_int8_cuda",
           "quantize_int8_plain", "dequantize_int8_plain"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_QUANT_ARGTYPES = [_P, _P, _P, _I, _L, _I, _L, _L, _I, _I, _I, _P]
_DEQUANT_ARGTYPES = [_P, _P, _P, _I, _L, _I, _L, _L, _P]


# ---------------------------------------------------------------------------
# Canonical leaf helpers (one implementation for wire codec + compression)
# ---------------------------------------------------------------------------

def leaf_rows(x):
    """Canonical 2-D per-row view of a leaf for row-scaled quantization
    (numpy arrays and tensors; rank 0/1 becomes one row)."""
    return x.reshape(-1, x.shape[-1]) if x.ndim >= 2 else x.reshape(1, -1)


def quantize_int8_np(x) -> tuple[np.ndarray, np.ndarray]:
    """NumPy mirror of the kernel math for the wire hot path.  ``x`` (any
    rank, any layout) -> ``(q int8 (rows, cols), scale f32 (rows, 1))``."""
    flat = np.ascontiguousarray(leaf_rows(np.asarray(x)), dtype=np.float32)
    absmax = np.max(np.abs(flat), axis=1, keepdims=True) if flat.size \
        else np.zeros((flat.shape[0], 1), np.float32)
    scale = np.maximum(absmax, 1e-12) / 127.0
    q = np.clip(np.rint(flat / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def dequantize_int8_np(q, scale, dtype=np.float32) -> np.ndarray:
    """Inverse of :func:`quantize_int8_np` (still (rows, cols); the caller
    reshapes, as only it knows the leaf's shape)."""
    return (np.asarray(q).astype(np.float32) * np.asarray(scale)).astype(dtype)


def quantize_leaf(x, *, impl: str | None = None):
    """A leaf (any rank, any float dtype) -> ``(q (rows, cols) int8, scale
    (rows, 1) f32)`` through ``ops.quantize_int8``."""
    from repro_torch.kernels import ops
    rows = leaf_rows(x)
    if rows.dtype not in (torch.float32, torch.bfloat16):
        rows = rows.float()
    return ops.quantize_int8(rows, impl=impl)


def dequantize_leaf(q, s, shape, dtype, *, impl: str | None = None):
    """Inverse of :func:`quantize_leaf`: ``q * s`` in fp32, cast to
    ``dtype`` and reshaped to ``shape``."""
    from repro_torch.kernels import ops
    out_dtype = dtype if dtype in (torch.float32, torch.bfloat16) else torch.float32
    return ops.dequantize_int8(q, s, out_dtype, impl=impl).reshape(shape).to(dtype)


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

#: vectors a thread holds at least (``row_plan``'s ``min_per``): four loads
#: of 16 bytes in flight per thread, where one a thread (rmsnorm's rule at
#: D 2048 bf16) left the card a third below its memory rate
MIN_PER = 4


def quantize_plan(x) -> Plan:
    """The launch plan for x (N, D): the vector path needs x's rows on 16
    bytes.  q's rows then lie on the vector's store width by construction
    (a fresh allocation, row stride D, a multiple of the vector); the C
    entry point checks both."""
    return row_plan(x.shape[1], x.element_size(), _build.rows_aligned(x), MIN_PER)


def quantize_int8_cuda(x):
    """x: (N, D) f32 or bf16 on the card, unit last stride -> (q (N, D)
    int8, scale (N, 1) f32)."""
    _build.require_cuda("quantize_int8", x)
    if x.ndim != 2:
        raise ValueError(f"quantize_int8: x must be (N, D), got {tuple(x.shape)}")
    x = _build.unit_last(x)
    N, D = x.shape
    q = torch.empty((N, D), dtype=torch.int8, device=x.device)
    scale = torch.empty((N, 1), dtype=torch.float32, device=x.device)
    plan = quantize_plan(x)
    _build.launch("avec_quantize_int8", _QUANT_ARGTYPES, (
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), _build.dtype_code(x), N, D, x.stride(0),
        q.stride(0), plan.per, plan.tpr, plan.rpb, _build.current_stream(x)),
        "quantize_int8", "quantize_int8_vec" if plan.per else "quantize_int8_scalar")
    return q, scale


def dequantize_int8_cuda(q, scale, dtype=torch.float32):
    """q: (N, D) int8, scale: (N, 1) f32 on the card -> (N, D) ``dtype``
    (float32 or bfloat16), the fp32 product rounded once."""
    _build.require_cuda("dequantize_int8", q, scale)
    N, D = q.shape
    if q.dtype != torch.int8 or scale.dtype != torch.float32 or scale.numel() != N:
        raise ValueError(f"dequantize_int8: q {q.dtype} {tuple(q.shape)}, scale "
                         f"{scale.dtype} {tuple(scale.shape)}")
    q = _build.unit_last(q)
    s = scale.reshape(N).contiguous()
    out = torch.empty((N, D), dtype=dtype, device=q.device)
    _build.launch("avec_dequantize_int8", _DEQUANT_ARGTYPES, (
        q.data_ptr(), s.data_ptr(), out.data_ptr(), _build.dtype_code(out), N, D, q.stride(0),
        out.stride(0), _build.current_stream(q)), "dequantize_int8")
    return out
