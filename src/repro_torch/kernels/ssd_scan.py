"""Mamba2 SSD chunked scan: a CUDA C++ kernel for Hopper (``csrc/ssd_scan.cu``).

Replaces ``src/repro/kernels/ssd_scan.py`` ``ssd_scan_kernel`` (Pallas,
``_ssd_kernel``).  On the H100 it is bound by bytes at the main path's
shapes (mamba2-130m: B 2, S 1024, H 24, P 64, G 1, N 128, chunk 256): about
15 MB in and out against 3.4 GFLOP.  The design: one block per (batch row,
head, 32-wide slice of P), the chunks a loop inside the block with the
slice's state in shared memory, each chunk walked in 64-row tiles so no
(L,L) score matrix is ever held; the products run on the CUDA cores (see
the source note for what bounds it and what comes next).

The kernel reads the model's ``(B,S,H,P)``, ``(B,S,H)`` and ``(B,S,G,N)``
tensors in place through their strides: no pad, reshape or transpose
copies.  Positions past S read as zero inside the kernel.

``ssd_scan_cuda`` launches the kernel (or raises); :func:`ssd_scan_plain`
(from ``kernels/ref.py``, the chunked algorithm) is the plain version that
``ops.ssd_scan`` takes for a tensor on the CPU.  ``launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_scan as ssd_scan_plain

__all__ = ["ssd_scan_cuda", "ssd_scan_plain", "launches"]

#: kernel launches so far (reset by ``ops.reset_launch_counts``)
launches = 0

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 7 + [_I] * 4 + [_L] + [_I] * 5 + [_L] * 15 + [_P]


def ssd_scan_cuda(x, dt, A, Bm, Cm, *, chunk: int):
    """x: (B,S,H,P) f32/bf16; dt: (B,S,H) f32 post-softplus; A: (H,);
    Bm, Cm: (B,S,G,N) in x's type; H % G == 0; chunks of ``chunk``.
    Returns (y (B,S,H,P) in x.dtype, final_state (B,H,P,N) fp32)."""
    _build.require_cuda("ssd_scan", x, dt, A, Bm, Cm)
    return _launch(x, dt, A, Bm, Cm, chunk, _build.current_stream(x))


def _launch(x, dt, A, Bm, Cm, chunk, stream):
    global launches
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if (tuple(dt.shape) != (B, S, H) or tuple(A.shape) != (H,)
            or tuple(Bm.shape) != (B, S, G, N) or tuple(Cm.shape) != (B, S, G, N)
            or H % G != 0):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)} dt {tuple(dt.shape)} "
                         f"A {tuple(A.shape)} B {tuple(Bm.shape)} C {tuple(Cm.shape)}")
    x, Bm, Cm = (_build.unit_last(t) for t in (x, Bm, Cm))
    A32 = A.to(torch.float32).contiguous()                  # (H,): a few bytes
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    fn = _build.function("avec_ssd_scan", _ARGTYPES)
    rc = fn(x.data_ptr(), dt.data_ptr(), A32.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            y.data_ptr(), state.data_ptr(),
            _build.dtype_code(x), _build.dtype_code(Bm) if Bm.dtype == Cm.dtype else -1,
            _build.dtype_code(dt), B, S, H, P, G, N, chunk,
            *x.stride()[:3], *dt.stride(), *Bm.stride()[:3], *Cm.stride()[:3],
            *y.stride()[:3], stream)
    _build.check(rc, "ssd_scan")
    launches += 1
    return y, state
