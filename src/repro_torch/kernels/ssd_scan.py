"""Mamba2 SSD chunked scan: CUDA C++ kernels for Hopper (``csrc/ssd_scan.cu``).

Replaces ``src/repro/kernels/ssd_scan.py`` ``ssd_scan_kernel`` (Pallas,
``_ssd_kernel``).  On the H100 it is bound by bytes at the main path's
shapes (mamba2-130m: B 2, S 1024, H 24, P 64, G 1, N 128, chunk 256): about
15 MB in and out against 3.4 GFLOP.  Two hand-written kernels, chosen on the
host by :func:`tensor_core_branch` from the dtype and the shape:

* the tensor-core branch (bf16, P and N multiples of 16 up to 128, L a
  multiple of 64; A <= 0 and dt >= 0, as Mamba2's A = -exp(A_log) and
  softplus dt give, since the decay is factored on that condition): the
  chunks in parallel, in the published SSD
  decomposition -- chunk states (the state passing in the last block of
  each (batch row, head, slice), found by a counter), then the chunk scan
  -- with every product on ``mma.sync``; the fp32 operands (decayed
  scores, x * w, the entering state) enter as bf16 hi/lo pairs.  A block
  takes one slice of at most ``TC_SLICE_P`` columns of P (the columns are
  independent), so jamba-1.5-large's head dim 128 runs as two slices
  (:func:`tc_slices`), each recomputing its C B^T.  Two launches;
  fp32 scratch for the chunk states, cum and dt, bf16 scratch for the
  entering states and int32 counters, all from the device's pool
  (``_build.scratch``, laid out by :func:`tc_scratch`);
* the CUDA-core branch (fp32, where TF32 would break the 2e-4 hold, and
  every other shape): one block per (batch row, head, 32-wide slice of P),
  the chunks a loop inside the block with the slice's state in shared
  memory, the products on the CUDA cores.

This is dispatch by type and shape: a CUDA tensor goes to one of the two
kernels, or the launch raises.  Both read the model's ``(B,S,H,P)``,
``(B,S,H)`` and ``(B,S,G,N)`` tensors in place through their strides (the
tensor-core branch copies x, B or C only if its rows do not lie on 16
bytes, ``_build.rows_aligned``); positions past S read as zero inside the
kernels.

``ssd_scan_cuda`` launches a kernel (or raises); :func:`ssd_scan_plain`
(from ``kernels/ref.py``, the chunked algorithm) is the plain version that
``ops.ssd_scan`` takes for a tensor on the CPU.  A call counts as
``ssd_scan`` and as its branch, ``ssd_scan_tc`` or ``ssd_scan_simt``
(``_build.launch``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_scan as ssd_scan_plain

__all__ = ["ssd_scan_cuda", "ssd_scan_plain", "tensor_core_branch", "tc_slices", "tc_scratch"]

TC_TILE = 64                       # positions per tile of the tensor-core kernels
TC_MAX_P, TC_MAX_N, TC_MAX_L = 128, 128, 2048
TC_SLICE_P = 64                    # columns of P per block of the tensor-core kernels

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 7 + [_I] * 4 + [_L] + [_I] * 5 + [_L] * 15 + [_P]
_TC_ARGTYPES = [_P] * 11 + [_I, _L] + [_I] * 5 + [_L] * 15 + [_P]


def tensor_core_branch(dtype, P: int, N: int, L: int) -> bool:
    """True when a scan of x, B and C in ``dtype`` with head dim P, state
    dim N and chunk length L takes the tensor-core kernels: bf16 (fp32
    stays on the CUDA cores: TF32 would break the 2e-4 hold), P and N
    multiples of 16 up to 128, L a multiple of 64 up to 2048."""
    return (dtype == torch.bfloat16 and P % 16 == 0 and 0 < P <= TC_MAX_P
            and N % 16 == 0 and 0 < N <= TC_MAX_N and L % TC_TILE == 0 and 0 < L <= TC_MAX_L)


def tc_slices(P: int) -> int:
    """Slices of P the tensor-core kernels split a head into: one block per
    ``TC_SLICE_P`` columns (the last slice may be narrower)."""
    return -(-P // TC_SLICE_P)


def tc_scratch(B: int, H: int, P: int, N: int, nc: int, L: int) -> tuple[int, int, int, int]:
    """(int32 counters, fp32 floats, byte offsets of the bf16 hi and lo
    regions) the tensor-core kernels take from the device's pool for B rows
    of H heads in nc chunks of L: the chunk states, cum, dt and the chunk
    decays in fp32 from the start, then the entering states' hi and lo
    halves in bf16, each region starting on 16 bytes."""
    ns, n_states = tc_slices(P), B * H * nc * P * N
    hi = -(-4 * (n_states + B * H * nc * (2 * L + ns)) // 16) * 16
    lo = hi + -(-2 * n_states // 16) * 16
    return B * H * ns, -(-(lo + 2 * n_states) // 4), hi, lo


def ssd_scan_cuda(x, dt, A, Bm, Cm, *, chunk: int):
    """x: (B,S,H,P) f32/bf16; dt: (B,S,H) f32 post-softplus; A: (H,);
    Bm, Cm: (B,S,G,N) in x's type; H % G == 0; chunks of ``chunk``.
    Returns (y (B,S,H,P) in x.dtype, final_state (B,H,P,N) fp32)."""
    _build.require_cuda("ssd_scan", x, dt, A, Bm, Cm)
    return _launch(x, dt, A, Bm, Cm, chunk, _build.current_stream(x))


def _launch(x, dt, A, Bm, Cm, chunk, stream):
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if (tuple(dt.shape) != (B, S, H) or tuple(A.shape) != (H,)
            or tuple(Bm.shape) != (B, S, G, N) or tuple(Cm.shape) != (B, S, G, N)
            or H % G != 0):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)} dt {tuple(dt.shape)} "
                         f"A {tuple(A.shape)} B {tuple(Bm.shape)} C {tuple(Cm.shape)}")
    A32 = A.to(torch.float32).contiguous()                  # (H,): a few bytes
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    if Bm.dtype == Cm.dtype == x.dtype and S > 0 and tensor_core_branch(x.dtype, P, N, chunk):
        if dt.dtype != torch.float32:
            raise TypeError(f"ssd_scan: dt must be float32, not {dt.dtype}")
        x, Bm, Cm = (_build.aligned_rows(t) for t in (x, Bm, Cm))
        n_ints, n_floats, hi, lo = tc_scratch(B, H, P, N, -(-S // chunk), chunk)
        counter, f32 = _build.scratch(x.device, n_ints, n_floats)
        _build.launch("avec_ssd_scan_tc", _TC_ARGTYPES, (
            x.data_ptr(), dt.data_ptr(), A32.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            y.data_ptr(), state.data_ptr(), f32.data_ptr(), f32.data_ptr() + hi,
            f32.data_ptr() + lo, counter.data_ptr(), B, S, H, P, G, N, chunk,
            *x.stride()[:3], *dt.stride(), *Bm.stride()[:3], *Cm.stride()[:3],
            *y.stride()[:3], stream), "ssd_scan", "ssd_scan_tc")
    else:
        x, Bm, Cm = (_build.unit_last(t) for t in (x, Bm, Cm))
        _build.launch("avec_ssd_scan", _ARGTYPES, (
            x.data_ptr(), dt.data_ptr(), A32.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            y.data_ptr(), state.data_ptr(),
            _build.dtype_code(x), _build.dtype_code(Bm) if Bm.dtype == Cm.dtype else -1,
            _build.dtype_code(dt), B, S, H, P, G, N, chunk,
            *x.stride()[:3], *dt.stride(), *Bm.stride()[:3], *Cm.stride()[:3],
            *y.stride()[:3], stream), "ssd_scan", "ssd_scan_simt")
    return y, state
