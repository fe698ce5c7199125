"""A dropless MoE's routing and combine at a decode: two CUDA C++ kernels for
Hopper (``csrc/moe_route.cu``).

Replace no TPU kernel: the JAX package routes with plain array code
(``repro/models/moe.py``), and the port's dropless dispatch did too -- some
twenty small kernels a layer around ``ops.moe_experts`` (the router's GEMV,
the softmax, the top-k and its renormalisation, a radix sort, a search of
the sorted ids, gathers, a scatter and the sum over k).  At a decode they
cost their launches and the gaps between them, not their bytes (the router
is 1.18 MB fp32 at granite-4.0-h-small's widths).  ``moe_route`` does the
routing in one launch, fp32 throughout: blocks take slices of the router's
rows and write partial logits, and the last block to arrive (an integer
counter, reset by that block) sums them in a fixed order, then takes the
softmax, the top k (an exact tie to the lower expert id), the
renormalisation and a stable counting sort by expert, and copies x's rows
into expert order; two calls give bit-identical output.  ``moe_combine``
weights each expert's output row by its probability, puts it back with its
token, sums over k and adds the shared expert's output, in one launch.  The
scratch and the counter are the device's pool (``_build.scratch``).

``moe_route_cuda`` and ``moe_combine_cuda`` launch the kernels (or raise);
:func:`moe_route_plain` and :func:`moe_combine_plain` (from ``kernels/ref.py``)
are the plain versions that ``ops.moe_route`` and ``ops.moe_combine`` take for
tensors on the CPU.  A call is one kernel launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import moe_combine as moe_combine_plain
from repro_torch.kernels.ref import moe_route as moe_route_plain

__all__ = ["moe_route_cuda", "moe_combine_cuda", "moe_route_plain", "moe_combine_plain",
           "check_route_args", "check_combine_args", "route_plan", "MAX_ROWS"]

#: assignments (tokens x k) the route kernel's last block sorts in shared
#: memory and copies alone (csrc MAX_ROWS): a decode of up to 51 rows at
#: k 10; a prefill of more takes the plain chain (``models/moe.py``)
MAX_ROWS = 512
MAX_E = 256
MAX_K = 32
ROUTER_ROWS = 128        # router rows a block takes at least

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ROUTE_ARGTYPES = [_P] * 8 + [_I] * 6 + [_L, _P]
_COMBINE_ARGTYPES = [_P] * 5 + [_I] * 3 + [_L, _P]


def moe_route_cuda(x, router, k: int):
    """x (T, d) bf16, router (d, E) fp32, on the card -> (rows (T*k, d),
    ends (E,) int32, w (T*k,) bf16, order (T*k,) int32), as
    :func:`moe_route_plain`."""
    _build.require_cuda("moe_route", x, router)
    T, d, E = check_route_args(x, router, k)
    dev = x.device
    rows = torch.empty((T * k, d), dtype=x.dtype, device=dev)
    ends = torch.zeros(E, dtype=torch.int32, device=dev)
    w = torch.empty(T * k, dtype=x.dtype, device=dev)
    order = torch.empty(T * k, dtype=torch.int32, device=dev)
    if T == 0:
        return rows, ends, w, order
    x, router = _build.aligned_rows(x), _build.aligned_rows(router.contiguous())
    rb = route_plan(T, d, _build.sm_count(dev))
    S = -(-d // rb)
    counter, scratch = _build.scratch(dev, 1, T * S * E)
    _build.launch("avec_moe_route", _ROUTE_ARGTYPES, (
        x.data_ptr(), router.data_ptr(), rows.data_ptr(), ends.data_ptr(), w.data_ptr(),
        order.data_ptr(), scratch.data_ptr(), counter.data_ptr(), T, d, E, k, rb, S,
        x.stride(0) if T > 1 else d, _build.current_stream(x)), "moe_route")
    return rows, ends, w, order


def route_plan(T: int, d: int, n_sm: int) -> int:
    """Router rows a block of ``moe_route`` takes: ``ROUTER_ROWS`` (a
    thread's loads in one round trip) while the T x slices blocks fit in two
    waves of the card's ``n_sm`` SMs, more where T is large, so that the
    last block sums fewer partials: on an H100 (132 SMs) at d 4096, 32
    slices up to T 8, 8 at T 32."""
    slices = min(-(-d // ROUTER_ROWS), max(1, 2 * n_sm // T))
    return -(-d // slices)


def moe_combine_cuda(out, w, order, k: int, shared=None):
    """out (T*k, d), w (T*k,) bf16, order (T*k,) int32 as ``moe_route``
    left them, shared (T, d) bf16 or None, on the card -> y (T, d) bf16, as
    :func:`moe_combine_plain`."""
    _build.require_cuda("moe_combine", out, w, order, *([] if shared is None else [shared]))
    T, d = check_combine_args(out, w, order, k, shared)
    y = torch.empty((T, d), dtype=out.dtype, device=out.device)
    if T == 0:
        return y
    out, w, order = _build.aligned_rows(out.contiguous()), w.contiguous(), order.contiguous()
    if shared is not None:
        shared = _build.aligned_rows(shared)
    _build.launch("avec_moe_combine", _COMBINE_ARGTYPES, (
        out.data_ptr(), w.data_ptr(), order.data_ptr(),
        None if shared is None else shared.data_ptr(), y.data_ptr(), T, d, k,
        0 if shared is None else shared.stride(0) if T > 1 else d, _build.current_stream(out)),
        "moe_combine")
    return y


def check_route_args(x, router, k: int) -> tuple:
    """(T, d, E) of a routing the kernel takes, or raise: x (T, d) bf16 with
    d a multiple of 8, the router (d, E) fp32 with E a multiple of 4 up to
    ``MAX_E``, 1 <= k <= min(E, ``MAX_K``), T * k up to ``MAX_ROWS``."""
    if x.ndim != 2 or router.ndim != 2 or router.shape[0] != x.shape[1]:
        raise ValueError(f"moe_route: x {tuple(x.shape)} must be (T, d) and the router "
                         f"{tuple(router.shape)} (d, E)")
    (T, d), E = x.shape, router.shape[1]
    if d % 8 or E % 4 or not 0 < E <= MAX_E or not 1 <= k <= min(E, MAX_K) or T * k > MAX_ROWS:
        raise ValueError(f"moe_route: T {T}, d {d}, E {E}, k {k} (d a multiple of 8, E a "
                         f"multiple of 4 up to {MAX_E}, k from 1 to min(E, {MAX_K}), T * k up "
                         f"to {MAX_ROWS})")
    if x.dtype != torch.bfloat16 or router.dtype != torch.float32:
        raise TypeError("moe_route: x must be bfloat16 and the router float32 on the card")
    return T, d, E


def check_combine_args(out, w, order, k: int, shared=None) -> tuple:
    """(T, d) of a combine the kernel takes, or raise: out (T*k, d) bf16 with
    d a multiple of 8, w (T*k,) bf16, order (T*k,) int32, shared (T, d) bf16
    or None; 1 <= k <= ``MAX_K``, T * k up to ``MAX_ROWS``."""
    if out.ndim != 2 or not 1 <= k <= MAX_K or out.shape[0] % k:
        raise ValueError(f"moe_combine: out {tuple(out.shape)} must be (T * k, d), k {k} "
                         f"from 1 to {MAX_K}")
    (Tk, d), T = out.shape, out.shape[0] // k
    want = {"w": (w, (Tk,)), "order": (order, (Tk,))}
    if shared is not None:
        want["shared"] = (shared, (T, d))
    bad = {n: tuple(t.shape) for n, (t, s) in want.items() if tuple(t.shape) != s}
    if bad or d % 8 or Tk > MAX_ROWS:
        raise ValueError(f"moe_combine: shapes {bad or ''} out {tuple(out.shape)} (d a multiple "
                         f"of 8, T * k up to {MAX_ROWS})")
    if (out.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 or order.dtype != torch.int32
            or (shared is not None and shared.dtype != torch.bfloat16)):
        raise TypeError("moe_combine: out, w and shared must be bfloat16 and order int32 on "
                        "the card")
    return T, d
