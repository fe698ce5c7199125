"""Layout wrappers around the kernels, in the models' layouts.

Each op takes model-native layouts, views them in the kernel layout (no
copy: the kernels take strides), and dispatches by the tensor's device: a
CUDA tensor goes to the hand-written kernel, which launches or raises; a
CPU tensor goes to the plain version in ``kernels/ref.py``.  There is no
fallback from CUDA to the plain version.  Checks that hold a kernel against
its plain version on the card force the plain one with ``impl="ref"`` or
:func:`force_impl`; the main path never does.  A DTensor (the dry-run's) runs
attention shard by shard (``distributed/dtensor.py``), each shard through
this same dispatch.  Each kernel module holds the
CUDA wrapper (``*_cuda``, which counts its launches through ``_build``) and
the plain version (``*_plain``, from ``kernels/ref.py``).  Where autograd records the call
(an input requires grad), ``rmsnorm``, ``flash_attention`` and ``ssd_scan``
on the card go through :class:`~repro_torch.kernels.autograd.KernelFunction`:
forward through the kernel, backward through the recomputed plain version.
In a traced call (``obs.trace``) each op counts its calls and host time
into the call's wrapper counters.
"""
from __future__ import annotations

import contextlib
import time
from functools import partial, wraps

import torch

from repro_torch.distributed.dtensor import attention_per_shard, is_dtensor
from repro_torch.kernels import _build
from repro_torch.kernels import comm_quant as _cq
from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mamba_step as _mstep
from repro_torch.kernels import moe_experts as _moe
from repro_torch.kernels import moe_route as _mroute
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels.autograd import KernelFunction, needs_grad
from repro_torch.obs import trace as _trace

#: what :func:`launch_counts` reports: each kernel, then the branches of the
#: SSD scan (``ssd_scan.tensor_core_branch``) and of the int8 quantize
#: (``comm_quant.quantize_plan``)
_COUNTED = ("rmsnorm", "flash_attention", "decode_attention", "ssd_scan", "moe_experts",
           "mamba_step", "moe_route", "moe_combine", "quantize_int8", "dequantize_int8",
           "ssd_scan_tc", "ssd_scan_simt", "quantize_int8_vec", "quantize_int8_scalar")
_forced: str | None = None


@contextlib.contextmanager
def force_impl(impl: str):
    """Run the enclosed model code through ``impl`` ("ref" or "cuda")."""
    global _forced
    prev, _forced = _forced, impl
    try:
        yield
    finally:
        _forced = prev


def _use_kernel(x, impl: str | None) -> bool:
    impl = impl or _forced
    if impl == "ref":
        return False
    if impl not in (None, "cuda"):
        raise ValueError(f"unknown impl {impl!r} (expected 'cuda' or 'ref')")
    if x.is_cuda:
        return True
    if impl == "cuda":
        raise RuntimeError("impl='cuda' needs CUDA tensors")
    return False


def launch_counts() -> dict[str, int]:
    """Each kernel's launches by its wrapper, and the calls per branch of
    the kernels that have two: ``ssd_scan_tc`` (the tensor-core kernels)
    and ``ssd_scan_simt`` (the CUDA-core kernel); ``quantize_int8_vec``
    (rows in 16-byte vectors) and ``quantize_int8_scalar`` (the scalar
    loop).  Launches inside a CUDA graph capture are not counted, nor are a
    replayed graph's kernels (``_build.count``)."""
    return {name: _build.launches[name] for name in _COUNTED}


def reset_launch_counts() -> None:
    _build.launches.clear()


def _counted(op):
    """The op, counting its calls and host time into the traced call's
    :class:`~repro_torch.obs.trace.Stages` on this thread, if there is one."""
    name = op.__name__

    @wraps(op)
    def counted(*args, **kwargs):
        stages = _trace.CURRENT.stages
        if stages is None:
            return op(*args, **kwargs)
        t0 = time.perf_counter_ns()
        try:
            return op(*args, **kwargs)
        finally:
            stages.wrapper(name, t0)
    return counted


# ---------------------------------------------------------------------------

@_counted
def flash_attention(q, k, v, *, causal: bool = True, scale: float | None = None,
                    impl: str | None = None):
    """Model layout q: (B,S,H,D), k/v: (B,T,K,D) -> (B,S,H,D); the scores
    scaled by ``scale`` (1/sqrt(D) when None).  A DTensor goes shard by
    shard, each shard through this dispatch."""
    if is_dtensor(q):
        return attention_per_shard(partial(flash_attention, causal=causal, scale=scale,
                                           impl=impl), q, k, v)
    if not _use_kernel(q, impl):
        return _flash_plain(q, k, v, causal=causal, scale=scale)
    if needs_grad(q, k, v):
        return KernelFunction.apply(_flash_kernel, _flash_plain,
                                    {"causal": causal, "scale": scale}, q, k, v)
    return _flash_kernel(q, k, v, causal=causal, scale=scale)


def _flash_plain(q, k, v, *, causal, scale):
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return _fa.flash_attention_plain(qt, kt, vt, causal=causal, scale=scale).transpose(1, 2)


def _flash_kernel(q, k, v, *, causal, scale):
    out = q.new_empty(q.shape)
    _fa.flash_attention_cuda(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                             causal=causal, scale=scale, out=out.transpose(1, 2))
    return out


@_counted
def decode_attention(q, k, v, kv_len, *, scale: float | None = None, impl: str | None = None):
    """Model layout q: (B,1,H,D), k/v: (B,S,K,D), kv_len (B,) -> (B,1,H,D);
    the scores scaled by ``scale`` (1/sqrt(D) when None).  A DTensor goes
    shard by shard, each shard through this dispatch."""
    if is_dtensor(q):
        return attention_per_shard(partial(decode_attention, scale=scale, impl=impl),
                                   q, k, v, kv_len)
    B, _, H, D = q.shape
    K = k.shape[2]
    qt = q.reshape(B, K, H // K, D)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    if not _use_kernel(q, impl):
        return _dec.decode_attention_plain(qt, kt, vt, kv_len, scale=scale).reshape(B, 1, H, D)
    return _dec.decode_attention_cuda(qt, kt, vt, kv_len, scale=scale).reshape(B, 1, H, D)


@_counted
def rmsnorm(x, scale, *, eps: float = 1e-6, impl: str | None = None):
    if not _use_kernel(x, impl):
        return _rms.rmsnorm_plain(x, scale, eps=eps)
    if needs_grad(x, scale):
        return KernelFunction.apply(_rms.rmsnorm_cuda, _rms.rmsnorm_plain, {"eps": eps},
                                    x, scale)
    return _rms.rmsnorm_cuda(x, scale, eps=eps)


@_counted
def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int = 256, impl: str | None = None):
    """Model layout x: (B,S,H,P), dt: (B,S,H), A: (H,), Bm/Cm: (B,S,G,N).
    Returns (y (B,S,H,P), final_state (B,H,P,N) fp32).  The chunk length
    follows the JAX package's wrapper: S itself when it divides S, else
    ``chunk`` with a ragged last chunk (zero-padded by the plain version,
    masked inside the kernel)."""
    L = ssd_chunk_len(x.shape[1], chunk)
    if not _use_kernel(x, impl):
        return _ssd.ssd_scan_plain(x, dt, A, Bm, Cm, L)
    if needs_grad(x, dt, A, Bm, Cm):
        return KernelFunction.apply(_ssd.ssd_scan_cuda, _ssd.ssd_scan_plain, {"chunk": L},
                                    x, dt, A, Bm, Cm)
    return _ssd.ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=L)


@_counted
def moe_experts(x, w_gate, w_up, w_down, offs, *, impl: str | None = None):
    """x: (R, d) rows sorted by expert, expert e's ending at row ``offs[e]``
    ((E,) int32 on x's device); w_gate, w_up (E, d, f), w_down (E, f, d) ->
    (R, d): each row's expert's SwiGLU (``kernels/moe_experts.py``)."""
    if not _use_kernel(x, impl):
        return _moe.moe_experts_plain(x, w_gate, w_up, w_down, offs)
    return _moe.moe_experts_cuda(x, w_gate, w_up, w_down, offs)


@_counted
def moe_route(x, router, k: int, *, impl: str | None = None):
    """A dropless MoE's routing: x (T, d) the tokens, router (d, E) fp32 ->
    (rows (T*k, d): x's rows in stable expert order, ends (E,) int32: each
    expert's end row, w (T*k,): the renormalised top-k probabilities in x's
    dtype in the same order, order (T*k,) int32: row i is assignment
    ``order[i] = t*k + j``), for ``moe_experts`` and ``moe_combine``
    (``kernels/moe_route.py``; T*k up to its ``MAX_ROWS``)."""
    if not _use_kernel(x, impl):
        return _mroute.moe_route_plain(x, router, k)
    return _mroute.moe_route_cuda(x, router, k)


@_counted
def moe_combine(out, w, order, k: int, shared=None, *, impl: str | None = None):
    """out (T*k, d) the experts' rows in ``moe_route``'s order, w and order
    as it left them, shared (T, d) the shared expert's output or None ->
    (T, d): each token's k rows weighted and summed, plus ``shared``."""
    if not _use_kernel(out, impl):
        return _mroute.moe_combine_plain(out, w, order, k, shared)
    return _mroute.moe_combine_cuda(out, w, order, k, shared)


@_counted
def mamba_step(u, z, x, Bm, Cm, p: dict, conv, ssm, *, eps: float, impl: str | None = None):
    """A Mamba-2 layer's decode step between its input projections and
    ``wo``: u (B,1,d) the layer's normed input, z and x (B,1,di), Bm and Cm
    (B,1,G*N) as the projections leave them; ``p`` the layer's parameters
    as stored (``models.mamba.mamba_specs``); the cache leaves conv
    (B,ck-1,conv_dim) and ssm (B,H,P,N) fp32 are written in place ->
    rmsnorm(y * silu(z)) * norm_scale (B,1,di) in z's dtype, ready for
    ``wo`` (``kernels/mamba_step.py``)."""
    if not _use_kernel(z, impl):
        return _mstep.mamba_step_plain(u, z, x, Bm, Cm, p, conv, ssm, eps=eps)
    return _mstep.mamba_step_cuda(u, z, x, Bm, Cm, p, conv, ssm, eps=eps)


def ssd_chunk_len(S: int, chunk: int) -> int:
    """The chunk length the scan runs at (the JAX package's wrapper's rule):
    S itself when it fits in ``chunk`` (and so divides itself), else
    ``chunk``, with a ragged last chunk when it does not divide S."""
    return min(chunk, S) if S % min(chunk, S) == 0 else chunk


@_counted
def quantize_int8(x, *, impl: str | None = None):
    """x: (N, D) -> (q int8 (N, D), scale f32 (N, 1)); the kernel reads f32
    or bf16 (exact in fp32), the plain version casts to fp32."""
    if not _use_kernel(x, impl):
        return _cq.quantize_int8_plain(x)
    return _cq.quantize_int8_cuda(x)


@_counted
def dequantize_int8(q, scale, dtype=torch.float32, *, impl: str | None = None):
    """q (N, D) int8, scale (N, 1) f32 -> (N, D) ``dtype``."""
    if not _use_kernel(q, impl):
        return _cq.dequantize_int8_plain(q, scale, dtype)
    return _cq.dequantize_int8_cuda(q, scale, dtype)
