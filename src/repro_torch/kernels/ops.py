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
CUDA wrapper (``*_cuda``, which counts its launches) and the plain version
(``*_plain``, from ``kernels/ref.py``).  Where autograd records the call
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
from repro_torch.kernels import comm_quant as _cq
from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels.autograd import KernelFunction, needs_grad
from repro_torch.obs import trace as _trace

# kernel name -> (module, the module's launch counter)
_KERNELS = {"rmsnorm": (_rms, "launches"), "flash_attention": (_fa, "launches"),
            "decode_attention": (_dec, "launches"), "ssd_scan": (_ssd, "launches"),
            "quantize_int8": (_cq, "quantize_launches"),
            "dequantize_int8": (_cq, "dequantize_launches")}
# branch of a kernel -> (module, its launch counter): the SSD scan's calls
# by the kernel they took (``ssd_scan.tensor_core_branch``), the int8
# quantize's by its path (``comm_quant.quantize_plan``)
_BRANCHES = {"ssd_scan_tc": (_ssd, "launches_tc"), "ssd_scan_simt": (_ssd, "launches_simt"),
             "quantize_int8_vec": (_cq, "quantize_launches_vec"),
             "quantize_int8_scalar": (_cq, "quantize_launches_scalar")}
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
    return {name: getattr(mod, attr) for name, (mod, attr) in _KERNELS.items()}


def branch_counts() -> dict[str, int]:
    """Calls per branch of the kernels that have two: ``ssd_scan_tc`` (the
    tensor-core kernels) and ``ssd_scan_simt`` (the CUDA-core kernel);
    ``quantize_int8_vec`` (rows in 16-byte vectors) and
    ``quantize_int8_scalar`` (the scalar loop)."""
    return {name: getattr(mod, attr) for name, (mod, attr) in _BRANCHES.items()}


def reset_launch_counts() -> None:
    for mod, attr in (*_KERNELS.values(), *_BRANCHES.values()):
        setattr(mod, attr, 0)


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
def flash_attention(q, k, v, *, causal: bool = True, impl: str | None = None):
    """Model layout q: (B,S,H,D), k/v: (B,T,K,D) -> (B,S,H,D).  A DTensor
    goes shard by shard, each shard through this dispatch."""
    if is_dtensor(q):
        return attention_per_shard(partial(flash_attention, causal=causal, impl=impl), q, k, v)
    if not _use_kernel(q, impl):
        return _flash_plain(q, k, v, causal=causal)
    if needs_grad(q, k, v):
        return KernelFunction.apply(_flash_kernel, _flash_plain, {"causal": causal}, q, k, v)
    return _flash_kernel(q, k, v, causal=causal)


def _flash_plain(q, k, v, *, causal):
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return _fa.flash_attention_plain(qt, kt, vt, causal=causal).transpose(1, 2)


def _flash_kernel(q, k, v, *, causal):
    out = q.new_empty(q.shape)
    _fa.flash_attention_cuda(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                             causal=causal, out=out.transpose(1, 2))
    return out


@_counted
def decode_attention(q, k, v, kv_len, *, impl: str | None = None):
    """Model layout q: (B,1,H,D), k/v: (B,S,K,D), kv_len (B,) -> (B,1,H,D).
    A DTensor goes shard by shard, each shard through this dispatch."""
    if is_dtensor(q):
        return attention_per_shard(partial(decode_attention, impl=impl), q, k, v, kv_len)
    B, _, H, D = q.shape
    K = k.shape[2]
    qt = q.reshape(B, K, H // K, D)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    if not _use_kernel(q, impl):
        return _dec.decode_attention_plain(qt, kt, vt, kv_len).reshape(B, 1, H, D)
    return _dec.decode_attention_cuda(qt, kt, vt, kv_len).reshape(B, 1, H, D)


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
