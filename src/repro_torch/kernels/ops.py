"""Layout wrappers around the kernels, in the models' layouts.

Each op takes model-native layouts, views them in the kernel layout (no
copy: the kernels take strides), and dispatches by the tensor's device: a
CUDA tensor goes to the hand-written kernel, which launches or raises; a
CPU tensor goes to the plain version in ``kernels/ref.py``.  There is no
fallback from CUDA to the plain version.  Checks that hold a kernel against
its plain version on the card force the plain one with ``impl="ref"`` or
:func:`force_impl`; the main path never does.  Each kernel module holds the
CUDA wrapper (``*_cuda``, which counts its launches) and the plain version
(``*_plain``, from ``kernels/ref.py``).
"""
from __future__ import annotations

import contextlib

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rmsnorm as _rms

_KERNELS = {"rmsnorm": _rms, "flash_attention": _fa, "decode_attention": _dec}
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
    return {name: mod.launches for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.launches = 0


# ---------------------------------------------------------------------------

def flash_attention(q, k, v, *, causal: bool = True, impl: str | None = None):
    """Model layout q: (B,S,H,D), k/v: (B,T,K,D) -> (B,S,H,D)."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if not _use_kernel(q, impl):
        return _fa.flash_attention_plain(qt, kt, vt, causal=causal).transpose(1, 2)
    out = q.new_empty(q.shape)
    _fa.flash_attention_cuda(qt, kt, vt, causal=causal, out=out.transpose(1, 2))
    return out


def decode_attention(q, k, v, kv_len, *, impl: str | None = None):
    """Model layout q: (B,1,H,D), k/v: (B,S,K,D), kv_len (B,) -> (B,1,H,D)."""
    B, _, H, D = q.shape
    K = k.shape[2]
    qt = q.reshape(B, K, H // K, D)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    if not _use_kernel(q, impl):
        return _dec.decode_attention_plain(qt, kt, vt, kv_len).reshape(B, 1, H, D)
    return _dec.decode_attention_cuda(qt, kt, vt, kv_len).reshape(B, 1, H, D)


def rmsnorm(x, scale, *, eps: float = 1e-6, impl: str | None = None):
    if not _use_kernel(x, impl):
        return _rms.rmsnorm_plain(x, scale, eps=eps)
    return _rms.rmsnorm_cuda(x, scale, eps=eps)
