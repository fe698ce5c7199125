"""The routed experts' SwiGLU over rows grouped by expert, on the card
through ``torch._grouped_mm`` (the grouped GEMM PyTorch builds from CUTLASS
for sm90).

Replaces no TPU kernel: the JAX package runs its MoE as batched products
over an (E, C, d) capacity buffer, left to XLA (``repro/models/moe.py``),
and the port's capacity dispatch keeps that.  A dropless MoE
(``MoEConfig.dropless``) sorts its T*k assignments by expert into one
(T*k, d) buffer with each expert's end row in ``offs``, on the device: no
count is read back to the host, so a decode that calls it can be captured
as a CUDA graph.  Each grouped product computes only the groups that hold
rows, so a B-1 decode (k distinct experts, one row each) reads k experts'
weights and not all E: there it is bound by those bytes (k * 3 * d * f
elements); a prefill of hundreds of tokens reads every expert once and is
bound by its products.  Three grouped products (gate, up, down) and the
gate's SiLU times the up in between, all in bf16 with fp32 accumulation.

``moe_experts_cuda`` launches them (or raises); :func:`moe_experts_plain`
(from ``kernels/ref.py``) is the plain version that ``ops.moe_experts``
takes for tensors on the CPU.  A call counts as one ``moe_experts`` launch
(``_build.count``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.ref import moe_experts as moe_experts_plain

__all__ = ["moe_experts_cuda", "moe_experts_plain"]


def moe_experts_cuda(x, w_gate, w_up, w_down, offs):
    """x: (R, d) bf16 rows grouped by expert; w_gate, w_up: (E, d, f) and
    w_down: (E, f, d) bf16; offs: (E,) int32, expert e's rows ending at
    ``offs[e]`` and ``offs[E-1] == R``, on the card -> (R, d) bf16."""
    _build.require_cuda("moe_experts", x, w_gate, w_up, w_down, offs)
    E, d, f = w_gate.shape
    if (x.ndim != 2 or x.shape[1] != d or tuple(w_up.shape) != (E, d, f)
            or tuple(w_down.shape) != (E, f, d) or tuple(offs.shape) != (E,)):
        raise ValueError(f"moe_experts: shapes x {tuple(x.shape)} w_gate {tuple(w_gate.shape)} "
                         f"w_up {tuple(w_up.shape)} w_down {tuple(w_down.shape)} "
                         f"offs {tuple(offs.shape)}")
    if not (x.dtype == w_gate.dtype == w_up.dtype == w_down.dtype == torch.bfloat16):
        raise TypeError("moe_experts: x and the weights must be bfloat16 on the card")
    if offs.dtype != torch.int32:
        raise TypeError("moe_experts: offs must be int32")
    x = _build.aligned_rows(x)
    h = F.silu(torch._grouped_mm(x, w_gate, offs=offs)) * torch._grouped_mm(x, w_up, offs=offs)
    out = torch._grouped_mm(h, w_down, offs=offs)
    _build.count("moe_experts")
    return out
