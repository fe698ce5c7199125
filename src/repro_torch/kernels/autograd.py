"""Gradients through the forward kernels.

The CUDA wrappers write into fresh tensors through ctypes, so autograd
cannot see through them: without this module a ``loss.backward()`` on the
card would silently drop every gradient that flows through a norm, an
attention or a scan.  :class:`KernelFunction` wraps a forward kernel in a
``torch.autograd.Function``: its forward launches the hand kernel, and its
backward recomputes the plain version from the saved inputs under
``torch.enable_grad()`` and returns ``torch.autograd.grad`` of it.  That is
the counterpart of the JAX package, whose models are pure jnp that XLA
differentiates (it has no backward kernel); hand-written backward kernels
are later work.

The saved inputs are the tensors the caller passed (strided views stay
views), and each gradient comes back in its input's own dtype and shape.
An output whose gradient is unused (the SSD scan's final state in training)
receives ``None``.
"""
from __future__ import annotations

import torch


#: profiler range around each plain-recompute backward (``chip_smoke.py
#: --profile`` reads its device time as the backward's share of a step)
BACKWARD_SPAN = "KernelFunction.backward"


class KernelFunction(torch.autograd.Function):
    """``KernelFunction.apply(kernel, plain, kwargs, *tensors)``: forward
    ``kernel(*tensors, **kwargs)``, backward through ``plain(*tensors,
    **kwargs)`` recomputed.  Both return a tensor or a tuple of tensors."""

    @staticmethod
    def forward(ctx, kernel, plain, kwargs, *tensors):
        ctx.plain, ctx.kwargs = plain, kwargs
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*tensors)
        return kernel(*tensors, **kwargs)

    @staticmethod
    def backward(ctx, *grad_outs):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[3:]
        with torch.profiler.record_function(BACKWARD_SPAN), torch.enable_grad():
            inputs = [t.detach().requires_grad_(need) for t, need in zip(saved, needs)]
            outs = ctx.plain(*inputs, **ctx.kwargs)
            outs = outs if isinstance(outs, tuple) else (outs,)
            pairs = [(o, g) for o, g in zip(outs, grad_outs)
                     if g is not None and o.requires_grad]
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad([o for o, _ in pairs], wanted,
                                             [g for _, g in pairs], allow_unused=True)
                         if pairs and wanted else [None] * len(wanted))
        return (None, None, None, *[next(grads) if t.requires_grad else None
                                    for t in inputs])


def needs_grad(*tensors) -> bool:
    """True when autograd records an op on ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
