"""Gradient compression with error feedback (the AVEC slow-link rule applied
to training: gradient traffic over the slow hop is int8).

A copy of ``repro/optim/compression.py``.  Every leaf quantizes through
``kernels.comm_quant`` (the hand-written quantize/dequantize kernels on the
card, their plain versions on the CPU), the one implementation the wire
codec shares.  ``ErrorFeedback`` keeps the quantization residual and folds
it into the next step's gradients (Seide et al. 1-bit SGD / EF-SGD).
``compressed_psum`` has the numerics of quantize -> all-reduce ->
dequantize over a ``torch.distributed`` process group, where the reference
takes a shard_map axis name: like the reference, it all-reduces the
dequantized fp32 values, and the wire saving is accounted analytically
(``compress_tree``'s byte count, ``distributed.collectives.dcn_wire_bytes``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.kernels.comm_quant import dequantize_leaf, quantize_leaf
from repro_torch.utils import dtype_name, tree_flatten, tree_map, tree_unflatten


def _is_entry(x) -> bool:
    return isinstance(x, dict) and "q" in x


def compress_tree(tree):
    """tree -> (quantized tree of {"q", "s", "shape", "dtype"}, wire_bytes
    int: one byte per element plus four per row scale)."""
    wire = 0
    flat, tdef = tree_flatten(tree)
    qs = []
    for leaf in flat:
        q, s = quantize_leaf(leaf)
        wire += q.numel() * 1 + s.numel() * 4
        qs.append({"q": q, "s": s, "shape": tuple(leaf.shape), "dtype": dtype_name(leaf)})
    return tree_unflatten(tdef, qs), wire


def decompress_tree(ctree):
    def dq(entry):
        return dequantize_leaf(entry["q"], entry["s"], entry["shape"],
                               getattr(torch, entry["dtype"]))
    return tree_map(dq, ctree, is_leaf=_is_entry)


class ErrorFeedback:
    """Stateful EF compressor for a gradient tree.  ``compress`` folds the
    gradient into the residual IN PLACE (the residual passed in becomes the
    new residual), so a full-width model keeps one fp32 residual tree, not
    two."""

    @staticmethod
    def init(grads):
        return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                        grads)

    @staticmethod
    @torch.no_grad()
    def compress(grads, residual):
        """Returns (quantized-dequantized grads in their dtypes, new residual)."""
        def one(g, e):
            corrected = e.add_(g)                       # g.float() + e
            q, s = quantize_leaf(corrected)
            deq = dequantize_leaf(q, s, corrected.shape, torch.float32)
            out = deq.to(g.dtype)
            corrected.sub_(deq)                         # corrected - deq
            return out, corrected
        flat_g, tdef = tree_flatten(grads)
        flat_e = tree_flatten(residual)[0]
        out = [one(g, e) for g, e in zip(flat_g, flat_e)]
        return (tree_unflatten(tdef, [o[0] for o in out]),
                tree_unflatten(tdef, [o[1] for o in out]))


@torch.no_grad()
def compressed_psum(tree, group):
    """int8 numerics of a sum over ``group`` (a ``torch.distributed``
    process group): each rank quantizes and dequantizes its leaf, the
    dequantized fp32 values are all-reduced, and the sum comes back in the
    leaf's dtype."""
    def one(x):
        q, s = quantize_leaf(x)
        deq = dequantize_leaf(q, s, x.shape, torch.float32)
        dist.all_reduce(deq, group=group)
        return deq.to(x.dtype)
    return tree_map(one, tree)
