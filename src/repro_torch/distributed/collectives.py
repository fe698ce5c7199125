"""Gradient all-reduce with the AVEC slow-link rule: full precision over the
fast group, int8-compressed over the slow one.

A copy of ``repro/distributed/collectives.py`` on ``torch.distributed``.
The reference runs under shard_map over a mesh whose ``pod`` axis is the
slow (DCN) hop and whose other axes are fast (ICI); here the caller passes
the two process groups it built (``init_process_group`` with NCCL on the
card, gloo in the CPU tests).  A hop whose group is ``None`` is skipped, as
a mesh without that axis skips it.  Error feedback stays the caller's
(``optim.compression.ErrorFeedback``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.optim.compression import compressed_psum
from repro_torch.utils import tree_leaves, tree_map


@dataclass(frozen=True)
class ReduceGroups:
    """The mesh's axes as process groups: ``fast`` (intra-pod, full
    precision) and ``slow`` (the pod hop, int8 when compressing)."""
    fast: Optional[Any] = None
    slow: Optional[Any] = None


def _psum(tree, group):
    """Full-precision sum of every leaf over ``group`` (into copies)."""
    def one(x):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x
    return tree_map(one, tree)


def hierarchical_psum(tree, *, fast_group=None, slow_group=None, compress_slow: bool = True):
    """Sum over ``fast_group`` at full precision, then over ``slow_group``
    int8-compressed (if enabled).  A ``None`` group is skipped."""
    out = _psum(tree, fast_group) if fast_group is not None else tree
    if slow_group is None:
        return out
    return compressed_psum(out, slow_group) if compress_slow else _psum(out, slow_group)


@torch.no_grad()
def compressed_grad_allreduce(groups: ReduceGroups, grads, *, compress: bool = True):
    """All-reduce a gradient tree (already batch-reduced per rank) across
    both hops, compressing the slow one."""
    return hierarchical_psum(grads, fast_group=groups.fast, slow_group=groups.slow,
                             compress_slow=compress)


def dcn_wire_bytes(tree, compressed: bool) -> int:
    """Analytic wire accounting for the slow hop (per direction), exactly as
    the reference computes it: one fp32 scale per ``leaf.shape[0]`` for a
    leaf of rank >= 2.  ``comm_quant.leaf_rows``, which the quantizer uses,
    has ``prod(shape[:-1])`` rows, so for a rank-3 leaf this undercounts the
    scales; kept so, to match the reference."""
    total = 0
    for leaf in tree_leaves(tree):
        n = int(np.prod(leaf.shape)) if hasattr(leaf, "shape") else 0
        if compressed:
            rows = leaf.shape[0] if getattr(leaf, "ndim", 0) >= 2 else 1
            total += n * 1 + rows * 4          # int8 payload + fp32 scales
        else:
            total += n * 4
    return total
