"""Parameter specification trees, initialization, and carrying weights over.

Every model module declares its parameters as a nested dict of ``ParamSpec``
(shape, logical axes, initializer, scale, dtype), as the JAX package does.
``init_params`` materializes a spec tree with a seeded ``torch.Generator``
per leaf (same shapes, scales and dtypes as the reference; the random bits
differ, so equivalence tests carry the reference's own weights across with
:func:`from_numpy_tree`).
"""
from __future__ import annotations

import hashlib
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.utils import keystr, to_tensor, tree_flatten_with_path, tree_map, tree_unflatten


class ParamSpec(NamedTuple):
    shape: tuple
    axes: tuple            # logical axis names, len == len(shape); None entries replicate
    init: str = "normal"   # normal | zeros | ones
    scale: float = 0.02    # stddev for "normal"
    dtype: Optional[torch.dtype] = None  # override model param_dtype (e.g. fp32 norms)


def is_spec(x: Any) -> bool:
    return isinstance(x, ParamSpec)


def stack_specs(specs, n: int, axis_name: str = "layers"):
    """Prepend a stacking dimension (the stacked ``blocks`` layout)."""
    def f(s: ParamSpec) -> ParamSpec:
        return ParamSpec((n,) + tuple(s.shape), (axis_name,) + tuple(s.axes),
                         s.init, s.scale, s.dtype)
    return tree_map(f, specs, is_leaf=is_spec)


def _path_seed(path) -> int:
    return int.from_bytes(hashlib.sha256(keystr(path).encode()).digest()[:4], "little")


def init_params(specs, seed: int, param_dtype=torch.bfloat16, device="cuda"):
    """Materialize a spec tree on ``device``.  Each leaf draws from its own
    generator, seeded from ``seed`` and the leaf's path, so values do not
    depend on traversal order."""
    device = torch.device(device)
    flat, treedef = tree_flatten_with_path(specs, is_leaf=is_spec)
    leaves = []
    for path, spec in flat:
        dtype = spec.dtype or param_dtype
        if spec.init == "zeros":
            leaves.append(torch.zeros(spec.shape, dtype=dtype, device=device))
        elif spec.init == "ones":
            leaves.append(torch.ones(spec.shape, dtype=dtype, device=device))
        elif spec.init == "normal":
            g = torch.Generator(device=device)
            g.manual_seed((int(seed) << 32) ^ _path_seed(path))
            x = torch.randn(spec.shape, generator=g, dtype=torch.float32, device=device)
            leaves.append((x * spec.scale).to(dtype))
        else:
            raise ValueError(f"unknown init {spec.init!r}")
    return tree_unflatten(treedef, leaves)


def from_numpy_tree(tree: Any, device="cuda") -> Any:
    """The function that carries weights across: the reference's parameter
    tree (numpy leaves, ml_dtypes bf16 included, or this port's host
    arrays) -> the same tree of tensors on ``device``, with the same names
    and layouts.  The executor's ``put_model`` goes through it too."""
    device = torch.device(device)
    return tree_map(lambda x: to_tensor(x, device)
                    if isinstance(x, (np.ndarray, np.generic, torch.Tensor)) else x, tree)
