"""Parameter specification trees, initialization, and carrying weights over.

Every model module declares its parameters as a nested dict of ``ParamSpec``
(shape, logical axes, initializer, scale, dtype), as the JAX package does.
``init_params`` materializes a spec tree with a seeded ``torch.Generator``
per leaf (same shapes, scales and dtypes as the reference; the random bits
differ, so equivalence tests carry the reference's own weights across with
:func:`from_numpy_tree`).  The two Mamba initializers are deterministic
numpy, copied from the reference, and give bit-equal leaves.
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
    init: str = "normal"   # normal | zeros | ones | mamba_dt_bias | mamba_a_log
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
        elif spec.init == "mamba_dt_bias":
            # dt bias such that softplus(dt_bias) spans [1e-3, 1e-1] (Mamba
            # init), spread over every element of the (stacked) leaf
            n = int(np.prod(spec.shape))
            dt = np.exp(np.linspace(np.log(1e-3), np.log(1e-1), max(n, 1)))
            inv = dt + np.log(-np.expm1(-dt))
            leaves.append(torch.from_numpy(inv.reshape(spec.shape)).to(dtype).to(device))
        elif spec.init == "mamba_a_log":
            n_last = spec.shape[-1]
            a = np.broadcast_to(np.arange(1, n_last + 1, dtype=np.float32), spec.shape)
            leaves.append(torch.from_numpy(np.log(a)).to(dtype).to(device))
        else:
            raise ValueError(f"unknown init {spec.init!r}")
    return tree_unflatten(treedef, leaves)


def abstract_params(specs, param_dtype=torch.bfloat16):
    """The spec tree as empty tensors on the ``meta`` device: shapes and
    dtypes with no storage (a checkpoint template; the reference's
    ``abstract_params``)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype or param_dtype, device="meta"),
                    specs, is_leaf=is_spec)


def from_numpy_tree(tree: Any, device="cuda") -> Any:
    """The function that carries weights across: the reference's parameter
    tree (numpy leaves, ml_dtypes bf16 included, or this port's host
    arrays) -> the same tree of tensors on ``device``, with the same names
    and layouts.  The executor's ``put_model`` goes through it too."""
    device = torch.device(device)
    return tree_map(lambda x: to_tensor(x, device)
                    if isinstance(x, (np.ndarray, np.generic, torch.Tensor)) else x, tree)


def param_axes(specs):
    """Tree of logical-axis tuples, mirroring the spec tree."""
    return tree_map(lambda s: tuple(s.axes), specs, is_leaf=is_spec)


def cast_tree(tree, dtype):
    return tree_map(lambda x: x.to(dtype), tree)
