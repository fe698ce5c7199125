"""Small shared utilities: tree helpers, the numpy <-> torch bridge, devices.

Tree helpers follow ``jax.tree_util`` semantics so that both packages walk a
parameter tree in the same order and name its leaves the same way:

* dict keys are visited **sorted** (``torch.utils._pytree`` keeps insertion
  order, so it is not used here), lists and tuples in order, and ``None`` is
  an empty subtree;
* a path renders like ``jax.tree_util.keystr``, e.g.
  ``['blocks']['layers'][0]['attn']['wq']``.

The bridge carries bfloat16 without ``ml_dtypes``: on the host a bf16 leaf is
a :class:`BF16Array`, an ndarray of the raw 2-byte payload whose dtype name is
rendered as ``"bfloat16"``.  Arrays that do carry an ``ml_dtypes`` bfloat16
dtype (the JAX package's host arrays) are accepted as they are.
"""
from __future__ import annotations

import warnings
from typing import Any, Callable, Optional

import numpy as np
import torch


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


# ---------------------------------------------------------------------------
# Tree helpers (jax.tree_util order and key rendering)
# ---------------------------------------------------------------------------

def _children(node):
    """-> (kind, keys, children) for an inner node, or None for a leaf."""
    if isinstance(node, dict):
        keys = sorted(node)
        return "dict", keys, [node[k] for k in keys]
    if isinstance(node, (list, tuple)):
        return type(node).__name__, list(range(len(node))), list(node)
    if node is None:
        return "none", [], []
    return None


def tree_flatten_with_path(tree: Any, is_leaf: Optional[Callable] = None):
    """-> ([(path, leaf), ...], treedef).  ``path`` is a tuple of dict keys
    and sequence indices; ``treedef`` is a hashable structure description."""
    out: list = []

    def walk(node, path):
        if is_leaf is not None and is_leaf(node):
            out.append((path, node))
            return ("leaf",)
        ch = _children(node)
        if ch is None:
            out.append((path, node))
            return ("leaf",)
        kind, keys, kids = ch
        sub = tuple(walk(c, path + (k,)) for k, c in zip(keys, kids))
        return (kind, tuple(keys) if kind == "dict" else len(keys), sub)

    treedef = walk(tree, ())
    return out, treedef


def tree_flatten(tree: Any, is_leaf: Optional[Callable] = None):
    flat, treedef = tree_flatten_with_path(tree, is_leaf)
    return [leaf for _, leaf in flat], treedef


def tree_leaves(tree: Any, is_leaf: Optional[Callable] = None) -> list:
    return tree_flatten(tree, is_leaf)[0]


def tree_leaves_with_path(tree: Any, is_leaf: Optional[Callable] = None) -> list:
    return tree_flatten_with_path(tree, is_leaf)[0]


def tree_unflatten(treedef, leaves) -> Any:
    it = iter(leaves)

    def build(td):
        kind = td[0]
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        kids = [build(c) for c in td[2]]
        if kind == "dict":
            return dict(zip(td[1], kids))
        return tuple(kids) if kind == "tuple" else kids

    return build(treedef)


def tree_flatten_up_to(treedef, tree: Any) -> list:
    """The subtrees of ``tree`` at the leaf positions of ``treedef``
    (``jax.tree_util.PyTreeDef.flatten_up_to``): an optimizer state whose
    per-parameter entries are themselves dicts flattens to one entry per
    parameter."""
    out: list = []

    def walk(td, node):
        kind = td[0]
        if kind == "leaf":
            out.append(node)
            return
        if kind == "none":
            return
        ch = _children(node)
        if ch is None or ch[0] != kind or (
                tuple(ch[1]) if kind == "dict" else len(ch[1])) != td[1]:
            raise ValueError("tree_flatten_up_to: tree does not match the structure")
        for sub, kid in zip(td[2], ch[2]):
            walk(sub, kid)

    walk(treedef, tree)
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any,
             is_leaf: Optional[Callable] = None) -> Any:
    """Map ``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, which must share its structure).  Dicts come back with their
    keys in sorted order, as ``jax.tree_util.tree_map`` returns them."""
    leaves, treedef = tree_flatten(tree, is_leaf)
    others = [tree_flatten(r, is_leaf) for r in rest]
    for _, td in others:
        if td != treedef:
            raise ValueError("tree_map: trees differ in structure")
    mapped = [fn(*xs) for xs in zip(leaves, *(o[0] for o in others))]
    return tree_unflatten(treedef, mapped)


def keystr(path) -> str:
    """``jax.tree_util.keystr`` rendering: ``['a'][0]['b']``."""
    return "".join(f"[{k!r}]" for k in path)


# ---------------------------------------------------------------------------
# numpy <-> torch bridge
# ---------------------------------------------------------------------------

class BF16Array(np.ndarray):
    """bfloat16 on the host without ``ml_dtypes``: uint16 storage of the raw
    bf16 bits.  ``dtype_name`` renders it as ``"bfloat16"`` so the wire and
    the model fingerprint name it as the JAX package does."""


def is_bf16_host(x) -> bool:
    return isinstance(x, BF16Array) or (
        isinstance(x, np.ndarray) and x.dtype.name == "bfloat16")


def dtype_name(x) -> str:
    """numpy-style dtype name of a tensor or host array (``float32``,
    ``bfloat16``, ``int32``, ...)."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    if isinstance(x, BF16Array):
        return "bfloat16"
    return str(x.dtype)


def to_numpy(x):
    """Tensor (any device) -> host array; bf16 becomes a :class:`BF16Array`.
    Host arrays pass through; Python scalars become 0-d arrays."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(np.uint16).view(BF16Array)
        return t.cpu().numpy()
    if isinstance(x, np.ndarray):
        return x
    return np.asarray(x)


def to_tensor(x, device) -> torch.Tensor:
    """Host array (numpy, :class:`BF16Array` or ml_dtypes bf16) or tensor ->
    a tensor on ``device`` that owns its memory (never a view over a receive
    buffer)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    bf16 = is_bf16_host(x)
    a = np.asarray(x)
    if not a.flags.c_contiguous:
        a = a.copy(order="C")
    if bf16:
        a = a.view(np.int16)
    with warnings.catch_warnings():
        # read-only wire views are only read here: the copy below detaches
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(a)
    if bf16:
        t = t.view(torch.bfloat16)
    dev = torch.device(device)
    return t.clone() if dev.type == "cpu" else t.to(dev)


def to_numpy_tree(tree: Any) -> Any:
    return tree_map(to_numpy, tree)


def concat_rows(*xs) -> np.ndarray:
    """Host arrays stacked on axis 0 (bf16 host arrays stay bf16): one leaf
    of several coalesced requests, or of several shards' results."""
    out = np.concatenate([np.asarray(x) for x in xs], axis=0)
    return out.view(BF16Array) if isinstance(xs[0], BF16Array) else out


def resolve_device(device="cuda") -> torch.device:
    """The entry points' device rule: CUDA unless the caller asks for the
    CPU, and no quiet fallback when CUDA is missing."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return dev
