"""The benchmark's weights, drawn on the device from the seed.

A configuration's reference names every leaf of the port's parameter tree
in ``layout``: (path, shape, dtype, init).  All leaves of one kind come
from one draw of a ``torch.Generator`` on the device (one bf16 normal
draw, one float32 normal draw, one float32 uniform draw), each leaf a view
of its draw, scaled in place.  The same seed on the same device gives the
same bits, so the destination and the reference each draw their own copy
and the reference takes nothing from the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
DRAW = 2 ** 30


def torch_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed from the run's seed and a stream number."""
    return int(np.random.SeedSequence([seed % 2 ** 64, stream]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def _draw_kind(init) -> tuple:
    if init[0] in ("normal", "around"):
        return "normal"
    return "uniform"


def make(layout: list, seed: int, device) -> dict:
    """The parameter tree of ``layout`` (nested dicts, lists where a path
    holds an integer), on ``device``."""
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(torch_seed(seed, 1))
    groups: dict = {}
    for path, shape, dtype, init in layout:
        key = (dtype if init[0] == "normal" else "float32", _draw_kind(init))
        groups.setdefault(key, []).append((path, shape, dtype, init))
    tree: dict = {}
    for (dtype, kind), leaves in sorted(groups.items()):
        n = sum(math.prod(shape) for _, shape, _, _ in leaves)
        fn = torch.randn if kind == "normal" else torch.rand
        draw = torch.empty(n, dtype=_DTYPES[dtype], device=device)
        for i in range(0, n, DRAW):           # each draw under 2**31 elements
            draw[i:i + DRAW] = fn(min(DRAW, n - i), generator=g, dtype=_DTYPES[dtype],
                                  device=device)
        off = 0
        for path, shape, leaf_dtype, init in leaves:
            x = draw[off:off + math.prod(shape)].view(shape)
            off += math.prod(shape)
            _put(tree, path, _shape_init(x, init).to(_DTYPES[leaf_dtype]))
    return tree


def _shape_init(x, init):
    kind = init[0]
    if kind == "normal":                      # std * N(0, 1)
        return x.mul_(init[1])
    if kind == "around":                      # mean + std * N(0, 1)
        return x.mul_(init[2]).add_(init[1])
    if kind == "softplus_inv_loguniform":     # dt log-uniform, stored as softplus^-1(dt)
        lo, hi = math.log(init[1]), math.log(init[2])
        v = torch.exp(x * (hi - lo) + lo)
        return v + torch.log(-torch.expm1(-v))
    if kind == "log_uniform":                 # log of a value uniform in [lo, hi]
        return torch.log(x * (init[2] - init[1]) + init[1])
    raise ValueError(f"unknown init {init!r}")


def _put(tree, path, leaf) -> None:
    node = tree
    for k, nxt in zip(path[:-1], path[1:]):
        empty = [] if isinstance(nxt, int) else {}
        if isinstance(k, int):
            while len(node) <= k:
                node.append(None)
            if node[k] is None:
                node[k] = empty
            node = node[k]
        else:
            node = node.setdefault(k, empty)
    node[path[-1]] = leaf


def leaves(tree, path=()):
    """(path, leaf) pairs of a tree of dicts and lists, dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, t in enumerate(tree):
            yield from leaves(t, path + (i,))
    else:
        yield path, tree
