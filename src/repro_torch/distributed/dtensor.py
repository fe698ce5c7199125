"""The dry-run's DTensors, op by op where DTensor's own rules fall short.

The production dry-run (``launch/dryrun.py``) runs the model on meta
tensors placed as DTensors on a mesh.  Some ops have no DTensor rule in
every PyTorch version (views that merge sharded dims, ``index_copy_``, the
indexed read's backward); these helpers run them per shard under
``local_map``.  The function run on each shard is the caller's own
dispatching one, so a shard goes through ``kernels.ops``' device dispatch
as any tensor does: meta and CPU shards take the plain versions, CUDA
shards the kernels.
"""
from __future__ import annotations

import math
import sys


def is_dtensor(x) -> bool:
    """A DTensor.  One exists only once ``torch.distributed.tensor`` has
    been imported, so this reads ``sys.modules`` and imports nothing (the
    serving and training paths never pay for DTensor's import)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def attention_per_shard(fn, q, k, v, *rest):
    """``fn(q, k, v, *rest)`` on each device's shard (``local_map``): q
    keeps its placements over batch (dim 0) and heads (dim 2), k and v take
    the same ones, ``rest`` (per-row tensors) the batch's.  Where the mesh
    splits q's heads finer than the K kv heads divide, k and v are first
    repeated to one kv head per query head (the same dot products; GQA's
    head h reads kv head h // G), so every shard holds the kv heads its
    query heads read.  Attention goes through views that DTensor cannot
    shard (a flattened pair of sharded dims); per shard they are plain."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    pl = tuple(p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
               for p in q.placements)
    batch = tuple(p if p == Shard(0) else Replicate() for p in pl)
    head_split = math.prod(mesh.size(i) for i, p in enumerate(pl) if p == Shard(2))
    B, T, K, D = k.shape
    H = q.shape[2]
    if K % head_split:
        k, v = (t[:, :, :, None].expand(B, T, K, H // K, D).reshape(B, T, H, D) for t in (k, v))
    rest = [t if is_dtensor(t) else DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                                       run_check=False) for t in rest]
    per_shard = local_map(fn, out_placements=list(pl),
                          in_placements=(pl, pl, pl, *[batch] * len(rest)),
                          redistribute_inputs=True, device_mesh=mesh)
    return per_shard(q, k, v, *rest)


def index_copy_(x, dim: int, index, source):
    """``x.index_copy_(dim, index, source)`` (a decode step's cache write);
    a DTensor is written shard by shard, ``source`` taking its placements:
    some PyTorch versions have no DTensor rule for it."""
    if not is_dtensor(x):
        return x.index_copy_(dim, index, source)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    per_shard = local_map(lambda t, i, s: t.index_copy_(dim, i, s),
                          out_placements=list(x.placements),
                          in_placements=(x.placements, (Replicate(),) * mesh.ndim, x.placements),
                          redistribute_inputs=True, device_mesh=mesh)
    return per_shard(x, index, source)


def like_params(grads, params):
    """DTensor gradients placed as their parameters (reduced and sharded as
    GSPMD places a parameter's gradient), so the optimizer's arithmetic
    meets like placements: DTensor's propagation can leave a gradient
    sharded and partial over other mesh dims than its parameter, and some
    PyTorch versions cannot combine the two."""
    from repro_torch.utils import tree_map

    return tree_map(lambda g, p: g if tuple(g.placements) == tuple(p.placements)
                    else g.redistribute(p.device_mesh, p.placements), grads, params)


def embed_per_shard(tok, tokens):
    """``tok[tokens]`` shard by shard (``local_map``): each device reads its
    batch rows' tokens from the whole table (gathered), and its gradient of
    the table is a partial sum over the batch's mesh axes.  DTensor's own
    rules for the indexed read and its backward are not complete in every
    PyTorch version."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = tokens.device_mesh
    batch = tuple(p if p == Shard(0) else Replicate() for p in tokens.placements)
    per_shard = local_map(lambda t, i: t[i.long()], out_placements=list(batch),
                          in_placements=((Replicate(),) * mesh.ndim, batch),
                          in_grad_placements=(tuple(Partial() if p == Shard(0) else Replicate()
                                                    for p in batch), batch),
                          redistribute_inputs=True, device_mesh=mesh)
    return per_shard(tok, tokens)


def ssm_per_shard(fn, x, heads, n_groups: int, args, layouts, out_layouts):
    """``fn(*args)`` on each device's shards (``local_map``): the SSM
    mixer's causal conv, SSD scan and decode step, whose depthwise conv
    over sharded channels and flattening views DTensor cannot place.

    ``layouts`` give each argument's ``(batch dim, head dim)`` and
    ``out_layouts`` each output's, ``None`` where it has none.  The heads
    keep the mesh dims over which ``heads`` (a per-head parameter) is
    ``Shard(0)``, as the sharding rules placed it, provided B's and C's
    ``n_groups`` groups split with them (a lone group is replicated).  The
    batch splits over every other mesh dim over which x's is split or
    divides evenly, whatever placement DTensor's propagation left x in
    there (PyTorch versions differ: some leave it whole over "model", and
    every rank there would scan the same rows).  Every other dim is
    replicated, a ``Partial`` input reduced.  An input whole on a mesh dim
    that splits the batch or the heads (a weight, or B and C beside split
    heads) gets a gradient that is a partial sum there."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    split = ([p == Shard(0) for p in heads.placements] if is_dtensor(heads)
             else [False] * mesh.ndim)
    n_split = math.prod(mesh.size(i) for i, s in enumerate(split) if s)
    if n_groups > 1 and n_groups % n_split:
        split = [False] * mesh.ndim          # the heads' groups would not follow them
    batch, n_batch = [], 1
    for i, (p, s) in enumerate(zip(x.placements, split)):
        batch.append(not s and (p == Shard(0) or x.shape[0] % (n_batch * mesh.size(i)) == 0))
        n_batch *= mesh.size(i) if batch[-1] else 1

    def placements(layout):
        b, h = layout
        return tuple(Shard(b) if bi and b is not None else
                     Shard(h) if si and h is not None else Replicate()
                     for bi, si in zip(batch, split))

    def grad_placements(layout):
        # an input whole on a mesh dim that splits the work (the batch or
        # the heads) gets a partial gradient from each of its shards
        return tuple(Partial() if (bi or si) and p == Replicate() else p
                     for bi, si, p in zip(batch, split, placements(layout)))

    args = [a if is_dtensor(a) else DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                                       run_check=False) for a in args]
    per_shard = local_map(fn, out_placements=tuple(placements(o) for o in out_layouts),
                          in_placements=tuple(placements(l) for l in layouts),
                          in_grad_placements=tuple(grad_placements(l) for l in layouts),
                          redistribute_inputs=True, device_mesh=mesh)
    return per_shard(*args)
