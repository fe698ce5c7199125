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
