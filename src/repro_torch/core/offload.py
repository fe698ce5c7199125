"""Layer-granularity offload partitioning (Neurosurgeon/Scission-style,
which the paper cites as the placement substrate AVEC plugs into).

Given per-layer compute costs and inter-layer activation sizes, choose the
split point k: layers [0,k) run on the host, the activation crosses the link
once, layers [k,L) run at the destination, and the result returns.  AVEC's
default configuration is k=0 for the DNN backbone (all Caffe kernels remote,
paper §V.4) with host-only pre/post kernels accounted as "Other"."""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.costmodel import comm_time
from repro_torch.core.virtualization import AcceleratorSpec


@dataclass(frozen=True)
class LayerProfile:
    name: str
    flops: float
    out_bytes: float     # activation size leaving this layer


def split_time(layers: list[LayerProfile], k: int, input_bytes: float,
               result_bytes: float, host: AcceleratorSpec,
               dest: AcceleratorSpec) -> float:
    """Total cycle time when layers [0,k) run on host, [k,L) on dest."""
    t_host = sum(l.flops for l in layers[:k]) / host.effective_flops
    t_dest = sum(l.flops for l in layers[k:]) / dest.effective_flops
    cross = input_bytes if k == 0 else layers[k - 1].out_bytes
    if k == len(layers):               # fully local: nothing crosses
        return t_host
    t_comm = comm_time(cross, dest) + comm_time(result_bytes, dest)
    return t_host + t_comm + t_dest


def best_split(layers: list[LayerProfile], input_bytes: float,
               result_bytes: float, host: AcceleratorSpec,
               dest: AcceleratorSpec) -> tuple[int, float]:
    """Returns (k*, t*) minimizing the cycle time over all split points
    (k = len(layers) means fully local)."""
    best_k, best_t = 0, float("inf")
    for k in range(len(layers) + 1):
        t = split_time(layers, k, input_bytes, result_bytes, host, dest)
        if t < best_t:
            best_k, best_t = k, t
    return best_k, best_t
