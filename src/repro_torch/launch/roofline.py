"""Roofline terms of a dry-run cell on the NVIDIA H100.

Hardware model: NVIDIA H100 80GB HBM3 (SXM5), 700 W board power, the
figures of NVIDIA's H100 Tensor Core GPU datasheet:
  peak dense bf16 compute : 989 TFLOP/s per card (without sparsity)
  HBM3 bandwidth          : 3.35 TB/s per card
  NVLink 4 bandwidth      : 450 GB/s per direction (900 GB/s in all)
  device memory           : 80 GB

Terms (seconds; every count is per device, so dividing by per-card peaks
is ``total / (cards x peak)``):

  compute    = FLOPs_per_device      / peak FLOP/s
  memory     = bytes_per_device      / HBM bandwidth
  collective = coll_bytes_per_device / NVLink bandwidth per direction

The collectives are the ones the dry-run issues (``launch/dryrun.py``
counts them at the functional-collective level), by type, in bytes and
count, with the reference's result-shape convention: an op's bytes are its
result's (for a ring all-reduce or all-gather the per-device wire traffic is
about result bytes x 2(N-1)/N, the result size up to a <=2x constant,
applied uniformly)."""
from __future__ import annotations

from dataclasses import dataclass

HW = {
    "name": "NVIDIA H100 80GB HBM3 (SXM5), 700 W",
    "peak_flops": 989e12,     # dense bf16 FLOP/s per card
    "hbm_bw": 3.35e12,        # B/s per card
    "nvlink_bw": 450e9,       # B/s per direction per card
    "chip_mem": 80e9,         # B per card
}

#: functional collective (``torch.ops._c10d_functional``) -> the name of
#: its kind in the reference's records (XLA's HLO op names)
COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "broadcast",
}


def tally_collectives(calls) -> tuple[int, dict]:
    """``calls``: (functional collective name, result bytes) pairs ->
    (total bytes per device, {kind: {"bytes": int, "count": int}})."""
    by_type: dict[str, dict] = {}
    total = 0
    for name, nbytes in calls:
        slot = by_type.setdefault(COLLECTIVE_KINDS.get(name, name), {"bytes": 0, "count": 0})
        slot["bytes"] += int(nbytes)
        slot["count"] += 1
        total += int(nbytes)
    return total, by_type


@dataclass
class RooflineReport:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    model_flops: float
    useful_ratio: float
    dominant: str
    bound_s: float

    def to_dict(self) -> dict:
        return dict(self.__dict__)


def analyze(flops_per_device: float, bytes_per_device: float,
            coll_bytes_per_device: float, model_flops: float,
            chips: int) -> RooflineReport:
    compute_s = flops_per_device / HW["peak_flops"]
    memory_s = bytes_per_device / HW["hbm_bw"]
    collective_s = coll_bytes_per_device / HW["nvlink_bw"]
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    total = flops_per_device * chips
    useful = model_flops / total if total > 0 else 0.0
    return RooflineReport(
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        flops_per_device=flops_per_device, bytes_per_device=bytes_per_device,
        coll_bytes_per_device=coll_bytes_per_device, model_flops=model_flops,
        useful_ratio=useful, dominant=dominant, bound_s=terms[dominant])


def model_flops_6nd(cfg, shape) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE); D = tokens processed."""
    n = cfg.param_count(active_only=True)
    if shape.kind == "decode":
        d = shape.global_batch
    else:
        d = shape.global_batch * shape.seq_len
    return 6.0 * n * d
