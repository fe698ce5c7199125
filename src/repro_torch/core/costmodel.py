"""Analytic cost model for offload decisions and paper-testbed simulation.

The model is deliberately simple (the paper's own accounting, Fig. 8):

  t_native(host)    = flops / eff_flops(host) + t_other
  t_offload(dst)    = t_comm(dst) + flops / eff_flops(dst) + t_other
  t_comm(dst)       = 2*latency + DT/bandwidth + DT/serialize_rate
  speedup           = t_native / t_offload

with DT per the paper's Eq. 1 (generalized: args bytes + results bytes).
Efficiencies and link constants live on AcceleratorSpec and are calibrated
against Tables II-V (see repro_torch.core.virtualization.PAPER_TESTBED).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.virtualization import AcceleratorSpec


@dataclass(frozen=True)
class Workload:
    """One execution cycle of an offloadable workload."""
    name: str
    flops: float                 # destination compute per cycle
    bytes_out: float             # host -> destination per cycle (args)
    bytes_back: float            # destination -> host per cycle (results)
    host_other_s: float = 0.0    # host-side app time per cycle ("Other")
    model_bytes: float = 0.0     # one-time weight transfer (send-once cache)


def compute_time(flops: float, acc: AcceleratorSpec) -> float:
    return flops / acc.effective_flops


def comm_time(nbytes: float, acc: AcceleratorSpec) -> float:
    """One direction across the host->acc link."""
    if acc.link_bandwidth <= 0:
        return 0.0
    t = acc.link_latency + nbytes / acc.link_bandwidth
    if acc.serialize_rate > 0:
        t += nbytes / acc.serialize_rate
    return t


def cycle_comm_time(w: Workload, acc: AcceleratorSpec) -> float:
    return comm_time(w.bytes_out, acc) + comm_time(w.bytes_back, acc)


def native_cycle_time(w: Workload, host: AcceleratorSpec) -> float:
    return compute_time(w.flops, host) + w.host_other_s


def offload_cycle_time(w: Workload, dst: AcceleratorSpec) -> float:
    return cycle_comm_time(w, dst) + compute_time(w.flops, dst) + w.host_other_s


def speedup(w: Workload, host: AcceleratorSpec, dst: AcceleratorSpec) -> float:
    return native_cycle_time(w, host) / offload_cycle_time(w, dst)


def model_transfer_time(model_bytes: float, acc: AcceleratorSpec,
                        to_gpu_bw: float = 12e9) -> float:
    """Table III analogue: one-time weight movement onto the accelerator
    (wire transfer when remote + host-to-device copy)."""
    t = model_bytes / to_gpu_bw
    if acc.link_bandwidth > 0:
        t += comm_time(model_bytes, acc)
    return t


def amortized_speedup(w: Workload, host: AcceleratorSpec,
                      dst: AcceleratorSpec, cycles: int) -> float:
    """Speedup including the send-once model transfer amortized over a run —
    the related-work observation (GVirtuS-ARM) that offload favors
    longer-running workloads."""
    native = cycles * native_cycle_time(w, host)
    off = cycles * offload_cycle_time(w, dst) + model_transfer_time(
        w.model_bytes, dst)
    return native / off


def estimate_request_time(w: Workload, acc: AcceleratorSpec,
                          inflight: int = 0, load_penalty: float = 1.0) -> float:
    """Scheduler scoring: predicted completion including queueing pressure."""
    base = offload_cycle_time(w, acc)
    return base * (1.0 + load_penalty * inflight)
