"""Virtual accelerators and the tiered accelerator registry.

The paper's cloud-edge continuum (device / edge / cloud) generalizes here to
an arbitrary pool of *virtual accelerators*: entries that describe a compute
endpoint (its tier, peak FLOPS, memory, link characteristics to a given host)
plus, when live, a transport channel to its executor.  The same registry
drives

* the calibrated paper-testbed simulation (the JAX package's
  ``benchmarks/paper_tables.py``),
* the device-aware scheduler (core/scheduler.py, paper future-work iii), and
* failover targets for migration (core/migration.py, paper future-work ii).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class AcceleratorSpec:
    """Static capability description of one accelerator endpoint."""
    name: str
    tier: str                    # device | edge | cloud | pod
    peak_flops: float            # advertised peak (FLOP/s)
    efficiency: float            # achieved fraction on DL workloads (calibrated)
    mem_bytes: float
    link_bandwidth: float        # bytes/s on the path host -> this accelerator
    link_latency: float          # one-way seconds
    serialize_rate: float        # bytes/s the *destination* CPU (de)serializes
    gpu_cores: int = 0
    cpu_cores: int = 0

    @property
    def effective_flops(self) -> float:
        return self.peak_flops * self.efficiency


# ---------------------------------------------------------------------------
# The paper's lab test-bed (Table I), with efficiency/link constants
# calibrated against Tables II-V / Fig. 8 (the JAX package's
# benchmarks/paper_tables.py).  Copied verbatim: they are the paper's figures.
# ---------------------------------------------------------------------------

JETSON_NANO = AcceleratorSpec(
    name="jetson-nano", tier="device",
    peak_flops=235e9, efficiency=0.33,     # 160 GFLOP fwd in ~2.06 s (Table II)
    mem_bytes=4e9, link_bandwidth=0.0, link_latency=0.0,
    serialize_rate=300e6, gpu_cores=128, cpu_cores=4)

JETSON_TX2 = AcceleratorSpec(
    name="jetson-tx2", tier="edge",
    peak_flops=750e9, efficiency=0.197,    # ~1.09 s/frame (Table II / Fig. 8)
    mem_bytes=8e9, link_bandwidth=60e6, link_latency=2e-3,
    serialize_rate=22e6,                   # slow edge CPU dominates comm:
    gpu_cores=256, cpu_cores=4)            # 3.75MB -> ~0.235s (Fig. 8: 0.24s)

CLOUD_RTX = AcceleratorSpec(
    name="cloud-rtx", tier="cloud",
    peak_flops=6.5e12, efficiency=0.196,   # ~0.127 s/frame (Table II)
    mem_bytes=6e9, link_bandwidth=110e6, link_latency=5e-3,
    serialize_rate=300e6, gpu_cores=1920, cpu_cores=8)

PAPER_TESTBED = {"device": JETSON_NANO, "edge": JETSON_TX2, "cloud": CLOUD_RTX}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

@dataclass
class VirtualAccelerator:
    """A registry entry: spec + live state (channel, load, health) plus the
    capabilities the endpoint advertised at handshake time (protocol
    version, codecs, pipelining, coalescing — see
    ``DestinationExecutor._op_ping``)."""
    spec: AcceleratorSpec
    channel: object = None          # transport channel to the executor (live)
    inflight: int = 0
    healthy: bool = True
    total_requests: int = 0
    capabilities: dict = field(default_factory=dict)
    #: the endpoint advertised (or a client observed) a zero-downtime drain:
    #: alive — it still answers snapshot/restore/ping — but not admitting
    #: new work, so routing must skip it while sessions re-home
    draining: bool = False
    #: monotonic deadline of a post-failover cool-down: even if something
    #: flips ``healthy`` back (a heartbeat recovery, a successful re-dial),
    #: the scheduler must not route here until the window passes
    quarantined_until: float = 0.0

    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def quarantined(self) -> bool:
        return time.monotonic() < self.quarantined_until


class AcceleratorRegistry:
    """Thread-safe pool of virtual accelerators (elastic membership)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._pool: dict[str, VirtualAccelerator] = {}

    def register(self, spec: AcceleratorSpec, channel=None,
                 capabilities: Optional[dict] = None) -> VirtualAccelerator:
        with self._lock:
            va = VirtualAccelerator(spec=spec, channel=channel,
                                    capabilities=dict(capabilities or {}))
            self._pool[spec.name] = va
            return va

    def rebind(self, name: str, channel=None,
               capabilities: Optional[dict] = None) -> Optional[VirtualAccelerator]:
        """Swap the live channel/capabilities of an EXISTING entry without
        resetting its state (inflight, total_requests, healthy) — what a
        reconnect wants, where ``register`` would erase concurrent load
        accounting and silently clear an explicit mark_unhealthy.  Returns
        the entry, or None if the name is unknown."""
        with self._lock:
            va = self._pool.get(name)
            if va is None:
                return None
            va.channel = channel
            if capabilities is not None:
                va.capabilities = dict(capabilities)
            return va

    def deregister(self, name: str) -> None:
        with self._lock:
            self._pool.pop(name, None)

    def get(self, name: str) -> VirtualAccelerator:
        with self._lock:
            return self._pool[name]

    def mark_unhealthy(self, name: str) -> None:
        with self._lock:
            if name in self._pool:
                self._pool[name].healthy = False

    def mark_healthy(self, name: str) -> None:
        with self._lock:
            if name in self._pool:
                self._pool[name].healthy = True

    def mark_draining(self, name: str, draining: bool = True) -> None:
        """Flag an endpoint as draining (alive, not admitting new work).
        Routing — :meth:`routable` — skips it; health is untouched."""
        with self._lock:
            if name in self._pool:
                self._pool[name].draining = bool(draining)

    def quarantine(self, name: str, cooldown_s: float) -> None:
        """Mark ``name`` unhealthy AND hold it out of :meth:`routable` for
        ``cooldown_s`` even if its health flag flips back earlier — a node
        that just killed a session must re-earn routing, not rejoin on the
        first lucky ping."""
        with self._lock:
            va = self._pool.get(name)
            if va is not None:
                va.healthy = False
                va.quarantined_until = max(va.quarantined_until,
                                           time.monotonic() + cooldown_s)

    def clear_quarantine(self, name: str) -> None:
        with self._lock:
            if name in self._pool:
                self._pool[name].quarantined_until = 0.0

    def healthy(self) -> list[VirtualAccelerator]:
        with self._lock:
            return [v for v in self._pool.values() if v.healthy]

    def routable(self) -> list[VirtualAccelerator]:
        """The members a scheduler may route NEW work onto: healthy, not
        draining, and past any failover quarantine cool-down.  (``healthy``
        keeps its broader meaning — a draining node is healthy but not
        routable.)"""
        with self._lock:
            return [v for v in self._pool.values()
                    if v.healthy and not v.draining and not v.quarantined]

    def all(self) -> list[VirtualAccelerator]:
        with self._lock:
            return list(self._pool.values())

    def acquire(self, name: str) -> None:
        with self._lock:
            va = self._pool[name]
            va.inflight += 1
            va.total_requests += 1

    def release(self, name: str) -> None:
        with self._lock:
            if name in self._pool:
                self._pool[name].inflight = max(0, self._pool[name].inflight - 1)
