"""One front door for AVEC hosts: ``repro_torch.avec.connect``.

The paper's promise (§Q1 / motivation 4) is that an *unmodified*
application gets transparent accelerator virtualization.  The host-side
building blocks — registry, scheduler, transport, runtime tiers, sessions,
interception — are composable on purpose, but composing them by hand costs
~40 lines of bespoke wiring per caller and forces every application to pick
its own runtime tier.  This module is the facade that owns that wiring:

    client = avec.connect(["tcp://edge:9000", "tcp://cloud:9100"])
    sess = client.session(cfg, params, "lm", tenant="acme",
                          qos=avec.QoS(weight=3.0))        # fair-share share
    out = sess.call("prefill", {"tokens": prompts})        # scheduler-routed
    outs = sess.map("score", {rid: args, ...})             # sharded fan-out

``connect`` accepts heterogeneous *targets* — ``"tcp://host:port"`` URLs,
in-process :class:`~repro_torch.core.executor.DestinationExecutor` instances, or
``(AcceleratorSpec, target)`` pairs that attach a calibrated spec for the
scheduler — and performs a **versioned capability handshake** with each:
the executor's ping reply advertises its wire protocol version, decodable
codecs, op set, pipelining and coalescing support (plus live coalescer
stats).  The client then

* rejects protocol-version mismatches loudly at connect time (never
  misparse frames mid-stream),
* auto-selects :class:`~repro_torch.core.executor.PipelinedHostRuntime` when the
  peer and channel support pipelining, and downgrades to the synchronous
  :class:`~repro_torch.core.executor.HostRuntime` otherwise,
* downgrades the requested codec to one the peer can decode (``raw`` is
  mandatory at every version, so negotiation always succeeds),
* feeds the advertised ``coalesce_stats`` into
  :class:`~repro_torch.core.scheduler.DeviceAwareScheduler` so batch-amortizing
  destinations advertise their cheaper dispatch cost, and binds live
  runtime ``stats()`` for backpressure-aware scoring.

Sessions are tenant-scoped (the destination's fingerprint cache keys by
``tenant:fingerprint``, so two tenants sharing weights still get isolated
mutable state), scheduler-routed, and failover-integrated: a destination
that dies mid-stream is detected on the failing call, the session migrates
to the next-best healthy destination restoring the host-side shadow state,
and the call is retried — the application never sees the re-route.

``client.intercept(module, fn_map, session)`` installs the interception
library with explicit per-function :class:`~repro_torch.core.interception.ArgSpec`
extraction, replacing the deprecated positional ``args[2]`` convention.
"""
from __future__ import annotations

import itertools
import os
import time
import uuid
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.analysis import sanitize as _sanitize
from repro_torch.core.cache import model_fingerprint
from repro_torch.core.cluster import ClusterMembership, ReplicaGroup
from repro_torch.core.costmodel import Workload
from repro_torch.core.executor import (DestinationDraining, DestinationExecutor,
                                       HostRuntime, PipelinedHostRuntime,
                                       RemoteError, TenantThrottled, _gethostname)
from repro_torch.core.interception import (ArgSpec, AvecSession,
                                           InterceptionLibrary)
from repro_torch.core.migration import MigrationManager, SessionShadow
from repro_torch.core.scheduler import DeviceAwareScheduler, NoDestinationError
from repro_torch.core.shm import SharedMemoryChannel
from repro_torch.core.serialization import (PROTOCOL_VERSION, SUPPORTED_CODECS,
                                            tree_wire_bytes)
from repro_torch.core.transport import (Channel, ChannelClosed, DirectChannel,
                                        TCPChannel)
from repro_torch.core.virtualization import (AcceleratorRegistry, AcceleratorSpec,
                                             CLOUD_RTX)
from repro_torch.obs import trace as _trace
from repro_torch.obs.config import global_config
from repro_torch.serving.engine import (PipelinedOffloadFrontend,
                                        ShardedOffloadFrontend)
from repro_torch.serving.shardplan import ShardPlan, ShardPlanner, ShardStitchError
from repro_torch.utils import tree_leaves

__all__ = [
    "connect", "AvecClient", "ClientSession", "ConnectPolicy", "Endpoint",
    "Capabilities", "HandshakeError", "ArgSpec", "PROTOCOL_VERSION",
    "QoS", "TenantThrottled", "DestinationDraining", "ShardStitchError",
    "negotiate_codec", "negotiate_codecs",
]


class HandshakeError(ConnectionError):
    """Endpoint and client cannot interoperate (protocol version mismatch,
    unusable capability set).  Raised at connect time, loudly."""


@dataclass(frozen=True)
class QoS:
    """Per-session quality-of-service declaration, carried in every ``run``
    frame's metadata and honored by the destination's fair-share drain.

    ``weight``   — relative drain share under contention (a weight-3 tenant
                   drains ~3x a weight-1 tenant's requests; destinations may
                   pin weights server-side, which wins).
    ``priority`` — strict priority class: a higher class is always drained
                   next (an already-dispatched batch is never preempted).
                   Use sparingly — a saturated higher class starves lower
                   ones by design."""
    weight: float = 1.0
    priority: int = 0

    def as_meta(self) -> dict:
        return {"weight": float(self.weight), "priority": int(self.priority)}


def _qos_meta(qos) -> Optional[dict]:
    """Normalize a QoS | dict | None into frame metadata."""
    if qos is None:
        return None
    if isinstance(qos, QoS):
        return qos.as_meta()
    return dict(qos)


# Spec assumed for a bare "tcp://host:port" target: capability-class numbers
# of the paper's cloud tier with memory effectively unconstrained, so the
# scheduler never silently excludes an endpoint the caller didn't describe.
DEFAULT_ENDPOINT_SPEC = replace(CLOUD_RTX, name="endpoint", mem_bytes=64e9)


@dataclass(frozen=True)
class Capabilities:
    """What one endpoint advertised during the versioned handshake."""
    name: str
    protocol_version: int
    codecs: tuple
    ops: tuple
    libraries: dict
    pipelining: bool
    coalesce: bool
    coalesce_stats: dict
    fair_drain: bool = False
    tenant_stats: dict = field(default_factory=dict)
    tenant_limits: dict = field(default_factory=dict)
    #: the endpoint is bleeding its queues for a zero-downtime exit: alive
    #: (snapshot/restore/ping still served) but not admitting new work
    draining: bool = False
    #: the destination's effective knob values (repro_torch.obs.config — env and
    #: constructor overrides already folded in), so clients can see and
    #: log the remote end's actual tuning
    config: dict = field(default_factory=dict)
    raw: dict = field(default_factory=dict, compare=False)

    @staticmethod
    def from_ping(reply: dict) -> "Capabilities":
        return Capabilities(
            name=reply.get("name", "?"),
            protocol_version=int(reply.get("protocol_version", 1)),
            codecs=tuple(reply.get("codecs", ("raw",))),
            ops=tuple(reply.get("ops", ())),
            libraries=dict(reply.get("libraries", {})),
            pipelining=bool(reply.get("pipelining", False)),
            coalesce=bool(reply.get("coalesce", False)),
            coalesce_stats=dict(reply.get("coalesce_stats", {})),
            fair_drain=bool(reply.get("fair_drain", False)),
            tenant_stats=dict(reply.get("tenant_stats", {})),
            tenant_limits=dict(reply.get("tenant_limits", {})),
            draining=bool(reply.get("draining", False)),
            config=dict(reply.get("config", {})),
            raw=dict(reply))


@dataclass(frozen=True)
class ConnectPolicy:
    """Host-side policy knobs for :func:`connect` (all optional — the facade
    picks working defaults and the handshake downgrades what the peer can't
    do)."""
    codec: str = "raw"              # requested; downgraded to peer's set
    prefer_pipelining: bool = True  # use PipelinedHostRuntime when possible
    #: same-host tier selection: when a TCP-dialed peer's handshake
    #: advertises a shared-memory doorbell on THIS host, silently re-dial it
    #: over :class:`repro_torch.core.shm.SharedMemoryChannel` (mmap ring,
    #: zero-copy receive).  Cross-host peers are unaffected; set False to
    #: pin the wire transport (e.g. when benchmarking TCP on localhost).
    prefer_shm: bool = True
    #: pipelined window cap (adaptive below).  ``None`` resolves through
    #: the ``connect_max_in_flight`` knob (repro_torch.obs.config) — env
    #: ``AVEC_CONNECT_MAX_IN_FLIGHT`` overrides even an explicit value
    max_in_flight: Optional[int] = None
    adaptive_window: bool = True
    #: ``None`` resolves through the ``rpc_timeout_s`` knob
    timeout: Optional[float] = None
    copy_results: bool = False      # copy leaves at unpack (frees recv pool)
    #: hand sessions/map owning copies of results AFTER profiling, releasing
    #: recv-pool lease pins at materialization (zero-copy views otherwise;
    #: see repro_torch.core.memory for the lease contract)
    detach_results: bool = False
    failover: bool = True           # transparent re-route on node death
    #: proactive failure domain: keep a warm standby per session (scheduler
    #: picked, model made resident ahead of time, every host shadow snapshot
    #: replicated to it) so failover/drain re-home is a promotion, not a
    #: rebuild.  Needs ``failover`` + a shadow (``shadow_every > 0``) + a
    #: second servable destination; degrades silently to reactive failover
    #: otherwise.
    warm_standby: bool = True
    #: session placement: "scheduler" (cost-model pick, the default) or
    #: "hash" (consistent-hash of tenant:fingerprint onto the routable
    #: ring — sticky placement where membership churn moves only the
    #: affected arc; the scheduler still picks the standby)
    placement: str = "scheduler"
    #: snapshot the destination's mutable session state back to the host
    #: every N calls (0 = off).  The default (1) is correctness-first —
    #: mid-stream failover can restore the NEWEST state — but costs one
    #: snapshot RPC per call, which is real wire traffic for big KV
    #: caches; stateless or throughput-bound callers should pass 0.
    shadow_every: Optional[int] = None
    max_shards: Optional[int] = None   # session.map fan-out width (None=all)
    load_penalty: float = 1.0       # scheduler queueing weight

    def __post_init__(self) -> None:
        # resolve the knob-backed fields (env > explicit > default); a
        # frozen dataclass mutates via object.__setattr__ here only
        cfg = global_config()
        object.__setattr__(self, "max_in_flight", int(cfg.resolve(
            "connect_max_in_flight", self.max_in_flight)))
        object.__setattr__(self, "timeout", float(cfg.resolve(
            "rpc_timeout_s", self.timeout)))
        object.__setattr__(self, "shadow_every", int(cfg.resolve(
            "shadow_every", self.shadow_every)))


@dataclass
class Endpoint:
    """A parsed connect target: spec for the scheduler + a way to dial it."""
    name: str
    spec: AcceleratorSpec
    dial: Callable[[], Channel]

    @staticmethod
    def parse(target: Any, index: int) -> "Endpoint":
        """Accepts ``"tcp://host:port"``, ``"shm://<doorbell path>"`` (the
        AF_UNIX socket a :class:`repro_torch.core.shm.SharedMemoryServer`
        listens on), an in-process :class:`DestinationExecutor`, an
        :class:`Endpoint`, a zero-arg channel factory, or an
        ``(AcceleratorSpec, target)`` pair binding a calibrated spec to any
        of the above."""
        spec = None
        if isinstance(target, tuple) and len(target) == 2 \
                and isinstance(target[0], AcceleratorSpec):
            spec, target = target
        if isinstance(target, Endpoint):
            return target if spec is None else replace(target, spec=spec,
                                                       name=spec.name)
        if isinstance(target, str):
            if target.startswith("shm://"):
                path = target[len("shm://"):]
                if not path:
                    raise ValueError(f"malformed endpoint URL {target!r}")
                spec = spec or replace(DEFAULT_ENDPOINT_SPEC,
                                       name=f"ep{index}-shm")
                return Endpoint(
                    spec.name, spec,
                    lambda p=path: SharedMemoryChannel.connect(p))
            if not target.startswith("tcp://"):
                raise ValueError(
                    f"unsupported endpoint URL {target!r} (expected "
                    f"tcp://host:port or shm://path)")
            host, _, port = target[len("tcp://"):].rpartition(":")
            if not host or not port.isdigit():
                raise ValueError(f"malformed endpoint URL {target!r}")
            spec = spec or replace(DEFAULT_ENDPOINT_SPEC,
                                   name=f"ep{index}-{host}:{port}")
            return Endpoint(spec.name, spec,
                            lambda h=host, p=int(port): TCPChannel.connect(h, p))
        if isinstance(target, DestinationExecutor):
            spec = spec or replace(DEFAULT_ENDPOINT_SPEC,
                                   name=target.name or f"ep{index}")
            return Endpoint(spec.name, spec,
                            lambda ex=target: DirectChannel(ex))
        if callable(target):
            if spec is None:
                raise ValueError(
                    "a bare channel factory target needs an AcceleratorSpec: "
                    "pass (spec, factory)")
            return Endpoint(spec.name, spec, target)
        raise TypeError(f"cannot parse connect target {target!r}")


def _channel_pipelinable(ch: Channel) -> bool:
    """Pipelining needs independent send/recv on the channel; request-only
    shims (DirectChannel) can't keep multiple frames in flight."""
    return (type(ch).send is not Channel.send
            and type(ch).recv is not Channel.recv)


def negotiate_codecs(requested, peer_codecs: tuple) -> tuple:
    """The negotiated on-wire codec PREFERENCE LIST for one link: the
    requested codec(s), in order, filtered to what both sides implement,
    always ending in ``raw`` (mandatory at every protocol version, so
    negotiation cannot fail — an old peer that advertises nothing new gets
    clean raw frames).  The serializer resolves the list per leaf
    (``repro_torch.core.serialization._select_codec``): compression codecs apply
    to anything, quantizing codecs only to float leaves above the
    ``comm_quant_min_bytes`` floor."""
    req = (requested,) if isinstance(requested, str) else tuple(requested)
    prefs = [c for c in req
             if c != "raw" and c in peer_codecs and c in SUPPORTED_CODECS]
    return (*prefs, "raw")


def negotiate_codec(requested: str, peer_codecs: tuple) -> str:
    """The PRIMARY negotiated codec (first preference) — the requested
    codec if the peer decodes it, else ``raw``."""
    return negotiate_codecs(requested, peer_codecs)[0]


class AvecClient:
    """A connected pool of AVEC destinations behind one scheduler.

    Build with :func:`connect`.  Holds, per endpoint: the handshake
    :class:`Capabilities`, a negotiated runtime (pipelined where possible),
    and a registry entry the :class:`DeviceAwareScheduler` scores with
    handshake ``coalesce_stats`` plus live runtime ``stats()``."""

    def __init__(self, targets, policy: Optional[ConnectPolicy] = None,
                 registry: Optional[AcceleratorRegistry] = None) -> None:
        self.policy = policy or ConnectPolicy()
        self.registry = registry or AcceleratorRegistry()
        self.scheduler = DeviceAwareScheduler(
            self.registry, load_penalty=self.policy.load_penalty)
        self._lock = _sanitize.make_lock("AvecClient._lock")
        # serializes check-then-dial; deliberately NOT guarded-by registered:
        # dialing does socket I/O under it by design
        self._dial_lock = _sanitize.make_rlock("AvecClient._dial_lock")
        self._closed = False                            # guarded-by: _lock
        self._endpoints: dict[str, Endpoint] = {}       # fixed after __init__
        self._caps: dict[str, Capabilities] = {}        # guarded-by: _lock
        self._runtimes: dict[str, HostRuntime] = {}     # guarded-by: _lock
        self._codecs: dict[str, tuple] = {}             # guarded-by: _lock
        self._siblings: dict[tuple, AvecSession] = {}   # guarded-by: _lock
        self.migration = MigrationManager(self.registry, self.scheduler,
                                          self._runtime_for)
        # elastic membership view over the same registry: consistent-hash
        # ring of the routable pool, for sticky session placement and
        # arc-bounded re-homing on membership change
        self.cluster = ClusterMembership(self.registry)
        targets = list(targets)
        if not targets:
            raise ValueError("connect() needs at least one target")
        try:
            for i, t in enumerate(targets):
                ep = Endpoint.parse(t, i)
                if ep.name in self._endpoints:
                    raise ValueError(f"duplicate endpoint name {ep.name!r}")
                self._endpoints[ep.name] = ep
                self._dial(ep)
        except BaseException:
            self.close()        # don't leak endpoints dialed before the bad one
            raise

    # -- handshake ---------------------------------------------------------
    def _dial(self, ep: Endpoint) -> HostRuntime:
        """Dial one endpoint: open its channel, run the versioned capability
        handshake, and build the negotiated runtime tier on that channel."""
        pol = self.policy
        ch = ep.dial()
        try:
            probe = HostRuntime(ch, timeout=pol.timeout)
            reply = probe.ping({"protocol_version": PROTOCOL_VERSION,
                                "codecs": list(SUPPORTED_CODECS),
                                "client": "repro_torch.avec"})
            caps = Capabilities.from_ping(reply)
            if caps.protocol_version != PROTOCOL_VERSION:
                raise HandshakeError(
                    f"endpoint {ep.name!r} speaks AVEC protocol "
                    f"v{caps.protocol_version}; this client only speaks "
                    f"v{PROTOCOL_VERSION}.  Upgrade the older side (the "
                    f"wire format is not cross-version compatible) or pin "
                    f"both to the same repro release.")
            ch, caps = self._maybe_upgrade_shm(ch, caps)
            codecs = negotiate_codecs(pol.codec, caps.codecs)
            # runtimes carry the full preference tuple: the serializer
            # resolves it per leaf, and a quantizing head can be spliced in
            # later without renegotiating
            codec = codecs if len(codecs) > 1 else codecs[0]
            if caps.pipelining and pol.prefer_pipelining \
                    and _channel_pipelinable(ch):
                rt: HostRuntime = PipelinedHostRuntime(
                    ch, codec=codec, timeout=pol.timeout,
                    copy_results=pol.copy_results,
                    max_in_flight=pol.max_in_flight,
                    adaptive_window=pol.adaptive_window)
                qc = str(global_config().resolve("comm_quant_codec"))
                if qc != "off" and qc in caps.codecs:
                    # armed, not engaged: frames only quantize once the
                    # adaptive window observes a link-bound session
                    rt.quant_codec = qc
            else:
                rt = HostRuntime(ch, codec=codec, timeout=pol.timeout,
                                 copy_results=pol.copy_results)
        except BaseException:
            try:                # never leak a half-handshaken connection
                ch.close()
            except Exception:  # noqa: BLE001 — already failing loudly
                pass
            raise
        with self._lock:
            self._caps[ep.name] = caps
            self._runtimes[ep.name] = rt
            self._codecs[ep.name] = codecs
        # re-dials REBIND the existing pool entry: replacing it would reset
        # live load accounting (inflight held by concurrent sessions) and
        # silently clear an explicit mark_unhealthy
        if self.registry.rebind(ep.name, channel=ch,
                                capabilities=caps.raw) is None:
            self.registry.register(ep.spec, channel=ch,
                                   capabilities=caps.raw)
        self.scheduler.record_capabilities(ep.name, caps.raw)
        # an endpoint dialed (or re-dialed) mid-drain advertises it in the
        # handshake: keep it out of routing while its queues bleed
        self.registry.mark_draining(ep.name, caps.draining)
        if hasattr(rt, "stats"):
            self.scheduler.attach_runtime(ep.name, rt)
        return rt

    def _maybe_upgrade_shm(self, ch: Channel, caps: Capabilities):
        """Same-host tier selection: a TCP-dialed peer that advertised a
        shared-memory doorbell on THIS host is silently re-dialed over the
        mmap ring (``repro_torch.core.shm``) — the TCP probe connection closes and
        every later frame lands in pooled shared memory.  Any failure to
        upgrade (stale socket path, hostname mismatch, ring handshake error)
        keeps the working TCP channel; the fast path is an optimization,
        never a dependency."""
        shm = (caps.raw.get("shm") or {}) if self.policy.prefer_shm else {}
        path = shm.get("path")
        if (not path or shm.get("host") != _gethostname()
                or not isinstance(ch, TCPChannel)
                or not os.path.exists(path)):
            return ch, caps
        try:
            shm_ch = SharedMemoryChannel.connect(
                path, timeout=self.policy.timeout)
        except Exception:  # noqa: BLE001 — degraded tier, not a failure
            return ch, caps
        try:
            reply = HostRuntime(shm_ch, timeout=self.policy.timeout).ping(
                {"protocol_version": PROTOCOL_VERSION,
                 "codecs": list(SUPPORTED_CODECS),
                 "client": "repro_torch.avec"})
        except Exception:  # noqa: BLE001 — ring didn't answer; keep TCP
            try:
                shm_ch.close()
            except Exception:  # noqa: BLE001
                pass
            return ch, caps
        try:
            ch.close()
        except Exception:  # noqa: BLE001 — old probe conn, best-effort
            pass
        return shm_ch, Capabilities.from_ping(reply)

    def _runtime_for(self, name: str) -> HostRuntime:
        """The live runtime for pool member ``name``, re-dialing (with a
        fresh handshake) if its connection has been closed or failed.  Also
        the :class:`MigrationManager`'s runtime factory."""
        with self._dial_lock:   # one dial per endpoint, not one per racer
            if self._closed:
                raise ChannelClosed("AvecClient is closed")
            with self._lock:
                rt = self._runtimes.get(name)
            if rt is not None and not getattr(rt.channel, "broken", False) \
                    and not getattr(rt, "_closed", False) \
                    and getattr(rt, "_broken", None) is None:
                return rt
            return self._dial(self._endpoints[name])

    # -- introspection -----------------------------------------------------
    @property
    def destinations(self) -> list[str]:
        return list(self._endpoints)

    def capabilities(self, name: Optional[str] = None):
        """Handshake results (one endpoint, or all)."""
        with self._lock:
            if name is not None:
                return self._caps[name]
            return dict(self._caps)

    def refresh_capabilities(self, name: str) -> Capabilities:
        """Re-ping ``name`` and re-ingest its advertised capabilities —
        including LIVE per-tenant stats (queue depth, drain share, throttle
        counts) — into the scheduler.  Called automatically when a session
        exhausts its throttle retries, so routing sees the saturation that
        just bounced it."""
        rt = self._runtime_for(name)
        caps = Capabilities.from_ping(
            rt.ping({"protocol_version": PROTOCOL_VERSION,
                     "client": "repro_torch.avec"}))
        with self._lock:
            self._caps[name] = caps
        self.scheduler.record_capabilities(name, caps.raw)
        self.registry.mark_draining(name, caps.draining)
        return caps

    def tenant_stats(self, name: Optional[str] = None) -> dict:
        """The last-ingested per-tenant destination stats (one endpoint, or
        all) — refresh with :meth:`refresh_capabilities`."""
        if name is not None:
            return self.scheduler.tenant_stats(name)
        return {n: self.scheduler.tenant_stats(n) for n in self.destinations}

    def codec_for(self, name: str) -> str:
        """The PRIMARY negotiated codec for ``name`` (first preference)."""
        with self._lock:
            return self._codecs[name][0]

    def codecs_for(self, name: str) -> tuple:
        """The full negotiated codec preference list for ``name`` (always
        ends in ``raw``; see :func:`negotiate_codecs`)."""
        with self._lock:
            return self._codecs[name]

    def runtime(self, name: str) -> HostRuntime:
        """The negotiated live runtime for ``name`` (inspection/tests; the
        facade APIs below are the supported call paths)."""
        return self._runtime_for(name)

    def stats(self) -> dict:
        """Per-destination data-plane counters + scheduler snapshots."""
        out = {}
        with self._lock:
            items = list(self._runtimes.items())
        for name, rt in items:
            out[name] = rt.stats() if hasattr(rt, "stats") else {
                "bytes_sent": rt.bytes_sent,
                "bytes_received": rt.bytes_received}
        return out

    # -- sessions ----------------------------------------------------------
    def session(self, cfg: Any, params: Any, lib: str, *,
                tenant: Optional[str] = None, qos=None,
                workload: Optional[Workload] = None,
                destination: Optional[str] = None,
                name: str = "session") -> "ClientSession":
        """A tenant-scoped session whose destination the scheduler picks
        (capability-fed cost model + live load + the calling tenant's own
        saturation at each destination), with transparent failover.
        ``qos`` (a :class:`QoS` or ``{"weight": .., "priority": ..}`` dict)
        declares the session's fair-share weight and priority class,
        carried in every run frame's metadata.  ``workload`` refines the
        scheduler's estimate; omitted, it is derived from the parameter
        tree."""
        w = workload or self._default_workload(lib, params)
        if destination is None and self.policy.placement == "hash":
            destination = self._hash_place(cfg, params, lib, tenant)
        dest = destination or self._pick_serving(w, lib, tenant)
        return ClientSession(self, cfg, params, lib, dest, tenant=tenant,
                             qos=_qos_meta(qos), workload=w, name=name)

    def _hash_place(self, cfg, params, lib: str,
                    tenant: Optional[str]) -> Optional[str]:
        """Sticky placement: the tenant:fingerprint key lands on the
        consistent-hash ring of the routable pool, so the same model+tenant
        always re-homes to the same destination while membership holds, and
        a membership change moves only the keys in the affected arc.  Walks
        the ring preference order past destinations that don't serve
        ``lib``; returns None (scheduler fallback) on an empty ring."""
        key = f"{tenant or ''}:{model_fingerprint(cfg, params)}"
        self.cluster.place(key)     # sync the ring + record the placement
        for name in self.cluster.preference(key):
            if self.serves(name, lib):
                return name
        return None

    def serves(self, name: str, lib: str) -> bool:
        """Whether endpoint ``name`` advertised library ``lib`` in its
        handshake (endpoints that advertised nothing are assumed capable —
        older executors simply don't announce their libraries)."""
        with self._lock:
            caps = self._caps.get(name)
        libs = caps.libraries if caps is not None else {}
        return not libs or lib in libs

    def _pick_serving(self, w: Workload, lib: str,
                      tenant: Optional[str] = None) -> str:
        """Scheduler pick restricted to destinations that advertise ``lib``
        — health and memory alone must not route a session onto an
        executor that cannot serve its library.  ``tenant`` lets the
        scheduler penalize destinations where that tenant is already
        saturated (advertised tenant_stats)."""
        for va in self.scheduler.candidates(w, tenant=tenant):
            if self.serves(va.name, lib):
                return va.name
        raise NoDestinationError(
            f"no healthy destination advertises library {lib!r} "
            f"(pool: {self.destinations})")

    def _default_workload(self, lib: str, params: Any) -> Workload:
        # .nbytes (host arrays and tensors alike) avoids np.asarray's
        # device-to-host copy of the whole tree
        model_bytes = float(sum(
            getattr(l, "nbytes", None) or np.asarray(l).nbytes
            for l in tree_leaves(params)))
        # ~2 FLOPs per parameter per forwarded sample: the right order of
        # magnitude for dense forward passes, good enough to rank endpoints
        return Workload(lib, flops=max(model_bytes / 2, 1e6),
                        bytes_out=1e4, bytes_back=1e4,
                        model_bytes=model_bytes)

    def _sibling(self, sess: "ClientSession", name: str) -> AvecSession:
        """A secondary session handle for ``sess``'s model on destination
        ``name`` (sharded ``map``).  Shares the tenant-scoped fingerprint —
        send-once still applies per destination — and the caller's
        profiler."""
        key = (sess.fp, name)
        with self._lock:
            sib = self._siblings.get(key)
        if sib is not None and sib.runtime is self._runtime_for(name):
            return sib
        sib = AvecSession(sess.cfg, sess.params, self._runtime_for(name),
                          sess.lib, profiler=sess.profiler,
                          name=f"{sess.name}@{name}",
                          detach_results=sess.detach_results)
        sib.fp = sess.fp                # tenant scoping carries over
        sib.tenant = sess.tenant        # ...as does the fair-share identity
        sib.qos = sess.qos
        with self._lock:
            self._siblings[key] = sib
        return sib

    # -- interception ------------------------------------------------------
    def intercept(self, module, fn_map: dict, session: "ClientSession"
                  ) -> InterceptionLibrary:
        """Interception library over ``module`` with EXPLICIT per-function
        argument extraction: ``fn_map`` maps a module function name to
        ``(destination fn, ArgSpec)`` for offloaded functions, or ``None``
        for functions that stay host-side (still profiled as "Other").
        Returns the context manager; enter it to install."""
        offload = {k: v for k, v in fn_map.items() if v is not None}
        dispatcher = session.make_argspec_dispatcher(offload)
        return InterceptionLibrary(module, list(fn_map), dispatcher)

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        with self._lock:
            self._closed = True     # latch: no silent post-close re-dials
            runtimes = list(self._runtimes.values())
            self._runtimes.clear()
            self._siblings.clear()
        for rt in runtimes:
            try:
                rt.close()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass

    def __enter__(self) -> "AvecClient":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


class ClientSession(AvecSession):
    """An :class:`AvecSession` created through the facade: tenant-scoped
    fingerprint, scheduler-picked destination, transparent failover on node
    death, and multi-destination ``map`` fan-out."""

    #: failures that MAY mean the destination died (confirmed by a ping
    #: probe before failing over — a genuine application error from a live
    #: node is re-raised, not retried elsewhere)
    _FAILOVER_EXC = (RemoteError, ChannelClosed, TimeoutError, OSError)

    def __init__(self, client: AvecClient, cfg, params, lib: str,
                 destination: str, *, tenant: Optional[str],
                 qos: Optional[dict] = None,
                 workload: Workload, name: str = "session") -> None:
        super().__init__(cfg, params, client._runtime_for(destination), lib,
                         name=name,
                         detach_results=client.policy.detach_results)
        self.client = client
        self.tenant = tenant
        self.qos = qos
        self.workload = workload
        self.destination = destination
        if tenant is not None:
            # destination caches key by fingerprint: prefixing isolates both
            # the weight entry and the mutable session state per tenant
            self.fp = f"tenant:{tenant}:{self.fp}"
        n = client.policy.shadow_every
        self._shadow = SessionShadow(every_n_calls=n) if n > 0 else None
        self._steps = 0
        # client-generated logical call ids: the retry after a failover (or
        # a drain re-home) reuses the SAME id, so a destination that already
        # executed the original attempt answers from its replay LRU instead
        # of double-executing — wire-level rids can't serve here because a
        # re-dialed runtime resets them
        self._call_ns = uuid.uuid4().hex[:8]
        self._call_n = itertools.count(1)
        self.rehomes = 0
        self.last_rehome: Optional[dict] = None
        self.last_shard_stats: Optional[dict] = None
        # proactive failure domain: a warm standby replica group, fed by the
        # host shadow's snapshot cadence (no shadow -> nothing to replicate)
        pol = client.policy
        self._replica: Optional[ReplicaGroup] = None
        if (pol.failover and pol.warm_standby and self._shadow is not None
                and len(client.destinations) > 1):
            self._replica = ReplicaGroup(
                self.fp, destination,
                pick_standby=self._pick_standby,
                runtime_for=client._runtime_for,
                prepare=self._prepare_standby)

    # ------------------------------------------------------------------
    def call(self, fn: str, args: Any, *,
             shard: Optional[bool] = None) -> Any:
        """One profiled execution cycle, with transparent failover: if the
        destination died (confirmed by a failed ping), the session migrates
        to the next-best healthy destination — weights via send-once, state
        from the host-side shadow — and the call is retried once.

        ``shard=True`` opts this call into INTRA-CALL sharding (``None``
        defers to the ``shard_calls`` knob): the leading batch axis of the
        argument tree is row-split across the healthiest dedup-capable
        destinations, the sub-calls run concurrently, and the results are
        stitched back in range order — the caller sees exactly the tree an
        unsharded call returns (bit-identical for row-aligned functions; a
        function emitting aggregate leaves raises :class:`ShardStitchError`).
        Only stateless functions belong here — the sharded path performs no
        shadow snapshot.  When the pool can't shard the call (fewer than two
        eligible destinations, or too few rows for the per-shard floor), it
        silently falls through to the normal single-destination path.

        A :class:`TenantThrottled` that survives the runtime's jittered
        retries is NOT failover (the node is alive — it is saying no to
        this tenant specifically): the destination's live tenant stats are
        re-ingested so the scheduler penalizes it for this tenant's future
        routing, and the typed error surfaces to the caller.

        A :class:`DestinationDraining` bounce is not failover either — the
        node is alive but exiting: the session re-homes to its warm standby
        (falling back to a planned live migration, which the draining node
        still serves) and retries there.

        Retries carry the SAME logical ``call_id`` as the original attempt,
        so a destination that already executed it (failure hit the response,
        not the request) serves the cached result instead of re-executing —
        at-least-once delivery with replay dedup, no client-observed
        duplicates."""
        if shard is None:
            shard = bool(global_config().get("shard_calls"))
        if shard:
            planned = self._plan_shards(args)
            if planned is not None:
                return self._call_sharded(fn, args, *planned)
        cid = f"{self._call_ns}-{next(self._call_n)}"
        try:
            out = self._tracked_call(fn, args, cid)
        except TenantThrottled:
            try:
                self.client.refresh_capabilities(self.destination)
            except Exception:  # noqa: BLE001 — best-effort stats refresh
                pass
            raise
        except DestinationDraining as e:    # before _FAILOVER_EXC: subclass
            self._rehome_for_drain(e)
            out = self._tracked_call(fn, args, cid)
        except self._FAILOVER_EXC as e:
            if not self._recover_same_destination():
                self._failover_or_raise(e)
            out = self._tracked_call(fn, args, cid)
        self._steps += 1
        if self._shadow is not None:
            try:
                fresh = self._shadow.maybe_snapshot(self, self._steps)
                if fresh and self._replica is not None:
                    # piggyback the snapshot onto the warm standby over the
                    # same pooled send path (best-effort: a broken standby
                    # is dropped and re-picked on the next snapshot)
                    self._replica.primary = self.destination
                    self._replica.replicate(self.fp, self._shadow.state,
                                            self._steps)
            except self._FAILOVER_EXC:
                pass            # shadow is best-effort; keep the last one
        return out

    def _tracked_call(self, fn: str, args: Any,
                      call_id: Optional[str] = None) -> Any:
        """One cycle with the registry's live-load counter held, so the
        scheduler's queueing (and coalescer-amortization) terms see real
        in-flight pressure from facade traffic."""
        reg = self.client.registry
        dest = self.destination
        reg.acquire(dest)
        try:
            return super().call(fn, args, call_id=call_id)
        finally:
            reg.release(dest)

    # -- intra-call sharding -------------------------------------------
    def _plan_shards(self, args: Any) -> Optional[tuple]:
        """Row-range plan + destination assignment for one sharded call,
        or ``None`` when the call must run unsharded (fewer than two
        eligible destinations, unsplittable tree, or too few rows).
        Eligible destinations serve this library AND dedup replays —
        per-shard failover re-sends every range under its original
        call_id, so a shard landing on a non-dedup peer could
        double-execute.  Shard weights are the inverse of the scheduler's
        predicted-latency scores (cost model x live backpressure x this
        tenant's saturation): a destination scored 2x slower gets ~half
        the rows."""
        scored = [(va, s) for va, s in self.client.scheduler
                  .scored_candidates(self.workload, tenant=self.tenant)
                  if self.client.serves(va.name, self.lib)
                  and self.client.capabilities(va.name)
                  .raw.get("replay_dedup")]
        if len(scored) < 2:
            return None
        planner = ShardPlanner()
        scored = scored[:max(planner.max_shards, 1)]
        weights = [1.0 / max(s, 1e-9) for _, s in scored]
        plan = planner.plan_tree(args, weights)
        if plan is None:
            return None
        names = [va.name for va, _ in scored][:plan.n_shards]
        return plan, names

    def _shard_frontend(self, cache: dict, fn: str,
                        nm: str) -> PipelinedOffloadFrontend:
        """Per-destination frontend for sharded sub-calls, model ensured
        (send-once: a fingerprint hit when the destination holds it)."""
        fe = cache.get(nm)
        if fe is not None:
            return fe
        sib = self if nm == self.destination else \
            self.client._sibling(self, nm)
        sib.ensure_model()
        fe = PipelinedOffloadFrontend(
            sib.runtime, sib.fp, fn, tenant=self.tenant, qos=self.qos,
            detach_results=self.detach_results)
        cache[nm] = fe
        return fe

    def _shard_destination_alive(self, name: str) -> bool:
        """Ping probe for one shard destination — same policy as
        :meth:`_destination_alive`: an application error from a live node
        is the call's problem, not grounds for failover."""
        try:
            rt = self.client._runtime_for(name)     # re-dials if broken
        except Exception:  # noqa: BLE001 — re-dial failed: dead
            return False
        old_timeout = rt.timeout
        rt.timeout = min(5.0, old_timeout)
        try:
            rt.ping()
            return True
        except Exception:  # noqa: BLE001 — any failure means dead
            return False
        finally:
            rt.timeout = old_timeout

    def _call_sharded(self, fn: str, args: Any, plan: ShardPlan,
                      names: list) -> Any:
        """Dispatch one planned call as concurrent row-range sub-calls
        and stitch the results back in range order.

        Per-range call ids derive from one parent id
        (``<cid>/r<start>-<stop>``), and a failure triggers a RETRY ROUND
        that re-sends EVERY range under its original id: ranges whose
        destination survived answer from the replay LRU in one wire round
        trip (no re-execution), and only the dead destination's ranges
        actually re-execute on a survivor — at-least-once dispatch plus
        dedup is exactly-once math.  A confirmed-dead destination is
        quarantined (a draining one marked) exactly like whole-session
        failover, and the re-homed ranges land in the migration ledger.

        Tracing: each range gets a child record sharing the parent's
        trace_id (fn suffixed with its row range); the parent absorbs the
        slowest shard's timeline plus a measured ``stitch`` span (see
        :func:`repro_torch.obs.trace.merge_sharded`), so a sharded call still
        sums to its wall like an unsharded one."""
        cid = f"{self._call_ns}-{next(self._call_n)}"
        parent = _trace.start_trace(fn=fn, call_id=cid)
        t0 = time.perf_counter()
        parts = plan.split(args)
        n = plan.n_shards
        rcids = [f"{cid}/r{r.start}-{r.stop}" for r in plan.ranges]
        assign = list(names)                # range i -> destination name
        frontends: dict[str, PipelinedOffloadFrontend] = {}
        reg = self.client.registry
        children: list = [None] * n
        walls = [0.0] * n
        computes = [0.0] * n
        results: list = [None] * n
        acquired = [False] * n
        dead: set = set()
        last_exc: Optional[BaseException] = None
        retry_rounds = 0
        ok = False
        try:
            for _round in range(len(names)):
                alive = [nm for nm in names if nm not in dead]
                if not alive:
                    break
                # re-home ranges off dead destinations (round > 0) onto the
                # least-loaded survivors, and ledger the move
                moved: dict[str, list] = {}
                rr = itertools.cycle(alive)
                for i in range(n):
                    if assign[i] in dead:
                        old_nm, assign[i] = assign[i], next(rr)
                        moved.setdefault(old_nm, []).append(
                            {"start": plan.ranges[i].start,
                             "stop": plan.ranges[i].stop,
                             "to": assign[i]})
                for old_nm, rs in moved.items():
                    self.client.migration.record_shard_failover(
                        old_nm, rs, seconds=time.perf_counter() - t0)
                # dispatch every range (survivors answer retries from the
                # replay cache), then gather; a failed round marks deaths
                # and goes again over whoever is left
                failed = False
                futs: list = [None] * n
                for i in range(n):
                    nm = assign[i]
                    if parent is not None:
                        r = plan.ranges[i]
                        children[i] = _trace.TraceRecord(
                            trace_id=parent.trace_id, call_id=rcids[i],
                            fn=f"{fn}[{r.start}:{r.stop}]")
                    try:
                        fe = self._shard_frontend(frontends, fn, nm)
                        reg.acquire(nm)
                        acquired[i] = True
                        futs[i] = (fe, fe.submit(
                            parts[i], call_id=rcids[i], trace=children[i]),
                            time.perf_counter())
                    except DestinationDraining as e:
                        self.client.registry.mark_draining(nm)
                        dead.add(nm)
                        last_exc, failed = e, True
                    except self._FAILOVER_EXC as e:
                        if self._shard_destination_alive(nm):
                            raise       # live node: the call's own error
                        self.client.registry.quarantine(
                            nm, self.client.migration.quarantine_s)
                        dead.add(nm)
                        last_exc, failed = e, True
                for i in range(n):
                    if futs[i] is None:
                        continue
                    fe, fut, ts = futs[i]
                    nm = assign[i]
                    try:
                        out = fe.gather(fut, parts[i], call_id=rcids[i],
                                        trace=children[i])
                    except TenantThrottled:
                        try:    # saturation feedback, like unsharded call
                            self.client.refresh_capabilities(nm)
                        except Exception:  # noqa: BLE001 — best-effort
                            pass
                        raise
                    except DestinationDraining as e:
                        self.client.registry.mark_draining(nm)
                        dead.add(nm)
                        last_exc, failed = e, True
                        continue
                    except self._FAILOVER_EXC as e:
                        if nm not in dead:
                            if self._shard_destination_alive(nm):
                                raise   # live node: application error
                            self.client.registry.quarantine(
                                nm, self.client.migration.quarantine_s)
                            dead.add(nm)
                        last_exc, failed = e, True
                        continue
                    finally:
                        if acquired[i]:
                            reg.release(nm)
                            acquired[i] = False
                    walls[i] = time.perf_counter() - ts
                    computes[i] = getattr(fe.runtime, "last_compute_s",
                                          0.0) or 0.0
                    results[i] = out
                if not failed:
                    ok = True
                    retry_rounds = _round
                    break
            if not ok:
                raise last_exc or NoDestinationError(
                    f"no destination survived sharded call {cid!r}")
            ts0 = time.perf_counter_ns()
            out = plan.stitch(results)
            stitch_ns = time.perf_counter_ns() - ts0
            for i in range(n):
                _trace.finish_trace(children[i], walls[i])
            _trace.merge_sharded(parent, children)
            if parent is not None:
                parent.add("stitch", ts0, stitch_ns)
            wall = time.perf_counter() - t0
            _trace.finish_trace(parent, wall)
            compute = max(computes) if computes else 0.0
            self.profiler.record_cycle(
                gpu_s=compute, comm_s=max(wall - compute, 0.0),
                bytes_sent=tree_wire_bytes(args),
                bytes_received=tree_wire_bytes(out), fn=fn)
            self.last_shard_stats = {
                "call_id": cid, "fn": fn, "rows": plan.rows,
                "shards": plan.describe(), "destinations": list(assign),
                "failed": sorted(dead), "retry_rounds": retry_rounds,
                "wall_s": wall}
            return out
        finally:
            for i, nm in enumerate(assign):     # unwind an aborted round
                if acquired[i]:
                    reg.release(nm)
            for fe in frontends.values():   # release sync fallback threads
                fe.close()

    # -- proactive failure domain --------------------------------------
    def _pick_standby(self, primary: str) -> Optional[str]:
        """Scheduler's choice of warm standby: best routable destination
        that serves this library, excluding the primary (None when the pool
        has no second servable member)."""
        unservable = tuple(n for n in self.client.destinations
                           if not self.client.serves(n, self.lib))
        try:
            return self.client.scheduler.pick(
                self.workload, exclude=(primary,) + unservable,
                tenant=self.tenant).name
        except NoDestinationError:
            return None

    def _prepare_standby(self, name: str) -> None:
        """Make the model resident on the standby AHEAD of failure (send-
        once: a fingerprint check when the standby already holds it)."""
        self.client._sibling(self, name).ensure_model()

    def _rehome_to_standby(self, reason: str) -> bool:
        """Promote the warm standby to primary.  Warm means the standby
        already holds the model and a replicated snapshot at least as fresh
        as the host shadow — no state rebuild from host.  A stale standby
        (replication fell behind) is caught up from the shadow.  The dead
        runtime is closed only on ``failover`` — a draining node is alive
        and its runtime may be shared with other sessions.  Returns False
        (leaving the session untouched) when there is no standby or the
        promotion probe fails, so callers fall through to reactive paths."""
        if self._replica is None:
            return False
        self._replica.ensure_standby()
        t0 = time.perf_counter()
        promoted = self._replica.promote()
        if promoted is None:
            return False
        name, replicated_step = promoted
        old_rt, old_name = self.runtime, self.destination
        warm = False
        try:
            fresh = self.client._runtime_for(name)
            old_t = fresh.timeout
            fresh.timeout = min(5.0, old_t)
            try:
                fresh.ping()
            finally:
                fresh.timeout = old_t
            self.runtime = fresh
            self._ready = False
            cached = self.ensure_model()    # hit: standby was prepared
            shadow_step = (self._shadow.snapshot_step
                           if self._shadow is not None else -1)
            warm = 0 <= shadow_step <= replicated_step
            state = self._shadow.state if self._shadow is not None else None
            if not warm and state is not None:
                self.runtime.restore(self.fp, state)    # catch-up restore
        except Exception:  # noqa: BLE001 — promotion is best-effort
            self.runtime = old_rt
            self._ready = False
            self._replica.primary = old_name
            return False
        if reason == "failover":
            try:
                old_rt.close()  # dead node: fail its in-flight futures too
            except Exception:  # noqa: BLE001
                pass
        self.destination = name
        self._replica.primary = name
        self.rehomes += 1
        self.last_rehome = {"from": old_name, "to": name, "reason": reason,
                            "warm": warm,
                            "seconds": time.perf_counter() - t0}
        self.client.migration.record_rehome(
            old_name, name, warm=warm, cached=cached,
            seconds=self.last_rehome["seconds"], reason=reason)
        return True

    def _rehome_for_drain(self, exc: DestinationDraining) -> None:
        """The destination bounced the call because it is draining: stop
        routing there, promote the warm standby (or fall back to a planned
        live migration — the draining node still serves snapshot), retry is
        the caller's."""
        self.client.registry.mark_draining(self.destination)
        if self._rehome_to_standby("drain"):
            return
        unservable = tuple(n for n in self.client.destinations
                           if not self.client.serves(n, self.lib))
        try:
            self.destination = self.client.migration.migrate(
                self, self.workload, from_name=self.destination,
                exclude=unservable)
        except NoDestinationError:
            raise exc           # nowhere to go: surface the drain bounce

    def _recover_same_destination(self) -> bool:
        """Connection-level recovery: when only the CHANNEL died (reset,
        mid-frame timeout) but the destination process may be fine, re-dial
        the same endpoint and probe it — cheaper and state-preserving
        compared to migrating.  The shadow state is restored after
        reconnecting because the failed call may or may not have executed
        at the destination; resetting to the last snapshot makes the retry
        exact either way.  Returns True when the session is ready to retry
        on the same destination."""
        if not self.client.policy.failover:
            return False
        rt = self.runtime
        broken = (getattr(rt.channel, "broken", False)
                  or getattr(rt, "_closed", False)
                  or getattr(rt, "_broken", None) is not None)
        if not broken:
            return False
        try:
            fresh = self.client._runtime_for(self.destination)  # re-dials
            if fresh is rt:
                return False
            old_t = fresh.timeout
            fresh.timeout = min(5.0, old_t)
            try:
                fresh.ping()
            finally:
                fresh.timeout = old_t
            self.runtime = fresh
            self._ready = False
            hit = self.ensure_model()   # fingerprint hit if the node kept it
            state = self._shadow.state if self._shadow is not None else None
            dedup = bool(self.client.capabilities(self.destination)
                         .raw.get("replay_dedup"))
            # a node that KEPT the session (model hit) and dedups replays
            # must not be reset to the snapshot: if the failed call actually
            # executed there, the same-call_id retry answers from the replay
            # cache without re-executing, and a restored (pre-call) state
            # would then diverge from the acknowledged result.  Restore only
            # when the retry is guaranteed to re-execute (model re-sent ->
            # state gone, or the peer can't dedup).
            if state is not None and not (hit and dedup):
                self.runtime.restore(self.fp, state)
        except Exception:  # noqa: BLE001 — recovery is best-effort
            return False
        self.client.registry.mark_healthy(self.destination)
        return True

    def _failover_or_raise(self, exc: BaseException) -> None:
        if not self.client.policy.failover:
            raise exc
        if self._destination_alive():
            # a live node answered the probe: the failure is the CALL's
            # (application error, one slow request) — re-raising beats
            # migrating state away from a healthy destination
            raise exc
        # quarantine, not just mark_unhealthy: a heartbeat that flaps the
        # node healthy inside the cool-down must not make it routable again
        self.client.registry.quarantine(self.destination,
                                        self.client.migration.quarantine_s)
        dead_rt = self.runtime
        if self._rehome_to_standby("failover"):
            return              # warm promotion: standby already had state
        state = self._shadow.state if self._shadow is not None else None
        if state is None:
            state = {}          # nothing shadowed yet: restore empty state
        # never migrate onto a destination that can't serve this library
        unservable = tuple(n for n in self.client.destinations
                           if not self.client.serves(n, self.lib))
        try:
            new = self.client.migration.migrate(
                self, self.workload, from_name=self.destination,
                state=state, exclude=unservable)
        except NoDestinationError:
            try:                # pool exhausted: still don't leak the dead
                dead_rt.close() # runtime's channel/in-flight futures
            except Exception:  # noqa: BLE001
                pass
            raise exc           # nowhere to go: surface the original death
        self.destination = new

    def _destination_alive(self) -> bool:
        rt = self.runtime
        old_timeout = rt.timeout
        rt.timeout = min(5.0, old_timeout)   # probe, don't hang
        try:
            rt.ping()
            return True
        except Exception:  # noqa: BLE001 — any failure means dead
            return False
        finally:
            rt.timeout = old_timeout

    # ------------------------------------------------------------------
    def map(self, fn: str, requests: dict, *,
            batchable: Optional[bool] = None,
            max_shards: Optional[int] = None,
            shard: Optional[bool] = None) -> dict:
        """Fan ``{rid: args}`` out across the healthiest destinations (the
        ROADMAP's sharded-destinations step): requests round-robin over up
        to ``max_shards`` scheduler-ranked endpoints, each shard streaming
        through its own (pipelined where negotiated) runtime, weights
        ensured once per destination.  Only stateless per-request functions
        belong here — stateful decode streams must stay on one session.
        ``batchable`` defaults to each peer's advertised coalescing
        support.

        ``shard=True`` (``None`` defers to the ``shard_calls`` knob)
        additionally row-splits any single oversized request across the
        fan-out destinations and stitches it back — intra-call sharding on
        the map path.  A request whose leading axis is under the
        ``shard_min_rows`` floor always passes through whole, never as
        degenerate slivers."""
        limit = max_shards or self.client.policy.max_shards
        cands = [va for va in self.client.scheduler.candidates(
                     self.workload, tenant=self.tenant)
                 if self.client.serves(va.name, self.lib)]
        names = [va.name for va in cands][:limit] or [self.destination]
        frontends = []
        for nm in names:
            sib = self if nm == self.destination else \
                self.client._sibling(self, nm)
            sib.ensure_model()
            caps = self.client.capabilities(nm)
            b = batchable if batchable is not None else caps.coalesce
            frontends.append(PipelinedOffloadFrontend(
                sib.runtime, sib.fp, fn, batchable=b,
                tenant=self.tenant, qos=self.qos,
                detach_results=self.detach_results))
        if shard is None:
            shard = bool(global_config().get("shard_calls"))
        sharded = ShardedOffloadFrontend(
            frontends, names=names,
            planner=ShardPlanner() if shard else None)
        # hold the registry's live-load counters for the round-robin
        # assignment (shard i serves every len(names)-th request) so
        # concurrent sessions' scheduling sees this fan-out as load
        reg = self.client.registry
        counts = [len(range(i, len(requests), len(names)))
                  for i in range(len(names))]
        for nm, c in zip(names, counts):
            for _ in range(c):
                reg.acquire(nm)
        try:
            return sharded.map(requests)
        finally:
            for nm, c in zip(names, counts):
                for _ in range(c):
                    reg.release(nm)
            self.last_map_stats = sharded.stats()
            for fe in frontends:    # release sync-runtime fallback threads
                fe.close()


def connect(targets, *, policy: Optional[ConnectPolicy] = None,
            registry: Optional[AcceleratorRegistry] = None,
            **overrides) -> AvecClient:
    """Open AVEC's front door: handshake every target, negotiate runtime
    tiers/codecs, and return an :class:`AvecClient` routing through a
    capability-fed :class:`DeviceAwareScheduler`.

    ``targets`` — iterable of ``"tcp://host:port"`` URLs, in-process
    :class:`DestinationExecutor` instances, ``(AcceleratorSpec, target)``
    pairs, or :class:`Endpoint` objects.  ``policy`` (or keyword overrides
    of :class:`ConnectPolicy` fields, e.g. ``codec="zstd"``) sets host-side
    preferences; the handshake downgrades anything the peer can't do and
    raises :class:`HandshakeError` on a protocol-version mismatch."""
    if overrides:
        policy = replace(policy or ConnectPolicy(), **overrides)
    return AvecClient(targets, policy=policy, registry=registry)
