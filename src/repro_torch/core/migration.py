"""Workload migration and fault tolerance (paper future-work ii).

* ``HeartbeatMonitor`` — pings a destination on an interval; after N
  consecutive misses marks it unhealthy in the registry and fires a callback.
* ``SessionShadow``    — host-side periodic snapshot of the destination's
  mutable session state (serving caches), so failover survives destination
  death (you cannot snapshot a dead node).
* ``MigrationManager`` — moves a session to a new destination: weights via
  the send-once cache path, state from a live snapshot (planned migration)
  or the shadow (failover), then swaps the session's runtime in place — the
  application keeps calling the same intercepted API.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from repro_torch.analysis import sanitize as _sanitize
from repro_torch.core.executor import HostRuntime
from repro_torch.core.interception import AvecSession
from repro_torch.core.scheduler import DeviceAwareScheduler
from repro_torch.core.virtualization import AcceleratorRegistry
from repro_torch.obs.config import global_config


class HeartbeatMonitor:
    """Liveness probe with K-consecutive-miss failure detection.

    A single missed ping is noise (GC pause, a saturated link); only
    ``misses`` consecutive misses declare the destination dead — registry
    marked unhealthy, ``failed`` set, ``on_failure`` fired.  The loop keeps
    monitoring after a failure: a destination that answers again is marked
    healthy, ``failed`` clears, the flap is counted, and ``on_recovery``
    fires (the scheduler's quarantine cool-down — not this monitor — decides
    when a flapping node may take new work again).  Ping intervals are
    jittered so a fleet of monitors started together does not synchronize
    into probe bursts."""

    def __init__(self, runtime: HostRuntime, name: str,
                 registry: AcceleratorRegistry, *,
                 interval_s: Optional[float] = None,
                 misses: Optional[int] = None,
                 timeout_s: Optional[float] = None,
                 jitter: float = 0.2, seed: int = 0,
                 on_failure: Optional[Callable[[str], None]] = None,
                 on_recovery: Optional[Callable[[str], None]] = None) -> None:
        import random
        cfg = global_config()
        self.runtime = runtime
        self.name = name
        self.registry = registry
        self.interval_s = float(cfg.resolve("heartbeat_interval_s",
                                            interval_s))
        self.misses = int(cfg.resolve("heartbeat_misses", misses))
        self.timeout_s = float(cfg.resolve("heartbeat_timeout_s", timeout_s))
        self.jitter = max(0.0, min(float(jitter), 0.95))
        self.on_failure = on_failure
        self.on_recovery = on_recovery
        self._rng = random.Random(seed if seed else hash(name) & 0xFFFF)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self.failed = threading.Event()
        self._lock = _sanitize.make_lock("HeartbeatMonitor._lock")
        self._pings = 0             # guarded-by: _lock (successful pings)
        self._missed = 0            # guarded-by: _lock (total missed, lifetime)
        self._consecutive = 0       # guarded-by: _lock (current miss streak)
        self._failures = 0          # guarded-by: _lock (times declared dead)
        self._flaps = 0             # guarded-by: _lock (dead -> alive recoveries)

    def start(self) -> "HeartbeatMonitor":
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                old_timeout = self.runtime.timeout
                self.runtime.timeout = self.timeout_s
                try:
                    self.runtime.ping()
                finally:
                    self.runtime.timeout = old_timeout
                with self._lock:
                    self._pings += 1
                    self._consecutive = 0
                if self.failed.is_set():
                    # the destination answered after being declared dead
                    with self._lock:
                        self._flaps += 1
                    self.registry.mark_healthy(self.name)
                    self.failed.clear()
                    if self.on_recovery:
                        self.on_recovery(self.name)
            except Exception:  # noqa: BLE001 — any ping failure counts
                with self._lock:
                    self._missed += 1
                    self._consecutive += 1
                    streak = self._consecutive
                if streak >= self.misses and not self.failed.is_set():
                    with self._lock:
                        self._failures += 1
                    self.registry.mark_unhealthy(self.name)
                    self.failed.set()
                    if self.on_failure:
                        self.on_failure(self.name)
            self._stop.wait(self.interval_s * self._rng.uniform(
                1.0 - self.jitter, 1.0 + self.jitter))

    def stats(self) -> dict:
        with self._lock:
            return {"pings": self._pings, "missed": self._missed,
                    "consecutive_misses": self._consecutive,
                    "failures": self._failures, "flaps": self._flaps}

    def stop(self) -> None:
        self._stop.set()


class SessionShadow:
    """Host-side copy of the latest session state snapshot."""

    def __init__(self, every_n_calls: int = 8) -> None:
        self.every_n_calls = every_n_calls
        self.state = None
        self.snapshot_step = -1
        self._calls = 0

    def maybe_snapshot(self, session: AvecSession, step: int) -> bool:
        self._calls += 1
        if self._calls % self.every_n_calls != 0:
            return False
        self.state = session.runtime.snapshot(session.fp)
        self.snapshot_step = step
        return True

    def force_snapshot(self, session: AvecSession, step: int) -> None:
        self.state = session.runtime.snapshot(session.fp)
        self.snapshot_step = step


class MigrationManager:
    def __init__(self, registry: AcceleratorRegistry,
                 scheduler: DeviceAwareScheduler,
                 runtime_factory: Callable[[str], HostRuntime],
                 quarantine_s: float = 5.0) -> None:
        """``runtime_factory(name)`` builds a HostRuntime connected to the
        named pool member (e.g. dials its TCP endpoint).  ``quarantine_s``
        is the routing cool-down imposed on a destination that just failed
        over — a lucky heartbeat recovery inside the window does not make
        it routable again."""
        self.registry = registry
        self.scheduler = scheduler
        self.runtime_factory = runtime_factory
        self.quarantine_s = quarantine_s
        self.migrations: list[dict] = []

    # ------------------------------------------------------------------
    def migrate(self, session: AvecSession, workload, *,
                from_name: str, state=None,
                exclude: tuple[str, ...] = ()) -> str:
        """Move ``session`` off ``from_name``.  ``state=None`` attempts a
        live snapshot (planned migration); otherwise uses the given state
        (failover from a shadow).  Returns the new destination name."""
        t0 = time.perf_counter()
        if state is None:
            state = session.runtime.snapshot(session.fp)
        target = self.scheduler.pick(workload, exclude=(from_name,) + exclude)
        new_rt = self.runtime_factory(target.name)
        old_rt = session.runtime
        session.runtime = new_rt
        session._ready = False
        cached = session.ensure_model()       # send-once: hit if already resident
        if state is not None:
            session.runtime.restore(session.fp, state)
        try:
            # runtime-level close, not bare channel close: a pipelined
            # runtime must also fail its in-flight futures so no caller
            # hangs on a response the dead destination will never send
            old_rt.close()
        except Exception:  # noqa: BLE001
            pass
        self.migrations.append({
            "from": from_name, "to": target.name,
            "cached": cached, "seconds": time.perf_counter() - t0,
        })
        return target.name

    def failover(self, session: AvecSession, workload, *, failed_name: str,
                 shadow: SessionShadow) -> str:
        """Failover after destination death: restore from the host shadow.

        The failed destination is quarantined for ``quarantine_s`` so the
        scheduler cannot route new work back the moment a heartbeat flaps
        it healthy.  If re-routing itself fails (``NoDestinationError`` —
        pool exhausted), the dead runtime is still closed so its channel
        and any pipelined in-flight futures do not leak; the session is
        left runtime-less rather than holding a stub to a dead node."""
        self.registry.quarantine(failed_name, self.quarantine_s)
        # an empty-dict state still restores (idempotent) — shadow.state can
        # legitimately be None when failure hit before the first snapshot,
        # and migrate(state=None) would try to live-snapshot the dead node
        state = shadow.state if shadow.state is not None else {}
        try:
            return self.migrate(session, workload, from_name=failed_name,
                                state=state)
        except BaseException:
            try:
                session.runtime.close()
            except Exception:  # noqa: BLE001 — already dead; close is best-effort
                pass
            raise

    def record_rehome(self, from_name: str, to_name: str, *, warm: bool,
                      cached: bool, seconds: float, reason: str) -> dict:
        """Ledger entry for a replica-group re-home (warm standby promotion)
        — same ``migrations`` list as :meth:`migrate` so operators and tests
        see one ordered history of every time a session changed homes."""
        entry = {"from": from_name, "to": to_name, "cached": cached,
                 "seconds": seconds, "warm": warm, "reason": reason}
        self.migrations.append(entry)
        return entry

    def record_shard_failover(self, from_name: str, ranges: list, *,
                              seconds: float) -> dict:
        """Ledger entry for an intra-call shard failover: destination
        ``from_name`` died (or drained) mid-sharded-call and only its row
        ``ranges`` re-executed elsewhere — the surviving shards answered
        the retry round from their replay caches.  Same ordered
        ``migrations`` history as whole-session re-homes."""
        entry = {"from": from_name, "to": None, "cached": False,
                 "seconds": seconds, "warm": False,
                 "reason": "shard-failover", "ranges": list(ranges)}
        self.migrations.append(entry)
        return entry
