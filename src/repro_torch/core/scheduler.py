"""Device-aware scheduling over the accelerator pool (paper future-work iii)
with hedged dispatch for straggler mitigation.

The scheduler scores every healthy pool member with the analytic cost model
(capability x link x current load) and picks the minimum-predicted-latency
destination.  ``hedged_call`` implements tail-latency mitigation: if the
primary destination does not answer within a deadline, the request is
duplicated to the runner-up and the first completion wins — AVEC's answer to
slow/overloaded edge nodes.

Data-plane feedback: bind a live host runtime to a pool member with
:meth:`DeviceAwareScheduler.attach_runtime` (its ``stats()`` snapshot is
pulled at scoring time), or push snapshots explicitly via
:meth:`DeviceAwareScheduler.record_runtime_stats`.  A member whose link
shows byte-level backpressure (send stalls per completed request, measured
per snapshot interval and EMA-decayed so a recovered link is forgiven)
gets its predicted latency penalized — the analytic link model can't see a
saturated socket buffer, but the runtime counters can.

Coalescer awareness (ROADMAP item, fed by the capability handshake): a
destination whose executor micro-batches concurrent ``run`` ops advertises
``coalesce`` + live ``coalesce_stats`` in its ping reply; push them via
:meth:`DeviceAwareScheduler.record_capabilities`.  Its observed average
batch size discounts the QUEUEING term of the score — n requests already
in flight there cost ~n/avg_batch stacked dispatches, not n serial ones —
so under load a batch-amortizing destination correctly outbids an
otherwise identical serial one (base link/compute terms are untouched:
coalescing amortizes dispatch, it does not speed up the wire).

Tenant awareness (multi-tenant fair-share serving): the same capability
ingest records the destination's per-tenant stats (``tenant_stats``: queue
depth, in-flight, throttle counts vs the advertised ``tenant_limits``).
Scoring with ``tenant=`` penalizes destinations where THAT tenant is
already saturated — at its admission cap, recently throttled, or sitting
on a deep drain queue — so a tenant's new sessions route around its own
hotspots instead of piling on (other tenants' scores are untouched)."""
from __future__ import annotations

import concurrent.futures as _fut
import threading
import time
from typing import Callable, Optional

from repro_torch.core.costmodel import Workload, estimate_request_time
from repro_torch.core.virtualization import AcceleratorRegistry, VirtualAccelerator


class NoDestinationError(RuntimeError):
    pass


class DeviceAwareScheduler:
    def __init__(self, registry: AcceleratorRegistry,
                 load_penalty: float = 1.0,
                 backpressure_penalty: float = 1.0,
                 stall_decay_halflife_s: float = 30.0,
                 tenant_penalty: float = 2.0) -> None:
        self.registry = registry
        self.load_penalty = load_penalty
        self.backpressure_penalty = backpressure_penalty
        self.stall_decay_halflife_s = stall_decay_halflife_s
        self.tenant_penalty = tenant_penalty
        self._stats_lock = threading.Lock()
        self._runtime_stats: dict[str, dict] = {}
        self._stall_rate: dict[str, float] = {}
        self._stall_seen: dict[str, float] = {}
        self._runtimes: dict[str, object] = {}
        self._avg_batch: dict[str, float] = {}
        self._tenant_stats: dict[str, dict] = {}
        self._tenant_limits: dict[str, dict] = {}

    # -- data-plane feedback -----------------------------------------------
    def attach_runtime(self, name: str, runtime) -> None:
        """Bind a live host runtime (anything with ``stats()``, i.e. a
        ``PipelinedHostRuntime``) to pool member ``name``; its counters are
        snapshotted automatically every time the member is scored."""
        with self._stats_lock:
            self._runtimes[name] = runtime

    def record_runtime_stats(self, name: str, stats: dict) -> None:
        """Ingest a ``PipelinedHostRuntime.stats()`` snapshot for pool
        member ``name`` (chosen adaptive window, stall/backpressure
        counters, byte totals).  The stall rate is computed over the DELTA
        from the previous snapshot and EMA-smoothed, so a transient
        backpressure burst decays once the link recovers instead of
        penalizing the member for the rest of the process lifetime."""
        with self._stats_lock:
            prev = self._runtime_stats.get(name)
            d_stalls = stats.get("send_stalls", 0)
            d_done = stats.get("requests_completed", 0)
            if prev is not None:
                d_stalls -= prev.get("send_stalls", 0)
                d_done -= prev.get("requests_completed", 0)
                if d_stalls < 0 or d_done < 0:      # runtime was replaced
                    d_stalls = stats.get("send_stalls", 0)
                    d_done = stats.get("requests_completed", 0)
            now = time.monotonic()
            if d_stalls or d_done:
                rate = min(float(d_stalls) / max(int(d_done), 1), 1.0)
                old = self._stall_rate.get(name)
                self._stall_rate[name] = (rate if old is None or prev is None
                                          else 0.5 * old + 0.5 * rate)
            elif prev is not None:
                # idle interval: decay by ELAPSED TIME, not per call —
                # rapid back-to-back scoring must not erase the penalty of
                # a link that simply hasn't been retried yet
                dt = now - self._stall_seen.get(name, now)
                if dt > 0:
                    self._stall_rate[name] = (
                        self._stall_rate.get(name, 0.0)
                        * 0.5 ** (dt / self.stall_decay_halflife_s))
            self._stall_seen[name] = now
            self._runtime_stats[name] = dict(stats)

    def record_capabilities(self, name: str, capabilities: dict) -> None:
        """Ingest a handshake capability dict for pool member ``name``
        (``DestinationExecutor._op_ping`` reply / the facade's
        ``Capabilities.raw``).  A coalescing destination's observed average
        batch size (``coalesce_stats``: requests/batches) becomes its
        dispatch-amortization factor; a destination that coalesces but has
        no traffic yet gets a conservative nominal factor so the capability
        still tips ties under load."""
        coalesce = bool(capabilities.get("coalesce"))
        cs = capabilities.get("coalesce_stats") or {}
        avg = 1.0
        if coalesce:
            if cs.get("batches"):
                avg = max(float(cs["requests"]) / float(cs["batches"]), 1.0)
            else:
                avg = 2.0       # capable but unmeasured: assume pairs
        ts = capabilities.get("tenant_stats") or {}
        tl = capabilities.get("tenant_limits") or {}
        with self._stats_lock:
            self._avg_batch[name] = avg
            self._tenant_stats[name] = {t: dict(s) for t, s in ts.items()}
            self._tenant_limits[name] = dict(tl)

    def _dispatch_amortization(self, name: str) -> float:
        with self._stats_lock:
            return self._avg_batch.get(name, 1.0)

    def tenant_stats(self, name: str, tenant: str | None = None) -> dict:
        """The recorded per-tenant destination stats (one tenant, or all)."""
        with self._stats_lock:
            stats = self._tenant_stats.get(name, {})
            if tenant is not None:
                return dict(stats.get(tenant, {}))
            return {t: dict(s) for t, s in stats.items()}

    def tenant_saturation(self, name: str, tenant: str) -> float:
        """How saturated ``tenant`` already is at destination ``name``, in
        [0, 1]: the max of (in-flight vs the advertised admission cap),
        (throttle share of its admission attempts), and (its drain-queue
        depth, soft-saturating).  0.0 when the destination never advertised
        stats for this tenant."""
        with self._stats_lock:
            ts = self._tenant_stats.get(name, {}).get(tenant)
            limits = self._tenant_limits.get(name, {})
        if not ts:
            return 0.0
        sat = 0.0
        max_inflight = limits.get("max_inflight") or 0
        if max_inflight:
            sat = max(sat, min(ts.get("inflight", 0) / max_inflight, 1.0))
        throttled = ts.get("throttled", 0)
        if throttled:
            # completions = the admission counter when present ("served"
            # counts every admitted run, coalesced or not); falling back to
            # the coalescer's "drained".  Never sum them — a coalesced
            # request increments BOTH, which would halve the penalty on
            # exactly the fair-drain destinations this term targets.
            completions = ts.get("served", ts.get("drained", 0))
            sat = max(sat, min(throttled / max(throttled + completions, 1),
                               1.0))
        depth = ts.get("queue_depth", 0)
        if depth:
            sat = max(sat, depth / (depth + 4.0))
        return sat

    def runtime_stats(self, name: str | None = None) -> dict:
        """The recorded data-plane snapshots (all members, or one)."""
        with self._stats_lock:
            if name is not None:
                return dict(self._runtime_stats.get(name, {}))
            return {k: dict(v) for k, v in self._runtime_stats.items()}

    def _backpressure_factor(self, name: str) -> float:
        with self._stats_lock:
            rt = self._runtimes.get(name)
        if rt is not None and hasattr(rt, "stats"):
            self.record_runtime_stats(name, rt.stats())
        with self._stats_lock:
            rate = self._stall_rate.get(name, 0.0)
        return 1.0 + self.backpressure_penalty * rate

    def score(self, w: Workload, va: VirtualAccelerator,
              tenant: str | None = None) -> float:
        # queueing discount: n in-flight requests at a coalescing
        # destination collapse into ~n/avg_batch stacked dispatches
        eff_inflight = va.inflight / self._dispatch_amortization(va.name)
        base = estimate_request_time(w, va.spec, eff_inflight,
                                     self.load_penalty)
        s = base * self._backpressure_factor(va.name)
        if tenant is not None:
            s *= 1.0 + self.tenant_penalty * self.tenant_saturation(va.name,
                                                                    tenant)
        return s

    def scored_candidates(self, w: Workload, exclude: tuple[str, ...] = (),
                          tenant: str | None = None
                          ) -> list[tuple[VirtualAccelerator, float]]:
        """Routable candidates WITH their predicted-latency scores, ranked
        best first.  The intra-call ``ShardPlanner`` (serving's
        shard plan) weights shard sizes by the inverse of these scores,
        so a backpressured destination gets proportionally fewer rows."""
        # routable, not merely healthy: a destination that advertised
        # ``draining`` in its handshake (or sits in a post-failover
        # quarantine cool-down) must stop receiving NEW placements while
        # its in-flight work bleeds and sessions re-home
        pool = [va for va in self.registry.routable()
                if va.name not in exclude
                and va.spec.mem_bytes >= w.model_bytes]
        scored = [(va, self.score(w, va, tenant)) for va in pool]
        scored.sort(key=lambda pair: pair[1])
        return scored

    def candidates(self, w: Workload, exclude: tuple[str, ...] = (),
                   tenant: str | None = None) -> list[VirtualAccelerator]:
        return [va for va, _ in self.scored_candidates(w, exclude, tenant)]

    def pick(self, w: Workload, exclude: tuple[str, ...] = (),
             tenant: str | None = None) -> VirtualAccelerator:
        cands = self.candidates(w, exclude, tenant)
        if not cands:
            raise NoDestinationError(
                f"no routable accelerator can host {w.name} "
                f"({w.model_bytes/1e9:.1f} GB model)")
        return cands[0]


def hedged_call(primary: Callable[[], object], backup: Optional[Callable[[], object]],
                hedge_after_s: float) -> tuple[object, str]:
    """Run ``primary``; if it has not completed after ``hedge_after_s``,
    launch ``backup`` concurrently and return the first success.
    Returns (result, winner) with winner in {"primary", "backup"}."""
    with _fut.ThreadPoolExecutor(max_workers=2) as pool:
        f1 = pool.submit(primary)
        try:
            return f1.result(timeout=hedge_after_s), "primary"
        except _fut.TimeoutError:
            pass
        if backup is None:
            return f1.result(), "primary"
        f2 = pool.submit(backup)
        done, _ = _fut.wait({f1, f2}, return_when=_fut.FIRST_COMPLETED)
        # prefer whichever finished without error
        for f in done:
            if not f.exception():
                return f.result(), ("primary" if f is f1 else "backup")
        remaining = ({f1, f2} - done)
        if remaining:
            f = remaining.pop()
            return f.result(), ("primary" if f is f1 else "backup")
        raise next(iter(done)).exception()
