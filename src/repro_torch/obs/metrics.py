"""Counter/gauge/histogram registry with Prometheus text exposition.

Design: the hot path never pushes samples.  Existing subsystems already
keep their own counters under their own locks (``stats()``,
``pool_stats()``, ``tenant_stats``, ``HeartbeatMonitor.stats()``); the
``bind_*`` helpers below re-express those dicts as *scrape-time reads* —
a bound metric holds a callback that is invoked only when ``/metrics``
is rendered.  Direct ``inc()``/``set()``/``observe()`` is available for
code that has no stats surface of its own.

Lock discipline follows avecheck: every lock is a tracked lock from
:mod:`repro_torch.analysis.sanitize`, mutated state carries ``guarded-by``
annotations, and callbacks are never invoked while a registry or metric
lock is held (callbacks take foreign locks — executor ``_cv``, pool
locks — and holding ours across that would manufacture lock-order
edges).
"""
from __future__ import annotations

import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Iterable, Optional

from repro_torch.analysis import sanitize as _sanitize

DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _escape(value: str) -> str:
    return (str(value).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _fmt_labels(key: tuple) -> str:
    if not key:
        return ""
    return "{" + ",".join('%s="%s"' % (k, _escape(v)) for k, v in key) + "}"


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class _Metric:
    """Base: a named family of samples keyed by label set."""

    kind = "untyped"

    def __init__(self, name: str, doc: str) -> None:
        self.name = name
        self.doc = doc
        self._lock = _sanitize.make_lock(f"Metric[{name}]._lock")
        self._samples: dict[tuple, float] = {}      # guarded-by: _lock
        self._callbacks: list[tuple] = []           # guarded-by: _lock

    # -- binding (scrape-time reads) --------------------------------------
    def bind(self, fn: Callable[[], float], **labels) -> None:
        """Attach a zero-arg callback producing one sample with fixed
        labels every scrape."""
        with self._lock:
            self._callbacks.append((_label_key(labels), fn))

    def bind_samples(self, fn: Callable[[], Iterable[tuple]]) -> None:
        """Attach a callback producing ``(labels_dict, value)`` pairs —
        for dynamic label sets (e.g. one sample per live tenant)."""
        with self._lock:
            self._callbacks.append((None, fn))

    # -- collection -------------------------------------------------------
    def samples(self) -> list[tuple]:
        """``(label_key, value)`` pairs: static samples then callback
        reads.  Callbacks run outside our lock (they take foreign locks)."""
        with self._lock:
            static = sorted(self._samples.items())
            callbacks = list(self._callbacks)
        out = list(static)
        for key, fn in callbacks:
            try:
                if key is None:
                    for labels, value in fn():
                        out.append((_label_key(labels), float(value)))
                else:
                    out.append((key, float(fn())))
            except Exception:
                # A dead callback (torn-down runtime) must not poison
                # the whole exposition.
                continue
        return out


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = _label_key(labels)
        with self._lock:
            self._samples[key] = self._samples.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._samples.get(_label_key(labels), 0.0)


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._samples[_label_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._samples[key] = self._samples.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        with self._lock:
            return self._samples.get(_label_key(labels), 0.0)


class Histogram(_Metric):
    """Fixed-bucket histogram (cumulative at exposition, like Prometheus
    client libraries)."""

    kind = "histogram"

    def __init__(self, name: str, doc: str,
                 buckets: tuple = DEFAULT_BUCKETS) -> None:
        super().__init__(name, doc)
        self.buckets = tuple(sorted(buckets))
        self._counts: dict[tuple, list] = {}    # guarded-by: _lock
        self._sums: dict[tuple, float] = {}     # guarded-by: _lock
        self._totals: dict[tuple, int] = {}     # guarded-by: _lock

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            counts = self._counts.get(key)
            if counts is None:
                counts = self._counts[key] = [0] * len(self.buckets)
                self._sums[key] = 0.0
                self._totals[key] = 0
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    counts[i] += 1
            self._sums[key] += value
            self._totals[key] += 1

    def snapshot(self) -> list[tuple]:
        """``(label_key, cumulative_counts, sum, count)`` per label set."""
        with self._lock:
            return [(key, list(self._counts[key]), self._sums[key],
                     self._totals[key]) for key in sorted(self._counts)]


class MetricsRegistry:
    """Named metric families with get-or-create semantics and text
    exposition (Prometheus exposition format 0.0.4)."""

    def __init__(self) -> None:
        self._lock = _sanitize.make_lock("MetricsRegistry._lock")
        self._metrics: dict[str, _Metric] = {}      # guarded-by: _lock

    def _get_or_make(self, name: str, kind: str, doc: str,
                     factory: Callable[[], _Metric]) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
                return m
        if m.kind != kind:
            raise ValueError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested {kind}")
        return m

    def counter(self, name: str, doc: str) -> Counter:
        return self._get_or_make(name, "counter", doc,
                                 lambda: Counter(name, doc))

    def gauge(self, name: str, doc: str) -> Gauge:
        return self._get_or_make(name, "gauge", doc,
                                 lambda: Gauge(name, doc))

    def histogram(self, name: str, doc: str,
                  buckets: tuple = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_make(name, "histogram", doc,
                                 lambda: Histogram(name, doc, buckets))

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)

    def _collect(self) -> list[_Metric]:
        with self._lock:
            return [self._metrics[n] for n in sorted(self._metrics)]

    # -- exposition -------------------------------------------------------
    def render(self) -> str:
        """Prometheus text format: HELP/TYPE per family, then samples."""
        lines: list[str] = []
        for m in self._collect():
            lines.append(f"# HELP {m.name} {_escape(m.doc)}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            if isinstance(m, Histogram):
                for key, counts, total_sum, total in m.snapshot():
                    for bound, cnt in zip(m.buckets, counts):
                        bkey = key + (("le", _fmt_value(bound)),)
                        lines.append("%s_bucket%s %d"
                                     % (m.name, _fmt_labels(bkey), cnt))
                    ikey = key + (("le", "+Inf"),)
                    lines.append("%s_bucket%s %d"
                                 % (m.name, _fmt_labels(ikey), total))
                    lines.append("%s_sum%s %s"
                                 % (m.name, _fmt_labels(key),
                                    _fmt_value(total_sum)))
                    lines.append("%s_count%s %d"
                                 % (m.name, _fmt_labels(key), total))
            else:
                for key, value in m.samples():
                    lines.append("%s%s %s"
                                 % (m.name, _fmt_labels(key),
                                    _fmt_value(value)))
        return "\n".join(lines) + "\n"

    def sample_values(self) -> dict[str, float]:
        """Flat ``{name{labels}: value}`` snapshot — what the benches dump
        alongside each BENCH_dataplane.json section."""
        out: dict[str, float] = {}
        for m in self._collect():
            if isinstance(m, Histogram):
                for key, _, total_sum, total in m.snapshot():
                    out[m.name + "_sum" + _fmt_labels(key)] = total_sum
                    out[m.name + "_count" + _fmt_labels(key)] = float(total)
            else:
                for key, value in m.samples():
                    out[m.name + _fmt_labels(key)] = value
        return out


_GLOBAL_LOCK = threading.Lock()
_REGISTRY: Optional[MetricsRegistry] = None


def global_metrics() -> MetricsRegistry:
    """Process-wide default registry (module singleton)."""
    global _REGISTRY
    with _GLOBAL_LOCK:
        if _REGISTRY is None:
            _REGISTRY = MetricsRegistry()
        return _REGISTRY


# ----------------------------------------------------------------------
# View bindings over existing stats surfaces
# ----------------------------------------------------------------------

def _stat(fn_stats: Callable[[], dict], key: str,
          default: float = 0.0) -> Callable[[], float]:
    def read() -> float:
        return float(fn_stats().get(key, default))
    return read


def bind_runtime(reg: MetricsRegistry, runtime, **labels) -> None:
    """Expose a (pipelined) host runtime's ``stats()`` as metrics."""
    stats = runtime.stats
    reg.gauge("avec_inflight_window",
              "Current adaptive in-flight window of a pipelined host "
              "runtime (requests allowed on the wire at once)."
              ).bind(_stat(stats, "window"), **labels)
    reg.counter("avec_send_stalls_total",
                "Sends that hit socket backpressure and resumed via the "
                "receive pump.").bind(_stat(stats, "send_stalls"), **labels)
    reg.counter("avec_requests_completed_total",
                "Offloaded requests completed by the runtime."
                ).bind(_stat(stats, "requests_completed"), **labels)
    reg.counter("avec_bytes_sent_total",
                "Payload bytes written to the wire by the runtime."
                ).bind(_stat(stats, "bytes_sent"), **labels)
    reg.counter("avec_bytes_received_total",
                "Payload bytes read from the wire by the runtime."
                ).bind(_stat(stats, "bytes_received"), **labels)
    reg.gauge("avec_wire_ema_seconds",
              "EMA of per-request wire time observed by the adaptive "
              "window controller.").bind(_stat(stats, "wire_ema_s"),
                                         **labels)
    reg.gauge("avec_compute_ema_seconds",
              "EMA of per-request destination compute time observed by "
              "the adaptive window controller."
              ).bind(_stat(stats, "compute_ema_s"), **labels)

    reg.counter("avec_comm_quant_frames_total",
                "Request frames sent with a quantizing wire codec engaged "
                "(comm_quant: the adaptive window judged the link bound)."
                ).bind(_stat(stats, "quant_frames"), **labels)
    reg.counter("avec_comm_quant_bytes_saved_total",
                "Raw leaf bytes minus encoded frame bytes summed over "
                "quantized request frames (wire traffic comm_quant avoided)."
                ).bind(_stat(stats, "quant_bytes_saved"), **labels)

    def recv_pool_hit_rate() -> float:
        pool = stats().get("recv_pool") or {}
        return float(pool.get("hit_rate", 0.0))
    reg.gauge("avec_pool_hit_ratio",
              "BufferPool acquisition hit ratio (pooled frames / total)."
              ).bind(recv_pool_hit_rate, pool="recv", **labels)


def bind_executor(reg: MetricsRegistry, ex, **labels) -> None:
    """Expose a DestinationExecutor's tenant/coalesce stats as metrics."""
    def tenant_samples(key: str, scale: float = 1.0):
        def read():
            for tenant, st in ex.tenant_stats.items():
                yield (dict(labels, tenant=tenant),
                       float(st.get(key, 0.0)) * scale)
        return read

    reg.gauge("avec_tenant_drain_share",
              "Fraction of coalescer drain quanta spent on each tenant "
              "(weighted DRR outcome)."
              ).bind_samples(tenant_samples("drain_share"))
    reg.gauge("avec_tenant_queue_depth",
              "Requests queued per tenant at the destination coalescer."
              ).bind_samples(tenant_samples("queue_depth"))
    reg.gauge("avec_tenant_inflight",
              "Admitted in-flight requests per tenant at the destination."
              ).bind_samples(tenant_samples("inflight"))
    reg.counter("avec_tenant_served_total",
                "Requests served per tenant at the destination."
                ).bind_samples(tenant_samples("served"))
    reg.counter("avec_tenant_throttled_total",
                "Requests bounced with TenantThrottled per tenant."
                ).bind_samples(tenant_samples("throttled"))

    def total_inflight() -> float:
        return float(sum(st.get("inflight", 0)
                         for st in ex.tenant_stats.values()))
    reg.gauge("avec_inflight_window",
              "Current adaptive in-flight window of a pipelined host "
              "runtime (requests allowed on the wire at once)."
              ).bind(total_inflight, view="destination", **labels)

    co = getattr(ex, "_coalescer", None)
    if co is not None:
        reg.counter("avec_coalesce_batches_total",
                    "Coalesced dispatches executed at the destination."
                    ).bind(lambda: float(co.stats.get("batches", 0)),
                           **labels)
        reg.counter("avec_coalesce_requests_total",
                    "Requests that flowed through the coalescer."
                    ).bind(lambda: float(co.stats.get("requests", 0)),
                           **labels)
        reg.gauge("avec_coalesce_max_batch",
                  "Largest coalesced batch dispatched so far."
                  ).bind(lambda: float(co.stats.get("max_batch", 0)),
                         **labels)


def bind_pool_stats(reg: MetricsRegistry,
                    fn_stats: Callable[[], dict], **labels) -> None:
    """Expose a BufferPool ``stats()`` / TCPServer ``pool_stats()`` dict."""
    reg.gauge("avec_pool_hit_ratio",
              "BufferPool acquisition hit ratio (pooled frames / total)."
              ).bind(_stat(fn_stats, "hit_rate"), **labels)
    reg.counter("avec_pool_hits_total",
                "BufferPool acquisitions served from a slab."
                ).bind(_stat(fn_stats, "hits"), **labels)
    reg.counter("avec_pool_misses_total",
                "BufferPool acquisitions that fell back to the heap."
                ).bind(_stat(fn_stats, "misses"), **labels)
    reg.counter("avec_pool_wraps_total",
                "BufferPool ring wrap-arounds."
                ).bind(_stat(fn_stats, "wraps"), **labels)
    reg.gauge("avec_pool_outstanding",
              "Live leases currently held against the pool."
              ).bind(_stat(fn_stats, "outstanding"), **labels)


def bind_server(reg: MetricsRegistry, server, **labels) -> None:
    """Expose a TCPServer's aggregated recv-pool stats."""
    bind_pool_stats(reg, server.pool_stats, pool="server", **labels)


def bind_shm_channel(reg: MetricsRegistry, channel, **labels) -> None:
    """Expose a SharedMemoryChannel's ring counters (``stats()``) —
    occupancy is the capacity-planning signal for the ``shm_ring_bytes``
    knob, spills the symptom when it is sized too small."""
    stats = channel.stats
    reg.gauge("avec_shm_ring_occupancy",
              "Fraction of the shared-memory TX ring held by in-flight "
              "(not yet credited) frames."
              ).bind(_stat(stats, "ring_occupancy"), **labels)
    reg.gauge("avec_shm_tx_outstanding_frames",
              "Frames parked in the shared-memory TX ring awaiting the "
              "receiver's credit.").bind(
                  _stat(stats, "tx_outstanding_frames"), **labels)
    reg.counter("avec_shm_frames_total",
                "Frames carried through the shared-memory ring."
                ).bind(_stat(stats, "frames_sent"), direction="sent",
                       **labels)
    reg.counter("avec_shm_frames_total",
                "Frames carried through the shared-memory ring."
                ).bind(_stat(stats, "frames_received"),
                       direction="received", **labels)
    reg.counter("avec_shm_spills_total",
                "Frames too large for a ring slab that degraded to the "
                "doorbell socket.").bind(_stat(stats, "spills_sent"),
                                         direction="sent", **labels)
    reg.counter("avec_shm_spills_total",
                "Frames too large for a ring slab that degraded to the "
                "doorbell socket.").bind(_stat(stats, "spills_received"),
                                         direction="received", **labels)


def bind_heartbeat(reg: MetricsRegistry, monitor, **labels) -> None:
    """Expose a HeartbeatMonitor's stats() as metrics."""
    stats = monitor.stats
    reg.counter("avec_heartbeat_pings_total",
                "Heartbeat pings sent to a destination."
                ).bind(_stat(stats, "pings"), **labels)
    reg.counter("avec_heartbeat_missed_total",
                "Heartbeat pings that timed out or errored."
                ).bind(_stat(stats, "missed"), **labels)
    reg.counter("avec_heartbeat_failures_total",
                "K-miss failure declarations for a destination."
                ).bind(_stat(stats, "failures"), **labels)
    reg.counter("avec_heartbeat_flaps_total",
                "Failure -> recovery transitions observed."
                ).bind(_stat(stats, "flaps"), **labels)


def bind_sanitizer(reg: MetricsRegistry) -> None:
    """When ``AVEC_SANITIZE=1``, export the PR-7 runtime sanitizer's
    live state as gauges so it is scrapeable rather than assert-only."""
    if not _sanitize.enabled():
        return
    tracker = _sanitize.global_lease_tracker()
    recorder = _sanitize.global_lock_recorder()
    reg.gauge("avec_sanitizer_live_leases",
              "Live BufferPool leases tracked by the AVEC_SANITIZE=1 "
              "LeaseTracker.").bind(lambda: float(tracker.live_count()))
    reg.gauge("avec_sanitizer_lock_edges",
              "Distinct lock acquisition-order edges recorded by the "
              "AVEC_SANITIZE=1 LockOrderRecorder."
              ).bind(lambda: float(len(recorder.edges())))


# ----------------------------------------------------------------------
# Stdlib-only /metrics HTTP listener
# ----------------------------------------------------------------------

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsServer:
    """Daemon-thread HTTP listener serving ``GET /metrics`` for one
    registry.  Stdlib-only (``http.server``); one scrape per request."""

    def __init__(self, registry: MetricsRegistry,
                 host: str = "127.0.0.1", port: int = 0) -> None:
        self.registry = registry
        self.host = host
        self.port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MetricsServer":
        registry = self.registry

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:        # noqa: N802 (http.server API)
                if self.path.split("?", 1)[0] != "/metrics":
                    self.send_error(404)
                    return
                body = registry.render().encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args) -> None:
                pass    # scrapes are not log-worthy

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.2},
            name="avec-metrics", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
