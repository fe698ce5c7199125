"""Destination executor and host-side runtime (the AVEC forwarding pair).

This is the JAX package's ``core/executor.py`` with its jax seam replaced
by PyTorch: the executor keeps parameters and session state as tensors on
its ``device`` (``"cuda"`` unless the caller asks for the CPU), moves
arguments there, synchronizes the device around each call so ``compute_s``
is device time, and brings outputs back to host numpy before packing.  The
wire and the op set are unchanged, so a host of either package can drive a
destination of the other.

Protocol (msgpack header via core.serialization, tree payloads as buffers;
every response echoes the request's frame id so pipelined hosts can match
out-of-order completions):

  {"op": "ping", ...client info}          -> {"ok": True} + capabilities
  {"op": "has_model", "fp": ...}          -> {"resident": bool}
  {"op": "put_model", "fp", "lib": name}  + params tree -> {"ok": True,
                                             "transfer_s": float}
  {"op": "run", "fp", "fn": name, "codec",
   "batchable": bool}                     + inputs tree
       -> {"ok": True, "compute_s": float, "coalesced": int} + outputs tree
  {"op": "drop_session", "fp"}            -> {"ok": True}
  {"op": "snapshot", "fp"}                -> session state tree (migration)
  {"op": "restore", "fp"}  + state tree   -> {"ok": True}

The executor times destination compute separately ("GPU time" in the paper's
Figs. 8-9) so the host profiler can attribute the cycle without clock
synchronization.

Data-plane additions (paper Figs. 8-9 show communication + serialization
dominating the cycle; these are the levers that shrink it):

* **Call coalescing** (``DestinationExecutor(coalesce=True)``): concurrent
  ``run`` ops marked ``batchable`` with the same (fingerprint, fn, codec,
  leaf signature) are drained from a queue and dispatched as ONE stacked
  device call (leaves concatenated on axis 0), amortizing tree traversal and
  dispatch overhead across clients.  Stateful ops (decode) must not set
  ``batchable``.
* **Per-tenant QoS drain** (multi-tenant fair-share serving): the coalescer
  keeps one sub-queue per tenant (``meta["tenant"]``) and drains them by
  weighted deficit-round-robin — weights and priority classes declared in
  the frame metadata (``meta["qos"] = {"weight": w, "priority": p}``, see
  ``repro.avec.QoS``) or pinned server-side via ``tenant_weights``.
  Coalescing still micro-batches within a tenant's (fp, fn, signature) key,
  but one tenant's batch train can no longer starve another's: under
  contention each tenant's drain share converges to its weight share, and a
  higher priority class is always served next (an already-dispatched batch
  is never preempted).  A lone active tenant gets full ``max_coalesce``
  batches — fairness costs nothing when there is no contention.
* **Admission control** (``tenant_max_inflight`` / ``tenant_max_bytes``):
  a tenant at its in-flight or bytes cap gets a typed ``TenantThrottled``
  response (``{"ok": False, "throttled": True, "retry_after_s": ...}``)
  instead of a queue slot; host runtimes retry with jittered backoff
  (``throttle_retries``), so a saturated tenant backs off instead of
  ballooning the destination's queues.  The first request of an idle tenant
  is always admitted (a single request larger than the bytes cap must not
  starve forever).
* **Per-tenant stats in the handshake**: the ping reply carries
  ``tenant_stats`` (queue depth, drain share, throttle count, in-flight)
  and ``tenant_limits`` so ``DeviceAwareScheduler`` can penalize
  destinations where the *calling* tenant is already saturated.
* **Pipelined host** (``PipelinedHostRuntime``): keeps up to N request
  frames in flight on one channel, matching responses by frame id — frame
  k+1 serializes and transmits while frame k computes at the destination
  (double-buffered offload).
* **Resumable, backpressure-aware sends**: over TCP, request frames go out
  through a non-blocking resumable state machine
  (``TCPChannel.try_send_resume``).  When the kernel send buffer fills —
  the byte-level backpressure of a narrow real link — the submitter parks
  the partial frame and pumps RECEIVES until the socket is writable again,
  so host and destination can never deadlock on mutually-full buffers.
* **Adaptive in-flight window**: ``max_in_flight`` is a cap, not the
  operating point.  The runtime sizes the live window from the observed
  comm/compute ratio (per-response ``compute_s`` vs measured wire time):
  ~2 when destination compute dominates (double buffering suffices), and
  growing toward the cap as the link dominates.
* **Pooled receive buffers** (``repro_torch.core.memory``): frames arrive in
  recycled ``BufferPool`` slabs as ``BufferLease``s.  Runtimes release the
  base reference once a response is unpacked (``_rpc`` / pipelined
  ``_dispatch``); decoded zero-copy leaves pin the lease until collected.
  On the destination, the transport releases a request after the response
  is written, and the coalescer ``retain``s queued requests until their
  batch dispatches — steady-state offload allocates zero payload buffers
  per received frame.

Runtime stats (``PipelinedHostRuntime.stats()``) — exported to
``DeviceAwareScheduler.record_runtime_stats`` (and serving's
``PipelinedOffloadFrontend.stats``):

  bytes_sent / bytes_received   wire totals (cv-protected counters)
  in_flight                     currently outstanding requests
  window / max_in_flight        chosen adaptive window and its configured cap
  send_stalls                   would-block events on the send path
                                (byte-level backpressure hits)
  sends_resumed                 frames that needed >1 non-blocking attempt
  recv_retries                  clean channel recv timeouts retried inside
                                the pump (caller deadline not yet expired)
  throttle_retried              TenantThrottled admission responses retried
                                with jittered backoff
  requests_completed            responses dispatched to futures
  wire_ema_s / compute_ema_s    the smoothed comm/compute estimates driving
                                the window controller
"""
from __future__ import annotations

import collections
import itertools
import math
import random
import socket as _socket
import threading
import time
import traceback
from concurrent.futures import Future
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.analysis import sanitize as _sanitize
from repro_torch.core.cache import ModelCache
from repro_torch.core.memory import BufferLease, release_buffer
from repro_torch.core.serialization import (PROTOCOL_VERSION, SUPPORTED_CODECS,
                                      Frame, frame_preamble_ok,
                                      frame_request_id, pack_message,
                                      tree_wire_bytes, unpack_message)
from repro_torch.core.transport import Channel, ChannelClosed, ProtocolError
from repro_torch.models.params import from_numpy_tree
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import trace as _trace
from repro_torch.obs.config import global_config
from repro_torch.utils import (concat_rows, dtype_name, resolve_device, to_numpy_tree,
                               tree_flatten, tree_leaves, tree_map, tree_unflatten)


class RemoteError(RuntimeError):
    pass


class TenantThrottled(RemoteError):
    """Typed destination backpressure: the calling tenant is at its
    admission cap (in-flight requests or bytes).  Carries the destination's
    ``retry_after_s`` hint; host runtimes retry with jittered backoff up to
    ``throttle_retries`` before surfacing the error."""

    def __init__(self, msg: str, tenant: str = "default",
                 retry_after_s: float = 0.01) -> None:
        super().__init__(msg)
        self.tenant = tenant
        self.retry_after_s = retry_after_s


class DestinationDraining(RemoteError):
    """Typed zero-downtime-drain response: the destination is ALIVE (it
    still serves in-flight work, snapshots, and pings) but admits no new
    ``run`` ops.  Never retried locally and never treated as a death —
    the session layer re-homes to its warm standby instead."""

    def __init__(self, msg: str, destination: str = "?") -> None:
        super().__init__(msg)
        self.destination = destination


def _remote_exception(rmeta: dict) -> RemoteError:
    """The typed host-side exception for a ``{"ok": False}`` response."""
    msg = rmeta.get("error", "unknown remote error")
    if rmeta.get("throttled"):
        return TenantThrottled(msg, rmeta.get("tenant", DEFAULT_TENANT),
                               float(rmeta.get("retry_after_s", 0.01)))
    if rmeta.get("draining"):
        return DestinationDraining(msg, rmeta.get("name", "?"))
    return RemoteError(msg)


def wire_error_meta(exc: BaseException) -> dict:
    """The typed-flag metadata for an exception crossing the wire — the
    inverse of :func:`_remote_exception` (see serialization.WIRE_ERRORS).

    ``DestinationExecutor.handle`` merges this into its generic error
    response so a :class:`TenantThrottled`/:class:`DestinationDraining`
    raised *inside* op handling (a coalesced future, a nested call) reaches
    the client as the same typed exception it would have been as a direct
    ``_op_run`` response — not as a flag-less generic ``RemoteError``."""
    if isinstance(exc, TenantThrottled):
        return {"throttled": True, "tenant": exc.tenant,
                "retry_after_s": exc.retry_after_s}
    if isinstance(exc, DestinationDraining):
        return {"draining": True, "name": exc.destination}
    return {}


def _clone_channel_exc(exc: BaseException) -> BaseException:
    """A traceback-free copy of a channel-failure exception, same type and
    message.  Stored (and re-raised) instead of the original: an exception
    object held for a dead runtime's lifetime grows a traceback on every
    raise, and that traceback pins the raising frames' locals — decoded
    result trees and their recv-pool leases included."""
    try:
        return type(exc)(*exc.args) if exc.args else type(exc)(str(exc))
    except Exception:  # noqa: BLE001 — exotic ctor signature
        return ChannelClosed(f"{type(exc).__name__}: {exc}")


def _throttle_backoff(attempt: int, retry_after_s: float) -> float:
    """Jittered exponential backoff for TenantThrottled retries.  Full
    jitter (0.5x-1.5x) decorrelates tenants that were throttled together —
    synchronized retries would just collide at the admission gate again."""
    base = min(max(retry_after_s, 1e-3) * (2 ** attempt), 0.5)
    return base * random.uniform(0.5, 1.5)


# ---------------------------------------------------------------------------
# Destination-side call coalescing
# ---------------------------------------------------------------------------

def _batch_signature(tree: Any) -> tuple:
    """Structure + per-leaf (trailing shape, dtype) — two requests coalesce
    only when their trees differ in leading (batch) dim alone."""
    leaves, treedef = tree_flatten(tree)
    sig = tuple((tuple(np.shape(l))[1:], dtype_name(l)) for l in leaves)
    return (str(treedef), sig)


DEFAULT_TENANT = "default"


def _gethostname() -> str:
    try:
        return _socket.gethostname()
    except OSError:  # pragma: no cover - hostname lookup failure
        return "unknown"

#: weights are clamped here so a ~zero declared weight cannot make the DRR
#: rotation spin unboundedly before its tenant accrues one request's deficit
_MIN_WEIGHT = 0.01


class _TenantQueue:
    """One tenant's pending sub-queue + its deficit-round-robin state."""

    __slots__ = ("name", "items", "deficit", "weight", "priority", "active",
                 "enqueued", "drained", "batches")

    def __init__(self, name: str) -> None:
        self.name = name
        self.items: collections.deque = collections.deque()
        self.deficit = 0.0
        self.weight = 1.0           # empty/undeclared qos defaults
        self.priority = 0
        self.active = False
        self.enqueued = 0
        self.drained = 0
        self.batches = 0


class _QoSQueues:
    """Per-tenant sub-queues drained by weighted deficit-round-robin, with
    strict priority classes.

    NOT thread-safe: the coalescer calls every method under its condition
    variable.  Items are ``(key, meta, tree, future, lease)`` tuples (the
    last element is the request frame's recv-pool ``BufferLease`` or
    ``None`` — retained on enqueue, released after the batch holding the
    item dispatches); a *batch* is a run of consecutive same-key items from
    ONE tenant's queue (coalescing never mixes tenants into a stacked
    dispatch).

    Scheduling: the highest priority class with pending work is served
    first.  Within a class, tenants are visited round-robin; each visit
    adds ``weight * (max_batch / max_active_weight)`` to the tenant's
    deficit, and the tenant may drain up to ``floor(deficit)`` requests
    (capped at ``max_batch``) — so the heaviest tenant fills whole batches
    while drain *shares* converge to the weight ratio.  A lone active
    tenant bypasses the deficit entirely (full batches, zero fairness tax).
    """

    def __init__(self, tenant_weights: dict | None = None) -> None:
        self._tenant_weights = dict(tenant_weights or {})   # server pins
        self._tenants: dict[str, _TenantQueue] = {}
        self._rotation: dict[int, collections.deque] = {}   # priority -> RR
        self.pending = 0

    # ------------------------------------------------------------------
    def push(self, tenant: str, qos: dict | None, item: tuple) -> None:
        tq = self._tenants.get(tenant)
        if tq is None:
            tq = self._tenants[tenant] = _TenantQueue(tenant)
        qos = qos or {}
        declared = self._tenant_weights.get(tenant, qos.get("weight", None))
        if declared is not None:
            tq.weight = max(float(declared), _MIN_WEIGHT)
        if not tq.active:           # priority moves only between activations
            tq.priority = int(qos.get("priority", tq.priority))
            tq.active = True
            tq.deficit = 0.0
            self._rotation.setdefault(tq.priority,
                                      collections.deque()).append(tq)
        tq.items.append(item)
        tq.enqueued += 1
        self.pending += 1

    def _deactivate(self, tq: _TenantQueue) -> None:
        tq.active = False
        tq.deficit = 0.0
        rot = self._rotation.get(tq.priority)
        if rot is not None:
            try:
                rot.remove(tq)
            except ValueError:
                pass
            if not rot:
                del self._rotation[tq.priority]

    # ------------------------------------------------------------------
    def next_batch(self, max_batch: int) -> tuple[_TenantQueue, tuple, list]:
        """Pick the next tenant (priority, then DRR) and take its head
        batch.  Caller guarantees ``pending > 0``."""
        prio = max(self._rotation)
        rot = self._rotation[prio]
        if self.pending == len(rot[0].items):
            # the sole ACTIVE tenant holds everything pending (inactive
            # tenants linger in _tenants for stats but hold no items):
            # no contention, fairness is moot, serve full batches
            tq = rot[0]
            tq.deficit = 0.0
            budget = max_batch
        else:
            max_w = max(t.weight for t in rot)
            quantum = max_batch / max_w
            while True:
                tq = rot[0]
                rot.rotate(-1)
                # cap stops unbounded accrual when a tenant's queue head is
                # fragmented across keys and it can't spend its deficit
                tq.deficit = min(tq.deficit + tq.weight * quantum,
                                 2.0 * max_batch)
                if tq.deficit >= 1.0 and tq.items:
                    break
            budget = min(int(tq.deficit), max_batch)
        key = tq.items[0][0]
        batch = self.take_matching(tq, key, budget)
        if batch:
            # one dispatched batch per next_batch call — window-fill grows
            # THIS batch via further take_matching calls, so the per-tenant
            # batch counter (the handshake's amortization signal) must tick
            # here, not per take
            tq.batches += 1
        return tq, key, batch

    def take_matching(self, tq: _TenantQueue, key: tuple, n: int) -> list:
        """Consume up to ``n`` consecutive head items of ``tq`` matching
        ``key`` (an incompatible head flushes the batch, as before).  Does
        NOT count a batch — callers growing an existing batch reuse this."""
        batch = []
        while len(batch) < n and tq.items and tq.items[0][0] == key:
            batch.append(tq.items.popleft())
        tq.deficit = max(tq.deficit - len(batch), 0.0)
        tq.drained += len(batch)
        self.pending -= len(batch)
        if tq.active and not tq.items:
            self._deactivate(tq)
        return batch

    def drain_all(self) -> list:
        """Remove and return every pending item (shutdown)."""
        items = []
        for tq in self._tenants.values():
            items.extend(tq.items)
            tq.items.clear()
            if tq.active:
                self._deactivate(tq)
        self.pending = 0
        return items

    def stats(self) -> dict:
        total = sum(t.drained for t in self._tenants.values())
        return {name: {
            "queue_depth": len(tq.items),
            "enqueued": tq.enqueued,
            "drained": tq.drained,
            "batches": tq.batches,
            "drain_share": (tq.drained / total) if total else 0.0,
            "weight": tq.weight,
            "priority": tq.priority,
        } for name, tq in self._tenants.items()}


class _Coalescer:
    """Micro-batches compatible ``run`` requests into one stacked dispatch,
    draining per-tenant sub-queues fairly (see :class:`_QoSQueues`).

    ``submit`` blocks the calling (per-connection) thread on a future; a
    single worker picks the next tenant by priority + weighted DRR, takes
    up to its deficit's worth of consecutive compatible requests,
    concatenates their leaves along axis 0, runs the library function once,
    and splits outputs back per request.  The coalescing window (waiting up
    to ``window_s`` for more compatible arrivals) only opens when nothing
    else is pending anywhere — under contention, fairness beats batching."""

    def __init__(self, execute: Callable, window_s: float = 0.002,
                 max_batch: int = 8,
                 tenant_weights: dict | None = None) -> None:
        self._execute = execute     # (key, metas, trees) -> list[(meta, tree)]
        self.window_s = window_s
        self.max_batch = max_batch
        self._cv = _sanitize.make_condition("_Coalescer._cv")
        self._q = _QoSQueues(tenant_weights)   # guarded-by: _cv
        self._stopped = False                  # guarded-by: _cv
        self.stats = {"batches": 0, "requests": 0, "max_batch": 0}
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def submit(self, key: tuple, meta: dict, tree: Any,
               lease: BufferLease | None = None) -> tuple[dict, Any]:
        """``lease`` — the request frame's recv-pool lease, if any.  The
        coalescer takes one reference atomically with the enqueue (so the
        frame's bytes survive in the queue past the connection loop's own
        release) and drops it after the batch holding this request is
        dispatched — or in the stop-drain if the executor shuts down
        first."""
        fut: Future = Future()
        # check-stop and enqueue are atomic vs stop(): nothing can be put
        # after the stop flag is set, so the post-stop drain is exhaustive
        with self._cv:
            if self._stopped:
                raise ChannelClosed("coalescer stopped")
            if lease is not None:
                lease.retain()      # ownership transfers with the enqueue
            tenant = meta.get("tenant") or DEFAULT_TENANT
            # trailing element: enqueue timestamp, so traced requests can
            # attribute their destination wait to queue vs coalesce spans
            self._q.push(tenant, meta.get("qos"),   # avecheck: handoff
                         (key, meta, tree, fut, lease, time.perf_counter_ns()))
            self._cv.notify_all()
        return fut.result()

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        self._worker.join(timeout=1.0)
        self._drain_failed()

    def _drain_failed(self) -> None:
        with self._cv:
            left = self._q.drain_all()
        for item in left:
            if not item[3].done():
                item[3].set_exception(ChannelClosed("coalescer stopped"))
            release_buffer(item[4])     # never strand a queued frame's lease

    @property
    def tenant_stats(self) -> dict:
        with self._cv:
            return self._q.stats()

    # ------------------------------------------------------------------
    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._stopped and self._q.pending == 0:
                    self._cv.wait()
                if self._stopped:
                    break
                tq, key, batch = self._q.next_batch(self.max_batch)
                picked_at = time.perf_counter_ns()
                if len(batch) < self.max_batch:
                    # window-fill: wait for more compatible arrivals, but
                    # ONLY while nothing else (any tenant) is pending —
                    # holding a batch open under contention would tax every
                    # other tenant's latency for this tenant's throughput
                    deadline = time.monotonic() + self.window_s
                    while (len(batch) < self.max_batch
                           and not self._stopped and self._q.pending == 0):
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cv.wait(timeout=remaining)
                        batch += self._q.take_matching(
                            tq, key, self.max_batch - len(batch))
            self._dispatch(batch, picked_at)
            # drop the reference before parking on the cv: a lingering
            # `batch` local would pin the last batch's trees (and their
            # recv-pool leases' leaf pins) across the worker's entire idle
            # period
            batch = tq = key = None
        self._drain_failed()

    def _dispatch(self, batch: list, picked_at: int | None = None) -> None:
        key = batch[0][0]
        metas = [b[1] for b in batch]
        trees = [b[2] for b in batch]
        t_exec = time.perf_counter_ns()
        try:
            results = self._execute(key, metas, trees)
            self.stats["batches"] += 1
            self.stats["requests"] += len(batch)
            self.stats["max_batch"] = max(self.stats["max_batch"], len(batch))
            for item, res in zip(batch, results):
                meta, fut, t_enq = item[1], item[3], item[5]
                if meta.get("trace") is not None:
                    # queue: enqueue -> DRR pick; coalesce: window fill
                    # until execution began.  Window-fill stragglers
                    # (enqueued after the pick) clamp queue to zero.
                    pick = min(picked_at if picked_at is not None
                               else t_exec, t_exec)
                    res[0]["_waits"] = [
                        ("queue", t_enq, max(pick - t_enq, 0)),
                        ("coalesce", max(pick, t_enq),
                         max(t_exec - max(pick, t_enq), 0))]
                fut.set_result(res)
        except Exception as e:  # noqa: BLE001 — propagate per request
            for item in batch:
                if not item[3].done():
                    item[3].set_exception(e)
        finally:
            # batch dispatched (stacked leaves were copied, outputs are
            # fresh arrays): the queued request frames' bytes are done
            for item in batch:
                release_buffer(item[4])


class DestinationExecutor:
    """Runs registered libraries' functions on the destination accelerator.

    ``libraries`` maps library name -> {fn_name: callable(params, *args)}.
    A *session* is (model fingerprint -> params + mutable state); the state
    slot carries serving caches so sessions can be snapshot/migrated.

    With ``coalesce=True``, concurrent batchable ``run`` ops micro-batch into
    one stacked dispatch, drained fairly across tenants (see module
    docstring).  ``tenant_weights`` pins per-tenant drain weights
    server-side (overriding frame-declared qos); ``tenant_max_inflight`` /
    ``tenant_max_bytes`` cap one tenant's concurrently admitted ``run``
    requests / payload bytes (0 = unlimited) — beyond the cap the tenant
    gets a typed ``TenantThrottled`` response instead of a queue slot.

    ``device`` is where parameters, session state and arguments live
    (``"cuda"`` unless the caller asks for ``"cpu"``; no quiet fallback)."""

    def __init__(self, libraries: dict[str, dict[str, Callable]],
                 cache: ModelCache | None = None, name: str = "dest", *,
                 device="cuda",
                 coalesce: bool = False,
                 coalesce_window_s: float | None = None,
                 max_coalesce: int | None = None,
                 tenant_weights: dict | None = None,
                 tenant_max_inflight: int | None = None,
                 tenant_max_bytes: float | None = None,
                 replay_cache: int | None = None) -> None:
        cfg = global_config()
        self.device = resolve_device(device)
        self.libraries = libraries
        self.cache = cache or ModelCache()
        self.name = name
        self.fail = False          # fault-injection switch (tests/migration)
        self.draining = False      # zero-downtime drain: stop admitting runs
        # set by launch.serve (or tests) when an SHM doorbell listens beside
        # the TCP port: the ping handshake advertises it so same-host
        # clients auto-upgrade to the zero-copy transport
        self.shm_address: str | None = None
        self.coalesce_window_s = float(cfg.resolve("coalesce_window_s",
                                                   coalesce_window_s))
        self.max_coalesce = int(cfg.resolve("max_coalesce", max_coalesce))
        self.tenant_max_inflight = int(cfg.resolve("tenant_max_inflight",
                                                   tenant_max_inflight))
        self.tenant_max_bytes = float(cfg.resolve("tenant_max_bytes",
                                                  tenant_max_bytes))
        self._adm_lock = _sanitize.make_lock("DestinationExecutor._adm_lock")
        self._adm: dict[str, dict] = {}     # guarded-by: _adm_lock (tenant -> admission counters)
        self._tls = threading.local()       # per-connection-thread recv lease
        # idempotent replay guard: per-session LRU of recently served
        # call ids -> completed responses.  A failover retry of a call the
        # destination DID finish (only the ack was lost) replays the cached
        # result instead of executing twice.
        self.replay_cache = int(cfg.resolve("replay_cache", replay_cache))
        self._replay_lock = _sanitize.make_lock(
            "DestinationExecutor._replay_lock")
        self._replay: dict[str, collections.OrderedDict] = {}  # guarded-by: _replay_lock
        self.replay_hits = 0                                   # guarded-by: _replay_lock
        self._coalescer = (_Coalescer(self._run_batch,
                                      self.coalesce_window_s,
                                      self.max_coalesce, tenant_weights)
                           if coalesce else None)
        # per-destination metric views (scrape-time reads over the stats
        # surfaces above; see repro_torch.obs.metrics) — served by the `metrics`
        # control op and launch.serve's /metrics listener
        self.metrics = _obs_metrics.MetricsRegistry()
        _obs_metrics.bind_executor(self.metrics, self)
        _obs_metrics.bind_sanitizer(self.metrics)

    @property
    def coalesce_stats(self) -> dict:
        return dict(self._coalescer.stats) if self._coalescer else {}

    @property
    def tenant_stats(self) -> dict:
        """Live per-tenant serving stats: admission counters (in-flight,
        bytes in flight, throttle/served counts) merged with the coalescer's
        drain stats (queue depth, drain share, weight) — the payload the
        ping handshake advertises to host schedulers."""
        drain = self._coalescer.tenant_stats if self._coalescer else {}
        with self._adm_lock:
            adm = {t: dict(c) for t, c in self._adm.items()}
        out: dict[str, dict] = {}
        served_total = sum(c["served"] for c in adm.values()) or 0
        for tenant in set(adm) | set(drain):
            row = dict(drain.get(tenant, {}))
            row.update(adm.get(tenant, {}))
            if "drain_share" not in row and served_total:
                row["drain_share"] = row.get("served", 0) / served_total
            out[tenant] = row
        return out

    def shutdown(self) -> None:
        if self._coalescer:
            self._coalescer.stop()

    # -- zero-downtime drain -------------------------------------------
    def pending_work(self) -> int:
        """Admitted-but-unfinished ``run`` ops plus coalescer queue depth —
        what a drain waits to bleed to zero."""
        with self._adm_lock:
            inflight = sum(st["inflight"] for st in self._adm.values())
        queued = 0
        if self._coalescer is not None:
            with self._coalescer._cv:
                queued = self._coalescer._q.pending
        return inflight + queued

    def drain(self, timeout_s: float = 30.0, poll_s: float = 0.005) -> dict:
        """Zero-downtime drain: stop admitting new ``run`` ops (they get a
        typed ``draining`` response so sessions re-home), keep serving
        everything already admitted — the coalescer's QoS queues bleed
        through their normal fair drain — and block until nothing is
        pending (or ``timeout_s``).  Snapshot/restore/ping stay served
        throughout, so standbys can warm up while the node bleeds."""
        self.draining = True
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline and self.pending_work():
            time.sleep(poll_s)
        pending = self.pending_work()
        return {"drained": pending == 0, "pending": pending}

    # -- idempotent replay guard ---------------------------------------
    def _replay_get(self, fp: str, call_id: str):
        with self._replay_lock:
            lru = self._replay.get(fp)
            if lru is None or call_id not in lru:
                return None
            lru.move_to_end(call_id)
            self.replay_hits += 1
            return lru[call_id]

    def _replay_put(self, fp: str, call_id: str, rmeta: dict, rtree) -> None:
        with self._replay_lock:
            lru = self._replay.setdefault(fp, collections.OrderedDict())
            lru[call_id] = (dict(rmeta), rtree)
            while len(lru) > self.replay_cache:
                lru.popitem(last=False)

    # -- per-tenant admission control ----------------------------------
    def _adm_entry(self, tenant: str) -> dict:  # avecheck: ignore[lock] -- callers hold _adm_lock
        st = self._adm.get(tenant)
        if st is None:
            st = self._adm[tenant] = {"inflight": 0, "bytes_inflight": 0,
                                      "throttled": 0, "served": 0}
        return st

    def _admit(self, tenant: str, nbytes: int) -> tuple[bool, float]:
        """-> (admitted, retry_after_s).  The first request of an idle
        tenant is always admitted, so a cap smaller than one request cannot
        starve it forever."""
        with self._adm_lock:
            st = self._adm_entry(tenant)
            over_inflight = (self.tenant_max_inflight
                             and st["inflight"] >= self.tenant_max_inflight)
            over_bytes = (self.tenant_max_bytes
                          and st["bytes_inflight"] + nbytes
                          > self.tenant_max_bytes)
            if st["inflight"] and (over_inflight or over_bytes):
                st["throttled"] += 1
                depth = st["inflight"]
                if self._coalescer:
                    depth += self._coalescer.tenant_stats.get(
                        tenant, {}).get("queue_depth", 0)
                return False, min(0.25, 0.005 * (depth + 1))
            st["inflight"] += 1
            st["bytes_inflight"] += nbytes
            return True, 0.0

    def _release(self, tenant: str, nbytes: int, served: bool) -> None:
        """``served`` only counts SUCCESSFUL completions — the scheduler's
        tenant-saturation term reads it as real service, so an erroring
        tenant must not look well-served."""
        with self._adm_lock:
            st = self._adm_entry(tenant)
            st["inflight"] = max(st["inflight"] - 1, 0)
            st["bytes_inflight"] = max(st["bytes_inflight"] - nbytes, 0)
            if served:
                st["served"] += 1

    # ------------------------------------------------------------------
    def handle(self, raw) -> Frame:
        """bytes/Frame in -> response Frame (request id echoed).

        A frame whose preamble is unreadable cannot be answered addressably:
        a rid-0 error response would be dropped by a pipelined host and the
        caller's future would hang until timeout.  Such frames raise
        :class:`~repro_torch.core.transport.ProtocolError` so the transport tears
        the connection down loudly; per-request failures past a readable
        preamble still echo the real request id."""
        if not frame_preamble_ok(raw):
            raise ProtocolError(
                f"executor {self.name}: unreadable frame preamble "
                f"({len(raw)}B) — connection must be dropped")
        rid = frame_request_id(raw)
        # the transport layer owns the request lease (released once the
        # response is written); ops that must keep the frame's bytes alive
        # past this call — the coalescer's queue — retain it from here
        self._tls.lease = raw if isinstance(raw, BufferLease) else None
        t_in = time.perf_counter_ns()
        try:
            meta, tree = unpack_message(raw)
            self._tls.unpack = (t_in, time.perf_counter_ns())   # a traced run's span
            if self.fail:
                raise RuntimeError(f"executor {self.name} marked failed")
            op = meta["op"]
            rmeta, rtree, codec = getattr(self, f"_op_{op}")(meta, tree)
            return pack_message(rmeta, rtree, codec=codec, request_id=rid)
        except Exception as e:  # noqa: BLE001 — protocol boundary
            return pack_message({"ok": False, "error": str(e),
                                 "trace": traceback.format_exc(),
                                 **wire_error_meta(e)},
                                request_id=rid)
        finally:
            self._tls.lease = None

    # ------------------------------------------------------------------
    def _op_ping(self, meta, tree):
        """Liveness probe AND versioned capability handshake.

        The reply advertises everything a connecting host needs to pick its
        runtime tier and codec without trial-and-error: the wire protocol
        version, decodable codecs, the op set, per-library function lists,
        whether ``run`` ops marked ``batchable`` are coalesced (plus the
        coalescer's live stats, which feed the host's scheduler), and that
        out-of-order response matching — pipelining — is supported.  Old
        clients sending a bare ``{"op": "ping"}`` just ignore the extras;
        version gating is the CLIENT's job (``repro.avec.connect``) so a
        lone executor never refuses a probe it could answer."""
        return {
            "ok": True,
            "name": self.name,
            "protocol_version": PROTOCOL_VERSION,
            "codecs": list(SUPPORTED_CODECS),
            "ops": sorted(m[4:] for m in dir(self) if m.startswith("_op_")),
            "libraries": {lib: sorted(fns) for lib, fns in
                          self.libraries.items()},
            "batchable_ops": ["run"],
            "pipelining": True,          # responses echo request ids
            "coalesce": self._coalescer is not None,
            "coalesce_stats": self.coalesce_stats,
            # fair-share serving: per-tenant live stats + admission caps, so
            # host schedulers can penalize destinations where the calling
            # tenant is already saturated
            "fair_drain": self._coalescer is not None,
            "tenant_stats": self.tenant_stats,
            "tenant_limits": {"max_inflight": self.tenant_max_inflight,
                              "max_bytes": self.tenant_max_bytes},
            # failure domain: a draining node advertises it so schedulers
            # stop routing here; replay_dedup tells hosts a failover retry
            # carrying the same call_id cannot double-execute
            "draining": self.draining,
            "replay_dedup": self.replay_cache > 0,
            # intra-call sharding: a row-range sub-call is just a normal
            # ``run`` with a range-keyed call_id, so any dedup-capable
            # executor can serve one; advertised separately so facades can
            # gate the feature explicitly
            "intra_op_sharding": self.replay_cache > 0,
            # observability: the destination's effective knob values (env
            # overrides and constructor args already folded in), so a
            # client sees the remote end's actual tuning
            "config": self.effective_config(),
            # same-host zero-copy path: when an SHM doorbell listens beside
            # this executor, clients on the same host swap their TCP probe
            # channel for a SharedMemoryChannel (repro.avec prefer_shm)
            "shm": ({"path": self.shm_address, "host": _gethostname()}
                    if self.shm_address else None),
        }, None, "raw"

    def effective_config(self) -> dict:
        """Every registered knob's effective value at this destination,
        with this executor's resolved instance knobs folded over the
        registry snapshot — what :meth:`_op_ping` advertises."""
        eff = global_config().effective()
        eff.update({
            "coalesce_window_s": self.coalesce_window_s,
            "max_coalesce": self.max_coalesce,
            "tenant_max_inflight": self.tenant_max_inflight,
            "tenant_max_bytes": self.tenant_max_bytes,
            "replay_cache": self.replay_cache,
        })
        return eff

    def _op_metrics(self, meta, tree):
        """Control op: scrape this destination's metric registry over the
        existing wire — Prometheus text plus a flat sample dict, for hosts
        that cannot reach the /metrics HTTP listener."""
        return {"ok": True,
                "exposition": self.metrics.render(),
                "samples": self.metrics.sample_values()}, None, "raw"

    def _op_drain(self, meta, tree):
        """Control op for zero-downtime drain.  ``{"op": "drain"}`` flips
        the admission gate (non-blocking — the serve loop or a caller polls
        ``pending`` until the node has bled); ``{"op": "drain", "enable":
        False}`` re-opens admission (tests, canary un-drain)."""
        self.draining = bool(meta.get("enable", True))
        return {"ok": True, "draining": self.draining,
                "pending": self.pending_work()}, None, "raw"

    def _op_has_model(self, meta, tree):
        return {"ok": True, "resident": self.cache.has(meta["fp"])}, None, "raw"

    def _op_put_model(self, meta, tree):
        t0 = time.perf_counter()
        # parameters go to the device once; the receive buffer is released
        # as soon as the copy is made
        params = from_numpy_tree(tree, self.device)
        self._sync()
        nbytes = sum(np.asarray(l).nbytes for l in tree_leaves(tree))
        self.cache.put(meta["fp"], {
            "lib": meta["lib"], "params": params, "state": {},
            "extra": meta.get("extra", {}),
        }, nbytes)
        return {"ok": True, "transfer_s": time.perf_counter() - t0}, None, "raw"

    def _op_run(self, meta, tree):
        codec = meta.get("codec", "raw")
        if isinstance(codec, list):
            # negotiated codec preference list (msgpack round-trips tuples
            # as lists): normalize so the coalesce key stays hashable and
            # the response pack resolves per-leaf like the request did
            codec = tuple(codec)
        tenant = meta.get("tenant") or DEFAULT_TENANT
        call_id = meta.get("call_id")
        if call_id is not None:
            # replay guard FIRST: a retried call the node already finished
            # must be answered from cache even while draining or throttled
            # (the retry is not new work — its execution already happened)
            hit = self._replay_get(meta["fp"], call_id)
            if hit is not None:
                rmeta, rtree = hit
                return {**rmeta, "replayed": True}, rtree, codec
        if self.draining:
            return {"ok": False, "draining": True, "name": self.name,
                    "error": f"destination {self.name} is draining: new "
                             f"work is not admitted; re-home the session "
                             f"to its standby"}, None, "raw"
        nbytes = tree_wire_bytes(tree) if tree is not None else 0
        admitted, retry_after = self._admit(tenant, nbytes)
        if not admitted:
            return {"ok": False, "throttled": True, "tenant": tenant,
                    "retry_after_s": retry_after,
                    "error": f"tenant {tenant!r} throttled at {self.name}: "
                             f"admission cap reached (max_inflight="
                             f"{self.tenant_max_inflight}, max_bytes="
                             f"{self.tenant_max_bytes:.0f}); retry after "
                             f"~{retry_after * 1e3:.0f}ms"}, None, "raw"
        done_ok = False
        try:
            if self._coalescer is not None and meta.get("batchable"):
                key = (meta["fp"], meta["fn"], codec, _batch_signature(tree))
                rmeta, out_np = self._coalescer.submit(
                    key, meta, tree, lease=getattr(self._tls, "lease", None))
            else:
                rmeta, out_np = self._run_one(meta, tree)
            done_ok = True
            # a traced run's measured hops ride in private keys: off the
            # wire, and out of the replay cache (a replayed response must
            # not carry the original execution's stale timings)
            measured, waits = rmeta.pop("_timing", None), rmeta.pop("_waits", None)
            if call_id is not None:
                self._replay_put(meta["fp"], call_id, rmeta, out_np)
            if meta.get("trace") is not None and measured is not None:
                rmeta = self._stamp_spans(dict(rmeta), meta["trace"], measured,
                                          waits)
            return rmeta, out_np, codec
        finally:
            self._release(tenant, nbytes, served=done_ok)

    def _stamp_spans(self, rmeta: dict, trace_id, measured: tuple,
                     waits: list | None) -> dict:
        """Attach a traced run's destination spans to its response
        (``repro_torch.obs.trace``): ``unpack`` from :meth:`handle`, the
        coalescer's ``queue`` and ``coalesce`` waits, or on the direct path
        ``queue`` from the decoded frame to the arguments' copy, then
        :meth:`_run_one`'s ``h2d``, ``issue``, ``sync`` and ``d2h``, its
        stages and wrapper counters."""
        hops, stages = measured
        t_in, t_out = self._tls.unpack
        if waits is None:
            waits = [("queue", t_out, hops[0][1] - t_out)]
        spans, starts = {}, {}
        for name, start, dur in [("unpack", t_in, t_out - t_in), *waits, *hops]:
            spans[name] = dur / 1e9
            starts[name] = start
        rmeta["trace"] = trace_id
        rmeta["spans"] = spans
        rmeta["span_starts"] = starts
        rmeta["stages"] = stages.spans
        rmeta["wrappers"] = stages.wrappers
        return rmeta

    def _op_drop_session(self, meta, tree):
        self.cache.drop(meta["fp"])
        with self._replay_lock:
            self._replay.pop(meta["fp"], None)
        return {"ok": True}, None, "raw"

    def _op_snapshot(self, meta, tree):
        entry = self.cache.get(meta["fp"])
        state_np = to_numpy_tree(entry["state"])
        return {"ok": True, "lib": entry["lib"]}, state_np, "raw"

    def _op_restore(self, meta, tree):
        entry = self.cache.get(meta["fp"])
        entry["state"] = from_numpy_tree(tree, self.device)
        return {"ok": True}, None, "raw"

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run_one(self, meta, tree, traced: bool | None = None) -> tuple[dict, Any]:
        """One library call.  ``traced`` (default: the request carries a
        trace id) puts a :class:`~repro_torch.obs.trace.Stages` on this
        thread for the call and returns the measured hops under the
        private ``"_timing"`` key."""
        if traced is None:
            traced = meta.get("trace") is not None
        entry = self.cache.get(meta["fp"])
        fn = self.libraries[entry["lib"]][meta["fn"]]
        t0 = time.perf_counter_ns()
        args = from_numpy_tree(tree, self.device)
        self._sync()                # compute_s times the call, not the copy in
        t1 = time.perf_counter_ns()
        if traced:
            _trace.CURRENT.stages = stages = _trace.Stages()
        try:
            out = fn(entry["params"], entry["state"], args)
            t2 = time.perf_counter_ns()
            self._sync()            # jax.block_until_ready's counterpart
            t3 = time.perf_counter_ns()
        finally:
            if traced:
                _trace.CURRENT.stages = None
        # host numpy before packing: the wire flattens with np.asarray
        out_np = to_numpy_tree(out)
        rmeta = {"ok": True, "compute_s": (t3 - t1) / 1e9, "coalesced": 1}
        if traced:
            hops = [("h2d", t0, t1 - t0), ("issue", t1, t2 - t1), ("sync", t2, t3 - t2),
                    ("d2h", t3, time.perf_counter_ns() - t3)]
            rmeta["_timing"] = (hops, stages)
        return rmeta, out_np

    def _run_batch(self, key, metas: list, trees: list) -> list:
        """One stacked dispatch for a coalesced batch (leaves concatenated on
        axis 0), outputs split back by per-request row counts."""
        if len(trees) == 1:
            return [self._run_one(metas[0], trees[0])]
        rows = [np.shape(tree_leaves(t)[0])[0] for t in trees]
        # every input leaf must carry its request's batch dim on axis 0 —
        # per-request-constant leaves (masks, scalars) would concatenate into
        # nonsense, so fall back to per-request dispatch
        for t, r in zip(trees, rows):
            for leaf in tree_leaves(t):
                a = np.shape(leaf)
                if len(a) == 0 or a[0] != r:
                    return [self._run_one(m, tr)
                            for m, tr in zip(metas, trees)]
        stacked = tree_map(concat_rows, *trees)
        rmeta, out_np = self._run_one(
            metas[0], stacked, traced=any(m.get("trace") is not None for m in metas))
        total = int(sum(rows))
        out_leaves_chk = tree_leaves(out_np)
        if any(np.ndim(l) == 0 or np.shape(l)[0] != total
               for l in out_leaves_chk):
            # fn emits aggregate leaves (not row-aligned with the batch):
            # splitting would silently hand clients wrong slices — run each
            # request individually instead
            return [self._run_one(m, t) for m, t in zip(metas, trees)]
        splits = np.cumsum(rows)[:-1]
        # flatten/unflatten explicitly: a tree_map-over-parts split would
        # misfire on output trees that contain list nodes of their own
        out_leaves, out_def = tree_flatten(out_np)
        leaf_parts = [np.split(l, splits, axis=0) for l in out_leaves]
        n = len(trees)
        per_meta = {**rmeta, "compute_s": rmeta["compute_s"] / n, "coalesced": n}
        if "_timing" in rmeta:
            per_meta["_timing"] = _trace_share(rmeta["_timing"], n)
        return [(dict(per_meta),
                 tree_unflatten(out_def, [parts[i] for parts in leaf_parts]))
                for i in range(len(trees))]


def _trace_share(measured: tuple, n: int) -> tuple:
    """One of ``n`` coalesced calls' share of their batch's measured hops
    and stages: durations divided, as ``compute_s`` is; counts kept."""
    hops, stages = measured
    share = _trace.Stages()
    share.spans = {k: [t, d // n, c] for k, (t, d, c) in stages.spans.items()}
    share.wrappers = {k: [c, d // n] for k, (c, d) in stages.wrappers.items()}
    return [(name, t, d // n) for name, t, d in hops], share


# ---------------------------------------------------------------------------
# Host-side stubs
# ---------------------------------------------------------------------------

class HostRuntime:
    """Host-side RPC stub over a channel to one DestinationExecutor.

    ``put_model``, ``run`` and ``restore`` accept trees of tensors (on any
    device) or of host arrays; they go on the wire as host numpy.

    ``copy_results=False`` (default) hands back zero-copy views over the
    received frame for raw-codec leaves; set it when callers mutate results
    in place.  ``throttle_retries`` bounds the jittered retries of a
    :class:`TenantThrottled` admission response inside :meth:`run`."""

    def __init__(self, channel: Channel, codec: str = "raw",
                 timeout: float | None = None, copy_results: bool = False,
                 throttle_retries: int | None = None) -> None:
        cfg = global_config()
        self.channel = channel
        self.codec = codec
        self.timeout = float(cfg.resolve("rpc_timeout_s", timeout))
        self.copy_results = copy_results
        self.throttle_retries = int(cfg.resolve("throttle_retries",
                                                throttle_retries))
        self.throttle_retried = 0   # TenantThrottled responses retried
        self.bytes_sent = 0
        self.bytes_received = 0
        self.last_compute_s = 0.0
        self._closed = False

    def _rpc(self, meta: dict, tree=None, codec: str = "raw",
             trace=None) -> tuple[dict, Any]:
        if trace is not None:
            meta = {**meta, "trace": trace.trace_id}
            t0 = time.perf_counter_ns()
            req = pack_message(meta, tree, codec=codec)
            trace.stamp("serialize", t0)
        else:
            req = pack_message(meta, tree, codec=codec)
        self.bytes_sent += len(req)
        resp = self.channel.request(req, timeout=self.timeout)
        self.bytes_received += len(resp)
        t_un = time.perf_counter_ns()
        try:
            rmeta, rtree = unpack_message(resp, copy=self.copy_results)
        finally:
            # consumption point: drop the recv-pool lease's base reference
            # (decoded leaf views carry their own pins; with copy_results
            # the slab recycles immediately)
            release_buffer(resp)
        if trace is not None:
            unpack_ns = time.perf_counter_ns() - t_un
            trace.merge(rmeta)
            trace.add("unpack", t_un, unpack_ns)
        if not rmeta.get("ok", False):
            raise _remote_exception(rmeta)
        return rmeta, rtree

    def ping(self, client_info: dict | None = None) -> dict:
        """Liveness probe.  ``client_info`` (protocol version, codecs) rides
        along for the capability handshake; the reply carries the peer's
        advertised capabilities (see ``DestinationExecutor._op_ping``)."""
        return self._rpc({"op": "ping", **(client_info or {})})[0]

    def has_model(self, fp: str) -> bool:
        return self._rpc({"op": "has_model", "fp": fp})[0]["resident"]

    def put_model(self, fp: str, lib: str, params, extra: dict | None = None) -> float:
        params_np = to_numpy_tree(params)
        meta, _ = self._rpc({"op": "put_model", "fp": fp, "lib": lib,
                             "extra": extra or {}}, params_np)
        return meta["transfer_s"]

    def _run_meta(self, fp: str, fn: str, batchable: bool,
                  tenant: str | None, qos: dict | None,
                  call_id: str | None = None, codec=None) -> dict:
        # meta["codec"] tells the destination how to encode the RESPONSE;
        # a preference tuple rides as a msgpack list and is normalized back
        # by _op_run, so both directions resolve per leaf
        meta = {"op": "run", "fp": fp, "fn": fn,
                "codec": self.codec if codec is None else codec,
                "batchable": batchable}
        if tenant is not None:
            meta["tenant"] = tenant
        if qos:
            meta["qos"] = dict(qos)
        if call_id is not None:
            # client-generated logical id: a failover retry reuses it so the
            # destination's replay LRU can dedup an already-executed call
            meta["call_id"] = call_id
        return meta

    def run(self, fp: str, fn: str, args, batchable: bool = False, *,
            tenant: str | None = None, qos: dict | None = None,
            call_id: str | None = None, trace=None) -> Any:
        """One execution cycle.  ``tenant``/``qos`` ride in the frame
        metadata (fair-share drain + admission at the destination); a
        :class:`TenantThrottled` response is retried with jittered backoff
        up to ``throttle_retries`` times before surfacing.  ``trace`` (a
        :class:`repro_torch.obs.trace.TraceRecord`) collects per-hop spans."""
        args_np = to_numpy_tree(args)
        rmeta = self._run_meta(fp, fn, batchable, tenant, qos, call_id)
        attempt = 0
        while True:
            try:
                meta, out = self._rpc(rmeta, args_np, codec=self.codec,
                                      trace=trace)
                self.last_compute_s = meta["compute_s"]
                return out
            except TenantThrottled as e:
                if attempt >= self.throttle_retries:
                    raise
                self.throttle_retried += 1
                time.sleep(_throttle_backoff(attempt, e.retry_after_s))
                attempt += 1

    def drain(self, enable: bool = True) -> dict:
        """Flip the destination's admission gate (zero-downtime drain
        control op).  Returns the executor's ``{"draining", "pending"}``
        status so callers can poll until the node has bled."""
        return self._rpc({"op": "drain", "enable": enable})[0]

    def snapshot(self, fp: str) -> Any:
        return self._rpc({"op": "snapshot", "fp": fp})[1]

    def restore(self, fp: str, state) -> None:
        state_np = to_numpy_tree(state)
        self._rpc({"op": "restore", "fp": fp}, state_np)

    def drop(self, fp: str) -> None:
        self._rpc({"op": "drop_session", "fp": fp})

    def close(self) -> None:
        self._closed = True     # lets pool owners detect a dead stub
        self.channel.close()



class _WindowController:
    """Adaptive in-flight window from the observed comm/compute ratio.

    Hiding the wire behind destination compute needs roughly
    ``1 + comm/compute`` frames in flight: ~2 when compute dominates
    (classic double buffering), more as the link dominates.  Observations
    are EMA-smoothed; the chosen window is clamped to
    ``[min(2, cap), cap]``.  The window STARTS at the cap — a fresh
    runtime must not throttle a destination that batches its first burst —
    and adapts once responses carry measurements.  Callers must serialize
    ``observe`` externally (the runtime calls it under its condition
    variable)."""

    def __init__(self, cap: int, alpha: float = 0.25) -> None:
        self.cap = max(int(cap), 1)
        self.alpha = alpha
        self.floor = min(2, self.cap)
        self.window = self.cap
        self.wire_ema = 0.0
        self.compute_ema = 0.0
        self.observations = 0

    def observe(self, wire_s: float, compute_s: float) -> int:
        """Fold one completed request's (measured wire seconds, reported
        destination-compute seconds) into the window choice."""
        a = self.alpha
        if self.observations == 0:
            self.wire_ema, self.compute_ema = wire_s, compute_s
        else:
            self.wire_ema = (1 - a) * self.wire_ema + a * wire_s
            self.compute_ema = (1 - a) * self.compute_ema + a * compute_s
        self.observations += 1
        # ratio capped so a ~zero compute_s cannot overflow; the window is
        # clamped to the configured cap anyway
        ratio = self.wire_ema / max(self.compute_ema, 1e-6)
        need = 1 + math.ceil(min(ratio, float(self.cap)))
        self.window = max(self.floor, min(need, self.cap))
        return self.window


class _PipelinedFuture(Future):
    """Future that pumps its runtime's channel inside ``result()`` /
    ``exception()`` — with no reader thread, the waiter is the receiver."""

    _rt: "PipelinedHostRuntime" = None

    def result(self, timeout: float | None = None):
        if not self.done() and self._rt is not None:
            self._rt._pump_until(self.done, timeout)
        return super().result(timeout=0)

    def exception(self, timeout: float | None = None):
        if not self.done() and self._rt is not None:
            self._rt._pump_until(self.done, timeout)
        return super().exception(timeout=0)


class PipelinedHostRuntime(HostRuntime):
    """HostRuntime that keeps up to ``max_in_flight`` requests in flight on
    one channel.

    Every request frame carries a unique id, so responses can be matched
    out of order (e.g. from a coalescing destination).  While frame k
    computes at the destination, frame k+1 is already serialized and sitting
    in the connection's send buffer — the double-buffering that hides the
    wire behind destination compute (paper Figs. 8-9's "Communication"
    slice).

    There is NO dedicated reader thread: responses are pumped by whichever
    caller is blocked (on a full window in ``submit`` or on
    ``Future.result`` via ``wait``), one designated receiver at a time.  A
    reader-thread variant was measured to burn more in GIL handoffs per
    response than the overlap recovered on fast links; the pump design has
    zero extra thread switches in the steady single-caller case while still
    supporting concurrent submitters/waiters.

    Requires a channel with independent ``send``/``recv`` (TCP, loopback);
    sync ops (``ping``/``put_model``/...) go through the same pipelined path
    and simply wait on their own future.

    ``max_in_flight`` is the window CAP.  With ``adaptive_window=True`` (the
    default) the live window is sized from the observed comm/compute ratio
    — see :class:`_WindowController` and the module docstring's stats table.
    Over channels exposing the resumable-send API (``begin_send`` /
    ``try_send_resume``, i.e. TCP), a request frame is written
    non-blockingly: when the kernel send buffer fills, the submitter pumps
    receives until the socket is writable again instead of blocking —
    byte-level backpressure without a mutual stall on full socket buffers."""

    def __init__(self, channel: Channel, codec: str = "raw",
                 timeout: float | None = None, copy_results: bool = False,
                 max_in_flight: int | None = None,
                 adaptive_window: bool | None = None,
                 throttle_retries: int | None = None) -> None:
        super().__init__(channel, codec, timeout, copy_results,
                         throttle_retries=throttle_retries)
        cfg = global_config()
        self.max_in_flight = int(cfg.resolve("max_in_flight", max_in_flight))
        self.adaptive_window = bool(cfg.resolve("adaptive_window",
                                                adaptive_window))
        self._window = _WindowController(self.max_in_flight)  # guarded-by: _cv
        self._pending: dict[int, Future] = {}            # guarded-by: _cv
        self._track: dict[int, tuple[float, int]] = {}   # guarded-by: _cv (rid -> (t0, depth))
        self._traces: dict[int, Any] = {}                # guarded-by: _cv (rid -> TraceRecord)
        self._cv = _sanitize.make_condition("PipelinedHostRuntime._cv")
        self._receiving = False                          # guarded-by: _cv
        self._slock = _sanitize.make_lock("PipelinedHostRuntime._slock")
        self._rid = itertools.count(1)
        self._closed = False
        self._broken: BaseException | None = None        # guarded-by: _cv
        self._send_stalls = 0                            # guarded-by: _cv
        self._sends_resumed = 0                          # guarded-by: _cv
        self._recv_retries = 0                           # guarded-by: _cv
        self._requests_completed = 0                     # guarded-by: _cv
        # comm_quant: set by the facade after the handshake (knob on AND
        # peer advertised the codec); None leaves the base codec untouched
        self.quant_codec: str | None = None
        self._quant_frames = 0                           # guarded-by: _cv
        self._quant_bytes_saved = 0                      # guarded-by: _cv

    # ------------------------------------------------------------------
    def submit(self, meta: dict, tree=None, codec: str = "raw",
               trace=None) -> Future:
        """Send one request frame; returns a Future of (rmeta, rtree).
        Blocks (pumping responses) only when the adaptive window's worth of
        requests is already outstanding (request-level backpressure), or —
        on a resumable-send channel — while the kernel send buffer is full
        (byte-level backpressure), in which case the stalled send pumps
        receives between attempts so the link can never deadlock on
        mutually-full socket buffers.

        Zero-copy contract: raw-codec leaves are sent as views over the
        caller's arrays.  Over TCP the kernel copies during this call, but
        over in-process channels (Loopback) the frame aliases the arrays
        until the destination drains it — don't mutate submitted arrays
        before their future resolves.

        Platform note: byte-level backpressure needs per-call non-blocking
        sends (``MSG_DONTWAIT``; see ``TCPChannel.supports_resumable_send``).
        On platforms without it the legacy blocking send path is used, and
        the old sizing rule applies: keep ``max_in_flight`` x request bytes
        within the link's socket buffering or both ends can stall."""
        if self._closed:
            raise ChannelClosed("pipelined runtime closed")
        rid = next(self._rid)
        fut = self.make_future()
        if trace is not None:
            meta = {**meta, "trace": trace.trace_id}

        def _admit() -> None:  # avecheck: ignore[lock] -- runs as on_pass under _pump_until's cv
            # window check and pending insertion are one atomic step under
            # the cv, or concurrent submitters could exceed the window; the
            # (send time, queue depth) snapshot feeds the window controller
            self._pending[rid] = fut
            self._track[rid] = (time.monotonic(), len(self._pending))
            if trace is not None:
                self._traces[rid] = trace
        self._pump_until(lambda: len(self._pending) < self._window.window,
                         on_pass=_admit)
        try:
            t_ser = time.perf_counter_ns()
            req = pack_message(meta, tree, codec=codec, request_id=rid)
            if trace is not None:
                trace.stamp("serialize", t_ser)
            # comm_quant accounting: a preference tuple headed by a quant
            # codec means _effective_codec engaged — record what the lossy
            # encode shaved off the raw leaf bytes (floor 0: tiny leaves
            # fall back to raw under the min-bytes knob)
            quant_saved = -1
            if (tree is not None and isinstance(codec, tuple) and codec
                    and codec[0] in ("int8", "fp16")):
                quant_saved = max(tree_wire_bytes(tree) - len(req), 0)
            deadline = time.monotonic() + self.timeout
            t_send = time.perf_counter_ns()
            with self._slock:
                self._send_frame_pumping(req, deadline)
            if trace is not None:
                # includes backpressure stalls (pumped receives) — the
                # honest cost of getting this frame onto the wire
                trace.stamp("send", t_send)
            with self._cv:
                self.bytes_sent += len(req)
                if quant_saved >= 0:
                    self._quant_frames += 1
                    self._quant_bytes_saved += quant_saved
        except BaseException:
            with self._cv:
                self._pending.pop(rid, None)
                self._track.pop(rid, None)
                self._traces.pop(rid, None)
                self._cv.notify_all()   # a window slot just freed: re-wake
            raise                       # submitters parked on the predicate
        return fut

    # ------------------------------------------------------------------
    def _send_frame_pumping(self, req, deadline: float) -> None:
        """Write one request frame without ever blocking on a full socket
        buffer while responses are undrained.

        On channels exposing the resumable-send API the frame goes out via
        non-blocking attempts; each would-block stall either drains one
        response (as the designated receiver) or waits for writability while
        another thread receives.  Channels whose ``send`` cannot block
        mid-frame against the peer (loopback, simulated, direct) use the
        plain blocking path.  Caller holds ``_slock`` (frames are atomic
        wire units)."""
        ch = self.channel
        if not getattr(ch, "supports_resumable_send", False):
            ch.send(req)
            return
        state = ch.begin_send(req)
        try:
            if ch.try_send_resume(state):
                return
            with self._cv:
                self._sends_resumed += 1
                self._send_stalls += 1
            while True:
                now = time.monotonic()
                if now >= deadline:
                    raise TimeoutError(
                        "pipelined send timeout under backpressure "
                        f"({state.sent}/{state.total}B written)")
                became_receiver = False
                with self._cv:
                    if self._broken is not None:
                        self._raise_broken()
                    if not self._receiving:
                        self._receiving = True
                        became_receiver = True
                if became_receiver:
                    try:
                        readable, _ = ch.wait_io(
                            read=True, write=True,
                            timeout=min(0.2, deadline - now))
                    except BaseException as e:
                        self._fail_pending(e)
                        raise
                    if readable:
                        self._recv_dispatch_once()
                    else:
                        self._release_receiver()
                else:
                    # someone else is draining responses; sleep until the
                    # kernel will take more bytes (or their dispatch wakes
                    # the cv)
                    ch.wait_io(read=False, write=True, timeout=0.05)
                if ch.try_send_resume(state):
                    return
                with self._cv:
                    self._send_stalls += 1
        except BaseException:
            # a partially-written frame left on the wire tears the framing
            # for every later request: fail the channel (and all pending
            # futures) rather than let the next send corrupt the stream
            if state.sent and not state.done:
                if hasattr(ch, "fail_partial_send"):
                    ch.fail_partial_send(state)
                self._fail_pending(ChannelClosed(
                    "channel failed: frame abandoned mid-send "
                    f"({state.sent}/{state.total}B written)"))
            raise

    def _raise_broken(self) -> None:
        """Raise the stored channel-failure exception as a fresh clone of
        the same type (see :func:`_clone_channel_exc` — the stored object
        must never accumulate tracebacks)."""
        raise _clone_channel_exc(self._broken)

    def make_future(self) -> _PipelinedFuture:
        """A Future whose ``result()`` pumps this runtime's channel.  Use for
        futures chained off :meth:`submit` (e.g. result transformers) so
        waiting on them drives the receive loop."""
        fut = _PipelinedFuture()
        fut._rt = self
        return fut

    def chain(self, inner: Future, transform) -> Future:
        """Pump-aware future chaining: returns a Future resolving to
        ``transform(rmeta, rtree)`` of ``inner``'s result, forwarding
        exceptions; waiting on it drives the receive loop."""
        outer = self.make_future()

        def _done(f: Future) -> None:
            exc = f.exception()
            if exc is not None:
                outer.set_exception(exc)
                return
            try:
                outer.set_result(transform(*f.result()))
            except BaseException as e:  # noqa: BLE001 — surface via future
                outer.set_exception(e)

        inner.add_done_callback(_done)
        return outer

    def wait(self, fut: Future, timeout: float | None = None) -> tuple[dict, Any]:
        """Resolve a future from :meth:`submit`, pumping the channel."""
        self._pump_until(fut.done, timeout)
        return fut.result(timeout=0)

    # ------------------------------------------------------------------
    def _pump_until(self, pred, timeout: float | None = None,
                    on_pass=None) -> None:
        """Cooperative receive loop: exactly one thread receives at a time;
        every receipt re-wakes the others to re-check their predicate.
        ``on_pass`` runs under the cv in the same critical section as the
        passing predicate check (atomic check-then-act).

        The receiving thread's socket timeout is the RUNTIME timeout, never
        the caller's (short) wait deadline — a short per-future timeout must
        expire that one wait, not interrupt a response mid-frame and fail
        the shared channel for every pending request.  Consequently a wait
        may overshoot its deadline by up to one in-flight response.  A
        CLEAN channel-level recv timeout (no frame byte seen; stream and
        channel intact) is not the caller's failure: the pump retries until
        the caller's own deadline expires (``recv_retries`` in stats)."""
        timeout = self.timeout if timeout is None else timeout
        deadline = time.monotonic() + timeout
        while True:
            with self._cv:
                while True:
                    if pred():
                        if on_pass is not None:
                            on_pass()
                        return
                    if self._broken is not None:
                        self._raise_broken()
                    if time.monotonic() >= deadline:
                        raise TimeoutError("pipelined rpc timeout")
                    if not self._receiving:
                        self._receiving = True
                        break
                    if not self._cv.wait(timeout=deadline - time.monotonic()):
                        raise TimeoutError("pipelined rpc timeout")
            if not self._recv_dispatch_once():
                # clean channel timeout: not this caller's failure unless
                # its own deadline has passed
                if time.monotonic() >= deadline:
                    raise TimeoutError("pipelined rpc timeout")
                with self._cv:
                    self._recv_retries += 1

    def _recv_dispatch_once(self) -> bool:
        """As the designated receiver: one blocking recv + dispatch, then
        release the receiver slot.  Returns False on a CLEAN channel recv
        timeout (stream intact, receiver released, safe to retry).  Any
        damage — a mid-frame timeout that broke the channel, a closed
        socket, a garbled frame — fails every pending future and re-raises."""
        try:
            data = self.channel.recv(timeout=self.timeout)
        except TimeoutError as e:
            if getattr(self.channel, "broken", False):
                # mid-frame timeout failed the channel: every pending
                # response is lost, not just this caller's
                exc = ChannelClosed(str(e))
                self._fail_pending(exc)
                raise exc
            self._release_receiver()
            return False
        except BaseException as e:
            self._fail_pending(e)
            raise
        try:
            self._dispatch(data)    # avecheck: handoff
        except BaseException as e:
            self._fail_pending(e)
            raise
        self._release_receiver()
        return True

    def _release_receiver(self) -> None:
        with self._cv:
            self._receiving = False
            self._cv.notify_all()

    def _dispatch(self, data) -> None:
        try:
            self._dispatch_inner(data)
        finally:
            # future consumption: the raw frame is decoded (or dead) — drop
            # the recv-pool lease's base ref; leaf views pin what they need
            release_buffer(data)

    def _dispatch_inner(self, data) -> None:
        rid = frame_request_id(data)
        now = time.monotonic()
        with self._cv:
            fut = self._pending.pop(rid, None)
            track = self._track.pop(rid, None)
            trace = self._traces.pop(rid, None)
            # shared counters only mutate under the cv (readers of stats()
            # and concurrent dispatchers must never race a lost update)
            self.bytes_received += len(data)
            if fut is not None:
                self._requests_completed += 1
        if fut is None:
            return
        t_un = time.perf_counter_ns()
        try:
            rmeta, rtree = unpack_message(data, copy=self.copy_results)
        except Exception as e:  # noqa: BLE001
            fut.set_exception(e)
            return
        if trace is not None:
            # safe without the future's result: the caller only reads the
            # trace after the future resolves (the future is the fence)
            unpack_ns = time.perf_counter_ns() - t_un
            trace.merge(rmeta)
            trace.add("unpack", t_un, unpack_ns)
        if (self.adaptive_window and track is not None
                and rmeta.get("ok", False) and "compute_s" in rmeta):
            t0, depth = track
            compute_s = max(float(rmeta["compute_s"]), 0.0)
            # wire time = round trip minus the destination-compute queueing
            # attributable to the requests in flight ahead of (and incl.)
            # this one — what's left is the link's share of the cycle
            wire_s = max((now - t0) - depth * compute_s, 0.0)
            with self._cv:
                self._window.observe(wire_s, compute_s)
        if not rmeta.get("ok", False):
            fut.set_exception(_remote_exception(rmeta))
        else:
            fut.set_result((rmeta, rtree))

    def _fail_pending(self, exc: BaseException) -> None:
        with self._cv:
            if self._broken is None:
                # store a traceback-free clone: the original keeps
                # propagating (and growing a traceback) through the failing
                # callers, and this slot outlives all of their frames
                self._broken = _clone_channel_exc(exc)
            pending = list(self._pending.values())
            self._pending.clear()
            self._track.clear()
            self._traces.clear()
            self._receiving = False
            self._cv.notify_all()
        for fut in pending:
            if not fut.done():
                fut.set_exception(exc)

    # ------------------------------------------------------------------
    def _rpc(self, meta: dict, tree=None, codec: str = "raw",
             trace=None) -> tuple[dict, Any]:
        return self.wait(self.submit(meta, tree, codec=codec, trace=trace))

    def _effective_codec(self):
        """Wire codec for the next ``run``: the configured base, upgraded
        to a quantizing preference list once the adaptive window's EMAs say
        the LINK (not destination compute) bounds throughput.  Engagement
        needs a few observations so one cold-start outlier can't flip it;
        when compute re-dominates (codec shrank the wire share below the
        compute EMA) the next calls naturally fall back to the base codec —
        the same feedback loop that sizes the window."""
        if not self.quant_codec:
            return self.codec
        with self._cv:
            w = self._window
            engaged = w.observations >= 4 and w.wire_ema > w.compute_ema
        if not engaged:
            return self.codec
        base = self.codec if isinstance(self.codec, tuple) else (self.codec,)
        prefs = (self.quant_codec,
                 *(c for c in base if c != self.quant_codec))
        return prefs if "raw" in prefs else (*prefs, "raw")

    def run_async(self, fp: str, fn: str, args, batchable: bool = False, *,
                  tenant: str | None = None, qos: dict | None = None,
                  call_id: str | None = None, trace=None) -> Future:
        """Async ``run``: a Future resolving to (rmeta, output tree).
        Resolve it with :meth:`wait` (or ``.result()`` after another call on
        this runtime has pumped the channel).  One wire attempt — a
        :class:`TenantThrottled` response surfaces on the future; the
        synchronous :meth:`run` wrapper (and the serving frontends) own the
        jittered retry loop."""
        args_np = to_numpy_tree(args)
        codec = self._effective_codec()
        inner = self.submit(
            self._run_meta(fp, fn, batchable, tenant, qos, call_id,
                           codec=codec),
            args_np, codec=codec, trace=trace)

        def _record(f: Future) -> None:
            if f.exception() is None:
                self.last_compute_s = f.result()[0]["compute_s"]
        inner.add_done_callback(_record)
        return inner

    def run(self, fp: str, fn: str, args, batchable: bool = False, *,
            tenant: str | None = None, qos: dict | None = None,
            call_id: str | None = None, trace=None) -> Any:
        attempt = 0
        while True:
            try:
                return self.wait(self.run_async(
                    fp, fn, args, batchable=batchable,
                    tenant=tenant, qos=qos, call_id=call_id,
                    trace=trace))[1]
            except TenantThrottled as e:
                if attempt >= self.throttle_retries:
                    raise
                with self._cv:
                    self.throttle_retried += 1
                time.sleep(_throttle_backoff(attempt, e.retry_after_s))
                attempt += 1

    def in_flight(self) -> int:
        with self._cv:
            return len(self._pending)

    @property
    def window(self) -> int:
        """The live in-flight window (adaptive; capped at max_in_flight)."""
        with self._cv:
            return self._window.window

    def stats(self) -> dict:
        """Snapshot of the data-plane counters (see module docstring).
        Includes the channel's recv-pool counters (hit rate, outstanding
        leases) under ``recv_pool`` when the transport pools its receive
        buffers."""
        pool = getattr(self.channel, "recv_pool", None)
        pool_stats = pool.stats() if pool is not None else None
        with self._cv:
            return {
                **({"recv_pool": pool_stats} if pool_stats else {}),
                "bytes_sent": self.bytes_sent,
                "bytes_received": self.bytes_received,
                "in_flight": len(self._pending),
                "window": self._window.window,
                "max_in_flight": self.max_in_flight,
                "adaptive_window": self.adaptive_window,
                "send_stalls": self._send_stalls,
                "sends_resumed": self._sends_resumed,
                "recv_retries": self._recv_retries,
                "throttle_retried": self.throttle_retried,
                "requests_completed": self._requests_completed,
                "wire_ema_s": self._window.wire_ema,
                "compute_ema_s": self._window.compute_ema,
                "window_observations": self._window.observations,
                "quant_codec": self.quant_codec,
                "quant_frames": self._quant_frames,
                "quant_bytes_saved": self._quant_bytes_saved,
            }

    def close(self) -> None:
        self._closed = True
        self.channel.close()
        self._fail_pending(ChannelClosed("pipelined runtime closed"))
