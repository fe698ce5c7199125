"""Request-scoped tracing and structured JSON logs.

A trace id is minted at the facade (``ClientSession.call``), carried to
the destination in the frame ``meta`` under ``"trace"``, and stamped
with one span per hop, each measured where its work happens:

* ``serialize`` — client-side pack into the vectored wire format;
* ``send`` — client-side wire write (including backpressure stalls;
  pipelined runtime only: the sync runtime's send and receive are one
  channel call, left in ``respond``);
* ``unpack`` — destination-side frame decode (``DestinationExecutor.handle``);
* ``queue`` — destination-side wait from the decoded frame to execution
  start (admission; on the coalesced path enqueue to the DRR pick);
* ``coalesce`` — destination-side window-fill wait inside a coalesced
  batch (absent on the direct path);
* ``h2d`` — the arguments' copy to the device and the sync after it;
* ``issue`` — the library function on the host, entry to return: the
  model step's host work, which enqueues its device work;
* ``sync`` — from that return to the end of the device sync (``issue`` +
  ``sync`` is the executor's ``compute_s``);
* ``d2h`` — the outputs' copy back to host numpy;
* ``unpack`` (again, client side) — the response's frame decode;
* ``stitch`` — a sharded call's reassembly (:func:`merge_sharded`);
* ``respond`` — what is left of the end-to-end wall: the caller's argument
  conversion, the destination's response pack (it cannot report its own
  time in the frame it is packing), both wire flights, and the hand-off
  to the caller.  Computed as the remainder at
  :meth:`TraceRecord.finish`, so the top-level spans sum to the wall; it
  is negative when measured hops overlapped (on one host, the destination
  can start decoding a frame before the client's ``send`` has returned).

A coalesced batch's ``h2d``, ``issue``, ``sync`` and ``d2h`` are divided
among its calls, as ``compute_s`` is.  Inside ``issue`` the model step
stamps *stages*, child spans (parent ``issue``) summed over the layers
with their count: ``mixer`` (a layer's norm, attention or Mamba call and
residual add) and ``ffn`` (the same for its MLP or MoE), and inside
``ffn`` a MoE layer's ``route`` (router, top-k, dispatch), ``experts``
(the routed experts and the combine) and ``shared`` (its dense residual
FFN); and each ``kernels.ops`` wrapper counts its calls and host time.
A decode replayed as a CUDA graph (``core.library.DecodeGraph``) books one
``replay`` stage instead (its inputs' refresh, the graph's launch and its
output's copy), and no layer stage or wrapper runs.  Both accumulate into a
:class:`Stages` that the executor puts on the running thread
(:data:`CURRENT`) only for a traced call.

Every span is a tuple ``(name, start_ns, dur_ns, parent, n)``: ``start_ns``
on ``time.perf_counter_ns()`` (CLOCK_MONOTONIC on Linux, one clock for the
processes of a host), ``None`` for the remainder ``respond`` and for hops
a JAX-package destination reports without starts; ``parent`` ``None`` for
hops; ``n`` the times a stage ran.  ``torch.profiler``'s events are on the
wall clock (``time.time_ns()``): a span lies on the destination's device
trace after adding ``realtime_offset_ns``, which each ``trace_log`` line
carries.

Destination spans travel back in the response meta: ``"spans"`` (``{name:
seconds}``, the form the JAX package's hosts read too), ``"span_starts"``,
``"stages"`` and ``"wrappers"``, merged client-side, so one offloaded call
yields one timeline.  Completed traces land in a bounded in-memory sink
(the benchmark's readers, tests and the ``trace`` control surface) and are
optionally emitted as JSON log lines (``trace_log`` knob).

:func:`emit` is also the structured replacement for the bare
``print()``\\ s in ``launch/serve.py``: one JSON object per line with a
timestamp, event name, and free-form fields.
"""
from __future__ import annotations

import collections
import json
import sys
import threading
import time
import uuid
from typing import Any, Optional, Sequence, TextIO

from repro_torch.analysis import sanitize as _sanitize
from repro_torch.obs.config import global_config

SPAN_ORDER = ("serialize", "send", "unpack", "queue", "coalesce", "h2d",
              "issue", "sync", "d2h", "stitch", "respond")
#: the stages a model step books inside ``issue``, and a MoE layer's
#: inside ``ffn`` (``models/moe.py``)
STAGES = ("mixer", "ffn", "replay", "route", "experts", "shared")
#: a stage's parent span, where it is not ``issue``
STAGE_PARENTS = {"route": "ffn", "experts": "ffn", "shared": "ffn"}
#: records the sink keeps: about ten times the calls of the busiest
#: benchmark window (1,589), so a window's records outlive it
SINK_CAPACITY = 16384


def new_trace_id() -> str:
    """16-hex-char request-scoped trace id."""
    return uuid.uuid4().hex[:16]


def trace_enabled() -> bool:
    return bool(global_config().get("trace_enabled"))


class Stages:
    """One traced call's stages and kernel-wrapper counters, accumulated on
    the thread that runs its library function: ``spans`` ``{name: [first
    start_ns, summed ns, count]}``, ``wrappers`` ``{op: [calls, summed ns]}``."""

    __slots__ = ("spans", "wrappers")

    def __init__(self) -> None:
        self.spans: dict[str, list] = {}
        self.wrappers: dict[str, list] = {}

    def stage(self, name: str, t0: int) -> int:
        """Book stage ``name`` from ``t0`` (perf_counter_ns) to now; returns
        now, the next stage's start."""
        t1 = time.perf_counter_ns()
        s = self.spans.get(name)
        if s is None:
            self.spans[name] = [t0, t1 - t0, 1]
        else:
            s[1] += t1 - t0
            s[2] += 1
        return t1

    def wrapper(self, op: str, t0: int) -> None:
        """Count one call of the ``kernels.ops`` wrapper ``op`` from ``t0``."""
        dt = time.perf_counter_ns() - t0
        w = self.wrappers.get(op)
        if w is None:
            self.wrappers[op] = [1, dt]
        else:
            w[0] += 1
            w[1] += dt


class _Current(threading.local):
    #: the traced call's :class:`Stages` on this thread, else None: the
    #: one attribute every stage and wrapper stamp tests
    stages: Optional[Stages] = None


CURRENT = _Current()


class TraceRecord:
    """Per-request span timeline: ``spans``, ``(name, start_ns, dur_ns,
    parent, n)`` tuples in the order they were booked, and ``wrappers``,
    ``(op, calls, ns)`` tuples of the destination's kernel wrappers.

    Not locked: hops touch the record strictly sequentially (the
    response future is the synchronization point between the dispatch
    thread that merges destination spans and the caller that finishes
    the record).
    """

    __slots__ = ("trace_id", "call_id", "fn", "spans", "wrappers", "wall_s")

    def __init__(self, trace_id: Optional[str] = None,
                 call_id: Optional[str] = None,
                 fn: Optional[str] = None) -> None:
        self.trace_id = trace_id or new_trace_id()
        self.call_id = call_id
        self.fn = fn
        self.spans: list[tuple] = []
        self.wrappers: tuple = ()
        self.wall_s: Optional[float] = None

    def add(self, name: str, start_ns: Optional[int], dur_ns: int,
            parent: Optional[str] = None, n: int = 1) -> None:
        self.spans.append((name, start_ns, int(dur_ns), parent, n))

    def stamp(self, name: str, start_ns: int) -> None:
        """A hop from ``start_ns`` (perf_counter_ns) to now."""
        self.add(name, start_ns, time.perf_counter_ns() - start_ns)

    def merge(self, rmeta: dict) -> None:
        """Fold a response's destination spans in: hops in canonical order
        (``{name: seconds}`` and their starts), then the stages under
        ``issue`` (a MoE's under ``ffn``), and the wrapper counters."""
        spans = rmeta.get("spans")
        if not spans:
            return
        starts = rmeta.get("span_starts") or {}
        names = [n for n in SPAN_ORDER if n in spans]
        names += [n for n in spans if n not in SPAN_ORDER]
        for name in names:
            self.add(name, starts.get(name), round(spans[name] * 1e9))
        for name, (start, dur, n) in (rmeta.get("stages") or {}).items():
            self.add(name, start, dur, STAGE_PARENTS.get(name, "issue"), n)
        self.wrappers = tuple((op, calls, ns) for op, (calls, ns)
                              in (rmeta.get("wrappers") or {}).items())

    def total_span_s(self) -> float:
        """The top-level spans' sum, seconds."""
        return sum(s[2] for s in self.spans if s[3] is None) / 1e9

    def span_names(self) -> list[str]:
        return [s[0] for s in self.spans]

    def finish(self, wall_s: float) -> "TraceRecord":
        """Close the record against the observed end-to-end wall,
        booking the unattributed remainder, signed, as the ``respond``
        span."""
        self.wall_s = float(wall_s)
        booked = sum(s[2] for s in self.spans if s[3] is None)
        self.add("respond", None, round(self.wall_s * 1e9) - booked)
        return self

    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id, "call_id": self.call_id,
                "fn": self.fn, "wall_s": self.wall_s,
                "spans": [{"name": name, "start_ns": start, "dur_s": dur / 1e9,
                           "parent": parent, "n": n}
                          for name, start, dur, parent, n in self.spans],
                "wrappers": {op: {"calls": calls, "s": ns / 1e9}
                             for op, calls, ns in self.wrappers}}


class TraceSink:
    """Bounded ring of recently completed traces."""

    def __init__(self, capacity: int = SINK_CAPACITY) -> None:
        self._lock = _sanitize.make_lock("TraceSink._lock")
        self._traces: collections.deque = collections.deque(
            maxlen=capacity)                        # guarded-by: _lock
        self.completed = 0                          # guarded-by: _lock

    def record(self, trace: TraceRecord) -> None:
        with self._lock:
            self._traces.append(trace)
            self.completed += 1

    def last(self) -> Optional[TraceRecord]:
        with self._lock:
            return self._traces[-1] if self._traces else None

    def recent(self, n: int = 16) -> list[TraceRecord]:
        with self._lock:
            return list(self._traces)[-n:]

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()


_SINK = TraceSink()


def get_sink() -> TraceSink:
    """The process-wide completed-trace sink."""
    return _SINK


def start_trace(fn: Optional[str] = None,
                call_id: Optional[str] = None) -> Optional[TraceRecord]:
    """New :class:`TraceRecord` when tracing is enabled, else ``None``
    (every stamping site tolerates ``trace is None``)."""
    if not trace_enabled():
        return None
    return TraceRecord(call_id=call_id, fn=fn)


def finish_trace(trace: Optional[TraceRecord],
                 wall_s: float) -> Optional[TraceRecord]:
    """Close + sink a trace; optionally emit it as a JSON log line."""
    if trace is None:
        return None
    trace.finish(wall_s)
    _SINK.record(trace)
    if global_config().get("trace_log"):
        emit("trace", **trace.to_dict(),
             realtime_offset_ns=time.time_ns() - time.perf_counter_ns())
    return trace


def merge_sharded(parent: Optional[TraceRecord],
                  children: Sequence[Optional[TraceRecord]]
                  ) -> Optional[TraceRecord]:
    """Fold one sharded call's per-shard timelines into the parent record.

    The shards ran CONCURRENTLY, so summing every shard's spans would
    overshoot the parent's wall by ~n_shards x.  The parent instead
    inherits the critical path — the slowest (finished) shard's full
    timeline, whose spans sum to that shard's wall, which is bounded by
    the parent's — so :meth:`TraceRecord.finish` still books a
    non-negative remainder and the sharded call sums to its wall exactly
    like an unsharded one.  The per-shard records carry the parent's
    ``trace_id`` and land in the sink individually (via
    :func:`finish_trace`), so the full fan-out is reconstructable."""
    if parent is None:
        return None
    done = [c for c in children if c is not None and c.wall_s is not None]
    if not done:
        return parent
    slowest = max(done, key=lambda c: c.wall_s)
    parent.spans.extend(slowest.spans)
    parent.wrappers = slowest.wrappers
    return parent


# ----------------------------------------------------------------------
# Structured JSON logs
# ----------------------------------------------------------------------

def _default(obj: Any) -> str:
    return repr(obj)


def emit(event: str, stream: Optional[TextIO] = None, **fields) -> None:
    """One structured JSON log line: ``{"ts": ..., "event": ..., ...}``.

    The replacement for bare ``print()`` in entrypoints — every line is
    machine-parseable and carries the request/trace ids the caller
    passes in.
    """
    record = {"ts": round(time.time(), 6), "event": event}
    record.update(fields)
    out = stream if stream is not None else sys.stdout
    out.write(json.dumps(record, default=_default) + "\n")
    out.flush()
