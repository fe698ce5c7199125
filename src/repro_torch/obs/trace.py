"""Request-scoped tracing and structured JSON logs.

A trace id is minted at the facade (``ClientSession.call``), carried to
the destination in the frame ``meta`` under ``"trace"``, and stamped
with one span per hop:

* ``serialize`` — client-side pack into the vectored wire format;
* ``send`` — client-side wire write (including backpressure stalls);
* ``queue`` — destination-side wait from frame arrival to dispatch
  pick (admission + DRR drain wait);
* ``coalesce`` — destination-side window-fill wait inside a coalesced
  batch (absent on the direct path);
* ``execute`` — destination compute (jit dispatch + block_until_ready);
* ``respond`` — everything left of the end-to-end wall: response pack,
  both wire flights, and client unpack (computed as the remainder at
  :meth:`TraceRecord.finish`, so spans always sum to the wall).

Destination spans travel back in the response meta (``"spans"``) and
are merged client-side, so one offloaded call yields one structured
timeline.  Completed traces land in a bounded in-memory sink (for tests
and the ``trace`` control surface) and are optionally emitted as JSON
log lines (``trace_log`` knob).

:func:`emit` is also the structured replacement for the bare
``print()``\\ s in ``launch/serve.py``: one JSON object per line with a
timestamp, event name, and free-form fields.
"""
from __future__ import annotations

import collections
import json
import sys
import time
import uuid
from typing import Any, Optional, Sequence, TextIO

from repro_torch.analysis import sanitize as _sanitize
from repro_torch.obs.config import global_config

SPAN_ORDER = ("serialize", "send", "queue", "coalesce", "execute",
              "stitch", "respond")


def new_trace_id() -> str:
    """16-hex-char request-scoped trace id."""
    return uuid.uuid4().hex[:16]


def trace_enabled() -> bool:
    return bool(global_config().get("trace_enabled"))


class TraceRecord:
    """Per-request span timeline.

    Not locked: hops touch the record strictly sequentially (the
    response future is the synchronization point between the dispatch
    thread that merges destination spans and the caller that finishes
    the record).
    """

    __slots__ = ("trace_id", "call_id", "fn", "spans", "wall_s",
                 "created_s")

    def __init__(self, trace_id: Optional[str] = None,
                 call_id: Optional[str] = None,
                 fn: Optional[str] = None) -> None:
        self.trace_id = trace_id or new_trace_id()
        self.call_id = call_id
        self.fn = fn
        self.spans: list[dict] = []
        self.wall_s: Optional[float] = None
        self.created_s = time.time()

    def add(self, name: str, dur_s: float) -> None:
        self.spans.append({"name": name, "dur_s": max(float(dur_s), 0.0)})

    def merge(self, spans: Optional[dict]) -> None:
        """Fold destination-reported ``{name: seconds}`` spans in, in
        canonical hop order."""
        if not spans:
            return
        for name in SPAN_ORDER:
            if name in spans:
                self.add(name, spans[name])
        for name in spans:
            if name not in SPAN_ORDER:
                self.add(name, spans[name])

    def total_span_s(self) -> float:
        return sum(s["dur_s"] for s in self.spans)

    def span_names(self) -> list[str]:
        return [s["name"] for s in self.spans]

    def finish(self, wall_s: float) -> "TraceRecord":
        """Close the record against the observed end-to-end wall,
        booking the unattributed remainder (response pack + wire flights
        + unpack) as the ``respond`` span."""
        self.wall_s = float(wall_s)
        remainder = self.wall_s - self.total_span_s()
        self.add("respond", remainder)
        return self

    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id, "call_id": self.call_id,
                "fn": self.fn, "wall_s": self.wall_s,
                "spans": list(self.spans)}


class TraceSink:
    """Bounded ring of recently completed traces."""

    def __init__(self, capacity: int = 256) -> None:
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
        emit("trace", **trace.to_dict())
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
    for span in slowest.spans:
        parent.add(span["name"], span["dur_s"])
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
