"""Runtime wire-protocol sanitizer: a validating channel wrapper.

``ValidatingChannel`` composes like :class:`~repro_torch.core.transport
.FaultyChannel` — wrap any channel (TCP, loopback, faulty) and every frame
crossing it is checked against the AVEC wire state machine *before* it
reaches the peer layer:

* **preamble** — magic + fixed-preamble length (``frame_preamble_ok``);
  a frame failing this is unaddressable and the stream is dead.
* **request-id discipline** — on the client side, every outbound request
  carries a fresh (or 0 = unpipelined) rid; every inbound response's rid
  must match an outstanding request.  The server side mirrors it: inbound
  rids are recorded, outbound responses must answer one.
* **metadata schema** — requests carry ``"op"`` naming a handler the
  executor actually implements (introspected from ``_op_*`` methods);
  responses carry ``"ok"``.

A violation raises :class:`ProtocolViolation` (an ``AssertionError`` — the
sanitizer family's contract, see ``repro_torch.analysis.sanitize``).  Inbound
frames that arrived in pooled recv memory are released before raising, so
a protocol bug never doubles as a lease leak.

Like ``FaultyChannel``, the wrapper does NOT expose the resumable-send
API: a pipelined runtime over a validating link uses the plain blocking
send path, keeping validation frame-aligned.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.analysis import sanitize as _sanitize
from repro_torch.core.memory import release_buffer
from repro_torch.core.serialization import (Frame, _head_of, _parse_head,
                                      frame_preamble_ok, frame_request_id)


class ProtocolViolation(AssertionError):
    """A frame broke the wire-protocol state machine."""


def known_ops() -> frozenset:
    """The op vocabulary the destination executor implements, introspected
    so the validator never drifts from the real dispatch table."""
    from repro_torch.core.executor import DestinationExecutor
    return frozenset(m[4:] for m in dir(DestinationExecutor)
                     if m.startswith("_op_"))


class ValidatingChannel:
    """Protocol state-machine validation over any inner channel.

    ``side="client"`` (default): sends are requests, recvs are responses.
    ``side="server"``: the mirror — wrap the destination's channel.
    """

    supports_resumable_send = False

    def __init__(self, inner, *, side: str = "client") -> None:
        if side not in ("client", "server"):
            raise ValueError(f"side must be 'client' or 'server': {side!r}")
        self._inner = inner
        self.side = side
        self._ops = known_ops()
        self._lock = _sanitize.make_lock("ValidatingChannel._lock")
        self._outstanding: set = set()  # guarded-by: _lock (open rids)
        self.frames_validated = 0       # guarded-by: _lock
        self.violations = 0             # guarded-by: _lock

    @property
    def broken(self) -> bool:
        return getattr(self._inner, "broken", False)

    # ------------------------------------------------------------------
    def _violate(self, msg: str, data=None) -> None:
        with self._lock:
            self.violations += 1
        if data is not None and not isinstance(data, Frame):
            release_buffer(data)    # a rejected pooled frame must not leak
        raise ProtocolViolation(f"[{self.side}] {msg}")

    def _meta_of(self, data) -> tuple[int, dict]:
        header, rid, _ = _parse_head(_head_of(data))
        meta = header.get("meta") or {}
        if not isinstance(meta, dict):
            raise TypeError(f"frame meta is {type(meta).__name__}, not dict")
        return rid, meta

    def _check_request(self, data, direction: str) -> None:
        if not frame_preamble_ok(data):
            self._violate(f"{direction} request frame with bad preamble",
                          data if direction == "inbound" else None)
        rid, meta = self._meta_of(data)
        op = meta.get("op")
        if op not in self._ops:
            self._violate(
                f"{direction} request carries op {op!r}, not one the "
                f"executor implements ({sorted(self._ops)})",
                data if direction == "inbound" else None)
        with self._lock:
            if rid != 0 and rid in self._outstanding:
                dup = True
            else:
                dup = False
                if rid != 0:
                    self._outstanding.add(rid)
            self.frames_validated += 1
        if dup:
            self._violate(f"{direction} request reuses in-flight rid {rid}",
                          data if direction == "inbound" else None)

    def _check_response(self, data, direction: str) -> None:
        if not frame_preamble_ok(data):
            self._violate(f"{direction} response frame with bad preamble",
                          data if direction == "inbound" else None)
        rid, meta = self._meta_of(data)
        if "ok" not in meta:
            self._violate(
                f"{direction} response meta lacks 'ok' (keys: "
                f"{sorted(meta)})",
                data if direction == "inbound" else None)
        with self._lock:
            if rid != 0 and rid not in self._outstanding:
                unknown = True
            else:
                unknown = False
                self._outstanding.discard(rid)
            self.frames_validated += 1
        if unknown:
            self._violate(
                f"{direction} response answers rid {rid}, which has no "
                f"outstanding request",
                data if direction == "inbound" else None)

    # ------------------------------------------------------------------
    def send(self, data) -> None:
        if self.side == "client":
            self._check_request(data, "outbound")
        else:
            self._check_response(data, "outbound")
        self._inner.send(data)

    def recv(self, timeout: Optional[float] = None):
        data = self._inner.recv(timeout)
        if self.side == "client":
            self._check_response(data, "inbound")
        else:
            self._check_request(data, "inbound")
        return data

    def request(self, data, timeout: Optional[float] = None):
        self.send(data)
        return self.recv(timeout)

    def stats(self) -> dict:
        with self._lock:
            return {"frames_validated": self.frames_validated,
                    "violations": self.violations,
                    "outstanding": len(self._outstanding)}

    def close(self) -> None:
        self._inner.close()
