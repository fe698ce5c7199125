"""Transport channels between host and destination nodes.

* ``LoopbackChannel``  — in-process queue pair (tests, same-process demos).
                         Vectored ``Frame``s pass through untouched (true
                         zero-copy in-process).
* ``TCPChannel``       — real sockets with length-prefixed frames (the paper's
                         Boost-ASIO analogue).  Sends vectored frames with
                         ``socket.sendmsg`` scatter-gather (no join copy) and
                         receives with ``recv_into`` **pooled slab memory**
                         (``repro_torch.core.memory.BufferPool``): in the steady
                         state a received frame costs zero payload-buffer
                         allocations — the bytes land in a recycled ring
                         slab and come back as a :class:`BufferLease` the
                         consumer chain releases (pool misses fall back to a
                         counted plain allocation; pass ``pool=False`` for
                         the legacy per-frame ``bytearray``).  ``TCPServer``
                         runs a DestinationExecutor behind a listening
                         socket with one recv pool per connection.
* ``SimulatedChannel`` — loopback + a virtual clock charging the calibrated
                         link model (latency + bytes/bandwidth + destination
                         serialization rate).  Used to reproduce the paper's
                         test-bed numbers on this CPU-only container.

Framing on the wire: ``[8B u64 little-endian length][frame bytes]`` where the
frame itself carries the AVEC preamble (see ``core.serialization``).
"""
from __future__ import annotations

import queue
import select
import socket
import struct
import sys
import threading
import time
from typing import Callable, Optional

from repro_torch.analysis import sanitize as _sanitize
from repro_torch.core.memory import BufferLease, BufferPool, release_buffer
from repro_torch.core.serialization import Frame
from repro_torch.obs.config import global_config
from repro_torch.obs.trace import emit as _log


class ChannelClosed(Exception):
    pass


class ProtocolError(ChannelClosed):
    """Unframeable / garbled bytes on a connection.  Past this point the
    stream cannot be re-synchronized, so transports must tear the connection
    down (loudly) rather than answer with a response nobody can address."""


class Channel:
    """Bidirectional message channel (bytes or vectored Frames in, bytes-like
    out)."""

    @property
    def broken(self) -> bool:
        """True once the channel's stream is unframeable (e.g. a mid-frame
        timeout) and every in-flight exchange on it is lost.  Wrapper
        channels must delegate to their inner channel."""
        return False

    def send(self, data) -> None:
        raise NotImplementedError

    def recv(self, timeout: Optional[float] = None):
        raise NotImplementedError

    def close(self) -> None:
        pass

    # RPC convenience -------------------------------------------------------
    def request(self, data, timeout: Optional[float] = None):
        self.send(data)
        return self.recv(timeout)


class DirectChannel(Channel):
    """Zero-transport channel: requests go straight into an executor-style
    handler (``handle(bytes) -> bytes``) in-process.  The standard shim for
    tests, benchmarks, and demos that don't need sockets.

    Closure semantics match ``TCPChannel``: after :meth:`close`, every
    ``request`` raises :class:`ChannelClosed` — runtimes never need to
    special-case the channel class to learn a stub is dead."""

    def __init__(self, executor) -> None:
        self.executor = executor
        self._closed = False

    def request(self, data, timeout=None):
        if self._closed:
            raise ChannelClosed("direct channel closed")
        return self.executor.handle(data)

    def close(self) -> None:
        self._closed = True


# ---------------------------------------------------------------------------
# Loopback
# ---------------------------------------------------------------------------

class LoopbackChannel(Channel):
    """In-process queue pair.  Timeout/closure semantics mirror
    ``TCPChannel`` — ``TimeoutError`` on a clean timeout,
    :class:`ChannelClosed` once either side has closed (and *repeatably*:
    the peer-closed sentinel is re-queued so every later ``recv``, from any
    thread, sees the closure instead of blocking forever)."""

    def __init__(self, tx: queue.Queue, rx: queue.Queue) -> None:
        self._tx, self._rx = tx, rx
        self._closed = False

    @staticmethod
    def pair() -> tuple["LoopbackChannel", "LoopbackChannel"]:
        a, b = queue.Queue(), queue.Queue()
        return LoopbackChannel(a, b), LoopbackChannel(b, a)

    def send(self, data) -> None:
        if self._closed:
            raise ChannelClosed("loopback channel closed")
        self._tx.put(data)

    def recv(self, timeout: Optional[float] = None):
        if self._closed:
            raise ChannelClosed("loopback channel closed")
        try:
            data = self._rx.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError("loopback recv timeout")
        if data is None:
            self._rx.put(None)      # persist closure for other waiters
            raise ChannelClosed("loopback peer closed")
        return data

    def close(self) -> None:
        self._closed = True
        self._tx.put(None)


# ---------------------------------------------------------------------------
# TCP
# ---------------------------------------------------------------------------

_IOV_MAX = 512          # segments per sendmsg call (conservative vs IOV_MAX)


def _segments(data) -> list:
    """Normalize bytes | Frame | BufferLease into memoryview segments."""
    if isinstance(data, Frame):
        return [s if isinstance(s, memoryview) else memoryview(s)
                for s in data.segments]
    if isinstance(data, BufferLease):
        return [data.view]
    return [memoryview(data)]


def _sendmsg_all(sock: socket.socket, segments: list) -> None:
    """Scatter-gather send of every segment, handling partial sends.  An
    index cursor tracks progress (a ``pending.pop(0)`` scheme is O(n^2) on
    large segment lists — big parameter trees have thousands of leaves)."""
    pending = [s for s in segments if len(s)]
    i = 0
    while i < len(pending):
        try:
            n = sock.sendmsg(pending[i:i + _IOV_MAX])
        except AttributeError:  # pragma: no cover - platforms without sendmsg
            for s in pending[i:]:
                sock.sendall(s)
            return
        while n:
            if n >= len(pending[i]):
                n -= len(pending[i])
                pending[i] = None       # release the buffer reference
                i += 1
            else:
                pending[i] = pending[i][n:]
                n = 0


class _SendState:
    """Resumable frame-send state machine.

    Tracks (segment index, intra-segment offset) progress of one wire frame
    — length prefix plus payload segments — across ``EAGAIN`` on a
    non-blocking send path, so a stalled send can be parked, receives pumped,
    and the SAME frame resumed exactly where the kernel stopped accepting
    bytes.  Framing integrity is the state machine's invariant: bytes are
    only ever consumed from the front, never re-sent or skipped.
    """

    __slots__ = ("segments", "index", "total", "sent", "stalls")

    def __init__(self, data) -> None:
        segs = _segments(data)
        total = sum(len(s) for s in segs)
        self.segments: list = [memoryview(struct.pack("<Q", total)),
                               *[s for s in segs if len(s)]]
        self.total = total + 8
        self.sent = 0
        self.index = 0
        self.stalls = 0             # would-block events while sending

    @property
    def done(self) -> bool:
        return self.index >= len(self.segments)

    def advance(self, n: int) -> None:
        """Consume ``n`` accepted bytes from the front of the frame."""
        self.sent += n
        while n:
            seg = self.segments[self.index]
            if n >= len(seg):
                n -= len(seg)
                self.segments[self.index] = None    # release the buffer ref
                self.index += 1
            else:
                self.segments[self.index] = seg[n:]
                n = 0


_MSG_DONTWAIT = getattr(socket, "MSG_DONTWAIT", 0)


def _send_frame(sock: socket.socket, data) -> None:
    segs = _segments(data)
    total = sum(len(s) for s in segs)
    _sendmsg_all(sock, [memoryview(struct.pack("<Q", total)), *segs])


def _recv_into_exact(sock: socket.socket, view: memoryview) -> int:
    """Fill ``view`` from the socket.  Raises _PartialRead(got) if a timeout
    (python-level or SO_RCVTIMEO's EAGAIN) interrupts mid-fill."""
    got = 0
    try:
        while got < len(view):
            n = sock.recv_into(view[got:], len(view) - got)
            if n == 0:
                raise ChannelClosed("socket closed")
            got += n
    except (socket.timeout, BlockingIOError, InterruptedError):
        raise _PartialRead(got)
    return got


def _set_rcvtimeo(sock: socket.socket, timeout) -> bool:
    """Arm a RECEIVE-direction-only timeout via SO_RCVTIMEO (0 = blocking).
    Unlike ``settimeout``, this cannot leak into a concurrent send on the
    same socket (full-duplex pipelined channels).  Returns False where the
    option is unavailable so callers can fall back to ``settimeout``."""
    t = 0.0 if timeout is None else max(float(timeout), 1e-6)
    try:
        sec = int(t)
        usec = int((t - sec) * 1e6)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVTIMEO,
                        struct.pack("@ll", sec, usec))
        return True
    except (AttributeError, OSError):  # pragma: no cover - non-POSIX
        return False


class _PartialRead(Exception):
    def __init__(self, got: int) -> None:
        super().__init__(f"timeout after {got} bytes")
        self.got = got


def _recv_frame(sock: socket.socket, pool: Optional[BufferPool] = None,
                hdr: Optional[bytearray] = None):
    """Blocking frame receive (server side).  With a ``pool``, the payload
    lands in leased slab memory (returned as a ``BufferLease`` the caller
    must release); without one, the legacy fresh ``bytearray``.  ``hdr`` is
    an optional reusable 8-byte scratch so a connection loop performs zero
    header allocations per frame."""
    hdr = bytearray(8) if hdr is None else hdr
    try:
        _recv_into_exact(sock, memoryview(hdr))
        (n,) = struct.unpack("<Q", hdr)
        if pool is not None:
            lease = pool.acquire(n)
            try:
                _recv_into_exact(sock, lease.view)
            except BaseException:
                lease.release()     # partial frame: the region is garbage
                raise
            return lease
        buf = bytearray(n)
        _recv_into_exact(sock, memoryview(buf))
    except _PartialRead as e:
        raise ChannelClosed(str(e))
    return buf


class TCPChannel(Channel):
    # resumable sends need per-call non-blocking sendmsg; flipping the whole
    # socket non-blocking instead would race a concurrent mid-frame recv
    # (which would then spuriously fail the channel), so without the flag
    # callers must use the plain blocking path
    supports_resumable_send = bool(_MSG_DONTWAIT)

    def __init__(self, sock: socket.socket, pool=None) -> None:
        """``pool`` — a shared :class:`BufferPool`, ``None`` for a private
        default-sized pool (lazy slabs: zero cost until the first recv), or
        ``False`` to disable pooling (legacy fresh ``bytearray`` per
        frame)."""
        self._sock = sock
        # pure I/O mutexes (serialize whole-frame send/recv) — deliberately
        # NOT guarded-by registered: blocking socket calls under them are by
        # design, and no shared counters hide behind them
        self._lock = _sanitize.make_lock("TCPChannel._lock")
        self._rlock = _sanitize.make_lock("TCPChannel._rlock")
        self._broken = False
        self._hdr = bytearray(8)    # reusable length-prefix scratch
        if isinstance(pool, BufferPool):
            self.recv_pool: Optional[BufferPool] = pool
        else:
            self.recv_pool = BufferPool(name="tcp-recv") if pool is None \
                else None

    @property
    def broken(self) -> bool:
        return self._broken

    @staticmethod
    def connect(host: str, port: int, timeout: float = 10.0,
                pool=None) -> "TCPChannel":
        sock = socket.create_connection((host, port), timeout=timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(None)       # connect timeout must not leak to I/O
        return TCPChannel(sock, pool=pool)

    def send(self, data) -> None:
        if self._broken:
            raise ChannelClosed("channel failed on a previous partial frame")
        with self._lock:
            try:
                _send_frame(self._sock, data)
            except socket.timeout:
                # a timeout can hit sendmsg when a concurrent recv set a
                # short per-call timeout on the shared socket; the frame may
                # be partially written, so the stream is unframeable — fail
                # the channel rather than let the next send corrupt it
                self._fail()
                raise TimeoutError(
                    "tcp send timed out mid-frame; channel failed")

    # -- resumable non-blocking send ---------------------------------------
    def begin_send(self, data) -> _SendState:
        """Start a resumable frame send; drive it with
        :meth:`try_send_resume`.  Callers must serialize begin/resume pairs
        per channel themselves (frames are atomic wire units) and must not
        interleave :meth:`send` with an unfinished state."""
        if self._broken:
            raise ChannelClosed("channel failed on a previous partial frame")
        return _SendState(data)

    def try_send_resume(self, state: _SendState) -> bool:
        """Push as many bytes of ``state``'s frame as the kernel will take
        WITHOUT blocking (per-call ``MSG_DONTWAIT``; the socket itself stays
        blocking so the receive path is untouched).  Returns True once the
        frame is fully written, False when the send buffer is full — drain
        receives / wait for writability, then call again.  Partial progress
        is kept in ``state``; framing can never tear because bytes are only
        consumed from the front."""
        if self._broken:
            raise ChannelClosed("channel failed on a previous partial frame")
        with self._lock:
            if not _MSG_DONTWAIT:  # pragma: no cover - no per-call flag
                # cannot send non-blockingly without flipping the SHARED
                # socket's mode under a concurrent mid-frame recv; degrade
                # to blocking (callers gate on supports_resumable_send)
                _sendmsg_all(self._sock, list(state.segments[state.index:]))
                state.index = len(state.segments)
                state.sent = state.total
                return True
            while not state.done:
                batch = state.segments[state.index:state.index + _IOV_MAX]
                try:
                    n = self._sock.sendmsg(batch, [], _MSG_DONTWAIT)
                except (BlockingIOError, InterruptedError):
                    state.stalls += 1
                    return False
                if n == 0:
                    state.stalls += 1
                    return False
                state.advance(n)
        return True

    def fail_partial_send(self, state: _SendState) -> None:
        """Abandoning a partially-written frame tears the wire framing (the
        peer would parse the next frame's length prefix out of payload
        bytes); the channel must be failed, exactly as the blocking ``send``
        path does on a mid-frame timeout.  No-op if the frame never started
        or already finished."""
        if state.sent and not state.done:
            self._fail()

    def wait_io(self, *, read: bool = True, write: bool = False,
                timeout: float = 0.05) -> tuple[bool, bool]:
        """``select()`` on the socket: returns (readable, writable).  The
        stalled-send pump uses this to sleep until EITHER the kernel will
        take more frame bytes or a response arrived to drain — no busy
        spin, no blocking send."""
        if self._broken:
            raise ChannelClosed("channel failed on a previous partial frame")
        try:
            r, w, _ = select.select([self._sock] if read else [],
                                    [self._sock] if write else [],
                                    [], max(timeout, 0.0))
        except (OSError, ValueError):
            raise ChannelClosed("socket closed while waiting for io")
        return bool(r), bool(w)

    def recv(self, timeout: Optional[float] = None):
        """Receive one frame into pooled slab memory (returned as a
        ``BufferLease`` — steady state: zero payload-buffer allocations per
        frame) or, with pooling disabled, a fresh ``bytearray``.

        The per-call timeout is armed with SO_RCVTIMEO (receive direction
        only — a concurrent ``send`` on this full-duplex socket must not
        inherit it) and disarmed afterwards; where SO_RCVTIMEO is
        unavailable it falls back to ``settimeout`` with restore.  A timeout
        *mid-frame* leaves the stream unframeable, so the channel is failed
        cleanly: marked broken and closed (and the partial frame's lease
        released); only a timeout before the first length byte is
        retryable."""
        with self._rlock:
            if self._broken:
                raise ChannelClosed("channel failed on a previous partial frame")
            via_rcvtimeo = _set_rcvtimeo(self._sock, timeout)
            prev = None
            if not via_rcvtimeo:
                prev = self._sock.gettimeout()
                self._sock.settimeout(timeout)
            try:
                hdr = self._hdr     # safe to reuse: recv serialized by _rlock
                try:
                    _recv_into_exact(self._sock, memoryview(hdr))
                except _PartialRead as e:
                    if e.got == 0:          # clean timeout: stream intact
                        raise TimeoutError("tcp recv timeout")
                    self._fail()
                    raise TimeoutError(
                        f"tcp recv timeout mid-header ({e.got}/8B); channel failed")
                (n,) = struct.unpack("<Q", hdr)
                lease = (self.recv_pool.acquire(n)
                         if self.recv_pool is not None else None)
                buf = lease.view if lease is not None else memoryview(
                    bytearray(n))
                try:
                    _recv_into_exact(self._sock, buf)
                except _PartialRead as e:
                    if lease is not None:
                        lease.release()
                    self._fail()
                    raise TimeoutError(
                        f"tcp recv timeout mid-frame ({e.got}/{n}B); channel failed")
                return lease if lease is not None else buf.obj
            finally:
                if not self._broken:
                    try:
                        if via_rcvtimeo:
                            _set_rcvtimeo(self._sock, None)
                        else:
                            self._sock.settimeout(prev)
                    except OSError:
                        pass

    def _fail(self) -> None:
        self._broken = True
        try:
            self._sock.close()
        except OSError:
            pass

    def close(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()


class TCPServer:
    """Accepts connections and feeds frames to a handler: bytes -> bytes/Frame.

    The per-connection loop is intentionally serial (recv -> handle -> send):
    a pipelined host keeps the connection's kernel buffer primed, so the next
    frame is a local memcpy away; an in-process read-ahead thread was
    measured to LOSE throughput to GIL contention with the handler.  Client
    threads are reaped as connections finish (no unbounded growth) and
    ``stop()`` joins the live ones with a timeout.

    Each connection receives into its own :class:`BufferPool` (serial loop:
    a small ring suffices) and the loop releases the request lease after
    the response is written — a handler that must hold request bytes past
    its return (the executor's coalescer) ``retain``s them.  Pass
    ``recv_pool=False`` for the legacy per-frame allocation;
    ``pool_stats()`` aggregates the live connections' pool counters."""

    def __init__(self, handler: Callable, host: str = "127.0.0.1",
                 port: int = 0, join_timeout: Optional[float] = None, *,
                 recv_pool: bool = True,
                 pool_slab_bytes: Optional[int] = None,
                 pool_slabs: Optional[int] = None) -> None:
        self._handler = handler
        self.recv_pool = recv_pool
        self._pool_kw = {}
        if pool_slab_bytes is not None:
            self._pool_kw["slab_bytes"] = int(pool_slab_bytes)
        if pool_slabs is not None:
            self._pool_kw["slabs"] = int(pool_slabs)
        self._pools: list[BufferPool] = []  # guarded-by: _lock
        # counters of reaped (closed + fully released) connection pools, so
        # pool_stats() stays lifetime-accurate without retaining every dead
        # connection's slab memory forever
        self._pool_totals = {"pools": 0, "acquired": 0, "released": 0,
                             "hits": 0, "misses": 0, "wraps": 0}  # guarded-by: _lock
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.port = self._sock.getsockname()[1]
        self.join_timeout = float(global_config().resolve(
            "server_join_timeout_s", join_timeout))
        self._stop = threading.Event()
        self._lock = _sanitize.make_lock("TCPServer._lock")
        self._threads: list[threading.Thread] = []  # guarded-by: _lock
        self._conns: list[socket.socket] = []       # guarded-by: _lock
        self._thread = threading.Thread(target=self._serve, daemon=True)

    def start(self) -> "TCPServer":
        self._thread.start()
        return self

    def live_client_threads(self) -> int:
        with self._lock:
            return sum(t.is_alive() for t in self._threads)

    def _serve(self) -> None:
        self._sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                with self._lock:   # reap finished client threads
                    self._threads = [t for t in self._threads if t.is_alive()]
                continue
            except OSError:
                break
            t = threading.Thread(target=self._client, args=(conn,), daemon=True)
            with self._lock:
                self._threads = [x for x in self._threads if x.is_alive()]
                self._threads.append(t)
                self._conns.append(conn)
            t.start()

    def _reap_pools(self) -> None:
        """Fold closed connections' fully-released pools into the lifetime
        totals and drop them — retaining every dead connection's slab
        memory would grow without bound under connection churn.  A closed
        pool with leases still outstanding (pins awaiting GC) is kept and
        retried on the next sweep."""
        with self._lock:
            keep = []
            for p in self._pools:
                if p.retired and p.outstanding() == 0:
                    s = p.stats()
                    self._pool_totals["pools"] += 1
                    for k in ("acquired", "released", "hits", "misses",
                              "wraps"):
                        self._pool_totals[k] += s[k]
                else:
                    keep.append(p)
            self._pools = keep

    def pool_stats(self) -> dict:
        """Aggregated recv-pool counters across this server's connections
        (lifetime: live pools plus reaped closed ones) — the lease-balance
        observability hook the leak tests assert on."""
        self._reap_pools()
        with self._lock:
            pools = list(self._pools)
            agg: dict = dict(self._pool_totals)
        agg["pools"] += len(pools)
        agg["outstanding"] = 0
        for p in pools:
            s = p.stats()
            for k in ("acquired", "released", "outstanding", "hits",
                      "misses", "wraps"):
                agg[k] += s[k]
        agg["hit_rate"] = (agg["hits"] / agg["acquired"]) if agg["acquired"] \
            else 1.0
        return agg

    def _client(self, conn: socket.socket) -> None:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        pool = None
        if self.recv_pool:
            pool = BufferPool(name=f"conn-{conn.fileno()}", **self._pool_kw)
            with self._lock:
                self._pools.append(pool)
        hdr = bytearray(8)          # per-connection: zero allocs per frame
        try:
            while not self._stop.is_set():
                req = _recv_frame(conn, pool, hdr)
                try:
                    _send_frame(conn, self._handler(req))
                finally:
                    release_buffer(req)
        except ProtocolError as e:
            # garbled stream: no addressable response is possible — drop the
            # connection and say so, instead of stranding the peer's futures
            _log("protocol_error", stream=sys.stderr,
                 component="TCPServer", error=str(e))
        except (ChannelClosed, OSError):
            pass
        finally:
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)
                # self-reap: a finished connection leaves _threads on its own
                # instead of lingering (stopped but listed) until the accept
                # loop's next 0.2s sweep
                me = threading.current_thread()
                self._threads = [t for t in self._threads
                                 if t is not me and t.is_alive()]
            conn.close()
            if pool is not None:
                pool.retired = True
            self._reap_pools()

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            conns, threads = list(self._conns), list(self._threads)
        for conn in conns:      # unblock client threads parked in recv
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        deadline = time.monotonic() + self.join_timeout
        self._thread.join(timeout=self.join_timeout)
        for t in threads:
            t.join(timeout=max(deadline - time.monotonic(), 0.05))
        with self._lock:
            self._threads = [t for t in self._threads if t.is_alive()]


# ---------------------------------------------------------------------------
# Simulated link (virtual clock)
# ---------------------------------------------------------------------------

class VirtualClock:
    """Accumulates simulated seconds, per category."""

    def __init__(self) -> None:
        self.elapsed: dict[str, float] = {}

    def charge(self, seconds: float, category: str) -> None:
        self.elapsed[category] = self.elapsed.get(category, 0.0) + seconds

    def total(self) -> float:
        return sum(self.elapsed.values())


class SimulatedChannel(Channel):
    """Loopback channel that charges a calibrated link model on a virtual
    clock: t = latency + bytes/bandwidth + bytes/serialize_rate (destination
    CPU cost, the term that makes the paper's *edge* link slower than its
    *cloud* link at equal data size — Fig. 9).

    With ``realtime=True`` the charged seconds are also actually slept, so
    the channel emulates a narrow real link in wall-clock time — the harness
    the adaptive in-flight window is exercised against (a link-bound
    simulated channel must grow the window; a compute-bound one must not)."""

    def __init__(self, inner: Channel, clock: VirtualClock, *,
                 bandwidth: float, latency: float, serialize_rate: float,
                 name: str = "link", realtime: bool = False) -> None:
        self._inner = inner
        self.clock = clock
        self.bandwidth = bandwidth
        self.latency = latency
        self.serialize_rate = serialize_rate
        self.name = name
        self.realtime = realtime

    @property
    def broken(self) -> bool:
        return getattr(self._inner, "broken", False)

    def _charge(self, nbytes: int, direction: str) -> None:
        t = self.latency + nbytes / self.bandwidth
        if self.serialize_rate > 0:
            t += nbytes / self.serialize_rate
        self.clock.charge(t, f"{self.name}.{direction}")
        if self.realtime and t > 0:
            time.sleep(t)

    def send(self, data) -> None:
        self._charge(len(data), "send")
        self._inner.send(data)

    def recv(self, timeout: Optional[float] = None):
        data = self._inner.recv(timeout)
        self._charge(len(data), "recv")
        return data

    def close(self) -> None:
        self._inner.close()


# ---------------------------------------------------------------------------
# Deterministic fault injection (chaos harness)
# ---------------------------------------------------------------------------

class FaultyChannel(Channel):
    """Deterministic fault injection over any channel — the chaos harness
    the failure-domain tests drive.

    Wraps an inner channel (TCP, Loopback, Simulated — they compose) and
    applies a seeded schedule of faults to the frames crossing it.  All
    faults default off; explicit schedules are 1-based frame indices
    counted per direction, probabilistic schedules draw from one seeded RNG
    so a given ``seed`` replays the exact same fault sequence.

    Fault vocabulary:

    * **drop**       — the frame is swallowed silently (``drop_sends`` /
                       ``drop_recvs`` indices, or ``drop_send_p``).  A
                       dropped response's lease is released, never leaked.
    * **delay**      — ``delay_s`` of sleep before the frame is forwarded
                       (``delay_sends`` / ``delay_recvs`` / ``delay_send_p``)
                       — the delayed-ack schedule.
    * **duplicate**  — the frame is delivered twice (``dup_sends`` /
                       ``dup_send_p``): duplicated request delivery at the
                       destination (replay-dedup territory) or a duplicated
                       response a pipelined host must ignore by rid.
    * **partial**    — ``partial_send_at``: the Nth outbound frame dies
                       mid-write.  Nothing framable reaches the peer and the
                       channel latches broken both ways (the kernel buffer
                       holds half a frame nobody can complete) — the
                       mid-frame-kill schedule.
    * **blackhole**  — from send #``blackhole_after`` on, every frame in
                       both directions is swallowed silently; ``recv`` burns
                       its timeout.  The node that is "up" but answers
                       nothing.

    ``faults`` counts every injection by kind; :meth:`stats` snapshots it.
    The wrapper intentionally does NOT expose the resumable-send API — a
    pipelined runtime over a faulty link uses the plain blocking send path,
    keeping the fault schedule frame-aligned and deterministic."""

    def __init__(self, inner: Channel, *, seed: int = 0,
                 drop_sends: tuple = (), drop_recvs: tuple = (),
                 dup_sends: tuple = (),
                 delay_sends: tuple = (), delay_recvs: tuple = (),
                 delay_s: float = 0.01,
                 drop_send_p: float = 0.0, dup_send_p: float = 0.0,
                 delay_send_p: float = 0.0,
                 partial_send_at: Optional[int] = None,
                 blackhole_after: Optional[int] = None) -> None:
        import random as _random
        self._inner = inner
        self._rng = _random.Random(seed)
        self.drop_sends = set(drop_sends)
        self.drop_recvs = set(drop_recvs)
        self.dup_sends = set(dup_sends)
        self.delay_sends = set(delay_sends)
        self.delay_recvs = set(delay_recvs)
        self.delay_s = delay_s
        self.drop_send_p = drop_send_p
        self.dup_send_p = dup_send_p
        self.delay_send_p = delay_send_p
        self.partial_send_at = partial_send_at
        self.blackhole_after = blackhole_after
        self._sends = 0             # guarded-by: _lock
        self._recvs = 0             # guarded-by: _lock
        self._blackholed = False    # guarded-by: _lock
        self._forced_broken = False # guarded-by: _lock
        self._lock = _sanitize.make_lock("FaultyChannel._lock")
        self.faults = {"dropped": 0, "duplicated": 0, "delayed": 0,
                       "partial": 0, "blackholed": 0}  # guarded-by: _lock

    @property
    def broken(self) -> bool:
        return self._forced_broken or getattr(self._inner, "broken", False)

    def stats(self) -> dict:
        with self._lock:
            return {"sends": self._sends, "recvs": self._recvs,
                    **self.faults}

    # ------------------------------------------------------------------
    def send(self, data) -> None:
        with self._lock:
            if self._forced_broken:
                raise ChannelClosed("faulty channel: broken by injected "
                                    "mid-frame kill")
            self._sends += 1
            i = self._sends
            if (self.blackhole_after is not None
                    and i >= self.blackhole_after):
                self._blackholed = True
            if self._blackholed:
                self.faults["blackholed"] += 1
                return
            if i == self.partial_send_at:
                # a frame cut mid-write is unframeable at the peer: nothing
                # is delivered, and the stream is dead in both directions
                self.faults["partial"] += 1
                self._forced_broken = True
                raise ChannelClosed(
                    f"faulty channel: injected mid-frame kill on send #{i}")
            drop = i in self.drop_sends or (
                self.drop_send_p and self._rng.random() < self.drop_send_p)
            dup = i in self.dup_sends or (
                self.dup_send_p and self._rng.random() < self.dup_send_p)
            delay = i in self.delay_sends or (
                self.delay_send_p and self._rng.random() < self.delay_send_p)
        if drop:
            with self._lock:
                self.faults["dropped"] += 1
            return
        if delay:
            with self._lock:
                self.faults["delayed"] += 1
            time.sleep(self.delay_s)
        self._inner.send(data)
        if dup:
            with self._lock:
                self.faults["duplicated"] += 1
            self._inner.send(data)

    def recv(self, timeout: Optional[float] = None):
        while True:
            with self._lock:
                if self._forced_broken:
                    raise ChannelClosed("faulty channel: broken by injected "
                                        "mid-frame kill")
                if self._blackholed:
                    self.faults["blackholed"] += 1
                    hole = True
                else:
                    hole = False
            if hole:
                time.sleep(timeout if timeout else 0.05)
                raise TimeoutError("faulty channel: recv blackholed")
            data = self._inner.recv(timeout)
            with self._lock:
                self._recvs += 1
                i = self._recvs
                drop = i in self.drop_recvs
                delay = i in self.delay_recvs
                if drop:
                    self.faults["dropped"] += 1
                elif delay:
                    self.faults["delayed"] += 1
            if drop:
                release_buffer(data)    # a swallowed frame's lease must not leak
                continue
            if delay:
                time.sleep(self.delay_s)
            return data

    def close(self) -> None:
        self._inner.close()
