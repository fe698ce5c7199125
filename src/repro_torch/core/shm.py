"""Shared-memory ring transport: same-host offload with the payload never
crossing a socket.

``SharedMemoryChannel`` implements the ``Channel`` interface over a pair of
mmap ring regions — one per direction — with a stream socket as the
doorbell (eventfd/pipe-style: tiny tokens, peer-death = EOF).  The shared
region is registered as ``BufferPool`` **slab backing** (the hook
``repro_torch.core.memory`` was designed for), which is the actual win:

* **send** — the vectored frame's segments are copied once, straight into
  a lease carved from the sender's TX half of the mmap, and a 17-byte
  ``FRAME(offset, len)`` token rings the peer's doorbell.  No ``sendmsg``
  of payload, no kernel socket buffer.
* **recv** — the receiver maps the token to a ``_RingLease`` whose view
  *is* the peer's slab bytes; ``unpack_message`` pins ``PooledView``
  leaves directly over the mmap.  Zero copies on the receive side.
* **credit** — when the receiver's lease fully releases (base ref + every
  leaf pin), a ``CREDIT(offset, len)`` token flows back and the sender
  releases its TX lease, recycling the slab.  Lease lifetime is therefore
  a *cross-process* contract, enforced by the same refcounts the TCP path
  uses.

Frames that don't fit the ring (oversize, or every slab pinned by
unreleased peer leases) **spill** over the doorbell socket as
``SPILL(len)`` + payload — the counted degradation path, mirroring
``BufferPool``'s fallback semantics: never an error, visible in stats.

Doorbell protocol (all little-endian, one stream both directions)::

    token   = kind u8 | a u64 | b u64          (17 bytes)
    FRAME   = 1, a=TX-region offset, b=payload length
    CREDIT  = 2, a=offset, b=length            (receiver fully released)
    SPILL   = 3, a=payload length, b=0, followed by a payload bytes
    EOF / reset                                -> ChannelClosed

A killed peer closes the socket, so a blocked ``recv`` wakes with
``ChannelClosed`` immediately — there is no stuck doorbell to poll.  A
timeout *mid-token* (or mid-spill) leaves the stream unframeable and fails
the channel, exactly like ``TCPChannel``'s mid-frame timeout.

Topologies:

* :meth:`SharedMemoryChannel.pair` — in-process endpoints over one
  anonymous mmap (tests, benches, wrapper-channel composition).
* :class:`SharedMemoryServer` + :meth:`SharedMemoryChannel.connect` —
  cross-process over an AF_UNIX socket; the server creates one backing
  file per connection (``/dev/shm`` when present), sends its path in a
  hello blob, and both sides mmap the same pages.

``repro_torch.avec`` auto-upgrades a TCP connection to this channel when the
handshake advertises an SHM listener on the same host (see
``ConnectPolicy.prefer_shm``); ``launch.serve --transport shm`` exposes
one.  The per-direction ring size is the ``shm_ring_bytes`` knob.
"""
from __future__ import annotations

import mmap
import os
import socket
import struct
import sys
import tempfile
import threading
import time
from collections import deque
from typing import Callable, Optional

from repro_torch.analysis import sanitize as _sanitize
from repro_torch.core.memory import (BufferLease, BufferPool, get_lease_tracker,
                                     release_buffer)
from repro_torch.core.transport import (Channel, ChannelClosed, ProtocolError,
                                        _segments)
from repro_torch.obs.config import global_config
from repro_torch.obs.trace import emit as _log

_TOKEN_FMT = "<BQQ"
_TOKEN_LEN = struct.calcsize(_TOKEN_FMT)     # 17
_K_FRAME = 1
_K_CREDIT = 2
_K_SPILL = 3

_HELLO_FMT = "<4sQH"                         # magic, ring_bytes, path length
_HELLO_MAGIC = b"SHM1"

#: slabs per TX region — ring_bytes/4 per slab so the default 16 MiB ring
#: pools the paper's ~3.76 MB OpenPose frame instead of spilling oversize
_TX_SLABS = 4


def _shm_dir() -> str:
    return "/dev/shm" if os.path.isdir("/dev/shm") else tempfile.gettempdir()


def _read_exact(sock: socket.socket, n: int) -> bytearray:
    """Read exactly ``n`` bytes (hello handshake only; channel reads go
    through the token reader)."""
    buf = bytearray(n)
    view, got = memoryview(buf), 0
    while got < n:
        k = sock.recv_into(view[got:])
        if k == 0:
            raise ChannelClosed("shm peer closed during hello")
        got += k
    return buf


class _RingRecvPool(BufferPool):
    """Receiver-side ``BufferPool`` over the *peer's* TX region.

    Leases are mapped at the offset the doorbell token names rather than
    carved by a local cursor (the peer's pool did the carving), so
    ``acquire`` is unused here — :meth:`lease_at` is the entry point, and
    every mapped lease is a pool hit by construction (hit rate 1.0: the
    bytes already live in pooled memory).  When a lease fully releases,
    ``credit`` tells the sender the region is reusable."""

    def __init__(self, region: memoryview, credit: Callable[[int, int], None],
                 name: str) -> None:
        super().__init__(slab_bytes=len(region), slabs=1, name=name)
        self._region = region
        self._credit = credit

    def lease_at(self, offset: int, nbytes: int) -> "_RingLease":
        if offset + nbytes > len(self._region):
            raise ProtocolError(
                f"shm frame token outside ring: off={offset} len={nbytes} "
                f"ring={len(self._region)}")
        view = self._region[offset:offset + nbytes]
        lease = _RingLease(self, view, offset)
        with self._lock:
            self.acquired += 1
            self.hits += 1
            self._live += 1
        tracker = get_lease_tracker()
        if tracker is not None:
            tracker.on_acquire(lease, self.name, nbytes)
        return lease


class _RingLease(BufferLease):
    """A received frame mapped in the peer's TX slab: releasing the last
    reference (base + leaf pins) sends the CREDIT token that lets the
    sender recycle the region."""

    __slots__ = ("_credited",)

    def __init__(self, pool: _RingRecvPool, view: memoryview,
                 offset: int) -> None:
        super().__init__(pool, view, None, offset)
        self._credited = False

    @property
    def pooled(self) -> bool:           # no local _Slab, but pooled memory
        return True

    def release(self) -> None:
        pool = self.pool
        with pool._lock:    # RLock: nested super().release() re-enters
            fire = self._refs == 1 and not self._credited
            if fire:
                self._credited = True
            super().release()
        if fire:            # outside the pool lock: credit does socket I/O
            pool._credit(self.region_offset, self.nbytes)


class SharedMemoryChannel(Channel):
    """Same-host zero-copy channel over a shared mmap (see module docstring).

    Constructor wires an endpoint over an already-established doorbell
    socket + mapped region; use :meth:`pair` (in-process) or
    :meth:`connect` (to a :class:`SharedMemoryServer`) instead."""

    #: ring sends never block on the peer (backpressure = spill), so the
    #: resumable-send machinery is unnecessary; pipelined runtimes use the
    #: plain blocking path
    supports_resumable_send = False

    #: deadline for a spilled frame's socket send (see :meth:`_spill`)
    SPILL_TIMEOUT_S = 10.0

    def __init__(self, sock: socket.socket, mm, tx_off: int, rx_off: int,
                 ring_bytes: int, *, name: str = "shm",
                 shm_path: Optional[str] = None) -> None:
        sock.settimeout(None)
        self._sock = sock
        self._mm = mm                   # keeps the mapping alive
        self._mv = memoryview(mm)
        self.ring_bytes = int(ring_bytes)
        self.name = name
        self.shm_path = shm_path
        slab = max(self.ring_bytes // _TX_SLABS, 1)
        self._tx_pool = BufferPool(
            slab_bytes=slab, name=f"{name}-tx",
            backing=self._mv[tx_off:tx_off + self.ring_bytes])
        self.recv_pool = _RingRecvPool(
            self._mv[rx_off:rx_off + self.ring_bytes], self._send_credit,
            name=f"{name}-rx")
        # pure I/O mutexes (serialize socket reads/writes) — deliberately
        # NOT guarded-by registered: blocking socket calls under them are
        # by design, and no shared counters hide behind them
        self._rio = _sanitize.make_lock(f"SharedMemoryChannel[{name}]._rio")
        self._wio = _sanitize.make_lock(f"SharedMemoryChannel[{name}]._wio")
        self._state = _sanitize.make_lock(
            f"SharedMemoryChannel[{name}]._state")
        self._outstanding: dict = {}    # guarded-by: _state (TX offset -> lease)
        self._tx_live_bytes = 0         # guarded-by: _state
        self._rx_tokens: deque = deque()  # guarded-by: _state (frames awaiting recv)
        self._broken = False
        self._tok = bytearray(_TOKEN_LEN)   # reusable: token reads under _rio
        self.frames_sent = 0            # guarded-by: _state
        self.frames_received = 0        # guarded-by: _state
        self.spills_sent = 0            # guarded-by: _state
        self.spills_received = 0        # guarded-by: _state
        self.credits_sent = 0           # guarded-by: _state
        self.credits_received = 0       # guarded-by: _state

    # -- construction ------------------------------------------------------
    @classmethod
    def pair(cls, ring_bytes: Optional[int] = None
             ) -> tuple["SharedMemoryChannel", "SharedMemoryChannel"]:
        """In-process endpoint pair over one anonymous mapping."""
        ring = int(global_config().resolve("shm_ring_bytes", ring_bytes))
        mm = mmap.mmap(-1, 2 * ring)
        sa, sb = socket.socketpair()
        a = cls(sa, mm, tx_off=0, rx_off=ring, ring_bytes=ring, name="shm-a")
        b = cls(sb, mm, tx_off=ring, rx_off=0, ring_bytes=ring, name="shm-b")
        return a, b

    @classmethod
    def connect(cls, path: str, timeout: float = 10.0,
                pool=None) -> "SharedMemoryChannel":
        """Dial a :class:`SharedMemoryServer`'s AF_UNIX socket at ``path``,
        receive the hello naming the per-connection backing file, and map
        it.  ``pool`` is accepted for dial-signature compatibility and
        ignored (the ring IS the pool)."""
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(timeout)
        try:
            sock.connect(path)
            hello = _read_exact(sock, struct.calcsize(_HELLO_FMT))
            magic, ring, plen = struct.unpack(_HELLO_FMT, hello)
            if magic != _HELLO_MAGIC:
                raise ProtocolError(f"bad shm hello magic {magic!r}")
            shm_path = bytes(_read_exact(sock, plen)).decode()
            fd = os.open(shm_path, os.O_RDWR)
            try:
                mm = mmap.mmap(fd, 2 * ring)
            finally:
                os.close(fd)
        except (OSError, ChannelClosed):
            sock.close()
            raise
        # server TX is the first half; the client transmits in the second
        return cls(sock, mm, tx_off=ring, rx_off=0, ring_bytes=ring,
                   name=f"shm-client-{os.path.basename(path)}",
                   shm_path=shm_path)

    # -- properties --------------------------------------------------------
    @property
    def broken(self) -> bool:
        return self._broken

    def stats(self) -> dict:
        with self._state:
            out = {
                "ring_bytes": self.ring_bytes,
                "tx_outstanding_bytes": self._tx_live_bytes,
                "tx_outstanding_frames": len(self._outstanding),
                "ring_occupancy": self._tx_live_bytes / self.ring_bytes,
                "frames_sent": self.frames_sent,
                "frames_received": self.frames_received,
                "spills_sent": self.spills_sent,
                "spills_received": self.spills_received,
                "credits_sent": self.credits_sent,
                "credits_received": self.credits_received,
            }
        out["tx_pool"] = self._tx_pool.stats()
        out["rx_pool"] = self.recv_pool.stats()
        return out

    # -- send path ---------------------------------------------------------
    def send(self, data) -> None:
        """Place the frame in shared slab memory and ring the doorbell;
        spill over the socket when the ring can't take it (counted)."""
        if self._broken:
            raise ChannelClosed("shared-memory channel closed")
        segs = _segments(data)
        total = sum(len(s) for s in segs)
        self._poll_credits()
        lease = self._tx_pool.acquire(total)
        placed = False
        try:
            if lease.region_offset >= 0:
                view, pos = lease.view, 0
                for s in segs:
                    n = len(s)
                    view[pos:pos + n] = s
                    pos += n
                with self._state:
                    # handed off: the CREDIT handler (or _fail) releases it
                    self._outstanding[lease.region_offset] = lease  # avecheck: handoff
                    self._tx_live_bytes += total
                    self.frames_sent += 1
                placed = True
        finally:
            if not placed:
                lease.release()
        if placed:
            self._send_token(_K_FRAME, lease.region_offset, total)
        else:
            self._spill(segs, total)

    def _send_token(self, kind: int, a: int, b: int) -> None:
        tok = struct.pack(_TOKEN_FMT, kind, a, b)
        with self._wio:
            try:
                self._sock.sendall(tok)
            except OSError as e:
                self._fail()
                raise ChannelClosed(f"shm doorbell send failed: {e}")

    def _spill(self, segs: list, total: int) -> None:
        # Spills traverse the doorbell socket, whose kernel buffer is tiny
        # next to the ring: a peer that stops receiving would block us
        # forever, so the whole spill gets a deadline — a mid-spill timeout
        # tears framing and fails the channel (TCP mid-frame semantics).
        tok = struct.pack(_TOKEN_FMT, _K_SPILL, total, 0)
        with self._wio:
            try:
                self._sock.settimeout(self.SPILL_TIMEOUT_S)
                try:
                    self._sock.sendall(tok)
                    for s in segs:
                        self._sock.sendall(s)
                finally:
                    if not self._broken:
                        self._sock.settimeout(None)
            except socket.timeout:
                self._fail()
                raise ChannelClosed(
                    f"shm spill stalled > {self.SPILL_TIMEOUT_S}s "
                    f"(peer not draining); channel failed")
            except OSError as e:
                self._fail()
                raise ChannelClosed(f"shm spill send failed: {e}")
        with self._state:
            self.spills_sent += 1

    def _send_credit(self, offset: int, nbytes: int) -> None:
        """Receiver-side: tell the peer its TX region is reusable.  A dead
        peer makes this a no-op — its sender pool died with it."""
        if self._broken:
            return
        tok = struct.pack(_TOKEN_FMT, _K_CREDIT, offset, nbytes)
        with self._wio:
            try:
                self._sock.sendall(tok)
            except OSError:
                self._fail()
                return
        with self._state:
            self.credits_sent += 1

    # -- receive path ------------------------------------------------------
    def recv(self, timeout: Optional[float] = None):
        """Next frame as a :class:`_RingLease` (zero-copy over the peer's
        slab) or, for spilled frames, a plain ``bytearray``.  TimeoutError
        on a clean timeout; ChannelClosed once the peer is gone."""
        deadline = (time.monotonic() + timeout) if timeout is not None \
            else None
        while True:
            with self._state:
                queued = self._rx_tokens.popleft() if self._rx_tokens \
                    else None
                if queued is not None and queued[0] != "spill":
                    self.frames_received += 1
            if queued is not None:
                if queued[0] == "spill":
                    return queued[1]
                return self.recv_pool.lease_at(queued[0], queued[1])
            if self._broken:
                raise ChannelClosed("shared-memory channel closed")
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError("shm recv timeout")
            with self._rio:
                got = self._read_token(remaining)
                spill = self._dispatch_token(got) if got is not None \
                    else None
            if got is None:
                raise TimeoutError("shm recv timeout")
            if spill is not None:
                return spill

    def _read_token(self, timeout: Optional[float]):
        """Read one 17-byte token (caller holds ``_rio``).  Returns the
        unpacked tuple, or None on a clean timeout at byte 0.  A timeout
        mid-token tears framing: the channel fails."""
        view = memoryview(self._tok)
        got = 0
        self._sock.settimeout(timeout)
        try:
            while got < _TOKEN_LEN:
                try:
                    n = self._sock.recv_into(view[got:])
                except socket.timeout:
                    if got == 0:
                        return None
                    self._fail()
                    raise ChannelClosed(
                        f"shm recv timeout mid-token ({got}/{_TOKEN_LEN}B); "
                        f"channel failed")
                except OSError as e:
                    self._fail()
                    raise ChannelClosed(str(e))
                if n == 0:
                    self._fail()
                    raise ChannelClosed("shm peer closed the doorbell")
                got += n
        finally:
            if not self._broken:
                try:
                    self._sock.settimeout(None)
                except OSError:
                    pass
        return struct.unpack(_TOKEN_FMT, self._tok)

    def _dispatch_token(self, tok):
        """Route one token (caller holds ``_rio``: a SPILL body is read off
        the socket in place).  Returns a spilled payload to hand to the
        caller, else None (FRAME tokens queue; CREDITs release)."""
        kind, a, b = tok
        if kind == _K_FRAME:
            with self._state:
                self._rx_tokens.append((a, b))
            return None
        if kind == _K_CREDIT:
            self._on_credit(a, b)
            return None
        if kind == _K_SPILL:
            buf = bytearray(a)
            view, got = memoryview(buf), 0
            self._sock.settimeout(None)
            while got < a:
                try:
                    n = self._sock.recv_into(view[got:])
                except OSError as e:
                    self._fail()
                    raise ChannelClosed(str(e))
                if n == 0:
                    self._fail()
                    raise ChannelClosed("shm peer closed mid-spill payload")
                got += n
            with self._state:
                self.spills_received += 1
            return buf
        self._fail()
        raise ProtocolError(f"unknown shm token kind {kind}")

    def _on_credit(self, offset: int, nbytes: int) -> None:
        with self._state:
            lease = self._outstanding.pop(offset, None)
            if lease is not None:
                self._tx_live_bytes -= lease.nbytes
                self.credits_received += 1
        if lease is not None:
            lease.release()

    def _poll_credits(self) -> None:
        """Drain already-arrived tokens without blocking, so a send-heavy
        caller recycles TX slabs even before its next ``recv``.  Skipped
        entirely when another thread is parked in a blocking read (that
        thread processes credits as they arrive)."""
        if not self._rio.acquire(blocking=False):
            return
        try:
            while True:
                self._sock.settimeout(0.0)
                try:
                    n = self._sock.recv_into(memoryview(self._tok)[:1])
                except (BlockingIOError, InterruptedError, socket.timeout):
                    return
                except OSError as e:
                    self._fail()
                    raise ChannelClosed(str(e))
                finally:
                    if not self._broken:
                        try:
                            self._sock.settimeout(None)
                        except OSError:
                            pass
                if n == 0:
                    self._fail()
                    raise ChannelClosed("shm peer closed the doorbell")
                # finish the token blockingly: 16 more bytes already in
                # flight from a peer that committed to the send
                view, got = memoryview(self._tok), 1
                while got < _TOKEN_LEN:
                    try:
                        k = self._sock.recv_into(view[got:])
                    except OSError as e:
                        self._fail()
                        raise ChannelClosed(str(e))
                    if k == 0:
                        self._fail()
                        raise ChannelClosed("shm peer closed mid-token")
                    got += k
                tok = struct.unpack(_TOKEN_FMT, self._tok)
                if tok[0] == _K_SPILL:
                    # a spilled frame meant for recv(): drain its payload
                    # (we hold _rio) and park it for the next recv call
                    buf = self._dispatch_token(tok)
                    with self._state:
                        self._rx_tokens.append(("spill", buf))
                    return
                self._dispatch_token(tok)
        finally:
            self._rio.release()

    # -- teardown ----------------------------------------------------------
    def _fail(self) -> None:
        with self._state:
            self._broken = True
            dead = list(self._outstanding.values())
            self._outstanding.clear()
            self._tx_live_bytes = 0
        for lease in dead:
            lease.release()
        try:
            self._sock.close()
        except OSError:
            pass

    def close(self) -> None:
        """Close the doorbell (the peer sees EOF).  Outstanding TX leases
        are released — their frames are lost with the channel.  The mapping
        itself is only unmapped once no decoded view pins it (BufferError
        guard), otherwise it lives until the leases do."""
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._fail()
        try:
            self._mv.release()
            self._mm.close()
        except (BufferError, ValueError):
            pass    # live PooledViews still point into the mapping


class SharedMemoryServer:
    """AF_UNIX accept loop feeding frames to ``handler`` over per-connection
    :class:`SharedMemoryChannel`s — the same serial recv -> handle -> send
    contract as ``TCPServer``, with the response placed straight into the
    connection's TX ring.

    Each connection gets its own backing file (created under ``/dev/shm``
    when available) sized ``2 * ring_bytes``; the file is unlinked as soon
    as both sides have it mapped, so a crashed process leaks nothing."""

    def __init__(self, handler: Callable, path: Optional[str] = None,
                 ring_bytes: Optional[int] = None,
                 join_timeout: Optional[float] = None) -> None:
        self._handler = handler
        self.ring_bytes = int(global_config().resolve(
            "shm_ring_bytes", ring_bytes))
        self.path = path or os.path.join(
            tempfile.mkdtemp(prefix="avec-shm-"), "doorbell.sock")
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(self.path)
        self._sock.listen(16)
        self.join_timeout = float(global_config().resolve(
            "server_join_timeout_s", join_timeout))
        self._stop = threading.Event()
        self._lock = _sanitize.make_lock("SharedMemoryServer._lock")
        self._threads: list = []        # guarded-by: _lock
        self._channels: list = []       # guarded-by: _lock
        self._pools: list = []          # guarded-by: _lock
        self._pool_totals = {"pools": 0, "acquired": 0, "released": 0,
                             "hits": 0, "misses": 0,
                             "wraps": 0}   # guarded-by: _lock
        self._thread = threading.Thread(target=self._serve, daemon=True)

    @property
    def address(self) -> str:
        return self.path

    def start(self) -> "SharedMemoryServer":
        self._thread.start()
        return self

    def _serve(self) -> None:
        self._sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                with self._lock:
                    self._threads = [t for t in self._threads if t.is_alive()]
                continue
            except OSError:
                break
            t = threading.Thread(target=self._client, args=(conn,),
                                 daemon=True)
            with self._lock:
                self._threads = [x for x in self._threads if x.is_alive()]
                self._threads.append(t)
            t.start()

    def _open_channel(self, conn: socket.socket) -> SharedMemoryChannel:
        ring = self.ring_bytes
        fd, shm_path = tempfile.mkstemp(prefix="avec-ring-", dir=_shm_dir())
        try:
            os.ftruncate(fd, 2 * ring)
            mm = mmap.mmap(fd, 2 * ring)
        finally:
            os.close(fd)
        pbytes = shm_path.encode()
        conn.sendall(struct.pack(_HELLO_FMT, _HELLO_MAGIC, ring,
                                 len(pbytes)) + pbytes)
        return SharedMemoryChannel(
            conn, mm, tx_off=0, rx_off=ring, ring_bytes=ring,
            name=f"shm-conn-{conn.fileno()}", shm_path=shm_path)

    def _client(self, conn: socket.socket) -> None:
        ch = None
        try:
            ch = self._open_channel(conn)
        except OSError:
            conn.close()
            return
        with self._lock:
            self._channels.append(ch)
            self._pools.append(ch.recv_pool)
        try:
            while not self._stop.is_set():
                req = ch.recv()
                try:
                    ch.send(self._handler(req))
                finally:
                    release_buffer(req)
        except ProtocolError as e:
            _log("protocol_error", stream=sys.stderr,
                 component="SharedMemoryServer", error=str(e))
        except (ChannelClosed, OSError):
            pass
        finally:
            with self._lock:
                if ch in self._channels:
                    self._channels.remove(ch)
                me = threading.current_thread()
                self._threads = [t for t in self._threads
                                 if t is not me and t.is_alive()]
            ch.close()
            ch.recv_pool.retired = True
            if ch.shm_path:
                try:
                    os.unlink(ch.shm_path)
                except OSError:
                    pass
            self._reap_pools()

    def _reap_pools(self) -> None:
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
        """Aggregated RX ring counters across connections — same shape as
        ``TCPServer.pool_stats`` so obs bindings and leak gates reuse it."""
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

    def channel_stats(self) -> list:
        with self._lock:
            channels = list(self._channels)
        return [ch.stats() for ch in channels]

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            channels, threads = list(self._channels), list(self._threads)
        for ch in channels:     # unblock client threads parked in recv
            try:
                ch._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        deadline = time.monotonic() + self.join_timeout
        self._thread.join(timeout=self.join_timeout)
        for t in threads:
            t.join(timeout=max(deadline - time.monotonic(), 0.05))
        try:
            os.unlink(self.path)
        except OSError:
            pass
