"""Pooled receive memory: a slab/ring ``BufferPool`` with refcounted
``BufferLease`` handles — the ownership model of the AVEC receive path.

Every other allocation on the hot path fell in PRs 1-2 (vectored sends,
zero-copy unpack views); what remained was the receive buffer itself: each
frame materialized a fresh ``bytearray`` in ``TCPChannel.recv`` /
``_recv_frame``, and nothing could recycle it because pipelined futures,
coalesced batches, and zero-copy unpack views may alias the bytes long
after the transport layer is done with them.  This module makes buffer
*lifetime* an explicit cross-layer contract:

* :class:`BufferPool` — a ring of lazily-allocated fixed-size slabs.
  ``acquire(n)`` carves the next ``n`` bytes off the current slab (bump
  allocation); when the frame doesn't fit the slab's tail, the pool *wraps*
  to the next fully-released slab in the ring (or grows, up to
  ``max_slabs``).  Frames larger than a slab, or arriving with every slab
  pinned, fall back to a plain allocation — never an error, always counted
  (``miss_oversize`` / ``miss_exhausted``), so a misconfigured pool degrades
  to exactly the pre-pool behaviour.
* :class:`BufferLease` — one received frame's buffer.  Refcounted: the
  receiving layer owns the base reference and releases it when the frame is
  consumed (``HostRuntime``/``PipelinedHostRuntime`` after unpack,
  ``TCPServer`` after the response is written, the executor's coalescer
  after batch dispatch).  ``unpack_message`` *pins* the lease once per
  raw-codec leaf it decodes in place (:meth:`BufferLease.pin_ndarray`):
  the leaf is a :class:`PooledView` ndarray constructed directly over the
  slab memory, and a ``weakref.finalize`` releases the pin when the last
  array referencing it is garbage-collected.  A slab is recycled only when
  every lease carved from it has fully released — application code can
  therefore hold zero-copy results indefinitely (the slab just stays
  pinned); ``copy=True`` / :func:`detach_tree` detach eagerly instead.

Lease rules for new consumers:

1. Whoever calls ``recv`` owns the base reference and must ``release()``
   exactly once, after the frame's bytes are no longer *directly* needed
   (decoded leaf views carry their own pins).
2. Handing a frame to another component that outlives your scope means
   ``retain()`` before the hand-off and ``release()`` in that component's
   completion path (see the coalescer).
3. Never write through a lease you didn't acquire; decoded views are
   read-only by construction.
4. Release is idempotent past zero (counted in ``over_released``) so
   belt-and-braces error paths are safe, but a balanced pool —
   ``outstanding() == 0`` at teardown — is the invariant tests gate on.

This interface is deliberately transport-agnostic: a shared-memory or RDMA
transport registers its pinned region as the slab backing (``backing=`` —
``repro.core.shm`` carves its mmap ring through it) and the whole consumer
chain above it is already lease-correct.
"""
from __future__ import annotations

import weakref
from typing import Optional

import numpy as np

from repro_torch.analysis import sanitize as _sanitize
from repro_torch.obs.config import global_config

#: installed LeaseTracker hook (``repro_torch.analysis.sanitize``) or None.
#: Auto-installed when AVEC_SANITIZE=1; benches/tests may install their own
#: via :func:`set_lease_tracker` to prove leak-freedom without the env flag.
_TRACKER = (_sanitize.global_lease_tracker() if _sanitize.enabled() else None)


def set_lease_tracker(tracker) -> object:
    """Install ``tracker`` (a :class:`repro_torch.analysis.sanitize.LeaseTracker`
    or None) as the pool-wide acquisition/release hook; returns the
    previous hook so callers can restore it."""
    global _TRACKER
    prev, _TRACKER = _TRACKER, tracker
    return prev


def get_lease_tracker():
    return _TRACKER

#: default slab sizing: 8 x 4 MiB per pool, allocated lazily — an idle
#: channel costs nothing.  4 MiB fits the paper's own workload (an OpenPose
#: frame is ~3.76 MB on the wire, Eq. 1) so the flagship use case pools
#: instead of falling back oversize.  These are the registered defaults of
#: the ``pool_slab_bytes`` / ``pool_slabs`` knobs (repro_torch.obs.config);
#: AVEC_POOL_SLAB_BYTES / AVEC_POOL_SLABS override any constructor value.
DEFAULT_SLAB_BYTES = 4 << 20
DEFAULT_SLABS = 8


class PooledView(np.ndarray):
    """A read-only ndarray decoded *in place* over pooled receive memory.

    Constructed directly over the slab buffer so it sits at the bottom of
    every derived view's base chain — numpy's base collapsing can never
    drop the reference that keeps the lease pinned.  Arithmetic results are
    fresh owning arrays; ``np.array(x, subok=False)`` (or
    :func:`detach_tree`) detaches an owning copy explicitly."""


class _Slab:
    __slots__ = ("buf", "view", "offset", "live", "base")

    def __init__(self, nbytes: int, buf=None, base: int = -1) -> None:
        # ``buf`` non-None: the slab is a window carved from an external
        # backing region (shared memory / pinned DMA) at region offset
        # ``base`` instead of a private heap bytearray.
        self.buf = bytearray(nbytes) if buf is None else buf
        self.view = memoryview(self.buf)
        self.offset = 0         # bump cursor
        self.live = 0           # leases carved from this slab still held
        self.base = base        # region offset of byte 0 (-1: heap slab)


class BufferLease:
    """One received frame's buffer, leased from a :class:`BufferPool`.

    Quacks like the ``bytearray`` the pre-pool receive path returned
    (``len``/``bytes``/indexing/equality) so legacy byte-level consumers
    keep working, while lease-aware layers use :attr:`view` for zero-copy
    access and :meth:`retain`/:meth:`release` for lifetime."""

    __slots__ = ("pool", "view", "nbytes", "_slab", "_refs",
                 "region_offset")

    def __init__(self, pool: "BufferPool", view: memoryview,
                 slab: _Slab | None, region_offset: int = -1) -> None:
        self.pool = pool
        self.view = view
        self.nbytes = len(view)
        self._slab = slab
        self._refs = 1
        #: byte offset of this lease within the pool's external backing
        #: region (-1 for heap-backed leases) — the address a shared-memory
        #: transport puts in its doorbell token so the peer maps the same
        #: bytes without any copy.
        self.region_offset = region_offset

    # -- bytes-like compatibility --------------------------------------
    def __len__(self) -> int:
        return self.nbytes

    def __bytes__(self) -> bytes:
        return bytes(self.view)

    def to_bytes(self) -> bytes:
        return bytes(self.view)

    def __getitem__(self, key):
        # full bytes semantics (including negative steps) for the rare
        # byte-twiddling consumer; not a hot path
        return bytes(self.view)[key]

    def __eq__(self, other) -> bool:
        if isinstance(other, BufferLease):
            return self.view == other.view
        if isinstance(other, (bytes, bytearray, memoryview)):
            return bytes(self.view) == bytes(other)
        return NotImplemented

    __hash__ = None     # mutable-ish wire buffer: never a dict key

    # -- lifetime ------------------------------------------------------
    @property
    def pooled(self) -> bool:
        return self._slab is not None

    @property
    def released(self) -> bool:
        return self._refs == 0

    def retain(self) -> "BufferLease":
        with self.pool._lock:
            if self._refs <= 0:
                raise RuntimeError("retain() on a fully released BufferLease")
            self._refs += 1
        return self

    def release(self) -> None:
        """Drop one reference; at zero the slab region becomes reusable.
        Extra releases are counted, not fatal (error paths may overlap)."""
        pool = self.pool
        with pool._lock:
            if self._refs <= 0:
                pool.over_released += 1
                return
            self._refs -= 1
            if self._refs:
                return
            pool.released += 1
            pool._live -= 1
            if self._slab is not None:
                self._slab.live -= 1
        if _TRACKER is not None:
            _TRACKER.on_release(self)

    def pin_ndarray(self, buf: memoryview, dtype, shape) -> np.ndarray:
        """Decode one leaf in place: a read-only :class:`PooledView` over
        ``buf`` (a sub-view of this lease) that pins the lease until the
        last array referencing it is garbage-collected."""
        arr = PooledView(shape, dtype=dtype, buffer=buf)
        self.retain()
        weakref.finalize(arr, self.release)   # avecheck: handoff
        arr.flags.writeable = False
        return arr


class BufferPool:
    """Ring of fixed-size slabs with bump allocation and wraparound reuse.

    Thread-safe (one reentrant lock: ``weakref.finalize`` pin-releases may
    fire inside an allocation triggered under the lock).  Slabs are
    allocated lazily up to ``slabs``; see the module docstring for the
    miss/fallback semantics and sizing guidance."""

    def __init__(self, slab_bytes: Optional[int] = None,
                 slabs: Optional[int] = None, name: str = "pool",
                 backing: Optional[memoryview] = None) -> None:
        cfg = global_config()
        self.slab_bytes = int(cfg.resolve("pool_slab_bytes", slab_bytes))
        self.max_slabs = max(int(cfg.resolve("pool_slabs", slabs)), 1)
        self.name = name
        self.backing = backing
        self._lock = _sanitize.make_rlock(f"BufferPool[{name}]._lock")
        self._slabs: list[_Slab] = []   # guarded-by: _lock
        self._cursor = 0                # guarded-by: _lock
        if backing is not None:
            # External backing region (the shared-memory/RDMA hook the
            # module docstring promises): carve it eagerly into as many
            # full slabs as fit and never heap-grow past them — a frame
            # that can't be placed falls back (counted) exactly like an
            # exhausted heap pool, and the transport decides what a
            # fallback means (e.g. spill over the control socket).
            n = len(backing) // self.slab_bytes
            if n < 1:
                raise ValueError(
                    f"backing region ({len(backing)} B) smaller than one "
                    f"slab ({self.slab_bytes} B)")
            self.max_slabs = n
            for i in range(n):
                base = i * self.slab_bytes
                self._slabs.append(_Slab(
                    self.slab_bytes,
                    buf=backing[base:base + self.slab_bytes], base=base))
        self._live = 0                  # guarded-by: _lock (leases with refs > 0)
        self.acquired = 0               # guarded-by: _lock
        self.released = 0               # guarded-by: _lock
        self.hits = 0                   # guarded-by: _lock
        self.miss_oversize = 0          # guarded-by: _lock
        self.miss_exhausted = 0         # guarded-by: _lock
        self.wraps = 0                  # guarded-by: _lock
        self.slab_allocs = 0            # guarded-by: _lock
        self.fallback_bytes = 0         # guarded-by: _lock
        self.over_released = 0          # guarded-by: _lock
        #: owner is done acquiring (e.g. its connection closed); aggregators
        #: may fold and drop the pool once outstanding() reaches zero
        self.retired = False

    # ------------------------------------------------------------------
    def acquire(self, nbytes: int) -> BufferLease:
        """Lease ``nbytes`` of receive memory (misses fall back to a
        counted plain allocation).  Counters only mutate once the lease
        exists — a failing allocation (``MemoryError`` on a garbage length
        prefix) must not unbalance the accounting the leak gates assert
        on."""
        with self._lock:
            if nbytes > self.slab_bytes:
                lease = self._fallback(nbytes)      # may raise: no counters
                self.miss_oversize += 1
            else:
                slab = self._slabs[self._cursor] if self._slabs else None
                if slab is None or slab.offset + nbytes > self.slab_bytes:
                    slab = self._wrap()             # may raise growing a slab
                if slab is None:
                    lease = self._fallback(nbytes)
                    self.miss_exhausted += 1
                else:
                    view = slab.view[slab.offset:slab.offset + nbytes]
                    off = (slab.base + slab.offset) if slab.base >= 0 else -1
                    lease = BufferLease(self, view, slab, off)
                    slab.offset += nbytes
                    slab.live += 1
                    self.hits += 1
            self.acquired += 1
            self._live += 1
        if _TRACKER is not None:
            _TRACKER.on_acquire(lease, self.name, nbytes)
        return lease

    def _wrap(self) -> _Slab | None:  # avecheck: ignore[lock] -- caller (acquire) holds _lock
        """Rewind or advance to a fully-released slab (resetting its bump
        cursor), growing the ring while under ``max_slabs``.  The CURRENT
        slab is checked first: in the steady sequential case (each frame
        released before the next arrives) the pool then recycles one
        cache-hot slab instead of marching through the whole ring's cold
        memory."""
        n = len(self._slabs)
        for k in range(n):
            i = (self._cursor + k) % n
            s = self._slabs[i]
            if s.live == 0:
                s.offset = 0
                self._cursor = i
                self.wraps += 1
                return s
        if n < self.max_slabs:
            s = _Slab(self.slab_bytes)
            self._slabs.append(s)
            self._cursor = n
            self.slab_allocs += 1
            return s
        return None

    def _fallback(self, nbytes: int) -> BufferLease:  # avecheck: ignore[lock] -- caller (acquire) holds _lock
        lease = BufferLease(self, memoryview(bytearray(nbytes)), None)
        self.fallback_bytes += nbytes       # only counted once allocated
        return lease

    # ------------------------------------------------------------------
    def outstanding(self) -> int:
        """Leases not yet fully released (base refs + leaf pins)."""
        with self._lock:
            return self._live

    @property
    def misses(self) -> int:
        return self.miss_oversize + self.miss_exhausted

    @property
    def hit_rate(self) -> float:
        with self._lock:
            return (self.hits / self.acquired) if self.acquired else 1.0

    def stats(self) -> dict:
        with self._lock:
            return {
                "name": self.name,
                "slab_bytes": self.slab_bytes,
                "max_slabs": self.max_slabs,
                "slabs": len(self._slabs),
                "acquired": self.acquired,
                "released": self.released,
                "outstanding": self._live,
                "hits": self.hits,
                "misses": self.misses,
                "miss_oversize": self.miss_oversize,
                "miss_exhausted": self.miss_exhausted,
                "wraps": self.wraps,
                "slab_allocs": self.slab_allocs,
                "fallback_bytes": self.fallback_bytes,
                "over_released": self.over_released,
                "hit_rate": (self.hits / self.acquired) if self.acquired
                            else 1.0,
            }


def release_buffer(data) -> None:
    """Release ``data``'s lease if it is one (no-op for plain buffers) —
    the one-liner every receive-path consumer threads through its
    completion path."""
    if isinstance(data, BufferLease):
        data.release()


def detach_tree(tree):
    """Deep-copy any pooled-view leaves of ``tree`` into plain owning
    arrays — the eager escape hatch for consumers that hold results
    long-term and should not pin recv slabs (the leaf pins release as soon
    as the views are garbage-collected)."""
    if isinstance(tree, dict):
        return {k: detach_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        t = [detach_tree(v) for v in tree]
        return tuple(t) if isinstance(tree, tuple) else t
    if isinstance(tree, PooledView):
        return np.array(tree, subok=False)
    return tree
