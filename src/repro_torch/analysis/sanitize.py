"""Runtime sanitizer for the AVEC data plane (``AVEC_SANITIZE=1``).

Stdlib-only on purpose: ``repro_torch.core`` modules import this unconditionally
(to construct their locks through :func:`make_lock` and friends), so it
must never pull the client stack, numpy, or jax back in.

Three instruments:

* :class:`LeaseTracker` — every :class:`~repro_torch.core.memory.BufferLease`
  acquisition records its acquisition-site traceback; the final release
  removes it.  :meth:`LeaseTracker.assert_quiescent` fails with the stacks
  of every still-live lease, turning "the pool is unbalanced at teardown"
  from a counter mismatch into a named allocation site.
* :class:`LockOrderRecorder` — the tracked locks report acquisition order
  per thread; an edge A→B is recorded whenever B is taken while A is held.
  A cycle in that graph is a potential deadlock even if the schedule never
  hit it — exactly the class of bug PR 2 found the hard way.
* Tracked lock factories (:func:`make_lock`, :func:`make_rlock`,
  :func:`make_condition`) — zero-overhead passthrough to ``threading``
  primitives unless the sanitizer is enabled at construction time.

Enablement is read from the environment at *construction* time, so the
flag must be exported before the runtimes/pools under test are built
(CI exports it for the whole pytest leg).
"""
from __future__ import annotations

import gc
import os
import threading
import time
import traceback
from typing import Optional


def enabled() -> bool:
    """True when the runtime sanitizer is switched on via ``AVEC_SANITIZE``."""
    return os.environ.get("AVEC_SANITIZE", "") not in ("", "0")


# ----------------------------------------------------------------------
# Lease tracking
# ----------------------------------------------------------------------

class LeaseLeak(AssertionError):
    """Raised by :meth:`LeaseTracker.assert_quiescent` when leases are
    still live at a point the pool contract says none may be."""


class LeaseTracker:
    """Records one entry per live lease, keyed by object identity, with
    the stack that acquired it.  Identity keys are safe because the entry
    is removed at final release — before the lease can be garbage
    collected and its id reused."""

    def __init__(self, capture_depth: int = 16) -> None:
        self.capture_depth = capture_depth
        self._lock = threading.Lock()   # internal; never a tracked lock
        self._live: dict[int, dict] = {}
        self.acquired = 0
        self.released = 0

    # -- hooks called from repro_torch.core.memory -----------------------------
    def on_acquire(self, lease: object, pool: str, nbytes: int) -> None:
        stack = traceback.extract_stack(limit=self.capture_depth + 1)[:-1]
        with self._lock:
            self.acquired += 1
            self._live[id(lease)] = {
                "pool": pool, "nbytes": nbytes,
                "stack": traceback.format_list(stack),
            }

    def on_release(self, lease: object) -> None:
        with self._lock:
            if self._live.pop(id(lease), None) is not None:
                self.released += 1

    # -- assertions -------------------------------------------------------
    def live_count(self) -> int:
        with self._lock:
            return len(self._live)

    def live_records(self) -> list[dict]:
        with self._lock:
            return [dict(r) for r in self._live.values()]

    def assert_quiescent(self, grace_s: float = 0.0,
                         baseline: int = 0) -> None:
        """Assert no more than ``baseline`` live leases (0 = none), first
        giving pinned-result finalizers ``grace_s`` seconds of gc+poll:
        zero-copy results release their lease ref from a
        ``weakref.finalize`` that only runs once the last aliasing array is
        collected.  ``baseline`` lets a per-test fixture tolerate leases
        that were already live when the test began."""
        deadline = time.monotonic() + grace_s
        while self.live_count() > baseline:
            gc.collect()
            if self.live_count() <= baseline \
                    or time.monotonic() >= deadline:
                break
            time.sleep(0.02)
        records = self.live_records()
        if len(records) > baseline:
            sites = "\n".join(
                "--- live lease: %d B from pool %r acquired at ---\n%s"
                % (r["nbytes"], r["pool"], "".join(r["stack"]))
                for r in records)
            raise LeaseLeak(
                f"{len(records)} lease(s) still live at quiescence point "
                f"({self.acquired} acquired / {self.released} released):\n"
                f"{sites}")


# ----------------------------------------------------------------------
# Lock-order recording
# ----------------------------------------------------------------------

class LockOrderCycle(AssertionError):
    """Raised by :meth:`LockOrderRecorder.assert_no_cycles` when the
    observed acquisition-order graph contains a cycle."""


class LockOrderRecorder:
    """Directed acquisition-order graph over *named* locks.

    ``on_acquire(B)`` with A held by the same thread records the edge
    A→B (with one sample stack per edge).  Self-edges are skipped —
    reentrant acquisition of an RLock is not an ordering fact.  Cycle
    detection is a plain DFS over the accumulated edges; it reports
    *potential* deadlocks, i.e. orderings that could interleave badly,
    not only ones the schedule actually interleaved."""

    def __init__(self, capture_depth: int = 8) -> None:
        self.capture_depth = capture_depth
        self._lock = threading.Lock()   # internal; never a tracked lock
        self._tls = threading.local()
        self._edges: dict[tuple[str, str], str] = {}

    def _held(self) -> list[str]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def on_acquire(self, name: str) -> None:
        held = self._held()
        new = [h for h in held if h != name]
        if new:
            stack = "".join(traceback.format_list(
                traceback.extract_stack(limit=self.capture_depth + 1)[:-1]))
            with self._lock:
                for h in dict.fromkeys(new):    # dedup, keep order
                    self._edges.setdefault((h, name), stack)
        held.append(name)

    def on_release(self, name: str) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                break

    # -- queries ----------------------------------------------------------
    def edges(self) -> list[tuple[str, str]]:
        with self._lock:
            return sorted(self._edges)

    def cycles(self) -> list[list[str]]:
        with self._lock:
            adj: dict[str, list[str]] = {}
            for a, b in self._edges:
                adj.setdefault(a, []).append(b)
        found: list[list[str]] = []
        state: dict[str, int] = {}      # 1 = on stack, 2 = done

        def dfs(node: str, path: list[str]) -> None:
            state[node] = 1
            path.append(node)
            for nxt in adj.get(node, ()):
                if state.get(nxt) == 1:
                    found.append(path[path.index(nxt):] + [nxt])
                elif nxt not in state:
                    dfs(nxt, path)
            path.pop()
            state[node] = 2

        for node in sorted(adj):
            if node not in state:
                dfs(node, [])
        return found

    def assert_no_cycles(self) -> None:
        cycles = self.cycles()
        if cycles:
            with self._lock:
                samples = {
                    c[0]: self._edges.get((c[0], c[1]), "")
                    for c in cycles if len(c) > 1}
            detail = "\n".join(
                " -> ".join(c)
                + ("\nfirst-edge sample stack:\n" + samples.get(c[0], "")
                   if samples.get(c[0]) else "")
                for c in cycles)
            raise LockOrderCycle(
                f"lock acquisition-order cycle(s) detected "
                f"(potential deadlock):\n{detail}")


# ----------------------------------------------------------------------
# Tracked lock factories
# ----------------------------------------------------------------------

class _TrackedLockBase:
    """Context-manager proxy reporting acquisition order to a recorder.
    Delegates everything else to the wrapped primitive."""

    def __init__(self, inner, name: str, recorder: LockOrderRecorder) -> None:
        self._inner = inner
        self.name = name
        self._recorder = recorder

    def acquire(self, *args, **kwargs):
        got = self._inner.acquire(*args, **kwargs)
        if got:
            self._recorder.on_acquire(self.name)
        return got

    def release(self) -> None:
        self._inner.release()
        self._recorder.on_release(self.name)

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self._inner.__enter__()
        self._recorder.on_acquire(self.name)
        return self

    def __exit__(self, *exc):
        self._recorder.on_release(self.name)
        return self._inner.__exit__(*exc)


class TrackedLock(_TrackedLockBase):
    pass


class TrackedCondition(_TrackedLockBase):
    """Condition proxy: ``wait``/``wait_for`` release and reacquire the
    underlying lock, but only ever from the thread that already holds it,
    so no held-stack adjustment is needed for ordering purposes."""

    def wait(self, timeout: Optional[float] = None):
        return self._inner.wait(timeout)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        return self._inner.wait_for(predicate, timeout)

    def notify(self, n: int = 1) -> None:
        self._inner.notify(n)

    def notify_all(self) -> None:
        self._inner.notify_all()


_GLOBAL_LOCK = threading.Lock()
_LEASE_TRACKER: Optional[LeaseTracker] = None
_LOCK_RECORDER: Optional[LockOrderRecorder] = None


def global_lease_tracker() -> LeaseTracker:
    global _LEASE_TRACKER
    with _GLOBAL_LOCK:
        if _LEASE_TRACKER is None:
            _LEASE_TRACKER = LeaseTracker()
        return _LEASE_TRACKER


def global_lock_recorder() -> LockOrderRecorder:
    global _LOCK_RECORDER
    with _GLOBAL_LOCK:
        if _LOCK_RECORDER is None:
            _LOCK_RECORDER = LockOrderRecorder()
        return _LOCK_RECORDER


def make_lock(name: str):
    """A ``threading.Lock`` — tracked when the sanitizer is enabled."""
    if enabled():
        return TrackedLock(threading.Lock(), name, global_lock_recorder())
    return threading.Lock()


def make_rlock(name: str):
    if enabled():
        return TrackedLock(threading.RLock(), name, global_lock_recorder())
    return threading.RLock()


def make_condition(name: str):
    if enabled():
        return TrackedCondition(threading.Condition(), name,
                                global_lock_recorder())
    return threading.Condition()
