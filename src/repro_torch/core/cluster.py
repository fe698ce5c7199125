"""Proactive failure domain: cluster membership, consistent-hash placement,
and warm shadow replica groups (paper future-work ii, taken past reactive
failover).

Reactive failover (core/migration.py) rebuilds a session on a fresh node
from the host-side shadow AFTER the primary dies — correct, but the recovery
path pays model ensure + state restore while the application stalls.  This
module ships the state *ahead of failure*:

* ``ConsistentHashRing`` — virtual-node hash ring over the routable pool.
  Placement of a tenant/session fingerprint moves only when its own arc's
  owner changes: membership churn re-homes the affected arc, not the world.
* ``ClusterMembership`` — reconciles the ring against the registry's
  routable set and tracks which placements moved on each sync, upgrading
  ``AcceleratorRegistry`` from a static pool into an elastic membership
  layer.
* ``ReplicaGroup`` — a session homed on a primary with a warm standby: the
  standby is picked by the scheduler, the model is made resident there in
  advance, and every host shadow snapshot is piggybacked onto the standby
  over the same pooled send path.  Promotion on primary death (or drain) is
  then warm — the standby already holds the model and a recent state, so
  re-home does not rebuild from host.
"""
from __future__ import annotations

import bisect
import hashlib
from typing import Callable, Iterable, Optional

from repro_torch.analysis import sanitize as _sanitize


def _hash64(key: str) -> int:
    """Stable 64-bit point on the ring (blake2b — fast, keyed-less, and not
    Python's randomized ``hash`` which would reshuffle placement per run)."""
    return int.from_bytes(
        hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest(), "big")


class ConsistentHashRing:
    """Consistent hashing with virtual nodes.

    Each member owns ``vnodes`` points on a 64-bit ring; a key is placed on
    the first point clockwise from its own hash.  Adding or removing one
    member moves only the keys in the arcs that member's points cover
    (~1/N of the keyspace), which is the whole reason to prefer this over
    ``hash(key) % N`` for session placement."""

    def __init__(self, members: Iterable[str] = (), vnodes: int = 64) -> None:
        self.vnodes = max(1, int(vnodes))
        self._ring: list[tuple[int, str]] = []   # sorted (point, member)
        self._members: set[str] = set()
        for m in members:
            self.add(m)

    def add(self, member: str) -> None:
        if member in self._members:
            return
        self._members.add(member)
        for i in range(self.vnodes):
            bisect.insort(self._ring, (_hash64(f"{member}#{i}"), member))

    def remove(self, member: str) -> None:
        if member not in self._members:
            return
        self._members.discard(member)
        self._ring = [(h, m) for h, m in self._ring if m != member]

    def members(self) -> set[str]:
        return set(self._members)

    def __len__(self) -> int:
        return len(self._members)

    def primary(self, key: str) -> Optional[str]:
        """The member owning ``key``'s arc (None on an empty ring)."""
        if not self._ring:
            return None
        i = bisect.bisect_left(self._ring, (_hash64(key), ""))
        if i == len(self._ring):
            i = 0
        return self._ring[i][1]

    def preference(self, key: str, n: Optional[int] = None,
                   exclude: tuple[str, ...] = ()) -> list[str]:
        """The first ``n`` DISTINCT members walking clockwise from ``key``
        — the natural primary + standby + ... ordering."""
        if not self._ring:
            return []
        want = len(self._members) if n is None else n
        out: list[str] = []
        i = bisect.bisect_left(self._ring, (_hash64(key), ""))
        for step in range(len(self._ring)):
            _, m = self._ring[(i + step) % len(self._ring)]
            if m not in out and m not in exclude:
                out.append(m)
                if len(out) >= want:
                    break
        return out


class ClusterMembership:
    """The registry's routable set, projected onto a consistent-hash ring,
    with placement bookkeeping.

    ``sync()`` reconciles the ring with the registry (members appear when
    routable, disappear when dead/draining/quarantined) and reports exactly
    which recorded placements moved — the acceptance property is that a
    one-node membership change moves only that node's arc."""

    def __init__(self, registry, *, vnodes: int = 64) -> None:
        self.registry = registry
        self._lock = _sanitize.make_lock("ClusterMembership._lock")
        self._ring = ConsistentHashRing(vnodes=vnodes)  # guarded-by: _lock
        self._placements: dict[str, str] = {}    # guarded-by: _lock (key -> current home)
        self.syncs = 0                           # guarded-by: _lock
        self.moves = 0                           # guarded-by: _lock

    def sync(self) -> dict:
        """Reconcile ring membership with ``registry.routable()``.  Returns
        ``{"added", "removed", "moved": {key: (old_home, new_home)}}`` —
        ``moved`` lists only the recorded placements whose arc owner
        actually changed."""
        with self._lock:
            routable = {va.name for va in self.registry.routable()}
            added = sorted(routable - self._ring.members())
            removed = sorted(self._ring.members() - routable)
            for m in added:
                self._ring.add(m)
            for m in removed:
                self._ring.remove(m)
            moved: dict[str, tuple[str, Optional[str]]] = {}
            if added or removed:
                for key, old in list(self._placements.items()):
                    new = self._ring.primary(key)
                    if new != old:
                        moved[key] = (old, new)
                        if new is None:
                            self._placements.pop(key)
                        else:
                            self._placements[key] = new
                self.moves += len(moved)
            self.syncs += 1
            return {"added": added, "removed": removed, "moved": moved}

    def place(self, key: str) -> Optional[str]:
        """Home ``key`` on the ring (sync first so the ring reflects current
        membership) and record the placement for move tracking."""
        self.sync()
        with self._lock:
            home = self._ring.primary(key)
            if home is not None:
                self._placements[key] = home
            return home

    def preference(self, key: str, n: Optional[int] = None,
                   exclude: tuple[str, ...] = ()) -> list[str]:
        with self._lock:
            return self._ring.preference(key, n, exclude)

    def placement(self, key: str) -> Optional[str]:
        with self._lock:
            return self._placements.get(key)

    def forget(self, key: str) -> None:
        with self._lock:
            self._placements.pop(key, None)

    def stats(self) -> dict:
        with self._lock:
            return {"members": sorted(self._ring.members()),
                    "placements": len(self._placements),
                    "syncs": self.syncs, "moves": self.moves}


class ReplicaGroup:
    """A session's failure domain: primary + warm standby.

    The standby is picked lazily (scheduler's choice, excluding the
    primary), the model is made resident there via ``prepare`` (the
    send-once weight cache makes this a fingerprint check when the standby
    already served this model), and every successful host shadow snapshot
    is replicated to the standby with ``runtime_for(standby).restore`` —
    the same pooled wire path normal traffic uses, so replication rides
    existing backpressure accounting.  ``promote()`` turns the standby into
    the new primary without touching the host shadow: warm re-home.

    Replication is best-effort by design: a standby that stops answering is
    dropped and re-picked on the next snapshot; the host shadow remains the
    ground-truth fallback, so a broken standby degrades to PR-era reactive
    failover, never to data loss."""

    def __init__(self, key: str, primary: str, *,
                 pick_standby: Callable[[str], Optional[str]],
                 runtime_for: Callable[[str], object],
                 prepare: Optional[Callable[[str], None]] = None) -> None:
        self.key = key
        self.primary = primary
        self.pick_standby = pick_standby
        self.runtime_for = runtime_for
        self.prepare = prepare
        self.standby: Optional[str] = None
        self.standby_step = -1        # last step replicated to the standby
        self.replicated = 0
        self.replication_failures = 0
        self.promotions = 0

    def ensure_standby(self) -> Optional[str]:
        """Pick + warm a standby if none is held.  Returns the standby name
        (None when the pool has no second servable destination — singleton
        pools simply run without a warm replica)."""
        if self.standby is not None:
            return self.standby
        name = self.pick_standby(self.primary)
        if name is None:
            return None
        if self.prepare is not None:
            try:
                self.prepare(name)
            except Exception:  # noqa: BLE001 — standby warming is best-effort
                self.replication_failures += 1
                return None
        self.standby = name
        self.standby_step = -1
        return name

    def replicate(self, fp: str, state, step: int) -> bool:
        """Ship a snapshot to the (lazily ensured) warm standby."""
        if self.ensure_standby() is None:
            return False
        try:
            self.runtime_for(self.standby).restore(fp, state)
        except Exception:  # noqa: BLE001 — drop the standby, re-pick next time
            self.replication_failures += 1
            self.standby = None
            self.standby_step = -1
            return False
        self.standby_step = step
        self.replicated += 1
        return True

    def promote(self) -> Optional[tuple[str, int]]:
        """Primary died (or is draining): the standby becomes the primary.
        Returns ``(new_primary, last_replicated_step)`` or None when no
        warm standby is held."""
        if self.standby is None:
            return None
        promoted, step = self.standby, self.standby_step
        self.primary = promoted
        self.standby = None
        self.standby_step = -1
        self.promotions += 1
        return promoted, step

    def stats(self) -> dict:
        return {"key": self.key, "primary": self.primary,
                "standby": self.standby, "standby_step": self.standby_step,
                "replicated": self.replicated,
                "replication_failures": self.replication_failures,
                "promotions": self.promotions}
