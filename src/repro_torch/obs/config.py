"""Typed global knob registry for the AVEC stack.

Every tunable constructor default in ``repro_torch.core`` / ``repro.avec`` is
registered here as a :class:`Knob` with a name, type, default, and doc
string.  Resolution precedence, highest first:

1. environment — ``AVEC_<NAME>`` (name upper-cased), read at resolve time
   so an operator can retune a deployment without touching call sites;
2. explicit constructor argument — call sites pass their (possibly
   ``None``-sentinel) argument through :meth:`GlobalConfig.resolve`;
3. programmatic override installed with :meth:`GlobalConfig.set`;
4. the registered default.

The registry is stdlib-only and import-light on purpose: ``repro_torch.core``
modules resolve their defaults through it at construction time, so it
must never pull the client stack, numpy, or jax back in.

Destinations advertise :meth:`GlobalConfig.effective` in the capability
handshake (PR 3), so a client's ``Capabilities`` shows the remote end's
actual tuning, not the client's local defaults.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Optional

from repro_torch.analysis import sanitize as _sanitize


class UnknownKnobError(KeyError):
    """Raised when a knob name was never registered — catches typos at
    the call site instead of silently minting a new config entry."""


_TRUE = frozenset(("1", "true", "yes", "on"))
_FALSE = frozenset(("0", "false", "no", "off", ""))


def _parse_bool(raw: str) -> bool:
    low = raw.strip().lower()
    if low in _TRUE:
        return True
    if low in _FALSE:
        return False
    raise ValueError(f"not a boolean: {raw!r}")


@dataclass(frozen=True)
class Knob:
    """One registered tunable: its type is enforced on every override."""

    name: str
    type: type
    default: Any
    doc: str

    @property
    def env(self) -> str:
        """Environment variable that overrides this knob."""
        return "AVEC_" + self.name.upper()

    def parse(self, raw: str) -> Any:
        """Parse a string override (env var) into the knob's type."""
        try:
            if self.type is bool:
                return _parse_bool(raw)
            return self.type(raw)
        except ValueError as e:
            raise ValueError(
                f"bad value for knob {self.name!r} "
                f"(env {self.env}): {e}") from None

    def coerce(self, value: Any) -> Any:
        """Type-check / convert a programmatic override."""
        if self.type is bool:
            if isinstance(value, bool):
                return value
            raise TypeError(
                f"knob {self.name!r} expects bool, got {type(value).__name__}")
        if self.type is float and isinstance(value, (int, float)) \
                and not isinstance(value, bool):
            return float(value)
        if self.type is int and isinstance(value, int) \
                and not isinstance(value, bool):
            return value
        if isinstance(value, self.type):
            return value
        raise TypeError(
            f"knob {self.name!r} expects {self.type.__name__}, "
            f"got {type(value).__name__}")


class GlobalConfig:
    """Registry of typed knobs with env > explicit > default resolution.

    Thread-safe: registration and programmatic overrides go through a
    tracked lock; env lookups read ``os.environ`` at resolve time so
    tests can monkeypatch overrides per-case.
    """

    def __init__(self) -> None:
        self._lock = _sanitize.make_lock("GlobalConfig._lock")
        self._knobs: dict[str, Knob] = {}       # guarded-by: _lock
        self._overrides: dict[str, Any] = {}    # guarded-by: _lock

    # -- registration -----------------------------------------------------
    def register(self, name: str, type: type, default: Any,
                 doc: str) -> Knob:
        if not doc or not doc.strip():
            raise ValueError(f"knob {name!r} must carry a doc string")
        knob = Knob(name=name, type=type, default=default, doc=doc.strip())
        with self._lock:
            if name in self._knobs:
                raise ValueError(f"knob {name!r} already registered")
            self._knobs[name] = knob
        return knob

    def knob(self, name: str) -> Knob:
        with self._lock:
            try:
                return self._knobs[name]
            except KeyError:
                raise UnknownKnobError(name) from None

    def knobs(self) -> list[Knob]:
        with self._lock:
            return [self._knobs[k] for k in sorted(self._knobs)]

    # -- overrides --------------------------------------------------------
    def set(self, name: str, value: Any) -> None:
        """Install a programmatic override (above the default, below env
        and explicit constructor arguments)."""
        knob = self.knob(name)
        coerced = knob.coerce(value)
        with self._lock:
            self._overrides[name] = coerced

    def unset(self, name: str) -> None:
        self.knob(name)
        with self._lock:
            self._overrides.pop(name, None)

    # -- resolution -------------------------------------------------------
    def resolve(self, name: str, explicit: Optional[Any] = None) -> Any:
        """Effective value of ``name`` given an explicit constructor
        argument (``None`` means "not passed").  Precedence:
        env > explicit > :meth:`set` override > default."""
        knob = self.knob(name)
        raw = os.environ.get(knob.env)
        if raw is not None:
            return knob.parse(raw)
        if explicit is not None:
            return knob.coerce(explicit)
        with self._lock:
            if name in self._overrides:
                return self._overrides[name]
        return knob.default

    def get(self, name: str) -> Any:
        return self.resolve(name)

    def source(self, name: str) -> str:
        """Where the effective value comes from: env/override/default."""
        knob = self.knob(name)
        if os.environ.get(knob.env) is not None:
            return "env"
        with self._lock:
            if name in self._overrides:
                return "override"
        return "default"

    def effective(self) -> dict:
        """Snapshot of every knob's effective value — what a destination
        advertises in the capability handshake."""
        return {k.name: self.resolve(k.name) for k in self.knobs()}

    # -- docs -------------------------------------------------------------
    def describe(self) -> list[dict]:
        """Rows for the generated knob-reference table."""
        return [{"name": k.name, "env": k.env, "type": k.type.__name__,
                 "default": k.default, "doc": k.doc}
                for k in self.knobs()]

    def markdown_table(self) -> str:
        rows = ["| knob | env var | type | default | doc |",
                "| --- | --- | --- | --- | --- |"]
        for r in self.describe():
            rows.append("| `%s` | `%s` | %s | `%r` | %s |"
                        % (r["name"], r["env"], r["type"],
                           r["default"], r["doc"]))
        return "\n".join(rows)


# ----------------------------------------------------------------------
# The process-global registry, pre-seeded with every stack knob.
# ----------------------------------------------------------------------

_CONFIG = GlobalConfig()


def global_config() -> GlobalConfig:
    """The process-wide knob registry (module singleton)."""
    return _CONFIG


def _register_defaults(cfg: GlobalConfig) -> None:
    reg: Callable[..., Knob] = cfg.register
    # -- memory / transport ----------------------------------------------
    reg("pool_slab_bytes", int, 4 << 20,
        "BufferPool slab size in bytes; frames larger than one slab fall "
        "back to heap allocation.")
    reg("pool_slabs", int, 8,
        "Maximum slabs a BufferPool grows to before acquisitions miss.")
    reg("server_join_timeout_s", float, 2.0,
        "TCPServer per-thread join timeout at stop(), seconds.")
    # -- executor / coalescer --------------------------------------------
    reg("coalesce_window_s", float, 0.002,
        "Coalescer batching window: how long the destination waits for "
        "same-key requests to stack into one dispatch, seconds.")
    reg("max_coalesce", int, 8,
        "Maximum requests stacked into one coalesced dispatch (the DRR "
        "drain quantum scales from this).")
    reg("tenant_max_inflight", int, 0,
        "Per-tenant admission cap on in-flight requests at a destination "
        "(0 = unlimited).")
    reg("tenant_max_bytes", float, 0.0,
        "Per-tenant admission cap on in-flight request payload bytes "
        "(0 = unlimited).")
    reg("replay_cache", int, 32,
        "Destination replay-dedup LRU size (per-client acked results "
        "kept for at-least-once retry suppression; 0 disables).")
    # -- runtimes ---------------------------------------------------------
    reg("rpc_timeout_s", float, 120.0,
        "Client-side timeout for one offloaded call round trip, seconds.")
    reg("throttle_retries", int, 4,
        "Client retries (jittered backoff) when the destination answers "
        "TenantThrottled before the error is surfaced.")
    reg("max_in_flight", int, 4,
        "PipelinedHostRuntime in-flight request window cap when "
        "constructed directly (the facade uses connect_max_in_flight).")
    reg("adaptive_window", bool, True,
        "Shrink/grow the pipelined in-flight window from the observed "
        "wire/compute ratio instead of pinning it at the cap.")
    # -- facade -----------------------------------------------------------
    reg("connect_max_in_flight", int, 8,
        "In-flight window cap for runtimes built by repro.avec.connect "
        "(ConnectPolicy.max_in_flight).")
    reg("shadow_every", int, 1,
        "Snapshot session state to the warm standby every N calls "
        "(ConnectPolicy.shadow_every).")
    # -- intra-op sharding -------------------------------------------------
    reg("shard_min_rows", int, 256,
        "Minimum batch rows per shard for intra-call sharding; a run "
        "whose leading axis is under twice this passes through unsharded "
        "(no degenerate slivers — per-sub-call wire overhead is fixed).")
    reg("shard_max_shards", int, 4,
        "Maximum destinations one run is row-split across "
        "(0 or 1 disables intra-call sharding).")
    reg("shard_calls", bool, False,
        "Default for ClientSession.call(shard=None): opt stateless "
        "facade calls into intra-call sharding without per-call flags "
        "(stateful decode streams must stay unsharded).")
    # -- transports / codecs ----------------------------------------------
    reg("shm_ring_bytes", int, 16 << 20,
        "Per-direction shared-memory ring size for SharedMemoryChannel, "
        "bytes.  Each side's send pool carves its TX half of the mmap "
        "into slabs; frames that do not fit spill over the doorbell "
        "socket (counted, never an error).")
    reg("comm_quant_codec", str, "off",
        "Auto-engaged wire quantization for link-bound pipelined "
        "sessions: 'int8' (per-row scales), 'fp16', or 'off'.  Engages "
        "only once the adaptive window's wire EMA exceeds its compute "
        "EMA and the peer advertised the codec in the handshake.")
    reg("comm_quant_min_bytes", int, 4096,
        "Smallest float leaf (bytes) a negotiated codec *list* will "
        "quantize; smaller leaves fall through to compression/raw.  An "
        "explicit single-codec request (codec='int8') ignores this "
        "floor.")
    # -- cluster ----------------------------------------------------------
    reg("heartbeat_interval_s", float, 0.05,
        "HeartbeatMonitor ping cadence, seconds (jittered).")
    reg("heartbeat_misses", int, 3,
        "Consecutive missed heartbeats (K) before a destination is "
        "declared failed.")
    reg("heartbeat_timeout_s", float, 0.5,
        "Per-ping reply timeout inside the heartbeat loop, seconds.")
    # -- observability ----------------------------------------------------
    reg("metrics_port", int, 0,
        "Port for the /metrics HTTP listener in launch.serve "
        "(0 = disabled).")
    reg("trace_enabled", bool, True,
        "Generate request-scoped trace ids at the facade and stamp "
        "per-hop spans into each call's trace record.")
    reg("trace_log", bool, False,
        "Emit one structured JSON log line per completed trace "
        "(the in-memory trace sink records regardless).")


_register_defaults(_CONFIG)
