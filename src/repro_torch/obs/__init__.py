"""repro_torch.obs — the observability plane for the AVEC stack.

Three pillars, all stdlib-only (``repro_torch.core`` modules import this package
unconditionally, so it must never pull numpy or jax back in — same contract
as :mod:`repro_torch.analysis.sanitize`):

* :mod:`repro_torch.obs.config` — typed ``GlobalConfig`` knob registry.  Every
  tunable the stack grew (coalesce window, admission caps, slab sizing,
  window caps, heartbeat cadence) registers here with a type, default and
  doc string; ``AVEC_<NAME>`` env vars override explicit constructor
  arguments which override defaults.  Destinations advertise their
  effective knob values in the capability handshake.
* :mod:`repro_torch.obs.metrics` — counter/gauge/histogram registry with
  Prometheus text exposition, a stdlib ``/metrics`` HTTP listener, and
  view bindings that re-express the existing ``stats()`` /
  ``pool_stats()`` / ``tenant_stats`` dicts as scrape-time metric reads
  (nothing is pushed on the hot path).
* :mod:`repro_torch.obs.trace` — request-scoped trace ids generated at the
  facade, carried in frame ``meta``, stamped with per-hop spans, each
  with its start on ``perf_counter_ns`` (serialize → send → unpack →
  queue → coalesce → h2d → issue → sync → d2h → unpack → respond, the
  last the remainder: argument conversion, response pack, both wire
  flights and the hand-off to the caller), the model step's ``mixer``
  and ``ffn`` stages and kernel-wrapper counters inside ``issue``, kept
  in a 16,384-record sink and emitted as structured JSON log lines.
"""
from repro_torch.obs.config import (GlobalConfig, Knob, UnknownKnobError,
                              global_config)
from repro_torch.obs.metrics import (MetricsRegistry, MetricsServer,
                               global_metrics)
from repro_torch.obs.trace import TraceRecord, emit, get_sink, new_trace_id

__all__ = [
    "GlobalConfig", "Knob", "UnknownKnobError", "global_config",
    "MetricsRegistry", "MetricsServer", "global_metrics",
    "TraceRecord", "emit", "get_sink", "new_trace_id",
]
