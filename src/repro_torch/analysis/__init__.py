"""avecheck — repo-specific correctness tooling for the AVEC data plane.

Two halves, one invariant set:

* **Static analyzer** (``python -m repro_torch.analysis src/``): AST rules that
  mechanically check the contracts the data plane established by convention —
  lease balance on every path, lock discipline on ``# guarded-by:``
  annotated fields, no blocking calls under a state lock, and wire-error
  table completeness.  See :mod:`repro_torch.analysis.rules`.
* **Runtime sanitizer** (``AVEC_SANITIZE=1``): a :class:`LeaseTracker`
  recording acquisition-site tracebacks and asserting zero live leases at
  teardown, a lock-order recorder that detects cycles across the
  runtime/coalescer/migration/cluster locks, and a protocol state-machine
  channel wrapper validating every frame.  See
  :mod:`repro_torch.analysis.sanitize` and :mod:`repro_torch.analysis.protocol`.

Only :mod:`repro_torch.analysis.sanitize` may be imported from ``repro_torch.core``
modules (it is stdlib-only); the analyzer and the protocol validator pull
in heavier dependencies and load lazily.
"""
from __future__ import annotations

import importlib

__all__ = [
    "LeaseTracker", "LeaseLeak", "LockOrderRecorder", "LockOrderCycle",
    "ValidatingChannel", "ProtocolViolation", "run_paths",
]

_LAZY = {
    "LeaseTracker": ("repro_torch.analysis.sanitize", "LeaseTracker"),
    "LeaseLeak": ("repro_torch.analysis.sanitize", "LeaseLeak"),
    "LockOrderRecorder": ("repro_torch.analysis.sanitize", "LockOrderRecorder"),
    "LockOrderCycle": ("repro_torch.analysis.sanitize", "LockOrderCycle"),
    "ValidatingChannel": ("repro_torch.analysis.protocol", "ValidatingChannel"),
    "ProtocolViolation": ("repro_torch.analysis.protocol", "ProtocolViolation"),
    "run_paths": ("repro_torch.analysis.checker", "run_paths"),
}


def __getattr__(name: str):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module 'repro_torch.analysis' has no attribute {name!r}")
    value = getattr(importlib.import_module(mod_name), attr)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
