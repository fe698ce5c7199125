"""AVEC profiler: per-cycle GPU / communication / other breakdown.

Mirrors the paper's nvprof-based accounting (Figs. 8-9): every offloaded
execution cycle is decomposed into destination compute time ("GPU"), wire +
(de)serialization time ("Communication"), and host-side application time
("Other"); FPS is derived per the paper's Table V."""
from __future__ import annotations

import threading
from dataclasses import dataclass, field


@dataclass
class CycleRecord:
    gpu_s: float
    comm_s: float
    bytes_sent: int
    bytes_received: int
    fn: str = ""


@dataclass
class AvecProfiler:
    cycles: list = field(default_factory=list)
    other_s: float = 0.0
    model_transfer_s: float = 0.0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def record_cycle(self, gpu_s: float, comm_s: float, bytes_sent: int,
                     bytes_received: int, fn: str = "") -> None:
        with self._lock:
            self.cycles.append(CycleRecord(gpu_s, comm_s, bytes_sent,
                                           bytes_received, fn))

    def record_other(self, seconds: float) -> None:
        with self._lock:
            self.other_s += seconds

    def record_model_transfer(self, seconds: float) -> None:
        with self._lock:
            self.model_transfer_s += seconds

    # ------------------------------------------------------------------
    @property
    def gpu_s(self) -> float:
        return sum(c.gpu_s for c in self.cycles)

    @property
    def comm_s(self) -> float:
        return sum(c.comm_s for c in self.cycles)

    @property
    def total_s(self) -> float:
        return self.gpu_s + self.comm_s + self.other_s

    @property
    def bytes_sent(self) -> int:
        return sum(c.bytes_sent for c in self.cycles)

    @property
    def bytes_received(self) -> int:
        return sum(c.bytes_received for c in self.cycles)

    def breakdown(self) -> dict:
        """Paper Figs. 8-9 categories, absolute seconds and fractions."""
        total = max(self.total_s, 1e-12)
        return {
            "gpu_s": self.gpu_s, "communication_s": self.comm_s,
            "other_s": self.other_s,
            "gpu_frac": self.gpu_s / total,
            "communication_frac": self.comm_s / total,
            "other_frac": self.other_s / total,
            "cycles": len(self.cycles),
            "bytes_sent": self.bytes_sent,
            "bytes_received": self.bytes_received,
            "model_transfer_s": self.model_transfer_s,
        }

    def fps(self, frames: int | None = None) -> float:
        n = frames if frames is not None else len(self.cycles)
        return n / max(self.total_s, 1e-12)

    def per_cycle(self) -> dict:
        n = max(len(self.cycles), 1)
        return {"gpu_s": self.gpu_s / n, "communication_s": self.comm_s / n,
                "other_s": self.other_s / n,
                "bytes_per_cycle": (self.bytes_sent + self.bytes_received) / n}
