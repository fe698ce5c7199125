"""Device trace of a window: taken in the destination process, reduced there.

``Tracer`` records the device's activity (kernels, copies, sets) with the
PyTorch profiler, CUDA activity only, over the traced window, and a marker
kernel (``torch.cuda._sleep``, named ``spin_kernel``) that the destination
launches at the start of every library call.  The markers cut the device
timeline into one cycle per call, from its start to the next call's start,
so a cycle holds the call's own work and the idle time that follows it
(the reply on the wire, the host's sampling, the next request).

:func:`reduce` turns the events into what the readers under ``metrics/``
need: per call its busy time (union of device intervals), its cycle, the
idle time inside the call (to the end of its last device-to-host copy, the
logits) and after it, and its device time by kernel name; over the window
the busy time, the top operations and the idle time by what the host was
doing.
"""
from __future__ import annotations

import time

import numpy as np

MARKER = "spin_kernel"
NAME_CHARS = 120          # of a kernel's name in the breakdown (templates run long)


class Tracer:
    """Start and stop the profiler from any thread of the destination; the
    calls record themselves through :meth:`on_call`."""

    def __init__(self) -> None:
        self.on = False
        self.calls: list = []
        self._prof = None
        self._t0 = 0.0

    def start(self) -> None:
        import torch
        from torch.autograd import profiler as ap

        torch.cuda.synchronize()
        self.calls = []
        self._prof = ap.profile(use_device="cuda", use_cpu=False, use_kineto=True)
        self._prof._prepare_trace()
        self._prof._start_trace()
        self._t0 = time.perf_counter()
        self.on = True

    def on_call(self, kind: str, tokens: int, pos: int) -> None:
        if self.on:
            import torch

            torch.cuda._sleep(1)
            self.calls.append({"kind": kind, "tokens": tokens, "pos": pos})

    def stop(self) -> dict:
        import torch
        from torch.autograd import DeviceType
        from torch.autograd import profiler as ap

        self.on = False
        torch.cuda.synchronize()
        window_s = time.perf_counter() - self._t0
        t1 = time.perf_counter()
        res = ap._disable_profiler()
        names, starts, ends = [], [], []
        for e in res.events():
            if e.device_type() == DeviceType.CUDA:
                names.append(e.name())
                starts.append(e.start_ns())
                ends.append(e.end_ns())
        out = reduce(names, np.asarray(starts, np.int64), np.asarray(ends, np.int64),
                     self.calls, window_s)
        out["reduce_s"] = time.perf_counter() - t1
        return out


def _busy_before(ms, me, cum, t):
    """Busy time of the merged intervals (ms, me) before each time in t."""
    idx = np.searchsorted(ms, t, side="right") - 1
    j = np.maximum(idx, 0)
    part = np.clip(t - ms[j], 0, me[j] - ms[j])
    return np.where(idx >= 0, cum[j] + part, 0)


def reduce(names: list, starts, ends, calls: list, window_s: float) -> dict:
    """Per-call and window figures from device events (name, start ns, end
    ns); ``calls`` are the window's library calls in order, one marker each."""
    names = np.asarray(names, dtype=object)
    is_marker = np.array([MARKER in n for n in names], dtype=bool)
    markers = np.sort(starts[is_marker])
    if len(markers) != len(calls):
        raise RuntimeError(f"trace: {len(markers)} call markers for {len(calls)} calls")
    names, starts, ends = names[~is_marker], starts[~is_marker], ends[~is_marker]
    o = np.argsort(starts, kind="stable")
    names, starts, ends = names[o], starts[o], ends[o]
    n = len(starts)
    if n == 0:
        return {"window_s": window_s, "busy_s": 0.0, "calls": [], "names": [],
                "top_ops": [], "idle_gaps": []}
    run = np.maximum.accumulate(ends)
    new = np.ones(n, dtype=bool)
    new[1:] = starts[1:] > run[:-1]
    first = np.nonzero(new)[0]
    ms = starts[first]
    me = run[np.r_[first[1:] - 1, n - 1]]
    cum = np.concatenate([[0], np.cumsum(me - ms)])
    busy_s = float(cum[-1]) * 1e-9

    ids: dict = {}
    nid = np.array([ids.setdefault(x, len(ids)) for x in names], dtype=np.int64)
    table = list(ids)
    bounds = np.r_[markers, max(int(run[-1]), int(markers[-1]) if len(markers) else 0)]
    k = len(calls)
    per_call = []
    if k:
        cyc = np.searchsorted(markers, starts, side="right") - 1
        inside = cyc >= 0
        b_busy = _busy_before(ms, me, cum, bounds)
        dtoh_end = bounds[:-1].copy()
        is_dtoh = np.array(["DtoH" in x for x in names], dtype=bool) & inside
        np.maximum.at(dtoh_end, cyc[is_dtoh], ends[is_dtoh])
        dtoh_end = np.minimum(dtoh_end, bounds[1:])
        d_busy = _busy_before(ms, me, cum, dtoh_end)
        kt = np.zeros((k, len(table)))
        np.add.at(kt, (cyc[inside], nid[inside]), (ends[inside] - starts[inside]) * 1e-9)
        for i, c in enumerate(calls):
            cycle = (bounds[i + 1] - bounds[i]) * 1e-9
            busy = (b_busy[i + 1] - b_busy[i]) * 1e-9
            in_idle = ((dtoh_end[i] - bounds[i]) - (d_busy[i] - b_busy[i])) * 1e-9
            nz = np.nonzero(kt[i])[0]
            per_call.append({**c, "cycle_s": float(cycle), "busy_s": float(busy),
                             "inside_idle_s": float(in_idle),
                             "after_idle_s": float(cycle - busy - in_idle),
                             "kernels": {int(j): float(kt[i, j]) for j in nz}})
    tot = np.bincount(nid, weights=(ends - starts) * 1e-9, minlength=len(table))
    top = [[table[j][:NAME_CHARS], float(tot[j])] for j in np.argsort(-tot)[:10]]
    gaps: dict = {}
    for c in per_call:
        for where, key in (("inside the call: host dispatch", "inside_idle_s"),
                           ("after the call: wire, host sampling, next request",
                            "after_idle_s")):
            name = f"{c['kind']}, {where}"
            gaps[name] = gaps.get(name, 0.0) + c[key]
    idle = sorted(([g, s] for g, s in gaps.items()), key=lambda x: -x[1])[:10]
    return {"window_s": float(window_s), "busy_s": busy_s, "calls": per_call,
            "names": table, "top_ops": top, "idle_gaps": idle}
