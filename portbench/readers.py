"""What the metric readers under ``metrics/`` share.  A reader gets the
run's context: ``calls`` (the window's library calls from the host: kind,
tokens, pos, round trip ``rt_s``, ``t_done_s`` from the window's start, the
destination's ``compute_s`` and the rest ``comm_s`` from the session's
``AvecProfiler`` cycles, and ``traced``: whether the device trace was on),
``window_s``, ``setup_s``, ``config`` and its ``reference``, and with
``--trace 1`` the reduced device ``trace`` (``devtrace.reduce``) of the
window's second half.  The host-clock spans are read from the calls the
profiler did not slow (the first half's, in a traced run).  A reader that
finds nothing to read returns None."""
from __future__ import annotations

import re

import numpy as np

from portbench import peaks
from portbench.harness import load_module


def p95_ms(ctx, kind: str):
    rts = [c["rt_s"] for c in ctx.calls if c["kind"] == kind]
    return float(np.percentile(rts, 95)) * 1e3 if rts else None


def untraced(ctx, kind: str) -> list:
    return [c for c in ctx.calls if c["kind"] == kind and not c["traced"]]


def mean_ms(ctx, kind: str, key: str):
    xs = [c[key] for c in untraced(ctx, kind)]
    return float(np.mean(xs)) * 1e3 if xs else None


def mfu(ctx, kind: str):
    """The calls' operations over their destination time at the bf16 peak, %."""
    calls = untraced(ctx, kind)
    if not calls:
        return None
    flops = sum(ctx.reference.call_flops(ctx.config, kind, c["tokens"], c["pos"]) for c in calls)
    return 100.0 * flops / (sum(c["compute_s"] for c in calls) * peaks.BF16_FLOPS)


def device_idle(ctx, kind: str):
    """1 - busy / cycle over the traced calls of ``kind``, %."""
    if ctx.trace is None:
        return None
    calls = [c for c in ctx.trace["calls"] if c["kind"] == kind]
    cycle = sum(c["cycle_s"] for c in calls)
    if not calls or cycle <= 0:
        return None
    return 100.0 * (1.0 - sum(c["busy_s"] for c in calls) / cycle)


def roofline(ctx, op: str):
    """Sum of the least times of ``op``'s launches in the traced window over
    the device time of the kernels its ``NAMES`` match in the same calls, %.
    The launches of a call come from the reference's ``kernel_calls``."""
    if ctx.trace is None:
        return None
    k = load_module(f"kernels/{op}.py")
    names = ctx.trace["names"]
    match = {str(j) for j, n in enumerate(names) if re.search(k.NAMES, n)}
    bound = spent = 0.0
    for c in ctx.trace["calls"]:
        for name, shape, launches in ctx.reference.kernel_calls(ctx.config, c["kind"],
                                                                c["tokens"], c["pos"]):
            if name == op:
                bound += launches * peaks.bound_s(k.flops(**shape), k.nbytes(**shape))
                spent += sum(t for j, t in c["kernels"].items() if str(j) in match)
                break
    return 100.0 * bound / spent if spent > 0 else None
