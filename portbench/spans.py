"""What the readers of the program's own spans share (``issue_ms.*``,
``mixer_ms.decode``, ``ffn_ms.decode``, ``hops_ms.*``, ``wrapper_us.decode``).

The program keeps one trace record per library call in its host process's
sink (``repro_torch.obs.trace.get_sink()``), the newest last: hop spans
``(name, start_ns, dur_ns, parent, n)``, the destination's stages under
``issue`` and its kernel-wrapper counters ``(op, calls, ns)``.  The run's
calls are the session's last, so the sink's last ``len(ctx.calls)``
records are theirs, in order.  A reader returns None when the ring no
longer holds every call, when a record's ``fn`` is not its call's kind,
or when the records hold no such span (a program that keeps none, or with
tracing off).  Like ``compute_ms.*``, the means are over the untraced
calls (in a ``--trace 1`` run the first half's)."""
from __future__ import annotations

#: the measured hops of a call outside the model step and ``respond``:
#: the client's pack and send, both frame decodes (destination, then
#: client), the destination's admission wait and both device copies
HOPS = ("serialize", "send", "unpack", "queue", "h2d", "d2h")


def records(ctx, kind: str):
    """The untraced ``kind`` calls' records, or None (see the module)."""
    from repro_torch.obs import trace

    n = len(ctx.calls)
    recs = trace.get_sink().recent(n) if n else []
    if len(recs) < n or any(r.fn != c["kind"] for c, r in zip(ctx.calls, recs)):
        return None
    return [r for c, r in zip(ctx.calls, recs) if c["kind"] == kind and not c["traced"]]


def span_ms(ctx, kind: str, names) -> float | None:
    """Mean over the untraced ``kind`` calls of the summed durations of
    their spans named in ``names``, ms; None if a record has none of them."""
    recs = records(ctx, kind)
    if not recs:
        return None
    total = 0
    for r in recs:
        durs = [s[2] for s in r.spans if isinstance(s, tuple) and s[0] in names]
        if not durs:
            return None
        total += sum(durs)
    return total / len(recs) / 1e6


def wrapper_us(ctx, kind: str) -> float | None:
    """Host time of one call into a ``kernels.ops`` wrapper: the untraced
    ``kind`` calls' summed wrapper seconds over their summed wrapper
    calls, us."""
    recs = records(ctx, kind)
    if not recs:
        return None
    counts = [w for r in recs for w in getattr(r, "wrappers", ())]
    calls = sum(c for _, c, _ in counts)
    return sum(ns for _, _, ns in counts) / calls / 1e3 if calls else None
