"""Share of the window's untraced decode calls (in a ``--trace 1`` run the
first half's) whose trace record holds a ``replay`` stage inside ``issue``
(``obs.trace``): the decodes the destination ran as one CUDA graph, %.
None where the program books no such stage (``obs.trace.STAGES``), or where
the sink's records do not line up with the window's calls (``spans.py``)."""
from portbench import spans


def read(ctx):
    from repro_torch.obs import trace

    if "replay" not in getattr(trace, "STAGES", ()):
        return None
    recs = spans.records(ctx, "decode")
    if not recs:
        return None
    replayed = sum(any(isinstance(s, tuple) and s[0] == "replay" for s in r.spans)
                   for r in recs)
    return 100.0 * replayed / len(recs)
