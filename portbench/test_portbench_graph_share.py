"""``graph_share.decode`` (``metrics/graph_share.decode.py``) on made-up
sinks: the share of the untraced decodes whose record holds a ``replay``
stage, and None where the records do not line up with the window's calls
or the program books no such stage."""
from types import SimpleNamespace

import pytest

from portbench import harness
from repro_torch.obs import trace


def _record(kind, replayed):
    r = trace.TraceRecord(fn=kind)
    for name in ["unpack", "queue", "h2d", "issue", "sync", "d2h"]:
        r.add(name, 1_000_000, 1e6)
    if replayed:
        r.add("replay", 1_000_000, 0.5e6, "issue", 1)
    else:
        r.add("mixer", 1_000_000, 0.5e6, "issue", 4)
    r.finish(0.01)
    return r


def _read(replays, traced=None):
    """A prefill, then a decode per entry of ``replays`` (whether it
    replayed); the sink holds their records.  ``traced``: which decodes the
    device trace marked."""
    traced = traced or [False] * len(replays)
    calls = [{"kind": "prefill", "traced": False}]
    calls += [{"kind": "decode", "traced": t} for t in traced]
    sink = trace.get_sink()
    sink.clear()
    for r in [_record("prefill", False)] + [_record("decode", x) for x in replays]:
        sink.record(r)
    ctx = SimpleNamespace(calls=calls, window_s=2.0, setup_s=7.5, trace=None)
    return harness.load_module("metrics/graph_share.decode.py").read(ctx)


@pytest.mark.parametrize("replays,share", [([True] * 5, 100.0), ([False] * 5, 0.0),
                                           ([False, True, True, True], 75.0)])
def test_the_share_of_decodes_that_replayed(replays, share):
    assert _read(replays) == pytest.approx(share)


def test_traced_decodes_are_left_out():
    assert _read([True, True, False, False], [False, False, True, True]) == 100.0


def test_a_ring_that_lost_a_call_reads_none():
    sink = trace.get_sink()
    calls = [{"kind": "decode", "traced": False}] * 3
    sink.clear()
    sink.record(_record("decode", True))
    ctx = SimpleNamespace(calls=calls, window_s=2.0, setup_s=7.5, trace=None)
    assert harness.load_module("metrics/graph_share.decode.py").read(ctx) is None


def test_a_program_that_books_no_replay_stage_reads_none(monkeypatch):
    monkeypatch.delattr(trace, "STAGES")
    assert _read([True] * 3) is None
