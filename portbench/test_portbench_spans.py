"""The readers of the program's own spans (``spans.py``: ``issue_ms.*``,
``mixer_ms.decode``, ``ffn_ms.decode``, ``hops_ms.*``, ``wrapper_us.decode``)
on a made-up sink, and on a tiny run on the CPU."""
import time
from types import SimpleNamespace

import pytest

from portbench import harness
from portbench import test_portbench_run as tiny
from repro_torch.obs import trace

NEW = ["issue_ms.decode", "issue_ms.prefill", "mixer_ms.decode", "ffn_ms.decode",
       "hops_ms.decode", "hops_ms.prefill", "wrapper_us.decode"]


def _read(name, ctx):
    return harness.load_module(f"metrics/{name}.py").read(ctx)


def _record(kind, ms):
    """A call's record: each hop ``ms`` long (the client's unpack 2 ms), the
    stages and two wrappers inside issue."""
    r = trace.TraceRecord(fn=kind)
    t = 1_000_000
    for name in ["serialize", "send", "unpack", "queue", "h2d", "issue", "sync", "d2h"]:
        r.add(name, t, ms * 1e6)
        t += int(ms * 1e6)
    r.add("mixer", t, 0.5 * ms * 1e6, "issue", 4)
    r.add("ffn", t, 0.25 * ms * 1e6, "issue", 4)
    r.wrappers = (("rmsnorm", 9, 9 * 1000 * ms), ("decode_attention", 4, 4 * 3000 * ms))
    r.add("unpack", t, 2e6)
    r.finish(20 * ms / 1e3)
    return r


def _ctx(calls):
    return SimpleNamespace(calls=calls, window_s=2.0, setup_s=7.5, trace=None)


def _sink(records):
    sink = trace.get_sink()
    sink.clear()
    for r in records:
        sink.record(r)


def _calls():
    """A prefill then decodes, the last two traced (made 10x slower)."""
    kinds = ["prefill", "decode", "decode", "decode", "decode"]
    traced = [False, False, False, True, True]
    calls = [{"kind": k, "traced": t} for k, t in zip(kinds, traced)]
    _sink([_record("prefill", 3)] + [_record("decode", 1)] * 2 + [_record("decode", 10)] * 2)
    return calls


def test_traced_calls_are_left_out_and_the_sums_are_right():
    ctx = _ctx(_calls())
    assert _read("issue_ms.decode", ctx) == pytest.approx(1.0)
    assert _read("issue_ms.prefill", ctx) == pytest.approx(3.0)
    assert _read("mixer_ms.decode", ctx) == pytest.approx(0.5)
    assert _read("ffn_ms.decode", ctx) == pytest.approx(0.25)
    # serialize, send, queue, h2d, d2h, the destination's unpack, and the client's 2 ms
    assert _read("hops_ms.decode", ctx) == pytest.approx(6 * 1.0 + 2.0)
    assert _read("hops_ms.prefill", ctx) == pytest.approx(6 * 3.0 + 2.0)
    # (9 x 1 + 4 x 3) us over 13 calls
    assert _read("wrapper_us.decode", ctx) == pytest.approx((9 + 12) / 13)


def test_a_misaligned_or_evicted_window_reads_none():
    calls = _calls()
    for name in NEW:
        assert _read(name, _ctx(calls + [{"kind": "decode", "traced": False}])) is None
        assert _read(name, _ctx([{"kind": "decode", "traced": False}] + calls[1:])) is None
    trace.get_sink().clear()
    assert all(_read(name, _ctx(calls)) is None for name in NEW)


def test_records_without_such_spans_read_none():
    calls = [{"kind": "decode", "traced": False}]
    old = trace.TraceRecord(fn="decode")
    old.spans = [{"name": "execute", "dur_s": 0.01}]     # a record of another shape
    _sink([old])
    assert all(_read(name, _ctx(calls)) is None for name in NEW)
    bare = trace.TraceRecord(fn="decode")
    bare.finish(0.01)
    _sink([bare])
    assert all(_read(name, _ctx(calls)) is None for name in NEW)


@pytest.mark.parametrize("config", ["tiny-dense", "tiny-ssm"])
def test_a_tiny_run_reports_the_span_metrics(config):
    manifest = tiny._manifest(config)
    names = NEW + ["compute_ms.decode", "compute_ms.prefill", "offload_ms.decode",
                   "offload_ms.prefill"]
    manifest["end_to_end"] += [{"name": n, "unit": "ms"} for n in names]
    result, rows = harness.run_cell(manifest, "tiny.chat", 2 ** 31 + 23, 1.5, False,
                                    t_start=time.perf_counter(), device="cpu",
                                    limits=tiny.TINY_LIMITS)
    assert result["correct"] is True, rows
    m = {k: v["value"] for k, v in result["metrics"].items()}
    want = set(NEW) - ({"ffn_ms.decode"} if config == "tiny-ssm" else set())
    assert want <= set(m) and ("ffn_ms.decode" in m) == (config == "tiny-dense")
    for kind in ("decode", "prefill"):
        assert 0 < m[f"issue_ms.{kind}"] <= m[f"compute_ms.{kind}"]
        assert 0 < m[f"hops_ms.{kind}"] <= m[f"offload_ms.{kind}"]
    assert m["mixer_ms.decode"] + m.get("ffn_ms.decode", 0) <= m["issue_ms.decode"]
    assert m["wrapper_us.decode"] > 0
