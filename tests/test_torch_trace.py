"""The port's request tracing (``repro_torch.obs.trace``) on the CPU: a tiny
dense and a tiny SSM model served over loopback TCP, every hop measured
where its work happens, the model step's stages inside ``issue``, the
kernel wrappers' counters, and the sink that keeps a benchmark window."""
import json
import time

import numpy as np
import pytest

from repro_torch import avec
from repro_torch.configs import get_arch
from repro_torch.configs.base import reduced
from repro_torch.core.cache import model_fingerprint
from repro_torch.core.executor import DestinationExecutor, HostRuntime
from repro_torch.core.library import make_model_library
from repro_torch.core.transport import TCPChannel, TCPServer
from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mamba_step as _mstep
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.models.model import abstract_params, init_params
from repro_torch.obs import trace as T

ARCHS = {"dense": "granite-3-2b", "ssm": "mamba2-130m"}
DEST_HOPS = ["unpack", "queue", "h2d", "issue", "sync", "d2h"]
# the pipelined runtime's timeline of one call: the client's pack and send,
# the destination's hops, the client's unpack, the remainder
PIPELINED = ["serialize", "send", *DEST_HOPS, "unpack", "respond"]


@pytest.fixture(scope="module", params=sorted(ARCHS))
def served(request):
    cfg = reduced(get_arch(ARCHS[request.param]))
    ex = DestinationExecutor({"lm": make_model_library(cfg, max_cache_len=32, device="cpu")},
                             name=request.param, device="cpu")
    server = TCPServer(ex.handle).start()
    client = avec.connect([f"tcp://127.0.0.1:{server.port}"], codec="raw", prefer_shm=False,
                          shadow_every=0)
    sess = client.session(cfg, init_params(cfg, 0, "cpu"), "lm")
    sess.ensure_model()
    yield request.param, cfg, sess, ex, server
    client.close()
    server.stop()
    ex.shutdown()


def _calls(sess, decodes=3):
    """A prefill and ``decodes`` decodes -> [(record, compute_s)] in order."""
    T.get_sink().clear()
    out = []
    toks = np.arange(1, 9, dtype=np.int32)[None]
    for kind in ["prefill"] + ["decode"] * decodes:
        sess.call(kind, {"tokens": toks if kind == "prefill" else toks[:, :1]})
        out.append((T.get_sink().last(), sess.runtime.last_compute_s))
    assert [r.fn for r, _ in out] == ["prefill"] + ["decode"] * decodes
    return out


def _top(rec):
    return [s for s in rec.spans if s[3] is None]


def test_top_level_spans_sum_to_the_wall_and_each_hop_appears_once(served):
    _, _, sess, _, _ = served
    for rec, _ in _calls(sess):
        assert [s[0] for s in _top(rec)] == PIPELINED
        assert sum(s[2] for s in _top(rec)) == round(rec.wall_s * 1e9)
        assert rec.total_span_s() == pytest.approx(rec.wall_s, abs=1e-9)
        # every measured hop is a duration from its start on perf_counter_ns;
        # only the remainder has no start (and is negative where hops overlap)
        assert all(s[2] >= 0 for s in rec.spans if s[0] != "respond")
        assert all(isinstance(s[1], int) for s in _top(rec)[:-1]) and _top(rec)[-1][1] is None


def test_destination_hops_tile_from_the_frame_to_the_outputs(served):
    _, _, sess, _, _ = served
    for rec, _ in _calls(sess):
        hops = {s[0]: s for s in _top(rec)[2:8]}
        for a, b in zip(DEST_HOPS, DEST_HOPS[1:]):
            assert hops[a][1] + hops[a][2] == hops[b][1], (a, b)
        serialize, send = _top(rec)[:2]
        assert serialize[1] + serialize[2] <= send[1] <= hops["unpack"][1]
        assert hops["d2h"][1] + hops["d2h"][2] <= _top(rec)[8][1]       # the client's unpack


def test_issue_plus_sync_is_compute_s(served):
    _, _, sess, _, _ = served
    for rec, compute_s in _calls(sess):
        d = {s[0]: s[2] for s in _top(rec)}
        assert d["issue"] + d["sync"] == round(compute_s * 1e9)
        assert d["issue"] > 0


def test_stages_lie_within_issue_one_count_a_layer(served):
    kind, cfg, sess, _, _ = served
    for rec, _ in _calls(sess):
        issue = next(s for s in rec.spans if s[0] == "issue")
        stages = {s[0]: s for s in rec.spans if s[3] is not None}
        assert set(stages) == ({"mixer", "ffn"} if kind == "dense" else {"mixer"})
        for name, start, dur, parent, n in stages.values():
            assert parent == "issue" and n == cfg.num_layers
            assert issue[1] <= start and start + dur <= issue[1] + issue[2]
        assert sum(s[2] for s in stages.values()) <= issue[2]


def test_a_decode_on_the_cpu_runs_its_layers_and_replays_no_graph(served):
    """``core.library.DecodeGraph`` replays a decode only on the card: on the
    CPU each decode books its layers' stages and wrapper calls, no
    ``replay``."""
    family, cfg, sess, _, _ = served
    for rec, _ in _calls(sess)[1:]:
        stages = {s[0] for s in rec.spans if s[3] == "issue"}
        assert "replay" not in stages and "mixer" in stages
        assert ("ffn" in stages) == (family == "dense")
        assert dict((op, n) for op, n, _ in rec.wrappers)["rmsnorm"] > 0


def test_wrapper_counts_equal_the_ops_calls_of_the_step(served, monkeypatch):
    kind, cfg, sess, _, _ = served
    made: dict = {}

    def counting(mod, attr, op):
        plain = getattr(mod, attr)

        def f(*a, **k):
            made[op] = made.get(op, 0) + 1
            return plain(*a, **k)
        monkeypatch.setattr(mod, attr, f)

    counting(_rms, "rmsnorm_plain", "rmsnorm")
    counting(_fa, "flash_attention_plain", "flash_attention")
    counting(_dec, "decode_attention_plain", "decode_attention")
    counting(_ssd, "ssd_scan_plain", "ssd_scan")
    counting(_mstep, "mamba_step_plain", "mamba_step")
    L = cfg.num_layers
    T.get_sink().clear()
    toks = np.arange(1, 9, dtype=np.int32)[None]
    # an SSM decode step's mixer, its gated norm included, is one mamba_step
    for call, want in [("prefill", {"rmsnorm": 2 * L + 1,
                                    "flash_attention" if kind == "dense" else "ssd_scan": L}),
                       ("decode", {"rmsnorm": 2 * L + 1, "decode_attention": L}
                        if kind == "dense" else {"rmsnorm": L + 1, "mamba_step": L})]:
        made.clear()
        sess.call(call, {"tokens": toks if call == "prefill" else toks[:, :1]})
        counts = {op: calls for op, calls, _ in T.get_sink().last().wrappers}
        assert counts == made == want
        assert all(ns > 0 for _, _, ns in T.get_sink().last().wrappers)


def test_the_sync_runtime_books_the_client_unpack(served):
    _, cfg, sess, _, server = served
    rt = HostRuntime(TCPChannel.connect("127.0.0.1", server.port))
    try:
        fp = model_fingerprint(cfg, abstract_params(cfg))
        assert rt.has_model(fp)
        rec = T.TraceRecord(fn="prefill")
        t0 = time.perf_counter()
        rt.run(fp, "prefill", {"tokens": np.arange(1, 9, dtype=np.int32)[None]}, trace=rec)
        rec.finish(time.perf_counter() - t0)
    finally:
        rt.close()
    assert [s[0] for s in _top(rec)] == ["serialize", *DEST_HOPS, "unpack", "respond"]
    d = {s[0]: s[2] for s in _top(rec)}
    assert d["issue"] + d["sync"] == round(rt.last_compute_s * 1e9)
    assert rec.to_dict()["spans"][0]["start_ns"] == rec.spans[0][1]


def test_tracing_off_books_no_span_and_accumulates_nothing(served, monkeypatch):
    _, cfg, sess, _, server = served
    monkeypatch.setenv("AVEC_TRACE_ENABLED", "0")
    seen = []
    plain = _rms.rmsnorm_plain

    def watching(*a, **k):
        seen.append(T.CURRENT.stages)
        return plain(*a, **k)
    monkeypatch.setattr(_rms, "rmsnorm_plain", watching)
    T.get_sink().clear()
    done = T.get_sink().completed
    toks = np.arange(1, 9, dtype=np.int32)[None]
    sess.call("prefill", {"tokens": toks})
    sess.call("decode", {"tokens": toks[:, :1]})
    assert T.get_sink().last() is None and T.get_sink().completed == done
    assert seen and all(s is None for s in seen)
    # an untraced request's response carries no span
    rt = HostRuntime(TCPChannel.connect("127.0.0.1", server.port))
    try:
        rmeta, _ = rt._rpc(rt._run_meta(model_fingerprint(cfg, abstract_params(cfg)),
                                        "decode", False, None, None),
                           {"tokens": toks[:, :1]})
    finally:
        rt.close()
    assert not {"spans", "span_starts", "stages", "wrappers", "_timing"} & set(rmeta)


def test_a_trace_log_line_carries_the_starts_and_the_clock_offset(monkeypatch, capsys):
    monkeypatch.setenv("AVEC_TRACE_LOG", "1")
    rec = T.TraceRecord(fn="decode")
    rec.add("serialize", 123, 5000)
    T.finish_trace(rec, 1e-5)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["event"] == "trace" and line["fn"] == "decode"
    assert [(s["name"], s["start_ns"], s["dur_s"]) for s in line["spans"]] == [
        ("serialize", 123, 5e-6), ("respond", None, 5e-6)]
    assert abs(line["realtime_offset_ns"] - (time.time_ns() - time.perf_counter_ns())) < 1e9


def test_a_coalesced_batch_divides_its_hops_among_its_calls():
    ex = DestinationExecutor({"lib": {"f": lambda params, state, args: {"y": args["x"] * 2}}},
                             device="cpu")
    ex.cache.put("fp", {"lib": "lib", "params": {}, "state": {}, "extra": {}}, 0)
    metas = [{"fp": "fp", "fn": "f", "trace": f"t{i}"} for i in range(3)]
    trees = [{"x": np.full((2, 4), i, np.float32)} for i in range(3)]
    res = ex._run_batch(None, metas, trees)
    for i, (rmeta, out) in enumerate(res):
        np.testing.assert_array_equal(out["y"], 2 * trees[i]["x"])
        hops, _ = rmeta["_timing"]
        assert [h[0] for h in hops] == ["h2d", "issue", "sync", "d2h"]
        d = {h[0]: h[2] for h in hops}
        assert (d["issue"] + d["sync"]) / 1e9 == pytest.approx(rmeta["compute_s"], abs=2e-9)
        assert rmeta["coalesced"] == 3
    ex.shutdown()


def test_the_sink_keeps_16384_records_in_order():
    sink = T.TraceSink()
    assert T.SINK_CAPACITY == 16384 and T.get_sink()._traces.maxlen == 16384
    recs = [T.TraceRecord(call_id=str(i), fn="decode") for i in range(16384 + 100)]
    for r in recs:
        sink.record(r)
    kept = sink.recent(16384)
    assert kept == recs[100:] and sink.recent(20000) == kept and sink.completed == 16484
