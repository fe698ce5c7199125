"""The port's front door, ``repro_torch.avec``, at reduced granite-3-2b
(float32, on the CPU), with weights from ``repro.models.model.init_params``
fed to both packages.

* the versioned handshake: the pipelined runtime over TCP, a protocol
  mismatch refused, codec and pipelining downgraded, a request-only channel
  kept synchronous;
* routed sessions: library-aware routing, transparent mid-stream failover,
  application errors that do not fail over, a connection blip recovered on
  the same destination, ``map`` over several destinations and its cap;
* tenancy: tenant-scoped fingerprints, the QoS drain order against the
  reference's, typed ``TenantThrottled`` with the frontend's retries, tenant
  stats through the handshake, routing around a tenant's own saturation;
* ``quant_codec``: armed by the ``comm_quant_codec`` knob at the handshake,
  engaged on a narrow simulated link (the three ``quant_*`` stats keys);
* mixed fleets both ways over TCP and ``shm://``: the JAX package's
  ``avec.connect`` drives port destinations and the port's drives JAX
  destinations through ``call``, ``map`` and ``shard=True``;
* the deprecated positional dispatcher, kept because the reference exports
  it, and ``repro_torch.connect`` resolving lazily.

Port against reference numerics are held to 1e-4 (float32 logits and loss),
as in ``tests/test_torch_fleet.py``."""
import dataclasses
import os
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest

import repro.avec as ref_avec
from repro.configs import get_arch, reduced
from repro.core.executor import DestinationExecutor as RefDest
from repro.core.executor import HostRuntime as RefHost
from repro.core.executor import _QoSQueues as RefQoSQueues
from repro.core.library import make_model_library as ref_library
from repro.core.shm import SharedMemoryServer as RefShmServer
from repro.core.transport import DirectChannel as RefDirect
from repro.core.transport import TCPServer as RefTCPServer
from repro.models import model as RM
from repro_torch import avec
from repro_torch import configs as tconfigs
from repro_torch.core import (AcceleratorRegistry, ArgExtractionError, AvecSession,
                              DeviceAwareScheduler, HostRuntime, PipelinedHostRuntime, Workload)
from repro_torch.core.executor import (DestinationExecutor, RemoteError, TenantThrottled,
                                       _QoSQueues)
from repro_torch.core.library import make_model_library
from repro_torch.core.scheduler import NoDestinationError
from repro_torch.core.serialization import PROTOCOL_VERSION
from repro_torch.core.shm import SharedMemoryServer
from repro_torch.core.transport import (ChannelClosed, DirectChannel, LoopbackChannel,
                                        SimulatedChannel, TCPChannel, TCPServer, VirtualClock)
from repro_torch.core.virtualization import JETSON_TX2
from repro_torch.serving.engine import PipelinedOffloadFrontend, generate_sequential

TOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def lm():
    cfg = tconfigs.reduced(tconfigs.get_arch("granite-3-2b"))
    params = jax.tree_util.tree_map(
        np.asarray, RM.init_params(reduced(get_arch("granite-3-2b")), jax.random.PRNGKey(0)))
    return cfg, params, make_model_library(cfg, max_cache_len=32, device="cpu")


def _dest(libs, name, cls=DestinationExecutor, **kw):
    return cls(libs, name=name, device="cpu", **kw)


def _counting_lib(lib, hits):
    out = {}
    for name, fn in lib.items():
        def wrap(fn=fn, name=name):
            def g(p, s, a):
                hits[name] = hits.get(name, 0) + 1
                return fn(p, s, a)
            return g
        out[name] = wrap()
    return out


def _greedy(out, cfg) -> int:
    return int(np.argmax(np.asarray(out["logits"])[0, 0, :cfg.vocab_size]))


def _score_reqs(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return {f"r{i}": {"tokens": rng.integers(0, cfg.vocab_size, (1, 8)).astype(np.int32),
                      "targets": rng.integers(0, cfg.vocab_size, (1, 8)).astype(np.int32)}
            for i in range(n)}


# ---------------------------------------------------------------------------
# the handshake: upgrade, reject, downgrade
# ---------------------------------------------------------------------------

def test_handshake_auto_upgrades_pipelining_over_tcp(lm):
    cfg, params, lib = lm
    server = TCPServer(_dest({"lm": lib}, "tcp-dest").handle).start()
    try:
        with avec.connect([f"tcp://127.0.0.1:{server.port}"]) as client:
            name = client.destinations[0]
            caps = client.capabilities(name)
            assert caps.protocol_version == PROTOCOL_VERSION
            assert "raw" in caps.codecs and caps.pipelining
            assert "run" in caps.ops and "ping" in caps.ops
            assert caps.libraries == {"lm": sorted(lib)}
            assert isinstance(client.runtime(name), PipelinedHostRuntime)
            out = client.session(cfg, params, "lm").call(
                "prefill", {"tokens": np.zeros((1, 4), np.int32)})
            assert out["logits"].shape[0] == 1
    finally:
        server.stop()


def test_handshake_rejects_protocol_version_mismatch(lm):
    _, _, lib = lm

    class FutureExecutor(DestinationExecutor):
        def _op_ping(self, meta, tree):
            m, t, c = super()._op_ping(meta, tree)
            m["protocol_version"] = PROTOCOL_VERSION + 7
            return m, t, c

    with pytest.raises(avec.HandshakeError) as ei:
        avec.connect([_dest({"lm": lib}, "future", cls=FutureExecutor)])
    msg = str(ei.value)
    assert f"v{PROTOCOL_VERSION + 7}" in msg and f"v{PROTOCOL_VERSION}" in msg
    assert "future" in msg


def test_handshake_downgrades_codec_and_pipelining(lm):
    cfg, params, lib = lm

    class LimitedExecutor(DestinationExecutor):
        def _op_ping(self, meta, tree):
            m, t, c = super()._op_ping(meta, tree)
            m["codecs"] = ["raw"]
            m["pipelining"] = False
            return m, t, c

    server = TCPServer(_dest({"lm": lib}, "limited", cls=LimitedExecutor).handle).start()
    try:
        with avec.connect([f"tcp://127.0.0.1:{server.port}"], codec="zstd") as client:
            name = client.destinations[0]
            assert type(client.runtime(name)) is HostRuntime
            assert client.codec_for(name) == "raw"
            client.session(cfg, params, "lm").call(
                "prefill", {"tokens": np.zeros((1, 4), np.int32)})
    finally:
        server.stop()


def test_request_only_channel_downgrades_pipelining(lm):
    _, _, lib = lm
    with avec.connect([_dest({"lm": lib}, "inproc")]) as client:
        assert type(client.runtime("inproc")) is HostRuntime
        assert client.capabilities("inproc").pipelining


@pytest.mark.parametrize("requested,peer", [
    ("zstd", ("raw", "zstd")), (("int8", "zstd"), ("raw",)),
    (("int8", "zstd", "gzip"), ("raw", "zstd", "zlib", "int8", "fp16")),
    ("raw", ("raw", "zstd")), (("fp16",), ("raw", "fp16"))])
def test_negotiate_codecs_equals_reference(requested, peer):
    assert avec.negotiate_codecs(requested, peer) == ref_avec.negotiate_codecs(requested, peer)
    first = requested if isinstance(requested, str) else requested[0]
    assert avec.negotiate_codec(first, peer) == ref_avec.negotiate_codec(first, peer)


# ---------------------------------------------------------------------------
# routed sessions and failover
# ---------------------------------------------------------------------------

def test_mid_stream_failover_reroutes_transparently(lm):
    cfg, params, lib = lm
    executors = {n: _dest({"lm": lib}, n) for n in ("edge-a", "edge-b")}
    targets = [(dataclasses.replace(JETSON_TX2, name=n), ex) for n, ex in executors.items()]
    prompt = [5, 17, 3, 99, 42, 7]
    want = generate_sequential(cfg, params, prompt, 6, max_len=32, device="cpu")
    with avec.connect(targets) as client:
        sess = client.session(cfg, params, "lm", destination="edge-a")
        sess.call("prefill", {"tokens": np.asarray([prompt], np.int32)})
        got = [want[0]]
        for step in range(1, 6):
            if step == 3:
                executors["edge-a"].fail = True
            got.append(_greedy(sess.call("decode", {"tokens": np.asarray([[got[-1]]], np.int32)}),
                               cfg))
        assert got == want
        assert sess.destination == "edge-b"
        assert client.migration.migrations[0]["from"] == "edge-a"
        assert not client.registry.get("edge-a").healthy
        assert client.registry.get("edge-b").total_requests >= 3
        assert client.registry.get("edge-b").inflight == 0


def test_application_errors_do_not_failover(lm):
    cfg, params, lib = lm
    with avec.connect([_dest({"lm": lib}, n) for n in ("a", "b")]) as client:
        sess = client.session(cfg, params, "lm", destination="a")
        sess.ensure_model()
        with pytest.raises(RemoteError):
            sess.call("no_such_fn", {"x": np.zeros(1, np.float32)})
        assert sess.destination == "a" and client.migration.migrations == []


def test_connection_blip_recovers_on_same_destination(lm):
    cfg, params, lib = lm
    server = TCPServer(_dest({"lm": lib}, "only").handle).start()
    prompt = [5, 17, 3, 99]
    want = generate_sequential(cfg, params, prompt, 3, max_len=32, device="cpu")
    try:
        with avec.connect([f"tcp://127.0.0.1:{server.port}"]) as client:
            sess = client.session(cfg, params, "lm")
            sess.call("prefill", {"tokens": np.asarray([prompt], np.int32)})
            client.runtime(sess.destination).channel._fail()
            out = sess.call("decode", {"tokens": np.asarray([[want[0]]], np.int32)})
            assert _greedy(out, cfg) == want[1]
            assert client.migration.migrations == []
            assert client.registry.get(sess.destination).healthy
    finally:
        server.stop()


def test_library_aware_routing_and_client_close(lm):
    cfg, params, lib = lm
    with avec.connect([_dest({"other": lib}, "no-lm"), _dest({"lm": lib}, "has-lm")]) as client:
        sess = client.session(cfg, params, "lm")
        assert sess.destination == "has-lm"
        sess.map("score", _score_reqs(cfg, 2, 2))
        assert list(sess.last_map_stats["assigned"]) == ["has-lm"]
        with pytest.raises(NoDestinationError, match="nothere"):
            client.session(cfg, params, "nothere")
    with pytest.raises(ChannelClosed):
        client.runtime("has-lm")


def test_map_shards_across_destinations_and_respects_max_shards(lm):
    cfg, params, lib = lm
    hits = [{}, {}, {}]
    exs = [_dest({"lm": _counting_lib(lib, hits[i])}, f"d{i}") for i in range(3)]
    reqs = _score_reqs(cfg, 6, 0)
    with avec.connect(exs) as client:
        sess = client.session(cfg, params, "lm")
        out = sess.map("score", reqs)
        assert sorted(sess.last_map_stats["assigned"].values()) == [2, 2, 2]
        assert all(h.get("score", 0) == 2 for h in hits)
        for nm in ("d0", "d1", "d2"):
            va = client.registry.get(nm)
            assert va.total_requests >= 2 and va.inflight == 0
        sess.map("score", reqs, max_shards=2)
        assert len(sess.last_map_stats["assigned"]) == 2
    with avec.connect([_dest({"lm": lib}, "ref")]) as ref_client:
        ref = ref_client.session(cfg, params, "lm").map("score", reqs)
    for rid in reqs:
        assert np.array_equal(np.asarray(out[rid]["loss"]), np.asarray(ref[rid]["loss"]))


# ---------------------------------------------------------------------------
# tenancy
# ---------------------------------------------------------------------------

def test_tenant_scoped_fingerprint_caches(lm):
    cfg, params, lib = lm
    ex = _dest({"lm": lib}, "shared")
    with avec.connect([ex]) as client:
        s_a = client.session(cfg, params, "lm", tenant="acme")
        s_b = client.session(cfg, params, "lm", tenant="bravo")
        s_none = client.session(cfg, params, "lm")
        assert len({s_a.fp, s_b.fp, s_none.fp}) == 3
        assert s_a.ensure_model() is False and s_b.ensure_model() is False
        assert client.session(cfg, params, "lm", tenant="acme").ensure_model() is True
        tok = np.asarray([[3, 1, 4, 1]], np.int32)
        s_a.call("prefill", {"tokens": tok})
        s_b.call("prefill", {"tokens": tok})
        out_a1 = s_a.call("decode", {"tokens": tok[:, :1]})
        s_b.call("decode", {"tokens": tok[:, :1]})
        with avec.connect([_dest({"lm": lib}, "iso-ref")]) as ref:
            r = ref.session(cfg, params, "lm", tenant="acme")
            r.call("prefill", {"tokens": tok})
            ref_a1 = r.call("decode", {"tokens": tok[:, :1]})
        assert np.array_equal(np.asarray(out_a1["logits"]), np.asarray(ref_a1["logits"]))


def _drain_order(queues, pushes, max_batch=8):
    for tenant, qos, key in pushes:
        queues.push(tenant, qos, (key, {}, None, None))
    order = []
    while queues.pending:
        tq, key, batch = queues.next_batch(max_batch)
        order.append((tq.name, key, len(batch)))
    return order


@pytest.mark.parametrize("case", ["weights", "pinned", "priority", "keys"])
def test_qos_drain_order_equals_reference(case):
    """The weighted deficit-round-robin drain, priority classes and key
    flushes give the reference's order, batch by batch."""
    kw, pushes = {}, []
    if case == "weights":
        pushes = [p for _ in range(40) for p in (("a", {"weight": 3}, ("k",)),
                                                  ("b", {"weight": 1}, ("k",)))]
    elif case == "pinned":
        kw = {"tenant_weights": {"a": 1.0, "b": 3.0}}
        pushes = [p for _ in range(30) for p in (("a", {"weight": 100.0}, ("k",)),
                                                  ("b", None, ("k",)))]
    elif case == "priority":
        pushes = [("low", {"priority": 0}, ("k",))] * 5 + [("hi", {"priority": 5}, ("k",))]
    else:
        pushes = [("t", None, ("k1",)), ("t", None, ("k1",)), ("t", None, ("k2",)),
                  ("u", {"weight": 2}, ("k1",))]
    got = _drain_order(_QoSQueues(**kw), pushes)
    assert got == _drain_order(RefQoSQueues(**kw), pushes) and got


def _gated(**caps):
    gate, entered = threading.Event(), threading.Event()

    def slow(params, state, args):
        entered.set()
        assert gate.wait(timeout=10)
        return {"y": np.asarray(args["x"]) + 1.0}

    ex = _dest({"tiny": {"slow": slow}}, "gated", **caps)
    HostRuntime(DirectChannel(ex)).put_model("fp", "tiny", {"w": np.zeros(1, np.float32)})
    return ex, gate, entered


def test_tenant_throttled_typed_error_and_retry_resumes():
    ex, gate, entered = _gated(tenant_max_inflight=1)
    x = {"x": np.zeros(2, np.float32)}
    first = threading.Thread(target=HostRuntime(DirectChannel(ex)).run, args=("fp", "slow", x),
                             kwargs={"tenant": "acme"})
    first.start()
    assert entered.wait(timeout=10)
    with pytest.raises(TenantThrottled) as ei:
        HostRuntime(DirectChannel(ex), throttle_retries=0).run("fp", "slow", x, tenant="acme")
    assert ei.value.tenant == "acme" and ei.value.retry_after_s > 0
    threading.Timer(0.15, gate.set).start()         # free the slot mid-retries
    rt = HostRuntime(DirectChannel(ex), throttle_retries=20)
    np.testing.assert_array_equal(rt.run("fp", "slow", x, tenant="acme")["y"], np.ones(2))
    assert rt.throttle_retried >= 1
    first.join(timeout=10)
    assert ex.tenant_stats["acme"]["throttled"] >= 2


def test_pipelined_frontend_map_retries_throttled_fanout():
    """A fan-out wider than the tenant's cap degrades to jittered
    re-submits inside the frontend's gather."""
    def slow(params, state, args):
        time.sleep(0.02)
        return {"y": np.asarray(args["x"]) + 1.0}

    ex = _dest({"tiny": {"slow": slow}}, "capped", tenant_max_inflight=2)
    HostRuntime(DirectChannel(ex)).put_model("fp", "tiny", {"w": np.zeros(1, np.float32)})
    host_ch, dest_ch = LoopbackChannel.pair()
    stop = threading.Event()

    def serve():
        while not stop.is_set():
            try:
                raw = dest_ch.recv(timeout=0.2)
            except TimeoutError:
                continue
            except ChannelClosed:
                return
            threading.Thread(target=lambda r=raw: dest_ch.send(ex.handle(r)),
                             daemon=True).start()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    rt = PipelinedHostRuntime(host_ch, max_in_flight=8, throttle_retries=50)
    fe = PipelinedOffloadFrontend(rt, "fp", "slow", tenant="acme")
    outs = fe.map({f"r{i}": {"x": np.full(3, float(i), np.float32)} for i in range(8)})
    for i in range(8):
        np.testing.assert_array_equal(outs[f"r{i}"]["y"], np.full(3, i + 1.0))
    assert ex.tenant_stats["acme"]["throttled"] >= 1
    assert ex.tenant_stats["acme"]["served"] == 8
    stop.set()
    rt.close()
    t.join(timeout=5)


def test_tenant_qos_and_stats_roundtrip_through_handshake(lm):
    cfg, params, lib = lm
    ex = _dest({"lm": lib}, "dest-a", coalesce=True, tenant_max_inflight=4)
    try:
        with avec.connect([ex]) as client:
            caps = client.capabilities("dest-a")
            assert caps.fair_drain and caps.tenant_limits["max_inflight"] == 4
            sess = client.session(cfg, params, "lm", tenant="acme",
                                  qos=avec.QoS(weight=3.0, priority=1))
            assert sess.qos == {"weight": 3.0, "priority": 1}
            sess.call("score", {"tokens": np.zeros((1, 8), np.int32),
                                "targets": np.zeros((1, 8), np.int32)})
            row = client.refresh_capabilities("dest-a").tenant_stats["acme"]
            assert row["served"] == 1
            assert client.scheduler.tenant_stats("dest-a", "acme")["served"] == 1
    finally:
        ex.shutdown()


def test_session_routes_around_own_saturation(lm):
    cfg, params, lib = lm
    with avec.connect([_dest({"lm": lib}, "dest-a"), _dest({"lm": lib}, "dest-b")]) as client:
        client.scheduler.record_capabilities("dest-a", {
            "tenant_stats": {"acme": {"inflight": 4, "throttled": 50, "served": 5,
                                      "queue_depth": 16}},
            "tenant_limits": {"max_inflight": 4}})
        assert client.session(cfg, params, "lm", tenant="acme").destination == "dest-b"


def test_handshake_feeds_coalesce_stats_to_scheduler(lm):
    _, _, lib = lm
    ex_co = _dest({"lm": lib}, "co", coalesce=True)
    try:
        with avec.connect([_dest({"lm": lib}, "plain"), ex_co]) as client:
            w = Workload("w", flops=1e9, bytes_out=1e4, bytes_back=1e4, model_bytes=1e6)
            for name in ("plain", "co"):
                client.registry.get(name).inflight = 6
            assert client.scheduler.pick(w).name == "co"
    finally:
        ex_co.shutdown()


def test_scheduler_coalesce_capability_discounts_queueing():
    reg = AcceleratorRegistry()
    reg.register(dataclasses.replace(JETSON_TX2, name="serial"))
    reg.register(dataclasses.replace(JETSON_TX2, name="batcher"))
    sched = DeviceAwareScheduler(reg)
    sched.record_capabilities("batcher", {
        "coalesce": True, "coalesce_stats": {"batches": 10, "requests": 40, "max_batch": 8}})
    w = Workload("w", flops=1e9, bytes_out=1e5, bytes_back=1e5, model_bytes=1e6)
    va_s, va_b = reg.get("serial"), reg.get("batcher")
    assert sched.score(w, va_s) == pytest.approx(sched.score(w, va_b))
    va_s.inflight = va_b.inflight = 8
    assert sched.score(w, va_b) < sched.score(w, va_s)


# ---------------------------------------------------------------------------
# quant_codec on a narrow link
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("knob", ["int8", "off"])
def test_quant_codec_engages_on_a_narrow_link(monkeypatch, knob):
    """Armed by the knob when the peer decodes it; engaged once the window
    has seen a link-bound session (wire EMA over compute EMA); the frames it
    shrank are counted in ``stats()``.  Off, nothing is quantized."""
    monkeypatch.setenv("AVEC_COMM_QUANT_CODEC", knob)

    def work(params, state, args):
        return {"y": np.asarray(args["x"]).sum(axis=1, keepdims=True)}

    server = TCPServer(_dest({"tiny": {"work": work}}, "far").handle).start()

    def dial():
        return SimulatedChannel(TCPChannel.connect("127.0.0.1", server.port), VirtualClock(),
                                bandwidth=20e6, latency=0.001, serialize_rate=0.0,
                                realtime=True)

    x = {"x": np.random.default_rng(0).standard_normal((64, 1024)).astype(np.float32)}
    try:
        with avec.connect([(dataclasses.replace(JETSON_TX2, name="far"), dial)]) as client:
            rt = client.runtime("far")
            assert isinstance(rt, PipelinedHostRuntime)
            assert rt.quant_codec == (None if knob == "off" else "int8")
            sess = client.session({"m": 1}, {"w": np.zeros(1, np.float32)}, "tiny")
            outs = [np.asarray(sess.call("work", x)["y"]) for _ in range(8)]
            st = rt.stats()
            assert {"quant_codec", "quant_frames", "quant_bytes_saved"} <= set(st)
            assert st["window_observations"] >= 8
            want = x["x"].sum(axis=1, keepdims=True)
            if knob == "off":
                assert st["quant_frames"] == 0 and st["quant_bytes_saved"] == 0
                assert all(np.array_equal(o, want) for o in outs)
            else:
                assert st["wire_ema_s"] > st["compute_ema_s"]
                assert 1 <= st["quant_frames"] <= 4       # engaged after 4 observations
                assert st["quant_bytes_saved"] >= st["quant_frames"] * x["x"].nbytes // 2
                assert np.array_equal(outs[0], want)      # before engagement: exact
                bound = 1024 * np.abs(x["x"]).max(axis=1, keepdims=True) / 254.0
                assert np.all(np.abs(outs[-1] - want) <= bound)
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# mixed fleets, both ways, over TCP and shm://
# ---------------------------------------------------------------------------

def _serve(transport, executor, server_cls):
    srv = server_cls(executor.handle).start()
    url = (f"tcp://127.0.0.1:{srv.port}" if transport == "tcp" else f"shm://{srv.address}")
    return srv, url


def _reference_outputs(cfg_ref, params, prompt, reqs, htoks):
    """The same calls on an in-process JAX-package destination."""
    rt = RefHost(RefDirect(RefDest({"lm": ref_library(cfg_ref, 32)}, name="want")))
    fp = "want"
    rt.put_model(fp, "lm", params)
    pre = np.array(rt.run(fp, "prefill", {"tokens": prompt})["logits"])
    dec = np.array(rt.run(fp, "decode", {"tokens": pre[:, -1:, :cfg_ref.vocab_size]
                                         .argmax(-1).astype(np.int32)})["logits"])
    scores = {rid: float(np.asarray(rt.run(fp, "score", a)["loss"])) for rid, a in reqs.items()}
    hidden = np.array(rt.run(fp, "hidden", {"tokens": htoks})["hidden"])
    return pre, dec, scores, hidden


@pytest.mark.parametrize("transport", ["tcp", "shm"])
@pytest.mark.parametrize("host", ["reference_host", "port_host"])
def test_mixed_fleet_call_map_and_shard(lm, monkeypatch, transport, host):
    """reference_host: the JAX package's ``avec.connect`` over two port
    destinations; port_host: the port's over two JAX-package destinations."""
    cfg, params, lib = lm
    cfg_ref = reduced(get_arch("granite-3-2b"))
    monkeypatch.setenv("AVEC_SHARD_MIN_ROWS", "2")
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab_size, (1, 8)).astype(np.int32)
    reqs = _score_reqs(cfg, 4, 6)
    htoks = rng.integers(0, cfg.vocab_size, (4, 8)).astype(np.int32)
    want_pre, want_dec, want_scores, want_hidden = _reference_outputs(
        cfg_ref, params, prompt, reqs, htoks)

    if host == "reference_host":
        connect, sess_cfg = ref_avec.connect, cfg_ref
        server_cls = TCPServer if transport == "tcp" else SharedMemoryServer
        dests = [_dest({"lm": lib}, f"port-{i}") for i in range(2)]
    else:
        connect, sess_cfg = avec.connect, cfg
        server_cls = RefTCPServer if transport == "tcp" else RefShmServer
        dests = [RefDest({"lm": ref_library(cfg_ref, 32)}, name=f"jax-{i}") for i in range(2)]
    servers, urls = zip(*(_serve(transport, ex, server_cls) for ex in dests))
    try:
        with connect(list(urls), shadow_every=0) as client:
            runtimes = [type(client.runtime(n)).__name__ for n in client.destinations]
            assert runtimes == ["PipelinedHostRuntime"] * 2
            sess = client.session(sess_cfg, params, "lm", tenant="mixed")
            pre = np.array(sess.call("prefill", {"tokens": prompt})["logits"])
            dec = np.array(sess.call("decode", {"tokens": pre[:, -1:, :cfg.vocab_size]
                                                .argmax(-1).astype(np.int32)})["logits"])
            np.testing.assert_allclose(pre, want_pre, atol=TOL, rtol=TOL)
            np.testing.assert_allclose(dec, want_dec, atol=TOL, rtol=TOL)
            out = sess.map("score", reqs)
            assert sorted(sess.last_map_stats["assigned"].values()) == [2, 2]
            for rid, a in reqs.items():
                assert abs(float(np.asarray(out[rid]["loss"])) - want_scores[rid]) <= TOL
            hidden = np.array(sess.call("hidden", {"tokens": htoks}, shard=True)["hidden"])
            st = sess.last_shard_stats
            assert st is not None and len(st["shards"]) == 2 and not st["failed"]
            assert len(set(st["destinations"])) == 2
            np.testing.assert_allclose(hidden, want_hidden, atol=TOL, rtol=TOL)
    finally:
        for srv in servers:
            srv.stop()
        for ex in dests:
            ex.shutdown()


# ---------------------------------------------------------------------------
# interception, the deprecated dispatcher, the lazy front door
# ---------------------------------------------------------------------------

def test_argspec_intercept_through_the_client(lm):
    """``client.intercept`` routes an ArgSpec'd module function through the
    session; a call missing its argument raises instead of sending {}."""
    cfg, params, lib = lm
    import types

    mod = types.ModuleType("app")
    mod.score = lambda cfg_, params_, batch: pytest.fail("ran locally")
    args = _score_reqs(cfg, 1, 3)["r0"]
    with avec.connect([_dest({"lm": lib}, "x")]) as client:
        sess = client.session(cfg, params, "lm")
        want = float(np.asarray(sess.call("score", args)["loss"]))
        with client.intercept(mod, {"score": ("score", avec.ArgSpec(position=2))}, sess):
            assert float(np.asarray(mod.score(cfg, params, args)["loss"])) == want
            with pytest.raises(ArgExtractionError, match="score"):
                mod.score(cfg, params)


def test_legacy_dispatcher_deprecated_and_no_longer_silent(lm):
    """Kept because the reference exports it: warns, and the formerly
    silent two-positional-args case raises."""
    cfg, params, lib = lm
    sess = AvecSession(cfg, params, HostRuntime(DirectChannel(_dest({"lm": lib}, "legacy"))),
                       "lm")
    with pytest.warns(DeprecationWarning, match="ArgSpec"):
        disp = sess.make_dispatcher({"fn": "score"})
    with pytest.raises(ArgExtractionError, match="positional convention"):
        disp("fn", lambda *a, **k: None, "cfg", "params")


def test_connect_resolves_lazily():
    code = ("import sys, repro_torch\n"
            "assert 'repro_torch.avec' not in sys.modules\n"
            "from repro_torch import connect, AvecClient, ConnectPolicy, ArgSpec, avec\n"
            "assert connect is avec.connect and 'repro_torch.avec' in sys.modules\n"
            "assert sorted(dir(repro_torch)) == sorted(set(dir(repro_torch)))\n"
            "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
