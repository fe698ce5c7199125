"""The port's host side against the JAX package's, on the CPU: interception
of an unmodified caller, remote errors, the profiler, the cost model and the
split search, the scheduler, hedging, failover of a decode stream, the
heartbeat and ``ArgSpec`` extraction.

Pure arithmetic (profiler sums, cost model, ``best_split``, scheduler
scores) must equal the reference's exactly; intercepted OpenPose beliefs
agree with the reference's ``op_forward`` within 1e-5·max|ref| (float32
convolutions in another order); a failed-over decode stream is
bit-identical to the same stream run without a failure.  Every wait has a
limit of its own, generous for a loaded machine."""
import dataclasses
import importlib.util
import itertools
import threading
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.costmodel as RC
import repro.core.offload as RO
from repro.core import AvecProfiler as RefProfiler
from repro.core import DeviceAwareScheduler as RefScheduler
from repro.core import AcceleratorRegistry as RefRegistry
from repro.core.interception import ArgExtractionError as RefArgError
from repro.core.interception import ArgSpec as RefArgSpec
from repro.core.virtualization import PAPER_TESTBED as REF_TESTBED
from repro.models import openpose as R
from repro.models.params import init_params as ref_init
from repro_torch import configs as tconfigs
import repro_torch.core.costmodel as C
import repro_torch.core.offload as O
from repro_torch.configs.avec_openpose import WORKLOAD
from repro_torch.core import (PAPER_TESTBED, AcceleratorRegistry, ArgExtractionError,
                              ArgSpec, AvecProfiler, AvecSession, DestinationExecutor,
                              DeviceAwareScheduler, HeartbeatMonitor, HostRuntime,
                              InterceptionLibrary, MigrationManager, RemoteError,
                              SessionShadow, Workload, hedged_call)
from repro_torch.core.library import make_model_library, make_openpose_library
from repro_torch.core.transport import DirectChannel
from repro_torch.core.virtualization import CLOUD_RTX, JETSON_NANO, JETSON_TX2
from repro_torch.models import model as M
from repro_torch.models import openpose as P
from repro_torch.models.params import from_numpy_tree

TOL = 1e-5


@pytest.fixture(scope="module")
def openpose_weights():
    net = R.OpenPoseLite()
    params = jax.tree_util.tree_map(
        np.asarray, ref_init(R.op_param_specs(net), jax.random.PRNGKey(2), jnp.float32))
    return net, params


def _openpose_session(params, name="op-dest"):
    ex = DestinationExecutor({"openpose": make_openpose_library(P.OpenPoseLite(), device="cpu")},
                             name=name, device="cpu")
    rt = HostRuntime(DirectChannel(ex))
    return ex, rt, AvecSession(P.OpenPoseLite(), params, rt, "openpose")


# ---------------------------------------------------------------------------
# interception
# ---------------------------------------------------------------------------

def application(params, frames):
    """Unmodified application code: calls the library by module attribute."""
    out = P.op_forward(P.OpenPoseLite(), params, {"frames": frames})
    beliefs = torch.from_numpy(np.array(out["beliefs"]))
    return beliefs, P.render_pose(frames, beliefs)


@pytest.mark.parametrize("legacy", [False, True], ids=["argspec", "positional"])
def test_interception_no_source_modification(openpose_weights, legacy):
    """An application module calling the port's openpose functions is
    rerouted without any change to its own code; render_pose stays on the
    host, timed as "other"."""
    net, params = openpose_weights
    ex, rt, sess = _openpose_session(params)
    frames = P.make_frames(1, 32, 32)
    want = np.asarray(R.op_forward(net, params, frames.numpy()))
    orig = P.op_forward
    if legacy:
        with pytest.warns(DeprecationWarning, match="ArgSpec"):
            disp = sess.make_dispatcher({"op_forward": "forward"})
    else:
        disp = sess.make_argspec_dispatcher({"op_forward": ("forward", ArgSpec(position=2))})
    with InterceptionLibrary(P, ["op_forward", "render_pose"], disp):
        assert P.op_forward.__wrapped__ is orig
        beliefs, rendered = application(params, frames)
    assert P.op_forward is orig and not hasattr(P.op_forward, "__wrapped__")
    assert beliefs.shape == want.shape and rendered.shape == frames.shape
    assert np.abs(beliefs.numpy() - want).max() <= TOL * np.abs(want).max()
    assert len(sess.profiler.cycles) == 1 and sess.profiler.other_s > 0
    assert sess.profiler.cycles[0].bytes_sent > frames.numel() * 4
    ex.shutdown()


def test_library_imported_inside_intercepted_block(openpose_weights):
    """A destination whose library module is first executed while the
    application's ``op_forward`` is intercepted still runs the backbone
    itself: no cycle goes back through the session."""
    net, params = openpose_weights
    ex, rt, sess = _openpose_session(params)
    frames = P.make_frames(1, 32, 32)
    want = P.op_forward(P.OpenPoseLite(), from_numpy_tree(params, "cpu"), frames)
    disp = sess.make_argspec_dispatcher({"op_forward": ("forward", ArgSpec(position=2))})
    with InterceptionLibrary(P, ["op_forward"], disp):
        spec = importlib.util.find_spec("repro_torch.core.library")
        fresh = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(fresh)
        lib = fresh.make_openpose_library(P.OpenPoseLite(), device="cpu")
        got = lib["forward"](from_numpy_tree(params, "cpu"), {}, {"frames": frames})["beliefs"]
    assert torch.equal(got, want)
    assert len(sess.profiler.cycles) == 0
    ex.shutdown()


def test_remote_error_propagates(openpose_weights):
    _, params = openpose_weights
    ex, rt, sess = _openpose_session(params)
    sess.ensure_model()
    ex.fail = True
    with pytest.raises(RemoteError):
        sess.call("forward", {"frames": P.make_frames(1, 16, 16)})
    ex.fail = False
    assert sess.call("forward", {"frames": P.make_frames(1, 16, 16)})["beliefs"].shape == \
        (1, 2, 2, 57)
    ex.shutdown()


# ---------------------------------------------------------------------------
# profiler
# ---------------------------------------------------------------------------

def test_profiler_accounting_sums_match_reference():
    ref, port = RefProfiler(), AvecProfiler()
    records = [(0.10, 0.05, 100, 50, "forward"), (0.125, 0.0375, 3_760_000, 1_100_000, "x"),
               (0.0, 0.01, 7, 0, "")]
    for p in (ref, port):
        for r in records:
            p.record_cycle(*r)
        p.record_other(0.1)
        p.record_model_transfer(0.25)
    assert port.breakdown() == ref.breakdown()
    assert port.per_cycle() == ref.per_cycle()
    assert port.fps() == ref.fps() and port.fps(10) == ref.fps(10)
    b = port.breakdown()
    assert abs(b["gpu_frac"] + b["communication_frac"] + b["other_frac"] - 1.0) < 1e-9


# ---------------------------------------------------------------------------
# cost model and the split search
# ---------------------------------------------------------------------------

PAIRS = list(itertools.product(("device", "edge", "cloud"), repeat=2))


def _workload(mod, host_other_s=0.18):
    return mod.Workload("openpose", flops=WORKLOAD.forward_flops,
                        bytes_out=WORKLOAD.data_transfer_bytes() * 0.999,
                        bytes_back=WORKLOAD.data_transfer_bytes() * 0.001,
                        host_other_s=host_other_s, model_bytes=WORKLOAD.model_weight_bytes)


def test_presets_are_the_papers():
    assert {k: dataclasses.asdict(v) for k, v in PAPER_TESTBED.items()} == \
        {k: dataclasses.asdict(v) for k, v in REF_TESTBED.items()}


@pytest.mark.parametrize("host,dst", PAIRS)
def test_costmodel_equals_reference(host, dst):
    h, d = PAPER_TESTBED[host], PAPER_TESTBED[dst]
    rh, rd = REF_TESTBED[host], REF_TESTBED[dst]
    w, rw = _workload(C), _workload(RC)
    assert C.compute_time(w.flops, d) == RC.compute_time(rw.flops, rd)
    assert C.comm_time(w.bytes_out, d) == RC.comm_time(rw.bytes_out, rd)
    assert C.cycle_comm_time(w, d) == RC.cycle_comm_time(rw, rd)
    assert C.native_cycle_time(w, h) == RC.native_cycle_time(rw, rh)
    assert C.offload_cycle_time(w, d) == RC.offload_cycle_time(rw, rd)
    assert C.speedup(w, h, d) == RC.speedup(rw, rh, rd)
    assert C.model_transfer_time(w.model_bytes, d) == RC.model_transfer_time(rw.model_bytes, rd)
    for cycles in (1, 10, 1000):
        assert C.amortized_speedup(w, h, d, cycles) == RC.amortized_speedup(rw, rh, rd, cycles)
    for inflight in (0, 3):
        assert C.estimate_request_time(w, d, inflight, 0.5) == \
            RC.estimate_request_time(rw, rd, inflight, 0.5)


def test_costmodel_paper_band():
    w = _workload(C)
    s_edge = C.speedup(w, JETSON_NANO, JETSON_TX2)
    s_cloud = C.speedup(w, JETSON_NANO, CLOUD_RTX)
    assert s_cloud > s_edge > 1.0
    assert 1.1 < s_edge < 2.2                 # paper Table IV (video): 1.45x edge
    assert 4.0 < s_cloud < 11.0               # and 7.48x cloud
    a10 = C.amortized_speedup(w, JETSON_NANO, CLOUD_RTX, 10)
    a1000 = C.amortized_speedup(w, JETSON_NANO, CLOUD_RTX, 1000)
    assert a10 < a1000 <= s_cloud * 1.001


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("host,dst", [("device", "edge"), ("device", "cloud"), ("edge", "cloud")])
def test_best_split_equals_reference(seed, host, dst):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 12))
    flops = rng.uniform(1e8, 4e10, n)
    outb = rng.uniform(1e4, 8e6, n)
    layers = [O.LayerProfile(f"l{i}", float(f), float(b)) for i, (f, b) in enumerate(zip(flops, outb))]
    ref_layers = [RO.LayerProfile(f"l{i}", float(f), float(b))
                  for i, (f, b) in enumerate(zip(flops, outb))]
    inp, res = float(rng.uniform(1e5, 4e6)), float(rng.uniform(1e4, 2e6))
    got = O.best_split(layers, inp, res, PAPER_TESTBED[host], PAPER_TESTBED[dst])
    assert got == RO.best_split(ref_layers, inp, res, REF_TESTBED[host], REF_TESTBED[dst])
    for k in range(n + 1):
        assert O.split_time(layers, k, inp, res, PAPER_TESTBED[host], PAPER_TESTBED[dst]) == \
            RO.split_time(ref_layers, k, inp, res, REF_TESTBED[host], REF_TESTBED[dst])


# ---------------------------------------------------------------------------
# scheduler + hedging
# ---------------------------------------------------------------------------

def test_scheduler_picks_best_and_respects_memory():
    regs = (AcceleratorRegistry(), RefRegistry())
    for reg in regs:
        reg.register(JETSON_TX2)
        reg.register(CLOUD_RTX)
    sched, ref = DeviceAwareScheduler(regs[0]), RefScheduler(regs[1])
    w = Workload("w", flops=160e9, bytes_out=3.7e6, bytes_back=1e6, model_bytes=5.5e9)
    rw = RC.Workload("w", flops=160e9, bytes_out=3.7e6, bytes_back=1e6, model_bytes=5.5e9)
    w_big = Workload("big", flops=1e9, bytes_out=1e6, bytes_back=1e6, model_bytes=7e9)
    rw_big = RC.Workload("big", flops=1e9, bytes_out=1e6, bytes_back=1e6, model_bytes=7e9)

    def both(load):
        for reg in regs:
            reg.get("cloud-rtx").inflight = load
        picks = [sched.pick(w).name, sched.pick(w_big).name]
        assert picks == [ref.pick(rw).name, ref.pick(rw_big).name]
        assert [s for _, s in sched.scored_candidates(w)] == \
            [s for _, s in ref.scored_candidates(rw)]
        return picks

    assert both(0) == ["cloud-rtx", "jetson-tx2"]    # 8 GB edge fits, 6 GB rtx not
    assert both(50) == ["jetson-tx2", "jetson-tx2"]  # load shifts the decision
    regs[0].mark_unhealthy("jetson-tx2")
    from repro_torch.core.scheduler import NoDestinationError
    with pytest.raises(NoDestinationError):
        sched.pick(w_big)


@pytest.mark.parametrize("order", ["slow_first", "fast_first"])
def test_hedged_call_straggler(order):
    def slow():
        time.sleep(1.0)
        return "slow"

    def fast():
        return "fast"

    if order == "slow_first":
        assert hedged_call(slow, fast, hedge_after_s=0.05) == ("fast", "backup")
    else:
        assert hedged_call(fast, slow, hedge_after_s=5.0) == ("fast", "primary")


# ---------------------------------------------------------------------------
# migration / failover
# ---------------------------------------------------------------------------

def test_failover_preserves_decode_stream():
    """The destination dies mid-stream; the session fails over to a second
    executor restoring the shadowed KV state, and the continuation equals an
    uninterrupted run bit for bit."""
    cfg = tconfigs.reduced(tconfigs.get_arch("granite-3-2b"))
    params = M.init_params(cfg, 0, device="cpu")
    executors = {n: DestinationExecutor({"lm": make_model_library(cfg, 32, device="cpu")},
                                        name=n, device="cpu")
                 for n in ("edge-a", "edge-b", "steady")}
    reg = AcceleratorRegistry()
    for n in ("edge-a", "edge-b"):
        reg.register(dataclasses.replace(JETSON_TX2, name=n))

    def rt_factory(name):
        return HostRuntime(DirectChannel(executors[name]))

    mgr = MigrationManager(reg, DeviceAwareScheduler(reg), rt_factory)
    sess = AvecSession(cfg, params, rt_factory("edge-a"), "lm")
    steady = AvecSession(cfg, params, rt_factory("steady"), "lm")
    shadow = SessionShadow(every_n_calls=1)
    tok = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 6)).astype(np.int32)

    def decode(s, t):
        return np.array(s.call("decode", {"tokens": np.asarray([[t]], np.int32)})["logits"])

    lg = [np.array(s.call("prefill", {"tokens": tok})["logits"]) for s in (sess, steady)]
    np.testing.assert_array_equal(lg[0], lg[1])
    nxt = int(np.argmax(lg[0][0, -1, :cfg.vocab_size]))
    shadow.force_snapshot(sess, step=0)
    a, b = decode(sess, nxt), decode(steady, nxt)
    np.testing.assert_array_equal(a, b)
    assert shadow.maybe_snapshot(sess, step=1)
    executors["edge-a"].fail = True
    w = Workload("lm", flops=1e9, bytes_out=1e4, bytes_back=1e4, model_bytes=1e6)
    assert mgr.failover(sess, w, failed_name="edge-a", shadow=shadow) == "edge-b"
    nxt = int(np.argmax(a[0, 0, :cfg.vocab_size]))
    for _ in range(2):
        a, b = decode(sess, nxt), decode(steady, nxt)
        np.testing.assert_array_equal(a, b)
        nxt = int(np.argmax(a[0, 0, :cfg.vocab_size]))
    assert mgr.migrations[0]["from"] == "edge-a" and mgr.migrations[0]["to"] == "edge-b"
    assert reg.get("edge-a").quarantined and not reg.get("edge-a").healthy
    for ex in executors.values():
        ex.shutdown()


def test_heartbeat_detects_failure_and_recovery(openpose_weights):
    _, params = openpose_weights
    ex, rt, _ = _openpose_session(params, name="hb-dest")
    reg = AcceleratorRegistry()
    reg.register(dataclasses.replace(JETSON_TX2, name="hb-dest"))
    failed, recovered = threading.Event(), threading.Event()
    mon = HeartbeatMonitor(rt, "hb-dest", reg, interval_s=0.01, misses=2, timeout_s=5.0,
                           on_failure=lambda n: failed.set(),
                           on_recovery=lambda n: recovered.set()).start()
    try:
        deadline = time.monotonic() + 30
        while mon.stats()["pings"] < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert mon.stats()["pings"] >= 2 and not failed.is_set()
        ex.fail = True
        assert failed.wait(timeout=30)
        assert not reg.get("hb-dest").healthy
        ex.fail = False
        assert recovered.wait(timeout=30)
        assert reg.get("hb-dest").healthy and mon.stats()["flaps"] == 1
    finally:
        mon.stop()
        mon._thread.join(timeout=30)
    assert not mon._thread.is_alive()
    ex.shutdown()


# ---------------------------------------------------------------------------
# ArgSpec extraction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec,args,kwargs", [
    (dict(position=2), ("net", "params"), {}),
    (dict(keywords=("tokens",)), (), {"junk": 2}),
    (dict(), (1, 2, 3), {}),
], ids=["position", "keywords", "empty"])
def test_argspec_mismatch_raises_as_reference(spec, args, kwargs):
    with pytest.raises(ArgExtractionError) as got:
        ArgSpec(**spec)("op_forward", args, kwargs)
    with pytest.raises(RefArgError) as want:
        RefArgSpec(**spec)("op_forward", args, kwargs)
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, TypeError)


def test_argspec_extraction_forms():
    assert ArgSpec(position=2)("f", (1, 2, {"x": 3}), {}) == {"x": 3}
    assert ArgSpec(keywords=("tokens",))("f", (), {"tokens": 1, "junk": 2}) == {"tokens": 1}
    assert ArgSpec(extract=lambda a, k: {"x": a[0]})("f", (7,), {}) == {"x": 7}
    with pytest.raises(TypeError, match="ArgSpec"):
        AvecSession.make_argspec_dispatcher(None, {"f": ("forward", "not a spec")})


def test_intercepted_call_that_misses_its_argspec_raises(openpose_weights):
    _, params = openpose_weights
    ex, rt, sess = _openpose_session(params)
    disp = sess.make_argspec_dispatcher({"op_forward": ("forward", ArgSpec(position=2))})
    with InterceptionLibrary(P, ["op_forward"], disp):
        with pytest.raises(ArgExtractionError, match="op_forward"):
            P.op_forward(P.OpenPoseLite(), params)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        legacy = sess.make_dispatcher({"fn": "forward"})
    with pytest.raises(ArgExtractionError, match="positional convention"):
        legacy("fn", lambda *a, **k: None, "cfg", "params")
    assert sess.profiler.cycles == []
    ex.shutdown()
