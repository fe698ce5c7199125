"""Mixed fleets over real TCP sockets: a JAX-package host drives a port
destination (on the CPU) and gets what a JAX-package destination returns; a
port snapshot restores into a JAX-package destination; a port host drives a
JAX-package destination.  The same for reduced mamba2-130m, whose session
state is a conv window and an SSM state instead of a KV cache.  Then
OpenPose-lite, the paper's workload: JAX-package hosts, synchronous and
pipelined, drive a port destination; the port's pipelined host drives
JAX-package destinations; both packages' sessions agree on the fingerprint.
Last, the other families: a JAX-package host drives a port destination
serving a MoE (moonshot) and a VLM (llama-3.2-vision, its vision rows sent
with every call), and the port's host drives a JAX-package destination
serving whisper (frames with the prefill and the score).

Tolerance 1e-4 on float32 logits and loss (the reference's own
cache-consistency bound is 2e-3); OpenPose beliefs within 1e-5·max|ref|."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.core.executor import DestinationExecutor as RefDest
from repro.core.executor import HostRuntime as RefHost
from repro.core.executor import PipelinedHostRuntime as RefPipelined
from repro.core.interception import AvecSession as RefSession
from repro.core.library import make_model_library as ref_library
from repro.core.library import make_openpose_library as ref_openpose_library
from repro.core.transport import TCPChannel as RefChannel
from repro.core.transport import TCPServer as RefServer
from repro.models import model as RM
from repro.models import openpose as ROP
from repro.models.params import init_params as ref_init_params
from repro_torch import configs as tconfigs
from repro_torch.core.cache import model_fingerprint
from repro_torch.core.executor import DestinationExecutor, HostRuntime, PipelinedHostRuntime
from repro_torch.core.interception import AvecSession
from repro_torch.core.library import make_model_library, make_openpose_library
from repro_torch.core.transport import TCPChannel, TCPServer
from repro_torch.models import openpose as TOP
from repro_torch.models.params import from_numpy_tree

ARCH = "granite-3-2b"
CACHE, B, S = 32, 2, 8
TOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    cfg = reduced(get_arch(ARCH))
    tcfg = tconfigs.reduced(tconfigs.get_arch(ARCH))
    params = jax.tree_util.tree_map(np.asarray, RM.init_params(cfg, jax.random.PRNGKey(0)))
    fp = model_fingerprint(tcfg, from_numpy_tree(params, "cpu"))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S + 4)).astype(np.int32)
    return cfg, tcfg, params, fp, toks


class _Node:
    """A destination behind a TCP server, with a host connected to it."""

    def __init__(self, dest, server_cls, host_cls, channel_cls):
        self.dest = dest
        self.server = server_cls(dest.handle).start()
        self.host = host_cls(channel_cls.connect("127.0.0.1", self.server.port))

    def close(self):
        self.host.close()
        self.server.stop()
        self.dest.shutdown()


def _ref_dest(cfg):
    return RefDest({"lm": ref_library(cfg, CACHE)}, name="jax-dest")


def _port_dest(tcfg):
    return DestinationExecutor({"lm": make_model_library(tcfg, CACHE, device="cpu")},
                               name="torch-dest", device="cpu")


def _drive(host, fp, params, toks):
    assert host.ping()["ok"]
    host.put_model(fp, "lm", params)
    out = [np.array(host.run(fp, "prefill", {"tokens": toks[:, :S]})["logits"])]
    for i in range(3):
        out.append(np.array(host.run(fp, "decode", {"tokens": toks[:, S + i:S + i + 1]})["logits"]))
    tgt = np.roll(toks[:, :S], -1, axis=1)
    out.append(np.array(host.run(fp, "score", {"tokens": toks[:, :S], "targets": tgt})["loss"]))
    return out


def test_reference_host_drives_port_destination(setup):
    cfg, tcfg, params, fp, toks = setup
    ref = _Node(_ref_dest(cfg), RefServer, RefHost, RefChannel)
    port = _Node(_port_dest(tcfg), TCPServer, RefHost, RefChannel)
    try:
        want = _drive(ref.host, fp, params, toks)
        got = _drive(port.host, fp, params, toks)
        assert port.host.has_model(fp)
        for a, b in zip(got, want):
            assert a.shape == b.shape and a.dtype == b.dtype == np.float32
            np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)
    finally:
        ref.close()
        port.close()


def test_port_snapshot_restores_into_reference_destination(setup):
    cfg, tcfg, params, fp, toks = setup
    port = _Node(_port_dest(tcfg), TCPServer, RefHost, RefChannel)
    ref = _Node(_ref_dest(cfg), RefServer, RefHost, RefChannel)
    try:
        for node in (port, ref):
            node.host.put_model(fp, "lm", params)
        port.host.run(fp, "prefill", {"tokens": toks[:, :S]})
        snap = port.host.snapshot(fp)
        assert int(np.asarray(snap["pos"])) == S
        assert str(snap["cache"]["layers"][0]["k"].dtype) == "float32"
        ref.host.restore(fp, snap)
        for i in range(2):
            nt = {"tokens": toks[:, S + i:S + i + 1]}
            a = np.array(port.host.run(fp, "decode", nt)["logits"])
            b = np.array(ref.host.run(fp, "decode", nt)["logits"])
            np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)
    finally:
        port.close()
        ref.close()


def test_reference_snapshot_restores_into_port_destination(setup):
    cfg, tcfg, params, fp, toks = setup
    ref = _Node(_ref_dest(cfg), RefServer, RefHost, RefChannel)
    port = _Node(_port_dest(tcfg), TCPServer, RefHost, RefChannel)
    try:
        for node in (ref, port):
            node.host.put_model(fp, "lm", params)
        ref.host.run(fp, "prefill", {"tokens": toks[:, :S]})
        port.host.restore(fp, ref.host.snapshot(fp))
        nt = {"tokens": toks[:, S:S + 1]}
        np.testing.assert_allclose(np.array(port.host.run(fp, "decode", nt)["logits"]),
                                   np.array(ref.host.run(fp, "decode", nt)["logits"]),
                                   atol=TOL, rtol=TOL)
    finally:
        ref.close()
        port.close()


def test_port_host_drives_reference_destination(setup):
    cfg, tcfg, params, fp, toks = setup
    ref = _Node(_ref_dest(cfg), RefServer, HostRuntime, TCPChannel)
    try:
        info = ref.host.ping()
        assert info["ok"] and "put_model" in info["ops"]
        tparams = from_numpy_tree(params, "cpu")         # the port host sends tensors
        ref.host.put_model(fp, "lm", tparams)
        got = ref.host.run(fp, "prefill", {"tokens": torch.from_numpy(toks[:, :S])})["logits"]
        want = RM.prefill(cfg, jax.tree_util.tree_map(np.asarray, params),
                          {"tokens": toks[:, :S]}, CACHE)[0]
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL, rtol=TOL)
    finally:
        ref.close()


def test_port_destination_coalesces_batchable_runs(setup):
    """Two batchable ``hidden`` calls coalesce into one stacked dispatch and
    split back per request."""
    import threading

    _, tcfg, params, fp, toks = setup
    dest = DestinationExecutor({"lm": make_model_library(tcfg, CACHE, device="cpu")},
                               device="cpu", coalesce=True, coalesce_window_s=0.5,
                               max_coalesce=2)
    server = TCPServer(dest.handle).start()
    hosts = [HostRuntime(TCPChannel.connect("127.0.0.1", server.port)) for _ in range(2)]
    try:
        hosts[0].put_model(fp, "lm", params)
        outs = [None, None]

        def call(i):
            outs[i] = np.array(hosts[i].run(fp, "hidden", {"tokens": toks[i:i + 1, :S]},
                                            batchable=True)["hidden"])

        threads = [threading.Thread(target=call, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert dest.coalesce_stats["max_batch"] == 2
        alone = np.array(hosts[0].run(fp, "hidden", {"tokens": toks[:2, :S]})["hidden"])
        np.testing.assert_allclose(np.concatenate(outs), alone, atol=1e-6)
    finally:
        for h in hosts:
            h.close()
        server.stop()
        dest.shutdown()


def test_destination_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DestinationExecutor({}, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_model_library(tconfigs.get_arch(ARCH))


# ---------------------------------------------------------------------------
# mamba2-130m: the SSM family behind the same executor
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mamba_setup():
    cfg = reduced(get_arch("mamba2-130m"))
    tcfg = tconfigs.reduced(tconfigs.get_arch("mamba2-130m"))
    params = jax.tree_util.tree_map(np.asarray, RM.init_params(cfg, jax.random.PRNGKey(0)))
    fp = model_fingerprint(tcfg, from_numpy_tree(params, "cpu"))
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S + 4)).astype(np.int32)
    return cfg, tcfg, params, fp, toks


def test_reference_host_drives_port_mamba_destination(mamba_setup):
    cfg, tcfg, params, fp, toks = mamba_setup
    ref = _Node(_ref_dest(cfg), RefServer, RefHost, RefChannel)
    port = _Node(_port_dest(tcfg), TCPServer, RefHost, RefChannel)
    try:
        want = _drive(ref.host, fp, params, toks)
        got = _drive(port.host, fp, params, toks)
        assert port.host.has_model(fp)
        for a, b in zip(got, want):
            assert a.shape == b.shape and a.dtype == b.dtype == np.float32
            np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)
    finally:
        ref.close()
        port.close()


@pytest.mark.parametrize("direction", ["port_to_reference", "reference_to_port"])
def test_mamba_snapshot_restores_across_packages(mamba_setup, direction):
    """A mamba session (conv window + fp32 SSM state) snapshotted on one
    package's destination restores into the other's and decodes the same."""
    cfg, tcfg, params, fp, toks = mamba_setup
    port = _Node(_port_dest(tcfg), TCPServer, RefHost, RefChannel)
    ref = _Node(_ref_dest(cfg), RefServer, RefHost, RefChannel)
    src, dst = (port, ref) if direction == "port_to_reference" else (ref, port)
    try:
        for node in (src, dst):
            node.host.put_model(fp, "lm", params)
        src.host.run(fp, "prefill", {"tokens": toks[:, :S]})
        snap = src.host.snapshot(fp)
        assert int(np.asarray(snap["pos"])) == S
        layer = snap["cache"]["layers"][0]
        assert sorted(layer) == ["conv", "ssm"] and str(layer["ssm"].dtype) == "float32"
        dst.host.restore(fp, snap)
        for i in range(2):
            nt = {"tokens": toks[:, S + i:S + i + 1]}
            a = np.array(src.host.run(fp, "decode", nt)["logits"])
            b = np.array(dst.host.run(fp, "decode", nt)["logits"])
            np.testing.assert_allclose(b, a, atol=TOL, rtol=TOL)
    finally:
        port.close()
        ref.close()


# ---------------------------------------------------------------------------
# OpenPose-lite, the paper's workload, and the pipelined runtimes
# (beliefs within 1e-5·max|ref|: float32 convolutions in another order)
# ---------------------------------------------------------------------------

OP_TOL = 1e-5


@pytest.fixture(scope="module")
def openpose_setup():
    net = ROP.OpenPoseLite()
    params = jax.tree_util.tree_map(
        np.asarray, ref_init_params(ROP.op_param_specs(net), jax.random.PRNGKey(4), jax.numpy.float32))
    fp = model_fingerprint(TOP.OpenPoseLite(), params)
    frames = [np.asarray(ROP.make_frames(1, 368, 656, seed=5)),
              np.asarray(ROP.make_frames(2, 45, 77, seed=6))]
    return net, params, fp, frames


def _op_ref_dest(net):
    return RefDest({"openpose": ref_openpose_library(net)}, name="jax-op")


def _op_port_dest():
    return DestinationExecutor({"openpose": make_openpose_library(TOP.OpenPoseLite(), device="cpu")},
                               name="torch-op", device="cpu")


def _forward_all(host, fp, params, frames, pipelined):
    host.put_model(fp, "openpose", params)
    if pipelined:
        futs = [host.run_async(fp, "forward", {"frames": f}) for f in frames]
        return [np.array(host.wait(f, timeout=120)[1]["beliefs"]) for f in futs]
    return [np.array(host.run(fp, "forward", {"frames": f})["beliefs"]) for f in frames]


@pytest.mark.parametrize("host_cls", [RefHost, RefPipelined], ids=["sync", "pipelined"])
def test_reference_host_drives_port_openpose_destination(openpose_setup, host_cls):
    net, params, fp, frames = openpose_setup
    ref = _Node(_op_ref_dest(net), RefServer, RefHost, RefChannel)
    port = _Node(_op_port_dest(), TCPServer, host_cls, RefChannel)
    try:
        want = _forward_all(ref.host, fp, params, frames, pipelined=False)
        got = _forward_all(port.host, fp, params, frames, pipelined=host_cls is RefPipelined)
        assert port.host.has_model(fp)
        for a, b in zip(got, want):
            assert a.shape == b.shape and a.dtype == b.dtype == np.float32
            assert np.abs(a - b).max() <= OP_TOL * np.abs(b).max()
    finally:
        ref.close()
        port.close()


def test_port_pipelined_host_drives_reference_destinations(setup, openpose_setup):
    """The port's pipelined runtime against a JAX-package destination: the
    dense LM (prefill, decodes, score) and OpenPose-lite."""
    cfg, tcfg, params, fp, toks = setup
    ref = _Node(_ref_dest(cfg), RefServer, PipelinedHostRuntime, TCPChannel)
    net, op_params, op_fp, frames = openpose_setup
    op_ref = _Node(_op_ref_dest(net), RefServer, PipelinedHostRuntime, TCPChannel)
    sync = _Node(_ref_dest(cfg), RefServer, RefHost, RefChannel)
    try:
        got = _drive(ref.host, fp, params, toks)
        want = _drive(sync.host, fp, params, toks)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)              # the same destination code
        beliefs = _forward_all(op_ref.host, op_fp, from_numpy_tree(op_params, "cpu"), frames,
                               pipelined=True)
        for f, a in zip(frames, beliefs):
            b = np.asarray(ROP.op_forward(net, op_params, f))
            assert np.abs(a - b).max() <= OP_TOL * np.abs(b).max()
        s = op_ref.host.stats()
        assert s["requests_completed"] == 1 + len(frames) and s["in_flight"] == 0
    finally:
        ref.close()
        op_ref.close()
        sync.close()


def test_sessions_agree_on_the_openpose_fingerprint(openpose_setup):
    net, params, fp, _ = openpose_setup
    ref = RefSession(net, params, None, "openpose")
    port = AvecSession(TOP.OpenPoseLite(), params, None, "openpose")
    port_t = AvecSession(TOP.OpenPoseLite(), from_numpy_tree(params, "cpu"), None, "openpose")
    assert ref.fp == port.fp == port_t.fp == fp


# ---------------------------------------------------------------------------
# the other families: MoE, cross-attention, encoder-decoder
# ---------------------------------------------------------------------------

def _family_setup(name, seed):
    cfg = reduced(get_arch(name))
    tcfg = tconfigs.reduced(tconfigs.get_arch(name))
    params = jax.tree_util.tree_map_with_path(        # non-zero cross gates (zeros at init)
        lambda path, x: np.full(x.shape, 0.7, x.dtype)
        if "cross_gate" in jax.tree_util.keystr(path) else np.asarray(x),
        RM.init_params(cfg, jax.random.PRNGKey(seed)))
    fp = model_fingerprint(tcfg, from_numpy_tree(params, "cpu"))
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 4)).astype(np.int32)
    extra = {}
    if cfg.family == "vlm":
        extra["vision"] = (0.5 * rng.standard_normal(
            (B, cfg.num_vision_tokens, cfg.d_model))).astype(np.float32)
    if cfg.family == "encdec":
        extra["frames"] = (0.5 * rng.standard_normal(
            (B, cfg.num_audio_frames, cfg.d_model))).astype(np.float32)
    return cfg, tcfg, params, fp, toks, extra


def _drive_family(host, fp, params, toks, extra):
    """_drive with the family's inputs: the vision rows ride every call,
    the frames the prefill and the score."""
    per_step = {k: v for k, v in extra.items() if k == "vision"}
    assert host.ping()["ok"]
    host.put_model(fp, "lm", params)
    out = [np.array(host.run(fp, "prefill", {"tokens": toks[:, :S], **extra})["logits"])]
    for i in range(3):
        out.append(np.array(host.run(fp, "decode", {"tokens": toks[:, S + i:S + i + 1],
                                                    **per_step})["logits"]))
    tgt = np.roll(toks[:, :S], -1, axis=1)
    out.append(np.array(host.run(fp, "score", {"tokens": toks[:, :S], "targets": tgt,
                                               **extra})["loss"]))
    return out


@pytest.mark.parametrize("name", ["moonshot-v1-16b-a3b", "llama-3.2-vision-90b"])
def test_reference_host_drives_port_moe_and_vlm_destinations(name):
    cfg, tcfg, params, fp, toks, extra = _family_setup(name, 2)
    ref = _Node(_ref_dest(cfg), RefServer, RefHost, RefChannel)
    port = _Node(_port_dest(tcfg), TCPServer, RefHost, RefChannel)
    try:
        want = _drive_family(ref.host, fp, params, toks, extra)
        got = _drive_family(port.host, fp, params, toks, extra)
        assert port.host.has_model(fp)
        for a, b in zip(got, want):
            assert a.shape == b.shape and a.dtype == b.dtype == np.float32
            np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)
    finally:
        ref.close()
        port.close()


def test_port_host_drives_reference_whisper_destination():
    """The port's host sends tensors to a JAX-package destination serving
    whisper; the same calls on a port destination give the same outputs."""
    cfg, tcfg, params, fp, toks, extra = _family_setup("whisper-medium", 3)
    ref = _Node(_ref_dest(cfg), RefServer, HostRuntime, TCPChannel)
    port = _Node(_port_dest(tcfg), TCPServer, HostRuntime, TCPChannel)
    try:
        tparams = from_numpy_tree(params, "cpu")
        got = _drive_family(ref.host, fp, tparams, toks, extra)
        want = _drive_family(port.host, fp, tparams, toks, extra)
        assert ref.host.has_model(fp)
        for a, b in zip(got, want):
            assert a.shape == b.shape and a.dtype == b.dtype == np.float32
            np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)
    finally:
        ref.close()
        port.close()
