"""Mixed fleets over real TCP sockets: a JAX-package host drives a port
destination (on the CPU) and gets what a JAX-package destination returns; a
port snapshot restores into a JAX-package destination; a port host drives a
JAX-package destination.

Tolerance 1e-4 on float32 logits and loss (the reference's own
cache-consistency bound is 2e-3)."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.core.executor import DestinationExecutor as RefDest
from repro.core.executor import HostRuntime as RefHost
from repro.core.library import make_model_library as ref_library
from repro.core.transport import TCPChannel as RefChannel
from repro.core.transport import TCPServer as RefServer
from repro.models import model as RM
from repro_torch import configs as tconfigs
from repro_torch.core.cache import model_fingerprint
from repro_torch.core.executor import DestinationExecutor, HostRuntime
from repro_torch.core.library import make_model_library
from repro_torch.core.transport import TCPChannel, TCPServer
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
