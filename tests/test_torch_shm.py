"""The port's shared-memory ring transport against the JAX package's.

The doorbell token, the hello and the ring layout are the reference's byte
for byte, so frames cross between the packages over ``shm://``: a port
channel talks to a JAX-package ``SharedMemoryServer`` and the reverse.  The
ring's own contract runs on the copy: the receiver's decoded leaves view the
sender's pages (bf16 leaves too), credits recycle the TX slabs, oversize
frames and an exhausted ring spill over the doorbell and recover, a dead
peer raises ``ChannelClosed`` at once, and the server unlinks its backing
file.  Through the port's facade: ``shm://`` endpoints negotiate the
pipelined runtime, a same-host TCP dial upgrades to the ring, and the
sharded map and the coalescer run over it (reduced granite-3-2b, float32,
on the CPU)."""
import gc
import os
import threading
import time

import jax
import ml_dtypes
import numpy as np
import pytest

from repro.configs import get_arch, reduced
from repro.core import shm as ref_shm
from repro.core.memory import release_buffer as ref_release
from repro.core.serialization import pack_message as ref_pack
from repro.core.serialization import unpack_message as ref_unpack
from repro.models import model as RM
from repro.obs.config import global_config as ref_config
from repro_torch import avec
from repro_torch import configs as tconfigs
from repro_torch.core import shm
from repro_torch.core.executor import DestinationExecutor, PipelinedHostRuntime
from repro_torch.core.library import make_model_library
from repro_torch.core.memory import PooledView, release_buffer
from repro_torch.core.serialization import pack_message, unpack_message
from repro_torch.core.shm import SharedMemoryChannel, SharedMemoryServer
from repro_torch.core.transport import ChannelClosed, TCPChannel, TCPServer
from repro_torch.obs.config import global_config
from repro_torch.utils import BF16Array, dtype_name


@pytest.fixture(scope="module")
def lm():
    cfg = tconfigs.reduced(tconfigs.get_arch("granite-3-2b"))
    params = jax.tree_util.tree_map(
        np.asarray, RM.init_params(reduced(get_arch("granite-3-2b")), jax.random.PRNGKey(0)))
    return cfg, params, make_model_library(cfg, max_cache_len=32, device="cpu")


def _dest(lib, name, **kw):
    return DestinationExecutor({"lm": lib}, name=name, device="cpu", **kw)


def _drained(outstanding_fn, deadline_s: float = 5.0) -> int:
    deadline = time.monotonic() + deadline_s
    while True:
        gc.collect()
        n = outstanding_fn()
        if n == 0 or time.monotonic() >= deadline:
            return n
        time.sleep(0.02)


# ---------------------------------------------------------------------------
# the wire layout and frames across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["_TOKEN_FMT", "_TOKEN_LEN", "_K_FRAME", "_K_CREDIT",
                                  "_K_SPILL", "_HELLO_FMT", "_HELLO_MAGIC", "_TX_SLABS",
                                  "shm_ring_bytes"])
def test_doorbell_hello_and_ring_layout_equal_reference(name):
    if name == "shm_ring_bytes":        # the ring size knob's default
        assert global_config().knob(name).default == ref_config().knob(name).default
        return
    assert getattr(shm, name) == getattr(ref_shm, name)


def _echo(pack, unpack):
    def handler(req):
        meta, tree = unpack(req)
        return pack({"ok": True, "echo": meta["tag"]},
                    {"y": np.asarray(tree["x"]) * 2.0, "h": tree["h"]},
                    request_id=meta.get("rid", 0))
    return handler


@pytest.mark.parametrize("direction", ["port_channel_to_reference_server",
                                       "reference_channel_to_port_server"])
def test_frames_cross_packages_over_shm(direction):
    """fp32 and bf16 leaves, ring-sized and spilled frames, both ways."""
    port_side = direction == "reference_channel_to_port_server"
    server_cls = SharedMemoryServer if port_side else ref_shm.SharedMemoryServer
    chan_cls = ref_shm.SharedMemoryChannel if port_side else SharedMemoryChannel
    s_pack, s_unpack = (pack_message, unpack_message) if port_side else (ref_pack, ref_unpack)
    c_pack, c_unpack = (ref_pack, ref_unpack) if port_side else (pack_message, unpack_message)
    c_release = ref_release if port_side else release_buffer
    bits = np.random.default_rng(0).integers(0, 1 << 15, 2048).astype(np.uint16)
    h = bits.view(ml_dtypes.bfloat16) if port_side else bits.view(BF16Array)
    server = server_cls(_echo(s_pack, s_unpack), ring_bytes=1 << 20).start()
    try:
        ch = chan_cls.connect(server.address, timeout=5)
        for tag, n in (("ring", 4096), ("spill", 200_000)):      # 800 KB > a 256 KiB slab
            x = np.arange(n, dtype=np.float32)
            ch.send(c_pack({"op": "run", "tag": tag}, {"x": x, "h": h}))
            resp = ch.recv(timeout=10)
            meta, tree = c_unpack(resp)
            assert meta["ok"] and meta["echo"] == tag
            np.testing.assert_array_equal(np.asarray(tree["y"]), x * 2.0)
            got = tree["h"]
            assert (str(got.dtype) if port_side else dtype_name(got)) == "bfloat16"
            assert np.array_equal(np.asarray(got).view(np.uint16), bits)
            del tree, got
            c_release(resp)
        assert ch.stats()["spills_sent"] == 1
        ch.close()
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# ring data path: zero-copy, credits, spills, peer death
# ---------------------------------------------------------------------------

def test_pair_roundtrip_is_zero_copy_over_shared_pages():
    """The receiver's decoded leaves (fp32 and bf16) view the pages the
    sender's TX lease wrote: a byte flipped through the lease shows up."""
    a, b = SharedMemoryChannel.pair(ring_bytes=1 << 20)
    try:
        x = np.arange(16384, dtype=np.float32)
        h = np.arange(512, dtype=np.uint16).view(BF16Array)
        a.send(pack_message({"op": "run", "seq": 1}, {"x": x, "h": h}))
        lease = b.recv(timeout=5)
        assert lease.pooled
        meta, tree = unpack_message(lease)
        assert meta["seq"] == 1 and isinstance(tree["x"], PooledView)
        assert isinstance(tree["h"], BF16Array) and isinstance(tree["h"].base, PooledView)
        np.testing.assert_array_equal(np.asarray(tree["x"]), x)
        np.testing.assert_array_equal(tree["h"].view(np.uint16), h.view(np.uint16))
        (tx_lease,) = a._outstanding.values()
        before = bytes(lease.view[-4:])
        tx_lease.view[-1] ^= 0xFF
        assert bytes(lease.view[-4:]) != before
        del tree, meta
        release_buffer(lease)
        assert _drained(b.recv_pool.outstanding) == 0
        a._poll_credits()
        assert a.stats()["tx_outstanding_frames"] == 0
        assert a.stats()["credits_received"] == 1
    finally:
        a.close()
        b.close()


def test_credits_recycle_tx_slabs_without_spilling():
    a, b = SharedMemoryChannel.pair(ring_bytes=256 * 1024)
    try:
        payload = np.random.default_rng(0).random(12000).astype(np.float32)
        for i in range(12):
            a.send(pack_message({"op": "run", "i": i}, {"x": payload}))
            lease = b.recv(timeout=5)
            _, tree = unpack_message(lease)
            np.testing.assert_array_equal(np.asarray(tree["x"]), payload)
            del tree
            release_buffer(lease)
            assert _drained(b.recv_pool.outstanding) == 0
        a._poll_credits()
        sa, sb = a.stats(), b.stats()
        assert sa["frames_sent"] == 12 and sb["frames_received"] == 12
        assert sa["spills_sent"] == 0 and sb["spills_received"] == 0
        assert sa["credits_received"] == 12 and sa["tx_outstanding_frames"] == 0
        assert sb["rx_pool"]["hit_rate"] == 1.0
    finally:
        a.close()
        b.close()


def test_oversize_frame_spills_over_doorbell_and_channel_survives():
    a, b = SharedMemoryChannel.pair(ring_bytes=64 * 1024)
    try:
        big = np.arange(20000, dtype=np.float32)
        a.send(pack_message({"op": "run"}, {"x": big}))
        got = b.recv(timeout=5)
        assert isinstance(got, bytearray)
        _, tree = unpack_message(got)
        np.testing.assert_array_equal(np.asarray(tree["x"]), big)
        assert a.stats()["spills_sent"] == 1 and b.stats()["spills_received"] == 1
        a.send(pack_message({"op": "run"}, {"x": np.arange(64, dtype=np.float32)}))
        lease = b.recv(timeout=5)
        assert lease.pooled
        release_buffer(lease)
    finally:
        a.close()
        b.close()


def test_ring_exhaustion_spills_then_recovers_on_credit():
    a, b = SharedMemoryChannel.pair(ring_bytes=64 * 1024)
    try:
        payload = np.zeros(2500, np.float32)
        held = []
        for _ in range(4):
            a.send(pack_message({"op": "run"}, {"x": payload}))
            held.append(b.recv(timeout=5))
        a.send(pack_message({"op": "run"}, {"x": payload}))
        assert isinstance(b.recv(timeout=5), bytearray)
        assert a.stats()["spills_sent"] == 1
        for lease in held:
            release_buffer(lease)
        a.send(pack_message({"op": "run"}, {"x": payload}))
        lease = b.recv(timeout=5)
        assert lease.pooled
        release_buffer(lease)
        sa = a.stats()
        assert sa["credits_received"] >= 4 and sa["spills_sent"] == 1
    finally:
        a.close()
        b.close()


def test_peer_close_wakes_blocked_recv_and_releases_tx_leases():
    a, b = SharedMemoryChannel.pair(ring_bytes=1 << 20)
    a.send(pack_message({"op": "run"}, {"x": np.zeros(1024, np.float32)}))
    errs, waiting = [], threading.Event()

    def blocked():
        waiting.set()
        t0 = time.monotonic()
        try:
            a.recv(timeout=30)
        except ChannelClosed:
            errs.append(time.monotonic() - t0)

    t = threading.Thread(target=blocked)
    t.start()
    assert waiting.wait(5)
    b.close()
    t.join(timeout=10)
    assert errs and errs[0] < 10.0           # woke on EOF, not the 30 s timeout
    assert a.stats()["tx_outstanding_frames"] == 0
    with pytest.raises(ChannelClosed):
        a.send(pack_message({"op": "run"}, None))
    a.close()


def test_server_request_response_and_backing_file_cleanup():
    server = SharedMemoryServer(_echo(pack_message, unpack_message)).start()
    try:
        ch = SharedMemoryChannel.connect(server.address, timeout=5)
        shm_path = ch.shm_path
        assert os.path.exists(shm_path)
        x = np.arange(4096, dtype=np.float32)
        h = np.zeros(8, np.uint16).view(BF16Array)
        for tag in ("one", "two"):
            ch.send(pack_message({"op": "run", "tag": tag}, {"x": x, "h": h}))
            resp = ch.recv(timeout=5)
            meta, tree = unpack_message(resp)
            assert meta["ok"] and meta["echo"] == tag
            np.testing.assert_array_equal(np.asarray(tree["y"]), x * 2.0)
            del tree
            release_buffer(resp)
        ch.close()
        deadline = time.monotonic() + 5
        while os.path.exists(shm_path) and time.monotonic() < deadline:
            time.sleep(0.02)
        assert not os.path.exists(shm_path)
        assert server.pool_stats()["outstanding"] == 0
    finally:
        server.stop()
    assert not os.path.exists(server.path)


# ---------------------------------------------------------------------------
# through the port's facade
# ---------------------------------------------------------------------------

def test_facade_shm_endpoint_negotiates_pipelined_runtime(lm):
    cfg, params, lib = lm
    server = SharedMemoryServer(_dest(lib, "shm-dest").handle).start()
    try:
        with avec.connect([f"shm://{server.address}"]) as client:
            name = client.destinations[0]
            rt = client.runtime(name)
            assert isinstance(rt, PipelinedHostRuntime)
            assert isinstance(rt.channel, SharedMemoryChannel)
            caps = client.capabilities(name)
            assert "int8" in caps.codecs and "fp16" in caps.codecs
            out = client.session(cfg, params, "lm").call(
                "prefill", {"tokens": np.zeros((1, 4), np.int32)})
            assert out["logits"].shape[0] == 1
    finally:
        server.stop()


def test_facade_auto_upgrades_same_host_tcp_to_shm(lm):
    cfg, params, lib = lm
    ex = _dest(lib, "dual-dest")
    server = TCPServer(ex.handle).start()
    shm_server = SharedMemoryServer(ex.handle).start()
    ex.shm_address = shm_server.address
    target = f"tcp://127.0.0.1:{server.port}"
    try:
        with avec.connect([target]) as client:
            name = client.destinations[0]
            assert isinstance(client.runtime(name).channel, SharedMemoryChannel)
            out = client.session(cfg, params, "lm").call(
                "prefill", {"tokens": np.zeros((1, 4), np.int32)})
            assert out["logits"].shape[0] == 1
        with avec.connect([target], prefer_shm=False) as client:
            assert isinstance(client.runtime(client.destinations[0]).channel, TCPChannel)
    finally:
        shm_server.stop()
        server.stop()


def test_sharded_map_and_coalescing_work_over_shm(lm):
    cfg, params, lib = lm
    srv = [SharedMemoryServer(_dest(lib, n, coalesce=True).handle).start()
           for n in ("shm-a", "shm-b")]
    rng = np.random.default_rng(0)
    reqs = {f"r{i}": {"tokens": rng.integers(0, cfg.vocab_size, (1, 8)).astype(np.int32),
                      "targets": rng.integers(0, cfg.vocab_size, (1, 8)).astype(np.int32)}
            for i in range(6)}
    try:
        with avec.connect([f"shm://{s.address}" for s in srv]) as client:
            assert all(client.capabilities(n).coalesce for n in client.destinations)
            sess = client.session(cfg, params, "lm")
            out = sess.map("score", reqs)
        assert sorted(sess.last_map_stats["assigned"].values()) == [3, 3]
        with avec.connect([_dest(lib, "ref")]) as ref_client:
            ref = ref_client.session(cfg, params, "lm").map("score", reqs)
        for rid in reqs:
            np.testing.assert_allclose(np.asarray(out[rid]["loss"]),
                                       np.asarray(ref[rid]["loss"]), rtol=1e-5)
    finally:
        for s in srv:
            s.stop()
