"""The port's pipelined host runtime and pooled receive buffers, on the CPU.

``PipelinedHostRuntime``: out-of-order completion matched by frame id,
results from a coalescing destination, the adaptive window's controller
(its trajectory must equal the JAX package's exactly for the same
observations), deadlock-free sends through shrunken socket buffers, and
pending futures failed when the channel closes.  ``repro_torch.core.memory``:
the ``BufferPool``/``BufferLease`` mechanics (the same traffic through the
reference's pool must leave the same counters) and the lease balance across
the pipelined and coalesced consumers.  Every wait has a generous limit of
its own; results are compared exactly (the destinations only move bytes)."""
import gc
import socket
import struct
import threading
import time

import numpy as np
import pytest

from repro.core.executor import _WindowController as RefWindowController
from repro.core.memory import BufferPool as RefBufferPool
from repro_torch.core.executor import (DestinationExecutor, HostRuntime,
                                       PipelinedHostRuntime, RemoteError,
                                       _WindowController)
from repro_torch.core.memory import (BufferLease, BufferPool, PooledView, detach_tree,
                                     release_buffer)
from repro_torch.core.serialization import frame_request_id, pack_message, unpack_message
from repro_torch.core.transport import (ChannelClosed, LoopbackChannel, TCPChannel,
                                        TCPServer, _recv_frame, _send_frame)

WAIT = 60.0


def _drained(outstanding_fn, deadline_s: float = 30.0) -> int:
    """Poll ``outstanding_fn`` to zero, letting the GC fire the leaf-view pin
    finalizers (futures can hold reference cycles)."""
    deadline = time.monotonic() + deadline_s
    while True:
        gc.collect()
        n = outstanding_fn()
        if n == 0 or time.monotonic() >= deadline:
            return n
        time.sleep(0.02)


def _tiny_library():
    def double(params, state, args):
        return {"y": args["x"] * 2.0}

    def slow(params, state, args):
        time.sleep(0.02)
        return {"y": args["x"] + 1.0}

    return {"double": double, "slow": slow}


def _tiny_dest(**kw):
    ex = DestinationExecutor({"tiny": _tiny_library()}, device="cpu", **kw)
    return ex, TCPServer(ex.handle).start()


def _shrunken_socketpair(bufsize: int = 8192):
    a, b = socket.socketpair()
    for s in (a, b):
        s.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, bufsize)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, bufsize)
    return a, b


def _serve(recv, send, n, reverse=False, compute_s=1e-4, fn=lambda x: x * 10.0):
    """A destination that answers ``n`` frames with ``fn(x)``: serially, or
    all read first and answered in reverse order."""
    def loop():
        try:
            reqs = []
            for _ in range(n):
                reqs.append(recv())
                if not reverse:
                    _answer(reqs.pop())
            for raw in reversed(reqs):
                _answer(raw)
        except (ChannelClosed, OSError):
            pass

    def _answer(raw):
        _, tree = unpack_message(raw)
        send(pack_message({"ok": True, "compute_s": compute_s},
                          {"y": fn(np.asarray(tree["x"]))}, request_id=frame_request_id(raw)))
        release_buffer(raw)

    t = threading.Thread(target=loop, daemon=True)
    t.start()
    return t


# ---------------------------------------------------------------------------
# PipelinedHostRuntime
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("link", ["loopback", "tcp"])
def test_pipelined_out_of_order_completion(link):
    """Responses are matched by request id when the destination answers in
    reverse order."""
    if link == "loopback":
        host_ch, dest_ch = LoopbackChannel.pair()
        t = _serve(lambda: dest_ch.recv(timeout=WAIT), dest_ch.send, 4, reverse=True)
    else:
        a, b = socket.socketpair()
        host_ch = TCPChannel(a)
        t = _serve(lambda: _recv_frame(b), lambda f: _send_frame(b, f), 4, reverse=True)
    rt = PipelinedHostRuntime(host_ch, max_in_flight=4, timeout=WAIT)
    futs = [rt.submit({"op": "noop"}, {"x": np.full(3, i, np.float32)}) for i in range(4)]
    for i, f in enumerate(futs):
        _, out = f.result(timeout=WAIT)
        np.testing.assert_array_equal(out["y"], np.full(3, 10.0 * i))
    t.join(timeout=WAIT)
    assert not t.is_alive()
    s = rt.stats()
    assert s["requests_completed"] == 4 and s["in_flight"] == 0
    rt.close()


def test_pipelined_against_coalescing_destination():
    """Three pipelined hosts on their own connections submit batchable runs
    at once to a coalescing destination; every future gets its own rows."""
    ex, server = _tiny_dest(coalesce=True, coalesce_window_s=0.05, max_coalesce=8)
    rts = [PipelinedHostRuntime(TCPChannel.connect("127.0.0.1", server.port),
                                max_in_flight=4, timeout=WAIT) for _ in range(3)]
    rts[0].put_model("fp", "tiny", {"w": np.zeros(1, np.float32)})
    outs, errors = {}, []
    barrier = threading.Barrier(3, timeout=WAIT)

    def client(c):
        try:
            barrier.wait()
            futs = {(c, i): rts[c].run_async("fp", "double", {"x": np.full((1, 3), 10 * c + i,
                                                                           np.float32)},
                                             batchable=True) for i in range(4)}
            for key, f in futs.items():
                outs[key] = f.result(timeout=WAIT)
        except Exception as e:  # noqa: BLE001 — surfaced by the assert below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
    assert not any(t.is_alive() for t in threads) and errors == []
    for (c, i), (meta, out) in outs.items():
        assert meta["ok"] and meta["coalesced"] >= 1
        np.testing.assert_array_equal(out["y"], np.full((1, 3), 2.0 * (10 * c + i)))
    assert ex.coalesce_stats["requests"] == 12
    for rt in rts:
        assert rt.stats()["requests_completed"] >= 4
        rt.close()
    server.stop()
    ex.shutdown()


def test_pipelined_window_errors_and_sync_ops():
    """Never more than the window outstanding; a remote error fails its own
    future and the channel goes on serving."""
    ex, server = _tiny_dest()
    rt = PipelinedHostRuntime(TCPChannel.connect("127.0.0.1", server.port), max_in_flight=3,
                              timeout=WAIT)
    assert rt.ping()["ok"]
    rt.put_model("fp", "tiny", {"w": np.zeros(1, np.float32)})
    futs, seen = [], []
    for i in range(8):
        futs.append(rt.run_async("fp", "slow", {"x": np.full(2, i, np.float32)}))
        seen.append(rt.in_flight())
    assert max(seen) <= 3
    for i, f in enumerate(futs):
        np.testing.assert_array_equal(rt.wait(f, timeout=WAIT)[1]["y"], np.full(2, i + 1.0))
    ex.fail = True
    bad = [rt.run_async("fp", "double", {"x": np.zeros(2, np.float32)}) for _ in range(2)]
    for f in bad:
        with pytest.raises(RemoteError):
            f.result(timeout=WAIT)
    ex.fail = False
    np.testing.assert_array_equal(rt.run("fp", "double", {"x": np.ones(2, np.float32)})["y"],
                                  np.full(2, 2.0))
    assert rt.in_flight() == 0 and rt.stats()["requests_completed"] == 13
    rt.close()
    server.stop()
    ex.shutdown()


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("cap", [1, 2, 4, 8])
def test_window_controller_trajectory_equals_reference(seed, cap):
    rng = np.random.default_rng(seed)
    port, ref = _WindowController(cap), RefWindowController(cap)
    assert port.window == ref.window == max(cap, 1)
    for _ in range(60):
        # compute-bound, link-bound and ~zero-compute stretches
        wire = float(rng.choice([1e-4, 5e-3, 0.1])) * float(rng.uniform(0.5, 1.5))
        compute = float(rng.choice([0.0, 1e-3, 0.05])) * float(rng.uniform(0.5, 1.5))
        assert port.observe(wire, compute) == ref.observe(wire, compute)
        assert (port.window, port.wire_ema, port.compute_ema, port.observations) == \
            (ref.window, ref.wire_ema, ref.compute_ema, ref.observations)


def test_window_controller_adapts_both_ways():
    wc = _WindowController(8)
    assert wc.window == 8           # fresh: no throttling before evidence
    for _ in range(10):
        wc.observe(wire_s=0.0005, compute_s=0.05)
    assert wc.window == 2           # compute-bound: double buffering
    for _ in range(30):
        wc.observe(wire_s=0.1, compute_s=0.001)
    assert wc.window == 8           # link-bound: grows back to the cap


def test_small_socket_buffer_sends_do_not_deadlock():
    """Window x frame bytes far above the socket buffering, against a serial
    (recv -> answer -> send) destination: a send that blocked without
    pumping receives would stall both ends; the resumable path parks the
    frame, drains responses and completes every request."""
    a, b = _shrunken_socketpair()
    t = _serve(lambda: _recv_frame(b), lambda f: _send_frame(b, f), 6, fn=lambda x: x + 1.0)
    rt = PipelinedHostRuntime(TCPChannel(a), max_in_flight=4, timeout=WAIT)
    xs = [np.full(128 * 1024, float(i), np.float32) for i in range(6)]     # 512 KB frames
    futs = [rt.submit({"op": "noop"}, {"x": x}) for x in xs]
    for x, f in zip(xs, futs):
        np.testing.assert_array_equal(rt.wait(f, timeout=WAIT)[1]["y"], x + 1.0)
    s = rt.stats()
    assert s["requests_completed"] == 6
    assert s["send_stalls"] > 0 and s["sends_resumed"] > 0   # the buffer really filled
    rt.close()
    t.join(timeout=WAIT)
    b.close()


def test_abandoned_partial_send_fails_channel():
    """A deadline that expires with a frame half written fails the channel:
    a later frame would otherwise be spliced into the torn one."""
    a, b = _shrunken_socketpair()        # the destination never reads
    rt = PipelinedHostRuntime(TCPChannel(a), max_in_flight=2, timeout=1.0)
    with pytest.raises(TimeoutError):
        rt.submit({"op": "noop"}, {"x": np.zeros(256 * 1024, np.float32)})
    assert rt.stats()["send_stalls"] > 0
    with pytest.raises(ChannelClosed):
        rt.submit({"op": "noop"}, {"x": np.zeros(4, np.float32)})
    rt.close()
    b.close()


@pytest.mark.parametrize("link", ["loopback", "tcp"])
def test_close_fails_pending_futures(link):
    if link == "loopback":
        host_ch, peer = LoopbackChannel.pair()          # nobody answers
    else:
        a, peer = socket.socketpair()
        host_ch = TCPChannel(a)
    rt = PipelinedHostRuntime(host_ch, max_in_flight=2, timeout=WAIT)
    futs = [rt.submit({"op": "ping"}), rt.submit({"op": "ping"})]
    rt.close()
    for f in futs:
        with pytest.raises(ChannelClosed):
            f.result(timeout=WAIT)
    with pytest.raises(ChannelClosed):
        rt.submit({"op": "ping"})
    peer.close()


def test_pump_retries_past_clean_channel_timeout():
    """A clean channel-level recv timeout does not expire a caller whose own
    deadline has not passed."""
    host_ch, dest_ch = LoopbackChannel.pair()

    def late():
        raw = dest_ch.recv(timeout=WAIT)
        time.sleep(0.6)                 # several runtime timeouts long
        dest_ch.send(pack_message({"ok": True}, None, request_id=frame_request_id(raw)))

    t = threading.Thread(target=late, daemon=True)
    t.start()
    rt = PipelinedHostRuntime(host_ch, max_in_flight=2, timeout=0.15)
    meta, _ = rt.wait(rt.submit({"op": "noop"}), timeout=WAIT)
    assert meta["ok"] and rt.stats()["recv_retries"] >= 1
    t.join(timeout=WAIT)
    rt.close()


# ---------------------------------------------------------------------------
# repro_torch.core.memory: pool mechanics
# ---------------------------------------------------------------------------

def test_pool_carve_wrap_and_recycle():
    pool = BufferPool(slab_bytes=100, slabs=2)
    a = pool.acquire(60)
    b = pool.acquire(30)            # same slab (60 + 30 <= 100)
    assert pool.stats()["slabs"] == 1 and pool.hits == 2
    c = pool.acquire(60)            # doesn't fit the tail: second slab
    assert pool.stats()["slabs"] == 2
    d = pool.acquire(60)            # both slabs pinned: counted fallback
    assert pool.miss_exhausted == 1 and not d.pooled
    a.release()
    b.release()
    e = pool.acquire(80)            # slab 0 fully released: wraps onto it
    assert e.pooled and pool.wraps >= 1
    for lease in (c, d, e):
        lease.release()
    assert pool.outstanding() == 0
    s = pool.stats()
    assert s["acquired"] == s["released"] == 5


def test_pool_oversize_and_lease_as_bytes():
    pool = BufferPool(slab_bytes=64, slabs=2)
    big = pool.acquire(1000)
    assert not big.pooled and pool.miss_oversize == 1 and len(big) == 1000
    big.view[:4] = b"abcd"
    assert bytes(big)[:4] == b"abcd"
    big.release()
    lease = pool.acquire(5)
    lease.view[:] = b"hello"
    assert bytes(lease) == b"hello" and lease.to_bytes() == b"hello"
    assert lease == b"hello" and lease[1] == b"hello"[1] and lease[::-1] == b"olleh"
    lease.release()
    assert pool.outstanding() == 0


def test_lease_refcounts_and_over_release():
    pool = BufferPool(slab_bytes=64, slabs=1)
    lease = pool.acquire(8)
    lease.retain()
    lease.release()
    assert pool.outstanding() == 1      # one ref left
    lease.release()
    assert pool.outstanding() == 0 and lease.released
    lease.release()                     # extra release: counted, not fatal
    assert pool.over_released == 1
    with pytest.raises(RuntimeError):
        lease.retain()                  # resurrection is a bug
    release_buffer(b"not a lease")      # no-op on plain buffers


@pytest.mark.parametrize("seed", range(4))
def test_pool_pattern_integrity_and_counters_match_reference(seed):
    """Under random acquire/release traffic every live lease's bytes stay
    intact, the pool balances, and the reference's pool driven by the same
    traffic ends with the same counters."""
    rng = np.random.default_rng(seed)
    pools = (BufferPool(slab_bytes=256, slabs=3), RefBufferPool(slab_bytes=256, slabs=3))
    live: list[tuple[list, bytes]] = []
    for _ in range(300):
        if live and rng.random() < 0.45:
            leases, pattern = live.pop(int(rng.integers(0, len(live))))
            for lease in leases:
                assert bytes(lease) == pattern
                lease.release()
        else:
            n = int(rng.integers(0, 300))   # includes oversize (>256)
            pattern = bytes(rng.integers(0, 256, n, dtype=np.uint8))
            leases = [p.acquire(n) for p in pools]
            assert leases[0].pooled == leases[1].pooled
            for lease in leases:
                lease.view[:] = pattern
            live.append((leases, pattern))
        for leases, pattern in live:
            assert bytes(leases[0]) == pattern
    for leases, pattern in live:
        for lease in leases:
            lease.release()
    assert pools[0].outstanding() == 0
    assert pools[0].stats() == pools[1].stats()


class _TrickleRecvSocket:
    """recv_into hands out a pseudo-random few bytes per call."""

    def __init__(self, wire: bytes, seed: int) -> None:
        self.wire = memoryview(wire)
        self.pos = 0
        self.rng = np.random.default_rng(seed)

    def recv_into(self, view, n):
        left = len(self.wire) - self.pos
        assert left > 0, "test read past the prepared wire"
        k = min(int(self.rng.integers(1, 7)), n, left)
        view[:k] = self.wire[self.pos:self.pos + k]
        self.pos += k
        return k


@pytest.mark.parametrize("seed", range(3))
def test_ring_wraparound_under_partial_reads(seed):
    rng = np.random.default_rng(seed)
    payloads = [bytes(rng.integers(0, 256, int(rng.integers(1, 90)), dtype=np.uint8))
                for _ in range(12)]
    sock = _TrickleRecvSocket(b"".join(struct.pack("<Q", len(p)) + p for p in payloads), seed)
    pool = BufferPool(slab_bytes=128, slabs=2)
    hdr = bytearray(8)
    held: list = []
    for payload in payloads:
        held.append((_recv_frame(sock, pool, hdr), payload))
        for h, p in held:
            assert bytes(h) == p
        if len(held) > 2:               # keep 2 pinned across wraps
            held.pop(0)[0].release()
    for h, p in held:
        assert bytes(h) == p
        h.release()
    s = pool.stats()
    assert pool.outstanding() == 0 and s["acquired"] == s["released"] == len(payloads)
    assert s["wraps"] >= 1


# ---------------------------------------------------------------------------
# decoded views pin their lease
# ---------------------------------------------------------------------------

def _leased_frame(pool, tree):
    frame = bytes(pack_message({"ok": True}, tree))
    lease = pool.acquire(len(frame))
    lease.view[:] = frame
    return lease


def test_unpack_views_pin_lease_until_collected():
    pool = BufferPool(slab_bytes=1024, slabs=1)
    lease = _leased_frame(pool, {"x": np.arange(16, dtype=np.float32)})
    _, out = unpack_message(lease)
    assert isinstance(out["x"], PooledView) and isinstance(lease, BufferLease)
    with pytest.raises(ValueError):
        out["x"][0] = 1.0               # decoded views are read-only
    sliced = np.asarray(out["x"]).reshape(4, 4)[1:3]     # a derived view keeps the pin
    lease.release()                     # the transport's base ref goes...
    assert pool.outstanding() == 1      # ...but the leaf view pins the slab
    blocked = pool.acquire(900)
    assert not blocked.pooled and pool.miss_exhausted == 1
    blocked.release()
    del out
    assert _drained(pool.outstanding, deadline_s=1.0) == 1
    np.testing.assert_array_equal(sliced[0], np.arange(4, 8))
    del sliced
    assert _drained(pool.outstanding) == 0
    assert pool.acquire(900).pooled     # the slab is reusable again


@pytest.mark.parametrize("how", ["copy", "detach_tree"])
def test_owning_copies_release_the_slab(how):
    pool = BufferPool(slab_bytes=1024, slabs=1)
    lease = _leased_frame(pool, {"x": np.arange(4, dtype=np.float32),
                                 "n": [np.ones(2, np.float32)], "t": (7, "s")})
    if how == "copy":
        _, out = unpack_message(lease, copy=True)
    else:
        _, views = unpack_message(lease)
        out = detach_tree(views)
        del views
    lease.release()
    assert _drained(pool.outstanding) == 0
    assert type(out["x"]) is np.ndarray and out["t"] == (7, "s")
    out["x"][0] = 5.0                   # owning and writable
    np.testing.assert_array_equal(out["n"][0], np.ones(2, np.float32))


# ---------------------------------------------------------------------------
# lease balance across the consumer layers
# ---------------------------------------------------------------------------

def test_pipelined_out_of_order_completion_balances_pool():
    """Every response lease is released once its future's result is
    dropped, with responses arriving out of order over TCP."""
    a, b = socket.socketpair()
    t = _serve(lambda: _recv_frame(b), lambda f: _send_frame(b, f), 6, reverse=True)
    rt = PipelinedHostRuntime(TCPChannel(a), max_in_flight=8, timeout=WAIT)
    pool = rt.channel.recv_pool
    futs = [rt.submit({"op": "noop"}, {"x": np.full(64, i, np.float32)}) for i in range(6)]
    for i, f in enumerate(futs):
        _, out = rt.wait(f, timeout=WAIT)
        np.testing.assert_array_equal(out["y"], np.full(64, 10.0 * i))
        del out
    del futs, f                 # futures hold their results (and pins)
    t.join(timeout=WAIT)
    assert _drained(pool.outstanding) == 0
    s = pool.stats()
    assert s["acquired"] == s["released"] == 6 and s["hit_rate"] == 1.0
    rt.close()
    b.close()


def test_coalesced_batch_dispatch_releases_server_leases():
    """Requests queued in the coalescer retain their receive lease past the
    connection loop's release and drop it after the batch dispatches."""
    ex, server = _tiny_dest(coalesce=True, coalesce_window_s=0.25, max_coalesce=8)
    rts = [HostRuntime(TCPChannel.connect("127.0.0.1", server.port), timeout=WAIT)
           for _ in range(4)]
    rts[0].put_model("fp", "tiny", {"w": np.zeros(1, np.float32)})
    results = [None] * 4
    barrier = threading.Barrier(4, timeout=WAIT)

    def worker(i):
        barrier.wait()
        results[i] = rts[i].run("fp", "double", {"x": np.full((1, 3), i, np.float32)},
                                batchable=True)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
    assert not any(t.is_alive() for t in threads)
    for i in range(4):
        np.testing.assert_array_equal(results[i]["y"], np.full((1, 3), 2.0 * i))
    assert ex.coalesce_stats["requests"] == 4
    assert _drained(lambda: server.pool_stats()["outstanding"]) == 0
    ps = server.pool_stats()
    assert ps["acquired"] == ps["released"] > 0 and ps["hits"] > 0
    for rt in rts:
        rt.close()
    server.stop()
    ex.shutdown()
