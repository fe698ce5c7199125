"""Microbenchmarks of the framework's own moving parts, the JAX package's
``benchmarks/micro.py``'s twin: wire serialization, transports, the kernels,
MoE dispatch, serving engine throughput, real loopback offload of
OpenPose-lite (the end-to-end AVEC cycle with real timing), and the data
plane's probes behind ``BENCH_dataplane.json``'s sections.

The benches and probes that compute on a device take ``device``: the card
(``"cuda"``) unless the caller asks for the CPU, with no quiet fallback.  The
host-side probes' destinations compute numpy stand-ins (a sleep, an
elementwise map), so their executors run on the CPU.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.obs import metrics as obs_metrics
from repro_torch.utils import resolve_device


def _runtime_metrics_snapshot(runtime) -> dict:
    """Flat scrape of the same bound metric views the /metrics listener
    serves (repro_torch.obs), recorded next to a section's raw stats so
    BENCH_dataplane.json shows the obs plane agreeing with the bench's own
    counters (window, send_stalls, pool hit ratio...)."""
    reg = obs_metrics.MetricsRegistry()
    obs_metrics.bind_runtime(reg, runtime)
    return reg.sample_values()


def _executor_metrics_snapshot(ex) -> dict:
    """Scrape of a destination executor's per-tenant metric views (drain
    share, served/throttled, queue depth) — what a Prometheus scrape of the
    destination would report at this instant."""
    reg = obs_metrics.MetricsRegistry()
    obs_metrics.bind_executor(reg, ex)
    return reg.sample_values()


def _time(fn, n: int = 5, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n


def _sync(device):
    """-> a function that waits for ``device`` to finish its queued work
    and passes its argument through (``jax.block_until_ready``'s
    counterpart: timed calls end on the device, not at the enqueue)."""
    dev = torch.device(device)

    def wait(out=None):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out
    return wait


def bench_serialization() -> list:
    from repro_torch.core.serialization import pack_message, unpack_message
    x = {"x": np.random.default_rng(0).standard_normal((512, 512))
         .astype(np.float32)}
    rows = []
    for codec in ("raw", "zstd", "int8"):
        data = pack_message({}, x, codec=codec)
        t_pack = _time(lambda: pack_message({}, x, codec=codec))
        t_unpack = _time(lambda: unpack_message(data))
        mbps = x["x"].nbytes / t_pack / 1e6
        rows.append((f"serialize/{codec}", t_pack * 1e6,
                     f"{mbps:.0f}MB/s wire={len(data)}B"))
        rows.append((f"deserialize/{codec}", t_unpack * 1e6, ""))
    return rows


def _seed_pack_emulation(meta: dict, tree) -> bytes:
    """The pre-vectored hot path, byte-for-byte: per-leaf ``tobytes()`` copy
    + one ``b"".join`` copy.  Kept as the baseline the zero-copy pack is
    measured against (BENCH_dataplane.json `serialize.seed_*`)."""
    import struct

    import msgpack

    from repro_torch.core.serialization import MAGIC, _flatten
    leaves = []
    tmpl = _flatten(tree, leaves)
    bufs = [np.ascontiguousarray(a).tobytes() for a in leaves]
    metas = [{"dtype": str(a.dtype), "shape": list(a.shape), "codec": "raw"}
             for a in leaves]
    header = msgpack.packb({"meta": meta, "template": tmpl, "leaves": metas,
                            "buf_lens": [len(b) for b in bufs]},
                           use_bin_type=True)
    return b"".join([MAGIC, struct.pack("<I", len(header)), header, *bufs])


def _serialize_timings(n: int = 50) -> dict:
    """Pack/unpack timings on the 512x512 f32 payload, shared by the CSV
    rows (bench_dataplane) and the JSON artifact (dataplane_report)."""
    from repro_torch.core.serialization import pack_message, unpack_message
    x = {"x": np.random.default_rng(0).standard_normal((512, 512))
         .astype(np.float32)}
    blob = bytes(pack_message({}, x))
    return {
        "nbytes": x["x"].nbytes,
        "t_vec": _time(lambda: pack_message({}, x), n=n),
        "t_seed": _time(lambda: _seed_pack_emulation({}, x), n=n),
        "t_view": _time(lambda: unpack_message(blob), n=n),
        "t_copy": _time(lambda: unpack_message(blob, copy=True), n=n),
    }


def bench_dataplane() -> list:
    """Zero-copy wire format micro numbers (the heavy pipelined-offload
    comparison lives in ``dataplane_report``)."""
    t = _serialize_timings()
    nb = t["nbytes"]
    return [
        ("dataplane/pack_raw_vectored", t["t_vec"] * 1e6,
         f"{nb / t['t_vec'] / 1e9:.1f}GB/s"),
        ("dataplane/pack_raw_seed_joined", t["t_seed"] * 1e6,
         f"{nb / t['t_seed'] / 1e9:.1f}GB/s "
         f"{t['t_seed'] / t['t_vec']:.1f}x slower"),
        ("dataplane/unpack_raw_view", t["t_view"] * 1e6,
         f"{nb / t['t_view'] / 1e9:.1f}GB/s"),
        ("dataplane/unpack_raw_copy", t["t_copy"] * 1e6,
         f"{nb / t['t_copy'] / 1e9:.1f}GB/s"),
    ]


_OPENPOSE_DESTINATION = r"""
import sys, os, threading
sys.path.insert(0, sys.argv[1])
# model the paper's topology: the destination is a separate machine with its
# own compute — keep it off the host's core so overlap has CPU to run on
n = os.cpu_count() or 2
if n > 1:
    try:
        os.sched_setaffinity(0, set(range(1, n)))
    except (AttributeError, OSError):
        pass
import repro_torch.models.openpose as op
from repro_torch.core.executor import DestinationExecutor
from repro_torch.core.library import make_openpose_library
from repro_torch.core.transport import TCPServer
device = sys.argv[2]
net = op.OpenPoseLite()
ex = DestinationExecutor({"openpose": make_openpose_library(net, device=device)},
                         name="bench-dest", device=device)
server = TCPServer(ex.handle).start()
print(server.port, flush=True)
threading.Event().wait()
"""


def spawn_openpose_destination(device: str = "cuda"):
    """Start an OpenPose-lite destination executor in its OWN process (the
    paper's topology: host and destination are different machines with
    different interpreters), computing on ``device`` (the card unless the
    caller asks for the CPU).  Returns (subprocess, port)."""
    import os
    import subprocess
    import sys

    import repro_torch
    src = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))
    proc = subprocess.Popen([sys.executable, "-c", _OPENPOSE_DESTINATION, src, str(device)],
                            stdout=subprocess.PIPE, text=True)
    line = proc.stdout.readline()
    if not line.strip():        # child died before binding: name the failure
        proc.terminate()
        rc = proc.wait()
        raise RuntimeError(
            f"openpose destination subprocess failed to start (exit {rc}); "
            "run it by hand to see the traceback")
    return proc, int(line)


def _openpose_offload_walls(frames: int, in_flight: int,
                            device="cuda") -> tuple[float, float, dict]:
    """(sync_wall_s, pipelined_wall_s, pipelined runtime stats) for N
    OpenPose-lite frames over loopback TCP to a destination in its own
    process computing on ``device``, model resident and warm in both cases.
    (Co-locating the destination in this process makes "overlap"
    impossible — one GIL — and was measured to invert the comparison.)"""
    import repro_torch.models.openpose as op
    from repro_torch.core.executor import HostRuntime, PipelinedHostRuntime
    from repro_torch.core.transport import TCPChannel
    from repro_torch.models.params import init_params
    from repro_torch.utils import to_numpy_tree

    net = op.OpenPoseLite()
    # the host's copy of the weights (numpy, as they cross the wire)
    params = to_numpy_tree(init_params(op.op_param_specs(net), 0, torch.float32,
                                       device="cpu"))
    proc, port = spawn_openpose_destination(device)
    fp = "bench-openpose"
    batch = [np.asarray(op.make_frames(1, 368, 656)) for _ in range(frames)]

    try:
        sync_rt = HostRuntime(TCPChannel.connect("127.0.0.1", port))
        sync_rt.put_model(fp, "openpose", params)
        sync_rt.run(fp, "forward", {"frames": batch[0]})      # warm: allocator, cuDNN
        pipe_rt = PipelinedHostRuntime(
            TCPChannel.connect("127.0.0.1", port), max_in_flight=in_flight)
        pipe_rt.run(fp, "forward", {"frames": batch[0]})      # warm channel

        def sync_pass() -> float:
            t0 = time.perf_counter()
            for f in batch:
                sync_rt.run(fp, "forward", {"frames": f})
            return time.perf_counter() - t0

        def pipe_pass() -> float:
            t0 = time.perf_counter()
            futs = [pipe_rt.run_async(fp, "forward", {"frames": f})
                    for f in batch]
            for f in futs:
                f.result(timeout=300)
            return time.perf_counter() - t0

        # interleave passes and take the min per mode: destination compute
        # jitter on a shared CPU otherwise swamps the overlap being measured
        sync_walls, pipe_walls = [], []
        for _ in range(3):
            sync_walls.append(sync_pass())
            pipe_walls.append(pipe_pass())
        t_sync, t_pipe = min(sync_walls), min(pipe_walls)
        rt_stats = pipe_rt.stats()
        rt_stats["metrics"] = _runtime_metrics_snapshot(pipe_rt)
        sync_rt.close()
        pipe_rt.close()
    finally:
        proc.terminate()        # never orphan the destination process
        proc.wait()
    return t_sync, t_pipe, rt_stats


def backpressure_probe(frames: int = 6, frame_floats: int = 128 * 1024,
                       bufsize: int = 8192, max_in_flight: int = 4,
                       timeout: float = 60.0) -> dict:
    """Pipelined transfer through shrunken SO_SNDBUF/SO_RCVBUF against a
    serial (recv -> handle -> send) echo destination — the configuration
    that deadlocked a blocking send path.  Verifies every echoed
    payload and returns the runtime's backpressure counters + wall time.
    Shared by the smoke bench (BENCH_dataplane.json) and the deadlock
    regression test."""
    import socket
    import threading

    from repro_torch.core.executor import PipelinedHostRuntime
    from repro_torch.core.memory import release_buffer
    from repro_torch.core.serialization import (frame_request_id, pack_message,
                                          unpack_message)
    from repro_torch.core.transport import (ChannelClosed, TCPChannel, _recv_frame,
                                      _send_frame)

    a, b = socket.socketpair()
    for s in (a, b):
        s.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, bufsize)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, bufsize)
    stop = threading.Event()

    def destination():
        try:
            while not stop.is_set():
                req = _recv_frame(b)
                try:
                    rid = frame_request_id(req)
                    _, tree = unpack_message(req)
                    _send_frame(b, pack_message(
                        {"ok": True, "compute_s": 1e-3},
                        {"y": np.asarray(tree["x"]) + 1.0}, request_id=rid))
                finally:
                    release_buffer(req)
        except (ChannelClosed, OSError):
            pass

    t = threading.Thread(target=destination, daemon=True)
    t.start()
    rt = PipelinedHostRuntime(TCPChannel(a), max_in_flight=max_in_flight,
                              timeout=timeout)
    xs = [np.full(frame_floats, float(i), np.float32) for i in range(frames)]
    t0 = time.perf_counter()
    futs = [rt.submit({"op": "noop"}, {"x": x}) for x in xs]
    verified = True
    for x, f in zip(xs, futs):
        _, out = rt.wait(f, timeout=timeout)
        verified = verified and bool(np.array_equal(out["y"], x + 1.0))
    wall = time.perf_counter() - t0
    stats = rt.stats()
    metrics = _runtime_metrics_snapshot(rt)
    stop.set()
    rt.close()
    t.join(timeout=5)
    return {
        "frames": frames,
        "frame_bytes": frame_floats * 4,
        "socket_buffer_bytes": bufsize,
        "wall_s": wall,
        "verified": verified,
        "send_stalls": stats["send_stalls"],
        "sends_resumed": stats["sends_resumed"],
        "window": stats["window"],
        "requests_completed": stats["requests_completed"],
        "metrics": metrics,
    }


def recv_ring_probe(frames: int = 160, frame_floats: int = 128 * 1024,
                    held_frames: int = 8, warmup: int = 16,
                    max_in_flight: int = 4, timeout: float = 60.0) -> dict:
    """Steady-state pooled-recv probe (the recv ring buffer acceptance rig).

    A pipelined host drives an in-process echo destination over a
    socketpair; both directions receive into ``BufferPool`` slabs and the
    destination's reply payload is a zero-copy view over its pooled request
    lease.  Three measurements:

    * **pool hit rate / fallback allocations** over the measured window
      (steady state must be all hits: zero payload-buffer allocations per
      received frame, straight from the pool's own counters);
    * **bytes allocated per received frame via tracemalloc** (filtered to
      ``transport.py`` + ``memory.py``): ``held_frames`` sequential round
      trips with every response HELD live between two snapshots, so a
      per-frame payload ``bytearray`` cannot hide behind prompt frees —
      pooled recv lands in pre-snapshot slabs (~lease-object bytes), the
      unpooled baseline shows the full payload per frame;
    * **recv throughput vs the unpooled path**: a single-threaded
      sender-preload loop (send one prebuilt wire frame, time
      ``recv`` + unpack + release) with ``pool=False`` as the baseline —
      deterministic by construction (an in-process echo *thread* shares the
      GIL with the timed side and its scheduling jitter swamps the few-
      percent effect); passes interleave modes and take the min per mode.
    """
    import gc
    import socket
    import struct
    import threading
    import tracemalloc

    from repro_torch.analysis.sanitize import LeaseTracker
    from repro_torch.core import memory as memory_mod
    from repro_torch.core import transport as transport_mod
    from repro_torch.core.executor import PipelinedHostRuntime
    from repro_torch.core.memory import (BufferPool, release_buffer,
                                   set_lease_tracker)
    from repro_torch.core.serialization import (frame_request_id, pack_message,
                                          unpack_message)
    from repro_torch.core.transport import (ChannelClosed, TCPChannel, _recv_frame,
                                      _send_frame)

    # every lease the probe's pools hand out is tracked with its acquisition
    # site; the pool section must end with zero live (the sanitizer proof of
    # leak-freedom, stronger than the acquired==released counter identity)
    tracker = LeaseTracker()
    prev_tracker = set_lease_tracker(tracker)

    def build(pooled: bool):
        a, b = socket.socketpair()
        dest_pool = BufferPool() if pooled else None
        stop = threading.Event()

        def destination():
            hdr = bytearray(8)
            try:
                while not stop.is_set():
                    req = _recv_frame(b, dest_pool, hdr)
                    try:
                        rid = frame_request_id(req)
                        _, tree = unpack_message(req)
                        _send_frame(b, pack_message(
                            {"ok": True, "compute_s": 1e-4},
                            {"y": tree["x"]}, request_id=rid))
                        del tree            # drop leaf pins, then the base
                    finally:
                        release_buffer(req)     # ref: the slab region recycles
            except (ChannelClosed, OSError):
                pass

        t = threading.Thread(target=destination, daemon=True)
        t.start()
        rt = PipelinedHostRuntime(TCPChannel(a, pool=None if pooled else False),
                                  max_in_flight=max_in_flight, timeout=timeout)
        return rt, stop, t, b

    x = np.arange(frame_floats, dtype=np.float32)

    def pump(rt, n: int) -> float:
        """Closed-loop stream of ``n`` frames, results dropped on arrival."""
        import collections
        futs = collections.deque()
        t0 = time.perf_counter()
        for _ in range(n):
            futs.append(rt.submit({"op": "noop"}, {"x": x}))
            while len(futs) >= max_in_flight:
                _, out = rt.wait(futs.popleft(), timeout=timeout)
                del out
        while futs:
            _, out = rt.wait(futs.popleft(), timeout=timeout)
            del out
        return time.perf_counter() - t0

    def teardown(rt, stop, t, b):
        stop.set()
        rt.close()
        try:
            b.close()
        except OSError:
            pass
        t.join(timeout=5)

    # -- pipelined steady state: pool counters over a real offload stream --
    rig_pooled = build(pooled=True)
    rt = rig_pooled[0]
    pool = rt.channel.recv_pool
    # metrics ENABLED during the measured window: the obs views are bound
    # before pumping, proving the scrape-time design costs the hot path
    # nothing (the CI ring gate compares this wall against the seed's)
    mreg = obs_metrics.MetricsRegistry()
    obs_metrics.bind_runtime(mreg, rt)
    pump(rt, warmup)
    gc.collect()
    before = pool.stats()
    pump(rt, frames)
    after = pool.stats()
    hit_rate = ((after["hits"] - before["hits"])
                / max(after["acquired"] - before["acquired"], 1))
    fallback_allocs = after["misses"] - before["misses"]

    # -- tracemalloc: bytes allocated per received frame, responses held ---
    filters = [tracemalloc.Filter(True, transport_mod.__file__),
               tracemalloc.Filter(True, memory_mod.__file__)]

    def held_alloc_per_frame(rt) -> float:
        gc.collect()
        tracemalloc.start()
        snap1 = tracemalloc.take_snapshot().filter_traces(filters)
        held = [rt.wait(rt.submit({"op": "noop"}, {"x": x}),
                        timeout=timeout) for _ in range(held_frames)]
        snap2 = tracemalloc.take_snapshot().filter_traces(filters)
        tracemalloc.stop()
        grown = sum(max(d.size_diff, 0)
                    for d in snap2.compare_to(snap1, "filename"))
        del held
        gc.collect()
        return grown / held_frames

    held_alloc_per_frame(rt)    # warm the ring's lazy slab growth for a
    pooled_alloc = held_alloc_per_frame(rt)     # full held window first
    steady = pool.stats()
    metrics = mreg.sample_values()
    teardown(*rig_pooled)
    balanced = steady["acquired"] == steady["released"] \
        and steady["outstanding"] == 0

    # -- unpooled baseline: the held-allocation contrast -------------------
    rig_plain = build(pooled=False)
    pump(rig_plain[0], warmup)
    held_alloc_per_frame(rig_plain[0])          # symmetric warm pass
    unpooled_alloc = held_alloc_per_frame(rig_plain[0])
    teardown(*rig_plain)

    # -- recv throughput, single-threaded sender-preload loop --------------
    resp_frame = pack_message({"ok": True, "compute_s": 1e-4}, {"y": x})
    wire = struct.pack("<Q", len(resp_frame)) + bytes(resp_frame)

    def sync_rig(pooled: bool):
        a, b = socket.socketpair()
        for s in (a, b):
            s.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 2 << 20)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 2 << 20)
        return TCPChannel(a, pool=None if pooled else False), b

    def sync_pass(ch, peer, n: int) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            peer.sendall(wire)
            resp = ch.recv()
            try:
                _, out = unpack_message(resp)
                del out
            finally:
                release_buffer(resp)
        return time.perf_counter() - t0

    rigs = {True: sync_rig(True), False: sync_rig(False)}
    for mode in (True, False):
        sync_pass(*rigs[mode], warmup)
    walls: dict = {True: [], False: []}
    for _ in range(5):
        for mode in (True, False):
            walls[mode].append(sync_pass(*rigs[mode], frames))
    pooled_wall, unpooled_wall = min(walls[True]), min(walls[False])
    for ch, peer in rigs.values():
        ch.close()
        peer.close()

    # every rig is down: poll live leases to zero with a short gc grace
    # (pinned zero-copy views release from weakref finalizers)
    deadline = time.monotonic() + 5.0
    while tracker.live_count() and time.monotonic() < deadline:
        gc.collect()
        time.sleep(0.02)
    live_at_teardown = tracker.live_count()
    set_lease_tracker(prev_tracker)

    frame_bytes = frame_floats * 4
    return {
        "frames": frames,
        "frame_payload_bytes": frame_bytes,
        "held_frames": held_frames,
        "pool_hit_rate": hit_rate,
        "steady_state_fallback_allocs": fallback_allocs,
        "pool_balanced_at_teardown": balanced,
        "payload_alloc_per_frame_bytes": pooled_alloc,
        "unpooled_alloc_per_frame_bytes": unpooled_alloc,
        "pooled_wall_s": pooled_wall,
        "unpooled_wall_s": unpooled_wall,
        "recv_throughput_mbps": frames * frame_bytes / pooled_wall / 1e6,
        "baseline_throughput_mbps": frames * frame_bytes / unpooled_wall / 1e6,
        "throughput_ratio_vs_unpooled": unpooled_wall / pooled_wall,
        "live_leases_at_teardown": live_at_teardown,
        "leases_tracked": tracker.acquired,
        "pool": steady,
        "metrics": metrics,
    }


def shm_probe(frames: int = 48, frame_floats: int = 256 * 1024,
              held_frames: int = 8, warmup: int = 8,
              timeout: float = 30.0) -> dict:
    """Shared-memory ring vs real localhost TCP recv throughput (the
    same-host transport-tier acceptance rig).

    Both rigs run the identical single-threaded sender-preload loop (peer
    sends one prebuilt response frame, the timed side recv + unpack +
    release), interleaved min-of-5 passes:

    * **TCP**: a real 127.0.0.1 connection (not a socketpair — loopback TCP
      pays the stack both ways), pooled receive into ``BufferPool`` slabs;
    * **SHM**: a :class:`SharedMemoryChannel` pair — the sender's frame is
      written once into the mmap ring, the receiver's ``recv`` returns a
      lease over the SAME bytes after a 17-byte doorbell token, and
      ``release_buffer`` posts the credit back.

    Gates (CI): SHM throughput >= 1.5x localhost TCP; every SHM receive a
    ring-pool hit (hit rate 1.0, zero fallback allocations, zero spills);
    tracemalloc-held allocations per received frame at lease-object scale,
    not payload scale."""
    import gc
    import socket
    import tracemalloc

    from repro_torch.core import memory as memory_mod
    from repro_torch.core import shm as shm_mod
    from repro_torch.core.memory import release_buffer
    from repro_torch.core.serialization import pack_message, unpack_message
    from repro_torch.core.shm import SharedMemoryChannel
    from repro_torch.core.transport import TCPChannel

    x = np.arange(frame_floats, dtype=np.float32)
    resp = bytes(pack_message({"ok": True, "compute_s": 1e-4}, {"y": x}))
    frame_bytes = len(resp)

    shm_a, shm_b = SharedMemoryChannel.pair()

    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    csock = socket.create_connection(("127.0.0.1",
                                      lsock.getsockname()[1]))
    ssock, _ = lsock.accept()
    lsock.close()
    for s in (csock, ssock):
        # the preload loop writes a whole frame before draining it: size
        # the kernel buffers so the single-threaded rig can never wedge
        s.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4 << 20)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4 << 20)
    tcp_ch, tcp_peer = TCPChannel(csock), TCPChannel(ssock)

    def one_pass(peer, ch, n: int) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            peer.send(resp)
            got = ch.recv(timeout=timeout)
            try:
                _, out = unpack_message(got)
                del out
            finally:
                release_buffer(got)
        return time.perf_counter() - t0

    # correctness spot check: the zero-copy view IS the sent payload
    shm_a.send(resp)
    got = shm_b.recv(timeout=timeout)
    try:
        _, tree = unpack_message(got)
        assert np.array_equal(np.asarray(tree["y"]), x)
        del tree
    finally:
        release_buffer(got)

    mreg = obs_metrics.MetricsRegistry()
    obs_metrics.bind_shm_channel(mreg, shm_b, link="probe")
    one_pass(shm_a, shm_b, warmup)
    one_pass(tcp_peer, tcp_ch, warmup)

    before = shm_b.recv_pool.stats()
    walls: dict = {"shm": [], "tcp": []}
    for _ in range(5):
        walls["shm"].append(one_pass(shm_a, shm_b, frames))
        walls["tcp"].append(one_pass(tcp_peer, tcp_ch, frames))
    after = shm_b.recv_pool.stats()
    hit_rate = ((after["hits"] - before["hits"])
                / max(after["acquired"] - before["acquired"], 1))
    fallback_allocs = after["misses"] - before["misses"]

    # -- tracemalloc: held window over the SHM side --------------------
    filters = [tracemalloc.Filter(True, shm_mod.__file__),
               tracemalloc.Filter(True, memory_mod.__file__)]
    gc.collect()
    tracemalloc.start()
    snap1 = tracemalloc.take_snapshot().filter_traces(filters)
    held = []
    for _ in range(held_frames):
        shm_a.send(resp)
        held.append(shm_b.recv(timeout=timeout))
    snap2 = tracemalloc.take_snapshot().filter_traces(filters)
    tracemalloc.stop()
    grown = sum(max(d.size_diff, 0)
                for d in snap2.compare_to(snap1, "filename"))
    for lease in held:
        release_buffer(lease)
    del held

    shm_stats = shm_a.stats()
    metrics = mreg.sample_values()
    shm_wall, tcp_wall = min(walls["shm"]), min(walls["tcp"])
    for ch in (shm_a, shm_b, tcp_ch, tcp_peer):
        ch.close()

    return {
        "frames": frames,
        "frame_payload_bytes": frame_bytes,
        "ring_bytes": shm_stats["ring_bytes"],
        "shm_wall_s": shm_wall,
        "tcp_wall_s": tcp_wall,
        "shm_throughput_mbps": frames * frame_bytes / shm_wall / 1e6,
        "tcp_throughput_mbps": frames * frame_bytes / tcp_wall / 1e6,
        "speedup_vs_tcp": tcp_wall / shm_wall,
        "pool_hit_rate": hit_rate,
        "steady_state_fallback_allocs": fallback_allocs,
        "spills": shm_stats["spills_sent"] + shm_stats["spills_received"],
        "payload_alloc_per_frame_bytes": grown / held_frames,
        "frames_sent": shm_stats["frames_sent"],
        "credits_received": shm_stats["credits_received"],
        "metrics": metrics,
    }


def comm_quant_probe(frames: int = 10, rows: int = 512, cols: int = 256,
                     bandwidth: float = 12e6, latency: float = 0.002,
                     in_flight: int = 4, warmup: int = 6,
                     timeout: float = 60.0) -> dict:
    """Negotiated wire quantization on a narrow link (the comm_quant
    acceptance rig).

    A pipelined host drives an echo destination over a realtime
    :class:`SimulatedChannel` (~12 MB/s — the 100 Mbit edge-uplink class
    the paper's cloud-edge split actually crosses).  Two interleaved
    configurations of the SAME stream: the negotiated ``("raw",)``
    baseline, and the int8-armed runtime whose ``_effective_codec``
    engages once the adaptive window's wire EMA crosses its compute EMA
    (the warmup pumps until the crossover has actually fired, which also
    front-loads the one-time lazy import of the quant kernels).
    The destination echoes each request back through the SAME negotiated
    preference list, so the stitched result crosses TWO lossy hops.

    Gates (CI): quantized on-wire payload <= 0.3x the raw frame bytes;
    effective raw-leaf throughput >= 2x the raw baseline; every echoed
    element within the documented two-hop bound ``2 * absmax_row / 254``
    (plus float eps)."""
    import collections
    import threading

    from repro_torch.core.executor import PipelinedHostRuntime
    from repro_torch.core.memory import release_buffer
    from repro_torch.core.serialization import (frame_request_id, pack_message,
                                          unpack_message)
    from repro_torch.core.transport import (ChannelClosed, LoopbackChannel,
                                      SimulatedChannel, VirtualClock)

    rng = np.random.default_rng(7)
    x = (rng.standard_normal((rows, cols)).astype(np.float32)
         * rng.uniform(0.5, 8.0, (rows, 1)).astype(np.float32))
    raw_leaf_bytes = x.nbytes
    absmax_row = np.max(np.abs(x), axis=1, keepdims=True)
    # two quantizing hops (request + echoed response), each bounded by
    # absmax_row/254; the 1.01 absorbs the second hop quantizing the
    # first hop's slightly-shifted rows plus float32 arithmetic eps
    err_bound = 2.0 * absmax_row / 254.0 * 1.01 + 1e-6

    def build(quant: bool):
        host_inner, dest_ch = LoopbackChannel.pair()
        sim = SimulatedChannel(host_inner, VirtualClock(),
                               bandwidth=bandwidth, latency=latency,
                               serialize_rate=0.0, realtime=True)
        stop = threading.Event()

        def destination():
            try:
                while not stop.is_set():
                    req = dest_ch.recv(timeout=10)
                    try:
                        meta, tree = unpack_message(req)
                        codec = meta.get("codec", "raw")
                        if isinstance(codec, list):
                            codec = tuple(codec)
                        dest_ch.send(pack_message(
                            {"ok": True, "compute_s": 5e-4},
                            {"y": np.asarray(tree["x"])}, codec=codec,
                            request_id=frame_request_id(req)))
                    finally:
                        release_buffer(req)
            except (ChannelClosed, TimeoutError):
                pass

        t = threading.Thread(target=destination, daemon=True)
        t.start()
        rt = PipelinedHostRuntime(sim, codec="raw",
                                  max_in_flight=in_flight, timeout=timeout)
        if quant:
            rt.quant_codec = "int8"
        return rt, stop, t

    def pump(rt, n: int, keep: bool = False) -> tuple[float, list]:
        futs: collections.deque = collections.deque()
        outs: list = []
        t0 = time.perf_counter()
        for _ in range(n):
            futs.append(rt.run_async("fp", "fn", {"x": x}))
            while len(futs) >= in_flight:
                _, out = rt.wait(futs.popleft(), timeout=timeout)
                if keep:
                    outs.append(np.array(out["y"]))
        while futs:
            _, out = rt.wait(futs.popleft(), timeout=timeout)
            if keep:
                outs.append(np.array(out["y"]))
        return time.perf_counter() - t0, outs

    results = {}
    for quant in (False, True):
        rt, stop, t = build(quant)
        pump(rt, warmup)        # observations for the EMA crossover
        if quant:
            # the EMA crossover lags the in-flight window, so the first
            # warmup frames go out raw — keep pumping until a quantized
            # frame has actually been sent, so the measured window never
            # pays the engagement lag or the one-time lazy import of the
            # quant kernels (pallas is ~100ms of import on first encode)
            for _ in range(4 * warmup):
                if rt.stats()["quant_frames"] > 0:
                    break
                pump(rt, 1)
        before = rt.stats()
        wall, outs = pump(rt, frames, keep=True)
        after = rt.stats()
        stop.set()
        rt.close()
        t.join(timeout=5)
        err = max(float(np.max(np.abs(o - x) - err_bound)) for o in outs)
        results[quant] = {
            "wall_s": wall,
            "bytes_per_frame": (after["bytes_sent"]
                                - before["bytes_sent"]) / frames,
            "quant_frames": after["quant_frames"] - before["quant_frames"],
            "bytes_saved": (after["quant_bytes_saved"]
                            - before["quant_bytes_saved"]),
            "worst_err_minus_bound": err,
            "wire_ema_s": after["wire_ema_s"],
            "compute_ema_s": after["compute_ema_s"],
            "metrics": _runtime_metrics_snapshot(rt),
        }

    raw, q = results[False], results[True]
    return {
        "frames": frames,
        "raw_leaf_bytes": raw_leaf_bytes,
        "link_bandwidth_mbps": bandwidth / 1e6,
        "raw_wall_s": raw["wall_s"],
        "quant_wall_s": q["wall_s"],
        "raw_bytes_per_frame": raw["bytes_per_frame"],
        "quant_bytes_per_frame": q["bytes_per_frame"],
        "payload_ratio": q["bytes_per_frame"] / raw["bytes_per_frame"],
        "effective_speedup": raw["wall_s"] / q["wall_s"],
        "raw_throughput_mbps": frames * raw_leaf_bytes / raw["wall_s"] / 1e6,
        "quant_throughput_mbps": frames * raw_leaf_bytes / q["wall_s"] / 1e6,
        "quant_frames": q["quant_frames"],
        "quant_engaged": q["quant_frames"] >= frames,
        "raw_frames_quantized": raw["quant_frames"],
        "quant_bytes_saved": q["bytes_saved"],
        "within_error_bound": q["worst_err_minus_bound"] <= 0.0,
        "worst_err_minus_bound": q["worst_err_minus_bound"],
        "raw_roundtrip_exact": raw["worst_err_minus_bound"] <= 0.0,
        "wire_ema_s": q["wire_ema_s"],
        "compute_ema_s": q["compute_ema_s"],
        "metrics": q["metrics"],
    }


def tenant_fairness_probe(weight_a: float = 3.0, weight_b: float = 1.0,
                          threads_per_tenant: int = 6,
                          warmup_s: float = 0.4, measure_s: float = 1.5,
                          compute_s: float = 0.003,
                          max_coalesce: int = 4) -> dict:
    """Contended two-tenant fair-share probe (the CI fairness gate).

    Two tenants with identical closed-loop offered load (same thread count,
    same requests) hammer ONE coalescing destination whose drain weights are
    pinned ``weight_a:weight_b`` server-side.  Every dispatch costs a fixed
    ``compute_s`` regardless of batch size, so drain *slots* are the scarce
    resource and the weighted deficit-round-robin drain is what divides
    them.  A FIFO drain would split completions ~50/50 (equal offered load);
    the weighted drain must land each tenant's share within ±20% of its
    weight share, and the LOW-weight tenant's p95 latency must stay bounded
    (no starvation) — both recorded for BENCH_dataplane.json and asserted
    by CI's smoke-bench step."""
    import threading

    from repro_torch.core.executor import DestinationExecutor, HostRuntime
    from repro_torch.core.transport import DirectChannel

    def work(params, state, args):
        time.sleep(compute_s)
        return {"y": np.asarray(args["x"]) + 1.0}

    ex = DestinationExecutor(
        {"tiny": {"work": work}}, coalesce=True, coalesce_window_s=0.0,
        max_coalesce=max_coalesce,
        tenant_weights={"a": weight_a, "b": weight_b}, device="cpu")
    HostRuntime(DirectChannel(ex)).put_model(
        "fp", "tiny", {"w": np.zeros(1, np.float32)})
    stop = threading.Event()
    lat: dict[str, list] = {"a": [], "b": []}
    lat_lock = threading.Lock()
    t_measure = [0.0]

    def loop(tenant: str) -> None:
        rt = HostRuntime(DirectChannel(ex))
        x = {"x": np.zeros((1, 2), np.float32)}
        while not stop.is_set():
            t0 = time.perf_counter()
            rt.run("fp", "work", x, batchable=True, tenant=tenant)
            if t0 >= t_measure[0] > 0:      # completed inside the window
                with lat_lock:
                    lat[tenant].append(time.perf_counter() - t0)

    threads = [threading.Thread(target=loop, args=(t,))
               for t in ("a", "b") for _ in range(threads_per_tenant)]
    [t.start() for t in threads]
    time.sleep(warmup_s)
    t_measure[0] = time.perf_counter()
    before = {t: s.get("drained", 0) for t, s in ex.tenant_stats.items()}
    time.sleep(measure_s)
    after = {t: s.get("drained", 0) for t, s in ex.tenant_stats.items()}
    stop.set()
    [t.join(timeout=10) for t in threads]
    stats = ex.tenant_stats
    metrics = _executor_metrics_snapshot(ex)
    ex.shutdown()

    drained = {t: after.get(t, 0) - before.get(t, 0) for t in ("a", "b")}
    total = max(drained["a"] + drained["b"], 1)
    share_a = drained["a"] / total
    expected_share_a = weight_a / (weight_a + weight_b)
    p95_bound = 100.0 * compute_s       # ~10x the expected steady-state p95
    if lat["b"]:
        b_lat = sorted(lat["b"])
        b_p95 = b_lat[min(int(0.95 * len(b_lat)), len(b_lat) - 1)]
        b_mean = float(np.mean(b_lat))
    else:
        # total starvation: zero completions must read as the WORST p95,
        # not an empty-list 0.0 that would pass the bound
        b_p95 = b_mean = float(measure_s)
    return {
        "weights": {"a": weight_a, "b": weight_b},
        "threads_per_tenant": threads_per_tenant,
        "measure_s": measure_s,
        "dispatch_compute_s": compute_s,
        "drained": drained,
        "share_a": share_a,
        "share_b": 1.0 - share_a,
        "expected_share_a": expected_share_a,
        "share_tolerance": 0.2,
        "within_tolerance":
            abs(share_a - expected_share_a) <= 0.2 * expected_share_a,
        "b_completed": len(lat["b"]),
        "b_mean_s": b_mean,
        "b_p95_s": float(b_p95),
        "p95_bound_s": p95_bound,
        "b_p95_bounded": b_p95 < p95_bound,
        "tenant_stats": {t: {k: v for k, v in s.items()}
                         for t, s in stats.items()},
        "metrics": metrics,
    }


def drain_rehome_probe(n_steady: int = 200, n_drain: int = 200,
                       compute_s: float = 0.002,
                       p99_ratio_bound: float = 2.0) -> dict:
    """Zero-downtime drain probe (the CI drain gate).

    One session streams fixed-cost calls at a two-destination facade pool
    with warm shadow replication on.  Mid-stream the primary's admission
    gate flips (the ``drain`` control op): the next call bounces typed, the
    session promotes its warm standby, and the stream continues.  The probe
    records per-call latency in the steady window vs the drain window (which
    CONTAINS the bounce + re-home call) plus whether any call was dropped.
    Acceptance: zero dropped calls, drain-window p99 <= ``p99_ratio_bound``
    x steady p99, a warm (no state rebuild) re-home, and the drained node
    bleeding to zero pending."""
    from repro_torch import avec
    from repro_torch.core.executor import DestinationExecutor

    def work(params, state, args):
        time.sleep(compute_s)
        return {"y": np.asarray(args["x"]) + 1.0}

    executors = {n: DestinationExecutor({"tiny": {"work": work}}, name=n,
                                        device="cpu")
                 for n in ("prim", "stby")}
    cfg = {"arch": "drain-probe"}
    params = {"w": np.zeros(1, np.float32)}
    x = {"x": np.zeros((1, 2), np.float32)}

    def p99(lat: list) -> float:
        s = sorted(lat)
        return s[min(int(0.99 * len(s)), len(s) - 1)] if s else float("inf")

    dropped = 0
    lat_steady: list = []
    lat_drain: list = []
    with avec.connect(list(executors.values())) as client:
        sess = client.session(cfg, params, "tiny", destination="prim")
        for lat in (lat_steady, lat_drain):
            n = n_steady if lat is lat_steady else n_drain
            for _ in range(n):
                t0 = time.perf_counter()
                try:
                    sess.call("work", x)
                except Exception:  # noqa: BLE001 — a drop is the failure mode
                    dropped += 1
                    continue
                lat.append(time.perf_counter() - t0)
            if lat is lat_steady:
                # flip mid-stream: the NEXT call eats the bounce + re-home
                client.runtime("prim").drain()
        bleed = executors["prim"].drain(timeout_s=5.0)
        rehome = dict(sess.last_rehome or {})
        destination = sess.destination
    for ex in executors.values():
        ex.shutdown()
    steady_p99, drain_p99 = p99(lat_steady), p99(lat_drain)
    ratio = drain_p99 / steady_p99 if steady_p99 > 0 else float("inf")
    return {
        "calls_steady": n_steady,
        "calls_drain_window": n_drain,
        "dispatch_compute_s": compute_s,
        "dropped": dropped,
        "steady_p99_s": steady_p99,
        "drain_p99_s": drain_p99,
        "p99_ratio": ratio,
        "p99_ratio_bound": p99_ratio_bound,
        "within_bound": ratio <= p99_ratio_bound,
        "rehome": rehome,
        "destination_after": destination,
        "drained_node_bled": bleed,
    }


def intra_op_scaling_probe(rows: int = 4096, per_row_sleep_s: float = 2e-5,
                           reps: int = 3,
                           tolerance_4_vs_2: float = 1.1) -> dict:
    """Intra-call sharding scaling probe (the CI intra-op gate).

    ONE ``rows``-row elementwise-MLP batch offloaded through the facade
    with ``shard=True`` over 1 vs 2 vs 4 in-process destinations.  The
    modeled compute is a strictly row-proportional sleep (releases the
    GIL, so in-process destinations genuinely overlap) plus strictly
    row-wise elementwise math — deliberately NOT a BLAS matmul, whose
    M-dimension blocking could legally round differently per split and
    break the bit-identity acceptance this probe also checks.

    Acceptance: 2-destination speedup >= 1.3x over 1, the 4-destination
    wall within ``tolerance_4_vs_2`` of the 2-destination wall (ideally
    faster), and the stitched outputs bit-identical to the unsharded
    reference."""
    from repro_torch import avec
    from repro_torch.core.executor import DestinationExecutor

    params = {"w1": np.float32(1.5), "b1": np.float32(-3.0),
              "w2": np.float32(0.5)}

    def work(p, state, args):
        x = np.asarray(args["x"])
        w1, b1, w2 = (np.asarray(p[n]) for n in ("w1", "b1", "w2"))   # host tensors
        time.sleep(x.shape[0] * per_row_sleep_s)
        return {"y": np.maximum(x * w1 + b1, 0.0) * w2}

    x = {"x": np.arange(rows * 4, dtype=np.float32).reshape(rows, 4)}
    executors = [DestinationExecutor({"mlp": {"work": work}}, name=f"d{i}",
                                     device="cpu")
                 for i in range(4)]
    walls: dict = {}
    outs: dict = {}
    shards: dict = {}
    try:
        for n in (1, 2, 4):
            with avec.connect(executors[:n]) as client:
                sess = client.session({"arch": "intra-op-probe"}, params,
                                      "mlp", destination="d0")
                sess.call("work", x, shard=True)    # warm models/frontends
                best, out = float("inf"), None
                for _ in range(reps):
                    t0 = time.perf_counter()
                    out = sess.call("work", x, shard=True)
                    best = min(best, time.perf_counter() - t0)
                walls[n] = best
                outs[n] = np.asarray(out["y"]).copy()
                if sess.last_shard_stats is not None:
                    shards[n] = sess.last_shard_stats["shards"]
    finally:
        for ex in executors:
            ex.shutdown()
    return {
        "rows": rows,
        "per_row_sleep_s": per_row_sleep_s,
        "wall_1_s": walls[1],
        "wall_2_s": walls[2],
        "wall_4_s": walls[4],
        "speedup_2": walls[1] / walls[2],
        "speedup_4": walls[1] / walls[4],
        "tolerance_4_vs_2": tolerance_4_vs_2,
        "four_within_tolerance": walls[4] <= walls[2] * tolerance_4_vs_2,
        "bit_identical": bool(np.array_equal(outs[1], outs[2])
                              and np.array_equal(outs[1], outs[4])),
        "shards_2": shards.get(2, []),
        "shards_4": shards.get(4, []),
    }


def _coalesce_walls(clients: int = 8, reps: int = 4,
                    device="cuda") -> tuple[float, float, dict]:
    """(uncoalesced_wall_s, coalesced_wall_s, stats) for N concurrent clients
    hitting one destination on ``device`` with batchable matmul requests."""
    import threading

    from repro_torch.core.executor import DestinationExecutor, HostRuntime
    from repro_torch.core.transport import DirectChannel

    w = np.random.default_rng(0).standard_normal((256, 256)).astype(np.float32)

    def matmul(params, state, args):
        return {"y": torch.matmul(args["x"], params["w"])}

    xs = [np.random.default_rng(i).standard_normal((4, 256)).astype(np.float32)
          for i in range(clients)]

    def drive(ex) -> float:
        rts = [HostRuntime(DirectChannel(ex)) for _ in range(clients)]
        rts[0].put_model("fp", "mm", {"w": w})
        rts[0].run("fp", "matmul", {"x": xs[0]})          # warm: cuBLAS handle
        barrier = threading.Barrier(clients)

        def worker(i):
            barrier.wait()
            for _ in range(reps):
                rts[i].run("fp", "matmul", {"x": xs[i]}, batchable=True)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(clients)]
        t0 = time.perf_counter()
        [t.start() for t in threads]
        [t.join() for t in threads]
        return time.perf_counter() - t0

    lib = {"mm": {"matmul": matmul}}
    plain = DestinationExecutor(dict(lib), device=device)
    t_plain = min(drive(plain) for _ in range(3))     # min-of-3: warm-up/thread
    coal = DestinationExecutor(dict(lib), coalesce=True,    # jitter
                               coalesce_window_s=0.002, max_coalesce=clients,
                               device=device)
    walls = [drive(coal), drive(coal)]
    before = dict(coal.coalesce_stats)                # stats of the last rep
    walls.append(drive(coal))                         # only, not cumulative
    after = coal.coalesce_stats
    stats = {"batches": after["batches"] - before["batches"],
             "requests": after["requests"] - before["requests"],
             "max_batch": after["max_batch"]}
    t_coal = min(walls)
    coal.shutdown()
    return t_plain, t_coal, stats


def dataplane_report(frames: int = 8, in_flight: int = 4,
                     device="cuda") -> dict:
    """The BENCH_dataplane.json payload: serialize throughput vs the seed
    path, pipelined-vs-sync offload walls (with the adaptive window the
    runtime chose), small-socket-buffer backpressure counters, and coalesced
    dispatch walls.  The OpenPose destination and the coalesced matmuls
    compute on ``device``."""
    t = _serialize_timings(n=100)
    nb = t["nbytes"]
    t_sync, t_pipe, pipe_stats = _openpose_offload_walls(frames, in_flight,
                                                      device)
    bp = backpressure_probe()
    t_plain, t_coal, stats = _coalesce_walls(device=device)
    fairness = tenant_fairness_probe()
    ring = recv_ring_probe()
    drain = drain_rehome_probe()
    intra_op = intra_op_scaling_probe()
    shm = shm_probe()
    quant = comm_quant_probe()
    return {
        "serialize_raw_512x512": {
            "payload_bytes": nb,
            "vectored_gbps": nb / t["t_vec"] / 1e9,
            "seed_joined_gbps": nb / t["t_seed"] / 1e9,
            "speedup_vs_seed": t["t_seed"] / t["t_vec"],
            "unpack_view_gbps": nb / t["t_view"] / 1e9,
            "unpack_copy_gbps": nb / t["t_copy"] / 1e9,
        },
        "pipelined_offload_openpose": {
            "frames": frames,
            "max_in_flight": in_flight,
            "sync_wall_s": t_sync,
            "pipelined_wall_s": t_pipe,
            "speedup": t_sync / t_pipe,
            "adaptive_window": pipe_stats["window"],
            "send_stalls": pipe_stats["send_stalls"],
            "wire_ema_s": pipe_stats["wire_ema_s"],
            "compute_ema_s": pipe_stats["compute_ema_s"],
            "metrics": pipe_stats.get("metrics", {}),
        },
        "backpressure_small_sockbuf": bp,
        "recv_ring_buffer": ring,
        "shm_vs_tcp_localhost": shm,
        "comm_quant_narrow_link": quant,
        "tenant_fairness_2way": fairness,
        "drain_rehome": drain,
        "intra_op_scaling": intra_op,
        "coalesced_dispatch": {
            "clients": 8, "reps": 4,
            "uncoalesced_wall_s": t_plain,
            "coalesced_wall_s": t_coal,
            "speedup": t_plain / t_coal,
            "stats": stats,
        },
    }


def bench_transport() -> list:
    from repro_torch.core.transport import TCPChannel, TCPServer
    server = TCPServer(lambda b: b).start()
    ch = TCPChannel.connect("127.0.0.1", server.port)
    small, big = b"x" * 64, b"x" * (4 << 20)
    r1 = _time(lambda: ch.request(small), n=50)
    r2 = _time(lambda: ch.request(big), n=10)
    ch.close()
    server.stop()
    return [("tcp/roundtrip_64B", r1 * 1e6, ""),
            ("tcp/roundtrip_4MB", r2 * 1e6,
             f"{(len(big) * 2) / r2 / 1e6:.0f}MB/s")]


def _kernel_inputs(device="cuda") -> dict:
    """``bench_kernels``' float32 inputs, drawn from seed 0 on ``device``:
    q, k and v (1, 8, 512, 64) in the kernels' (B, H, S, D) layout, and x
    (4096, 1024) with an rmsnorm scale of ones."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    q, k, v = (torch.randn(1, 8, 512, 64, generator=g, device=dev) for _ in range(3))
    x = torch.randn(4096, 1024, generator=g, device=dev)
    return {"q": q, "k": k, "v": v, "x": x, "scale": torch.ones(1024, device=dev)}


def bench_kernels(device="cuda") -> list:
    """The hot ops through ``kernels.ops`` at the JAX package's shapes: the
    hand-written kernels when the inputs are on the card, their plain
    versions on the CPU; ``derived`` names which ran."""
    from repro_torch.kernels import ops

    t = _kernel_inputs(device)
    q, k, v = (t[n].transpose(1, 2) for n in "qkv")     # the ops' (B, S, H, D) view
    x, s = t["x"], t["scale"]
    wait = _sync(device)
    t1 = _time(lambda: wait(ops.flash_attention(q, k, v)))
    t2 = _time(lambda: wait(ops.rmsnorm(x, s)))
    t3 = _time(lambda: wait(ops.quantize_int8(x)))
    impl = "cuda" if x.is_cuda else "plain"
    return [("kernel_ref/attention_8h_512", t1 * 1e6, impl),
            ("kernel_ref/rmsnorm_4Mx", t2 * 1e6, impl),
            ("kernel_ref/quant_int8_4MB", t3 * 1e6, impl)]


def _moe_inputs(cfg, device="cuda") -> tuple[dict, torch.Tensor]:
    """``bench_moe_dispatch``'s inputs on ``device``: layer 0's MoE
    parameters of ``cfg`` (seed 0; the rest of the model is dropped) and
    (8, 64) tokens drawn from seed 1 in the model's compute dtype, as its
    blocks hand them to the layer."""
    from repro_torch.models import model as M
    from repro_torch.utils import tree_map

    dev = resolve_device(device)
    params = M.init_params(cfg, 0, device=dev)
    moe_p = tree_map(lambda a: a[0], params["blocks"])["layers"][0]["moe"]
    del params
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    x = torch.randn(8, 64, cfg.d_model, generator=g, device=dev)
    return moe_p, x.to(getattr(torch, cfg.compute_dtype))


def bench_moe_dispatch(cfg=None, device="cuda") -> list:
    """One MoE layer's dispatch (``models.moe.apply_moe``) on (8, 64)
    tokens; ``cfg`` is reduced arctic-480b unless given."""
    from repro_torch.models.moe import apply_moe

    cfg = cfg or reduced(get_arch("arctic-480b"))
    moe_p, x = _moe_inputs(cfg, device)
    wait = _sync(device)
    with torch.inference_mode():
        t = _time(lambda: wait(apply_moe(cfg, moe_p, x)[0]))
    toks = x.shape[0] * x.shape[1]
    return [(f"moe/dispatch_{toks}tok_{cfg.moe.num_experts}e", t * 1e6,
             f"{toks / t:.0f}tok/s")]


def bench_engine(cfg=None, device="cuda") -> list:
    """Continuous batching: 8 requests of 8 prompt tokens, 8 new tokens
    each, through 4 slots; ``cfg`` is reduced granite-3-2b unless given."""
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = cfg or reduced(get_arch("granite-3-2b"))
    params = M.init_params(cfg, 0, device=device)
    eng = ServingEngine(cfg, params, max_batch=4, max_len=64, device=device)
    rng = np.random.default_rng(0)
    for i in range(8):
        eng.submit(Request(f"r{i}", rng.integers(0, cfg.vocab_size, 8).tolist(),
                           max_new_tokens=8))
    wait = _sync(device)
    wait()
    t0 = time.perf_counter()
    out = wait(eng.run())
    dt = time.perf_counter() - t0
    toks = sum(len(v) for v in out.values())
    return [("engine/continuous_batching", dt * 1e6,
             f"{toks / dt:.0f}tok/s b=4")]


def bench_avec_offload_real(device="cuda") -> list:
    """Real loopback-TCP offload of the paper's workload (OpenPose-lite), its
    destination computing on ``device``: measures our framework's actual
    cycle overheads + Eq-1 style accounting."""
    import repro_torch.models.openpose as op
    from repro_torch.core.executor import DestinationExecutor, HostRuntime
    from repro_torch.core.interception import AvecSession
    from repro_torch.core.library import make_openpose_library
    from repro_torch.core.transport import TCPChannel, TCPServer
    from repro_torch.models.params import init_params
    from repro_torch.utils import to_numpy_tree

    net = op.OpenPoseLite()
    params = to_numpy_tree(init_params(op.op_param_specs(net), 0, torch.float32,
                                       device="cpu"))
    ex = DestinationExecutor({"openpose": make_openpose_library(net, device=device)},
                             device=device)
    server = TCPServer(ex.handle).start()
    ch = TCPChannel.connect("127.0.0.1", server.port)
    rt = HostRuntime(ch)
    sess = AvecSession(net, params, rt, "openpose")
    t_model = time.perf_counter()
    sess.ensure_model()
    t_model = time.perf_counter() - t_model
    frames = op.make_frames(1, 368, 656)
    for _ in range(3):
        sess.call("forward", {"frames": np.asarray(frames)})
    ch.close()
    server.stop()
    ex.shutdown()
    b = sess.profiler.breakdown()
    per = sess.profiler.per_cycle()
    return [
        ("avec_real/model_transfer", t_model * 1e6, "send-once"),
        ("avec_real/cycle_gpu", per["gpu_s"] * 1e6, ""),
        ("avec_real/cycle_comm", per["communication_s"] * 1e6,
         f"{per['bytes_per_cycle'] / 1e6:.2f}MB/cycle"),
        ("avec_real/comm_frac", b["communication_frac"] * 100, "percent"),
    ]


ALL_MICRO = [bench_serialization, bench_dataplane, bench_transport,
             bench_kernels, bench_moe_dispatch, bench_engine,
             bench_avec_offload_real]
