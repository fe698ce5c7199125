"""Serving entrypoint: stand up a destination executor (TCP), drive one or
more destinations as an ``avec.connect`` host, or run the continuous-batching
engine locally.

  # destination node (the "edge/cloud GPU server"):
  PYTHONPATH=src python -m repro_torch.launch.serve --role destination --port 9000

  # host node streaming requests at destination(s) through the facade —
  # handshake-negotiated pipelined runtime, scheduler-routed, sharded when
  # several destinations are given (prints the adaptive in-flight window +
  # backpressure counters from the runtime stats):
  PYTHONPATH=src python -m repro_torch.launch.serve --role host \
      --connect 127.0.0.1:9000,127.0.0.1:9001 --requests 32

  # local engine demo:
  PYTHONPATH=src python -m repro_torch.launch.serve --role local --requests 8

Every role runs on the card (``--device cuda``, the default); add
``--device cpu`` to run it on the CPU.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import avec
from repro_torch.configs import get_arch, list_archs, reduced
from repro_torch.core.executor import DestinationExecutor
from repro_torch.core.library import make_model_library
from repro_torch.core.shm import SharedMemoryServer
from repro_torch.core.transport import TCPServer
from repro_torch.models import model as M
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.config import global_config
from repro_torch.obs.trace import emit
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.utils import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b", choices=list_archs())
    ap.add_argument("--role", default="local",
                    choices=["local", "destination", "host"])
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--connect", default="127.0.0.1:9000",
                    help="host role: comma-separated destination "
                         "addresses host:port[,host:port...]; a "
                         "shm:///path/doorbell.sock entry dials a "
                         "same-host shared-memory destination directly")
    ap.add_argument("--codec", default="raw",
                    help="host role: requested wire codec (downgraded to "
                         "what the peer advertises)")
    ap.add_argument("--transport", default="tcp",
                    choices=["tcp", "shm", "both"],
                    help="destination role: listeners to stand up.  'shm' "
                         "serves same-host clients over a shared-memory "
                         "ring (mmap zero-copy); 'both' adds the SHM "
                         "doorbell beside TCP and advertises it in the "
                         "handshake so same-host clients auto-upgrade")
    ap.add_argument("--shm-path", default=None,
                    help="destination role: AF_UNIX doorbell path for the "
                         "SHM listener (default: a fresh temp dir)")
    ap.add_argument("--coalesce", action="store_true",
                    help="destination role: micro-batch concurrent "
                         "batchable run ops into stacked dispatches")
    ap.add_argument("--tenant-weights", default="",
                    help="destination role: pin per-tenant fair-drain "
                         "weights, e.g. acme:3,beta:1 (overrides "
                         "frame-declared qos)")
    ap.add_argument("--tenant-max-inflight", type=int, default=0,
                    help="destination role: per-tenant admission cap on "
                         "concurrent run requests (0 = unlimited; beyond "
                         "it the tenant gets TenantThrottled)")
    ap.add_argument("--tenant-max-bytes", type=float, default=0.0,
                    help="destination role: per-tenant admission cap on "
                         "in-flight payload bytes (0 = unlimited)")
    ap.add_argument("--tenant", default=None,
                    help="host role: tenant identity for the session "
                         "(isolated destination caches + fair-share drain)")
    ap.add_argument("--qos-weight", type=float, default=1.0,
                    help="host role: declared fair-share weight")
    ap.add_argument("--qos-priority", type=int, default=0,
                    help="host role: declared priority class (higher "
                         "drains first)")
    ap.add_argument("--drain", action="store_true",
                    help="destination role: exit via zero-downtime drain — "
                         "on ctrl-c stop admitting (DestinationDraining "
                         "bounces tell clients to re-home to their warm "
                         "standbys), bleed the QoS queues, then stop")
    ap.add_argument("--drain-timeout", type=float, default=30.0,
                    help="destination role: max seconds to wait for "
                         "in-flight work to bleed during --drain")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-in-flight", type=int, default=8,
                    help="host role: in-flight window cap (adaptive below)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="destination role: serve Prometheus text on "
                         "http://127.0.0.1:PORT/metrics (default: the "
                         "metrics_port knob / AVEC_METRICS_PORT; 0 = off)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the weights live and the destination or "
                         "local engine computes (cuda unless cpu is asked "
                         "for; no quiet fallback)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = reduced(get_arch(args.arch))
    params = M.init_params(cfg, args.seed, device)

    if args.role == "destination":
        lib = make_model_library(cfg, max_cache_len=args.max_len, device=device)
        weights = {}
        for part in args.tenant_weights.split(","):
            if part.strip():
                tname, _, w = part.partition(":")
                weights[tname.strip()] = float(w or 1.0)
        ex = DestinationExecutor({"lm": lib}, name=f"{args.arch}-dest",
                                 coalesce=args.coalesce,
                                 tenant_weights=weights or None,
                                 tenant_max_inflight=args.tenant_max_inflight,
                                 tenant_max_bytes=args.tenant_max_bytes,
                                 device=device)
        server = shm_server = None
        if args.transport in ("tcp", "both"):
            server = TCPServer(ex.handle, port=args.port).start()
            # the recv-pool lives on the server, not the executor — bind it
            # into the executor's registry so one scrape covers the whole
            # destination
            obs_metrics.bind_server(ex.metrics, server)
        if args.transport in ("shm", "both"):
            shm_server = SharedMemoryServer(ex.handle,
                                            path=args.shm_path).start()
            # advertised in every ping reply: same-host clients that dialed
            # TCP see the doorbell and silently re-dial over the ring
            ex.shm_address = shm_server.address
            obs_metrics.bind_pool_stats(ex.metrics, shm_server.pool_stats,
                                        pool="shm-server")
            emit("shm_listening", path=shm_server.address,
                 ring_bytes=shm_server.ring_bytes)
        metrics_port = int(global_config().resolve("metrics_port",
                                                   args.metrics_port))
        msrv = None
        if metrics_port > 0:
            msrv = obs_metrics.MetricsServer(ex.metrics,
                                             port=metrics_port).start()
            emit("metrics_listening", port=msrv.port,
                 url=f"http://127.0.0.1:{msrv.port}/metrics")
        emit("destination_listening", arch=args.arch,
             port=server.port if server is not None else None,
             transport=args.transport,
             coalesce=args.coalesce, tenant_weights=weights,
             tenant_max_inflight=args.tenant_max_inflight,
             tenant_max_bytes=args.tenant_max_bytes)
        try:
            while True:
                time.sleep(1)
        except KeyboardInterrupt:
            if args.drain:
                # zero-downtime exit: stop admitting (clients re-home on the
                # DestinationDraining bounce; ping keeps advertising
                # "draining" so schedulers stop routing here), bleed every
                # QoS queue, THEN tear the server down — in-flight requests
                # finish and their responses go out before the socket dies
                emit("drain_begin", name=ex.name, pending=ex.pending_work())
                res = ex.drain(timeout_s=args.drain_timeout)
                emit("drain_end", name=ex.name, drained=res["drained"],
                     pending=res["pending"], replay_hits=ex.replay_hits)
            if msrv is not None:
                msrv.stop()
            if shm_server is not None:
                shm_server.stop()
            if server is not None:
                server.stop()
            ex.shutdown()
        return

    if args.role == "host":
        targets = [addr.strip() if addr.strip().startswith(("tcp://",
                                                            "shm://"))
                   else f"tcp://{addr.strip()}"
                   for addr in args.connect.split(",") if addr.strip()]
        with avec.connect(targets, codec=args.codec, shadow_every=0,
                          max_in_flight=args.max_in_flight) as client:
            for name in client.destinations:
                caps = client.capabilities(name)
                emit("handshake", destination=name,
                     protocol_version=caps.protocol_version,
                     runtime=type(client.runtime(name)).__name__,
                     codec=client.codec_for(name), coalesce=caps.coalesce,
                     config=caps.config)
            sess = client.session(
                cfg, params, "lm", tenant=args.tenant,
                qos=avec.QoS(weight=args.qos_weight,
                             priority=args.qos_priority))
            rng = np.random.default_rng(args.seed)
            prompts = {f"r{i}": {"tokens": rng.integers(
                0, cfg.vocab_size, (1, 16)).astype(np.int32),
                "targets": rng.integers(0, cfg.vocab_size, (1, 16))
                .astype(np.int32)} for i in range(args.requests)}
            t0 = time.perf_counter()
            sess.map("score", prompts)
            dt = time.perf_counter() - t0
            emit("offload_complete", requests=args.requests, seconds=dt,
                 req_per_s=args.requests / dt,
                 assigned=sess.last_map_stats["assigned"])
            for name, s in client.stats().items():
                if "window" not in s:
                    continue
                emit("runtime_stats", destination=name, window=s["window"],
                     max_in_flight=s["max_in_flight"],
                     wire_ema_ms=s["wire_ema_s"] * 1e3,
                     compute_ema_ms=s["compute_ema_s"] * 1e3,
                     send_stalls=s["send_stalls"],
                     sends_resumed=s["sends_resumed"],
                     recv_retries=s["recv_retries"],
                     bytes_sent=s["bytes_sent"],
                     bytes_received=s["bytes_received"])
            for name in client.destinations:
                ts = client.refresh_capabilities(name).tenant_stats
                for tenant, row in sorted(ts.items()):
                    emit("tenant_stats", destination=name, tenant=tenant,
                         drain_share=row.get("drain_share", 0.0),
                         served=row.get("served", 0),
                         throttled=row.get("throttled", 0),
                         queue_depth=row.get("queue_depth", 0))
        return

    eng = ServingEngine(cfg, params, max_batch=args.max_batch,
                        max_len=args.max_len, device=device)
    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        eng.submit(Request(f"r{i}",
                           rng.integers(0, cfg.vocab_size,
                                        rng.integers(4, 16)).tolist(),
                           max_new_tokens=16))
    t0 = time.perf_counter()
    out = eng.run()
    dt = time.perf_counter() - t0
    toks = sum(len(v) for v in out.values())
    emit("engine_complete", requests=args.requests, tokens=toks, seconds=dt,
         tok_per_s=toks / dt, engine_ticks=eng.steps)


if __name__ == "__main__":
    main()
