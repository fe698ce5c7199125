"""End-to-end example (the paper's kind: inference offload serving), wired
entirely through the ``repro_torch.avec`` facade — the one front door.

Topology, all real processes-and-sockets on this host:

  [host client]  --TCP-->  [destination A: "edge" executor]
                 --TCP-->  [destination B: "cloud" executor]

``avec.connect`` handshakes both destinations (protocol version, codecs,
pipelining, coalescing), the device-aware scheduler picks one per the
calibrated cost model, weights are transferred once (send-once cache),
batched requests stream through prefill/decode, a stateless ``score`` batch
is sharded across BOTH destinations via ``session.map``, and the profiler
prints the paper's GPU/communication/other cycle breakdown (Figs. 8-9
analogue) plus FPS (Table V analogue).  Both destinations compute on
``--device`` (the card unless the caller asks for the CPU).

Run:  python -m repro_torch.examples.offload_serving [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch import avec
from repro_torch.configs import get_arch, reduced
from repro_torch.core import DestinationExecutor
from repro_torch.core.costmodel import Workload
from repro_torch.core.library import make_model_library
from repro_torch.core.transport import TCPServer
from repro_torch.core.virtualization import CLOUD_RTX, JETSON_TX2
from repro_torch.utils import resolve_device, to_numpy_tree


def run(cfg, *, device="cuda", params=None, seed: int = 0, timeout: float | None = None,
        echo=print) -> dict:
    """The demo on ``cfg`` -> what it prints, as a dict.  ``params``: a host
    (numpy) parameter tree in the JAX package's layout; made from ``seed``
    when omitted.  ``timeout``: the RPC timeout (``None``: the knob's)."""
    from repro_torch.models import model as M

    dev = resolve_device(device)
    if params is None:
        params = to_numpy_tree(M.init_params(cfg, seed, device=dev))
    lib = make_model_library(cfg, max_cache_len=64, device=dev)

    # two live destinations behind real TCP servers
    specs = {"edge-a": JETSON_TX2, "cloud-b": CLOUD_RTX}
    servers, targets, execs = {}, [], []
    for name, spec in specs.items():
        ex = DestinationExecutor({"lm": lib}, name=name, device=dev)
        execs.append(ex)
        srv = TCPServer(ex.handle).start()
        servers[name] = srv
        targets.append((dataclasses.replace(spec, name=name),
                        f"tcp://127.0.0.1:{srv.port}"))

    # one front door: handshake + scheduler + runtime tier in one call
    # (state shadowing off: this demo measures the paper's cycle breakdown,
    # and per-call KV snapshots would inflate the wire numbers)
    w = Workload("lm-serve", flops=5e9, bytes_out=2e4, bytes_back=2e4,
                 model_bytes=1e7)
    res: dict = {"handshake": {}}
    try:
        with avec.connect(targets, shadow_every=0, timeout=timeout) as client:
            for name in client.destinations:
                caps = client.capabilities(name)
                res["handshake"][name] = {"protocol": caps.protocol_version,
                                          "runtime": type(client.runtime(name)).__name__,
                                          "codec": client.codec_for(name)}
                echo(f"[handshake] {name}: protocol v{caps.protocol_version}, "
                     f"runtime {type(client.runtime(name)).__name__}, "
                     f"codec {client.codec_for(name)}")
            sess = client.session(cfg, params, "lm", workload=w)
            res["destination"] = sess.destination
            echo(f"[scheduler] chose {sess.destination} "
                 f"(capability + cost-model routed)")

            t0 = time.perf_counter()
            res["cached"] = sess.ensure_model()
            res["model_transfer_s"] = time.perf_counter() - t0
            echo(f"[cache] model transfer: cached={res['cached']} "
                 f"{res['model_transfer_s']:.3f}s (send-once)")

            # batched requests: prefill once, stream decode steps (stateful —
            # stays on the scheduler-picked session)
            rng = np.random.default_rng(seed)
            prompts = rng.integers(0, cfg.vocab_size,
                                   size=(4, 8)).astype(np.int32)
            out = sess.call("prefill", {"tokens": prompts})
            toks = np.argmax(out["logits"][:, -1, :cfg.vocab_size], axis=-1)
            stream = [toks]
            for _ in range(16):
                out = sess.call("decode",
                                {"tokens": toks[:, None].astype(np.int32)})
                toks = np.argmax(out["logits"][:, 0, :cfg.vocab_size], axis=-1)
                stream.append(toks)
            gen = np.stack(stream, axis=1)
            res["prompts"], res["tokens"] = prompts, gen
            echo(f"[serve] generated {gen.shape} tokens for {gen.shape[0]} "
                 f"requests")
            echo(f"[serve] req0: {gen[0].tolist()}")

            # stateless scoring shards across ALL healthy destinations
            reqs = {f"r{i}": {"tokens": rng.integers(
                0, cfg.vocab_size, (1, 16)).astype(np.int32),
                "targets": rng.integers(0, cfg.vocab_size, (1, 16))
                .astype(np.int32)} for i in range(8)}
            t0 = time.perf_counter()
            scores = sess.map("score", reqs)
            res["map_s"] = time.perf_counter() - t0
            res["scores"] = {k: float(np.asarray(v["loss"])) for k, v in scores.items()}
            res["assigned"] = sess.last_map_stats["assigned"]
            echo(f"[shard] {len(scores)} score() calls over "
                 f"{res['assigned']} in {res['map_s']:.2f}s")

            b = sess.profiler.breakdown()
            res["breakdown"] = b
            res["fps"] = sess.profiler.fps()
            res["tok_s"] = res["fps"] * gen.shape[0]
            echo("[profile] paper Fig-8 style cycle breakdown:")
            echo(f"  GPU           {b['gpu_s']:.3f}s ({b['gpu_frac'] * 100:.1f}%)")
            echo(f"  Communication {b['communication_s']:.3f}s "
                 f"({b['communication_frac'] * 100:.1f}%)")
            echo(f"  Other         {b['other_s']:.3f}s")
            echo(f"  wire: {b['bytes_sent']} B out / {b['bytes_received']} B back "
                 f"over {b['cycles']} cycles")
            echo(f"  throughput: {res['tok_s']:.1f} tok/s "
                 f"({res['fps']:.1f} steps/s)")
    finally:
        for srv in servers.values():
            srv.stop()
        for ex in execs:
            ex.shutdown()
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="AVEC offload serving through avec.connect")
    ap.add_argument("--device", default="cuda",
                    help="where both destinations compute (default: the card)")
    args = ap.parse_args(argv)
    run(reduced(get_arch("granite-3-2b")), device=args.device)


if __name__ == "__main__":
    main()
