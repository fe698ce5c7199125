"""The destination of a run: a child process that owns the card.

Built from the port's own calls, as a deployed destination is:
``core.library.make_model_library`` behind ``core.executor.DestinationExecutor``
behind ``core.transport.TCPServer`` on loopback.  The weights are drawn on
the device from the seed (``weights.py``) in the port's parameter layout and
put into the executor's model cache under the model's fingerprint, as at a
destination that already serves the model.

Run as ``python destination.py '<json spec>'``.  It prints
``PORTBENCH {json}`` lines on standard output (first the port it listens
on) and takes one JSON command a line on standard input: ``trace_start``,
``trace_stop``, ``stats`` and ``exit``.  The ``fault`` field of the spec
breaks the timed path on purpose, for the tests that must see ``correct``
come out false: ``stale_state`` (a decode leaves the session's state as it
found it) or ``altered_logits`` (every fifth call's logits shifted by one
id where they are produced).
"""
from __future__ import annotations

import json
import os
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def say(msg: dict) -> None:
    sys.stdout.write("PORTBENCH " + json.dumps(msg) + "\n")
    sys.stdout.flush()


def port_config(cfg_json: dict):
    """The port's ModelConfig of the run: the registered architecture with
    the configuration file's fields in force."""
    from dataclasses import replace

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import SSMConfig

    fields = dict(cfg_json["port"]["fields"])
    if "ssm" in fields:
        fields["ssm"] = SSMConfig(**fields["ssm"])
    return replace(get_arch(cfg_json["port"]["arch"]), **fields)


def bad_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _wrap(lib: dict, tracer, fault):
    """The library with each prefill and decode announced to the tracer, and
    broken on purpose where ``fault`` asks."""
    import torch

    from portbench import weights

    calls = [0]

    def wrap(kind, fn):
        def call(params, state, args):
            n = int(args["tokens"].shape[1])
            tracer.on_call(kind, n, int(state.get("pos", 0)) if kind == "decode" else 0)
            if fault == "stale_state" and kind == "decode":
                saved = ({k: v.clone() for k, v in weights.leaves(state["cache"])},
                         state["pos"])
                out = fn(params, state, args)
                with torch.inference_mode():        # the cache is made under it
                    for k, v in weights.leaves(state["cache"]):
                        v.copy_(saved[0][k])
                state["pos"] = saved[1]
            else:
                out = fn(params, state, args)
            calls[0] += 1
            if fault == "altered_logits" and calls[0] % 5 == 0:
                out = {"logits": torch.roll(out["logits"], 1, dims=-1)}
            return out
        return call

    return {**lib, "prefill": wrap("prefill", lib["prefill"]),
            "decode": wrap("decode", lib["decode"])}


def main(spec: dict) -> None:
    t0 = time.perf_counter()
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) > 2:      # off the last core, the host's, and off the first,
        os.sched_setaffinity(0, cores[1:-1])      # which the machine's own work keeps
    sys.path[:1] = [spec["root"], spec["src"]]      # not this file's folder
    import torch

    from portbench import weights
    from portbench.devtrace import Tracer
    from portbench.harness import load_module
    from repro_torch.core.cache import model_fingerprint
    from repro_torch.core.executor import DestinationExecutor
    from repro_torch.core.library import make_model_library
    from repro_torch.core.transport import TCPServer

    device = torch.device(spec["device"])
    cfg_json = spec["config"]
    ref = load_module(cfg_json["reference"])
    cfg = port_config(cfg_json)

    build_s = 0.0
    if device.type == "cuda":
        torch.cuda.init()
        from repro_torch.kernels import _build
        _build.build()
        build_s = _build.last_build_s
    t1 = time.perf_counter()
    params = weights.make(ref.layout(cfg_json), spec["seed"], device)
    fp = model_fingerprint(cfg, params)
    if device.type == "cuda":
        torch.cuda.synchronize()
    weights_s = time.perf_counter() - t1

    tracer = Tracer()
    lib = _wrap(make_model_library(cfg, max_cache_len=spec["max_cache_len"], device=device),
                tracer, spec.get("fault"))
    ex = DestinationExecutor({"portbench": lib}, name="portbench", device=device)
    nbytes = sum(t.numel() * t.element_size() for _, t in weights.leaves(params))
    ex.cache.put(fp, {"lib": "portbench", "params": params, "state": {}, "extra": {}}, nbytes)
    server = TCPServer(ex.handle).start()
    say({"port": server.port, "fingerprint": fp, "build_s": build_s,
         "weights_s": weights_s, "start_s": time.perf_counter() - t0})
    for line in sys.stdin:
        cmd = json.loads(line)["cmd"]
        if cmd == "trace_start":
            tracer.start()
            say({"ok": True})
        elif cmd == "trace_stop":
            say({"trace": tracer.stop()})
        elif cmd == "stats":
            peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
            say({"memory_peak_bytes": int(peak)})
        elif cmd == "exit":
            break
    server.stop()
    ex.shutdown()
    say({"bad_modules": bad_modules()})


if __name__ == "__main__":
    main(json.loads(sys.argv[1]))
