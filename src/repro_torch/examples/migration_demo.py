"""Fault tolerance demo (paper future-work ii, implemented): a decode stream
is running against destination A; A dies mid-stream; the NEXT call through
the ``repro_torch.avec`` session detects the death (failed call + failed
ping probe), fails over to destination B restoring the host-side shadow
state, and retries — the stream continues byte-identical to an
uninterrupted run, and the application never handles the re-route.  Both
destinations compute on ``--device`` (the card unless the caller asks for
the CPU).

Run:  python -m repro_torch.examples.migration_demo [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch import avec
from repro_torch.configs import get_arch, reduced
from repro_torch.core import DestinationExecutor
from repro_torch.core.library import make_model_library
from repro_torch.core.virtualization import JETSON_TX2
from repro_torch.models import model as M
from repro_torch.serving.engine import generate_sequential
from repro_torch.utils import resolve_device, to_numpy_tree


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where both destinations compute (default: the card)")
    args = ap.parse_args(argv)
    run(reduced(get_arch("granite-3-2b")), device=args.device)


def run(cfg, *, device="cuda", kill_at: int = 4, echo=print) -> dict:
    """The demo on ``cfg`` -> what it prints, as a dict.  ``kill_at``: the
    decode step at which edge-a dies."""
    dev = resolve_device(device)
    params = to_numpy_tree(M.init_params(cfg, 0, device=dev))
    lib = make_model_library(cfg, max_cache_len=32, device=dev)
    executors = {n: DestinationExecutor({"lm": lib}, name=n, device=dev)
                 for n in ("edge-a", "edge-b")}
    res: dict = {}

    # one front door: both in-process executors behind calibrated edge specs;
    # shadow_every=1 snapshots the serving state after every call, so a
    # failover can restore the newest KV cache
    targets = [(dataclasses.replace(JETSON_TX2, name=n), ex)
               for n, ex in executors.items()]
    try:
        with avec.connect(targets, shadow_every=1) as client:
            sess = client.session(cfg, params, "lm", destination="edge-a")

            prompt = [5, 17, 3, 99, 42, 7]
            want = generate_sequential(cfg, params, prompt, 10, max_len=32, device=dev)
            res["want"] = want
            echo(f"reference stream (uninterrupted): {want}")

            sess.call("prefill", {"tokens": np.asarray([prompt], np.int32)})
            got = [want[0]]
            for step in range(1, 10):
                if step == kill_at:
                    echo(">>> killing edge-a mid-stream")
                    executors["edge-a"].fail = True
                    t0 = time.perf_counter()
                out = sess.call("decode",
                                {"tokens": np.asarray([[got[-1]]], np.int32)})
                if step == kill_at:
                    res["failover_s"] = time.perf_counter() - t0
                    res["cached"] = client.migration.migrations[-1]["cached"]
                    echo(f">>> transparent failover to {sess.destination} in "
                         f"{res['failover_s']:.3f}s (state from shadow, "
                         f"weights cached={res['cached']})")
                got.append(int(np.argmax(out["logits"][0, 0, :cfg.vocab_size])))
            res.update(got=got, destination=sess.destination)
            echo(f"stream with mid-flight failover:  {got}")
            assert got == want, "failover changed the stream!"
            assert sess.destination == "edge-b"
            echo("OK: failover preserved the decode stream exactly — the "
                 "application only ever called sess.call()")
    finally:
        for ex in executors.values():
            ex.shutdown()
    return res


if __name__ == "__main__":
    main()
