"""One run of one cell, as an edge device drives an AVEC destination.

The host process starts the destination (``destination.py``) in a child
process that owns the card, connects to it through the port's front door
(``repro_torch.avec.connect`` over loopback TCP, raw codec) and opens one
session on the model, which the destination already holds.  It warms up
each prompt length of the cell's mix, then runs a closed loop for the
window: a prefill per request, greedy sampling on the host from the logits
each call returns, one decode call per further token.  A traced run turns
the destination's device trace on halfway through the window, at a call's
start: the host-clock spans are read from the calls of the first half,
which the profiler does not slow, the device's figures from the second.
The host never uses
CUDA before the window has closed and the destination has exited; then the
plain reference checks the logits the host received (``check.py``).

Everything that belongs to one cell is found by name: the cell's entry and
its configuration in ``BENCHMARK.json``, the configuration file and its
reference, the mix under ``mixes/``, the check's limits under ``limits/``,
and a reader per metric under ``metrics/``.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np

from portbench import traffic
from portbench.destination import FORBIDDEN, port_config

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SRC = os.path.join(ROOT, "src")
KERNEL_BUILD_DIR = os.path.join(SRC, "repro_torch", "kernels", "_build")
#: warm-up decodes after each warm-up prompt (the decode's shapes do not
#: change with the position; two calls also warm the wire's buffers)
WARM_DECODES = 2

_modules: dict = {}


def load_module(path: str):
    """A file under the benchmark's folder, imported by its path (file names
    carry the names of ``BENCHMARK.json``, dots and dashes included)."""
    name = "portbench_" + re.sub(r"\W", "_", path[:-3])
    path = os.path.join(HERE, path)
    if path not in _modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _modules[path] = mod
    return _modules[path]


def load_json(path: str) -> dict:
    with open(os.path.join(HERE, path) if not os.path.isabs(path) else path) as f:
        return json.load(f)


def cell_files(manifest: dict, workload: str) -> tuple[dict, dict, dict]:
    """(the cell's entry, its configuration file, its mix), read as JSON."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    mix = traffic.validate(load_json(f"mixes/{cell['traffic']}.json"),
                           f"mixes/{cell['traffic']}.json")
    return cell, load_json(os.path.join(ROOT, entry["file"])), mix


def cell_spec(manifest: dict, workload: str) -> SimpleNamespace:
    cell, cfg, mix = cell_files(manifest, workload)

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    return SimpleNamespace(
        name=workload, cell=cell, config=cfg, reference=load_module(cfg["reference"]), mix=mix,
        end_to_end=[m for m in manifest["end_to_end"] if applies(m)],
        per_layer=[m for m in manifest["per_layer"] if applies(m)])


class Destination:
    """The child process and its command channel."""

    def __init__(self, spec: dict) -> None:
        # every build and kernel cache at a fixed place in the checkout
        cache = os.path.join(ROOT, ".portbench_cache")
        env = {**os.environ, "REPRO_TORCH_BUILD_DIR": KERNEL_BUILD_DIR,
               "TRITON_CACHE_DIR": os.path.join(cache, "triton"),
               "TORCH_EXTENSIONS_DIR": os.path.join(cache, "torch_extensions")}
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "destination.py"), json.dumps(spec)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, env=env)
        self.ready: dict | None = None

    def wait_ready(self) -> dict:
        if self.ready is None:
            self.ready = self.read()
            self.ready["at_s"] = time.perf_counter() - self.t0
        return self.ready

    def read(self) -> dict:
        for line in self.proc.stdout:
            if line.startswith("PORTBENCH "):
                return json.loads(line[len("PORTBENCH "):])
        rc = self.proc.wait()
        raise RuntimeError(f"the destination process ended (exit {rc}); its errors are above")

    def ask(self, cmd: str) -> dict:
        self.proc.stdin.write(json.dumps({"cmd": cmd}) + "\n")
        self.proc.stdin.flush()
        return self.read()

    def close(self) -> dict:
        try:
            out = self.ask("exit")
        finally:
            self.proc.stdin.close()
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        return out

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def _call(sess, kind: str, tokens: np.ndarray, vocab: int, t_window: float):
    t = time.perf_counter()
    out = sess.call(kind, {"tokens": tokens})
    done = time.perf_counter()
    lg = np.array(out["logits"][0, -1, :vocab], dtype=np.float32)
    return lg, done - t, done - t_window


def drive(sess, spec, seed: int, seconds: float, vocab: int, t_window: float,
          at_half=None) -> dict:
    """The window's closed loop.  Every call issued before the window closes
    is timed and counted; a token counts towards the rate if it arrived
    before the close.  Requests not finished at the close are not checked.
    A call that raises ends the window and is counted as failed.  Before the
    first call that starts past the window's middle, ``at_half()`` runs once
    (the trace's start); that call and the later ones are marked ``traced``."""
    deadline = t_window + seconds
    half = t_window + seconds / 2 if at_half else math.inf
    traced = False
    calls, reqs, failed = [], [], 0
    try:
        for prompt, n_dec in traffic.requests(spec.mix, seed, vocab):
            if time.perf_counter() >= deadline:
                break
            req = {"prompt": prompt, "served": [], "logits": [], "finished": False}
            reqs.append(req)
            kind, toks, pos = "prefill", prompt[None, :], 0
            for j in range(n_dec + 1):
                now = time.perf_counter()
                if j and now >= deadline:
                    break
                if not traced and now >= half:
                    at_half()
                    traced = True
                lg, rt, t_done = _call(sess, kind, toks, vocab, t_window)
                calls.append({"kind": kind, "tokens": int(toks.shape[1]), "pos": pos,
                              "rt_s": rt, "t_done_s": t_done, "traced": traced})
                req["logits"].append(lg)
                tok = int(np.argmax(lg))
                req["served"].append(tok)
                kind, pos = "decode", len(prompt) + j
                toks = np.array([[tok]], dtype=np.int32)
            else:
                req["finished"] = True
    except Exception as e:  # noqa: BLE001 -- the run reports it and is not correct
        print(f"portbench: call {len(calls)} failed: {type(e).__name__}: {e}", file=sys.stderr)
        failed = 1
    return {"calls": calls, "requests": reqs, "failed": failed}


def start_destination(manifest: dict, workload: str, seed: int, device: str = "cuda",
                      fault: str | None = None) -> Destination:
    """Start the cell's destination; it loads while the host imports."""
    _, cfg, mix = cell_files(manifest, workload)
    return Destination({"root": ROOT, "src": SRC, "config": cfg, "device": device,
                        "seed": seed, "fault": fault, "max_cache_len": mix["max_cache_len"]})


def run_cell(manifest: dict, workload: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device: str = "cuda", limits: dict | None = None,
             fault: str | None = None, control: bool = False,
             dest: Destination | None = None) -> tuple[dict, list]:
    """-> (the result line's object, the check's (name, value, limit) rows)."""
    dest = dest or start_destination(manifest, workload, seed, device, fault)
    try:
        t_imp = time.perf_counter()
        from repro_torch import avec
        from repro_torch.core.cache import model_fingerprint
        from repro_torch.models.model import abstract_params

        from portbench import check

        spec = cell_spec(manifest, workload)
        limits = limits if limits is not None else load_json(f"limits/{workload}.json")
        mix, cfg_json = spec.mix, spec.config
        vocab = cfg_json["vocab_size"]
        cfg = port_config(cfg_json)
        meta = abstract_params(cfg)
        t_imp_done = time.perf_counter()
        ready = dest.wait_ready()
        if ready["fingerprint"] != model_fingerprint(cfg, meta):
            raise RuntimeError("the benchmark's weights do not have the port's parameter "
                               f"layout (fingerprint {ready['fingerprint']}, the port's "
                               f"{model_fingerprint(cfg, meta)})")
        client = avec.connect([f"tcp://127.0.0.1:{ready['port']}"], codec="raw",
                              prefer_shm=False, shadow_every=0)
        try:
            sess = client.session(cfg, meta, "portbench")
            if not sess.ensure_model():
                raise RuntimeError("the session did not find the model resident")
            t_warm = time.perf_counter()
            for prompt in traffic.warmup_prompts(mix, seed, vocab):
                sess.call("prefill", {"tokens": prompt[None, :]})
                for _ in range(WARM_DECODES if mix["decode_tokens"] else 0):
                    sess.call("decode", {"tokens": prompt[None, :1]})
            n_warm = len(sess.profiler.cycles)
            t_window = time.perf_counter()
            print(f"setup: {t_window - t_start:.3f} s; the host's imports of the program "
                  f"from {t_imp - t_start:.3f} s took {t_imp_done - t_imp:.3f} s; destination "
                  f"ready {ready['at_s']:.3f} s after its start (kernel build "
                  f"{ready['build_s']:.3f} s, weights {ready['weights_s']:.3f} s); warm-up "
                  f"{t_window - t_warm:.3f} s", file=sys.stderr)
            run = drive(sess, spec, seed, seconds, vocab, t_window,
                        (lambda: dest.ask("trace_start")) if trace else None)
            tr = dest.ask("trace_stop")["trace"] if trace else None
            if tr is not None:
                print(f"trace: the window's last {tr['window_s']:.3f} s, "
                      f"{sum(c['traced'] for c in run['calls'])} of {len(run['calls'])} "
                      f"calls; {sum(len(c['kernels']) for c in tr['calls'])} (call, kernel) "
                      f"sums, reduced in {tr['reduce_s']:.3f} s", file=sys.stderr)
            cycles = sess.profiler.cycles[n_warm:]
        finally:
            client.close()
        peak = dest.ask("stats")["memory_peak_bytes"]
        child_bad = dest.close()["bad_modules"]
    finally:
        dest.kill()
    if len(cycles) != len(run["calls"]):
        raise RuntimeError(f"{len(cycles)} profiled cycles for {len(run['calls'])} calls")
    for c, cyc in zip(run["calls"], cycles):
        c["compute_s"], c["comm_s"] = cyc.gpu_s, cyc.comm_s

    readings = check.compare(spec, seed, run["requests"], device, control=control)
    rows = [("compared_tokens", readings["compared_tokens"], 1, "min")]
    rows += [(k, readings[k], limits[k]["limit"], "max") for k in check.NUMBERS]
    if control:
        rows += [(f"control.{k}", readings[f"control.{k}"], limits[k]["limit"], "max")
                 for k in check.NUMBERS]
    ok = all(v >= lim if how == "min" else v <= lim for name, v, lim, how in rows
             if not name.startswith("control."))

    ctx = SimpleNamespace(cell=workload, config=cfg_json, mix=mix, reference=spec.reference,
                          calls=run["calls"], window_s=seconds, setup_s=t_window - t_start,
                          trace=tr)
    metrics = {}
    for m in (spec.per_layer if trace else spec.end_to_end):
        value = load_module(f"metrics/{m['name']}.py").read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if child_bad:
        raise ForbiddenModules(child_bad)
    result = {"correct": bool(ok and not run["failed"]),
              "attempted": len(run["calls"]) + run["failed"], "failed": run["failed"],
              "metrics": metrics, "device": _device_info(device, peak, tr)}
    if tr is not None:
        result["breakdown"] = {"device_ops": tr["top_ops"], "idle_gaps": tr["idle_gaps"]}
    result["checks"] = {name: {"value": v, "limit": lim, "limit_is": how}
                        for name, v, lim, how in rows}
    return result, rows


class ForbiddenModules(RuntimeError):
    """A process of the run loaded a module it may not load."""

    def __init__(self, names) -> None:
        super().__init__("modules loaded that a run may not load: " + ", ".join(names)
                         + f" (top-level names checked: {', '.join(FORBIDDEN)})")


def _device_info(device: str, peak: int, tr) -> dict:
    if device == "cuda":
        import torch
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
                "memory_peak_bytes": peak}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    if tr is not None:
        info["busy_s"] = tr["busy_s"]
        info["window_s"] = tr["window_s"]
    return info
