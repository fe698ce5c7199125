"""Whole runs on the CPU at a tiny size: the harness skips its look for a
card and drives the rest of a run (destination process, front door, window,
check).  Clean runs are correct and their last line follows the contract's
schema; a timed path broken underneath makes ``correct`` false."""
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import harness, traffic

HERE = os.path.dirname(os.path.abspath(__file__))
# tiny sizes read gap <= 0.003 and logit_err <= 0.02 with bf16, the fp8
# control 0.026-0.035 and 0.17-0.26 (two configurations, one seed each)
TINY_LIMITS = {"gap": {"limit": 0.012}, "logit_err": {"limit": 0.06}}


def _manifest(config):
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        e2e = json.load(f)["end_to_end"]
    return {"configs": [{"name": config, "file": f"portbench/testdata/{config}.json"}],
            "workloads": [{"name": "tiny.chat", "config": config,
                           "traffic": "../testdata/tiny-chat", "chips": 1}],
            "end_to_end": [{k: v for k, v in m.items() if k != "workloads"} for m in e2e],
            "per_layer": []}


def _run(config, fault=None, control=False, seed=2 ** 31 + 17):
    return harness.run_cell(_manifest(config), "tiny.chat", seed, 1.5, False,
                            t_start=time.perf_counter(), device="cpu", limits=TINY_LIMITS,
                            fault=fault, control=control)


@pytest.mark.parametrize("config", ["tiny-dense", "tiny-ssm"])
def test_clean_run_is_correct_and_the_control_is_not(config):
    result, rows = _run(config, control=True)
    assert result["correct"] is True, rows
    checks = result["checks"]
    assert checks["compared_tokens"]["value"] >= 7
    assert any(checks[f"control.{k}"]["value"] > TINY_LIMITS[k]["limit"]
               for k in ("gap", "logit_err")), checks
    line = json.loads(json.dumps(result))
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"itl_p95_ms", "tokens_per_s", "ttft_p95_ms", "setup_s"}
    assert all(set(m) == {"value", "unit"} and m["value"] > 0 for m in line["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])


@pytest.mark.parametrize("config,fault", [("tiny-dense", "stale_state"),
                                          ("tiny-dense", "altered_logits"),
                                          ("tiny-ssm", "stale_state"),
                                          ("tiny-ssm", "altered_logits")])
def test_broken_timed_path_is_not_correct(config, fault):
    result, rows = _run(config, fault=fault)
    assert result["correct"] is False, rows


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    p = subprocess.run([sys.executable, os.path.join(HERE, "run.py"), "--workload",
                        "granite-3-2b.chat", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=harness.ROOT, timeout=120,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_the_trace_starts_once_halfway_and_marks_the_later_calls():
    class Session:
        def call(self, kind, args):
            time.sleep(0.01)
            return {"logits": np.zeros((1, args["tokens"].shape[1], 32), np.float32)}

    spec = SimpleNamespace(mix=traffic.validate(harness.load_json("testdata/tiny-chat.json")))
    started = []
    t0 = time.perf_counter()
    run = harness.drive(Session(), spec, 5, 0.6, 32, t0, lambda: started.append(
        time.perf_counter() - t0))
    flags = [c["traced"] for c in run["calls"]]
    assert len(started) == 1 and 0.3 <= started[0] < 0.35
    assert flags == sorted(flags) and 0 < sum(flags) < len(flags)
    assert all(c["t_done_s"] - c["rt_s"] >= 0.3 for c in run["calls"] if c["traced"])
    assert not any(c["traced"] for c in harness.drive(Session(), spec, 5, 0.2, 32,
                                                      time.perf_counter())["calls"])
