"""The metric readers and the trace reduction on made-up runs."""
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import devtrace, harness, peaks

GRANITE = harness.load_json("configs/granite-3-2b.json")
REF = harness.load_module("configs/granite-3-2b.py")


def _read(name, ctx):
    return harness.load_module(f"metrics/{name}.py").read(ctx)


def _ctx(calls, trace=None):
    return SimpleNamespace(calls=calls, window_s=2.0, setup_s=7.5, config=GRANITE,
                           reference=REF, trace=trace)


def test_reduce_splits_busy_and_idle_by_call():
    # call 0 (decode) marker at 100 ns: kernels 110-130 and 140-150, logits out
    # 160-170, the next call's tokens in 290-295; call 1 (prefill) at 300
    names = ["spin_kernel(long)", "k1", "k2", "Memcpy DtoH (Device -> Pageable)",
             "spin_kernel(long)", "k1", "Memcpy DtoH (Device -> Pageable)", "Memcpy HtoD"]
    st = np.array([100, 110, 140, 160, 300, 310, 330, 290])
    en = np.array([101, 130, 150, 170, 301, 320, 335, 295])
    out = devtrace.reduce(names, st, en, [{"kind": "decode", "tokens": 1, "pos": 5},
                                          {"kind": "prefill", "tokens": 9, "pos": 0}], 1.0)
    c0, c1 = out["calls"]
    assert c0["cycle_s"] == pytest.approx(200e-9) and c0["busy_s"] == pytest.approx(45e-9)
    assert c0["inside_idle_s"] == pytest.approx(30e-9)
    assert c0["after_idle_s"] == pytest.approx(125e-9)
    assert c1["busy_s"] == pytest.approx(15e-9) and c1["inside_idle_s"] == pytest.approx(20e-9)
    assert out["busy_s"] == pytest.approx(60e-9)
    assert out["names"][0] == "k1" and c0["kernels"][0] == pytest.approx(20e-9)
    with pytest.raises(RuntimeError):
        devtrace.reduce(names, st, en, [{"kind": "decode", "tokens": 1, "pos": 5}], 1.0)


def test_end_to_end_readers():
    calls = [{"kind": "prefill", "tokens": 100, "pos": 0, "rt_s": 0.5, "t_done_s": 0.5,
              "compute_s": 0.4, "comm_s": 0.1, "traced": False}]
    calls += [{"kind": "decode", "tokens": 1, "pos": 100 + i, "rt_s": 0.01 * (i + 1),
               "t_done_s": 0.5 + 0.1 * (i + 1), "compute_s": 0.008, "comm_s": 0.002,
               "traced": False}
              for i in range(20)]
    ctx = _ctx(calls)
    assert _read("itl_p95_ms", ctx) == pytest.approx(np.percentile(
        [10.0 * (i + 1) for i in range(20)], 95))
    assert _read("ttft_p95_ms", ctx) == pytest.approx(500.0)
    assert _read("tokens_per_s", ctx) == pytest.approx(16 / 2.0)     # 1 + 15 by 2 s
    assert _read("setup_s", ctx) == 7.5
    assert _read("offload_ms.decode", ctx) == pytest.approx(2.0)
    assert _read("compute_ms.prefill", ctx) == pytest.approx(400.0)
    flops = sum(REF.call_flops(GRANITE, "decode", 1, c["pos"]) for c in calls[1:])
    assert _read("mfu.decode", ctx) == pytest.approx(100 * flops / (20 * 0.008 * 989e12))
    # calls made while the profiler was on are left out of the host-clock spans
    slow = [{**c, "compute_s": 9.0, "comm_s": 9.0, "traced": True} for c in calls]
    ctx = _ctx(calls + slow)
    assert _read("offload_ms.decode", ctx) == pytest.approx(2.0)
    assert _read("compute_ms.prefill", ctx) == pytest.approx(400.0)
    assert _read("mfu.decode", ctx) == pytest.approx(100 * flops / (20 * 0.008 * 989e12))
    assert _read("decode_p95_ms", ctx) == pytest.approx(_read("itl_p95_ms", _ctx(calls)))
    assert _read("compute_ms.decode", _ctx(slow)) is None
    assert _read("decode_p95_ms", _ctx(slow)) is None


def test_trace_readers():
    trace = {"names": ["void (anonymous namespace)::decode_split_kernel<bf16, bf16, 64>()",
                       "nvjet_gemm"],
             "calls": [{"kind": "decode", "tokens": 1, "pos": 99, "cycle_s": 0.1,
                        "busy_s": 0.01, "kernels": {"0": 0.0002, "1": 0.005}},
                       {"kind": "prefill", "tokens": 64, "pos": 0, "cycle_s": 0.05,
                        "busy_s": 0.04, "kernels": {"1": 0.03}}]}
    ctx = _ctx([], trace)
    assert _read("device_idle.decode", ctx) == pytest.approx(90.0)
    assert _read("device_idle.prefill", ctx) == pytest.approx(20.0)
    k = harness.load_module("kernels/decode_attention.py")
    shape = {"B": 1, "H": 32, "K": 8, "D": 64, "kv_len": 100}
    want = 100 * 40 * peaks.bound_s(k.flops(**shape), k.nbytes(**shape)) / 0.0002
    assert _read("decode_attention_roofline", ctx) == pytest.approx(want)
    assert _read("flash_attention_roofline", ctx) is None          # no flash kernel traced
    assert _read("device_idle.decode", _ctx([], None)) is None
