"""The operation and byte counts against counts made by hand."""
import json
import os

import pytest

from portbench import peaks
from portbench.harness import load_module as _load

HERE = os.path.dirname(os.path.abspath(__file__))


def _cfg(name):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        return json.load(f)


def test_decode_attention_counts_by_hand():
    k = _load("kernels/decode_attention.py")
    # granite: 32 query heads over 8 KV heads of 64, 100 live keys, bf16
    assert k.flops(B=1, H=32, K=8, D=64, kv_len=100) == 2 * 2 * 32 * 64 * 100
    q_and_o = 2 * 32 * 64 * 2
    kv = 2 * 100 * 8 * 64 * 2
    assert k.nbytes(B=1, H=32, K=8, D=64, kv_len=100) == q_and_o + kv + 4


def test_flash_attention_counts_by_hand():
    k = _load("kernels/flash_attention.py")
    # S = 3: query i sees i + 1 keys, 6 pairs; each pair 2 * D for QK and 2 * D for PV
    assert k.flops(B=1, S=3, H=2, K=1, D=4) == 6 * 2 * (2 * 4 + 2 * 4)
    assert k.nbytes(B=1, S=3, H=2, K=1, D=4) == 2 * (3 * 2 * 4 * 2 + 3 * 1 * 4 * 2)


def test_ssd_scan_counts_by_hand():
    k = _load("kernels/ssd_scan.py")
    B, S, H, P, G, N = 1, 10, 3, 4, 1, 5
    assert k.flops(B=B, S=S, H=H, P=P, G=G, N=N) == S * H * (2 * P * N + 2 * P * N)
    x_y = 2 * (S * H * P) * 2
    bc = 2 * (S * G * N) * 2
    dt_a_state = 4 * (S * H) + 4 * H + 4 * (H * P * N)
    assert k.nbytes(B=B, S=S, H=H, P=P, G=G, N=N) == x_y + bc + dt_a_state


def test_bound_takes_the_slower_of_compute_and_bytes():
    assert peaks.bound_s(989e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.bound_s(989e12, 2 * 3.35e12) == pytest.approx(2.0)


def test_granite_call_flops_by_hand():
    ref, c = _load("configs/granite-3-2b.py"), _cfg("granite-3-2b")
    d, f, L, V = 2048, 8192, 40, 49155
    per_layer = 2 * (d * 32 * 64 + 2 * d * 8 * 64 + 32 * 64 * d) + 2 * 3 * d * f
    assert ref.call_flops(c, "decode", 1, 99) == L * per_layer + L * 32 * 4 * 64 * 100 + 2 * d * V
    S = 1024
    attn = L * 32 * 2 * 64 * S * (S + 1)
    assert ref.call_flops(c, "prefill", S, 0) == S * L * per_layer + attn + 2 * d * V
    # 2.538 B parameters, of which the tied embedding (51200 rows) is 105 M
    assert L * per_layer / 2 + 51200 * d + 2 * L * d + d == pytest.approx(2.538e9, rel=1e-3)


def test_mamba2_call_flops_by_hand():
    ref, c = _load("configs/mamba2-130m.py"), _cfg("mamba2-130m")
    d, di, nh, N, L, V = 768, 1536, 24, 128, 24, 50280
    proj = 2 * d * (2 * di + 2 * N + nh) + 2 * di * d
    conv = 2 * 4 * (di + 2 * N)
    scan = 4 * nh * 64 * N
    assert ref.call_flops(c, "decode", 1, 7) == L * (proj + conv + scan) + 2 * d * V
    assert ref.call_flops(c, "prefill", 10, 0) == 10 * L * (proj + conv + scan) + 2 * d * V
    assert ref.kernel_calls(c, "decode", 1, 7) == []
    (op, shape, n), = ref.kernel_calls(c, "prefill", 1000, 0)
    assert (op, n, shape["H"], shape["P"], shape["N"]) == ("ssd_scan", 24, 24, 64, 128)
