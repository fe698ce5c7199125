"""The port's micro benches and data-plane probes
(``repro_torch.benchmarks.micro``) against the JAX package's
``benchmarks/micro.py`` and the committed ``BENCH_dataplane.json``, on the
CPU at small arguments.

Each probe returns the keys of its ``BENCH_dataplane.json`` section (the
``metrics`` snapshots' metric names included), and the results that do not
depend on the clock (flags, counts, bytes, shard plans) equal the reference
probe's on the same arguments.  Walls, shares and speedups are never held:
under the tier-1 run's parallel workers they pick up scheduling gaps.
"""
import ast
import json
import pathlib
import sys

import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.benchmarks import micro as T
from repro_torch.kernels import ops

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:               # the reference's benchmarks package
    sys.path.insert(0, str(ROOT))
from benchmarks import micro as R  # noqa: E402

COMMITTED = json.loads((ROOT / "BENCH_dataplane.json").read_text())


def key_tree(d):
    """A dict's nested key structure: {key: subtree or None}."""
    return {k: key_tree(v) if isinstance(v, dict) else None for k, v in d.items()}


# probe, its section of BENCH_dataplane.json, small arguments, the keys whose
# values must equal the reference probe's
PROBES = [
    ("backpressure_probe", "backpressure_small_sockbuf", {"frames": 6, "bufsize": 8192},
     ("frames", "frame_bytes", "socket_buffer_bytes", "verified", "requests_completed")),
    ("recv_ring_probe", "recv_ring_buffer", {"frames": 16, "warmup": 4, "held_frames": 4},
     ("frames", "frame_payload_bytes", "held_frames", "pool_balanced_at_teardown",
      "live_leases_at_teardown")),
    ("shm_probe", "shm_vs_tcp_localhost", {"frames": 8, "warmup": 2, "held_frames": 4},
     ("frames", "frame_payload_bytes", "ring_bytes", "spills", "frames_sent")),
    ("comm_quant_probe", "comm_quant_narrow_link", {"frames": 4, "rows": 64, "cols": 256},
     ("frames", "raw_leaf_bytes", "raw_frames_quantized", "within_error_bound",
      "raw_roundtrip_exact", "raw_bytes_per_frame")),
    ("tenant_fairness_probe", "tenant_fairness_2way", {"warmup_s": 0.1, "measure_s": 0.3},
     ("weights", "threads_per_tenant", "measure_s", "dispatch_compute_s", "expected_share_a",
      "share_tolerance", "p95_bound_s")),
    ("drain_rehome_probe", "drain_rehome", {"n_steady": 10, "n_drain": 10},
     ("calls_steady", "calls_drain_window", "dropped", "destination_after",
      "drained_node_bled")),
    ("intra_op_scaling_probe", "intra_op_scaling",
     {"rows": 4096, "per_row_sleep_s": 1e-6, "reps": 1},
     ("rows", "bit_identical", "shards_2", "shards_4")),
]


@pytest.mark.parametrize("probe,section,kw,same", PROBES, ids=[p[0] for p in PROBES])
def test_probe_matches_reference_and_committed_section(probe, section, kw, same):
    mine = getattr(T, probe)(**kw)
    ref = getattr(R, probe)(**kw)
    assert key_tree(mine) == key_tree(COMMITTED[section])
    assert {k: mine[k] for k in same} == {k: ref[k] for k in same}


def test_probe_flags_hold():
    """The correctness flags the chip run holds, here on the CPU."""
    assert T.backpressure_probe(frames=6, bufsize=8192)["verified"]
    ring = T.recv_ring_probe(frames=16, warmup=4, held_frames=4)
    assert ring["pool_balanced_at_teardown"] and ring["live_leases_at_teardown"] == 0
    q = T.comm_quant_probe(frames=4, rows=64, cols=256)
    # the int8 codec starts only once the wire EMA crosses the compute EMA
    assert q["quant_engaged"] and q["quant_frames"] == 4
    assert q["within_error_bound"] and q["raw_roundtrip_exact"]
    # int8 rows plus a scale each, against the fp32 leaf: a quarter and a bit
    assert 0.25 < q["payload_ratio"] < 0.3
    r = R.comm_quant_probe(frames=4, rows=64, cols=256)
    assert r["quant_engaged"] and q["quant_bytes_per_frame"] == r["quant_bytes_per_frame"]
    d = T.drain_rehome_probe(n_steady=10, n_drain=10)
    assert d["dropped"] == 0 and d["rehome"]["reason"] == "drain" and d["rehome"]["warm"]
    io = T.intra_op_scaling_probe(rows=4096, per_row_sleep_s=1e-6, reps=1)
    assert io["bit_identical"] and len(io["shards_2"]) == 2 and len(io["shards_4"]) == 4


def test_serialization_wire_bytes_equal_reference():
    """AVC2 is byte for byte: raw, zstd and int8 frames have the reference's
    sizes (the ``wire=...B`` of each ``serialize/*`` row)."""
    def wire(rows):
        return {name: derived.split("wire=")[1] for name, _, derived in rows
                if name.startswith("serialize/")}
    mine, ref = wire(T.bench_serialization()), wire(R.bench_serialization())
    assert set(mine) == {"serialize/raw", "serialize/zstd", "serialize/int8"}
    assert mine == ref


def _reference_row_names(fn: str) -> list:
    """The row names a reference ``bench_*`` returns, read from its source
    (each a string constant in a returned tuple) without running it."""
    tree = ast.parse((ROOT / "benchmarks" / "micro.py").read_text())
    node = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == fn)
    names = []
    for ret in (n for n in ast.walk(node) if isinstance(n, ast.Return)):
        for t in ast.walk(ret.value):
            if isinstance(t, ast.Tuple) and isinstance(t.elts[0], ast.Constant):
                names.append(t.elts[0].value)
    return names


DEVICE_BENCHES = ("bench_kernels", "bench_moe_dispatch", "bench_engine",
                  "bench_avec_offload_real")


@pytest.mark.parametrize("bench", [b.__name__ for b in R.ALL_MICRO])
def test_bench_row_names_equal_reference(bench):
    """Each ``bench_*`` twin at its default config (on the CPU where it
    computes on a device) gives the reference function's rows, by name;
    ``bench_serialization``'s names are formatted, so the reference runs."""
    fn = getattr(T, bench)
    rows = fn(device="cpu") if bench in DEVICE_BENCHES else fn()
    if bench == "bench_serialization":
        want = [r[0] for r in R.bench_serialization()]
    else:
        want = _reference_row_names(bench)
    assert [r[0] for r in rows] == want
    assert all(isinstance(us, float) and us >= 0 for _, us, _ in rows)


def test_all_micro_is_the_reference_list():
    assert [b.__name__ for b in T.ALL_MICRO] == [b.__name__ for b in R.ALL_MICRO]


def test_bench_kernels_on_the_cpu_runs_the_plain_versions():
    ops.reset_launch_counts()
    rows = T.bench_kernels(device="cpu")
    assert [d for _, _, d in rows] == ["plain"] * 3
    assert not any(ops.launch_counts().values())


def test_kernel_inputs_are_the_reference_shapes():
    t = T._kernel_inputs("cpu")
    assert {n: tuple(v.shape) for n, v in t.items()} == {
        "q": (1, 8, 512, 64), "k": (1, 8, 512, 64), "v": (1, 8, 512, 64),
        "x": (4096, 1024), "scale": (1024,)}
    assert all(v.dtype == torch.float32 for v in t.values())


def test_moe_row_name_follows_the_config():
    cfg = tconfigs.reduced(tconfigs.get_arch("moonshot-v1-16b-a3b"))
    (name, _, derived), = T.bench_moe_dispatch(cfg, device="cpu")
    assert name == f"moe/dispatch_512tok_{cfg.moe.num_experts}e" and derived.endswith("tok/s")


def test_avec_offload_real_carries_eq1_bytes():
    """The paper's cycle over loopback TCP: 3.76 MB a cycle (Eq. 1)."""
    rows = dict((n, d) for n, _, d in T.bench_avec_offload_real(device="cpu"))
    assert rows["avec_real/cycle_comm"] == "3.76MB/cycle"


def test_coalesced_dispatch_counts_equal_reference():
    _, _, mine = T._coalesce_walls(device="cpu")
    _, _, ref = R._coalesce_walls()
    assert mine["requests"] == ref["requests"] == 32
    assert set(mine) == set(COMMITTED["coalesced_dispatch"]["stats"])


@pytest.mark.parametrize("bench", DEVICE_BENCHES + ("_coalesce_walls",))
def test_device_benches_need_the_card_unless_asked_for_the_cpu(bench):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(T, bench)()
