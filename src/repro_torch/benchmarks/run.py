"""Benchmark harness, the JAX package's ``benchmarks/run.py``'s twin: one
section per paper table/figure + framework micro benches + the roofline
summary.  Prints ``name,us_per_call,derived`` CSV and writes the data
plane's JSON (zero-copy serialize throughput vs the seed path,
pipelined-vs-sync offload walls, coalesced dispatch walls, and the
contended two-tenant fairness probe) with ``BENCH_dataplane.json``'s
sections and keys.

    python -m repro_torch.benchmarks.run [--smoke] [--no-json]
        [--device cpu|cuda] [--json PATH] [--dryrun-dir DIR]

``--smoke`` runs only the fast data-plane subset; ``--no-json`` skips the
JSON artifact, which goes to ``--json`` (``chipwork/BENCH_dataplane_torch.json``
by default; the committed ``BENCH_dataplane.json`` is the JAX package's and
is never written here).  The benches that compute on a device, and the JSON's
OpenPose destination and coalesced matmuls, run on ``--device`` (the card
by default).  Roofline rows come from the dry-run records in
``--dryrun-dir``.

For the paper tables the CSV cells are (name, model_value, "paper=<v>
err=<pct>") so the reproduction gap is visible inline.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import traceback

from repro_torch.launch.dryrun import DEFAULT_OUT

DATAPLANE_JSON = os.path.join("chipwork", "BENCH_dataplane_torch.json")


def write_dataplane_json(path: str = DATAPLANE_JSON, frames: int = 8,
                         device="cuda") -> dict:
    from repro_torch.benchmarks import micro
    report = micro.dataplane_report(frames=frames, device=device)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    return report


def _run_bench(bench, device) -> list:
    """``bench()``, given ``device`` where it computes on one; a failure
    becomes its ``/ERROR`` row."""
    try:
        if "device" in inspect.signature(bench).parameters:
            return bench(device=device)
        return bench()
    except Exception as e:  # noqa: BLE001
        return [(f"{bench.__name__}/ERROR", 0.0, str(e)[:60])]


def summary_rows(report: dict) -> list:
    """The CSV's rows that summarize the data plane's JSON."""
    rows = []
    ser = report["serialize_raw_512x512"]
    pipe = report["pipelined_offload_openpose"]
    rows.append(("dataplane/serialize_speedup_vs_seed",
                 ser["speedup_vs_seed"],
                 f"{ser['vectored_gbps']:.1f}GB/s vs "
                 f"{ser['seed_joined_gbps']:.1f}GB/s"))
    rows.append(("dataplane/pipelined_vs_sync_speedup",
                 pipe["speedup"],
                 f"{pipe['frames']} frames "
                 f"{pipe['pipelined_wall_s']:.2f}s vs "
                 f"{pipe['sync_wall_s']:.2f}s "
                 f"window={pipe['adaptive_window']}"))
    bp = report["backpressure_small_sockbuf"]
    rows.append(("dataplane/backpressure_send_stalls",
                 float(bp["send_stalls"]),
                 f"{bp['frames']}x{bp['frame_bytes']}B frames thru "
                 f"{bp['socket_buffer_bytes']}B sockbufs in "
                 f"{bp['wall_s']:.2f}s (deadlock-free)"))
    rb = report["recv_ring_buffer"]
    rows.append(("dataplane/recv_pool_hit_rate",
                 rb["pool_hit_rate"],
                 f"{rb['steady_state_fallback_allocs']} fallback "
                 f"allocs over {rb['frames']} pipelined frames"))
    rows.append(("dataplane/recv_alloc_per_frame_bytes",
                 rb["payload_alloc_per_frame_bytes"],
                 f"unpooled={rb['unpooled_alloc_per_frame_bytes']:.0f}B "
                 f"({rb['frame_payload_bytes']}B payloads)"))
    rows.append(("dataplane/recv_throughput_vs_unpooled",
                 rb["throughput_ratio_vs_unpooled"],
                 f"{rb['recv_throughput_mbps']:.0f}MB/s pooled vs "
                 f"{rb['baseline_throughput_mbps']:.0f}MB/s"))
    tf = report["tenant_fairness_2way"]
    rows.append(("dataplane/tenant_fairness_share_a",
                 tf["share_a"],
                 f"target {tf['expected_share_a']:.2f} ±20% "
                 f"({tf['weights']['a']:.0f}:"
                 f"{tf['weights']['b']:.0f} weights, "
                 f"drained {tf['drained']})"))
    rows.append(("dataplane/tenant_fairness_b_p95_ms",
                 tf["b_p95_s"] * 1e3,
                 f"bound {tf['p95_bound_s'] * 1e3:.0f}ms "
                 f"(low-weight tenant not starved)"))
    dr = report["drain_rehome"]
    # obs-plane cross-check: the scrape-time metric views recorded
    # inside each section must agree with the bench's own counters
    pm = pipe.get("metrics", {})
    ring_hit_key = 'avec_pool_hit_ratio{pool="recv"}'
    ring_hit = rb.get("metrics", {}).get(ring_hit_key, "n/a")
    rows.append(("dataplane/obs_metric_snapshots",
                 float(sum("metrics" in report[k]
                           for k in ("pipelined_offload_openpose",
                                     "backpressure_small_sockbuf",
                                     "recv_ring_buffer",
                                     "tenant_fairness_2way"))),
                 f"window={pm.get('avec_inflight_window')} "
                 f"stalls={pm.get('avec_send_stalls_total')} "
                 f"pool_hit={ring_hit}"))
    rows.append(("dataplane/drain_rehome_p99_ratio",
                 dr["p99_ratio"],
                 f"drain p99 {dr['drain_p99_s'] * 1e3:.1f}ms vs "
                 f"steady {dr['steady_p99_s'] * 1e3:.1f}ms "
                 f"(bound {dr['p99_ratio_bound']:.0f}x, "
                 f"dropped={dr['dropped']}, "
                 f"warm={dr['rehome'].get('warm')})"))
    sh = report["shm_vs_tcp_localhost"]
    rows.append(("dataplane/shm_speedup_vs_tcp",
                 sh["speedup_vs_tcp"],
                 f"{sh['shm_throughput_mbps']:.0f}MB/s ring vs "
                 f"{sh['tcp_throughput_mbps']:.0f}MB/s loopback TCP "
                 f"(hit_rate={sh['pool_hit_rate']:.2f}, "
                 f"spills={sh['spills']})"))
    cq = report["comm_quant_narrow_link"]
    rows.append(("dataplane/comm_quant_payload_ratio",
                 cq["payload_ratio"],
                 f"{cq['quant_bytes_per_frame']:.0f}B vs "
                 f"{cq['raw_bytes_per_frame']:.0f}B raw "
                 f"(bounded={cq['within_error_bound']})"))
    rows.append(("dataplane/comm_quant_effective_speedup",
                 cq["effective_speedup"],
                 f"{cq['quant_throughput_mbps']:.1f}MB/s effective "
                 f"vs {cq['raw_throughput_mbps']:.1f}MB/s on a "
                 f"{cq['link_bandwidth_mbps']:.0f}MB/s link"))
    io = report["intra_op_scaling"]
    rows.append(("dataplane/intra_op_speedup_2dest",
                 io["speedup_2"],
                 f"{io['rows']} rows: {io['wall_1_s'] * 1e3:.0f}ms "
                 f"-> {io['wall_2_s'] * 1e3:.0f}ms "
                 f"(4dest {io['wall_4_s'] * 1e3:.0f}ms, "
                 f"bit_identical={io['bit_identical']})"))
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true", help="only the fast data-plane subset")
    ap.add_argument("--no-json", action="store_true", help="skip the JSON artifact")
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    ap.add_argument("--json", default=DATAPLANE_JSON, help="where the JSON goes")
    ap.add_argument("--dryrun-dir", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    rows = []

    from repro_torch.benchmarks import micro

    if args.smoke:
        for bench in (micro.bench_serialization, micro.bench_dataplane,
                      micro.bench_transport):
            rows.extend(_run_bench(bench, args.device))
    else:
        # --- paper tables (calibrated cost model; see paper_tables.py) ----
        from repro_torch.benchmarks import paper_tables
        for fn in paper_tables.ALL_TABLES.values():
            for label, paper, model, err in fn():
                rows.append((label, model, f"paper={paper} err={err * 100:.1f}%"))

        # --- framework micro benches (real measurements) ------------------
        for bench in micro.ALL_MICRO:
            rows.extend(_run_bench(bench, args.device))

        # --- roofline summary from dry-run records (if present) -----------
        try:
            from repro_torch.benchmarks import roofline_report
            rl = roofline_report.rows(args.dryrun_dir)
            if rl:
                rows.extend(rl)
            else:
                rows.append(("roofline/none", 0.0,
                             "run python -m repro_torch.launch.dryrun --all first"))
        except Exception as e:  # noqa: BLE001
            rows.append(("roofline/ERROR", 0.0, str(e)[:60]))

    # --- data-plane acceptance artifact -----------------------------------
    if not args.no_json:
        try:
            # 8 frames even in smoke mode: shorter streams spend most of the
            # run ramping the in-flight window and under-report the overlap
            report = write_dataplane_json(args.json, frames=8, device=args.device)
            rows.extend(summary_rows(report))
        except Exception:  # noqa: BLE001
            traceback.print_exc()
            rows.append(("dataplane/ERROR", 0.0, "see traceback"))

    print("name,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.2f},{derived}")


if __name__ == "__main__":
    main()
