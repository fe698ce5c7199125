"""The correctness check's control, run at a cell's own size: not part of a
benchmark run.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 --seconds 30

For each seed, one run of the cell (its destination, its window, its
sample of finished requests) whose check also reads the two numbers for
the reference computed with fp8 projections in the program's place
(``check.py``).  Prints one JSON line per seed with the program's readings
and the control's.  The limits in ``limits/<cell>.json`` lie between the
largest program reading over a dozen seeds or more and the smallest
control reading.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:1] = [ROOT, os.path.join(ROOT, "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    import torch

    from portbench.harness import run_cell

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        result, _ = run_cell(manifest, args.workload, seed, args.seconds, False,
                             t_start=t0, control=True)
        torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "checks": result["checks"], "metrics": result["metrics"],
                          "wall_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
