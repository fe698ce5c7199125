"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Needs as many CUDA devices as the cell asks
for; without them it exits with code 2 and prints no result.  With
``--trace 0`` the line holds the cell's end-to-end metrics, with ``--trace
1`` its per-layer metrics, the device's busy time and a breakdown.  The
numbers the correctness check compared are printed, each beside its limit,
as the last lines on standard error and under ``checks``, the line's last
key.  A run that loads ``jax``, ``jaxlib``, ``flax`` or ``repro`` exits
with code 3 and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:1] = [ROOT, os.path.join(ROOT, "src")]      # not this file's folder


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
        return out[0] if out else "nvidia-smi printed nothing"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed is a whole number >= 0")

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if args.workload not in cells:
        ap.error(f"unknown workload {args.workload!r}; known: {sorted(cells)}")

    from portbench.destination import bad_modules
    from portbench.harness import ForbiddenModules, run_cell, start_destination

    # the destination starts loading first; the host imports meanwhile.  The
    # host, one closed-loop client, keeps to the last core it may use, and the
    # destination to those between the first and the last (destination.py)
    dest = start_destination(manifest, args.workload, args.seed)
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) > 2:
        os.sched_setaffinity(0, cores[-1:])
    try:
        import torch

        chips = cells[args.workload]["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"portbench: {args.workload} needs {chips} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        result, rows = run_cell(manifest, args.workload, args.seed, args.seconds,
                                bool(args.trace), t_start=T_START, dest=dest)
        if bad_modules():                   # this process, the window closed
            raise ForbiddenModules(bad_modules())
    except ForbiddenModules as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    finally:
        dest.kill()
    print(f"card: {card_line()} (peaks in shares: H100 SXM at 700 W)", file=sys.stderr)
    for name, value, limit, how in rows:
        print(f"check {name} {value!r} {'at least' if how == 'min' else 'at most'} {limit!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
