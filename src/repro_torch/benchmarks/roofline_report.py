"""Roofline report, the JAX package's ``benchmarks/roofline_report.py``'s
twin: reads the port's dry-run records (``python -m
repro_torch.launch.dryrun`` writes them, by default under ``chipwork/dryrun``)
and renders the §Roofline table (all cells) + per-cell bottleneck analysis
rows for ``repro_torch.benchmarks.run``.

Each function takes the records' directory, ``DEFAULT_OUT`` unless given.
Two columns differ from the reference's: the memory a device holds is
checked against the H100's 80 GB (``launch.roofline.HW["chip_mem"]``), and
the ratio of 6ND to the step's FLOPs reads "6ND/counted", because the port
counts every op eagerly (``cost_method`` "counted") where the reference
reads XLA's HLO cost analysis.

    python -m repro_torch.benchmarks.roofline_report [--dryrun-dir DIR]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.dryrun import DEFAULT_OUT
from repro_torch.launch.roofline import HW

CHIP_MEM_GB = HW["chip_mem"] / 1e9


def load_records(pattern: str = "*.json", root: str = DEFAULT_OUT) -> list[dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(root, pattern))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def baseline_records(mesh: str = "single", root: str = DEFAULT_OUT) -> list[dict]:
    return [r for r in load_records(root=root)
            if r.get("mesh") == mesh and not r.get("tag")
            and r.get("profile", "dp_tp") == "dp_tp" and not r.get("overrides")]


def rows(root: str = DEFAULT_OUT) -> list:
    out = []
    for r in baseline_records("single", root):
        cell = f"roofline/{r['arch']}/{r['shape']}"
        if r.get("skipped"):
            out.append((cell, 0.0, "SKIP(full-attn long-context)"))
            continue
        if not r.get("ok"):
            out.append((cell, 0.0, f"FAIL {r.get('error', '')[:40]}"))
            continue
        roof = r["roofline"]
        out.append((cell, roof["bound_s"] * 1e6,
                    f"dom={roof['dominant']} "
                    f"c={roof['compute_s'] * 1e3:.1f}ms "
                    f"m={roof['memory_s'] * 1e3:.1f}ms "
                    f"x={roof['collective_s'] * 1e3:.1f}ms "
                    f"useful={roof['useful_ratio']:.2f}"))
    return out


def markdown_table(mesh: str = "single", tag: str = "", profile: str = "dp_tp",
                   overrides_ok: bool = False, root: str = DEFAULT_OUT) -> str:
    recs = [r for r in load_records(root=root)
            if r.get("mesh") == mesh and r.get("tag", "") == tag
            and r.get("profile", "dp_tp") == profile
            and (overrides_ok or not r.get("overrides"))]
    lines = [
        "| arch | shape | compute (ms) | memory (ms) | collective (ms) | "
        f"dominant | 6ND/counted | args/dev (GB) | fits {CHIP_MEM_GB:.0f}GB |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(recs, key=lambda x: (x["arch"], x["shape"])):
        if r.get("skipped"):
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                         f"skipped (full-attn @500k) | — | — | — |")
            continue
        if not r.get("ok"):
            lines.append(f"| {r['arch']} | {r['shape']} | FAIL | | | | | | |")
            continue
        roof = r["roofline"]
        args_gb = (r["memory_analysis"]["argument_bytes"] or 0) / 1e9
        fits = "yes" if args_gb <= CHIP_MEM_GB else f"NO ({args_gb:.0f}GB)"
        lines.append(
            f"| {r['arch']} | {r['shape']} | {roof['compute_s'] * 1e3:.1f} | "
            f"{roof['memory_s'] * 1e3:.1f} | {roof['collective_s'] * 1e3:.1f} | "
            f"{roof['dominant']} | {roof['useful_ratio']:.2f} | "
            f"{args_gb:.2f} | {fits} |")
    return "\n".join(lines)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="the §Roofline table of the dry-run records")
    ap.add_argument("--dryrun-dir", default=DEFAULT_OUT)
    print(markdown_table(root=ap.parse_args().dryrun_dir))
