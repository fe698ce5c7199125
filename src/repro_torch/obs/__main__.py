"""CLI for the observability plane.

``python -m repro_torch.obs --knobs`` prints the generated knob-reference
table (markdown) — the same table embedded in README's Observability
section.  ``--format plain`` prints one line per knob instead.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.obs.config import global_config


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs")
    ap.add_argument("--knobs", action="store_true",
                    help="print the registered knob reference table")
    ap.add_argument("--effective", action="store_true",
                    help="print each knob's effective value and source")
    ap.add_argument("--format", choices=("markdown", "plain"),
                    default="markdown")
    args = ap.parse_args(argv)

    cfg = global_config()
    if args.effective:
        for knob in cfg.knobs():
            print("%-24s %-10r (%s)" % (knob.name, cfg.resolve(knob.name),
                                        cfg.source(knob.name)))
        return 0
    if args.knobs:
        if args.format == "markdown":
            print(cfg.markdown_table())
        else:
            for r in cfg.describe():
                print("%-24s %-28s %-6s %-10r %s"
                      % (r["name"], r["env"], r["type"], r["default"],
                         r["doc"]))
        return 0
    ap.print_help()
    return 1


if __name__ == "__main__":
    sys.exit(main())
