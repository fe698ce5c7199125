"""CLI: ``python -m repro_torch.analysis [paths...]`` (default: ``src/``).

Exit status 0 when every finding is suppressed with a justification,
1 otherwise — the CI ``analysis`` job gates on it.  ``--show-suppressed``
prints the justified-and-silenced findings too (the audit trail).
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.analysis.checker import RULES, run_paths


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="avecheck: lease/lock/blocking/wire-error static "
                    "analysis for the AVEC data plane")
    ap.add_argument("paths", nargs="*", default=["src/"],
                    help="files or directories to analyze (default: src/)")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="also print findings silenced by justified "
                         "`# avecheck: ignore[...]` comments")
    args = ap.parse_args(argv)

    findings = run_paths(args.paths)
    active = [f for f in findings if not f.suppressed]
    suppressed = [f for f in findings if f.suppressed]
    for f in active:
        print(f)
    if args.show_suppressed:
        for f in suppressed:
            print(f)
    print(f"avecheck: {len(active)} finding(s), {len(suppressed)} "
          f"suppressed with justification "
          f"(rules: {', '.join(RULES)})", file=sys.stderr)
    return 1 if active else 0


if __name__ == "__main__":
    sys.exit(main())
