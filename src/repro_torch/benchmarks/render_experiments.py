"""Render the dry-run sections of an experiments report from the port's
dry-run records, the JAX package's ``benchmarks/render_experiments.py``'s
twin.

    python -m repro_torch.benchmarks.render_experiments OUT [--template PATH]
        [--dryrun-dir DIR]

It writes ``OUT`` and nothing else.  Given a template that holds the
three markers (``<!-- DRYRUN_TABLE -->``, ``<!-- ROOFLINE_TABLE -->``,
``<!-- ROOFLINE_NOTES -->``), it fills them in; otherwise it writes the
three sections one after the other.  The per-cell notes name the H100's
units (tensor cores, HBM3, NVLink) where the reference's name a TPU's.
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks.roofline_report import baseline_records, markdown_table
from repro_torch.launch.dryrun import DEFAULT_OUT

MARKERS = ("<!-- DRYRUN_TABLE -->", "<!-- ROOFLINE_TABLE -->", "<!-- ROOFLINE_NOTES -->")


def dryrun_table(root: str = DEFAULT_OUT) -> str:
    lines = ["### Dry-run status (every arch × shape × mesh; dp_tp baseline)",
             "",
             "| arch | shape | single-pod (256) | multi-pod (512) | compile s/m |",
             "|---|---|---|---|---|"]
    singles = {(r["arch"], r["shape"]): r for r in baseline_records("single", root)}
    multis = {(r["arch"], r["shape"]): r for r in baseline_records("multi", root)}
    for key in sorted(singles):
        s, m = singles[key], multis.get(key)

        def stat(r):
            if r is None:
                return "—"
            if r.get("skipped"):
                return "skip"
            return "OK" if r.get("ok") else "FAIL"
        cs = f"{s.get('compile_s', 0):.0f}/{(m or {}).get('compile_s', 0):.0f}"
        lines.append(f"| {key[0]} | {key[1]} | {stat(s)} | {stat(m)} | {cs} |")
    recs = list(singles.values()) + list(multis.values())
    n_ok = sum(1 for r in recs if r.get("ok"))
    n_skip = sum(1 for r in recs if r.get("skipped"))
    n_fail = len(recs) - n_ok - n_skip
    lines.append("")
    lines.append(f"**{n_ok} cells compiled OK, {n_skip} documented skips, "
                 f"{n_fail} failures.**  Multi-pod cells shard batch over "
                 f"(`pod`,`data`) — the `pod` (inter-node network) axis carries "
                 f"only data-parallel gradient reduction, per the AVEC "
                 f"link-hierarchy rule.")
    return "\n".join(lines)


def roofline_notes(root: str = DEFAULT_OUT) -> str:
    """Per-cell dominant-bottleneck one-liners (single-pod)."""
    lines = ["### Per-cell bottleneck notes (single-pod baseline)", ""]
    for r in baseline_records("single", root):
        if not r.get("ok"):
            continue
        roof = r["roofline"]
        dom = roof["dominant"]
        coll = r.get("collectives", {})
        ar = coll.get("all-reduce", {}).get("bytes", 0)
        ag = coll.get("all-gather", {}).get("bytes", 0)
        what = {
            "memory": "HBM3-bound: fp32 score/logit materialization + remat "
                      "recompute traffic; fix = blocked+mixed attention, "
                      "chunked-vocab xent",
            "collective": ("NVLink-bound: "
                           + ("MoE dispatch all-reduce of the global expert "
                              "buffer; fix = sharded dispatch (all-to-all)"
                              if ar > ag else
                              "weight/activation gathers; fix = resharding")),
            "compute": "tensor-core-bound (closest to roofline)",
        }[dom]
        lines.append(
            f"- **{r['arch']} × {r['shape']}**: dominant={dom} "
            f"(c/m/x = {roof['compute_s']:.3f}/{roof['memory_s']:.3f}/"
            f"{roof['collective_s']:.3f} s; 6ND/counted={roof['useful_ratio']:.3f})"
            f" — {what}")
    return "\n".join(lines)


def render(template: str | None = None, root: str = DEFAULT_OUT) -> str:
    """The three sections, filled into ``template`` where it holds all
    three markers, else one after the other."""
    sections = (dryrun_table(root),
                "### Roofline terms, single-pod (dp_tp baseline)\n\n"
                + markdown_table("single", root=root)
                + "\n\n### Roofline terms, multi-pod 512 chips (dp_tp baseline)\n\n"
                + markdown_table("multi", root=root),
                roofline_notes(root))
    if template is None or not all(m in template for m in MARKERS):
        return "\n\n".join(sections) + "\n"
    for marker, section in zip(MARKERS, sections):
        template = template.replace(marker, section)
    return template


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", help="the file to write")
    ap.add_argument("--template", default=None,
                    help="a file holding the three markers to fill in")
    ap.add_argument("--dryrun-dir", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    template = None
    if args.template:
        with open(args.template) as f:
            template = f.read()
    text = render(template, args.dryrun_dir)
    with open(args.out, "w") as f:
        f.write(text)
    print(f"{args.out}: dry-run sections rendered")


if __name__ == "__main__":
    main()
