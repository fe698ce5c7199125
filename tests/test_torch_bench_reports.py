"""The port's report twins (``repro_torch.benchmarks.roofline_report``,
``render_experiments`` and ``run``) against the JAX package's
``benchmarks/`` on the same dry-run records, on the CPU.

The records: three mini cells counted by the port's ``launch/dryrun.py`` on
the production meshes' fake ranks (mamba2-130m's and granite-3-2b's
``decode_32k`` cut to S 64, B 32), and hand-made ones: a skipped cell, a
failed cell, a cell whose arguments fit 80 GB but not 16, and a cell run
with overrides (left out of every baseline).  The reference reads them
through its ``ARTIFACTS`` directory, patched here; its files are not
edited.  The twins' rows, statuses, dominant terms and numbers equal the
reference's.  What differs is named where it is held: the memory column
(the H100's 80 GB against a TPU v5e's 16 GB), the FLOP ratio's name
("6ND/counted": the port counts ops eagerly, the reference reads HLO),
the TPU words of the notes (MXU, ICI, HBM, DCN: tensor cores, NVLink,
HBM3, the inter-node network), and the failure count, which the reference
prints as 0 whatever the records hold.
"""
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

from repro_torch.benchmarks import render_experiments as TX
from repro_torch.benchmarks import roofline_report as TR

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
if str(ROOT) not in sys.path:               # the reference's benchmarks package
    sys.path.insert(0, str(ROOT))
from benchmarks import micro as RM  # noqa: E402
from benchmarks import paper_tables as RP  # noqa: E402
from benchmarks import render_experiments as RX  # noqa: E402
from benchmarks import roofline_report as RR  # noqa: E402

COMMITTED = ROOT / "BENCH_dataplane.json"

MINI_CELLS = r"""
import sys
sys.path.insert(0, sys.argv[1])
from repro_torch.launch.mesh import start_fake_world
start_fake_world()                       # the production meshes' fake ranks
from repro_torch.launch.dryrun import run_cell
cut = {"seq_len": 64, "global_batch": 32}
for arch, mesh in (("mamba2-130m", "single"), ("mamba2-130m", "multi"),
                   ("granite-3-2b", "single")):
    assert run_cell(arch, "decode_32k", mesh, "dp_tp", {}, sys.argv[2],
                    device="cpu", shape_overrides=cut)["ok"]
"""


def _write(d: pathlib.Path, rec: dict) -> None:
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{rec.pop('_suffix', '')}.json"
    (d / name).write_text(json.dumps(rec))


@pytest.fixture(scope="module")
def records(tmp_path_factory) -> str:
    d = tmp_path_factory.mktemp("dryrun")
    out = subprocess.run([sys.executable, "-c", MINI_CELLS, SRC, str(d)],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    base = {"profile": "dp_tp", "overrides": {}, "tag": "", "chips": 256, "mesh": "single"}
    _write(d, {**base, "arch": "granite-3-2b", "shape": "long_500k", "ok": False,
               "skipped": "long_500k requires a sub-quadratic decode path; "
                          "granite-3-2b is full-attention"})
    _write(d, {**base, "arch": "whisper-medium", "shape": "train_4k", "ok": False,
               "error": "RuntimeError: dry-run op aten.mm.default failed"})
    big = json.loads((d / "mamba2-130m__decode_32k__single.json").read_text())
    # jamba decode_32k's args/dev on the H100's plan (60.19 GB): fits 80, not 16
    big["memory_analysis"]["argument_bytes"] = 60_191_000_000
    _write(d, {**big, "arch": "jamba-1.5-large-398b"})
    _write(d, {**big, "overrides": {"attn_impl": "blocked"}, "_suffix": "__over"})
    return str(d)


@pytest.fixture
def ref_reads(records, monkeypatch):
    monkeypatch.setattr(RR, "ARTIFACTS", records)
    return records


def test_records_carry_the_reference_roofline_keys(records):
    rec = json.loads(pathlib.Path(records, "mamba2-130m__decode_32k__single.json").read_text())
    assert set(rec["roofline"]) >= {"bound_s", "useful_ratio", "compute_s", "memory_s",
                                    "collective_s", "dominant"}
    assert rec["cost_method"] == "counted" and rec["memory_analysis"]["argument_bytes"] > 0


def test_records_and_rows_equal_reference(ref_reads):
    assert TR.load_records(root=ref_reads) == RR.load_records()
    for mesh in ("single", "multi"):
        assert TR.baseline_records(mesh, ref_reads) == RR.baseline_records(mesh)
    rows = TR.rows(ref_reads)
    assert rows == RR.rows()
    status = {tuple(name.split("/")[1:]): d.split()[0] for name, _, d in rows}
    assert status == {("granite-3-2b", "decode_32k"): "dom=collective",
                      ("granite-3-2b", "long_500k"): "SKIP(full-attn",
                      ("jamba-1.5-large-398b", "decode_32k"): "dom=memory",
                      ("mamba2-130m", "decode_32k"): "dom=memory",
                      ("whisper-medium", "train_4k"): "FAIL"}
    assert ("roofline/granite-3-2b/long_500k", 0.0, "SKIP(full-attn long-context)") in rows


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_markdown_table_equals_reference_but_memory_and_flop_ratio(ref_reads, mesh):
    mine, ref = TR.markdown_table(mesh, root=ref_reads), RR.markdown_table(mesh)
    # named differences: the ratio's name, and 80 GB a device against 16
    ref = ref.replace("| 6ND/HLO |", "| 6ND/counted |").replace("| fits 16GB |", "| fits 80GB |")
    ref = ref.replace("| NO (60GB) |", "| yes |")
    assert mine == ref
    assert ("| jamba-1.5-large-398b | decode_32k |" in mine) == (mesh == "single")


def test_render_sections_equal_reference_but_h100_words(ref_reads):
    ref_table = RX.dryrun_table()
    n_fail = sum(1 for r in RR.baseline_records("single") + RR.baseline_records("multi")
                 if not r.get("ok") and not r.get("skipped"))
    assert n_fail == 1 and "0 failures" in ref_table      # the reference prints 0 always
    want = ref_table.replace("0 failures", f"{n_fail} failures").replace(
        "`pod` (DCN) axis", "`pod` (inter-node network) axis")
    assert TX.dryrun_table(ref_reads) == want
    notes = RX.roofline_notes()
    for tpu, h100 in (("MXU-bound", "tensor-core-bound"), ("ICI-bound", "NVLink-bound"),
                      ("HBM-bound", "HBM3-bound"), ("6ND/HLO=", "6ND/counted=")):
        notes = notes.replace(tpu, h100)
    mine = TX.roofline_notes(ref_reads)
    assert mine == notes
    assert "NVLink-bound" in mine and "HBM3-bound" in mine


def test_render_writes_its_own_file_from_a_template_or_without(records, tmp_path):
    experiments = ROOT / "EXPERIMENTS.md"
    before = experiments.exists()
    tpl = tmp_path / "tpl.md"
    tpl.write_text("# head\n<!-- DRYRUN_TABLE -->\nmid\n<!-- ROOFLINE_TABLE -->\n"
                   "<!-- ROOFLINE_NOTES -->\ntail\n")
    TX.main([str(tmp_path / "a.md"), "--template", str(tpl), "--dryrun-dir", records])
    text = (tmp_path / "a.md").read_text()
    assert text.startswith("# head\n### Dry-run status") and text.endswith("\ntail\n")
    assert "<!--" not in text and "\nmid\n### Roofline terms, single-pod" in text
    TX.main([str(tmp_path / "b.md"), "--dryrun-dir", records])
    plain = (tmp_path / "b.md").read_text()
    sections = (TX.dryrun_table(records), TX.roofline_notes(records))
    assert plain.startswith(sections[0]) and plain.endswith(sections[1] + "\n")
    assert "### Roofline terms, multi-pod 512 chips" in plain
    assert experiments.exists() == before


def _run_cli(*args, cwd) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": SRC}
    out = subprocess.run([sys.executable, "-m", "repro_torch.benchmarks.run", *args],
                         capture_output=True, text=True, cwd=cwd, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out


def _csv(stdout: str) -> list:
    lines = stdout.strip().splitlines()
    start = lines.index("name,us_per_call,derived")
    return [line.split(",", 2) for line in lines[start + 1:]]


SMOKE = (RM.bench_serialization, RM.bench_dataplane, RM.bench_transport)


def test_run_smoke_prints_the_reference_rows(tmp_path):
    rows = _csv(_run_cli("--smoke", "--no-json", "--device", "cpu", cwd=tmp_path).stdout)
    want = [r[0] for bench in SMOKE for r in bench()]
    assert [r[0] for r in rows] == want
    assert not any(n.endswith("/ERROR") for n, _, _ in rows)
    assert list(tmp_path.iterdir()) == []


def test_run_json_goes_to_its_path_never_to_the_committed_file(tmp_path):
    before = (COMMITTED.stat().st_mtime_ns, COMMITTED.read_bytes())
    path = tmp_path / "out" / "dataplane.json"
    rows = _csv(_run_cli("--smoke", "--device", "cpu", "--json", str(path),
                         cwd=tmp_path).stdout)
    assert (COMMITTED.stat().st_mtime_ns, COMMITTED.read_bytes()) == before
    report = json.loads(path.read_text())

    def key_tree(d):
        return {k: key_tree(v) if isinstance(v, dict) else None for k, v in d.items()}
    assert key_tree(report) == key_tree(json.loads(before[1]))
    assert report["backpressure_small_sockbuf"]["verified"]
    assert report["recv_ring_buffer"]["pool_balanced_at_teardown"]
    assert report["recv_ring_buffer"]["live_leases_at_teardown"] == 0
    cq = report["comm_quant_narrow_link"]
    assert cq["within_error_bound"] and cq["raw_roundtrip_exact"]
    assert report["intra_op_scaling"]["bit_identical"]
    assert report["drain_rehome"]["dropped"] == 0
    # after the smoke rows, the summary rows: the reference's names, in its order
    ref_src = (ROOT / "benchmarks" / "run.py").read_text()
    want = re.findall(r'rows\.append\(\("(dataplane/\w+)"', ref_src)
    want.remove("dataplane/ERROR")
    n_smoke = len([r for bench in SMOKE for r in bench()])
    assert [r[0] for r in rows[n_smoke:]] == want


def test_run_full_prints_every_reference_section(records, ref_reads, tmp_path):
    rows = _csv(_run_cli("--no-json", "--device", "cpu", "--dryrun-dir", records,
                         cwd=tmp_path).stdout)
    names = [r[0] for r in rows]
    assert not any(n.endswith("/ERROR") for n in names)
    paper = [label for fn in RP.ALL_TABLES.values() for label, *_ in fn()]
    micro = [n for n in names if not n.startswith("roofline/")][len(paper):]
    assert names[:len(paper)] == paper
    assert [n.split("/")[0] for n in micro] == [
        "serialize", "deserialize"] * 3 + ["dataplane"] * 4 + ["tcp"] * 2 + [
        "kernel_ref"] * 3 + ["moe", "engine"] + ["avec_real"] * 4
    assert [n for n in names if n.startswith("roofline/")] == [r[0] for r in RR.rows()]
