"""On the card, at a cell's own size: the program's readings stay within the
cell's limits and the fp8 control's do not.  Run on a machine with a CUDA
device: ``python -m pytest -m card portbench``."""
import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.mark.card
@pytest.mark.parametrize("workload,seconds", [("mamba2-130m.chat", 12)])
def test_control_fails_where_the_program_passes(workload, seconds):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with open(os.path.join(HERE, "limits", workload + ".json")) as f:
        limits = json.load(f)
    out = subprocess.run([sys.executable, os.path.join(HERE, "control.py"), "--workload",
                          workload, "--seeds", "11,12,13", "--seconds", str(seconds)],
                         capture_output=True, text=True, cwd=os.path.dirname(HERE),
                         timeout=900, check=True)
    lines = [json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")]
    assert len(lines) == 3
    for line in lines:
        c = line["checks"]
        assert all(c[k]["value"] <= limits[k]["limit"] for k in limits), c
        assert any(c[f"control.{k}"]["value"] > limits[k]["limit"] for k in limits), c
