"""``python -m repro_torch.obs`` prints the JAX package's CLI text: the knob
reference table (markdown and plain) and each knob's effective value and
source, with and without environment overrides; with no flag, its help
and exit code 1."""
import os
import subprocess
import sys

import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _cli(module: str, args, env_extra: dict) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if not k.startswith("AVEC_")}
    env.update(PYTHONPATH=SRC, **env_extra)
    return subprocess.run([sys.executable, "-m", module, *args], capture_output=True, text=True,
                          env=env, timeout=120)


@pytest.mark.parametrize("args,env,lines", [
    (["--knobs"], {}, 28),
    (["--knobs", "--format", "markdown"], {}, 28),
    (["--knobs", "--format", "plain"], {}, None),
    (["--effective"], {}, None),
    (["--effective"], {"AVEC_COALESCE_WINDOW_S": "0.005", "AVEC_ADAPTIVE_WINDOW": "0"}, None),
    (["--knobs"], {"AVEC_RPC_TIMEOUT_S": "7.5"}, 28),          # the table shows defaults
])
def test_obs_cli_prints_the_reference_text(args, env, lines):
    got, ref = _cli("repro_torch.obs", args, env), _cli("repro.obs", args, env)
    assert got.returncode == ref.returncode == 0, got.stderr
    assert got.stdout == ref.stdout and got.stdout.strip()
    if lines is not None:
        assert len(got.stdout.splitlines()) == lines
    if env and "--effective" in args:
        assert "0.005" in got.stdout and "(env)" in got.stdout


def test_obs_cli_without_a_flag_prints_help_and_exits_1():
    got, ref = _cli("repro_torch.obs", [], {}), _cli("repro.obs", [], {})
    assert got.returncode == ref.returncode == 1
    # the same help, wrapped for the longer program name
    assert got.stdout.replace("repro_torch.obs", "repro.obs").split() == ref.stdout.split()
