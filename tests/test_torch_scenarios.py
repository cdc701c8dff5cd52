"""The port's shell scenarios as processes on the CPU (a discovery runner,
as tests/test_cmds.py runs the reference's test/ scripts).

Every executable under drynx_tpu_torch/scenarios/ runs under bash with
DRYNX_SCENARIO_CPU=1, which its lib.sh turns into `--cpu` for `server run`
and `survey run` (on the card the scenarios need no variable). Each must
exit 0 and print OK. The copies are the reference's scenarios with the
port's entry points: their checks are the same lines. client_network-new
boots no server and runs in the fast tier; the others boot servers and
run whole surveys on the CPU (the proofs-on ones for ~minutes), so they
are marked slow.
"""
import os
import pathlib
import subprocess

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCENARIOS = ROOT / "drynx_tpu_torch" / "scenarios"
REFERENCE = ROOT / "test"


def _scripts():
    return sorted(p for p in SCENARIOS.iterdir()
                  if p.name != "lib.sh" and not p.is_dir())


def test_every_reference_scenario_has_a_port_copy():
    assert ({p.name for p in _scripts()}
            == {p.name for p in REFERENCE.iterdir() if p.name != "lib.sh"})
    for p in _scripts():
        text = p.read_text()
        assert os.access(p, os.X_OK), p
        assert "drynx_tpu." not in text and "jax" not in text, p
        assert "echo OK" in text


@pytest.mark.parametrize(
    "script", [pytest.param(p, id=p.name, marks=(
        [] if p.name == "client_network-new" else [pytest.mark.slow]))
        for p in _scripts()])
def test_scenario_runs_on_the_cpu(script):
    env = dict(os.environ, DRYNX_SCENARIO_CPU="1")
    limit = 5400 if "proofs" in script.name else 900
    r = subprocess.run(["bash", str(script)], capture_output=True, text=True,
                       timeout=limit, env=env)
    assert r.returncode == 0, (
        f"{script.name} failed\nstdout:\n{r.stdout}\nstderr:\n{r.stderr}")
    assert "OK" in r.stdout
