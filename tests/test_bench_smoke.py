"""The measurement scripts refuse to run without a GPU: bench.py and
chip_smoke.py exit non-zero on the CPU backend and print no result line.
(Their device paths run on the card; see chip_smoke.py.)"""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, os.path.join(ROOT, script), *args],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT,
    )


@pytest.mark.parametrize(
    "script,args",
    [("bench.py", ()), ("chip_smoke.py", ()), ("chip_smoke.py", ("--cards", "4"))],
)
def test_refuses_cpu(script, args):
    p = _run(script, *args)
    assert p.returncode != 0
    assert not any(ln.startswith("{") for ln in p.stdout.splitlines()), p.stdout
    assert "cpu" in (p.stdout + p.stderr).lower()


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py copied away from the package cannot run at all."""
    import shutil

    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    p = subprocess.run(
        [sys.executable, "chip_smoke.py"], capture_output=True, text=True,
        timeout=300, env=env, cwd=tmp_path,
    )
    assert p.returncode != 0
    assert not any(ln.startswith("{") for ln in p.stdout.splitlines())
