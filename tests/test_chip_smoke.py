"""chip_smoke.py refuses to report success without a GPU, and without the
rest of the repository."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("alone", [False, True],
                         ids=["checkout", "script_alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_env_phase_rejects_cpu():
    """The env phase itself fails on a non-GPU backend (independent of
    whether nvidia-smi exists on this host)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "chip_smoke.py", "--phase", "env"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"platform": "cpu"' in r.stdout
    assert "not gpu" in r.stderr
