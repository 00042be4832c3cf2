"""Driver entry points keep working: single-chip compile + 8-way dryrun."""

import os
import subprocess
import sys


def test_entry_and_dryrun():
    # run in a subprocess so backend re-configuration stays isolated
    code = (
        "import os\n"
        "os.environ['JAX_PLATFORMS']='cpu'\n"
        "os.environ['XLA_FLAGS']="
        "'--xla_force_host_platform_device_count=8'\n"
        "import jax\n"
        "jax.config.update('jax_platforms','cpu')\n"
        "import __graft_entry__ as ge\n"
        "fn, args = ge.entry()\n"
        "out = jax.jit(fn)(*args)\n"
        "jax.block_until_ready(out)\n"
        "print('entry-ok')\n"
        "ge.dryrun_multichip(8)\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code],
        cwd=os.path.join(os.path.dirname(__file__), ".."),
        capture_output=True, text=True, timeout=500)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "entry-ok" in r.stdout
    assert "dryrun_multichip(8): step ok" in r.stdout
    assert "funnel ok=True" in r.stdout


def test_dryrun_raises_on_too_few_devices():
    """No silent switch to a virtual CPU mesh: too few devices is an
    error naming the backend."""
    code = (
        "import jax\n"
        "import __graft_entry__ as ge\n"
        "n = len(jax.devices()) + 1\n"
        "try:\n"
        "    ge.dryrun_multichip(n)\n"
        "except RuntimeError as e:\n"
        "    print('raised:', e)\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    r = subprocess.run(
        [sys.executable, "-c", code],
        cwd=os.path.join(os.path.dirname(__file__), ".."), env=env,
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "raised: dryrun_multichip(3) needs 3 devices" in r.stdout
    assert "the cpu backend has 2" in r.stdout
