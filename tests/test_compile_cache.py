"""Persistent compile cache: JAX_COMPILATION_CACHE_DIR wins; otherwise a
fixed directory inside the checkout."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = (
    "import jax\n"
    "from danbing_tk_tpu.utils.compile_cache import enable_compile_cache\n"
    "p = enable_compile_cache()\n"
    "print(p)\n"
    "print(jax.config.jax_compilation_cache_dir)\n"
)


def _probe(env_extra, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(env_extra, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.split()


def test_env_dir_is_honoured(tmp_path):
    want = str(tmp_path / "cache")
    path, configured = _probe({"JAX_COMPILATION_CACHE_DIR": want})
    assert path == want
    assert configured == want


def test_default_dir_is_fixed_in_checkout():
    path, configured = _probe({}, drop=("JAX_COMPILATION_CACHE_DIR",))
    assert path == os.path.join(ROOT, "build", "jaxcache")
    assert configured == path
