import os

# The suite runs on JAX's CPU backend, as a virtual 8-device mesh, unless
# JAX_PLATFORMS names another platform.  Tests marked `gpu` need an
# NVIDIA GPU and skip elsewhere; on a GPU host run them with
#   JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
# (chip_smoke.py drives the main path on the card end to end).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "1")

import subprocess  # noqa: E402

import pytest  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

# Build the native C++ engines BEFORE collection: the native-gated tests'
# skipif conditions (native_referee/native_thread.available()) are
# evaluated while test modules import, so on a fresh checkout (no
# build/*.so yet) they would all skip even though the libs build fine.
# A no-op make returns in milliseconds once the libs are current.
_NATIVE = os.path.join(os.path.dirname(__file__), "..", "native")
try:
    _r = subprocess.run(["make", "-C", _NATIVE], check=False,
                        capture_output=True, timeout=300, text=True)
    if _r.returncode != 0:
        import sys as _sys
        print(f"WARNING: native build failed (rc={_r.returncode}); "
              f"native-gated tests will skip.  stderr tail:\n"
              f"{_r.stderr[-2000:]}", file=_sys.stderr)
except Exception as _e:  # tests that need the libs skip with their own reason
    import sys as _sys
    print(f"WARNING: native build could not run ({_e}); "
          f"native-gated tests will skip", file=_sys.stderr)


@pytest.fixture(scope="session")
def golden_dir():
    return GOLDEN


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips on other backends")


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skips `gpu` tests unless JAX's backend is a GPU (decided per test,
    never at import, so every xdist worker collects the same tests)."""
    if request.node.get_closest_marker("gpu") is not None:
        import jax

        if jax.default_backend() != "gpu":
            pytest.skip(f"needs an NVIDIA GPU (JAX backend: "
                        f"{jax.default_backend()})")
