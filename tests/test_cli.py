"""CLI smoke: align subcommand reproduces golden outputs."""

import os
import subprocess
import sys

import pytest


def test_cli_align(golden_dir, tmp_path):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    out = tmp_path / "out"
    r = subprocess.run(
        [sys.executable, "-m", "danbing_tk_tpu", "align",
         "-k", "21", "-qs", os.path.join(golden_dir, "pan"),
         "-fa", os.path.join(golden_dir, "reads.fa"),
         "-cth", "20", "-kf", "4", "1", "-on", str(out)],
        cwd=os.path.join(os.path.dirname(__file__), ".."),
        env=env, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-2000:]
    assert (tmp_path / "out.tr.kmers").read_bytes() == open(
        os.path.join(golden_dir, "out.on.tr.kmers"), "rb").read()
    assert (tmp_path / "out.kam").read_bytes() == open(
        os.path.join(golden_dir, "out.kam"), "rb").read()


def test_cli_warmup(golden_dir, tmp_path):
    """warmup precompiles the (P, E) align programs into a persistent
    compile cache and exits cleanly (no reads needed)."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "jaxcache")
    r = subprocess.run(
        [sys.executable, "-m", "danbing_tk_tpu", "warmup",
         "-qs", os.path.join(golden_dir, "pan"),
         "-P", "64", "-L", "160", "--prefilter",
         # small expansion caps: the default E=512 costs minutes of XLA
         # compile on a CPU backend and this test only checks plumbing
         "--expand-cap", "64", "--retry-expand", "128"],
        cwd=os.path.join(os.path.dirname(__file__), ".."),
        env=env, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "align step P=64 E=64 compiled" in r.stderr
    assert "retry tier step" in r.stderr
    assert "prefilter P=256 compiled" in r.stderr
    assert (tmp_path / "jaxcache").is_dir()
    assert f"warmup done -> {tmp_path / 'jaxcache'}" in r.stderr
    assert os.listdir(tmp_path / "jaxcache"), "no compiled program cached"


def _align_device(golden_dir, tmp_path, env):
    return subprocess.run(
        [sys.executable, "-m", "danbing_tk_tpu", "align", "--device",
         "-k", "21", "-qs", os.path.join(golden_dir, "pan"),
         "-fa", os.path.join(golden_dir, "reads.fa"),
         "-cth", "20", "-kf", "4", "1", "-ka", "--expand-cap", "64",
         "-o", str(tmp_path / "out")],
        cwd=os.path.join(os.path.dirname(__file__), ".."),
        env=env, capture_output=True, text=True)


def test_cli_device_refuses_implicit_cpu(golden_dir, tmp_path):
    """With no accelerator and JAX_PLATFORMS unset, JAX falls back to its
    CPU backend; --device must refuse instead of running there."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    backend = subprocess.run(
        [sys.executable, "-c", "import jax; print(jax.default_backend())"],
        env=env, capture_output=True, text=True).stdout.strip()
    if backend != "cpu":
        pytest.skip(f"this host has an accelerator ({backend})")
    r = _align_device(golden_dir, tmp_path, env)
    assert r.returncode != 0
    assert "found no accelerator" in r.stderr
    assert not (tmp_path / "out.trkmc.ar").exists()


def test_cli_device_runs_on_explicit_cpu(golden_dir, tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "jaxcache"))
    r = _align_device(golden_dir, tmp_path, env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "device engine: platform=cpu" in r.stderr
    assert (tmp_path / "out.trkmc.ar").read_bytes() == open(
        os.path.join(golden_dir, "out.trkmc.ar"), "rb").read()
