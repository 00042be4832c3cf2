"""Real 2-process jax.distributed run.

Spawns two controller processes (2 virtual CPU devices each -> a 4-device
global topology), each genotyping its round-robin shard of the golden
reads; global_merge() all-gathers the per-locus count vectors over the
coordination service and every process must produce a merged vector
byte-equal to a single-process run of the full file.
"""

import os
import socket
import subprocess
import sys

import numpy as np

from danbing_tk_tpu.engine.host_align import AlignConfig, HostAligner, RPGG

HERE = os.path.dirname(__file__)
ROOT = os.path.dirname(HERE)
GOLD = os.path.join(HERE, "golden")
WORKER = os.path.join(ROOT, "tools", "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_controller_global_merge(tmp_path):
    port = _free_port()
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=2",
        JAX_ENABLE_X64="1",
        PYTHONPATH=ROOT,
    )
    reads = os.path.join(GOLD, "reads.fa")
    pan = os.path.join(GOLD, "pan")
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), "2", str(port), reads, pan,
             str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for pid in (0, 1)
    ]
    for p in procs:
        out, err = p.communicate(timeout=540)
        assert p.returncode == 0, err.decode()

    merged0 = np.load(tmp_path / "merged.0.npy")
    merged1 = np.load(tmp_path / "merged.1.npy")
    np.testing.assert_array_equal(merged0, merged1)

    # single-process ground truth over the unsplit file
    al = HostAligner(RPGG(pan),
                     AlignConfig(ksize=21, cth=20, okam=False, nm_tr=20))
    al.run_file(reads)
    np.testing.assert_array_equal(merged0, al.flat_counts())
    assert merged0.sum() > 0


def test_two_controller_crash_resume(tmp_path):
    """Fault-injection drill for the multi-host path (SURVEY §5 failure
    detection): both controllers are killed mid-shard right after a
    checkpoint (exit 17, simulating preemption), then the job restarts
    and each worker resumes from its own checkpoint; the merged counts
    must be byte-equal to an uninterrupted single-process run."""
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=2",
        JAX_ENABLE_X64="1",
        PYTHONPATH=ROOT,
        DTK_WORKER_CKPT=str(tmp_path / "ck.%d.npz"),
    )
    reads = os.path.join(GOLD, "reads.fa")
    pan = os.path.join(GOLD, "pan")

    def round_(extra_env, want_rc):
        port = _free_port()
        procs = [
            subprocess.Popen(
                [sys.executable, WORKER, str(pid), "2", str(port), reads,
                 pan, str(tmp_path)],
                env={**env, **extra_env},
                stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            for pid in (0, 1)
        ]
        errs = []
        for p in procs:
            out, err = p.communicate(timeout=540)
            assert p.returncode == want_rc, err.decode()
            errs.append(err.decode())
        return errs

    errs = round_({"DTK_WORKER_FAULT": "600"}, 17)
    assert all("injected fault at cursor=" in e for e in errs)
    assert os.path.exists(tmp_path / "ck.0.npz")
    assert os.path.exists(tmp_path / "ck.1.npz")

    errs = round_({}, 0)
    for e in errs:
        cur = int(e.split("resume cursor=")[1].split()[0])
        assert cur >= 600, e  # actually resumed, not a fresh run

    merged0 = np.load(tmp_path / "merged.0.npy")
    merged1 = np.load(tmp_path / "merged.1.npy")
    np.testing.assert_array_equal(merged0, merged1)
    al = HostAligner(RPGG(pan),
                     AlignConfig(ksize=21, cth=20, okam=False, nm_tr=20))
    al.run_file(reads)
    np.testing.assert_array_equal(merged0, al.flat_counts())
