"""Device-aligner end-to-end bit-exactness vs reference golden outputs.

Runs the full jitted pipeline (on the CPU backend here; chip_smoke.py runs
the same program on the GPU) and checks byte-equality of every output
file.
"""

import os

import pytest

from danbing_tk_tpu.engine.align_runner import DeviceAlignRunner
from danbing_tk_tpu.engine.host_align import AlignConfig, RPGG


@pytest.fixture(scope="module")
def rpgg():
    golden_dir = os.path.join(os.path.dirname(__file__), "golden")
    return RPGG(os.path.join(golden_dir, "pan"))


def _golden(golden_dir, name):
    return open(os.path.join(golden_dir, name), "rb").read()


def test_device_align_bit_exact(rpgg, golden_dir, tmp_path):
    cfg = AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1,
                      output_bubbles=True)
    run = DeviceAlignRunner(rpgg, cfg, batch_pairs=1024, max_read_len=192)
    run.run_file(os.path.join(golden_dir, "reads.fa"))

    run.write_kam(tmp_path / "out.kam")
    run.write_tr_kmers(tmp_path / "out.tr.kmers")
    run.write_trkmc_ar(tmp_path / "out.trkmc.ar")
    run.write_summary(tmp_path / "out.tr.summary.txt")
    run.write_bubbles(tmp_path / "out.bub.kmdb")

    assert (tmp_path / "out.trkmc.ar").read_bytes() == _golden(
        golden_dir, "out.trkmc.ar")
    assert (tmp_path / "out.tr.kmers").read_bytes() == _golden(
        golden_dir, "out.on.tr.kmers")
    assert (tmp_path / "out.tr.summary.txt").read_bytes() == _golden(
        golden_dir, "out.tr.summary.txt")
    assert (tmp_path / "out.kam").read_bytes() == _golden(golden_dir,
                                                          "out.kam")
    assert (tmp_path / "out.bub.kmdb").read_bytes() == _golden(
        golden_dir, "out.bub.kmdb")
    # referee rate must stay small (golden set has deliberately ambiguous
    # shared-motif loci producing vote ties; ~1.4% here)
    assert run.n_referee <= 0.05 * 4600, run.n_referee
    # reason masks cover every referee'd pair (reasons can overlap)
    assert sum(run.referee_reasons.values()) >= run.n_referee, \
        run.referee_reasons


def test_device_align_simmode(rpgg, golden_dir, tmp_path):
    cfg = AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1, simmode=2)
    run = DeviceAlignRunner(rpgg, cfg, batch_pairs=1024, max_read_len=192)
    run.run_file(os.path.join(golden_dir, "reads.sim.fa"))
    run.write_kam(tmp_path / "out.sim.kam")
    assert (tmp_path / "out.sim.kam").read_bytes() == _golden(
        golden_dir, "out.sim.kam")
