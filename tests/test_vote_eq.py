"""Event-space (sort-free) voting — DTK_VOTE_EQ=1 — must be
decision-identical to the sorted-segment path: same .kam/.trkmc.ar/.bub
bytes on the okam+bubbles golden flow (ties, overflow retries and the
test2 boundary all present there), and same .aln in simmode.

The equality-matmul path replaces the (locus, -nm) lax.sort with one
batched bf16 equality-matmul + fused masked reduces;
this test pins its decisions to the reference goldens byte-for-byte.
"""

import os

import pytest

from danbing_tk_tpu.engine.align_runner import DeviceAlignRunner
from danbing_tk_tpu.engine.host_align import AlignConfig, RPGG


@pytest.fixture(autouse=True)
def _vote_eq_env(monkeypatch):
    monkeypatch.setenv("DTK_VOTE_EQ", "1")


def _gold(golden_dir, name):
    return open(os.path.join(golden_dir, name), "rb").read()


def test_vote_eq_okam_bub_bit_exact(golden_dir, tmp_path):
    cfg = AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1,
                      okam=True, output_bubbles=True)
    al = DeviceAlignRunner(RPGG(os.path.join(golden_dir, "pan")), cfg,
                           batch_pairs=256, max_read_len=192,
                           expand_cap=32, retry_expand=[64, 512])
    al.run_file_native(os.path.join(golden_dir, "reads.fa"),
                       prefilter=True)
    assert al.n_retried > 0
    al.write_kam(str(tmp_path / "r.kam"))
    al.write_trkmc_ar(str(tmp_path / "r.trkmc.ar"))
    al.write_bubbles(str(tmp_path / "r.bub.kmdb"))
    assert (tmp_path / "r.kam").read_bytes() == _gold(golden_dir,
                                                      "out.kam")
    assert (tmp_path / "r.trkmc.ar").read_bytes() == _gold(
        golden_dir, "out.trkmc.ar")
    assert (tmp_path / "r.bub.kmdb").read_bytes() == _gold(
        golden_dir, "out.bub.kmdb")


def test_vote_eq_sim_kam_bit_exact(golden_dir, tmp_path):
    cfg = AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1,
                      simmode=2, okam=True)
    al = DeviceAlignRunner(RPGG(os.path.join(golden_dir, "pan")), cfg,
                           batch_pairs=512, max_read_len=192)
    al.run_file_native(os.path.join(golden_dir, "reads.sim.fa"),
                       prefilter=True)
    al.write_kam(str(tmp_path / "out.kam"))
    al.write_trkmc_ar(str(tmp_path / "out.trkmc.ar"))
    assert (tmp_path / "out.kam").read_bytes() == _gold(
        golden_dir, "out.sim.kam")
    assert (tmp_path / "out.trkmc.ar").read_bytes() == _gold(
        golden_dir, "out.sim.trkmc.ar")
