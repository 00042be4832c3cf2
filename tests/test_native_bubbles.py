"""-bu bubbles on the native production path.

The reference emits novel-edge (bubble) counts in its one monolithic
pass (aQueryFasta_thread.cpp:2161-2166, dumpBubbles); the native-ingest
prefilter runner must produce a byte-identical .bub.kmdb to the slow
path — which requires replaying the reads_per_batch flush cadence
(accumBubbles merge order shapes the replayed libstdc++ map order).
"""

import os

import numpy as np
import pytest

from danbing_tk_tpu.engine.align_runner import DeviceAlignRunner
from danbing_tk_tpu.engine.host_align import AlignConfig, HostAligner, RPGG


def _golden(golden_dir, name):
    return open(os.path.join(golden_dir, name), "rb").read()


@pytest.mark.parametrize("prefilter", [False, True])
def test_native_bubbles_bit_exact(golden_dir, tmp_path, prefilter):
    reads = os.path.join(golden_dir, "reads.fa")
    cfg = AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1,
                      okam=False, output_bubbles=True)
    al = DeviceAlignRunner(RPGG(os.path.join(golden_dir, "pan")), cfg,
                           batch_pairs=1024, max_read_len=192)
    al.run_file_native(reads, prefilter=prefilter)
    al.write_bubbles(str(tmp_path / "nat.bub.kmdb"))
    al.write_trkmc_ar(str(tmp_path / "nat.trkmc.ar"))
    assert (tmp_path / "nat.bub.kmdb").read_bytes() == _golden(
        golden_dir, "out.bub.kmdb")
    assert (tmp_path / "nat.trkmc.ar").read_bytes() == _golden(
        golden_dir, "out.trkmc.ar")


@pytest.mark.parametrize("prefilter", [False, True])
def test_native_bubbles_flush_cadence(golden_dir, tmp_path, prefilter):
    """Tiny reads_per_batch forces flush boundaries both inside repack
    buffers and between prefilter dispatches; the host slow path at the
    same cadence is the ground truth for the merge order."""
    reads = os.path.join(golden_dir, "reads.fa")
    mk = dict(ksize=21, cth=20, n_filter=4, nm_filter=1, okam=False,
              output_bubbles=True, reads_per_batch=26)
    ref = HostAligner(RPGG(os.path.join(golden_dir, "pan")),
                      AlignConfig(**mk))
    ref.run_file(reads)
    ref.write_bubbles(str(tmp_path / "host.bub.kmdb"))

    al = DeviceAlignRunner(RPGG(os.path.join(golden_dir, "pan")),
                           AlignConfig(**mk),
                           batch_pairs=8, max_read_len=192)
    al.run_file_native(reads, prefilter=prefilter)
    al.write_bubbles(str(tmp_path / "nat.bub.kmdb"))
    assert (tmp_path / "nat.bub.kmdb").read_bytes() == \
        (tmp_path / "host.bub.kmdb").read_bytes()
    np.testing.assert_array_equal(al.flat_counts(), ref.flat_counts())
