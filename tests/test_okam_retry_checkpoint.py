"""okam/-bu on the native path with the retry ladder + checkpointing:
side outputs are re-serialized in pair order via
the ordinal-effect buffer, so a tiered run (overflow pairs resolved out
of order on bigger-E device steps) and a crash-resumed run both produce
byte-identical .kam/.bub/.trkmc.ar to the uninterrupted no-retry run
(which is itself golden-tested against the reference binaries in
test_native_kam.py)."""

import os
import shutil

import numpy as np
import pytest

from danbing_tk_tpu.engine.align_runner import DeviceAlignRunner
from danbing_tk_tpu.engine.host_align import AlignConfig, RPGG
from danbing_tk_tpu.io.rowsink import RowSink


def _golden(golden_dir, name):
    return open(os.path.join(golden_dir, name), "rb").read()


def _cfg(**kw):
    return AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1,
                       output_bubbles=True, **kw)


def test_okam_bub_retry_ladder_bit_exact(golden_dir, tmp_path):
    """Tiny primary expansion cap forces most pairs through the retry
    ladder; .kam/.bub/.trkmc.ar must still match the reference goldens
    byte-for-byte (ordinal reordering restores pair order)."""
    al = DeviceAlignRunner(RPGG(os.path.join(golden_dir, "pan")),
                           _cfg(), batch_pairs=256, max_read_len=192,
                           expand_cap=32, retry_expand=[64, 512])
    al.run_file_native(os.path.join(golden_dir, "reads.fa"),
                       prefilter=True)
    assert al.n_retried > 0, "expand_cap=32 should overflow some pairs"
    al.write_kam(str(tmp_path / "r.kam"))
    al.write_trkmc_ar(str(tmp_path / "r.trkmc.ar"))
    al.write_bubbles(str(tmp_path / "r.bub.kmdb"))
    assert (tmp_path / "r.kam").read_bytes() == _golden(golden_dir,
                                                        "out.kam")
    assert (tmp_path / "r.trkmc.ar").read_bytes() == _golden(
        golden_dir, "out.trkmc.ar")
    assert (tmp_path / "r.bub.kmdb").read_bytes() == _golden(
        golden_dir, "out.bub.kmdb")


@pytest.mark.parametrize("retry", [0, [512]])
def test_okam_bub_checkpoint_resume(golden_dir, tmp_path, retry):
    """Crash-resume an okam+bu run: take a mid-run checkpoint, copy the
    (longer) streamed .kam as the crash-time file, resume a fresh
    runner from the checkpoint — all outputs byte-identical to golden.
    The small reads_per_batch also exercises bubble-flush-boundary
    realignment on resume."""
    reads = os.path.join(golden_dir, "reads.fa")
    ck = str(tmp_path / "ok.ckpt")
    kam1 = str(tmp_path / "a.kam")

    r1 = DeviceAlignRunner(RPGG(os.path.join(golden_dir, "pan")),
                           _cfg(reads_per_batch=512), batch_pairs=128,
                           max_read_len=192, expand_cap=64,
                           retry_expand=retry)
    r1.kam_rows = RowSink(kam1)
    mid = {}
    orig_write = r1._ckpt_write

    def hook(path, cursor, state, hsnap, extra):
        orig_write(path, cursor, state, hsnap, extra)
        if not mid:                      # keep the FIRST (mid-run) save
            shutil.copy(path, path + ".mid")
            mid["cursor"] = cursor

    r1._ckpt_write = hook
    r1.run_file_native(reads, checkpoint=ck, checkpoint_every=256,
                       prefilter=True)
    r1.write_kam(kam1)
    r1.write_trkmc_ar(str(tmp_path / "a.trkmc.ar"))
    r1.write_bubbles(str(tmp_path / "a.bub.kmdb"))
    assert (tmp_path / "a.kam").read_bytes() == _golden(golden_dir,
                                                        "out.kam")
    assert (tmp_path / "a.bub.kmdb").read_bytes() == _golden(
        golden_dir, "out.bub.kmdb")
    assert mid, "no mid-run checkpoint was captured"
    assert 0 < mid["cursor"] < 4595, "mid checkpoint should be mid-run"

    # crash simulation: the .kam on disk holds MORE rows than the mid
    # checkpoint's high-water mark (rows streamed after the save)
    kam2 = str(tmp_path / "b.kam")
    shutil.copy(kam1, kam2)
    shutil.copy(ck + ".mid", ck)
    r2 = DeviceAlignRunner(RPGG(os.path.join(golden_dir, "pan")),
                           _cfg(reads_per_batch=512), batch_pairs=128,
                           max_read_len=192, expand_cap=64,
                           retry_expand=retry)
    r2.kam_rows = RowSink(kam2, append=True)
    r2.run_file_native(reads, checkpoint=ck, checkpoint_every=256,
                       prefilter=True)
    r2.write_kam(kam2)
    r2.write_trkmc_ar(str(tmp_path / "b.trkmc.ar"))
    r2.write_bubbles(str(tmp_path / "b.bub.kmdb"))
    assert (tmp_path / "b.kam").read_bytes() == _golden(golden_dir,
                                                        "out.kam")
    assert (tmp_path / "b.trkmc.ar").read_bytes() == _golden(
        golden_dir, "out.trkmc.ar")
    assert (tmp_path / "b.bub.kmdb").read_bytes() == _golden(
        golden_dir, "out.bub.kmdb")
    np.testing.assert_array_equal(r2.flat_counts(), r1.flat_counts())


def test_okam_resume_config_mismatch_refused(golden_dir, tmp_path):
    """A checkpoint written by an okam run must refuse to resume into a
    counting-mode runner (side-output state would be dropped)."""
    reads = os.path.join(golden_dir, "reads.fa")
    ck = str(tmp_path / "mm.ckpt")
    r1 = DeviceAlignRunner(RPGG(os.path.join(golden_dir, "pan")),
                           _cfg(), batch_pairs=128, max_read_len=192)
    r1.kam_rows = RowSink(str(tmp_path / "m.kam"))
    r1.run_file_native(reads, checkpoint=ck, checkpoint_every=256,
                       prefilter=True)
    r2 = DeviceAlignRunner(
        RPGG(os.path.join(golden_dir, "pan")),
        AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1,
                    okam=False),
        batch_pairs=128, max_read_len=192)
    with pytest.raises(ValueError, match="okam"):
        r2.run_file_native(reads, checkpoint=ck, checkpoint_every=256,
                           prefilter=True)
