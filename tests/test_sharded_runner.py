"""Full production loop under shard_map: the
ShardedAlignRunner drives run_file_native — prefilter window, dense
survivor repack, device retry, checkpoint/resume, host referee, bubble
maps, finalize — on the 8-device virtual CPU mesh, and every output must
be byte-equal to the single-device DeviceAlignRunner."""

import os

import numpy as np
import pytest

from danbing_tk_tpu.engine.align_runner import DeviceAlignRunner
from danbing_tk_tpu.engine.host_align import AlignConfig, RPGG
from danbing_tk_tpu.parallel.runner import ShardedAlignRunner


def _pan(golden_dir):
    return RPGG(os.path.join(golden_dir, "pan"))


@pytest.mark.parametrize("shard_index", [False, True])
def test_sharded_funnel_matches_single_device(golden_dir, shard_index):
    import jax
    assert len(jax.devices()) == 8
    reads = os.path.join(golden_dir, "reads.fa")
    cfg = AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1, okam=False)

    one = DeviceAlignRunner(_pan(golden_dir), cfg, batch_pairs=64,
                            max_read_len=192, expand_cap=128,
                            retry_expand=512)
    one.run_file_native(reads, prefilter=True)

    many = ShardedAlignRunner(_pan(golden_dir), cfg, batch_pairs=64,
                              max_read_len=192, expand_cap=128,
                              retry_expand=512, shard_index=shard_index)
    many.run_file_native(reads, prefilter=True)

    np.testing.assert_array_equal(many.flat_counts(), one.flat_counts())
    assert many.n_prefiltered == one.n_prefiltered
    assert many.n_referee == one.n_referee
    assert many.n_retried == one.n_retried
    assert many.referee_reasons == one.referee_reasons
    nm1 = one._dev_state("nmapread")[:-1] + one.host.nmapread
    nmN = many._dev_state("nmapread")[:-1] + many.host.nmapread
    np.testing.assert_array_equal(nmN, nm1)
    # and the single-device funnel itself equals the reference golden
    from danbing_tk_tpu.io.binary import read_karray

    gold = read_karray(os.path.join(golden_dir, "out.trkmc.ar"))
    np.testing.assert_array_equal(one.flat_counts(), gold)


def test_sharded_funnel_bubbles(golden_dir, tmp_path):
    """-bu on the sharded production path: .bub.kmdb byte-equal to the
    reference golden."""
    reads = os.path.join(golden_dir, "reads.fa")
    cfg = AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1,
                      okam=False, output_bubbles=True)
    al = ShardedAlignRunner(_pan(golden_dir), cfg, batch_pairs=64,
                            max_read_len=192)
    al.run_file_native(reads, prefilter=True)
    al.write_bubbles(str(tmp_path / "sh.bub.kmdb"))
    golden = open(os.path.join(golden_dir, "out.bub.kmdb"), "rb").read()
    assert (tmp_path / "sh.bub.kmdb").read_bytes() == golden


def test_sharded_checkpoint_resume(golden_dir, tmp_path, monkeypatch):
    """Interrupt the sharded prefilter funnel mid-run (SIGKILL-equivalent:
    a new runner object), resume from the checkpoint: counts byte-equal
    to an uninterrupted run."""
    # drain each prefilter dispatch immediately so checkpoints are
    # written before the injected failure
    monkeypatch.setenv("DTK_PREFILTER_WINDOW", "1")
    reads = os.path.join(golden_dir, "reads.fa")
    cfg = AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1, okam=False)
    ck = str(tmp_path / "sh.ckpt")

    full = ShardedAlignRunner(_pan(golden_dir), cfg, batch_pairs=64,
                              max_read_len=192)
    full.run_file_native(reads, prefilter=True)
    want = full.flat_counts()

    class Stop(Exception):
        pass

    r1 = ShardedAlignRunner(_pan(golden_dir), cfg, batch_pairs=64,
                            max_read_len=192)
    orig = r1._build_prefilter

    def wrap(Pp):
        inner = orig(Pp)
        n = {"c": 0}

        def bomb(codes, rlen, live):
            if n["c"] >= 3:
                raise Stop()
            n["c"] += 1
            return inner(codes, rlen, live)

        return bomb

    r1._build_prefilter = wrap
    with pytest.raises(Stop):
        r1.run_file_native(reads, checkpoint=ck, checkpoint_every=128,
                           prefilter=True)
    assert os.path.exists(ck)

    r2 = ShardedAlignRunner(_pan(golden_dir), cfg, batch_pairs=64,
                            max_read_len=192)
    r2.run_file_native(reads, checkpoint=ck, checkpoint_every=128,
                       prefilter=True)
    np.testing.assert_array_equal(r2.flat_counts(), want)
