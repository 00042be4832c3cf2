"""-e extract mode: byte-exact vs reference goldens (host + device)."""

import io
import os

import pytest

from danbing_tk_tpu.engine.host_align import AlignConfig, HostAligner, RPGG


def _gold(golden_dir, name):
    return open(os.path.join(golden_dir, name)).read()


@pytest.mark.parametrize("e", [1, 2])
def test_host_extract(golden_dir, e):
    rpgg = RPGG(os.path.join(golden_dir, "pan"))
    cfg = AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1, extract=e)
    al = HostAligner(rpgg, cfg)
    al.run_file(os.path.join(golden_dir, "reads.fa"))
    buf = io.StringIO()
    al.write_extract(buf)
    assert buf.getvalue() == _gold(golden_dir, f"out.e{e}.fa")


def test_host_extract_fastq(golden_dir):
    rpgg = RPGG(os.path.join(golden_dir, "pan"))
    cfg = AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1,
                      extract=1, simmode=2, is_fastq=True)
    al = HostAligner(rpgg, cfg)
    al.run_file(os.path.join(golden_dir, "reads.sim.fq"))
    buf = io.StringIO()
    al.write_extract(buf)
    assert buf.getvalue() == _gold(golden_dir, "out.fq.e1.fq")


def test_device_extract(golden_dir):
    from danbing_tk_tpu.engine.align_runner import DeviceAlignRunner

    rpgg = RPGG(os.path.join(golden_dir, "pan"))
    cfg = AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1, extract=2)
    al = DeviceAlignRunner(rpgg, cfg, batch_pairs=512)
    al.run_file(os.path.join(golden_dir, "reads.fa"))
    buf = io.StringIO()
    al.write_extract(buf)
    assert buf.getvalue() == _gold(golden_dir, "out.e2.fa")


def test_device_extract_threading(golden_dir):
    """No reference oracle (threading disabled at HEAD); device == host."""
    from danbing_tk_tpu.engine.align_runner import DeviceAlignRunner

    def run(cls, **kw):
        rpgg = RPGG(os.path.join(golden_dir, "pan"))
        cfg = AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1,
                          extract=1, simmode=2, threading=True,
                          thread_cth=50, maxncorrection=3)
        al = cls(rpgg, cfg, **kw)
        al.run_file(os.path.join(golden_dir, "reads.sim.fa"))
        buf = io.StringIO()
        al.write_extract(buf)
        return buf.getvalue()

    host = run(HostAligner)
    dev = run(DeviceAlignRunner, batch_pairs=512)
    assert host == dev
    assert host.count("\n") > 0


def test_track_bait_btk(golden_dir, tmp_path):
    """-tb bait tracker .btk.kmdb byte-exact vs reference golden."""
    rpgg = RPGG(os.path.join(golden_dir, "pan"), bait=True)
    cfg = AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1,
                      simmode=2, bait=True, track_bait=True)
    al = HostAligner(rpgg, cfg)
    al.run_file(os.path.join(golden_dir, "reads.sim.fa"))
    al.write_btk(str(tmp_path / "our.btk.kmdb"))
    assert (tmp_path / "our.btk.kmdb").read_bytes() == open(
        os.path.join(golden_dir, "out.tb.btk.kmdb"), "rb").read()


def test_trim_db_selection(golden_dir, tmp_path, monkeypatch):
    """-t reads $PREF.tr.trim<T>.kmers as the TR kmer DB."""
    import shutil

    pan = tmp_path / "pan"
    for suf in (".kmers.dbi", ".fl.kdb", ".tre.kdb", ".tr.kmers",
                ".graph.kmers"):
        shutil.copy(os.path.join(golden_dir, "pan" + suf),
                    str(pan) + suf)
    shutil.copy(str(pan) + ".tr.kmers", str(pan) + ".tr.trim3.kmers")
    os.remove(str(pan) + ".tr.kmers")
    rpgg = RPGG(str(pan), trim=3)
    assert rpgg.nloci > 0


def test_device_extract_fastq(golden_dir):
    """Device runner, fastq input, -e 1: byte-exact vs the reference
    golden."""
    from danbing_tk_tpu.engine.align_runner import DeviceAlignRunner

    rpgg = RPGG(os.path.join(golden_dir, "pan"))
    cfg = AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1,
                      extract=1, simmode=2, is_fastq=True)
    al = DeviceAlignRunner(rpgg, cfg, batch_pairs=512)
    al.run_file(os.path.join(golden_dir, "reads.sim.fq"))
    buf = io.StringIO()
    al.write_extract(buf)
    assert buf.getvalue() == _gold(golden_dir, "out.fq.e1.fq")
