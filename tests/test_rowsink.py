"""Streaming row sinks: .kam-scale side outputs must be O(1) memory with
byte-identical files.
"""

import os

from danbing_tk_tpu.engine.host_align import AlignConfig, HostAligner, RPGG
from danbing_tk_tpu.io.rowsink import RowSink


def test_rowsink_order_and_pop(tmp_path):
    p = str(tmp_path / "rows.txt")
    s = RowSink(p, flush_every=4)
    rows = [f"row{i}\n" for i in range(13)]
    for i, r in enumerate(rows):
        s.append(r)
        if i == 6:  # steal the newest row (the referee pattern)
            assert s.pop() == r
            s.append(r)
    assert len(s) == 13
    s.close()
    assert open(p).read() == "".join(rows)


def test_rowsink_bounded_buffer(tmp_path):
    s = RowSink(str(tmp_path / "big.txt"), flush_every=16)
    for i in range(10_000):
        s.append(f"{i}\n")
        assert len(s._buf) <= 17  # never accumulates beyond one batch
    s.close()
    assert sum(1 for _ in open(tmp_path / "big.txt")) == 10_000


def test_streamed_kam_byte_identical(golden_dir, tmp_path):
    rpgg = RPGG(os.path.join(golden_dir, "pan"))
    cfg = AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1)

    al = HostAligner(rpgg, cfg)
    al.kam_rows = RowSink(str(tmp_path / "stream.kam"), flush_every=2)
    al.run_file(os.path.join(golden_dir, "reads.fa"))
    al.write_kam(str(tmp_path / "stream.kam"))

    golden = open(os.path.join(golden_dir, "out.kam"), "rb").read()
    assert (tmp_path / "stream.kam").read_bytes() == golden
