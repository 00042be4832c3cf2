"""Second-oracle QC-harness test.

Runs pipeline/qc.run_qc_harness — the fn1a->fn2a3 loop of the
reference's test/QC/*.sh scripts — over the reference's OWN bundled
fixtures (test/QC/input/: mini pan RPGG + HG002/hs1 fragments) and
compares every artifact byte-for-byte against goldens frozen from the
reference binaries by tools/make_golden_qc.py.

Unlike tests/golden/* (authored by tools/make_golden.py from synthetic
data), these goldens are builder-independent: the inputs are the
reference's shipped fixtures and the expected outputs come from
executing the reference's danbing-tk / baitBuilder / ktools / sim_reads
binaries over the identical flow.
"""

import glob
import os

import pytest

from danbing_tk_tpu.pipeline.qc import run_qc_harness, sanitize

HERE = os.path.dirname(__file__)
GOLD = os.path.join(HERE, "golden_qc")
REFQC = "/root/reference/test/QC/input"
GENOMES = ["HG002", "hs1"]
REF_GENOME = "hs1"


def _gold(name: str) -> str:
    return os.path.join(GOLD, name)


@pytest.fixture(scope="module")
def qc_work(tmp_path_factory):
    if not os.path.isdir(REFQC):
        pytest.skip("reference QC fixtures not available")
    indir = tmp_path_factory.mktemp("qc_in")
    for g in GENOMES:
        for h in (0, 1):
            os.symlink(os.path.join(REFQC, f"{g}.{h}.fa"),
                       indir / f"{g}.{h}.fa")
    for suf in (".kmers.dbi", ".fl.kdb", ".tre.kdb", ".tr.kmers"):
        os.symlink(os.path.abspath(_gold("pan" + suf)), indir / ("pan" + suf))
    work = tmp_path_factory.mktemp("qc_work")
    run_qc_harness(str(indir), str(work), GENOMES, REF_GENOME, min_ctg=500)
    return work


def _assert_bytes_equal(ours, gold):
    with open(ours, "rb") as f:
        got = f.read()
    with open(gold, "rb") as f:
        want = f.read()
    assert got == want, f"{os.path.basename(ours)} differs from golden"


def test_sim_beds_match_reference_sim_reads(qc_work):
    """Our sim_reads -bed -split output == reference sim_reads binary's
    (golden filenames are sanitize()d; content must be identical)."""
    beds = sorted(glob.glob(str(qc_work / "*.reads.bed")))
    assert len(beds) == 12  # 2 genomes x 2 haps x 3 contigs
    for b in beds:
        base = os.path.basename(b)
        pref, ctg_part = base.split(".reads.", 1)
        ctg = ctg_part[: -len(".reads.bed")]
        _assert_bytes_equal(b, _gold(f"{pref}.reads.{sanitize(ctg)}.reads.bed"))


@pytest.mark.parametrize("g", GENOMES)
def test_annot_and_extract(qc_work, g):
    _assert_bytes_equal(qc_work / f"{g}.annot.fa", _gold(f"{g}.annot.fa"))
    _assert_bytes_equal(qc_work / f"{g}.extract.fa", _gold(f"{g}.extract.fa"))


@pytest.mark.parametrize("g", GENOMES)
def test_raw_map(qc_work, g):
    for suf in (".kam", ".tr.summary.txt", ".trkmc.ar"):
        _assert_bytes_equal(qc_work / f"{g}.raw{suf}", _gold(f"{g}.raw{suf}"))


def test_profiles_and_fpskmer(qc_work):
    for name in ([f"profile.{g}.TP_pf.txt" for g in GENOMES]
                 + [f"map.{REF_GENOME}.TP_pf.txt",
                    f"map.{REF_GENOME}.FP_pf.txt",
                    "FPSkmer.v0.tsv"]):
        _assert_bytes_equal(qc_work / name, _gold(name))


def test_bait_serialization(qc_work):
    _assert_bytes_equal(qc_work / "pan.bt.kmdb", _gold("pan.bt.kmdb"))


@pytest.mark.parametrize("g", GENOMES)
def test_bait_map(qc_work, g):
    """The bait filter must remove the decoy-derived FP reads exactly as
    the reference does (14 hs1 / 14 HG002 pairs on these fixtures)."""
    for suf in (".kam", ".tr.summary.txt", ".trkmc.ar"):
        _assert_bytes_equal(qc_work / f"{g}.bait{suf}",
                            _gold(f"{g}.bait{suf}"))
