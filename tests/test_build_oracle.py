"""Second-oracle BUILD-pipeline test.

Runs build_rpgg over the reference's own bundled test assemblies
(test/input/: HG00514/HG00733 regional contigs around a real chr12
VNTR, config per test/goodPanGenomeGraph.json) and compares every
artifact byte-for-byte against goldens frozen from the reference's
scripts/binaries by tools/make_golden_build.py.

The tmp1 liftover beds are shared glue (kmer_lift_tmp1; minimap2 is not
runnable here) consumed identically by both sides, so the comparison
isolates the MBE/merge/trfa/fa2kmers/genPanKmers/serialize stack.
"""

import os
import shutil

import pytest

from danbing_tk_tpu.pipeline.build import build_rpgg

HERE = os.path.dirname(__file__)
GOLD = os.path.join(HERE, "golden_build")
INDIR = "/root/reference/test/input"
GS = ["HG00514", "HG00733"]


@pytest.fixture(scope="module")
def build_work(tmp_path_factory):
    if not os.path.isdir(INDIR):
        pytest.skip("reference test fixtures not available")
    work = tmp_path_factory.mktemp("build_oracle")
    for g in GS:
        os.makedirs(work / g)
        for h in (0, 1):
            shutil.copy(os.path.join(GOLD, g, f"tmp1.{h}.bed"),
                        work / g / f"tmp1.{h}.bed")
    build_rpgg(str(work), INDIR, GS, os.path.join(INDIR, "tr.bed"),
               ksize=21, FS=500, TRWINDOW=100000, dist_merge=500,
               th1=0.31, th2=0.31)
    return work


def _assert_bytes_equal(ours, gold_name):
    with open(ours, "rb") as f:
        got = f.read()
    with open(os.path.join(GOLD, gold_name), "rb") as f:
        want = f.read()
    assert got == want, f"{gold_name} differs from golden"


def test_annotation_beds(build_work):
    for name in ("pan.tr.mbe.v0.bed", "pan.tr.mbe.v1.bed",
                 "pan.tr.mbe.v2.bed", "OrthoMap.v2.tsv", "mbe.m0.loci",
                 "locusMap.v1.to.v0.txt", "locusMap.v2.to.v1.txt"):
        _assert_bytes_equal(build_work / name, name)


@pytest.mark.parametrize("g", GS)
def test_trfa_and_genome_kmers(build_work, g):
    for h in (0, 1):
        _assert_bytes_equal(build_work / "trfa" / f"{g}.{h}.tr.fasta",
                            f"trfa/{g}.{h}.tr.fasta")
    # our no-prune per-genome prefix is {g}.PB; the reference snakefile
    # names it {g}.rawPB when pruning is off
    for t in ("tr", "fl", "graph", "tre"):
        _assert_bytes_equal(build_work / f"{g}.PB.{t}.kmers",
                            f"{g}.rawPB.{t}.kmers")


def test_pan_kmers_and_index(build_work):
    for name in ("pan.tr.kmers", "pan.fl.kmers", "pan.graph.kmers",
                 "pan.kmers.dbi", "pan.fl.kdb"):
        _assert_bytes_equal(build_work / name, name)


def test_pan_tre_sets(build_work):
    """The reference's tre merge mis-parses count-less .tre.kmers
    (documented deviation, apps/genpankmers.py); compare per-locus SETS
    of our pan.tre.kmers against the union of the golden per-genome tre
    files instead of bytes."""
    def read_sets(path):
        out = []
        for line in open(path):
            if line[0] == ">":
                out.append(set())
            else:
                out[-1].add(int(line.split()[0]))
        return out

    ours = read_sets(build_work / "pan.tre.kmers")
    union = read_sets(os.path.join(GOLD, f"{GS[0]}.rawPB.tre.kmers"))
    for g in GS[1:]:
        for li, s in enumerate(read_sets(
                os.path.join(GOLD, f"{g}.rawPB.tre.kmers"))):
            union[li] |= s
    assert [sorted(s) for s in ours] == [sorted(s) for s in union]


def test_tr_ksi(build_work):
    """ktools ksi over the (byte-identical) pan.tr.kmers; with a single
    locus the reference emits no boundary rows, and so do we."""
    from danbing_tk_tpu.apps.ktools import ksi

    ours = ksi(str(build_work / "pan.tr.kmers"))
    with open(os.path.join(GOLD, "pan.tr.ksi")) as f:
        gold = [int(x) for x in f.read().split()]
    assert ours == gold
