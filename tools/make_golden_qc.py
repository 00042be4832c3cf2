#!/usr/bin/env python
"""Second-oracle golden generator.

Round 1's goldens were all authored by tools/make_golden.py from
synthetic data.  This freezes a second, builder-independent oracle from
the reference's OWN bundled fixtures (test/QC/input/: a mini pan RPGG +
HG002/hs1 genome fragments) by executing the reference binaries
(default /tmp/refbuild/bin) over the full QC loop
(test/QC/fn1a.sim.sh .. fn2a3.bait.map.sh):

  ktools serialize   on the bundled text RPGG -> pan.kmers.dbi etc.
                     (pan.fl.kmers = bundled pan.ntr.kmers; pan.tre.kmers
                     derived from pan.graph.kmers edge masks — both
                     oracles consume the identical derived file)
  sim_reads          -pe -no-err -c 15 -ml 500 -bed -split per haplotype
  annotate           shared Python glue (pipeline/qc.py), NOT a binary
  danbing-tk -e 1    extract
  danbing-tk -s 2    raw map -> kam + genotype outputs
  baitBuilder v1.pf  TP/FP profiles
  baitBuilder v2     FPSkmer.v0.tsv
  ktools serialize-bt -> pan.bt.kmdb
  danbing-tk -b      bait map

Everything lands in tests/golden_qc/ for tests/test_qc_oracle.py.
Reference binaries are ONLY executed, never copied.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
from danbing_tk_tpu.ops import kmers_np as K
from danbing_tk_tpu.pipeline.qc import (annotate_reads, derive_tr_bed,
                                        sanitize)

REFBIN = os.environ.get("DTK_REF_BIN", "/tmp/refbuild/bin")
REFQC = os.environ.get("DTK_REF_QC", "/root/reference/test/QC/input")
OUT = os.path.join(os.path.dirname(__file__), "..", "tests", "golden_qc")
KSIZE = 21
GENOMES = ["HG002", "hs1"]
REF_GENOME = "hs1"


def run(cmd, **kw):
    print("+", " ".join(map(str, cmd)), file=sys.stderr)
    subprocess.run([str(c) for c in cmd], check=True, **kw)


def derive_tre(graph_kmers: str, out_path: str):
    """pan.graph.kmers stores per-locus {kmer: 4-bit out-edge mask}; each
    set bit is a TR-region (k+1)-mer edge kmer<<2|nt (canonicalized)."""
    with open(graph_kmers) as f, open(out_path, "w") as out:
        edges: set[int] = set()

        def flush():
            for e in sorted(edges):
                out.write(f"{e}\n")
            edges.clear()

        first = True
        for line in f:
            if line[0] == ">":
                if not first:
                    flush()
                first = False
                out.write(line)
            else:
                km_s, mask_s = line.split()
                km, mask = int(km_s), int(mask_s)
                for nt in range(4):
                    if (mask >> nt) & 1:
                        e = ((km << 2) | nt) & ((1 << (2 * KSIZE + 2)) - 1)
                        rc = int(K.revcomp_kmers(
                            np.array([e], dtype=np.uint64), KSIZE + 1)[0])
                        edges.add(min(e, rc))
        flush()


def contig_names(fasta: str):
    with open(fasta) as f:
        return [line[1:].split()[0] for line in f if line[0] == ">"]


def main():
    os.makedirs(OUT, exist_ok=True)
    pan = os.path.join(OUT, "pan")

    # --- index: bundled text -> HEAD serialized formats ---
    shutil.copy(os.path.join(REFQC, "pan.tr.kmers"), pan + ".tr.kmers")
    shutil.copy(os.path.join(REFQC, "pan.ntr.kmers"), pan + ".fl.kmers")
    shutil.copy(os.path.join(REFQC, "pan.graph.kmers"),
                pan + ".graph.kmers")
    derive_tre(pan + ".graph.kmers", pan + ".tre.kmers")
    run([f"{REFBIN}/ktools", "serialize", pan])

    # --- per-haplotype read sim + annotation ---
    nloci = sum(1 for line in open(pan + ".tr.kmers") if line[0] == ">")
    for g in GENOMES:
        annot_fa = os.path.join(OUT, f"{g}.annot.fa")
        with open(annot_fa, "w") as out:
            for h in (0, 1):
                fa = os.path.join(REFQC, f"{g}.{h}.fa")
                pref = os.path.join(OUT, f"{g}.{h}.reads")
                run([f"{REFBIN}/sim_reads", "-pe", "-no-err", "-c", 15,
                     "-ml", 500, "-bed", "-split", "-o", pref, "-i", fa])
                beds = []
                for ctg in contig_names(fa):
                    src = f"{pref}.{ctg}.reads.bed"
                    if os.path.exists(src):
                        # ':' in fragment names breaks downstream globs;
                        # keep sanitized file names in the golden tree
                        dst = f"{pref}.{sanitize(ctg)}.reads.bed"
                        if src != dst:
                            os.replace(src, dst)
                        beds.append(dst)
                annotate_reads(beds,
                               derive_tr_bed(pan + ".tr.kmers", fa),
                               out)

    # --- extract + raw map (reference align) ---
    for g in GENOMES:
        with open(os.path.join(OUT, f"{g}.extract.fa"), "w") as f:
            run([f"{REFBIN}/danbing-tk", "-cth", 5, "-e", 1, "-qs", pan,
                 "-fa", os.path.join(OUT, f"{g}.annot.fa")], stdout=f)
        with open(os.path.join(OUT, f"{g}.raw.kam"), "w") as f:
            run([f"{REFBIN}/danbing-tk", "-cth", 10, "-c", 40, "-s", 2,
                 "-qs", pan, "-fa", os.path.join(OUT, f"{g}.extract.fa"),
                 "-o", os.path.join(OUT, f"{g}.raw")], stdout=f)

    # --- profiles + FPSkmer + bait serialization ---
    for g in GENOMES:
        run([f"{REFBIN}/baitBuilder", "v1.pf",
             os.path.join(OUT, f"{g}.raw.kam"), nloci, KSIZE,
             os.path.join(OUT, f"profile.{g}"), "-tp"])
    run([f"{REFBIN}/baitBuilder", "v1.pf",
         os.path.join(OUT, f"{REF_GENOME}.raw.kam"), nloci, KSIZE,
         os.path.join(OUT, f"map.{REF_GENOME}")])
    fps = os.path.join(OUT, "FPSkmer.v0.tsv")
    run([f"{REFBIN}/baitBuilder", "v2", nloci, KSIZE, fps,
         os.path.join(OUT, f"map.{REF_GENOME}.FP_pf.txt"),
         os.path.join(OUT, f"map.{REF_GENOME}.TP_pf.txt")]
        + [os.path.join(OUT, f"profile.{g}.TP_pf.txt") for g in GENOMES])
    run([f"{REFBIN}/ktools", "serialize-bt", fps, nloci, pan])

    # --- bait map ---
    for g in GENOMES:
        with open(os.path.join(OUT, f"{g}.bait.kam"), "w") as f:
            run([f"{REFBIN}/danbing-tk", "-b", "-cth", 10, "-c", 40,
                 "-s", 2, "-qs", pan,
                 "-fa", os.path.join(OUT, f"{g}.extract.fa"),
                 "-o", os.path.join(OUT, f"{g}.bait")], stdout=f)

    print("golden_qc frozen:", sorted(os.listdir(OUT)), file=sys.stderr)


if __name__ == "__main__":
    main()
