#!/usr/bin/env python
"""Second-oracle goldens for the BUILD pipeline.

Runs the reference's JointTRAnnotation -> GenPanGenomeGraph ->
GenSerializedGraphAndIndex flow (GoodPanGenomeGraph.snakefile:156-391,
pruning=false per test/goodPanGenomeGraph.json) over the reference's OWN
bundled test assemblies (test/input/: HG00514 + HG00733 regional contigs
around a real chr12 VNTR), executing the reference Python scripts
(multiBoundaryExpansion.parallel.py, mergeMBEbed.py, SelectRegions.py)
and binaries (fa2kmers, genPanKmers, ktools) — never copying source.

Shared glue both oracles consume identically (documented deviations):
  * tmp1.{h}.bed from kmer_lift_tmp1 (the real pipeline's minimap2
    liftover isn't runnable here; the derived beds are inputs to both)
  * v0 support counts via bedops.bed_map_count (bedtools absent)
  * mbe.m0.loci via bedops.collision_scan (bedtools merge absent)
  * per-genome .tre.kmers via build.make_tre_kmers_mapped (HEAD fa2kmers
    emits tr/fl/graph only; the pipeline derives TR-edge kmers the same
    way on both sides)

Everything lands in tests/golden_build/ for tests/test_build_oracle.py.
Config follows test/goodPanGenomeGraph.json: k=21 FS=500 TRWINDOW=100000
dist_merge=dist_scan=500 MBE th1=th2=0.31.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from danbing_tk_tpu.pipeline.build import kmer_lift_tmp1, \
    make_tre_kmers_mapped
from danbing_tk_tpu.apps.genpankmers import read_ortho_map
from danbing_tk_tpu.utils.bedops import (bed_map_count, collision_scan,
                                         write_m0_loci)

REFBIN = os.environ.get("DTK_REF_BIN", "/tmp/refbuild/bin")
REFSCRIPT = "/root/reference/script"
INDIR = "/root/reference/test/input"
OUT = os.path.join(os.path.dirname(__file__), "..", "tests",
                   "golden_build")
GS = ["HG00514", "HG00733"]
KSIZE, FS, TRWINDOW, DMERGE = 21, 500, 100000, 500
TH1 = TH2 = 0.31


def run(cmd, **kw):
    print("+", " ".join(map(str, cmd)), file=sys.stderr)
    subprocess.run([str(c) for c in cmd], check=True, **kw)


def main():
    if os.path.exists(OUT):
        shutil.rmtree(OUT)
    os.makedirs(OUT)
    ref_fa = os.path.join(INDIR, "hg38.chr12.2155791.2356090.fasta")
    ref_tr = os.path.join(INDIR, "tr.bed")

    # --- tmp1 beds + v0 support counts (shared glue) ---
    ref_rows = [line.split()[:3] for line in open(ref_tr)]
    cols = []
    for g in GS:
        os.makedirs(os.path.join(OUT, g))
        for h in (0, 1):
            rows = kmer_lift_tmp1(ref_fa, ref_tr,
                                  os.path.join(INDIR, f"{g}.{h}.fa"),
                                  KSIZE)
            with open(os.path.join(OUT, g, f"tmp1.{h}.bed"), "w") as f:
                for r in rows:
                    f.write("\t".join(str(x) for x in r) + "\n")
            b = [(str(r[3]), str(r[4]), str(r[5]))
                 for r in rows if r[0] != "."]
            cols.append(bed_map_count(ref_rows, b))
    with open(os.path.join(OUT, "pan.tr.mbe.v0.bed"), "w") as f:
        for i, row in enumerate(ref_rows):
            f.write("\t".join(list(row) + [str(c[i]) for c in cols])
                    + "\n")
    with open(os.path.join(OUT, "genomes.txt"), "w") as f:
        f.write("\n".join(GS) + "\n")

    # --- MBE + collision scan + merge (reference scripts) ---
    os.makedirs("/tmp/pyshims/statsmodels", exist_ok=True)
    for fn in ("__init__.py", "api.py"):
        with open(f"/tmp/pyshims/statsmodels/{fn}", "w") as f:
            f.write("# stub\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REFSCRIPT + os.pathsep + "/tmp/pyshims"
    os.makedirs(os.path.join(OUT, "MBE"), exist_ok=True)
    run([sys.executable, f"{REFSCRIPT}/multiBoundaryExpansion.parallel.py",
         KSIZE, FS, TRWINDOW, "genomes.txt", "pan.tr.mbe.v0.bed",
         TH1, TH2, 2, INDIR, "--ignore-case"], cwd=OUT, env=env)
    shutil.rmtree(os.path.join(OUT, "MBE"))

    nh = 2 * len(GS)
    v1_rows = [line.split("\t") for line in
               open(os.path.join(OUT, "pan.tr.mbe.v1.bed"))
               .read().splitlines()]
    groups = collision_scan(v1_rows, nh, DMERGE)
    write_m0_loci(os.path.join(OUT, "mbe.m0.loci"), GS, groups)
    run([sys.executable, f"{REFSCRIPT}/mergeMBEbed.py", "genomes.txt",
         TH2], cwd=OUT, env=env)

    # --- trfa (reference SelectRegions.py over the awk'd v2 bed) ---
    os.makedirs(os.path.join(OUT, "trfa"), exist_ok=True)
    v2 = [line.split("\t") for line in
          open(os.path.join(OUT, "pan.tr.mbe.v2.bed")).read().splitlines()]
    hi = 0
    for g in GS:
        for h in (0, 1):
            bed = os.path.join(OUT, "trfa", f"{g}.{h}.bed")
            with open(bed, "w") as f:
                for c in v2:
                    ctg, s, e = c[3 + 4 * hi:6 + 4 * hi]
                    if ctg == "None":
                        continue
                    f.write(f"{ctg}\t{int(s) - FS}\t{int(e) + FS}\n")
            with open(os.path.join(OUT, "trfa",
                                   f"{g}.{h}.tr.fasta"), "w") as fout:
                run([sys.executable, f"{REFSCRIPT}/SelectRegions.py", bed,
                     os.path.join(INDIR, f"{g}.{h}.fa"), "/dev/stdout"],
                    cwd=OUT, env=env, stdout=fout)
            hi += 1

    # --- per-genome graphs (reference fa2kmers) + shared tre glue ---
    omap_path = os.path.join(OUT, "OrthoMap.v2.tsv")
    omap = read_ortho_map(omap_path, nh)
    nloci = len(omap)
    for gi, g in enumerate(GS):
        gmap_file = os.path.join(OUT, f"{g}.map.tsv")
        with open(omap_path) as f, open(gmap_file, "w") as out:
            for line in f:
                c = line.rstrip("\n").split("\t")
                out.write(f"{c[2 * gi]}\t{c[2 * gi + 1]}\n")
        fas = [os.path.join(OUT, "trfa", f"{g}.{h}.tr.fasta")
               for h in (0, 1)]
        run([f"{REFBIN}/fa2kmers", "-g", "-m", gmap_file, "-k", KSIZE,
             "-fsi", FS, "-fso", FS, "-on", os.path.join(OUT, f"{g}.rawPB"),
             "-fa", 2] + fas, cwd=OUT)
        gmap = [[omap[li][2 * gi + h] for h in (0, 1)]
                for li in range(nloci)]
        make_tre_kmers_mapped(os.path.join(OUT, f"{g}.rawPB"), fas, gmap,
                              nloci, KSIZE, FS)

    # --- pan merge + serialize + ksi (reference binaries) ---
    run([f"{REFBIN}/genPanKmers", "-o", os.path.join(OUT, "pan"), "-m",
         "-", "-k"] + [os.path.join(OUT, f"{g}.rawPB") for g in GS])
    run([f"{REFBIN}/ktools", "serialize", os.path.join(OUT, "pan")])
    with open(os.path.join(OUT, "pan.tr.ksi"), "w") as f:
        run([f"{REFBIN}/ktools", "ksi",
             os.path.join(OUT, "pan.tr.kmers")], stdout=f)

    print("golden_build frozen:", sorted(os.listdir(OUT)), file=sys.stderr)


if __name__ == "__main__":
    main()
