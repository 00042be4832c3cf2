"""End-to-end eqtl pipeline oracle: the reference script/eqtl.noPerm.py
is EXECUTED on a synthetic GTEx-shaped fixture (statsmodels shimmed) and
our `danbing_tk_tpu eqtl` driver must write byte-identical
{tissue}.v8.egenes.txt files."""

import glob
import gzip
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

REF_SCRIPT = "/root/reference/script/eqtl.noPerm.py"
STUBS = os.path.join(os.path.dirname(__file__), "stubs")

# enough samples that the 13-column covariate projection (3 GTEx PCs +
# 10 SNP PCs) stays full-rank, as in real GTEx (838 samples)
SAMPLES = [f"{a}{b}16" for a in "ABCDEFGH" for b in "ABCDEF"]
TISSUES = ["Adipose_Test", "Brain_Test"]
NLOCI, NGENE, NCTRL = 10, 12, 6
NL1, NL2 = 7, 9


def _make_fixture(root):
    rng = np.random.default_rng(42)
    os.makedirs(f"{root}/gen")
    os.makedirs(f"{root}/exp")
    os.makedirs(f"{root}/cov")

    # TR bed + gene bed + cis pairs
    tr_rows = [(f"chr{1 + i % 3}", 1000 * i + 37, 1000 * i + 400 + 13 * i)
               for i in range(NLOCI)]
    with open(f"{root}/tr.bed", "w") as f:
        for c, s, e in tr_rows:
            f.write(f"{c}\t{s}\t{e}\n")
    genes = [f"ENSG{i:08d}.{1 + i % 4}" for i in range(NGENE)]
    with open(f"{root}/genes.bed", "w") as f:
        for i, g in enumerate(genes):
            f.write(f"chr{1 + i % 3}\t{2000 * i}\t{2000 * i + 900}\t{g}\t"
                    f"GENE{i}\n")
    # pairs: each TR tests 1-3 genes; one gene appears for many TRs
    # (Bonferroni > 1), one pair names a gene absent from the tissues
    pairs = []
    for li in range(NLOCI):
        cand = sorted(rng.choice(NGENE, size=int(rng.integers(1, 4)),
                                 replace=False).tolist())
        for gi in cand:
            pairs.append((li, gi))
        pairs.append((li, 3))                    # hot gene: many TRs
    with open(f"{root}/pairs.bed", "w") as f:
        for li, gi in pairs:
            c, s, e = tr_rows[li]
            f.write(f"chrG\t{500 * gi}\t{500 * gi + 100}\t{genes[gi]}\t."
                    f"\t{c}\t{s}\t{e}\n")
        # gene absent from the expression beds
        c, s, e = tr_rows[0]
        f.write(f"chrG\t0\t1\tENSG99999999.9\t.\t{c}\t{s}\t{e}\n")

    # genomes / phenotype / ctrl coverage
    with open(f"{root}/genomes.txt", "w") as f:
        f.write("\n".join(SAMPLES) + "\n")
    with open(f"{root}/phenos.txt", "w") as f:
        f.write("SUBJID\tSEX\tAGE\n")
        for i, s in enumerate(SAMPLES):
            f.write(f"GTEX-{s}\t{1 + i % 2}\t55\n")
    ctrl = [(f"chr{1 + i % 2}", 100 * i, 100 * i + 80 + 10 * i)
            for i in range(NCTRL)]
    with open(f"{root}/ctrl.bed", "w") as f:
        for c, s, e in ctrl:
            f.write(f"{c}\t{s}\t{e}\n")
    # realistic coverage: per-sample depth x small per-locus wobble, so
    # normalized per-locus stds sit under the 0.1 rejection threshold —
    # except the two deliberately bad ctrl loci
    depth = rng.uniform(25, 35, len(SAMPLES))
    cov = depth[:, None] * (1 + rng.normal(0, 0.02, (len(SAMPLES), NCTRL)))
    # high-variance ctrl locus: enough wobble to fail the 0.1 std
    # threshold without dragging the per-sample global normalizer (and
    # with it every other locus's normalized std) along
    cov[:, 4] *= rng.uniform(0.7, 1.4, len(SAMPLES))
    cov[:, 5] *= 1.8                                   # biased-mean ctrl
    with open(f"{root}/ctrl.cov", "w") as f:
        for i, s in enumerate(SAMPLES):
            vals = "\t".join(f"{v:.4f}" for v in cov[i])
            f.write(f"{s}\t.\t{vals}\n")

    # per-sample genotypes (.tr.kmers); locus 6 is constant across
    # samples -> zero-variance z-score -> the non-finite skip path
    dose = rng.uniform(20, 120, (NLOCI, len(SAMPLES)))
    dose[6] = 77.0
    for si, s in enumerate(SAMPLES):
        with open(f"{root}/gen/{s}.tr.kmers", "w") as f:
            for li in range(NLOCI):
                f.write(f">{li}\n")
                total = int(dose[li, si])
                f.write(f"{li * 7 + 1}\t{total // 2}\n")
                f.write(f"{li * 7 + 2}\t{total - total // 2}\n")

    # SNP PCs (all samples) + per-tissue expression/covariates.
    with open(f"{root}/snp.evec", "w") as f:
        for s in SAMPLES:
            pcs = "\t".join(f"{v:.5f}" for v in rng.normal(0, 1, 10))
            f.write(f"V-{s}\t{pcs}\tignored\n")

    # effective dosage as the reference will see it: genotype columns in
    # glob order, indexed positionally by the genomes list
    files = glob.glob(f"{root}/gen/*.tr.kmers")
    eff = np.zeros((NLOCI, len(SAMPLES)))
    for fi, fn in enumerate(files):
        s = os.path.basename(fn).split(".")[0]
        # the file's dosage as written (integer-truncated)
        eff[:, fi] = np.floor(dose[:, SAMPLES.index(s)]).astype(int)
    # effective matrix: column i is treated as genomes[i] downstream

    for t in TISSUES:
        sub = list(SAMPLES)
        rng.shuffle(sub)
        sub = sub[: len(SAMPLES) - 1]            # drop one sample
        expr = rng.normal(0, 1, (NGENE, len(sub)))
        # plant strong associations on the EFFECTIVE dosage rows
        eff_cols = [SAMPLES.index(s) for s in sub]
        # strong plants: the reference's (1-P) projection quirk (see
        # analysis/eqtl_pipeline.py) only passes the covariate-space
        # component of the signal through, so effects must be large
        expr[1] += 0.5 * eff[2][eff_cols]
        expr[5] -= 0.6 * eff[8][eff_cols]
        expr[3] += 0.4 * eff[0][eff_cols]
        hdr = "#chr\tstart\tend\tgene_id\t" + "\t".join(
            f"GTEX-{s}" for s in sub)
        with gzip.open(f"{root}/exp/{t}.v8.normalized_expression.bed.gz",
                       "wt") as f:
            f.write(hdr + "\n")
            for gi, g in enumerate(genes):
                vals = "\t".join(f"{v:.6f}" for v in expr[gi])
                f.write(f"chr{1 + gi % 3}\t{2000 * gi}\t{2000 * gi + 900}"
                        f"\t{g}\t{vals}\n")
        # the reference residualizer is (1-P) with SCALAR 1 (its :96
        # quirk), i.e. the tested expression is the NEGATED projection
        # onto covariate space — a signal orthogonal to the covariates
        # cannot reach significance.  Give the covariates a component
        # along the planted dosage rows (population-structure-like), so
        # the projection carries the planted associations through.
        covs = np.vstack([
            eff[2][eff_cols] / 40 + rng.normal(0, 0.1, len(sub)),
            eff[8][eff_cols] / 40 + rng.normal(0, 0.1, len(sub)),
            eff[0][eff_cols] / 40 + rng.normal(0, 0.1, len(sub)),
        ])
        with open(f"{root}/cov/{t}.v8.covariates.txt", "w") as f:
            f.write("ID\t" + "\t".join(f"GTEX-{s}" for s in sub) + "\n")
            for ci in range(3):
                vals = "\t".join(f"{v:.5f}" for v in covs[ci])
                f.write(f"PC{ci + 1}\t{vals}\n")
    with open(f"{root}/tissues.txt", "w") as f:
        f.write("\n".join(TISSUES) + "\n")


def _args(root, outdir):
    return [
        "--TRbed", f"{root}/tr.bed", "--geneBed", f"{root}/genes.bed",
        "--pair", f"{root}/pairs.bed", "--expDir", f"{root}/exp",
        "--genDir", f"{root}/gen", "--covDir", f"{root}/cov",
        "--outDir", outdir, "--phenotype", f"{root}/phenos.txt",
        "--genomes", f"{root}/genomes.txt",
        "--tissues", f"{root}/tissues.txt",
        "--NL1", str(NL1), "--NL2", str(NL2),
        "--SNPPC", f"{root}/snp.evec", "--ctrlbed", f"{root}/ctrl.bed",
    ]


@pytest.mark.skipif(not os.path.exists(REF_SCRIPT),
                    reason="reference checkout absent")
def test_eqtl_pipeline_vs_executed_reference(tmp_path):
    root = str(tmp_path / "fix")
    os.makedirs(root)
    _make_fixture(root)

    ref_out = str(tmp_path / "ref_out")
    our_out = str(tmp_path / "our_out")
    os.makedirs(ref_out)
    os.makedirs(our_out)
    shutil.copy(f"{root}/ctrl.cov", f"{ref_out}/ctrl.cov")
    shutil.copy(f"{root}/ctrl.cov", f"{our_out}/ctrl.cov")

    env = dict(os.environ,
               PYTHONPATH=STUBS + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""),
               MPLBACKEND="Agg")
    r = subprocess.run(
        [sys.executable, REF_SCRIPT] + _args(root, ref_out),
        env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]

    from danbing_tk_tpu.analysis.eqtl_pipeline import run_eqtl

    ns = types.SimpleNamespace(
        TRbed=f"{root}/tr.bed", geneBed=f"{root}/genes.bed",
        pair=f"{root}/pairs.bed", expDir=f"{root}/exp", resDir=None,
        genDir=f"{root}/gen", covDir=f"{root}/cov", outDir=our_out,
        phenotype=f"{root}/phenos.txt", genomes=f"{root}/genomes.txt",
        tissues=f"{root}/tissues.txt", genMat=None, NL1=NL1, NL2=NL2,
        SNPPC=f"{root}/snp.evec", ctrlbed=f"{root}/ctrl.bed")
    written = run_eqtl(ns)
    assert len(written) == len(TISSUES)

    n_egenes = 0
    for t in TISSUES:
        ref_f = f"{ref_out}/{t}.v8.egenes.txt"
        our_f = f"{our_out}/{t}.v8.egenes.txt"
        assert os.path.exists(ref_f)
        ref_bytes = open(ref_f, "rb").read()
        assert open(our_f, "rb").read() == ref_bytes, t
        n_egenes += len(ref_bytes.splitlines()) - 1
    assert n_egenes > 0, "no eGenes called — fixture has no teeth"
