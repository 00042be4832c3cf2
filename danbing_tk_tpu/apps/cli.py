"""Command-line interface (L4): `python -m danbing_tk_tpu <cmd> ...`

Mirrors the reference binaries' CLIs (danbing-tk align, fa2kmers,
genPanKmers, ktools, danbing-tk-pred, baitBuilder, sim_reads, bam2pe,
mapkmers) plus the build/call pipelines.
"""

from __future__ import annotations

import argparse
import os
import sys


def _require_device() -> None:
    """--device runs the device engine on an accelerator.  JAX falls back
    to its CPU backend silently when it finds none; refuse that unless
    JAX_PLATFORMS names cpu explicitly (as the test suite does)."""
    import jax

    devs = jax.devices()
    named = {p.strip() for p in
             os.environ.get("JAX_PLATFORMS", "").split(",")}
    if devs[0].platform == "cpu" and "cpu" not in named:
        raise SystemExit(
            "--device: JAX found no accelerator (backend: cpu); set "
            "JAX_PLATFORMS=cpu to run the device engine on the CPU")
    print(f"device engine: platform={devs[0].platform} "
          f"kind={devs[0].device_kind} count={len(devs)}",
          file=sys.stderr)


def _cmd_align(args):
    from ..engine.host_align import AlignConfig, HostAligner, RPGG

    cfg = AlignConfig(
        ksize=args.k, cth=args.cth, n_filter=args.kf[0],
        nm_filter=args.kf[1], nm_tr=args.c, okam=not args.ka,
        bait=args.b, qc=bool(args.qc), simmode=args.s,
        output_bubbles=args.bu, is_fastq=args.fq is not None,
        threading=bool(args.gc or args.g), aln=args.a or args.ae,
        aln_minimal=args.ae,
        thread_cth=(args.gc or args.g or [100])[0],
        maxncorrection=(args.gc[1] if args.gc and len(args.gc) > 1 else 4),
        correction=bool(args.gc),
        extract=args.e,
        track_bait=args.tb,
        qth=args.qth,
        reads_per_batch=int(300000 * args.r),
    )
    rpgg = RPGG(args.qs, bait=args.b, qc_file=args.qc, trim=args.t)
    if args.device:
        from ..engine.align_runner import DeviceAlignRunner
        from ..utils.compile_cache import enable_compile_cache

        _require_device()
        enable_compile_cache()
        al = DeviceAlignRunner(rpgg, cfg, expand_cap=args.expand_cap,
                               retry_expand=args.retry_expand)
    else:
        al = HostAligner(rpgg, cfg)
    # bind streaming sinks for row side-outputs so .kam-scale runs are
    # O(1) host memory (rows stream in append order; byte-identical)
    from ..io.rowsink import RowSink

    pref = args.o or args.on
    if cfg.extract:
        al.extract_rows = RowSink(fh=sys.stdout)
    else:
        if cfg.okam and not cfg.threading:
            # crash-resume: keep the partial .kam (the checkpoint loader
            # truncates it back to the saved high-water mark)
            resuming = bool(args.checkpoint
                            and os.path.exists(args.checkpoint))
            al.kam_rows = RowSink(pref + ".kam", append=resuming)
        if cfg.aln:
            al.aln_rows = RowSink(pref + ".aln")
    if args.native_io or args.prefilter:
        assert args.device, "--native-io/--prefilter need --device"
        al.run_file_native(args.fa or args.fq, checkpoint=args.checkpoint,
                           checkpoint_every=args.checkpoint_every,
                           prefilter=args.prefilter)
    elif args.checkpoint:
        assert args.device, "--checkpoint needs --device"
        al.run_file(args.fa or args.fq, checkpoint=args.checkpoint)
    else:
        al.run_file(args.fa or args.fq)
    if cfg.extract:
        al.write_extract(sys.stdout)
        return
    if args.on:
        al.write_tr_kmers(pref + ".tr.kmers")
    else:
        al.write_trkmc_ar(pref + ".trkmc.ar")
        if not cfg.threading:
            al.write_summary(pref + ".tr.summary.txt")
    if cfg.okam and not cfg.threading:
        al.write_kam(pref + ".kam")
    if cfg.track_bait:
        al.write_btk(pref + ".btk.kmdb")
    if cfg.aln:
        al.write_aln(pref + ".aln")
    if cfg.output_bubbles:
        al.write_bubbles(pref + ".bub.kmdb")
    if args.device:
        print(f"referee pairs (host-oracle fallback): {al.n_referee}",
              file=sys.stderr)
    print(f"align done -> {pref}", file=sys.stderr)


def _cmd_warmup(args):
    """Precompile the device align programs for a (P, E, mode) shape set
    into the persistent compile cache, ahead of any production run.

    Each new (P, E, mode) shape pays its compile inside the run.
    `warmup` runs the same make_step / make_prefilter builders the
    runner uses and executes each program once on an empty batch, so
    the compiled binary lands in the persistent compile cache
    (utils/compile_cache.py); production launches and crash-resumes
    with the same shapes then load it in seconds.  Run once per device
    type/backend — e.g. in the deploy-image build — with the flags the
    production run will use."""
    import time

    import numpy as np

    from ..engine import device_align as da
    from ..engine.align_runner import DeviceAlignRunner
    from ..engine.host_align import AlignConfig, RPGG
    from ..utils.compile_cache import enable_compile_cache

    _require_device()
    cache = enable_compile_cache()
    if not args.ka:
        # okam (the default, like align without -ka) drives with_annot
        # through make_step, which is a DIFFERENT traced program from the
        # -ka counting step — warming one does not warm the other, and
        # the primary-step compile is the expensive one.  Say so loudly
        # instead of silently caching a program the -ka production run
        # never loads.
        print("warmup: warming the okam (.kam output, annotated) step "
              "variant; a -ka counting run compiles a different program "
              "— pass -ka here to warm that one", file=sys.stderr)
    cfg = AlignConfig(
        ksize=args.k, cth=args.cth, n_filter=args.kf[0],
        nm_filter=args.kf[1], nm_tr=args.c, okam=not args.ka,
        bait=args.b, qc=bool(args.qc), output_bubbles=args.bu,
        is_fastq=bool(args.fq), qth=args.qth)
    rpgg = RPGG(args.qs, bait=args.b, qc_file=args.qc, trim=args.t)
    t0 = time.time()
    al = DeviceAlignRunner(rpgg, cfg, batch_pairs=args.P,
                           max_read_len=args.L,
                           expand_cap=args.expand_cap,
                           retry_expand=args.retry_expand)
    print(f"warmup: index + tables ready in {time.time()-t0:.1f}s "
          f"(cache={cache})", file=sys.stderr)
    import jax

    P, L = al.P, al.L

    def empty_batch(Pb):
        return (np.full((2 * Pb, L), 255, dtype=np.uint8),
                np.zeros(2 * Pb, dtype=np.int32),
                np.ones(Pb, dtype=bool))

    def compile_step(name, fn, Pb):
        codes, rlen, live = empty_batch(Pb)
        fargs = [al.state, codes, rlen, live]
        if al.with_qual:
            fargs.append(da.qmask_batch(
                np.zeros((2 * Pb, L), np.uint8), rlen, cfg.qth,
                cfg.ksize))
        t0 = time.time()
        # state is donated to the jitted step: rebind the returned one
        al.state, out = fn(*fargs)
        jax.block_until_ready((al.state, out))
        print(f"warmup: {name} compiled+cached in {time.time()-t0:.1f}s",
              file=sys.stderr)

    compile_step(f"align step P={P} E={al.expand_cap}", al.step, P)
    for t, E in enumerate(al.retry_E):
        Pt = al.retry_P[t]
        if al.retry_steps[t] is None:
            # mirror run_file_native's flush_retry: okam tiers carry the
            # annotation plane for .kam rows
            al.retry_steps[t] = al._build_step(
                E, with_annot=cfg.okam, with_qual=al.with_qual, P=Pt)
        compile_step(f"retry tier step P={Pt} E={E}",
                     al.retry_steps[t], Pt)
    if args.prefilter:
        Pp = P * int(os.environ.get("DTK_PREFILTER_MULT", "4"))
        pre = al._build_prefilter(Pp)
        codes, rlen, live = empty_batch(Pp)
        t0 = time.time()
        jax.block_until_ready(pre(codes, rlen, live))
        print(f"warmup: prefilter P={Pp} compiled+cached in "
              f"{time.time()-t0:.1f}s", file=sys.stderr)
    print(f"warmup done -> {cache}", file=sys.stderr)


def _cmd_build(args):
    from ..pipeline.build import build_rpgg

    gs = [line.split()[0] for line in open(args.genomes)]
    if args.paf:
        from ..pipeline.liftover import lift_tr

        for kv in args.paf:
            g, paths = kv.split("=", 1)
            lift_tr(paths.split(","), args.refTR,
                    os.path.join(args.workdir, g),
                    min_len=args.lift_min_len)
    prune_reads = dict(kv.split("=", 1) for kv in args.prune_reads or [])
    pan = build_rpgg(args.workdir, args.indir, gs, args.refTR, ksize=args.k,
                     FS=args.fs, TRWINDOW=args.trwindow,
                     dist_merge=args.dist_merge, nproc=args.p,
                     prune_reads=prune_reads or None, cth=args.cth,
                     thcth=args.thcth, use_device=args.device)
    print(pan)


def _cmd_build_ref(args):
    from ..pipeline.ref_graph import build_ref_rpgg

    pref = build_ref_rpgg(args.workdir, args.ref_fa, args.refTR, g=args.g,
                          ksize=args.k, FS=args.fs,
                          TRWINDOW=args.trwindow,
                          dist_merge=args.dist_merge, nproc=args.p)
    print(pref)


def _cmd_qc(args):
    from ..pipeline.qc import run_qc_harness

    produced = run_qc_harness(
        args.indir, args.workdir, args.genomes.split(","), args.ref_genome,
        ksize=args.k, cov=args.cov, min_ctg=args.min_ctg,
        extract_cth=args.extract_cth, map_cth=args.map_cth,
        use_device=args.device)
    for name in sorted(produced):
        print(name, "->", produced[name])


def _cmd_serialize(args):
    from ..index.dbi import serialize

    serialize(args.pref)


def _cmd_fa2kmers(args):
    from ..apps.fa2kmers import fa2kmers, make_tre_kmers

    fa2kmers(args.o, args.fa, k=args.k, fsi=args.fsi, fso=args.fso,
             gen_graph=args.g, tr_only=args.tr, threshold=args.th,
             prune_file=args.p)
    if args.tre:
        make_tre_kmers(args.o, args.fa, args.k, args.fsi)


def _cmd_genpankmers(args):
    from ..apps.genpankmers import gen_pan_kmers

    gen_pan_kmers(args.o, args.k,
                  ortho_map=None if args.m == "-" else args.m,
                  tr_only=args.tr, tre_only=args.tre)


def _cmd_pred(args):
    from ..analysis.pred import run_pred

    run_pred(args.gt_meta, args.ikmer_meta, args.out_raw, args.out,
             args.out_bias, use_jax=args.jax)


def _cmd_bait(args):
    from ..apps.baitbuilder import build_profiles, enrichment_filter

    if args.mode == "v1.pf":
        build_profiles(args.kam, args.nloci, args.k, args.out,
                       tp_only=args.tp)
    else:
        enrichment_filter(args.nloci, args.k, args.out, args.fp_pf,
                          args.tp_pfs)


def _cmd_simreads(args):
    from ..apps.sim_reads import sim_reads

    sim_reads(args.i, sys.stdout, cov=args.c, flen=args.fs, rlen=args.rlen,
              min_ctg_len=args.ml, uni=args.uni, bed=args.bed,
              seed=args.seed, out_pref=args.o, split=args.split)


def _cmd_bam2pe(args):
    from ..apps.bam2pe import bam2pe

    with open(args.fai) as f:
        bam2pe(f, sys.stdout)


def _cmd_call(args):
    import pickle

    from ..analysis.rarevariant import build_metadata, call_rare_variants

    qcf, trks, ntrks = build_metadata(args.pref)
    out = call_rare_variants(
        qcf, trks, ntrks, args.tr_kmers, args.tr_index, args.bub,
        args.br_svm, args.bp_svm, len(trks), th=args.th,
        graph_size_limit=args.graph_size_limit)
    with open(args.out, "wb") as f:
        pickle.dump(out, f)
    print(f"{sum(len(v[0]) for v in out.values())} edges in callset",
          file=sys.stderr)


def _cmd_length(args):
    from ..analysis.length_pipeline import run_length

    bad = tuple(int(x) for x in args.bad_donors.split(",") if x)
    run_length(args.outdir, args.ksize, args.kmers, args.trbed,
               args.LSB, args.cov, ksi_path=args.ksi, qs=args.qs,
               seqruns=args.seqruns, db_seqruns=args.db_seqruns,
               bad_donors=bad)
    print(f"length done -> {args.outdir}/estimated_TR_len.tsv",
          file=sys.stderr)


def _cmd_eqtl(args):
    from ..analysis.eqtl_pipeline import run_eqtl

    for path in run_eqtl(args):
        print(path, file=sys.stderr)


def _cmd_bench(args):
    import runpy

    runpy.run_path("bench.py", run_name="__main__")


def _cmd_ktools(args):
    from ..apps import ktools as kt
    from ..index.dbi import serialize as dbi_serialize

    a = args.args
    if args.sub == "ksi":
        for v in kt.ksi(a[0]):
            print(v)
    elif args.sub == "sum":
        if a[0] == "-f":
            ks = [int(x) for x in open(a[1])]
            files = [line.strip() for line in open(a[2])]
            with open(a[3], "w") as fo:
                kt.kms_sum_matrix(ks, files, fo)
        else:
            ks = [int(x) for x in open(a[0])]
            for v in kt.kms_sum(ks, a[1]):
                print(v)
    elif args.sub == "extract":
        kt.extract(a[0], int(a[1]), a[2])
    elif args.sub == "extract-bt":
        kt.extract_bt(a[0], a[1], a[2] if len(a) > 2 else None)
    elif args.sub == "serialize":
        dbi_serialize(a[0])
    elif args.sub == "serialize-bt":
        kt.serialize_bt(a[0], int(a[1]), a[2])
    elif args.sub == "raava":
        kt.raava(a[0], int(a[1]))


def _cmd_liftbed(args):
    from ..apps.liftbed_clean import liftbed_clean

    rows = [line.split("\t") for line in
            open(args.liftbed).read().splitlines()]
    liftbed_clean(rows, sys.stdout)


def main(argv=None):
    p = argparse.ArgumentParser(prog="danbing-tk")
    sub = p.add_subparsers(dest="cmd", required=True)

    a = sub.add_parser("align", help="genotype SRS reads against an RPGG")
    a.add_argument("-fa")
    a.add_argument("-fq")
    a.add_argument("-qs", required=True)
    a.add_argument("-o")
    a.add_argument("-on")
    a.add_argument("-k", type=int, default=21)
    a.add_argument("-kf", type=int, nargs=2, default=[4, 1])
    a.add_argument("-cth", type=int, default=10)
    a.add_argument("-c", type=int, default=40)
    a.add_argument("-b", action="store_true")
    a.add_argument("-qc")
    a.add_argument("-bu", action="store_true")
    a.add_argument("-ka", action="store_true")
    a.add_argument("-s", type=int, default=0)
    a.add_argument("-e", type=int, default=0,
                   help="extract assigned read pairs (1: title, 2: title:locus)")
    a.add_argument("-t", type=int, default=0,
                   help="use $PREF.tr.trim<T>.kmers as the TR kmer DB")
    a.add_argument("-tb", action="store_true",
                   help="track first-violator bait kmers -> .btk.kmdb")
    a.add_argument("-qth", type=int, default=20)
    a.add_argument("-r", type=float, default=1.0,
                   help="reads-per-batch factor")
    a.add_argument("-p", type=int, default=1,
                   help="accepted for reference CLI parity; parallelism is "
                        "the device batch / mesh, not host threads")
    a.add_argument("-g", type=int, nargs="*")
    a.add_argument("-gc", type=int, nargs="*")
    a.add_argument("-a", action="store_true")
    a.add_argument("-ae", action="store_true")
    a.add_argument("--device", action="store_true",
                   help="run the device engine")
    a.add_argument("--native-io", action="store_true",
                   help="C++ streaming reader (production ingest; "
                        "counting mode only)")
    a.add_argument("--prefilter", action="store_true",
                   help="device sampled-kmer prefilter pass before the "
                        "full pipeline (WGS production path)")
    a.add_argument("--checkpoint", metavar="PATH",
                   help="periodically persist count state; resume from "
                        "PATH after a crash")
    a.add_argument("--checkpoint-every", type=int, default=None,
                   metavar="PAIRS",
                   help="fixed save cadence in pairs; default auto-sizes "
                        "from the measured save cost (<5%% overhead)")
    a.add_argument("--expand-cap", type=int, default=512,
                   help="per-pair kmer->locus expansion slots on device")
    a.add_argument("--retry-expand",
                   type=lambda v: [int(x) for x in v.split(",")],
                   default=0,
                   help="two-phase expansion: re-run overflowing pairs "
                        "through a second device step with this many "
                        "slots before the host referee (native path)")
    a.set_defaults(fn=_cmd_align)

    w = sub.add_parser(
        "warmup", help="precompile device align programs for a "
        "(P, E, mode) shape set into the persistent compile cache")
    w.add_argument("-qs", required=True)
    w.add_argument("-k", type=int, default=21)
    w.add_argument("-kf", type=int, nargs=2, default=[4, 1])
    w.add_argument("-cth", type=int, default=10)
    w.add_argument("-c", type=int, default=40)
    w.add_argument("-b", action="store_true")
    w.add_argument("-qc")
    w.add_argument("-bu", action="store_true")
    w.add_argument("-ka", action="store_true")
    w.add_argument("-fq", nargs="?", const=True, default=False,
                   metavar="READS",
                   help="warm the fastq (quality-masked) step variant; "
                        "an optional READS operand is accepted (and "
                        "ignored) so production align flags can be "
                        "copied verbatim")
    w.add_argument("-qth", type=int, default=20)
    w.add_argument("-t", type=int, default=0)
    w.add_argument("-P", type=int, default=4096,
                   help="full-step batch pairs (align batch_pairs)")
    w.add_argument("-L", type=int, default=256,
                   help="max read length (align max_read_len)")
    w.add_argument("--prefilter", action="store_true",
                   help="also warm the prefilter dispatch shape "
                        "(P x DTK_PREFILTER_MULT)")
    w.add_argument("--expand-cap", type=int, default=512)
    w.add_argument("--retry-expand",
                   type=lambda v: [int(x) for x in v.split(",")],
                   default=0)
    w.set_defaults(fn=_cmd_warmup)

    b = sub.add_parser("build", help="build an RPGG from assemblies+beds")
    b.add_argument("workdir")
    b.add_argument("indir")
    b.add_argument("genomes")
    b.add_argument("refTR")
    b.add_argument("-k", type=int, default=21)
    b.add_argument("-fs", type=int, default=700)
    b.add_argument("--trwindow", type=int, default=100000)
    b.add_argument("--dist-merge", type=int, default=700)
    b.add_argument("-p", type=int, default=1,
                   help="MBE worker processes (X3 parity)")
    b.add_argument("--paf", action="append", metavar="G=H0.paf,H1.paf",
                   help="run native LiftTR from minimap2 PAFs "
                        "(minimap2 {asm} {ref} -x asm5 -c --cs=long) to "
                        "produce the per-genome tmp1 beds, replacing "
                        "paftools.js+bedtools")
    b.add_argument("--lift-min-len", type=int, default=50_000,
                   help="liftover alignment-length gate (paftools -l)")
    b.add_argument("--prune-reads", action="append", metavar="G=READS",
                   help="genome=reads-path; enables the raw->prune->PB "
                   "graph path (GenRaw/GenPrunedGenomeGraph) per genome")
    b.add_argument("-cth", type=int, default=45,
                   help="prune-alignment count threshold")
    b.add_argument("--thcth", type=int, default=50,
                   help="prune-alignment threading count threshold")
    b.add_argument("--device", action="store_true",
                   help="run the prune alignment on the device engine")
    b.set_defaults(fn=_cmd_build)

    br = sub.add_parser("build-ref",
                        help="build a reference-genome RPGG (RefGraph)")
    br.add_argument("workdir")
    br.add_argument("ref_fa")
    br.add_argument("refTR")
    br.add_argument("-g", default="hg38")
    br.add_argument("-k", type=int, default=21)
    br.add_argument("-fs", type=int, default=700)
    br.add_argument("--trwindow", type=int, default=100000)
    br.add_argument("--dist-merge", type=int, default=700)
    br.add_argument("-p", type=int, default=1)
    br.set_defaults(fn=_cmd_build_ref)

    qc = sub.add_parser(
        "qc", help="QC/bait-build harness: the fn1a->fn2a3 loop of the "
        "reference's test/QC/*.sh (sim -> annotate -> extract -> raw map "
        "-> profiles -> FPSkmer -> serialize-bt -> bait map)")
    qc.add_argument("indir", help="dir with <g>.<h>.fa + serialized pan.*")
    qc.add_argument("workdir")
    qc.add_argument("genomes", help="comma-separated genome names")
    qc.add_argument("ref_genome",
                    help="negative-control genome defining the FP profile")
    qc.add_argument("-k", type=int, default=21)
    qc.add_argument("-c", "--cov", type=int, default=15)
    qc.add_argument("-ml", "--min-ctg", type=int, default=500)
    qc.add_argument("--extract-cth", type=int, default=5)
    qc.add_argument("--map-cth", type=int, default=10)
    qc.add_argument("--device", action="store_true")
    qc.set_defaults(fn=_cmd_qc)

    s = sub.add_parser("serialize", help="ktools serialize equivalent")
    s.add_argument("pref")
    s.set_defaults(fn=_cmd_serialize)

    f = sub.add_parser("fa2kmers")
    f.add_argument("-o", required=True)
    f.add_argument("-fa", nargs="+", required=True)
    f.add_argument("-k", type=int, default=21)
    f.add_argument("-fsi", type=int, default=700)
    f.add_argument("-fso", type=int, default=700)
    f.add_argument("-g", action="store_true")
    f.add_argument("-tr", action="store_true")
    f.add_argument("-th", type=int, default=0)
    f.add_argument("-p", help="prune kmer file (-p)", default=None)
    f.add_argument("--tre", action="store_true")
    f.set_defaults(fn=_cmd_fa2kmers)

    g = sub.add_parser("genpankmers")
    g.add_argument("-o", required=True)
    g.add_argument("-m", default="-")
    g.add_argument("-k", nargs="+", required=True)
    g.add_argument("-tr", action="store_true")
    g.add_argument("-tre", action="store_true")
    g.set_defaults(fn=_cmd_genpankmers)

    pr = sub.add_parser("pred", help="bias correction")
    pr.add_argument("gt_meta")
    pr.add_argument("ikmer_meta")
    pr.add_argument("out_raw")
    pr.add_argument("out")
    pr.add_argument("out_bias")
    pr.add_argument("--jax", action="store_true")
    pr.set_defaults(fn=_cmd_pred)

    bt = sub.add_parser("baitbuilder")
    bt.add_argument("mode", choices=["v1.pf", "v2"])
    bt.add_argument("--kam")
    bt.add_argument("--nloci", type=int, required=True)
    bt.add_argument("-k", type=int, default=21)
    bt.add_argument("--out", required=True)
    bt.add_argument("--tp", action="store_true")
    bt.add_argument("--fp-pf")
    bt.add_argument("--tp-pfs", nargs="+")
    bt.set_defaults(fn=_cmd_bait)

    sr = sub.add_parser("simreads")
    sr.add_argument("-i", required=True)
    sr.add_argument("-c", type=int, default=15)
    sr.add_argument("-fs", type=int, default=500)
    sr.add_argument("-rlen", type=int, default=150)
    sr.add_argument("-ml", type=int, default=50000)
    sr.add_argument("-uni", action="store_true")
    sr.add_argument("-bed", action="store_true")
    sr.add_argument("--seed", type=int, default=0)
    sr.add_argument("-o", default=None)
    sr.add_argument("-split", action="store_true")
    sr.set_defaults(fn=_cmd_simreads)

    bp = sub.add_parser("bam2pe")
    bp.add_argument("-fai", required=True)
    bp.set_defaults(fn=_cmd_bam2pe)

    be = sub.add_parser("bench")
    be.set_defaults(fn=_cmd_bench)

    eq = sub.add_parser(
        "eqtl", help="single-tissue eQTL mapping (eqtl.noPerm.py "
        "equivalent; writes {tissue}.v8.egenes.txt)")
    for name, req in (("TRbed", True), ("geneBed", True), ("pair", True),
                      ("expDir", True), ("resDir", False),
                      ("genDir", True), ("covDir", True), ("outDir", True),
                      ("phenotype", True), ("genomes", True),
                      ("tissues", True), ("genMat", False),
                      ("SNPPC", False), ("ctrlbed", False)):
        eq.add_argument(f"--{name}", required=req)
    eq.add_argument("--NL1", required=True, type=int)
    eq.add_argument("--NL2", required=True, type=int)
    eq.set_defaults(fn=_cmd_eqtl)

    ln = sub.add_parser(
        "length", help="VNTR length prediction from kmer dosage via "
        "precomputed locus-specific biases (the intended flow of the "
        "reference's bit-rotted script/kmc2length.py main; writes "
        "{outdir}/estimated_TR_len.tsv)")
    ln.add_argument("--outdir", required=True)
    ln.add_argument("--ksize", required=True, type=int)
    ln.add_argument("--kmers", required=True,
                    help="file listing per-sample count-only kmer files")
    ln.add_argument("--trbed", required=True)
    ln.add_argument("--LSB", required=True)
    ln.add_argument("--cov", required=True)
    ln.add_argument("--covbed", default=None,
                    help="accepted for reference-CLI parity (the "
                    "reference main never reads it; ctrl sizes come "
                    "from the LSB row names)")
    ln.add_argument("--ksi", default=None,
                    help="per-locus cumulative kmer index (ktools ksi)")
    ln.add_argument("--qs", default=None,
                    help="RPGG prefix to derive the ksi from "
                    "pan.tr.kmers (alternative to --ksi)")
    ln.add_argument("--seqruns", default=None,
                    help="sample->sequencing-run table: switches the "
                    "LSB-donor pick to the LOO seqrun prior")
    ln.add_argument("--db-seqruns", default=None)
    ln.add_argument("--bad-donors", default="",
                    help="comma-separated donor indices to exclude")
    ln.set_defaults(fn=_cmd_length)

    ca = sub.add_parser("call", help="rare-variant (novel bubble) calling")
    ca.add_argument("pref", help="RPGG prefix (needs .bi_tr/.bi_fl.kdb)")
    ca.add_argument("tr_kmers")
    ca.add_argument("tr_index")
    ca.add_argument("bub")
    ca.add_argument("br_svm")
    ca.add_argument("bp_svm")
    ca.add_argument("out")
    ca.add_argument("--th", type=int, default=10)
    ca.add_argument("--graph-size-limit", type=int, default=10000)
    ca.set_defaults(fn=_cmd_call)

    kt = sub.add_parser("ktools", help="index utilities")
    kt.add_argument("sub", choices=["ksi", "sum", "extract", "extract-bt",
                                    "serialize", "serialize-bt", "raava"])
    kt.add_argument("args", nargs="*")
    kt.set_defaults(fn=_cmd_ktools)

    mk = sub.add_parser("mapkmers")
    mk.add_argument("panbed")
    mk.add_argument("target_field", type=int)
    mk.add_argument("pankmers")
    mk.add_argument("kmers")
    mk.add_argument("outpref")
    mk.set_defaults(fn=lambda a: __import__(
        "danbing_tk_tpu.apps.mapkmers", fromlist=["mapkmers"]).mapkmers(
        a.panbed, a.target_field, a.pankmers, a.kmers, a.outpref))

    lb = sub.add_parser("liftbed-clean")
    lb.add_argument("liftbed")
    lb.set_defaults(fn=_cmd_liftbed)

    sr2 = sub.add_parser("select-regions")
    sr2.add_argument("bed")
    sr2.add_argument("fasta")
    sr2.add_argument("out")
    sr2.set_defaults(fn=lambda a: __import__(
        "danbing_tk_tpu.apps.select_regions",
        fromlist=["select_regions"]).select_regions(a.bed, a.fasta, a.out))

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
