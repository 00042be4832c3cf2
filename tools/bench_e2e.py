#!/usr/bin/env python
"""End-to-end WGS-shaped benchmark: C-reader ingest -> device prefilter
-> survivor repack -> full pipeline -> outputs, wall-clock.

Synthesizes a read file shaped like a WGS sample hitting a TR panel:
DTK_E2E_FRAC (default 5%) of pairs come from the bench haplotypes, the
rest are random background the prefilter must reject.  Reports overall
reads/s including ingest, and the stage funnel.

Run on the accelerator: `python tools/bench_e2e.py`
(env: DTK_E2E_PAIRS=200000, DTK_E2E_FRAC=0.05, DTK_BENCH_NLOCI=512)
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def synth_reads(path, npairs, frac, seqs, L=150, err=0.0,
                chunk=1_000_000, seed=3, flen=500, bg_pool=None):
    """WGS-shaped PE fasta, vectorized (a 5e7-pair/30GB file is feasible):
    frac of pairs drawn from the haplotype pool, the rest background —
    uniform random (bg_pool=None, the round-2 panel, flatters the
    prefilter) or proper PE fragments of REAL sequence (bg_pool=[byte
    arrays], e.g. the bundled hg38 chr12 slice).  err = per-base
    substitution rate; with a real background the profile applies to
    every read (real reads carry errors everywhere)."""
    rng = np.random.default_rng(seed)
    pool = [np.frombuffer(s.encode(), dtype=np.uint8)
            for s in seqs if len(s) >= flen]
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    comp = np.zeros(256, dtype=np.uint8)
    for a, b in zip(b"ACGTN", b"TGCAN"):
        comp[a] = b
    b2i = np.zeros(256, dtype=np.int64)
    for i_, a in enumerate(b"ACGT"):
        b2i[a] = i_
    nl = np.uint8(ord("\n"))
    bg = None
    if bg_pool is not None:
        bg = np.concatenate(bg_pool)
    # write to a temp name and rename at the end: a crashed/interrupted
    # synthesis must not leave a truncated file that later runs treat as
    # a valid cache
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        done = 0
        while done < npairs:
            n = min(chunk, npairs - done)
            if bg is None:
                r1 = bases[rng.integers(0, 4, (n, L))]
                r2 = bases[rng.integers(0, 4, (n, L))]
            else:
                # proper PE fragments from the real background; RC the
                # whole fragment half the time (strand randomness)
                starts = rng.integers(0, len(bg) - flen, n)
                w = np.arange(L)
                r1 = bg[starts[:, None] + w]
                r2 = comp[bg[(starts + flen - L)[:, None] + w]][:, ::-1]
                flip = rng.random(n) < 0.5
                r1f = comp[r2[flip, ::-1]][:, ::-1]      # RC of mate2
                r2f = comp[r1[flip, ::-1]][:, ::-1]
                r1[flip], r2[flip] = r1f, r2f
                if err:
                    for r in (r1, r2):
                        m = rng.random((n, L)) < err
                        cur = b2i[r[m]]
                        r[m] = bases[(cur + rng.integers(
                            1, 4, int(m.sum()))) % 4]
            for i in np.flatnonzero(rng.random(n) < frac):
                s = pool[int(rng.integers(len(pool)))]
                b = int(rng.integers(0, len(s) - flen + 1))
                r1[i] = s[b:b + L]
                r2[i] = comp[s[b + flen - L:b + flen]][::-1]
                if err:
                    for r in (r1, r2):
                        m = np.flatnonzero(rng.random(L) < err)
                        # substitute with a DIFFERENT base so the nominal
                        # rate is the effective rate (matches bench.py's
                        # exact-mode injection)
                        cur = b2i[r[i, m]]
                        r[i, m] = bases[(cur + rng.integers(
                            1, 4, len(m))) % 4]
            r1 = np.concatenate([r1, np.full((n, 1), nl)], axis=1)
            r2 = np.concatenate([r2, np.full((n, 1), nl)], axis=1)
            f.write(b"".join(
                b">p%d/1\n%s>p%d/2\n%s" % (done + i, r1[i].tobytes(),
                                           done + i, r2[i].tobytes())
                for i in range(n)))
            done += n
            print(f"  {done}/{npairs} pairs", file=sys.stderr)
    os.replace(tmp, path)


def main():
    from danbing_tk_tpu.engine.align_runner import DeviceAlignRunner
    from danbing_tk_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from danbing_tk_tpu.engine.host_align import AlignConfig, RPGG
    from danbing_tk_tpu.apps.fa2kmers import read_fasta_seqs
    from tools.make_bench_rpgg import build

    root = os.path.join(os.path.dirname(__file__), "..")
    npairs = int(os.environ.get("DTK_E2E_PAIRS", 200_000))
    frac = float(os.environ.get("DTK_E2E_FRAC", 0.05))
    nloci = int(os.environ.get("DTK_BENCH_NLOCI", 512))
    L = 150

    # panel provenance:
    #   synthetic — RNG motifs, uniform-random background (round-2 panel;
    #               flatters the prefilter)
    #   real      — real-motif TR arrays + human-composition flanks
    #               (tools/make_real_panel.py), background reads = proper
    #               PE fragments of the bundled hg38 chr12 slice
    panel = os.environ.get("DTK_E2E_PANEL", "synthetic")
    err = float(os.environ.get("DTK_E2E_ERR", 0.0))
    if panel == "real":
        from tools.make_real_panel import build as build_real
        from tools.make_real_panel import background_pool

        pan = build_real(os.path.join(root, "build",
                                      f"real_panel{nloci}"), nloci)
        bg_pool = background_pool()
    else:
        pan = build(os.path.join(
            root, "build", f"bench_rpgg{'' if nloci == 512 else nloci}"),
            nloci)
        bg_pool = None
    reads = os.path.join(os.path.dirname(pan),
                         f"e2e_{npairs}_{frac}_{err}.fa")
    if not os.path.exists(reads):
        print("synthesizing reads...", file=sys.stderr)
        seqs = read_fasta_seqs(os.path.join(os.path.dirname(pan),
                                            "hap0.fa"))
        synth_reads(reads, npairs, frac, seqs, L=L, err=err,
                    bg_pool=bg_pool)

    rpgg = RPGG(pan)
    # DTK_E2E_THREADING=1: graph-threading mode (the README release
    # mode -gc) — clean walks on the device DFA, error-correction pairs
    # fan the native engine over the host pool; counting mode, no .aln output
    threading = bool(os.environ.get("DTK_E2E_THREADING"))
    cfg = AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1,
                      okam=False, threading=threading,
                      thread_cth=int(os.environ.get("DTK_E2E_TCTH", 50)),
                      correction=threading, maxncorrection=4)
    P = int(os.environ.get("DTK_E2E_P", 4096))
    E = int(os.environ.get("DTK_E2E_EXPAND", 512))
    retry = [int(x) for x in os.environ.get(
        "DTK_E2E_RETRY", "0").split(",") if int(x)]
    al = DeviceAlignRunner(rpgg, cfg, batch_pairs=P, max_read_len=160,
                           expand_cap=E, retry_expand=retry)
    # compile both programs before the timed run (one-time cost per shape)
    t0 = time.time()
    al.run_file_native(reads, prefilter=True)
    wall = time.time() - t0
    nreads = 2 * npairs
    print(f"# wall={wall:.1f}s ({nreads / wall:.0f} reads/s incl. ingest "
          f"+ compile) prefiltered={al.n_prefiltered}/{npairs} "
          f"referee={al.n_referee}", file=sys.stderr)

    # steady-state: second pass reuses the compiled programs
    al2 = DeviceAlignRunner(rpgg, cfg, batch_pairs=P, max_read_len=160,
                            expand_cap=E, retry_expand=retry)
    al2.retry_steps = al.retry_steps
    al2.prefilter_step = al.prefilter_step
    al2.prefilter_P = getattr(al, "prefilter_P", None)
    al2.step = al.step
    t0 = time.time()
    al2.run_file_native(reads, prefilter=True)
    wall2 = time.time() - t0
    surv = npairs - al2.n_prefiltered
    print(f"# steady wall={wall2:.1f}s -> {nreads / wall2:.0f} reads/s "
          f"end-to-end (ingest+prefilter+full+referee) panel={panel} "
          f"nloci={nloci} survivors={surv}/{npairs} "
          f"({100 * surv / npairs:.2f}%) referee={al2.n_referee} "
          f"{al2.referee_reasons}"
          + (f" host_thread={al2.n_host_thread}" if threading else ""),
          file=sys.stderr)
    al2.write_trkmc_ar("/tmp/e2e.trkmc.ar")
    print(f"e2e_reads_per_sec={nreads / wall2:.0f}")


if __name__ == "__main__":
    main()
