#!/usr/bin/env python
"""Flagship WGS funnel at PRODUCTION INDEX SCALE.

Round 2 measured the funnel on a 720k-key toy panel and the 115M-key
index only in exact mode; this tool runs the REAL production path — C
reader ingest -> device prefilter -> survivor repack -> full device
pipeline (+ retry ladder) -> exact flat-referee — against the cached
80k-locus / ~115M-key scale index (tools/make_scale_index.py), with the
exact host semantics supplied by the flat host view
(engine/flat_rpgg.FlatRPGG: zero-copy sorted arrays, no dicts).

Reports: funnel reads/s (ingest included), prefilter survivor rate,
referee rate + reasons, retry count, and optionally checkpoint overhead.

Env knobs:
  DTK_SF_NLOCI=80000 DTK_SF_KPL=1500    index shape (cache key)
  DTK_SF_PAIRS=2000000 DTK_SF_FRAC=0.05 reads file shape
  DTK_SF_ERR=0.002                      per-base substitution rate
  DTK_SF_BG=random|real                 background provenance (real =
                                        hg38 chr12 PE fragments)
  DTK_SF_P=4096 DTK_SF_E=768            step shapes
  DTK_SF_RETRY=4096                     retry ladder ('' disables)
  DTK_SF_CKPT=1                         also measure checkpoint overhead
Tables ride as jit ARGUMENTS (the engine never embeds them as
constants).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    from danbing_tk_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from danbing_tk_tpu.engine.align_runner import DeviceAlignRunner
    from danbing_tk_tpu.engine.flat_rpgg import FlatRPGG
    from danbing_tk_tpu.engine.host_align import AlignConfig
    from tools.bench_e2e import synth_reads
    from tools.make_scale_index import build_scale_rpgg_cached

    nloci = int(os.environ.get("DTK_SF_NLOCI", 80_000))
    kpl = int(os.environ.get("DTK_SF_KPL", 1500))
    npairs = int(os.environ.get("DTK_SF_PAIRS", 2_000_000))
    frac = float(os.environ.get("DTK_SF_FRAC", 0.05))
    err = float(os.environ.get("DTK_SF_ERR", 0.002))
    bg = os.environ.get("DTK_SF_BG", "random")
    P = int(os.environ.get("DTK_SF_P", 4096))
    E = int(os.environ.get("DTK_SF_E", 768))
    retry = [int(x) for x in os.environ.get(
        "DTK_SF_RETRY", "4096").split(",") if x and int(x)]
    L = 150

    t0 = time.time()
    drp, seqs = build_scale_rpgg_cached(nloci, kpl)
    print(f"# index load: {time.time()-t0:.0f}s", file=sys.stderr)

    t0 = time.time()
    root0 = os.path.join(os.path.dirname(__file__), "..", "build")
    flat = FlatRPGG.from_device_tables_cached(
        drp, os.path.join(root0, f"flat_{nloci}_{kpl}_v1.npz"))
    print(f"# flat host view (exact referee substrate): "
          f"{len(flat.dbi)/1e6:.1f}M keys in {time.time()-t0:.0f}s",
          file=sys.stderr, flush=True)

    # WGS-shaped reads file (cached by shape)
    root = os.path.join(os.path.dirname(__file__), "..", "build")
    reads = os.path.join(
        root, f"sf_{nloci}_{kpl}_{npairs}_{frac}_{err}_{bg}.fa")
    if not os.path.exists(reads):
        t0 = time.time()
        bases = np.frombuffer(b"ACGT", dtype=np.uint8)
        dec = bases[seqs]
        pool = [dec[i].tobytes().decode()
                for i in range(min(len(dec), 20_000))]
        bg_pool = None
        if bg == "real":
            from tools.make_real_panel import background_pool

            bg_pool = background_pool()
        flen = min(500, len(pool[0]))
        assert flen >= L, (
            f"panel sequences ({len(pool[0])}bp) shorter than the read "
            f"length {L} — raise DTK_SF_KPL")
        synth_reads(reads, npairs, frac, pool, L=L, err=err,
                    flen=flen, bg_pool=bg_pool)
        print(f"# reads synthesized: {npairs} pairs "
              f"({os.path.getsize(reads)/1e9:.1f} GB, "
              f"{time.time()-t0:.0f}s)", file=sys.stderr)
    del seqs

    cfg = AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1,
                      okam=False)

    def mk():
        al = DeviceAlignRunner(flat, cfg, batch_pairs=P,
                               max_read_len=160, expand_cap=E,
                               retry_expand=retry, drp=drp)
        return al

    def sink(al):
        # a real device->host dependency ends the timed region
        import jax.numpy as jnp

        return int(al.state["counts"].sum(dtype=jnp.uint32))

    def report(tag, al, wall):
        nreads = 2 * npairs
        surv = npairs - al.n_prefiltered
        print(f"# {tag}: wall={wall:.1f}s -> {nreads/wall:.0f} reads/s "
              f"(P={P} E={E} retry={retry}) "
              f"survivors={surv}/{npairs} ({100*surv/npairs:.3f}%) "
              f"retried={al.n_retried} referee={al.n_referee} "
              f"{al.referee_reasons}", file=sys.stderr)
        return nreads / wall

    # pass 1: includes compiles
    al = mk()
    t0 = time.time()
    al.run_file_native(reads, prefilter=True)
    _ = sink(al)
    rps1 = report("cold (incl compile)", al, time.time() - t0)

    # steady passes (reuse compiled programs): median of DTK_SF_STEADY
    # with the spread printed (round-3 lesson: single passes hide
    # host-contention corruption)
    nsteady = int(os.environ.get("DTK_SF_STEADY", 5))
    deadline_ts = float(os.environ.get("DTK_PF_DEADLINE_TS", 0) or 0)
    walls = []
    al2 = al
    for _ in range(max(nsteady, 1)):
        flat.flat_counts()[:] = 0
        prev, al2 = al2, mk()
        al2.step = al.step
        al2.retry_steps = al.retry_steps
        al2.prefilter_step = getattr(al, "prefilter_step", None)
        al2.prefilter_P = getattr(al, "prefilter_P", None)
        prev.state = None    # free previous device accumulators
        t0 = time.time()
        al2.run_file_native(reads, prefilter=True)
        _ = sink(al2)
        walls.append(time.time() - t0)
        # soft deadline (set by bench.py): stop early with however many
        # passes fit rather than being hard-killed with nothing
        if deadline_ts and time.time() + 1.2 * max(walls) > deadline_ts:
            print(f"# steady: soft deadline reached after {len(walls)} "
                  f"pass(es)", file=sys.stderr, flush=True)
            break
    # the pass right after the cold pass still carries settling cost
    # (program residency / page cache); with >=4 passes measured, drop
    # it from the statistic (rehearsal r05: walls [10.6, 9.2, 8.6, 9.2,
    # 8.6] — the first is a one-off and tripped the contaminated flag)
    stat = walls[1:] if len(walls) >= 4 else walls
    wall2 = sorted(stat)[len(stat) // 2]
    spread = (max(stat) - min(stat)) / wall2
    rps2 = report("steady", al2, wall2)
    print(f"# steady walls: {[round(w, 1) for w in walls]} "
          f"(median {wall2:.1f}s, spread {100*spread:.1f}%)",
          file=sys.stderr)

    ck_over = None
    if os.environ.get("DTK_SF_CKPT"):
        every = int(os.environ.get("DTK_SF_CKPT_EVERY", 1_000_000))
        al_prev = al2
        # two passes: the first pays the one-time snapshot-program
        # compile; the second is the steady overhead
        for tag in ("ckpt cold", "ckpt warm"):
            flat.flat_counts()[:] = 0
            al_prev.state = None
            al3 = mk()
            al3.step = al.step
            al3.retry_steps = al.retry_steps
            al3.prefilter_step = getattr(al, "prefilter_step", None)
            al3.prefilter_P = getattr(al, "prefilter_P", None)
            ckpt = os.path.join(root, "sf_ckpt.npz")
            if os.path.exists(ckpt):
                os.unlink(ckpt)
            t0 = time.time()
            al3.run_file_native(reads, checkpoint=ckpt, prefilter=True,
                                checkpoint_every=every)
            _ = sink(al3)
            wall3 = time.time() - t0
            ck_over = (wall3 - wall2) / wall2
            report(f"{tag}@{every/1e6:g}M (overhead {100*ck_over:.1f}%)",
                   al3, wall3)
            al_prev = al3

    nkeys = len(flat.dbi)
    out = {
        "metric": "scale_funnel_reads_per_sec",
        "value": round(rps2, 1),
        "unit": f"reads/s@{nkeys/1e6:.0f}Mkeys",
        "vs_baseline": round(rps2 / (6.2e8 / (12 * 3600)), 2),
        "spread": round(spread, 4),
        "passes": len(walls),
    }
    # same discipline as the panel metrics: the
    # number carries its spread, and a loud flag when it is untrustworthy
    if spread > 0.15 or len(walls) < 3:
        out["contaminated"] = True
    print(json.dumps(out), flush=True)
    if ck_over is not None:
        print(json.dumps({"metric": "scale_funnel_ckpt_overhead",
                          "value": round(ck_over, 4), "unit": "frac",
                          "vs_baseline": 0}))
    _ = rps1


if __name__ == "__main__":
    main()
