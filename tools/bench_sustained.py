#!/usr/bin/env python
"""Sustained >=100M-pair production funnel run.

Every scale number so far extrapolated from <=50M pairs; this tool runs
ONE process over 100M pairs (a third of a 30x sample) against the
80k-locus / 115M-key index with real hg38 chr12 background, okam on,
auto-cadence checkpointing — validating ingest, rowsink, checkpoint
cadence and memory at sustained scale, and measuring rate drift between
the first and last 10M-pair windows.

The 100M pairs ride as 10 x 10M-pair files (distinct seeds) processed
sequentially by ONE runner: ingest load is identical to a single
monolithic file (the reference's one-pass design,
aQueryFasta_thread.cpp:1803-2283), and the per-file walls give the
drift windows for free.

Env knobs:
  DTK_SUST_WINDOWS=10   number of 10M-pair windows
  DTK_SUST_PAIRS=10000000  pairs per window
  DTK_SUST_SYNTH_ONLY=1 synthesize the window files and exit (host-only;
                        run before the device session)
  DTK_SUST_OKAM=1       okam (.kam rows) on (default 1)
  DTK_SUST_CKPT=1       auto-cadence checkpointing on (default 1)

Emits one JSON line: sustained reads/s over the full run + window rates
+ checkpoint overhead estimate.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

os.environ.setdefault("DTK_PREFILTER_MULT", "16")

ROOT = os.path.join(os.path.dirname(__file__), "..")


def window_files(nwin, npairs, frac, err):
    """Synthesize (or reuse cached) per-window read files."""
    from danbing_tk_tpu.apps.fa2kmers import read_fasta_seqs  # noqa: F401
    from tools.bench_e2e import synth_reads
    from tools.make_real_panel import background_pool

    build = os.path.join(ROOT, "build")
    paths = [os.path.join(
        build, f"sust_{npairs}_{frac}_{err}_w{w}.fa") for w in range(nwin)]
    missing = [w for w, p in enumerate(paths) if not os.path.exists(p)]
    if not missing:
        return paths
    # seqs pool: decode the first 20k panel sequences (same pool as
    # bench_scale_funnel's reads)
    from tools.make_scale_index import build_scale_rpgg_cached

    nloci = int(os.environ.get("DTK_SF_NLOCI", 80_000))
    kpl = int(os.environ.get("DTK_SF_KPL", 1500))
    t0 = time.time()
    _, seqs = build_scale_rpgg_cached(nloci, kpl)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    dec = bases[seqs]
    pool = [dec[i].tobytes().decode() for i in range(min(len(dec), 20_000))]
    del dec, seqs
    bg = background_pool()
    print(f"# pools ready ({time.time()-t0:.0f}s); synthesizing "
          f"{len(missing)} windows x {npairs} pairs", file=sys.stderr,
          flush=True)
    for w in missing:
        t0 = time.time()
        synth_reads(paths[w], npairs, frac, pool, L=150, err=err,
                    flen=min(500, len(pool[0])), seed=100 + w,
                    bg_pool=bg)
        print(f"# window {w}: {os.path.getsize(paths[w])/1e9:.1f} GB "
              f"({time.time()-t0:.0f}s)", file=sys.stderr, flush=True)
    return paths


def main():
    nwin = int(os.environ.get("DTK_SUST_WINDOWS", 10))
    npairs = int(os.environ.get("DTK_SUST_PAIRS", 10_000_000))
    frac = float(os.environ.get("DTK_SUST_FRAC", 0.05))
    err = float(os.environ.get("DTK_SUST_ERR", 0.002))
    okam = os.environ.get("DTK_SUST_OKAM", "1") != "0"
    ckpt_on = os.environ.get("DTK_SUST_CKPT", "1") != "0"

    paths = window_files(nwin, npairs, frac, err)
    if os.environ.get("DTK_SUST_SYNTH_ONLY"):
        print(f"# synth done: {nwin} windows", file=sys.stderr)
        return

    from danbing_tk_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from danbing_tk_tpu.engine.align_runner import DeviceAlignRunner
    from danbing_tk_tpu.engine.flat_rpgg import FlatRPGG
    from danbing_tk_tpu.engine.host_align import AlignConfig
    from danbing_tk_tpu.io.rowsink import RowSink
    from tools.make_scale_index import build_scale_rpgg_cached

    nloci = int(os.environ.get("DTK_SF_NLOCI", 80_000))
    kpl = int(os.environ.get("DTK_SF_KPL", 1500))
    P = int(os.environ.get("DTK_SF_P", 4096))
    E = int(os.environ.get("DTK_SF_E", 768))
    retry = [int(x) for x in os.environ.get(
        "DTK_SF_RETRY", "4096").split(",") if x and int(x)]

    t0 = time.time()
    drp, seqs = build_scale_rpgg_cached(nloci, kpl)
    del seqs
    flat = FlatRPGG.from_device_tables_cached(
        drp, os.path.join(ROOT, "build", f"flat_{nloci}_{kpl}_v1.npz"))
    print(f"# index + flat view ready: {len(flat.dbi)/1e6:.1f}M keys "
          f"({time.time()-t0:.0f}s)", file=sys.stderr, flush=True)

    cfg = AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1,
                      okam=okam)
    al = DeviceAlignRunner(flat, cfg, batch_pairs=P, max_read_len=160,
                           expand_cap=E, retry_expand=retry, drp=drp)
    kam_path = os.path.join(ROOT, "build", "sust.kam")
    if okam:
        if os.path.exists(kam_path):
            os.unlink(kam_path)
        al.kam_rows = RowSink(kam_path)
    ck = os.path.join(ROOT, "build", "sust.ckpt.npz") if ckpt_on else None
    if ck and os.path.exists(ck):
        os.unlink(ck)

    import resource

    walls, nref, nretr = [], [], []
    t_all = time.time()
    for w, path in enumerate(paths):
        t0 = time.time()
        al.run_file_native(path, prefilter=True, checkpoint=ck)
        walls.append(time.time() - t0)
        nref.append(al.n_referee)
        nretr.append(al.n_retried)
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
        print(f"# window {w}: {walls[-1]:.1f}s -> "
              f"{2*npairs/walls[-1]:.0f} reads/s  referee={al.n_referee}"
              f" retried={al.n_retried} maxrss={rss:.1f}GB "
              f"ckpt_wall={getattr(al, '_last_ckpt_wall', None)}",
              file=sys.stderr, flush=True)
    wall = time.time() - t_all
    if okam:
        al.write_kam(kam_path)
    al.write_trkmc_ar(os.path.join(ROOT, "build", "sust.trkmc.ar"))

    nreads = 2 * npairs * nwin
    rate = nreads / wall
    drift = (2 * npairs / walls[-1]) / (2 * npairs / walls[0]) - 1
    out = {
        "metric": "sustained_100M_reads_per_sec",
        "value": round(rate, 1),
        "unit": f"reads/s@{len(flat.dbi)/1e6:.0f}Mkeys",
        "vs_baseline": round(rate / (6.2e8 / (12 * 3600)), 2),
        "windows": [round(2 * npairs / w_, 1) for w_ in walls],
        "first_last_drift": round(drift, 4),
        "okam": okam, "ckpt": ckpt_on,
        "kam_bytes": os.path.getsize(kam_path) if okam else 0,
    }
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
