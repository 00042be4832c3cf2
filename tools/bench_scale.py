#!/usr/bin/env python
"""Production-index-scale engine benchmark.

Builds a >=100M-key synthetic index (tools/make_scale_index.py), uploads
the bucket tables to the device AS JIT ARGUMENTS (constants would bloat
the HLO beyond compile limits at this size), and measures:

  * dbi probe throughput (lookups/s) at production table size
  * full align-step throughput (reads/s) with vote + annotate + count
  * HBM table footprint, host build time, compile time

Env: DTK_SCALE_NLOCI (80000), DTK_SCALE_KPL (kmers/locus, 1500),
DTK_SCALE_PAIRS (2048), DTK_SCALE_STEPS (8), DTK_SCALE_PROBE_ONLY=1.
A persistent compile cache under build/jaxcache amortizes recompiles.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    import jax

    from danbing_tk_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import jax.numpy as jnp

    from danbing_tk_tpu.engine import device_align as da
    from danbing_tk_tpu.engine.host_align import AlignConfig
    from danbing_tk_tpu.index import device_table as dt
    from tools.make_scale_index import (build_scale_rpgg_cached,
                                        sample_read_batch)

    nloci = int(os.environ.get("DTK_SCALE_NLOCI", 80_000))
    kpl = int(os.environ.get("DTK_SCALE_KPL", 1500))
    P = int(os.environ.get("DTK_SCALE_PAIRS", 2048))
    nsteps = int(os.environ.get("DTK_SCALE_STEPS", 8))
    probe_only = bool(os.environ.get("DTK_SCALE_PROBE_ONLY"))
    L, k = 150, 21

    t0 = time.time()
    drp, seqs = build_scale_rpgg_cached(nloci, kpl,
                                        with_trfl=not probe_only)
    build_s = time.time() - t0
    # exact key count: level rows store lo at col 0 of each BUCKET*W row
    nkeys = 0
    for t, _ in drp.dbi_tab.levels:
        W = 3
        r = t.reshape(t.shape[0], dt.BUCKET, W)
        nkeys += int((r[:, :, 0] != dt.EMPTY).sum())
    tab_bytes = drp.dbi_tab.nbytes + (
        drp.trfl_tab.nbytes if drp.trfl_tab else 0)
    print(f"# index: {nkeys/1e6:.1f}M dbi keys, tables "
          f"{tab_bytes/1e9:.2f} GB, host build {build_s:.0f}s",
          file=sys.stderr)

    dev = jax.devices()[0]
    rng = np.random.default_rng(11)

    # ---- probe microbench: dbi lookups at production size ----
    NKW = L - k + 1
    t0 = time.time()
    dbi_dev = [(jax.device_put(jnp.asarray(t)), s)
               for t, s in drp.dbi_tab.levels]
    # finish the multi-GB table upload BEFORE any timed region
    jax.block_until_ready([t for t, _ in dbi_dev])
    print(f"# upload: dbi tables resident in {time.time()-t0:.0f}s",
          file=sys.stderr)
    salts = [s for _, s in drp.dbi_tab.levels]

    def probe(qlo, qhi, tabs):
        lv = list(zip(tabs, salts))
        f, v = dt.lookup_bucket_jax(drp.dbi_tab, qlo, qhi,
                                    levels_dev=lv)[:2]
        # chain-able reduction so dependent timing loops work
        return (f.sum().astype(jnp.uint32) + v.max()), f

    probe_j = jax.jit(probe)
    B = 4096
    codes, rlen = sample_read_batch(seqs, B // 2, L, rng)
    from danbing_tk_tpu.ops.kmers_jax import extract_kmers_edges
    ex = jax.jit(lambda c, r: extract_kmers_edges(c, r, k))(
        jnp.asarray(codes), jnp.asarray(rlen))
    qlo = jax.device_put(ex["klo"][:B])
    qhi = jax.device_put(ex["khi"][:B])
    tabs = [t for t, _ in dbi_dev]
    t0 = time.time()
    s, _ = probe_j(qlo, qhi, tabs)
    jax.block_until_ready(s)
    probe_compile = time.time() - t0
    t0 = time.time()
    nrep = 20
    for _ in range(nrep):
        s, _ = probe_j(qlo ^ (s & 0), qhi, tabs)   # chain on s
    _ = int(s)   # host fetch ends the timed region
    dt_probe = time.time() - t0
    lookups = nrep * B * NKW / dt_probe
    print(f"# probe: {lookups:.3e} lookups/s (B={B} NKW={NKW}, "
          f"compile {probe_compile:.1f}s)", file=sys.stderr)

    if probe_only:
        print(json.dumps({
            "metric": "scale_dbi_lookups_per_sec", "value": lookups,
            "unit": f"lookups/s@{nkeys/1e6:.0f}Mkeys", "vs_baseline": 0}))
        return

    # ---- full step at scale (tables ride as jit args) ----
    E = int(os.environ.get("DTK_SCALE_E", 768))
    cfg = AlignConfig(ksize=k, cth=20, n_filter=4, nm_filter=1)
    step = da.make_step(drp, cfg, P, L, expand_cap=E, with_annot=False)
    state = da.init_state(drp)
    codes, rlen = sample_read_batch(seqs, P, L, rng)
    live = jax.device_put(jnp.ones(P, bool))
    codes = jax.device_put(jnp.asarray(codes))
    rlen = jax.device_put(jnp.asarray(rlen))
    t0 = time.time()
    state, out = step(state, codes, rlen, live)
    jax.block_until_ready(out["vote_pass"])
    compile_s = time.time() - t0
    t0 = time.time()
    for _ in range(nsteps):
        state, out = step(state, codes, rlen, live)
    # host scalar fetch: a device->host dependency on the last step's
    # output ends the timed region
    _sink = float(jnp.asarray(state["counts"][:8].sum(), jnp.float32))
    dt_step = time.time() - t0
    rps = nsteps * 2 * P / dt_step
    nref = int(np.asarray(out["referee"]).sum())
    nrt, nro, nr2 = (int(np.asarray(out[k]).sum()) for k in
                     ("referee_tie", "referee_ovf", "referee_t2"))
    print(f"# full step: {rps:.0f} reads/s ({dt_step/nsteps*1e3:.0f} "
          f"ms/step P={P}) compile={compile_s:.0f}s referee={nref}/{P} "
          f"(tie={nrt} ovf={nro} t2={nr2}) device={dev}", file=sys.stderr)
    print(json.dumps({
        "metric": "scale_align_reads_per_sec",
        "value": round(rps, 1),
        "unit": f"reads/s@{nkeys/1e6:.0f}Mkeys",
        "vs_baseline": round(rps / (6.2e8 / (12 * 3600)), 3)}))


if __name__ == "__main__":
    main()
