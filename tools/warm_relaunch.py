#!/usr/bin/env python
"""Warm-relaunch decomposition at production index scale.

A warm relaunch's first pass against the 115M-key index pays host
loads, the table upload and program loads before steady state.  This
tool times each stage separately:

  1. index npz load (host)                 build/scale_*.npz
  2. flat host view load (host)            build/flat_*.npz
  3. device table upload (jax.device_put of every table level, blocked)
  4. compiled-program load + first dispatch (persistent-cache hit path)
  5. second dispatch (steady step, for contrast)
  6. first full 2M-pair funnel pass (what PERF calls "warm first pass")

Run on the device with the compile cache warm; the stage sums
attribute the first-pass wall and give the effective upload bandwidth.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from danbing_tk_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from danbing_tk_tpu.engine.align_runner import DeviceAlignRunner
    from danbing_tk_tpu.engine.flat_rpgg import FlatRPGG
    from danbing_tk_tpu.engine.host_align import AlignConfig
    from tools.make_scale_index import build_scale_rpgg_cached

    ROOT = os.path.join(os.path.dirname(__file__), "..")
    nloci = int(os.environ.get("DTK_SF_NLOCI", 80_000))
    kpl = int(os.environ.get("DTK_SF_KPL", 1500))
    P = int(os.environ.get("DTK_SF_P", 4096))
    E = int(os.environ.get("DTK_SF_E", 768))
    stages = {}

    t0 = time.time()
    drp, seqs = build_scale_rpgg_cached(nloci, kpl)
    del seqs
    stages["index_npz_load_s"] = round(time.time() - t0, 1)

    t0 = time.time()
    flat = FlatRPGG.from_device_tables_cached(
        drp, os.path.join(ROOT, "build", f"flat_{nloci}_{kpl}_v1.npz"))
    stages["flat_view_load_s"] = round(time.time() - t0, 1)

    # ---- stage 3: explicit device upload of every table level ----
    t0 = time.time()
    nbytes = 0
    devarrs = []
    for name in ("dbi_tab", "trfl_tab", "tre_tab", "graph_tab"):
        tab = getattr(drp, name, None)
        if tab is None:
            continue
        for lvl, _salt in tab.levels:
            a = jax.device_put(np.asarray(lvl))
            devarrs.append(a)
            nbytes += a.nbytes
    vv = jax.device_put(np.asarray(drp.vv))
    devarrs.append(vv)
    nbytes += vv.nbytes
    jax.block_until_ready(devarrs)
    dt = time.time() - t0
    stages["table_upload_s"] = round(dt, 1)
    stages["table_upload_gb"] = round(nbytes / 1e9, 2)
    stages["upload_gbps"] = round(nbytes / 1e9 / dt, 2)

    # ---- stage 4/5: program load (cache hit) + dispatch ----
    cfg = AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1,
                      okam=False)
    t0 = time.time()
    al = DeviceAlignRunner(flat, cfg, batch_pairs=P, max_read_len=160,
                           expand_cap=E, retry_expand=[], drp=drp)
    stages["runner_build_s"] = round(time.time() - t0, 1)

    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, (2 * P, 160), dtype=np.uint8)
    rlen = np.full(2 * P, 150, np.int32)
    live = np.ones(P, bool)
    t0 = time.time()
    state, out = al.step(al.state, jnp.asarray(codes), jnp.asarray(rlen),
                         jnp.asarray(live))
    jax.block_until_ready(out["referee_pack"])
    stages["first_dispatch_s"] = round(time.time() - t0, 1)
    al.state = state
    t0 = time.time()
    state, out = al.step(al.state, jnp.asarray(codes), jnp.asarray(rlen),
                         jnp.asarray(live))
    jax.block_until_ready(out["referee_pack"])
    stages["steady_dispatch_s"] = round(time.time() - t0, 2)
    al.state = state

    # ---- stage 6: first full funnel pass (the PERF "warm first pass")
    reads = os.path.join(
        ROOT, "build", "sf_80000_1500_2000000_0.05_0.002_real.fa")
    if os.path.exists(reads):
        al2 = DeviceAlignRunner(flat, cfg, batch_pairs=P,
                                max_read_len=160, expand_cap=E,
                                retry_expand=[4096], drp=drp)
        t0 = time.time()
        al2.run_file_native(reads, prefilter=True)
        stages["first_funnel_pass_s"] = round(time.time() - t0, 1)

    print(json.dumps({"metric": "warm_relaunch_decomposition",
                      **stages}), flush=True)


if __name__ == "__main__":
    main()
