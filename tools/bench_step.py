#!/usr/bin/env python
"""Focused full-step timer on the 512-locus bench panel (run on the
accelerator).

Env: DTK_BS_P=4096 DTK_BS_E=512 DTK_BS_STEPS=8 DTK_SPLIT_EXPAND=0|1
     DTK_BS_ERR=0.0
Reports steady ms/step + referee/overflow counts — the A/B harness for
vote-stage experiments (payload packing, split expansion)."""

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
    from danbing_tk_tpu.apps.fa2kmers import read_fasta_seqs
    from danbing_tk_tpu.engine import device_align as da
    from danbing_tk_tpu.engine.host_align import AlignConfig, RPGG
    from danbing_tk_tpu.ops import kmers_np as K
    from tools.make_bench_rpgg import build

    root = os.path.join(os.path.dirname(__file__), "..")
    P = int(os.environ.get("DTK_BS_P", 4096))
    E = int(os.environ.get("DTK_BS_E", 512))
    nsteps = int(os.environ.get("DTK_BS_STEPS", 8))
    err = float(os.environ.get("DTK_BS_ERR", 0.0))
    L = 160
    pan = build(os.path.join(root, "build", "bench_rpgg"), 512)
    rpgg = RPGG(pan)
    cfg = AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1)
    drp = da.DeviceRPGG.build(rpgg, with_tre=False)
    step = da.make_step(drp, cfg, P, L, expand_cap=E, with_annot=False)
    state = da.init_state(drp)

    rng = np.random.default_rng(1)
    seqs = read_fasta_seqs(os.path.join(os.path.dirname(pan), "hap0.fa"))
    codes = np.full((2 * P, L), 255, dtype=np.uint8)
    rlen = np.full(2 * P, L, dtype=np.int32)
    comp = str.maketrans("ACGT", "TGCA")
    FLEN = 500
    for i in range(P):
        s = seqs[int(rng.integers(0, len(seqs)))]
        beg = int(rng.integers(0, max(len(s) - FLEN, 1)))
        r1 = s[beg: beg + L]
        r2 = s[beg + FLEN - L: beg + FLEN][::-1].translate(comp)
        for m, r in ((0, r1), (1, r2)):
            cs = K.encode_bases(r)
            if err:
                hit = np.flatnonzero(rng.random(len(cs)) < err)
                cs = cs.copy()
                cs[hit] = (cs[hit] + rng.integers(
                    1, 4, len(hit)).astype(np.uint8)) % 4
            codes[2 * i + m, : len(cs)] = cs
            rlen[2 * i + m] = len(cs)
    codes = jax.device_put(jnp.asarray(codes))
    rlen = jax.device_put(jnp.asarray(rlen))
    live = jax.device_put(jnp.asarray(np.ones(P, dtype=bool)))

    t0 = time.time()
    state, out = step(state, codes, rlen, live)
    jax.block_until_ready(out["vote_pass"])
    compile_s = time.time() - t0
    t0 = time.time()
    for _ in range(nsteps):
        state, out = step(state, codes, rlen, live)
    jax.block_until_ready((state["counts"], out["vote_pass"]))
    dt = time.time() - t0
    nref = int(np.asarray(out["referee"]).sum())
    novf = int(np.asarray(out["referee_ovf"]).sum())
    print(f"P={P} E={E} split={os.environ.get('DTK_SPLIT_EXPAND', '0')} "
          f"err={err} compile={compile_s:.1f}s "
          f"steady={dt/nsteps*1e3:.2f} ms/step "
          f"({nsteps*2*P/dt:.0f} reads/s) referee={nref}/{P} ovf={novf}")


if __name__ == "__main__":
    main()
