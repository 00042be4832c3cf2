#!/usr/bin/env python
"""Stage breakdown of the current step on the 512-locus bench RPGG
(DEBUG_STOP bisect; run on the accelerator, one stage per jit)."""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import jax
import jax.numpy as jnp
import numpy as np

from danbing_tk_tpu.engine import device_align as da
from danbing_tk_tpu.engine.host_align import AlignConfig, RPGG
from danbing_tk_tpu.ops import kmers_np as K
from tools.make_bench_rpgg import build

root = os.path.join(os.path.dirname(__file__), "..")
P, L = 4096, 160
pan = build(os.path.join(root, "build", "bench_rpgg"), 512)
rpgg = RPGG(pan)
cfg = AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1)
drp = da.DeviceRPGG.build(rpgg, with_tre=False)

from danbing_tk_tpu.apps.fa2kmers import read_fasta_seqs
rng = np.random.default_rng(1)
seqs = read_fasta_seqs(os.path.join(os.path.dirname(pan), "hap0.fa"))
codes = np.full((2 * P, L), 255, dtype=np.uint8)
rlen = np.full(2 * P, L, dtype=np.int32)
for i in range(2 * P):
    s = seqs[int(rng.integers(0, len(seqs)))]
    beg = int(rng.integers(0, max(len(s) - L, 1)))
    cs = K.encode_bases(s[beg : beg + L])
    codes[i, : len(cs)] = cs
    rlen[i] = len(cs)
codes = jax.device_put(jnp.asarray(codes))
rlen = jax.device_put(jnp.asarray(rlen))
live = jax.device_put(jnp.asarray(np.ones(P, dtype=bool)))

stages = [s for s in os.environ.get(
    "DTK_STAGES", "probe,vote_sort1,vote_expand,vote,annot,assign,full"
).split(",") if s]
prev = 0.0
for stage in stages:
    da.DEBUG_STOP = None if stage == "full" else stage
    step = da.make_step(drp, cfg, P, L, with_annot=False)
    state = da.init_state(drp)
    t0 = time.time()
    state, out = step(state, codes, rlen, live)
    jax.block_until_ready(out)
    ct = time.time() - t0
    t0 = time.time()
    n = 6
    for _ in range(n):
        state, out = step(state, codes, rlen, live)
    jax.block_until_ready(out)
    rt = (time.time() - t0) / n * 1e3
    print(f"{stage:12s} compile {ct:6.1f}s cumulative {rt:8.2f} ms "
          f"(delta {rt - prev:+7.2f})", flush=True)
    prev = rt
