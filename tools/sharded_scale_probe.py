#!/usr/bin/env python
"""Sharded-index probe path at PRODUCTION table size.

Round 2 validated `parallel/sharded_index.py` only at toy sizes; this
loads a production-scale index (the full 1.2e9-slot build from
tools/build_full_index.py if present, else the 115M-key npz cache),
shards the dbi table over an 8-way virtual CPU mesh (multi-GB per-chip
row blocks), and asserts:

  1. collective probe == host lookup on a mixed hit/miss query batch
     (found, val, val2 planes all equal)
  2. sharded prefilter decisions == replicated prefilter decisions on a
     WGS-shaped read batch

Run: JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
     python tools/sharded_scale_probe.py
Env: DTK_SP_FULLDIR (full-index dir), DTK_SP_NLOCI/KPL (npz fallback),
     DTK_SP_B (global query batch, default 65536).
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from danbing_tk_tpu.engine import device_align as da
    from danbing_tk_tpu.engine.host_align import AlignConfig
    from danbing_tk_tpu.index import device_table as dt
    from danbing_tk_tpu.parallel import sharded_index as si
    from tools.make_scale_index import (build_scale_rpgg_cached,
                                        load_full_tables,
                                        sample_read_batch)

    full = os.environ.get(
        "DTK_SP_FULLDIR",
        os.path.join(os.path.dirname(__file__), "..", "build",
                     "full_index_80000_15000"))
    t0 = time.time()
    if os.path.isdir(full) and os.path.exists(
            os.path.join(full, "manifest.json")):
        drp, seqs, man = load_full_tables(full, mmap=False)
        prov = f"full 1.2e9-slot index ({full})"
    else:
        nloci = int(os.environ.get("DTK_SP_NLOCI", 80_000))
        kpl = int(os.environ.get("DTK_SP_KPL", 1500))
        drp, seqs = build_scale_rpgg_cached(nloci, kpl)
        prov = f"{nloci}-locus npz cache"
    print(f"# index: {prov}, dbi {drp.dbi_tab.nbytes/1e9:.2f} GB "
          f"({len(drp.dbi_tab.levels)} levels), loaded "
          f"{time.time()-t0:.0f}s", file=sys.stderr)

    ndev = len(jax.devices())
    mesh = Mesh(np.array(jax.devices()), ("data",))
    B = int(os.environ.get("DTK_SP_B", 65_536))
    rng = np.random.default_rng(7)

    # ---- 1. collective probe == host lookup (hits + misses) ----
    # sample real keys straight off level-0 rows + random misses
    t_lv0, _ = drp.dbi_tab.levels[0]
    W = 2 + int(drp.dbi_tab.composite) + drp.dbi_tab.nval
    r0 = np.asarray(t_lv0).reshape(-1, W)
    live_rows = np.flatnonzero(r0[:, 1] != dt.EMPTY)
    pick = live_rows[rng.integers(0, len(live_rows), B // 2)]
    hit_keys = (r0[pick, 0].astype(np.uint64)
                | (r0[pick, 1].astype(np.uint64) << 32))
    miss_keys = rng.integers(0, 1 << 42, B - B // 2, dtype=np.uint64)
    keys = np.concatenate([hit_keys, miss_keys])
    rng.shuffle(keys)
    qlo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    qhi = (keys >> np.uint64(32)).astype(np.uint32)

    fh, vh, v2h = dt.lookup_bucket_np(drp.dbi_tab, keys)
    print(f"# host lookup: {int(fh.sum())}/{B} hits", file=sys.stderr)

    shards, meta = si.shard_table(drp.dbi_tab, ndev)
    nlv = len(meta)
    stacked = [np.stack([shards[d][lv] for d in range(ndev)])
               for lv in range(nlv)]
    per_dev = sum(s.nbytes for s in shards[0])
    print(f"# shards: {per_dev/1e9:.2f} GB/device x {ndev}",
          file=sys.stderr)
    del shards

    def local(qlo_l, qhi_l, *tabs_l):
        levels = [t[0] for t in tabs_l]
        return si.lookup_bucket_sharded(
            levels, meta, drp.dbi_tab.composite, qlo_l, qhi_l,
            nval=drp.dbi_tab.nval)

    t0 = time.time()
    fs, vs, v2s = jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(P("data"), P("data")) + tuple(
            P("data") for _ in range(nlv)),
        out_specs=(P("data"), P("data"), P("data")),
        check_vma=False))(qlo, qhi, *stacked)
    fs, vs, v2s = (np.asarray(x) for x in (fs, vs, v2s))
    dt_probe = time.time() - t0
    assert np.array_equal(fs, fh), "sharded found != host"
    assert np.array_equal(vs[fh], vh[fh]), "sharded val != host"
    assert np.array_equal(v2s[fh], v2h[fh]), "sharded val2 != host"
    print(f"# collective probe == host lookup on {B} queries "
          f"({int(fh.sum())} hits) in {dt_probe:.0f}s (incl compile)",
          file=sys.stderr, flush=True)

    # ---- 2. sharded prefilter decisions == host/replicated ----
    cfg = AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1)
    Pp, L = 1024, 150
    codes, rlen = sample_read_batch(np.asarray(seqs[:4096]), Pp, L, rng,
                                    frac_tr=0.5)
    live = np.ones(Pp, bool)
    if drp.dbi_tab.nbytes > 16e9:
        # FULL-index path: the integration prefilter step would need two
        # more whole-table copies (replicated device + re-sharded) on
        # top of the loaded host tables — that OOMs a 125 GB host at
        # 36.5 GB/dbi.  Instead drive the prefilter DECISION math over
        # the already-sharded collective probe (the exact lookups the
        # sharded prefilter wires through probe_fns) and compare against
        # the pure-host decision.
        from danbing_tk_tpu.ops.kmers_np import sample_subfilter_queries

        sqlo, sqhi, svalid, snonshort = sample_subfilter_queries(
            codes, rlen, cfg.ksize, cfg.n_filter)
        Bq = sqlo.size
        pad = (-Bq) % ndev
        qlo_p = np.concatenate([sqlo.ravel(),
                                np.full(pad, 0xFFFFFFFF, np.uint32)])
        qhi_p = np.concatenate([sqhi.ravel(),
                                np.full(pad, 0xFFFFFFFF, np.uint32)])
        fsh = np.asarray(jax.jit(jax.shard_map(
            local, mesh=mesh,
            in_specs=(P("data"), P("data")) + tuple(
                P("data") for _ in range(nlv)),
            out_specs=(P("data"), P("data"), P("data")),
            check_vma=False))(qlo_p, qhi_p, *stacked)[0])[:Bq]
        found_sh = fsh.reshape(svalid.shape) & svalid
        read_pass = found_sh.sum(axis=1) >= cfg.nm_filter
        s_sh = (read_pass & snonshort).reshape(Pp, 2).all(axis=1) & live
        skeys = (sqlo.astype(np.uint64)
                 | (sqhi.astype(np.uint64) << 32)).ravel()
        fh2 = dt.lookup_bucket_np(drp.dbi_tab, skeys)[0]
        found_h = fh2.reshape(svalid.shape) & svalid
        s_host = ((found_h.sum(axis=1) >= cfg.nm_filter)
                  & snonshort).reshape(Pp, 2).all(axis=1) & live
        assert np.array_equal(s_host, s_sh), \
            "sharded prefilter decisions != host"
        nsurv = int(s_sh.sum())
    else:
        s_rep = np.asarray(da.make_prefilter_step(drp, cfg, Pp, L)(
            codes, rlen, live))
        step_sh, _pl = si.make_sharded_prefilter(drp, cfg, mesh, Pp, L)
        s_sh = np.asarray(step_sh(codes, rlen, live))
        assert np.array_equal(s_rep, s_sh), \
            "sharded prefilter != replicated"
        nsurv = int(s_rep.sum())
    print(f"# sharded prefilter decision-identical on {Pp} pairs "
          f"({nsurv} survive)", file=sys.stderr, flush=True)
    print("SHARDED-SCALE-PROBE-OK "
          f"dbi={drp.dbi_tab.nbytes/1e9:.2f}GB shard={per_dev/1e9:.2f}GB"
          f" x{ndev}", flush=True)


if __name__ == "__main__":
    main()
