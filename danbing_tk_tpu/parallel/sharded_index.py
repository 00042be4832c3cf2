"""Index sharding across the device mesh (model parallelism for the RPGG).

The production pan RPGG is ~1.2e9 k-mers; for an index larger than one
device's memory each device holds a 1/D row-block of every hash level
and probes are answered collectively:

    1. all_gather the local query block along the mesh axis
       (every chip sees the global batch of k-mer keys)
    2. each chip probes only the bucket rows it owns (bucket index range
       test + local gather; a key lives in exactly one bucket of one
       level, so exactly one chip can hit it)
    3. psum_scatter the (found, val) planes — the single owner's answer
       survives the sum and lands back on the chip that asked

Per probe this moves the query keys to every device and one answer
back.  This composes with data parallelism: the same "data" axis shards
both the read batch and the index rows (SURVEY.md §2.4: the kmerDBi
hash lookup sharded with k-mer routing).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..engine import device_align as da
from ..engine.host_align import AlignConfig
from ..index import device_table as dt


def shard_table(tab: dt.BucketTable, ndev: int):
    """Row-block split of every level.  Returns (shards, meta):
    shards[d] = list of per-level 2-D arrays (the d-th row block);
    meta = list of (salt, nb_full, rows_per_dev) per level."""
    shards = [[] for _ in range(ndev)]
    meta = []
    for t, salt in tab.levels:
        nb = t.shape[0]
        assert nb % ndev == 0, (nb, ndev)
        rows = nb // ndev
        for d in range(ndev):
            shards[d].append(t[d * rows:(d + 1) * rows])
        meta.append((salt, nb, rows))
    return shards, meta


def sharded_levels(drp: da.DeviceRPGG, name: str, tab: dt.BucketTable,
                   mesh: Mesh):
    """(per-level (D, rows, W) arrays sharded over "data", meta) for one
    table, placed straight from host memory and memoized on the
    DeviceRPGG (the primary step, retry tiers and prefilter share it)."""
    from .mesh import mesh_key

    ndev = mesh.devices.size
    sharding = NamedSharding(mesh, P("data"))

    def place():
        shards, meta = shard_table(tab, ndev)
        return [jax.device_put(np.stack([shards[d][lv]
                                         for d in range(ndev)]), sharding)
                for lv in range(len(meta))], meta

    return drp.dev(("shard", name, mesh_key(mesh)), place)


def lookup_bucket_sharded(local_levels, meta, composite, q_lo, q_hi,
                          q_loc=None, axis="data", nval: int = 1):
    """Collective probe inside shard_map.  q_* are this chip's local
    query block; always returns (found, val, val2) for that block —
    val2 is zeros when the table has no second value plane (nval < 2),
    keeping call-site arity fixed."""
    d = jax.lax.axis_index(axis)
    B = q_lo.shape[0]
    g_lo = jax.lax.all_gather(q_lo, axis, tiled=True)
    g_hi = jax.lax.all_gather(q_hi, axis, tiled=True)
    g_loc = None
    if q_loc is not None:
        g_loc = jax.lax.all_gather(q_loc, axis, tiled=True)

    W = 2 + int(composite) + nval
    vp = 2 + int(composite)
    found = jnp.zeros(g_lo.shape, dtype=jnp.bool_)
    val = jnp.zeros(g_lo.shape, dtype=jnp.uint32)
    val2 = jnp.zeros(g_lo.shape, dtype=jnp.uint32) if nval == 2 else None
    for t, (salt, nb, rows) in zip(local_levels, meta):
        b = dt.bucket_index_jax(g_lo, g_hi, g_loc, salt, nb)
        off = d * rows
        mine = (b >= off) & (b < off + rows)
        bl = jnp.clip(b - off, 0, rows - 1)
        rows_g = t[bl].reshape(bl.shape + (dt.BUCKET, W))
        m = (rows_g[..., 0] == g_lo[..., None]) & \
            (rows_g[..., 1] == g_hi[..., None])
        if composite:
            m &= rows_g[..., 2] == g_loc[..., None]
        m &= mine[..., None]
        hit = m.any(axis=-1)
        new = hit & ~found
        if nval >= 1:
            v = jnp.where(m, rows_g[..., vp], 0).max(axis=-1)
            val = jnp.where(new, v, val)
        if nval == 2:
            v2 = jnp.where(m, rows_g[..., vp + 1], 0).max(axis=-1)
            val2 = jnp.where(new, v2, val2)
        found = found | hit
    # exactly one chip can own a key's bucket -> sums recover the answer
    found = jax.lax.psum_scatter(
        found.astype(jnp.int32), axis, scatter_dimension=0, tiled=True) > 0
    val = jax.lax.psum_scatter(
        val.astype(jnp.int32), axis, scatter_dimension=0,
        tiled=True).astype(jnp.uint32)
    if nval == 2:
        val2 = jax.lax.psum_scatter(
            val2.astype(jnp.int32), axis, scatter_dimension=0,
            tiled=True).astype(jnp.uint32)
    else:
        val2 = jnp.zeros_like(val)
    return found[:B], val[:B], val2[:B]


def make_sharded_prefilter(drp: da.DeviceRPGG, cfg: AlignConfig,
                           mesh: Mesh, P_global: int, L: int):
    """Genome-wide prefilter with BOTH the read batch and the kmerDBi
    sharded over the mesh — the configuration for indexes larger than a
    single device's memory.  Decision-identical to the replicated prefilter.

    Returns (step(codes, rlen, live) -> survive (P_global,), P_local).
    """
    ndev = mesh.devices.size
    assert P_global % ndev == 0
    P_local = P_global // ndev
    k, nf, nmf = cfg.ksize, cfg.n_filter, cfg.nm_filter
    ptab = drp.member_tab if drp.member_tab is not None else drp.dbi_tab
    # per-level shards with a leading device axis; shard_map slices each
    # device its own row block
    stacked, meta = sharded_levels(drp, "pre", ptab, mesh)
    nlv = len(meta)

    def local(codes_l, rlen_l, live_l, *tabs_l):
        levels = [t[0] for t in tabs_l]
        qlo, qhi, valid, nk = da.prefilter_sample(codes_l, rlen_l, k, nf, L)
        q_shape = qlo.shape
        found = lookup_bucket_sharded(
            levels, meta, ptab.composite,
            qlo.reshape(-1), qhi.reshape(-1),
            nval=getattr(ptab, "nval", 1))[0]
        found = found.reshape(q_shape)
        return da.prefilter_decide(found, valid, nk, live_l, nmf, P_local)

    @jax.jit
    def step(stacked, codes, rlen, live):
        return jax.shard_map(
            local, mesh=mesh,
            in_specs=(P("data"), P("data"), P("data"))
            + tuple(P("data") for _ in range(nlv)),
            out_specs=P("data"), check_vma=False,
        )(codes, rlen, live, *stacked)

    return (lambda codes, rlen, live: step(stacked, codes, rlen, live),
            P_local)
