"""Multi-chip execution: shard_map data parallelism over a device mesh.

Mapping of the reference's parallelism inventory (SURVEY.md §2.4) onto a
device mesh:
  X1 (pthread pool + semaphores)  -> read batches data-parallel over the
                                     "data" mesh axis; host streaming feeds
                                     all chips
  X2 (atomic scatter-increment)   -> per-device scatter-add into a
                                     device-local count shard; cross-chip
                                     merge is one reduction at finalize
                                     (counts are commutative, so no per-batch
                                     collective traffic)
  X4 (Snakemake/sbatch scale-out) -> multi-host: each host runs a runner on
                                     its local devices; final counts merged
                                     with a single all-reduce

The RPGG tables are replicated per device by default (device-resident,
passed to the step as jit arguments).  For indexes beyond one device's
memory, make_sharded_step(shard_index=True) shards the dbi + trfl hash
tables over the same mesh axis and answers probes collectively
(parallel/sharded_index.py).  The mesh is one flat "data" axis: the
devices of one host are joined all to all, so no axis follows a link
topology.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..engine import device_align as da
from ..engine.host_align import AlignConfig


def make_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), axis_names=("data",))


def make_sharded_step(drp: da.DeviceRPGG, cfg: AlignConfig, mesh: Mesh,
                      P_global: int, L: int, expand_cap: int = 512,
                      with_annot: bool = True, with_bubbles: bool = False,
                      shard_index: bool = False, with_qual: bool = False):
    """Data-parallel batch step over the mesh.

    state arrays carry a leading device axis sharded over "data"; inputs
    are sharded along the pair axis; per-pair outputs come back sharded
    (logically concatenated in pair order).

    shard_index=True additionally shards the dbi + trfl hash tables over
    the same axis (1/D of every level's rows per chip) and answers their
    probes collectively — the configuration for indexes larger than one
    device's memory (see parallel/sharded_index.py).
    """
    ndev = mesh.devices.size
    assert P_global % ndev == 0
    # the annotation fast path reads the dbi row's second value plane
    # (ev_hit), and dbi_probe unpacks three planes unconditionally —
    # an older single-plane table would silently mis-annotate, so
    # refuse it up front (round-2 advice)
    assert getattr(drp.dbi_tab, "nval", 1) == 2, \
        "device dbi table must carry the annotation value plane (nval=2)"
    P_local = P_global // ndev

    tab_args = ()
    if shard_index:
        from . import sharded_index as si

        metas = {}
        stacks = {}
        for name in ("dbi", "trfl"):
            tab = getattr(drp, f"{name}_tab")
            stacks[name], meta = si.sharded_levels(drp, name, tab, mesh)
            metas[name] = (meta, tab.composite)
        nlv = {name: len(metas[name][0]) for name in stacks}
        tab_args = tuple(t for name in ("dbi", "trfl")
                         for t in stacks[name])
        ctx = {}

        def dbi_probe(q_lo, q_hi):
            meta, comp = metas["dbi"]
            f, v, a = si.lookup_bucket_sharded(
                ctx["dbi"], meta, comp,
                q_lo.reshape(-1), q_hi.reshape(-1),
                nval=drp.dbi_tab.nval)
            return (f.reshape(q_lo.shape), v.reshape(q_lo.shape),
                    a.reshape(q_lo.shape))

        def trfl_probe(q_lo, q_hi, q_loc):
            meta, comp = metas["trfl"]
            f, v, _ = si.lookup_bucket_sharded(
                ctx["trfl"], meta, comp, q_lo.reshape(-1),
                q_hi.reshape(-1), q_loc=q_loc.reshape(-1))
            return f.reshape(q_lo.shape), v.reshape(q_lo.shape)

        probe_fns = {"dbi": dbi_probe, "trfl": trfl_probe}
    else:
        probe_fns = None

    local_step, local_tabs = da.make_step(
        drp, cfg, P_local, L, expand_cap=expand_cap, with_annot=with_annot,
        with_bubbles=with_bubbles, jit=False, probe_fns=probe_fns,
        with_qual=with_qual)
    # the replicated tables ride as jit arguments too, one copy per device
    rep_tabs = replicated(drp, mesh, local_tabs)

    @jax.jit
    def sharded_step(rep_tabs, state, codes, rlen, live, qmask=None):
        def per_device(tabs_l, state_l, codes_l, rlen_l, live_l, *rest):
            if with_qual:
                qmask_l, sh_l = rest[0], rest[1:]
            else:
                qmask_l, sh_l = None, rest
            if shard_index:
                it = iter(sh_l)
                for name in ("dbi", "trfl"):
                    ctx[name] = [next(it)[0] for _ in range(nlv[name])]
            state_l = jax.tree.map(lambda x: x[0], state_l)
            new_state, out = local_step(tabs_l, state_l, codes_l, rlen_l,
                                        live_l, qmask=qmask_l)
            new_state = jax.tree.map(lambda x: x[None], new_state)
            return new_state, out

        extra = (qmask,) if with_qual else ()
        return jax.shard_map(
            per_device,
            mesh=mesh,
            in_specs=(P(), P("data"), P("data"), P("data"), P("data"))
            + tuple(P("data") for _ in extra)
            + tuple(P("data") for _ in tab_args),
            out_specs=(P("data"), P("data")),
            check_vma=False,
        )(rep_tabs, state, codes, rlen, live, *extra, *tab_args)

    if with_qual:
        return (lambda state, codes, rlen, live, qmask:
                sharded_step(rep_tabs, state, codes, rlen, live,
                             qmask)), P_local
    return (lambda state, codes, rlen, live:
            sharded_step(rep_tabs, state, codes, rlen, live)), P_local


def mesh_key(mesh: Mesh) -> tuple:
    return tuple(int(d.id) for d in mesh.devices.flat)


def replicated(drp: da.DeviceRPGG, mesh: Mesh, tabs: dict) -> dict:
    """One copy of each table on every mesh device, memoized on the
    DeviceRPGG so the primary step and every retry tier share it."""
    rep = NamedSharding(mesh, P())
    key = mesh_key(mesh)
    return {name: drp.dev(("rep", name, key),
                          lambda t=t: jax.device_put(t, rep))
            for name, t in tabs.items()}


def init_sharded_state(drp: da.DeviceRPGG, mesh: Mesh):
    ndev = mesh.devices.size
    state = da.init_state(drp)
    state = jax.tree.map(
        lambda x: jnp.broadcast_to(jnp.zeros_like(x), (ndev,) + x.shape),
        state)
    shard = NamedSharding(mesh, P("data"))
    return jax.device_put(state, shard)


def finalize_counts(state) -> dict:
    """Merge per-device accumulators (single cross-chip reduction)."""
    return {k: np.asarray(v).sum(axis=0) for k, v in state.items()}
