"""Multi-chip production runner: the FULL funnel loop (native ingest ->
prefilter window -> dense survivor repack -> full pipeline -> device
retry -> host referee -> checkpoint -> finalize) executing over a
jax.sharding.Mesh.

This is DeviceAlignRunner with the device programs swapped for their
mesh-parallel twins (SURVEY §2.4 parallelism mapping):
  * the full step runs under shard_map: read pairs sharded over "data",
    per-device count-state shards, RPGG tables replicated — or, with
    ``shard_index=True``, the dbi/trfl hash tables row-sharded over the
    same axis with collective probes (parallel/sharded_index.py), the
    configuration for indexes larger than one device's memory
  * the prefilter is a jit with data-sharded inputs (GSPMD partitions
    the probe gathers; no collectives needed with replicated tables)
  * finalize merges the per-device count shards with one reduction —
    byte-equal outputs to the single-device runner (tested on the 8-way
    virtual mesh)

The host side (reader, repack buffers, referee, checkpoints, bubble
maps) is unchanged — counts are commutative, so the only cross-shard
interaction is the final merge.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..engine import device_align as da
from ..engine.align_runner import DeviceAlignRunner
from . import mesh as pm


class ShardedAlignRunner(DeviceAlignRunner):
    def __init__(self, rpgg, cfg, mesh=None, batch_pairs: int = 4096,
                 max_read_len: int = 256, expand_cap: int = 512,
                 retry_expand: int = 0, shard_index: bool = False,
                 drp=None):
        self.mesh = mesh if mesh is not None else pm.make_mesh()
        self.shard_index = shard_index
        self.ndev = self.mesh.devices.size
        assert batch_pairs % self.ndev == 0, (batch_pairs, self.ndev)
        super().__init__(rpgg, cfg, batch_pairs=batch_pairs,
                         max_read_len=max_read_len,
                         expand_cap=expand_cap,
                         retry_expand=retry_expand, drp=drp)

    # -- hooks --

    def _sharding(self):
        return NamedSharding(self.mesh, P("data"))

    def _tier_P(self, E: int) -> int:
        # keep retry-tier batches mesh-divisible
        base = super()._tier_P(E)
        return max(self.ndev, (base // self.ndev) * self.ndev)

    def _build_step(self, expand_cap, with_annot, with_qual, P=None):
        cfg = self.cfg
        step, _ = pm.make_sharded_step(
            self.drp, cfg, self.mesh, P or self.P, self.L,
            expand_cap=expand_cap, with_annot=with_annot,
            with_bubbles=cfg.output_bubbles,
            shard_index=self.shard_index, with_qual=with_qual)
        # host batches arrive as numpy; under jax.distributed a jit may
        # not infer non-trivial shardings for numpy args, so place them
        # on the mesh explicitly
        sh = self._sharding()

        def wrapped(state, codes, rlen, live, *qm):
            args = [jax.device_put(a, sh) for a in (codes, rlen, live,
                                                    *qm)]
            return step(state, *args)

        return wrapped

    def _init_state(self):
        return pm.init_sharded_state(self.drp, self.mesh)

    def _build_prefilter(self, Pp: int):
        cfg = self.cfg
        if self.shard_index:
            from .sharded_index import make_sharded_prefilter

            step, _ = make_sharded_prefilter(self.drp, cfg, self.mesh,
                                             Pp, self.L)
            sh = self._sharding()
            return lambda codes, rlen, live: step(
                jax.device_put(codes, sh), jax.device_put(rlen, sh),
                jax.device_put(live, sh))
        # replicated tables: plain jit with data-sharded inputs — GSPMD
        # splits the probe gathers across the mesh, tables replicate
        raw, tabs = da.make_prefilter_step(self.drp, cfg, Pp, self.L,
                                           jit=False)
        tabs = pm.replicated(self.drp, self.mesh, {"pre": tabs})["pre"]
        sh = self._sharding()
        rep = NamedSharding(self.mesh, P())
        jitted = jax.jit(raw, in_shardings=(rep, sh, sh, sh))
        return lambda codes, rlen, live: jitted(
            tabs, jax.device_put(codes, sh), jax.device_put(rlen, sh),
            jax.device_put(live, sh))

    def _dev_state(self, key: str) -> np.ndarray:
        # per-device shards carry a leading mesh axis; one reduction
        return np.asarray(self.state[key]).sum(axis=0)

    def _load_checkpoint(self, path):
        cursor, extra = super()._load_checkpoint(path)
        # base restore loses the mesh placement; re-shard the stacked
        # per-device accumulators over "data"
        sh = NamedSharding(self.mesh, P("data"))
        self.state = {k: jax.device_put(jnp.asarray(v), sh)
                      for k, v in self.state.items()}
        return cursor, extra
