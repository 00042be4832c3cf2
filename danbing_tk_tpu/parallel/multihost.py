"""Multi-host scale-out for align (replaces the reference's
Snakemake/sbatch node fan-out, SURVEY §2.4 X4).

Counts are commutative, so the multi-host recipe is embarrassingly
simple and fault-tolerant:

  1. shard the input stream by host: host i of H processes batch b when
     b % H == i (or pre-split FASTQ shards; `shard_predicate`)
  2. each host runs its DeviceAlignRunner over its local mesh
     (parallel/mesh.py), periodically checkpointing
  3. final per-locus counts = elementwise sum of every host's flat count
     array (`merge_count_files`), either via files on shared storage or
     one jax.distributed psum at the end

With jax.distributed initialized (multi-controller, `init_distributed`),
`global_merge` does the final reduction over the coordination service;
otherwise file-based merging works across any scheduler.
"""

from __future__ import annotations

import glob

import numpy as np

from ..io import binary as bio


def init_distributed(port: int, nproc: int, pid: int) -> None:
    """jax.distributed over localhost with one device per process:
    process ``pid`` sees only local device ``pid``.  A GPU process
    reserves most of its card's memory when it starts, so a second
    process on the same card would fail for want of memory.  (The CPU
    backend ignores the device pinning.)"""
    import jax

    jax.distributed.initialize(f"localhost:{port}", num_processes=nproc,
                               process_id=pid, local_device_ids=[pid])


def shard_predicate(host_id: int, nhosts: int):
    """Batch-level round-robin sharding predicate."""
    return lambda batch_index: batch_index % nhosts == host_id


def save_host_counts(path: str, runner) -> None:
    bio.write_karray(path, runner.flat_counts())


def merge_count_files(pattern: str) -> np.ndarray:
    """Sum per-host .ar count files (shared-filesystem merge)."""
    paths = sorted(glob.glob(pattern))
    assert paths, pattern
    total = bio.read_karray(paths[0]).astype(np.uint64)
    for p in paths[1:]:
        total = total + bio.read_karray(p)
    return total


def global_merge(local_counts):
    """Cross-host reduction of the final count vector (requires
    jax.distributed.initialize on every host): all-gather one row per
    process, sum on host.  Counts are integers and addition is
    exact/commutative, so the merged vector is byte-equal to a
    single-process run regardless of shard order.

    Note a shard_map psum over the *global* device mesh would be wrong
    here: each host contributes ONE local vector, not one per local
    device, and P(None) "replicated" inputs that differ per host would
    multiply by the per-host device count.
    """
    import jax

    local = np.asarray(local_counts)
    if jax.process_count() == 1:
        return local
    from jax.experimental import multihost_utils

    rows = np.asarray(multihost_utils.process_allgather(local))
    return rows.sum(axis=0).astype(local.dtype)
