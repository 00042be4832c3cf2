#!/usr/bin/env python
"""One controller of a multi-process genotyping run (SURVEY §2.4 X4).

Usage: multihost_worker.py PID NPROC PORT READS PAN OUTDIR

Initializes jax.distributed against localhost:PORT (process PID on local
device PID), aligns this
process's round-robin shard of the PE read pairs, and global_merge()s
the per-locus counts across all processes; every process writes the
merged vector to OUTDIR/merged.<pid>.npy (they must be identical, and
byte-equal to a single-process run — tests/test_multihost_distributed.py).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    pid, nproc = int(sys.argv[1]), int(sys.argv[2])
    port, reads, pan, outdir = sys.argv[3:7]

    import jax

    from danbing_tk_tpu.parallel.multihost import init_distributed

    init_distributed(int(port), nproc, pid)

    import numpy as np

    from danbing_tk_tpu.engine.host_align import (AlignConfig, HostAligner,
                                                  RPGG)
    from danbing_tk_tpu.parallel.multihost import (global_merge,
                                                   shard_predicate)

    # pre-split shard: route by pair identity (the aligner pairs records
    # via a title hashmap, host_align.iter_fasta_pairs) so both mates of
    # a pair land on the same host; shard_predicate over a stable digest
    # of the pruned title
    import zlib

    from danbing_tk_tpu.engine.host_align import prune_pe_info

    keep = shard_predicate(pid, nproc)
    shard = os.path.join(outdir, f"shard.{pid}.fa")
    with open(reads) as f, open(shard, "w") as out:
        lines = f.read().splitlines()
        for i in range(0, len(lines), 2):
            pair_title = prune_pe_info(lines[i])
            if keep(zlib.crc32(pair_title.encode())):
                out.write("\n".join(lines[i:i + 2]) + "\n")

    cfg = AlignConfig(ksize=21, cth=20, okam=False, nm_tr=20)
    ckpt = os.environ.get("DTK_WORKER_CKPT")
    if ckpt:
        # crash-resume drill: device runner with periodic checkpointing;
        # DTK_WORKER_FAULT=N kills the process (exit 17, simulating
        # preemption/OOM) right after the first checkpoint past N pairs
        from danbing_tk_tpu.engine.align_runner import DeviceAlignRunner

        fault_after = int(os.environ.get("DTK_WORKER_FAULT", "0"))
        al = DeviceAlignRunner(RPGG(pan), cfg, batch_pairs=256,
                               max_read_len=192)
        cursor0 = al._load_checkpoint(ckpt.replace("%d", str(pid)))[0]
        print(f"[worker {pid}] resume cursor={cursor0}", file=sys.stderr,
              flush=True)
        if fault_after:
            save = al._save_checkpoint

            def save_and_die(path, cursor, extra=None):
                save(path, cursor, extra)
                print(f"[worker {pid}] injected fault at cursor={cursor}",
                      file=sys.stderr, flush=True)
                # Barrier before dying: the workers reach their first
                # checkpoint at different wall times, and if one exits
                # while the other is still mid-shard, the coordination
                # service FATAL-kills the survivor (exit 1) before it
                # reaches its own injected fault.  Simultaneous "node
                # preemption" is also the realistic drill (a pod/slice
                # preemption takes every controller down together).
                from jax.experimental import multihost_utils

                multihost_utils.sync_global_devices("dtk-fault-drill")
                os._exit(17)

            al._save_checkpoint = save_and_die
        al.run_file(shard, checkpoint=ckpt.replace("%d", str(pid)),
                    checkpoint_every=fault_after or 10 ** 9)
    elif os.environ.get("DTK_WORKER_HOST"):
        al = HostAligner(RPGG(pan), cfg)
        al.run_file(shard)
    else:
        # production topology: each controller drives the FULL native
        # funnel (prefilter -> repack -> finalize) under shard_map over
        # its local devices; cross-process merge below is the single
        # global reduction
        from danbing_tk_tpu.parallel import mesh as pm
        from danbing_tk_tpu.parallel.runner import ShardedAlignRunner

        local = jax.local_devices()
        al = ShardedAlignRunner(RPGG(pan), cfg, mesh=pm.make_mesh(local),
                                batch_pairs=64 * len(local),
                                max_read_len=192)
        al.run_file_native(shard, prefilter=True)
        print(f"[worker {pid}] funnel: prefiltered={al.n_prefiltered} "
              f"referee={al.n_referee}", file=sys.stderr, flush=True)
    merged = global_merge(al.flat_counts())
    np.save(os.path.join(outdir, f"merged.{pid}.npy"), merged)
    print(f"[worker {pid}] devices={jax.device_count()} "
          f"processes={jax.process_count()} counts={int(merged.sum())}",
          file=sys.stderr)


if __name__ == "__main__":
    main()
