#!/usr/bin/env python
"""Build the FULL production-scale index (~1.2e9 dbi keys, the
reference's genome-wide RPGG size, /root/reference/README.md:22) on the
host and cache it to disk.  Records build wall time, peak RSS, and table
bytes for PERF.md.

Usage: python tools/build_full_index.py [nloci] [kmers_per_locus]
"""

import os
import resource
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from tools.make_scale_index import build_full_tables  # noqa


def main():
    nloci = int(sys.argv[1]) if len(sys.argv) > 1 else 80_000
    kpl = int(sys.argv[2]) if len(sys.argv) > 2 else 15_000
    outdir = (sys.argv[3] if len(sys.argv) > 3
              else os.path.join(os.path.dirname(__file__), "..", "build",
                                f"full_index_{nloci}_{kpl}"))
    t0 = time.time()
    man = build_full_tables(outdir, nloci, kpl)
    wall = time.time() - t0
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6  # GB
    gb = {p: man[p]["nbytes"] / 1e9 for p in ("dbi", "trfl")}
    print(f"FULL-INDEX nloci={nloci} kpl={kpl} "
          f"slots={man['nslots']/1e9:.3f}e9 keys={man['nkeys']/1e9:.3f}e9"
          f" wall={wall:.0f}s peak_rss={rss:.1f}GB"
          f" bytes: dbi={gb['dbi']:.2f} trfl={gb['trfl']:.2f}"
          f" total={sum(gb.values()):.2f} GB -> {outdir}")


if __name__ == "__main__":
    main()
