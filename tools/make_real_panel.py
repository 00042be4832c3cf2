#!/usr/bin/env python
"""Real-sequence benchmark panel.

The round-2 bench panel was RNG motifs with uniform-random WGS
background, which flatters the prefilter (random 21-mers almost never
collide with a real index; human sequence does).  This builds a panel
anchored in the real human sequence bundled with the reference:

  * motif seeds: actual tandem-repeat motifs detected (by autocorrelation)
    in the reference's real haplotype slices (test/input/HG00514*,
    HG00733*, test/QC/input/HG002*, hs1*) — chr12 VNTR content — plus
    1-2-edit derivatives forming motif families, as real panels share
    motifs across loci
  * TR arrays: motif tandem-repeated with per-copy mutations (real VNTR
    arrays are imperfect), copy number varying per haplotype
  * flanks: order-6 Markov sequence trained on the real pool — human
    local composition without the artificial cross-locus flank sharing a
    160 KB source pool would force at 30k loci
  * WGS background for bench_e2e: literal windows of the bundled hg38
    chr12 slice (a disjoint region from the flank training material),
    reverse-complemented half the time, with the standard error profile

Built through the SAME build tools as production (fa2kmers -> ktools
serialize), cached under build/real_panel*/.
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)

from danbing_tk_tpu.apps.fa2kmers import fa2kmers, make_tre_kmers, \
    read_fasta_seqs  # noqa
from danbing_tk_tpu.index import dbi as dbi_mod  # noqa

REF = "/root/reference/test"
KSIZE, FS = 21, 700
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
COMP = np.zeros(256, dtype=np.uint8)
for _a, _b in zip(b"ACGTN", b"TGCAN"):
    COMP[_a] = _b


def load_real_pool() -> list[np.ndarray]:
    """All bundled real haplotype slices as byte arrays (uppercased)."""
    seqs = []
    for d, names in ((f"{REF}/input", ("HG00514.0.fa", "HG00514.1.fa",
                                       "HG00733.0.fa", "HG00733.1.fa")),
                     (f"{REF}/QC/input", ("HG002.0.fa", "HG002.1.fa",
                                          "hs1.0.fa", "hs1.1.fa"))):
        for n in names:
            for s in read_fasta_seqs(os.path.join(d, n)):
                seqs.append(np.frombuffer(s.upper().encode(), np.uint8))
    return seqs


def detect_motifs(seqs: list[np.ndarray], max_period: int = 64,
                  min_hits: int = 3) -> list[np.ndarray]:
    """Tandem motifs by autocorrelation: positions where seq[i] ==
    seq[i+p] over a long run indicate a period-p repeat; returns the
    repeating units (deduped)."""
    out = {}
    for s in seqs:
        n = len(s)
        for p in range(2, max_period + 1):
            eq = s[:-p] == s[p:]
            # run-length scan of eq to find runs >= 2 periods
            run = 0
            for i in range(len(eq)):
                run = run + 1 if eq[i] else 0
                if run == 2 * p:                  # >= 3 copies
                    unit = bytes(s[i - 2 * p + 1: i - p + 1])
                    if b"N" not in unit:
                        out[unit] = out.get(unit, 0) + 1
                    run = 0
    # prefer frequent units; drop homopolymers (period-1 disguised)
    units = [u for u, c in sorted(out.items(), key=lambda kv: -kv[1])
             if len(set(u)) > 1]
    return [np.frombuffer(u, np.uint8) for u in units[:256]]


class Markov:
    """Order-k Markov sampler over real sequence (human local
    composition; unlimited unique output)."""

    def __init__(self, seqs: list[np.ndarray], order: int = 6, seed=11):
        self.k = order
        self.rng = np.random.default_rng(seed)
        b2i = np.full(256, 255, np.uint8)
        for i, a in enumerate(b"ACGT"):
            b2i[a] = i
        counts = {}
        for s in seqs:
            c = b2i[s]
            ok = c != 255
            for i in range(order, len(c)):
                if ok[i - order:i + 1].all():
                    ctx = int(np.dot(c[i - order:i],
                                     4 ** np.arange(order)[::-1]))
                    key = ctx * 4 + int(c[i])
                    counts[key] = counts.get(key, 0) + 1
        self.table = {}
        for key, n in counts.items():
            self.table.setdefault(key >> 2, [0, 0, 0, 0])[key & 3] = n
        self.ctxs = list(self.table.keys())

    def sample(self, n: int) -> np.ndarray:
        rng = self.rng
        out = np.empty(n, np.uint8)
        ctx = int(self.ctxs[int(rng.integers(len(self.ctxs)))])
        mod = 4 ** (self.k - 1)
        for i in range(n):
            probs = self.table.get(ctx)
            if probs is None:                      # unseen context: restart
                ctx = int(self.ctxs[int(rng.integers(len(self.ctxs)))])
                probs = self.table[ctx]
            p = np.array(probs, float)
            c = int(rng.choice(4, p=p / p.sum()))
            out[i] = BASES[c]
            ctx = (ctx % mod) * 4 + c
        return out

    def sample_batch(self, nseq: int, length: int) -> np.ndarray:
        """nseq INDEPENDENT Markov walks, vectorized across sequences
        (one transition step per position over all walks).  Independent
        walks share only chance k-mers — the model for genomic flanks,
        which are unique sequence in a real genome.  (Slicing flanks
        out of one shared reservoir gave every 21-mer ~hundreds of
        locus hits and inflated the vote expansion demand ~30x over
        anything a real panel produces.)"""
        rng = self.rng
        dense = np.zeros((4 ** self.k, 4), float)
        for ctx, probs in self.table.items():
            dense[ctx] = probs
        seen = np.array(self.ctxs, np.int64)
        ctx = seen[rng.integers(0, len(seen), nseq)]
        out = np.empty((nseq, length), np.uint8)
        mod = 4 ** (self.k - 1)
        for i in range(length):
            rows = dense[ctx]
            bad = rows.sum(axis=1) == 0
            if bad.any():                          # unseen ctx: restart
                ctx[bad] = seen[rng.integers(0, len(seen),
                                             int(bad.sum()))]
                rows = dense[ctx]
            cdf = np.cumsum(rows, axis=1)
            cdf /= cdf[:, -1:]
            c = (rng.random((nseq, 1)) > cdf).sum(axis=1)
            out[:, i] = BASES[c]
            ctx = (ctx % mod) * 4 + c
        return out


def _mutate(arr: np.ndarray, rate: float, rng) -> np.ndarray:
    m = rng.random(len(arr)) < rate
    if m.any():
        arr = arr.copy()
        b2i = {65: 0, 67: 1, 71: 2, 84: 3}
        idx = np.flatnonzero(m)
        cur = np.array([b2i.get(int(arr[i]), 0) for i in idx])
        arr[idx] = BASES[(cur + rng.integers(1, 4, len(idx))) % 4]
    return arr


def build(outdir: str, nloci: int = 30_488, nhap: int = 2,
          seed: int = 7) -> str:
    os.makedirs(outdir, exist_ok=True)
    pan = os.path.join(outdir, "pan")
    ver = os.path.join(outdir, "PANEL_V2")
    if os.path.exists(pan + ".kmers.dbi") and os.path.exists(ver):
        return pan
    rng = np.random.default_rng(seed)
    pool = load_real_pool()
    units = detect_motifs(pool)
    assert units, "no tandem motifs detected in the real slices"
    # expand the seed units into a library of ~nloci/8 derivatives
    # (1-4 edits, unit doubling, rotations): real VNTR catalogs have
    # thousands of distinct motifs with a heavy STR-like head, not 50 —
    # without this every locus family shares one unit and every TR read
    # expands to hundreds of loci, far beyond real sharing
    motifs = list(units)
    target = max(len(units), nloci // 8)
    while len(motifs) < target:
        m = units[int(rng.integers(len(units)))]
        if rng.random() < 0.3 and len(m) <= 32:
            m = np.tile(m, 2)                      # period doubling
        r = int(rng.integers(len(m)))
        m = np.concatenate([m[r:], m[:r]])         # rotation
        motifs.append(_mutate(m, max(2.0 / len(m), 0.05), rng))
    print(f"[real-panel] {len(units)} real motif units -> "
          f"{len(motifs)} library variants "
          f"(lens {sorted(set(len(m) for m in motifs))[:10]}...)",
          file=sys.stderr)
    mk = Markov(pool, order=6, seed=seed + 1)
    # v2: per-flank INDEPENDENT Markov walks (vectorized batch sampler).
    # v1 sliced all flanks from one 2 MB reservoir, which made every
    # flank 21-mer map to ~hundreds of loci — an artifact no real panel
    # has (genomic flanks are unique sequence); measured it inflated
    # per-pair vote expansion demand to p50 ~9,300 slots vs ~60 for
    # independent flanks.
    all_flanks = mk.sample_batch(2 * nloci, FS)
    flank_i = [0]

    def flank():
        f = all_flanks[flank_i[0]]
        flank_i[0] += 1
        return _mutate(f, 0.02, rng)

    hapfiles = [os.path.join(outdir, f"hap{h}.fa") for h in range(nhap)]
    fhs = [open(p, "w") for p in hapfiles]
    fam_motif = None
    for li in range(nloci):
        # motif families: ~20% of loci reuse the previous family's
        # motif with a couple of edits (shared k-mers across loci)
        if fam_motif is not None and rng.random() < 0.20:
            motif = _mutate(fam_motif, 2.0 / len(fam_motif), rng)
        else:
            motif = motifs[int(rng.integers(len(motifs)))]
        fam_motif = motif
        # array length ~ lognormal bp, >= 3 copies
        tr_bp = int(np.clip(rng.lognormal(6.0, 0.7), 120, 3000))
        ncopy0 = max(3, tr_bp // len(motif))
        lf, rf = flank(), flank()
        for h in range(nhap):
            ncopy = max(3, ncopy0 + int(rng.integers(-2, 3)))
            arr = np.tile(motif, ncopy)
            arr = _mutate(arr, 0.01, rng)          # imperfect copies
            s = (lf.tobytes() + arr.tobytes() + rf.tobytes()).decode()
            fhs[h].write(f">locus{li}\n{s}\n")
    for f in fhs:
        f.close()
    print(f"[real-panel] building {nloci}-locus RPGG via fa2kmers + "
          f"serialize...", file=sys.stderr)
    # gen_graph=False: the asgn funnel never loads .graph.kmers
    # (SURVEY §3.1 HEAD quirk) and the dBG doubles build cost at 30k loci
    fa2kmers(pan, hapfiles, k=KSIZE, fsi=FS, fso=FS, gen_graph=False)
    make_tre_kmers(pan, hapfiles, KSIZE, FS)
    dbi_mod.serialize(pan)
    with open(ver, "w") as f:
        f.write("flanks=independent-markov-walks (v2)\n")
    return pan


def background_pool() -> list[np.ndarray]:
    """Real WGS background: the bundled hg38 chr12 slice (200 KB), a
    region disjoint from the panel's motif/flank training material."""
    s = read_fasta_seqs(
        f"{REF}/input/hg38.chr12.2155791.2356090.fasta")[0]
    return [np.frombuffer(s.upper().encode(), np.uint8)]


if __name__ == "__main__":
    out = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        ROOT, "build", "real_panel")
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 30_488
    print(build(out, n))
