"""Device scan-order tie resolution (updatetop2 semantics) vs host oracle.

Builds a small RPGG with HEAVY motif sharing (50% of loci reuse an earlier
locus's motif) and reads drawn from inside TR regions, which maximizes
full-total vote ties.  Every non-referee'd device verdict must match the
host count_hit (which replays libstdc++ sort order exactly); runner
outputs must stay byte-identical to the host engine either way.
"""

import os

import numpy as np
import pytest

import danbing_tk_tpu.engine.host_align as ha
from danbing_tk_tpu.engine import device_align as da
from danbing_tk_tpu.engine.align_runner import DeviceAlignRunner
from danbing_tk_tpu.engine.host_align import AlignConfig, HostAligner, RPGG
from danbing_tk_tpu.ops import kmers_np as K

KSIZE, FS = 21, 300


@pytest.fixture(scope="module")
def shared_pan(tmp_path_factory):
    from danbing_tk_tpu.apps.fa2kmers import fa2kmers, make_tre_kmers
    from danbing_tk_tpu.index import dbi as dbi_mod

    outdir = tmp_path_factory.mktemp("sharedrpgg")
    pan = str(outdir / "pan")
    rng = np.random.default_rng(5)
    bases = "ACGT"

    def rand_seq(n):
        return "".join(bases[i] for i in rng.integers(0, 4, n))

    nloci, nhap = 48, 2
    motifs, hapfiles = [], []
    haps = [[] for _ in range(nhap)]
    for li in range(nloci):
        if li % 2 == 1 and motifs:
            motif = motifs[int(rng.integers(0, len(motifs)))]
        else:
            motif = rand_seq(int(rng.integers(4, 12)))
        motifs.append(motif)
        lf, rf = rand_seq(FS), rand_seq(FS)
        for h in range(nhap):
            n = max(5, 40 + int(rng.integers(-5, 6)))
            haps[h].append(lf + motif * n + rf)
    for h in range(nhap):
        p = str(outdir / f"hap{h}.fa")
        with open(p, "w") as f:
            for li, s in enumerate(haps[h]):
                f.write(f">locus{li}\n{s}\n")
        hapfiles.append(p)
    fa2kmers(pan, hapfiles, k=KSIZE, fsi=FS, fso=FS)
    make_tre_kmers(pan, hapfiles, KSIZE, FS)
    dbi_mod.serialize(pan)

    # PE reads biased into the TR (pure repeat => vote ties)
    reads = str(outdir / "reads.fa")
    L, FLEN = 100, 260
    comp = str.maketrans("ACGT", "TGCA")
    with open(reads, "w") as f:
        for i in range(1500):
            h = int(rng.integers(0, nhap))
            li = int(rng.integers(0, nloci))
            s = haps[h][li]
            lo = max(FS - 30, 0)
            hi = max(len(s) - FS - FLEN + 30, lo + 1)
            beg = int(rng.integers(lo, hi))
            r1 = s[beg : beg + L]
            r2 = s[beg + FLEN - L : beg + FLEN][::-1].translate(comp)
            f.write(f">p{i}/1\n{r1}\n>p{i}/2\n{r2}\n")
    return pan, reads


def test_tie_resolution_matches_host_oracle(shared_pan):
    """Per-pair crosscheck: every pair the device decides (not referee'd)
    must agree with host count_hit on both dest and dst0."""
    pan, reads = shared_pan
    import jax
    import jax.numpy as jnp

    cfg = AlignConfig(ksize=KSIZE, cth=20, n_filter=4, nm_filter=1)
    rpgg = RPGG(pan)
    P, L, E = 512, 128, 384
    drp = da.DeviceRPGG.build(rpgg, with_tre=False)
    raw, tabs = da.make_step(drp, cfg, P, L, expand_cap=E,
                             with_annot=False, jit=False)
    jitted = jax.jit(raw, donate_argnums=1)

    def step(*args):
        return jitted(tabs, *args)
    host = HostAligner(RPGG(pan), cfg)

    pairs = []
    for batch in ha.iter_fasta_pairs(reads, cfg.cth + KSIZE - 1,
                                     rpgg.nloci, 0, 10**6):
        pairs.extend(batch)

    n_tie_resolved = n_referee = n_checked = 0
    for off in range(0, len(pairs), P):
        chunk = pairs[off : off + P]
        codes = np.full((2 * P, L), 255, dtype=np.uint8)
        rlen = np.zeros(2 * P, dtype=np.int32)
        live = np.zeros(P, dtype=bool)
        for i, (_, s1, s2, _) in enumerate(chunk):
            for m, s in ((0, s1), (1, s2)):
                c = K.encode_bases(s)[:L]
                codes[2 * i + m, : len(c)] = c
                rlen[2 * i + m] = len(c)
            live[i] = True
        state = da.init_state(drp)
        _, out = step(state, jnp.asarray(codes), jnp.asarray(rlen),
                      jnp.asarray(live))
        referee = np.asarray(out["referee"])
        dst0 = np.asarray(out["dst0"])
        vp = np.asarray(out["vote_pass"])
        alive = np.asarray(out["pair_alive"])
        for i, (_, s1, s2, _) in enumerate(chunk):
            if not alive[i]:
                continue
            if referee[i]:
                n_referee += 1
                continue
            caks1, _ = K.seq_to_kmers_and_edges(K.encode_bases(s1), KSIZE)
            caks2, _ = K.seq_to_kmers_and_edges(K.encode_bases(s2), KSIZE)
            its1, kf1 = ha.kfilter(caks1, host.g.dbi, cfg.cth)
            its2, kf2 = ha.kfilter(caks2, host.g.dbi, cfg.cth)
            if kf1 and kf2:
                continue
            r1, r2 = ha.ReadAsgn(), ha.ReadAsgn()
            r1.rm |= kf1
            r2.rm |= kf2
            dest, d0 = ha.count_hit(host.g.vv, its1, its2, host.g.nloci,
                                    cfg.cth, r1, r2)
            n_checked += 1
            dev_dest = int(dst0[i]) if vp[i] else host.g.nloci
            assert dev_dest == dest, (i, dev_dest, dest)
            if vp[i]:
                assert int(dst0[i]) == d0, (i, int(dst0[i]), d0)
    # the panel must actually exercise ties and the device must resolve
    # most of them (motif sharing previously referee'd ~13%)
    assert n_checked > 800
    frac = n_referee / (n_referee + n_checked)
    assert frac < 0.02, f"referee rate {frac:.1%}"


def test_tie_panel_runner_byte_exact(shared_pan, tmp_path):
    """Full runners: device (+referee) output == host engine output."""
    pan, reads = shared_pan
    cfg = AlignConfig(ksize=KSIZE, cth=20, n_filter=4, nm_filter=1)
    host = HostAligner(RPGG(pan), cfg)
    host.run_file(reads)
    host.write_trkmc_ar(tmp_path / "h.trkmc.ar")
    host.write_kam(tmp_path / "h.kam")
    host.write_summary(tmp_path / "h.sum")

    dev = DeviceAlignRunner(RPGG(pan), cfg, batch_pairs=512,
                            max_read_len=128, expand_cap=384)
    dev.run_file(reads)
    dev.write_trkmc_ar(tmp_path / "d.trkmc.ar")
    dev.write_kam(tmp_path / "d.kam")
    dev.write_summary(tmp_path / "d.sum")

    for n in ("trkmc.ar", "kam", "sum"):
        assert (tmp_path / f"d.{n}").read_bytes() == \
            (tmp_path / f"h.{n}").read_bytes(), n
