"""Fixed-shape bounded-edit error-correction scoring.

The reference's threading-mode error correction scores 8 hypothesis
families (62 extension counters) per failure site with serial
early-exit loops (aQueryFasta_thread.cpp:898-1106; Python oracle
engine/threading.error_correction_forward).  This module reformulates
the whole search in closed form so it vectorizes as a fixed-shape
stage over a batch of failure sites:

  * every hypothesis chain's k-mer sequence is determined ONLY by the
    read nucleotides and (for 2-edit families) the hypothesis
    nucleotides — it never depends on what the graph returns, so all
    62 chains x k steps of candidate k-mers can be materialized up
    front and graph-probed in ONE batched lookup;
  * the serial early-exit becomes a prefix-AND over per-step edge-bit
    checks, with the reference's stale-mask quirk (getNextNucs
    overwrites the allowed-nucleotide mask only when the accepted
    chain k-mer is PRESENT in the graph) reproduced by a forward-fill
    over the probe results;
  * the scan order of get_edit (priority + thresholds) is applied to
    the resulting (B, 62) counter plane.

Two implementations share the chain/gate tables:
  score_site_np   — numpy, one site; validated counter-exact against
                    the Python oracle (tests/test_correct_jax.py).
  make_site_scorer — jit-compiled batch scorer probing the DeviceRPGG
                    graph table (same table the DFA walk uses).

Trade: ~1.3k graph probes per site make this stage gather-bound, while
the batched C++ fallback (native/dtk_thread.cpp dtk_thread_pairs) runs
in the shadow of the device queue, so the device stage is kept as a
validated building block rather than wired into the hot path (whether
it pays on the current device is an open ROADMAP item).
"""

from __future__ import annotations

import numpy as np

NAN64 = 0xFFFFFFFFFFFFFFFF

# chain layout: 8 families -> 62 chains.
# (name, n_chains, joff, jmax_off) where step t (1-based) consumes read
# nucleotide rnt[t + joff] and the loop bound is j < min(k + jmax_off,
# nkrem).  Families with two hypothesis nucleotides fold nt1 into the
# chain init.
FAMILIES = (
    ("nem1", 4, 0, 1),    # one mismatch
    ("ned1", 4, -1, 0),   # 1 deletion
    ("nei1", 1, 0, 1),    # 1 insertion
    ("nem2", 16, 1, 2),   # two mismatches
    ("nemd", 16, 0, 1),   # 1 substitution + 1 deletion
    ("ned2", 16, -1, 0),  # 2 deletions
    ("nemi", 4, 1, 2),    # 1 substitution + 1 insertion
    ("nei2", 1, 1, 2),    # 2 insertions
)
NCHAINS = sum(f[1] for f in FAMILIES)          # 62
_OFF = {}
_o = 0
for _n, _c, _j, _m in FAMILIES:
    _OFF[_n] = _o
    _o += _c

MSC = 5  # min extension scores: ms1 = MSC, ms2 = 2 * MSC


def _shift(km, nt, rmask):
    return ((km & rmask) << 2) | nt


def site_inputs(kmers, ki, k):
    """Host prep for one failure site: (w, rnt, good, nkrem).

    w[j] = kmers[ki-1+j] for j in 0..k+2 (NAN64-padded past the read),
    rnt[j] = w[1+j] & 3, good[j] as the reference fills it."""
    nk = len(kmers)
    w = np.full(k + 3, NAN64, dtype=np.uint64)
    hi = min(nk, ki - 1 + k + 3)
    w[: hi - (ki - 1)] = kmers[ki - 1: hi]
    rnt = (w[1:] & np.uint64(3)).astype(np.int64)
    nkrem = nk - ki
    good = np.zeros(k + 2, dtype=bool)
    lim = min(k + 2, nkrem)
    good[:lim] = w[1: 1 + lim] != NAN64
    return w, rnt, good, nkrem


def _graph_masks(gbits_fn, node, k):
    """nts0 (4,), nts1 (4,), nts2 (4,), gnt3 (4,4,4), from <=21 probes.

    gbits_fn(km) -> (present, 4-bit out mask) for a packed k-mer."""
    rmask = (1 << (2 * (k - 1))) - 1
    _, b0 = gbits_fn(node)
    nts0 = np.array([(b0 >> i) & 1 for i in range(4)], dtype=bool)
    nts1 = np.zeros(4, dtype=bool)
    nts2 = np.zeros(4, dtype=bool)
    gnt3 = np.zeros((4, 4, 4), dtype=bool)
    cb = np.zeros(4, dtype=np.int64)          # child edge masks
    for b in range(4):
        if not nts0[b]:
            continue
        c = _shift(int(node), b, rmask)
        _, bits = gbits_fn(c)
        cb[b] = bits
        for i in range(4):
            nts1[i] |= bool((bits >> i) & 1)
        for b1 in range(4):
            if not (bits >> b1) & 1:
                continue
            c2 = _shift(c, b1, rmask)
            _, bits2 = gbits_fn(c2)
            for i in range(4):
                nts2[i] |= bool((bits2 >> i) & 1)
                gnt3[b, b1, i] = bool((bits2 >> i) & 1)
    return nts0, nts1, nts2, gnt3


def chain_table(w, rnt, nts0, gnt3, k):
    """Static chain definitions -> (init k-mer, init 4-bit mask,
    enable, joff, jmax_off) per chain, plus family slices."""
    rmask = (1 << (2 * (k - 1))) - 1
    w0, w1 = int(w[0]), int(w[1])
    oldnt = w1 & 3
    g3m = np.zeros((4, 4), dtype=np.int64)    # gnt3[b, b1] as bitmask
    for b in range(4):
        for b1 in range(4):
            g3m[b, b1] = sum(int(gnt3[b, b1, i]) << i for i in range(4))
    # get_nnts1(nt0) mask: bit nt1 = OR over nt2 of gnt3[nt0, nt1, nt2]
    or1m = np.array([sum((int(gnt3[b, j, :].any()) << j)
                         for j in range(4)) for b in range(4)],
                    dtype=np.int64)
    nts0m = sum(int(nts0[i]) << i for i in range(4))

    init_km = np.zeros(NCHAINS, dtype=np.uint64)
    init_mask = np.zeros(NCHAINS, dtype=np.int64)
    enable = np.zeros(NCHAINS, dtype=bool)
    x0 = [(w1 & ~3) | nt0 for nt0 in range(4)]
    for nt0 in range(4):
        e0 = bool(nts0[nt0])
        o = _OFF["nem1"] + nt0
        init_km[o], init_mask[o], enable[o] = x0[nt0], or1m[nt0], e0
        o = _OFF["ned1"] + nt0
        init_km[o], init_mask[o], enable[o] = x0[nt0], or1m[nt0], e0
        o = _OFF["nemi"] + nt0
        init_km[o], init_mask[o], enable[o] = x0[nt0], or1m[nt0], e0
        for nt1 in range(4):
            e01 = e0 and bool((or1m[nt0] >> nt1) & 1)
            x01 = _shift(x0[nt0], nt1, rmask)
            for fam in ("nem2", "nemd", "ned2"):
                o = _OFF[fam] + nt0 * 4 + nt1
                init_km[o] = x01
                init_mask[o] = g3m[nt0, nt1]
                enable[o] = e01
    for fam in ("nei1", "nei2"):
        o = _OFF[fam]
        init_km[o], init_mask[o], enable[o] = w0, nts0m, True
    return init_km, init_mask, enable


def family_gates(rnt, good, nts0, nts1, nts2, nkrem, mes):
    """The per-family top-level guards (incl. the nem1-elif-nem2
    exclusivity)."""
    g1 = nkrem > 1 and bool(nts1[rnt[1]]) and bool(good[1])
    gates = {
        "nem1": g1,
        "nem2": (not g1) and nkrem > 2 and bool(nts2[rnt[2]])
                and mes >= 2 and bool(good[2]),
        "nemi": nkrem > 2 and bool(nts1[rnt[2]]) and mes >= 2
                and bool(good[2]),
        "nemd": nkrem > 1 and bool(nts2[rnt[1]]) and mes >= 2
                and bool(good[1]),
        "nei1": nkrem > 1 and bool(nts0[rnt[1]]) and bool(good[1]),
        "ned1": bool(nts1[rnt[0]]) and bool(good[0]),
        "nei2": nkrem > 2 and bool(nts0[rnt[2]]) and mes >= 2
                and bool(good[2]),
        "ned2": bool(nts2[rnt[0]]) and mes >= 2 and bool(good[0]),
    }
    return gates


def score_site_np(gbits_fn, kmers, ki, k, mes):
    """Counter-exact numpy mirror of error_correction_forward for one
    site: returns the (62,) counter vector in FAMILIES order.

    gbits_fn(km) -> (present: bool, out-edge 4-bit mask: int)."""
    rmask = (1 << (2 * (k - 1))) - 1
    w, rnt, good, nkrem = site_inputs(np.asarray(kmers, dtype=np.uint64),
                                      ki, k)
    node = int(w[0])
    nts0, nts1, nts2, gnt3 = _graph_masks(gbits_fn, node, k)
    init_km, init_mask, enable = chain_table(w, rnt, nts0, gnt3, k)
    gates = family_gates(rnt, good, nts0, nts1, nts2, nkrem, mes)

    counters = np.zeros(NCHAINS, dtype=np.int64)
    for name, nch, joff, jmax_off in FAMILIES:
        if not gates[name]:
            continue
        jm = min(k + jmax_off, nkrem)
        for c in range(nch):
            o = _OFF[name] + c
            if not enable[o]:
                continue
            km = int(init_km[o])
            mask = int(init_mask[o])
            for t in range(1, k + 1):
                j = t + joff
                if j >= jm or not good[j]:
                    break
                km = _shift(km, int(rnt[j]), rmask)
                if not (mask >> (km & 3)) & 1:
                    break
                counters[o] += 1
                present, bits = gbits_fn(km)
                if present:                    # stale-mask quirk
                    mask = bits
    return counters


def get_edit_from_counters(counters, mes):
    """Exact mirror of ThreadExt.get_edit's priority scan -> (score,
    edits) with edits as [type, '', graph_char] rows."""
    from ..engine.threading import ALPHABET

    score = 0
    edits = []
    c = counters

    def sl(name):
        n = dict((f[0], f[1]) for f in FAMILIES)[name]
        return c[_OFF[name]: _OFF[name] + n]

    nem1, ned1, nei1 = sl("nem1"), sl("ned1"), int(sl("nei1")[0])
    nem2, nemd, ned2 = sl("nem2"), sl("nemd"), sl("ned2")
    nemi, nei2 = sl("nemi"), int(sl("nei2")[0])
    for i in range(4):
        if nem1[i] > score and nem1[i] >= MSC:
            score, edits = int(nem1[i]), [["X", "", ALPHABET[i]]]
    for i in range(4):
        if ned1[i] > score and ned1[i] >= MSC:
            score, edits = int(ned1[i]), [["D", "", ALPHABET[i]]]
    if nei1 > score and nei1 >= MSC:
        score, edits = int(nei1), [["I", "", ""]]
    if mes > 1:
        for i in range(4):
            for j in range(4):
                sm2, smd, sd2 = (int(nem2[i * 4 + j]),
                                 int(nemd[i * 4 + j]),
                                 int(ned2[i * 4 + j]))
                if sm2 > score and sm2 >= 2 * MSC:
                    score, edits = sm2, [["X", "", ALPHABET[i]],
                                         ["X", "", ALPHABET[j]]]
                if smd > score and smd >= 2 * MSC:
                    score, edits = smd, [["X", "", ALPHABET[i]],
                                         ["D", "", ALPHABET[j]]]
                if sd2 > score and sd2 >= 2 * MSC:
                    score, edits = sd2, [["D", "", ALPHABET[i]],
                                         ["D", "", ALPHABET[j]]]
            if nemi[i] > score and nemi[i] >= 2 * MSC:
                score, edits = int(nemi[i]), [["X", "", ALPHABET[i]],
                                              ["I", "", ""]]
        if nei2 > score and nei2 >= 2 * MSC:
            score, edits = int(nei2), [["I", "", ""], ["I", "", ""]]
    return score, edits


# ---- jit batch scorer ----

def make_site_scorer(drp, B: int, k: int = 21, mes: int = 2, jit=True):
    """Fixed-shape batched hypothesis scorer over B failure sites,
    probing the DeviceRPGG composite graph table ((kmer, locus) -> edge
    mask — the same table the DFA walk uses).

    scorer(w_lo, w_hi, nkrem, loc) -> (B, 62) i32 counters
      w_lo/w_hi: (B, k+3) u32 halves of kmers[ki-1 .. ki+k+1]
                 (all-ones rows where past the read / N holes)
      nkrem:     (B,) i32 = nkmers - ki
      loc:       (B,) i32 destination locus per site

    Probe budget: 21 mask + 62*k chain lookups per site (~1.3k rows) —
    gather-bound by design; see the module docstring."""
    import jax
    import jax.numpy as jnp

    from ..index import device_table as dt

    assert 16 < k <= 32, "u32-pair shift path assumes 32 < 2k <= 64"
    gtab = drp.graph_tab
    levels = [(jnp.asarray(t), s) for t, s in gtab.levels]
    hib = 2 * k - 32

    def shift1(lo, hi, nt):
        """((km & rmask) << 2 | nt) on u32 halves."""
        hi2 = hi & ((jnp.uint32(1) << (hib - 2)) - jnp.uint32(1)) \
            if hib >= 2 else jnp.zeros_like(hi)
        carry = lo >> 30
        lo2 = (lo << 2) | jnp.asarray(nt, jnp.uint32)
        hi3 = ((hi2 << 2) | carry) if hib >= 2 else \
            (carry & ((jnp.uint32(1) << hib) - 1))
        return lo2, hi3

    def probe(lo, hi, loc_b):
        found, mask, _ = dt.lookup_bucket_jax(
            gtab, lo, hi, q_loc=loc_b, levels_dev=levels)
        return found, mask.astype(jnp.int32)

    # static per-chain tables, FAMILIES order
    joff = np.concatenate([np.full(f[1], f[2], np.int32)
                           for f in FAMILIES])
    jmaxo = np.concatenate([np.full(f[1], f[3], np.int32)
                            for f in FAMILIES])
    famid = np.concatenate([np.full(f[1], i, np.int32)
                            for i, f in enumerate(FAMILIES)])
    joff_j, jmaxo_j, famid_j = (jnp.asarray(x)
                                for x in (joff, jmaxo, famid))

    def scorer(w_lo, w_hi, nkrem, loc):
        B_ = w_lo.shape[0]
        a4 = jnp.arange(4, dtype=jnp.int32)
        ones = jnp.uint32(0xFFFFFFFF)
        valid = ~((w_lo == ones) & (w_hi == ones))
        rnt = (w_lo[:, 1:] & 3).astype(jnp.int32)          # (B, k+2)
        jj = jnp.arange(k + 2, dtype=jnp.int32)[None, :]
        good = valid[:, 1:] & (jj < jnp.minimum(k + 2, nkrem)[:, None])

        # ---- mask probes: node -> children -> grandchildren ----
        n_lo, n_hi = w_lo[:, 0], w_hi[:, 0]
        _, nbits = probe(n_lo, n_hi, loc)
        nts0 = ((nbits[:, None] >> a4) & 1) > 0            # (B, 4)
        c_pairs = [shift1(n_lo, n_hi, jnp.full((B_,), b, jnp.int32))
                   for b in range(4)]
        c_lo = jnp.stack([p[0] for p in c_pairs], 1)       # (B, 4)
        c_hi = jnp.stack([p[1] for p in c_pairs], 1)
        _, cb = probe(c_lo, c_hi, loc[:, None])
        cb = jnp.where(nts0, cb, 0)                        # (B, 4)
        g_pairs = [shift1(c_lo[:, b], c_hi[:, b],
                          jnp.full((B_,), b1, jnp.int32))
                   for b in range(4) for b1 in range(4)]
        g_lo = jnp.stack([p[0] for p in g_pairs], 1)       # (B, 16)
        g_hi = jnp.stack([p[1] for p in g_pairs], 1)
        _, gb = probe(g_lo, g_hi, loc[:, None])
        has_e = ((cb[:, :, None] >> a4) & 1) > 0           # (B, 4, 4)
        gb = jnp.where(has_e, gb.reshape(B_, 4, 4), 0)     # gated
        gnt3 = ((gb[:, :, :, None] >> a4) & 1) > 0         # (B,4,4,4)

        def mask4(bits_b):                                 # (B,...,4)->int
            return (bits_b[..., 0].astype(jnp.int32)
                    | (bits_b[..., 1].astype(jnp.int32) << 1)
                    | (bits_b[..., 2].astype(jnp.int32) << 2)
                    | (bits_b[..., 3].astype(jnp.int32) << 3))

        nts1 = jnp.where(nts0[:, :, None], has_e, False).any(1)  # (B,4)
        nts2 = gnt3.any(axis=(1, 2))                       # (B, 4)
        or1m = mask4(gnt3.any(axis=3))                     # (B, 4): bit nt1
        g3m = mask4(gnt3)                                  # (B, 4, 4)
        nts0m = mask4(nts0)                                # (B,)

        # ---- family gates ----
        r0, r1, r2 = rnt[:, 0], rnt[:, 1], rnt[:, 2]
        n1_r0 = jnp.take_along_axis(nts1, r0[:, None], 1)[:, 0]
        n1_r1 = jnp.take_along_axis(nts1, r1[:, None], 1)[:, 0]
        n1_r2 = jnp.take_along_axis(nts1, r2[:, None], 1)[:, 0]
        n2_r0 = jnp.take_along_axis(nts2, r0[:, None], 1)[:, 0]
        n2_r1 = jnp.take_along_axis(nts2, r1[:, None], 1)[:, 0]
        n2_r2 = jnp.take_along_axis(nts2, r2[:, None], 1)[:, 0]
        n0_r1 = jnp.take_along_axis(nts0, r1[:, None], 1)[:, 0]
        n0_r2 = jnp.take_along_axis(nts0, r2[:, None], 1)[:, 0]
        g0, g1_, g2 = good[:, 0], good[:, 1], good[:, 2]
        m2 = bool(mes >= 2)
        gate1 = (nkrem > 1) & n1_r1 & g1_
        gates = jnp.stack([
            gate1,                                             # nem1
            n1_r0 & g0,                                        # ned1
            (nkrem > 1) & n0_r1 & g1_,                         # nei1
            (~gate1) & (nkrem > 2) & n2_r2 & m2 & g2,          # nem2
            (nkrem > 1) & n2_r1 & m2 & g1_,                    # nemd
            n2_r0 & m2 & g0,                                   # ned2
            (nkrem > 2) & n1_r2 & m2 & g2,                     # nemi
            (nkrem > 2) & n0_r2 & m2 & g2,                     # nei2
        ], axis=1)                                         # (B, 8)
        gate_chain = jnp.take_along_axis(
            gates, jnp.broadcast_to(famid_j[None, :], (B_, NCHAINS)),
            axis=1)                                        # (B, 62)

        # ---- chain inits ----
        x0_lo = (w_lo[:, 1] & ~jnp.uint32(3))[:, None] \
            | a4[None, :].astype(jnp.uint32)               # (B, 4)
        x0_hi = jnp.broadcast_to(w_hi[:, 1][:, None], (B_, 4))
        x01 = [shift1(x0_lo[:, b], x0_hi[:, b],
                      jnp.full((B_,), b1, jnp.int32))
               for b in range(4) for b1 in range(4)]
        x01_lo = jnp.stack([p[0] for p in x01], 1)         # (B, 16)
        x01_hi = jnp.stack([p[1] for p in x01], 1)
        w0l, w0h = w_lo[:, 0:1], w_hi[:, 0:1]
        init_lo = jnp.concatenate(
            [x0_lo, x0_lo, w0l, x01_lo, x01_lo, x01_lo, x0_lo, w0l], 1)
        init_hi = jnp.concatenate(
            [x0_hi, x0_hi, w0h, x01_hi, x01_hi, x01_hi, x0_hi, w0h], 1)
        g3m16 = g3m.reshape(B_, 16)
        nts0m_b = nts0m[:, None]
        init_mask = jnp.concatenate(
            [or1m, or1m, nts0m_b, g3m16, g3m16, g3m16, or1m, nts0m_b],
            1)                                             # (B, 62)
        e0 = nts0                                          # (B, 4)
        e01 = (e0[:, :, None]
               & (((or1m[:, :, None] >> a4) & 1) > 0)).reshape(B_, 16)
        tru = jnp.ones((B_, 1), bool)
        enable = jnp.concatenate(
            [e0, e0, tru, e01, e01, e01, e0, tru], 1)      # (B, 62)

        # ---- chain k-mers (precomputed; graph-independent) ----
        jt = joff_j[None, :] + jnp.arange(
            1, k + 1, dtype=jnp.int32)[:, None]            # (k, 62)
        jt_c = jnp.clip(jt, 0, k + 1)
        ck_lo, ck_hi = [], []
        lo_t, hi_t = init_lo, init_hi
        for t in range(k):
            nt_t = jnp.take(rnt, jt_c[t], axis=1)          # (B, 62)
            lo_t, hi_t = shift1(lo_t, hi_t, nt_t)
            ck_lo.append(lo_t)
            ck_hi.append(hi_t)
        ck_lo = jnp.stack(ck_lo, 1)                        # (B, k, 62)
        ck_hi = jnp.stack(ck_hi, 1)
        found, bits = probe(ck_lo.reshape(B_, -1),
                            ck_hi.reshape(B_, -1), loc[:, None])
        found = found.reshape(B_, k, NCHAINS)
        bits = bits.reshape(B_, k, NCHAINS)

        # ---- prefix-AND scoring with the stale-mask forward fill ----
        alive = enable & gate_chain
        m = init_mask
        cnt = jnp.zeros((B_, NCHAINS), jnp.int32)
        jmax = jnp.minimum(k + jmaxo_j[None, :], nkrem[:, None])
        for t in range(k):
            inb = jt[t][None, :] < jmax
            goodj = jnp.take(good, jt_c[t], axis=1)
            ck_nt = (ck_lo[:, t] & 3).astype(jnp.int32)
            chk = ((m >> ck_nt) & 1) > 0
            ok = alive & inb & goodj & chk
            cnt = cnt + ok.astype(jnp.int32)
            m = jnp.where(ok & found[:, t], bits[:, t], m)
            alive = ok
        return cnt

    if not jit:
        return scorer
    import jax

    return jax.jit(scorer)


def sites_to_batch(site_list, k: int = 21, B: int | None = None):
    """Host prep: [(kmers, ki, locus)] -> padded (w_lo, w_hi, nkrem,
    loc) arrays for make_site_scorer (pad rows score 0: nkrem = 0)."""
    n = len(site_list)
    B = B or n
    w_lo = np.full((B, k + 3), 0xFFFFFFFF, dtype=np.uint32)
    w_hi = np.full((B, k + 3), 0xFFFFFFFF, dtype=np.uint32)
    nkrem = np.zeros(B, dtype=np.int32)
    loc = np.zeros(B, dtype=np.int32)
    for i, (kmers, ki, li) in enumerate(site_list[:B]):
        w, _, _, nr = site_inputs(np.asarray(kmers, dtype=np.uint64),
                                  ki, k)
        w_lo[i] = (w & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        w_hi[i] = (w >> np.uint64(32)).astype(np.uint32)
        nkrem[i] = nr
        loc[i] = li
    return w_lo, w_hi, nkrem, loc
