"""Device aligner: the asgn-mode genotyping pipeline as fixed-shape
vectorized JAX, with a host referee for the rare pairs whose outcome depends
on the reference's early-stop scan order.

Pipeline per batch (all jitted, shape-static):

  pack(2P, L) u8 codes
   -> extract canonical k-mers + (k+1)-edges     (ops/kmers_jax)
   -> kmerDBi probe                              (index/device_table)
   -> subfilter / kfilter                        (reductions)
   -> locus voting: per-pair dedupe (lax.sort) -> CSR locus expansion
      -> per-(pair,locus) segment sums -> top/tie detection
   -> TR/flank annotation probe ((kmer,dst0) composite table)
   -> vectorized assignTRkmc state machine (associative scans)
   -> scatter-add TR k-mer counts / per-locus aggregates

Decision equivalence with the reference (aQueryFasta_thread.cpp:364-453):
full-count voting yields the same destLocus and pass/fail as the
early-stopped scan except when (a) two loci tie for the top vote, or
(b) the pair passes only via test2 (fc+rc >= 2*cth) -- the truncated
counts could fail it.  Such pairs (plus expansion-capacity overflows) are
masked out of all device accumulation and recomputed exactly by the host
oracle (engine/host_align.process_pair).  Everything else is provably
identical, so end-to-end outputs stay bit-exact.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

import jax
import jax.numpy as jnp

from ..index import device_table as dt
from ..ops.kmers_jax import EMPTY, extract_kmers_edges
from .host_align import AlignConfig, RPGG

NAN32 = np.uint32(0xFFFFFFFF)

# perf-bisect hook: set to 'probe'|'vote'|'annot'|'assign' to truncate the
# step after that stage (returns dummy outputs); None = full step
DEBUG_STOP = None


# ---------------------------------------------------------------------------
# Host-side table construction from the RPGG
# ---------------------------------------------------------------------------

ANN_FL = 1
ANN_TR = 2


@dataclass
class DeviceRPGG:
    """Device-resident RPGG model: flat tables + metadata."""
    nloci: int
    dbi_tab: dt.BucketTable
    vv: np.ndarray
    trfl_tab: dt.BucketTable      # (kmer, locus) -> (slot<<2)|ANN  or ANN_FL
    tre_tab: dt.BucketTable | None  # (edge, locus) -> 1
    locus_offsets: np.ndarray     # slot base per locus (trkmc flatten order)
    nslots: int
    bait_tab: dt.BucketTable | None = None  # (kmer, locus) -> (mi<<8)|ma
    qc: np.ndarray | None = None            # u8[nloci] pass mask
    graph_tab: dt.BucketTable | None = None  # (nc kmer, locus) -> edge mask
    member_tab: dt.BucketTable | None = None  # kmer -> (membership only):
    # 2-plane rows for the prefilter, which never reads vals — the
    # narrower row gathers measurably faster than the 4-plane dbi rows

    def dev(self, name: str, builder):
        """Memoized device upload.  Every step builder (primary, retry
        tiers, prefilter, a second runner over the same index) shares
        ONE device copy of each table: at production scale the dbi+trfl
        tables are gigabytes, and a re-upload per make_step call would
        hold a second copy for every step built."""
        cache = self.__dict__.setdefault("_dev_cache", {})
        if name not in cache:
            cache[name] = builder()
        return cache[name]

    def add_graph(self, rpgg: RPGG):
        """Builds the dBG transition table for the threading DFA walk
        (GraphType node -> 4-bit out-edge mask, per locus)."""
        graphs = rpgg.load_graphs()
        gk, gl, gv = [], [], []
        for li, g in enumerate(graphs):
            for km, mask in g.items():
                gk.append(km)
                gl.append(li)
                gv.append(mask)
        self.graph_tab = dt.build_bucket_table(
            np.array(gk, np.uint64), np.array(gv, np.uint32),
            np.array(gl, np.uint32))

    @classmethod
    def build(cls, rpgg: RPGG, with_tre: bool = True) -> "DeviceRPGG":
        keys = np.fromiter(rpgg.dbi.keys(), dtype=np.uint64,
                           count=len(rpgg.dbi))
        vals = np.fromiter(rpgg.dbi.values(), dtype=np.uint32,
                           count=len(rpgg.dbi))

        # trfl annotation entries; TR slot ids follow the .trkmc.ar flatten
        # order (per-locus insertion order of pan.tr.kmers).  Value
        # encoding: (rank << 3) | (in_tr << 2) | ann, where rank is the
        # slot's offset WITHIN its locus (slot = locus_offsets[dst] +
        # rank, resolved on device); ann 1=flank 2=TR (flank wins when a
        # kmer is in both sets, assignTRkmc :1464-1467, but aln-mode
        # counting still needs the TR slot -> in_tr bit).  Rank encoding
        # keeps the u32 value plane valid at production index scale:
        # global slots reach 1.2e9 (>2^29, which a (slot<<3) u32 cannot
        # hold), ranks stay < kmers-per-locus.
        tk, tl, tv = [], [], []
        offsets = np.zeros(rpgg.nloci + 1, dtype=np.int64)
        slot = 0
        for li in range(rpgg.nloci):
            offsets[li] = slot
            fl = rpgg.fl_sets[li]
            for rank, km in enumerate(rpgg.tr_orders[li]):
                tk.append(km)
                tl.append(li)
                if km in fl:
                    tv.append((rank << 3) | (1 << 2) | ANN_FL)
                else:
                    tv.append((rank << 3) | ANN_TR)
                slot += 1
            for km in fl:
                if km not in rpgg.tr_counts[li]:
                    tk.append(km)
                    tl.append(li)
                    tv.append(ANN_FL)
        offsets[rpgg.nloci] = slot

        # A single-locus k-mer (even dbi encoding) has exactly ONE trfl
        # entry — (km, its locus) — so its annotation value rides in the
        # dbi row itself (second value plane, fetched by the same row
        # gather).  Only multi-locus (vv) k-mers
        # keep composite-table entries, which shrinks the trfl table to
        # the sharing tail and turns most annotation-probe lanes into
        # constant-bucket no-ops (see make_step).
        tk_a = np.array(tk, dtype=np.uint64)
        tl_a = np.array(tl, dtype=np.uint32)
        tv_a = np.array(tv, dtype=np.uint32)
        korder = np.argsort(keys, kind="stable")
        sk = keys[korder]
        pos = np.searchsorted(sk, tk_a)
        if len(tk_a):
            assert len(sk) > 0, "trfl kmers present but kmerDBi is empty"
            assert (sk[np.minimum(pos, len(sk) - 1)] == tk_a).all(), \
                "trfl kmer missing from kmerDBi"
        entry_even = (vals[korder[pos]] & 1) == 0 if len(tk_a) else \
            np.zeros(0, dtype=bool)
        ee = korder[pos[entry_even]]
        # an even (single-locus) dbi entry must (a) point at the same
        # locus as its trfl entry — ev_hit attaches the annotation at the
        # dbi-encoded locus — and (b) own exactly ONE trfl entry; an
        # index violating either would silently corrupt annotations, so
        # fail loudly at build time instead
        assert (tl_a[entry_even] == (vals[ee] >> 1)).all(), \
            "single-locus dbi entry locus != its trfl entry locus"
        if len(ee):
            ees = np.sort(ee)
            assert not (ees[1:] == ees[:-1]).any(), \
                "multiple trfl entries map to one single-locus dbi entry"
        ann = np.zeros(len(keys), dtype=np.uint32)
        ann[ee] = tv_a[entry_even]
        dbi_tab = dt.build_bucket_table(keys, vals, vals2=ann)
        trfl_tab = dt.build_bucket_table(
            tk_a[~entry_even], tv_a[~entry_even], tl_a[~entry_even])

        tre_tab = None
        if with_tre:
            ek, el = [], []
            for li in range(rpgg.nloci):
                for e in rpgg.tre_sets[li]:
                    ek.append(e)
                    el.append(li)
            if ek:
                tre_tab = dt.build_bucket_table(
                    np.array(ek, dtype=np.uint64),
                    np.ones(len(ek), dtype=np.uint32),
                    np.array(el, dtype=np.uint32))
        vv = rpgg.vv.astype(np.uint32)
        if len(vv) == 0:
            vv = np.zeros(1, dtype=np.uint32)  # keep gathers well-formed
        bait_tab = None
        if rpgg.bait_dbs is not None:
            bk, bl, bv = [], [], []
            for li, db in enumerate(rpgg.bait_dbs):
                for km, v in db.items():
                    bk.append(km)
                    bl.append(li)
                    bv.append(v)
            if bk:
                bait_tab = dt.build_bucket_table(
                    np.array(bk, np.uint64), np.array(bv, np.uint32),
                    np.array(bl, np.uint32))
        qc = rpgg.qc_filter
        member_tab = dt.build_bucket_table(keys, None)
        return cls(rpgg.nloci, dbi_tab, vv, trfl_tab,
                   tre_tab, offsets, slot, bait_tab, qc,
                   member_tab=member_tab)


# ---------------------------------------------------------------------------
# The jitted batch step
# ---------------------------------------------------------------------------

def _seg_last_nonzero_excl(x):
    """y[i] = last nonzero x[j] for j < i (0 if none), along axis -1."""
    shifted = jnp.concatenate(
        [jnp.zeros_like(x[..., :1]), x[..., :-1]], axis=-1)
    return jax.lax.associative_scan(
        lambda a, b: jnp.where(b > 0, b, a), shifted, axis=-1)


def _cummax(x):
    return jax.lax.associative_scan(jnp.maximum, x, axis=-1)


def _first_true_idx(m):
    """Index of first True along axis -1, or width if none."""
    w = m.shape[-1]
    idx = jnp.where(m, jnp.arange(w, dtype=jnp.int32), w)
    return jnp.min(idx, axis=-1)


def _next_true_idx_excl(m):
    """For each position p: smallest j > p with m[j] True, else width.

    Reverse cumulative min of masked indices (log-depth scan, no scatter).
    """
    w = m.shape[-1]
    idx = jnp.where(m, jnp.arange(w, dtype=jnp.int32), w)
    rev = jax.lax.associative_scan(jnp.minimum, idx, axis=idx.ndim - 1,
                                   reverse=True)
    return jnp.concatenate(
        [rev[..., 1:], jnp.full(m.shape[:-1] + (1,), w, jnp.int32)],
        axis=-1)


def _shifted_cumsum(x):
    """Exclusive prefix sum along -1 (c[p] = sum of x[:p])."""
    c = jnp.cumsum(x, axis=-1)
    return jnp.concatenate(
        [jnp.zeros(x.shape[:-1] + (1,), c.dtype), c[..., :-1]], axis=-1)


def _row_gather(values, idx):
    """In-row gather: y[c][p, e] = values[c][p, idx[p, e]] (idx in range)."""
    return [jnp.take_along_axis(v, idx, axis=-1) for v in values]


def _row_scatter_bool(mask, idx, W):
    """Permutation scatter: out[p, idx[p, e]] = mask[p, e]; idx must be a
    permutation of 0..W-1 per row."""
    rows = jnp.arange(mask.shape[0], dtype=jnp.int32)[:, None]
    return jnp.zeros((mask.shape[0], W), bool).at[rows, idx].set(
        mask, unique_indices=True)


def _expand_gather(values, csum, E):
    """CSR expansion gather.  Row p expands position w into
    csum[p, w] - csum[p, w-1] consecutive slots (csum: (P, W) inclusive
    prefix sums, non-decreasing); slot e takes values[c][p, w] of the
    position that covers it, i.e. the first w with csum[p, w] > e.  Slots
    at or past the row's total csum[p, -1] get 0.  -> list of (P, E)."""
    W = csum.shape[-1]
    eidx = jnp.arange(E, dtype=jnp.int32)
    cov = jnp.sum((csum[:, None, :] <= eidx[None, :, None])
                  .astype(jnp.int32), axis=-1)
    valid = eidx[None, :] < csum[:, -1:]
    return [jnp.where(valid, g, 0)
            for g in _row_gather(values, jnp.minimum(cov, W - 1))]


def expand_gather_np(values, csum, E):
    """Host reference for _expand_gather (np.repeat per row)."""
    P, W = csum.shape
    nm = np.diff(np.concatenate([np.zeros((P, 1), csum.dtype), csum], 1))
    out = [np.zeros((P, E), v.dtype) for v in values]
    for p in range(P):
        src = np.repeat(np.arange(W), nm[p])[:E]
        for o, v in zip(out, values):
            o[p, :len(src)] = v[p, src]
    return out


def _seg_bcast(val_at_start, segnew, fill):
    """Forward-fill the value at each segment start across its segment
    (log-depth segmented scan; positions before the first start -> fill)."""
    v0 = jnp.where(segnew, val_at_start, fill)

    def comb(a, b):
        s_a, v_a = a
        s_b, v_b = b
        return s_a | s_b, jnp.where(s_b, v_b, v_a)

    _, out = jax.lax.associative_scan(comb, (segnew, v0), axis=-1)
    return out


def _range_sum(x, start, end_excl):
    """Sum of x over [start, end_excl) per row via prefix-sum gathers;
    start/end are (..., W) index arrays (end may be W -> use inclusive
    trick on padded prefix sums)."""
    c = jnp.cumsum(x, axis=-1)
    cpad = jnp.concatenate(
        [jnp.zeros(x.shape[:-1] + (1,), c.dtype), c], axis=-1)
    w = x.shape[-1]
    e = jnp.clip(end_excl, 0, w)
    s = jnp.clip(start, 0, w)
    return jnp.take_along_axis(cpad, e, axis=-1) - \
        jnp.take_along_axis(cpad, s, axis=-1)


def _take_rows(a, idx):
    """a: (..., W); idx: (...) -> a[..., idx] with clamping."""
    idxc = jnp.clip(idx, 0, a.shape[-1] - 1)
    return jnp.take_along_axis(a, idxc[..., None], axis=-1)[..., 0]


def prefilter_sample(codes, rlen, k, nf, L):
    """Subfilter query sampling (reference subfilter :172-188): the nf
    evenly-spaced canonical k-mers per read, gathered in-row.
    -> (qlo, qhi, valid, nk), EMPTY-masked where invalid."""
    NKW = L - k + 1
    ex = extract_kmers_edges(codes, rlen, k)
    nk = ex["nk"]
    S = nk // (nf - 1)
    # sampled window start positions per read: i*S (i<nf-1), nk-1
    starts = jnp.stack(
        [jnp.where(jnp.int32(i) != nf - 1, i * S, nk - 1)
         for i in range(nf)], axis=1)                       # (B, nf)
    starts = jnp.clip(starts, 0, NKW - 1)
    qlo, qhi, vmask = _row_gather(
        [ex["klo"], ex["khi"], ex["kvalid"]], starts)
    valid = vmask & (starts < nk[:, None])
    qlo = jnp.where(valid, qlo, EMPTY)
    qhi = jnp.where(valid, qhi, EMPTY)
    return qlo, qhi, valid, nk


def prefilter_decide(found, valid, nk, live, nmf, P):
    found = found & valid
    hits = found.sum(axis=1)
    read_pass = hits >= nmf
    nonshort = nk > 0
    return (read_pass & nonshort).reshape(P, 2).all(axis=1) & live


def make_prefilter_step(drp: DeviceRPGG, cfg: AlignConfig, P: int, L: int,
                        jit: bool = True):
    """Cheap first-pass subfilter (reference subfilter :172-188): probe only
    n_filter sampled k-mers per read; a pair survives if both mates hit
    >= nm_filter.  Genome-wide, ~99% of read pairs die here, so the full
    pipeline only sees survivors (host re-packs them densely).

    Returns step(codes, rlen, live) -> survive (P,) bool, byte-identical
    in decision to the full step's subfilter stage.  With ``jit=False``
    returns (step(tabs, codes, rlen, live), tabs) for callers that wrap
    the step in their own jit.
    """
    k = cfg.ksize
    nf, nmf = cfg.n_filter, cfg.nm_filter
    ptab, tabs, salts = _prefilter_tables(drp)

    def step(tabs, codes, rlen, live):
        qlo, qhi, valid, nk = prefilter_sample(codes, rlen, k, nf, L)
        found = dt.lookup_bucket_jax(ptab, qlo, qhi,
                                     levels_dev=list(zip(tabs, salts)))[0]
        return prefilter_decide(found, valid, nk, live, nmf, P)

    if not jit:
        return step, tabs
    jitted = jax.jit(step)
    return lambda codes, rlen, live: jitted(tabs, codes, rlen, live)


def _prefilter_tables(drp: DeviceRPGG):
    """(host table, device levels, salts) of the prefilter's membership
    table (the narrower member_tab rows when built, see DeviceRPGG)."""
    ptab = drp.member_tab if drp.member_tab is not None else drp.dbi_tab
    tabs = drp.dev("pre", lambda: [jnp.asarray(t) for t, _ in ptab.levels])
    return ptab, tabs, [s for _, s in ptab.levels]


def make_prefilter_step_q(drp: DeviceRPGG, cfg: AlignConfig, P: int):
    """Prefilter over host-sampled queries (kmers_np.sample_subfilter_queries):
    the dispatch uploads nf u32-pair queries per read instead of the
    L-byte code rows (~4x less transfer on the ingest-bound production
    path).  Decision-identical to make_prefilter_step.

    Returns step(qlo, qhi, valid, nonshort, live) -> survive (P,) bool.
    """
    nmf = cfg.nm_filter
    ptab, tabs, salts = _prefilter_tables(drp)

    @jax.jit
    def step(tabs, qlo, qhi, valid, nonshort, live):
        found = dt.lookup_bucket_jax(ptab, qlo, qhi,
                                     levels_dev=list(zip(tabs, salts)))[0]
        read_pass = (found & valid).sum(axis=1) >= nmf
        return (read_pass & nonshort).reshape(P, 2).all(axis=1) & live

    return lambda qlo, qhi, valid, nonshort, live: step(
        tabs, qlo, qhi, valid, nonshort, live)


def qmask_batch(quals: np.ndarray, rlen: np.ndarray, qth: int,
                k: int) -> np.ndarray:
    """Vectorized qString2qMask (aQueryFasta_thread.h:1043-1078) over a
    (R, L) batch of raw phred+33 quality bytes (0-padded).

    The reference's two-pointer scan is NOT a plain sliding-window AND:
    once the scan position reaches nk (= nq-k+1), later windows are left
    False even if their bases all pass.  Fuzz-verified closed form:
        qmask[w] = all(q[w..w+k-1] >= qth)
                   AND (w <= nk-k  OR  w is a good-run start)
    Returns (R, L-k+1) bool aligned with the k-mer window index.
    """
    R, L = quals.shape
    NKW = L - k + 1
    good = (quals.astype(np.int32) - 33) >= qth
    # padded tail bytes are 0 -> good False there already
    c = np.cumsum(good.astype(np.int32), axis=1)
    c = np.concatenate([np.zeros((R, 1), np.int32), c], axis=1)
    fullgood = (c[:, k:] - c[:, :-k]) == k          # (R, NKW)
    w = np.arange(NKW, dtype=np.int32)[None, :]
    nk = (rlen - k + 1).astype(np.int32)[:, None]
    runstart = np.concatenate(
        [np.ones((R, 1), bool), ~good[:, : NKW - 1]], axis=1)
    return fullgood & (w < nk) & ((w <= nk - k) | runstart)


def make_step(drp: DeviceRPGG, cfg: AlignConfig, P: int, L: int,
              expand_cap: int = 512, with_annot: bool = True,
              with_bubbles: bool = False, jit: bool = True,
              threading: bool = False, probe_fns: dict | None = None,
              with_qual: bool = False):
    """Builds the (by default jitted) per-batch function.

    probe_fns: optional {"dbi": fn(q_lo, q_hi), "trfl": fn(q_lo, q_hi,
    q_loc)} overriding the replicated-table probes — the hook
    parallel.sharded_index uses to answer probes collectively from
    mesh-sharded tables (the overridden tables are then not uploaded).

    Returns step(state, codes(2P,L) u8, rlen(2P,) i32, live(P,) bool)
      -> (state, outputs dict)
    state: dict of device accumulators (counts, nmapread, kmc, stats).
    The device tables are always jit ARGUMENTS, never closure constants
    (a constant would embed gigabytes of index in the executable and in
    its compile-cache key).  With ``jit=False`` returns
    (step(tabs, state, codes, rlen, live, qmask=None), tabs).
    """
    k = cfg.ksize
    cth = np.int32(cfg.cth)
    NKW = L - k + 1
    NE = L - k
    E = expand_cap
    nloci = drp.nloci
    # split expansion (see the vote section): E only holds vv-listed
    # (multi-locus) k-mer expansions; unique k-mers stay unexpanded in
    # the W plane.  Default ON (byte-exact either way);
    # DTK_SPLIT_EXPAND=0 restores the unsplit layout.
    SPLIT = os.environ.get("DTK_SPLIT_EXPAND", "1") == "1"
    # DTK_VOTE_EQ=1: sort-free event-space voting — per-locus totals via
    # one batched equality-matmul + fused masked reduces instead of the
    # (locus, -nm) lax.sort.  Decision-identical (tested); see the vote
    # block below for the trade.
    VOTE_EQ = os.environ.get("DTK_VOTE_EQ", "0") == "1"
    probe_fns = probe_fns or {}

    # vv rides as (ceil(n/8), 8) rows: one wide-row gather + lane select
    # per lookup instead of a scalar gather
    nvv = len(drp.vv)

    def _vv8():
        vv8 = np.zeros((max(nvv + 7, 8) // 8) * 8, dtype=np.uint32)
        vv8[:nvv] = drp.vv
        return jnp.asarray(vv8.reshape(-1, 8))

    def levels(name, tab):
        return drp.dev(name, lambda: [jnp.asarray(t) for t, _ in tab.levels])

    # uploads are memoized on the DeviceRPGG (drp.dev): the primary
    # step, every retry tier, and any further runner over the same index
    # share one device copy of each table
    tabs = {
        "vv": drp.dev("vv", _vv8),
        # per-locus slot bases: annotation values carry the RANK within
        # the locus (u32-safe at any index size); slot = loff[dst] + rank
        "loff": drp.dev("loff", lambda: jnp.asarray(np.asarray(
            drp.locus_offsets, np.int64).astype(np.int32))),
    }
    salts = {}
    named = [("dbi", drp.dbi_tab, "dbi" not in probe_fns),
             ("trfl", drp.trfl_tab, "trfl" not in probe_fns),
             ("tre", drp.tre_tab, with_bubbles and drp.tre_tab is not None),
             ("bait", drp.bait_tab, cfg.bait and drp.bait_tab is not None)]
    if threading:
        assert drp.graph_tab is not None, "call drp.add_graph(rpgg) first"
        named.append(("graph", drp.graph_tab, True))
    for name, tab, used in named:
        if used:
            tabs[name] = levels(name, tab)
            salts[name] = [s for _, s in tab.levels]
    if cfg.qc and drp.qc is not None:
        tabs["qc"] = drp.dev("qc", lambda: jnp.asarray(
            np.concatenate([drp.qc.astype(np.uint8), [0]])))

    def step(tb, state, codes, rlen, live, qmask=None):
        def lv(name):
            return list(zip(tb[name], salts[name])) if name in tb else None

        dbi_lv = lv("dbi")
        vv8 = tb["vv"]                     # (ceil(nvv/8), 8) rows

        def vv_at(pos):
            # wide-row gather + lane select (see the vv note above)
            p = jnp.clip(pos, 0, nvv - 1 if nvv else 0)
            rows = vv8[p >> 3]
            lane1h = (p & 7)[..., None] == jnp.arange(8, dtype=jnp.int32)
            return jnp.where(lane1h, rows, 0).sum(
                axis=-1, dtype=jnp.uint32)
        trfl_lv = lv("trfl")
        tre_lv = lv("tre")
        bait_lv = lv("bait")
        qc_arr = tb.get("qc")
        graph_lv = lv("graph")
        ex = extract_kmers_edges(codes, rlen, k)
        klo, khi, kvalid = ex["klo"], ex["khi"], ex["kvalid"]
        nk = ex["nk"]                      # (2P,)
        any_valid = ex["any_valid"]

        if "dbi" in probe_fns:
            found, val, annv = probe_fns["dbi"](klo, khi)
        else:
            found, val, annv = dt.lookup_bucket_jax(
                drp.dbi_tab, klo, khi, levels_dev=dbi_lv)
        found = found & kvalid

        pair_nonshort = (any_valid.reshape(P, 2).all(axis=1)) & live
        if DEBUG_STOP == 'probe':
            s2 = dict(state); s2['stats'] = state['stats'].at[0].add(
                (found.sum() + val.sum()).astype(state['stats'].dtype))
            return s2, dict(x=s2['stats'][0])

        # ---- subfilter ----
        nf, nmf = cfg.n_filter, cfg.nm_filter
        if nf and nmf:
            S = nk // (nf - 1)
            hits = jnp.zeros((2 * P,), jnp.int32)
            for i in range(nf):
                idx = jnp.where(jnp.int32(i) != nf - 1, i * S, nk - 1)
                hits = hits + _take_rows(found, idx).astype(jnp.int32)
            sub_pass = (hits >= nmf).reshape(P, 2).all(axis=1)
        else:
            sub_pass = jnp.ones((P,), bool)
        pair_sub = pair_nonshort & sub_pass

        # ---- kfilter ----
        nfound = found.sum(axis=-1).astype(jnp.int32)
        kf = (nfound < cth).astype(jnp.int32)         # (2P,)
        kf_p = kf.reshape(P, 2)
        pair_kf = pair_sub & ~(kf_p.all(axis=1))

        # ---- voting ----
        # merge mates; exclude kf-failed mates' entries
        use = found & (kf.reshape(2 * P, 1) == 0)
        use = use & pair_kf.repeat(2)[:, None]
        m_lo = jnp.where(use, klo, EMPTY).reshape(P, 2 * NKW)
        m_hi = jnp.where(use, khi, EMPTY).reshape(P, 2 * NKW)
        m_val = val.reshape(P, 2 * NKW)
        mate = jnp.tile(
            jnp.repeat(jnp.arange(2, dtype=jnp.int32), NKW)[None, :], (P, 1))
        m_use = use.reshape(P, 2 * NKW)

        s_hi, s_lo, s_val, s_mate, s_use = jax.lax.sort(
            (m_hi, m_lo, m_val, mate, m_use.astype(jnp.int32)),
            dimension=-1, num_keys=2)
        s_use = s_use.astype(bool)
        W = 2 * NKW
        # invalid entries (EMPTY keys) sort to the end.  All run statistics
        # live at run-START positions (scatter-free: prefix-sum differences
        # between consecutive starts).
        newrun = s_use & jnp.concatenate(
            [jnp.ones((P, 1), bool),
             (s_hi[:, 1:] != s_hi[:, :-1]) | (s_lo[:, 1:] != s_lo[:, :-1])],
            axis=1)
        nxt = _next_true_idx_excl(newrun)          # next run start (or W)
        run_end = jnp.where(s_use, jnp.minimum(
            nxt, jnp.sum(s_use, axis=-1, keepdims=True)), 0)
        # run counts = prefix-sum difference between run start and end; the
        # start-side term is the position's own exclusive prefix (no
        # gather), the end-side term is one in-row gather
        cf = jnp.cumsum((s_use & (s_mate == 0)).astype(jnp.int32), axis=-1)
        cr = jnp.cumsum((s_use & (s_mate == 1)).astype(jnp.int32), axis=-1)
        cf_pad = jnp.concatenate(
            [jnp.zeros((P, 1), jnp.int32), cf], axis=-1)
        cr_pad = jnp.concatenate(
            [jnp.zeros((P, 1), jnp.int32), cr], axis=-1)
        cf_end, cr_end = _row_gather([cf_pad, cr_pad], run_end)
        fcnt = jnp.where(newrun, cf_end - cf_pad[:, :-1], 0)
        rcnt = jnp.where(newrun, cr_end - cr_pad[:, :-1], 0)
        rval = s_val                                # valid at run starts

        if DEBUG_STOP == 'vote_sort1':
            s2 = dict(state); s2['stats'] = state['stats'].at[0].add(
                (fcnt.sum() + rcnt.sum() + rval.sum()).astype(
                    state['stats'].dtype))
            return s2, dict(x=s2['stats'][0])
        odd = (rval & 1) == 1
        nmapped = jnp.where(
            odd, vv_at((rval >> 1).astype(jnp.int32)), 1).astype(jnp.int32)
        nmapped = jnp.where(newrun, nmapped, 0)
        if DEBUG_STOP == 'vote_nm':
            s2 = dict(state); s2['stats'] = state['stats'].at[0].add(
                nmapped.sum().astype(state['stats'].dtype))
            return s2, dict(x=s2['stats'][0])

        # CSR expansion of loci lists into E slots per pair: every slot
        # gathers the run statistics of its covering run.
        #
        # SPLIT expansion (DTK_SPLIT_EXPAND=1): single-locus (even-val)
        # k-mers need no expansion at all — their one event stays at its
        # run position in the W plane; only vv-listed (odd) runs expand
        # into E slots, and the downstream per-locus segment machinery
        # runs over the CONCATENATED W+E event plane.  E then only has
        # to hold the odd demand (~5% of the total on WGS-shaped panels,
        # p99=65 vs 288 on the bench panel), so the expansion and the
        # census shrink ~4x at equal overflow rates.  Decision-identical:
        # even events carry nm=1 exactly as their single expansion slot
        # did.
        odd_run = newrun & ((rval & 1) == 1)
        nm_x = jnp.where(odd_run, nmapped, 0) if SPLIT else nmapped
        csum = jnp.cumsum(nm_x, axis=-1)
        total = csum[:, -1]
        overflow = total > E
        starts = csum - nm_x
        eidx = jnp.arange(E, dtype=jnp.int32)[None, :]
        evalid_exp = eidx < jnp.minimum(total, E)[:, None]
        # only expanding runs advance csum, so every slot below the
        # total gathers the statistics of its covering run
        e_rval, e_starts, e_f0, e_r0, e_nm = _expand_gather(
            [rval, starts, fcnt, rcnt, nmapped], csum, E)
        if DEBUG_STOP == 'vote_gather':
            s2 = dict(state); s2['stats'] = state['stats'].at[0].add(
                (e_rval.sum() + e_f0.sum() + e_r0.sum()).astype(
                    state['stats'].dtype))
            return s2, dict(x=s2['stats'][0])
        e_off = eidx - e_starts
        e_odd = (e_rval & 1) == 1
        vv_pos = (e_rval >> 1).astype(jnp.int32) + 1 + e_off
        e_locus = jnp.where(
            e_odd, vv_at(vv_pos), (e_rval >> 1).astype(jnp.uint32))
        e_locus = jnp.where(evalid_exp, e_locus, NAN32)
        e_f = jnp.where(evalid_exp, e_f0, 0)
        e_r = jnp.where(evalid_exp, e_r0, 0)

        if DEBUG_STOP == 'vote_expand':
            s2 = dict(state); s2['stats'] = state['stats'].at[0].add(
                (e_locus.sum() + e_f.sum() + e_r.sum()).astype(
                    state['stats'].dtype))
            return s2, dict(x=s2['stats'][0])
        if SPLIT:
            # even (single-locus) events ride the W plane unexpanded;
            # event space = [W plane | E odd-expansion plane]
            even_run = newrun & ~odd_run
            w_loc = jnp.where(even_run,
                              (rval >> 1).astype(jnp.uint32), NAN32)
            w_f = jnp.where(even_run, fcnt, 0)
            w_r = jnp.where(even_run, rcnt, 0)
            w_nm = even_run.astype(jnp.int32)
            widx = jnp.broadcast_to(
                jnp.arange(W, dtype=jnp.int32)[None, :], (P, W))
            ev_locus = jnp.concatenate([w_loc, e_locus], axis=1)
            ev_f = jnp.concatenate([w_f, e_f], axis=1)
            ev_r = jnp.concatenate([w_r, e_r], axis=1)
            ev_nm_mask = jnp.concatenate(
                [w_nm, jnp.where(evalid_exp, e_nm, 0)], axis=1)
            ev_starts = jnp.concatenate([widx, W + e_starts], axis=1)
            ev_run_nm = jnp.concatenate(
                [jnp.ones((P, W), jnp.int32), e_nm], axis=1)
            EV = W + E
        else:
            ev_locus, ev_f, ev_r = e_locus, e_f, e_r
            ev_nm_mask = jnp.where(evalid_exp, e_nm, 0)
            ev_starts, ev_run_nm = e_starts, e_nm
            EV = E
        ev_idx = jnp.broadcast_to(
            jnp.arange(EV, dtype=jnp.int32)[None, :], (P, EV))
        # ---- per-(pair, locus) totals + tie machinery ----
        # Two interchangeable implementations (byte-identical decisions):
        #   sort path (default): in-row lax.sort by (locus, -nmapped) +
        #     prefix-sum differences at segment starts.
        #   event-space path (DTK_VOTE_EQ=1): no
        #     sort — per-event locus totals ride ONE batched bf16
        #     equality-matmul (operands <= NKW < 256 are
        #     bf16-exact; f32 accumulation), and the per-locus max-nm /
        #     representative-event reductions are fused masked reduces
        #     over the same (EV, EV) equality plane.  Trades the sort's
        #     O(EV log^2 EV) compare-swap passes for one materialized
        #     (P, EV, EV) bf16 operand + elementwise reduces.
        if VOTE_EQ:
            ev_valid = ev_locus != NAN32
            eqm = (ev_locus[:, :, None] == ev_locus[:, None, :]) \
                & ev_valid[:, :, None] & ev_valid[:, None, :]
            rhs = jnp.stack(
                [ev_f.astype(jnp.bfloat16), ev_r.astype(jnp.bfloat16)],
                axis=-1)                               # (P, EV, 2)
            sums = jax.lax.dot_general(
                eqm.astype(jnp.bfloat16), rhs,
                (((2,), (1,)), ((0,), (0,))),
                preferred_element_type=jnp.float32)    # (P, EV, 2)
            tot_f = sums[..., 0].astype(jnp.int32)
            tot_r = sums[..., 1].astype(jnp.int32)
            # representative event = first occurrence of its locus
            first_idx = jnp.min(
                jnp.where(eqm, ev_idx[:, None, :], jnp.int32(EV)),
                axis=2)
            rep = ev_valid & (first_idx == ev_idx)
            # per-locus max nmapped (what the -nm secondary key gave the
            # sort path's segment leaders)
            nm_max = jnp.max(
                jnp.where(eqm, ev_nm_mask[:, None, :], 0), axis=2)

            ev_tot = tot_f + tot_r
            top_tot = jnp.max(jnp.where(ev_valid, ev_tot, -1), axis=-1)
            is_top_ev = ev_valid & (ev_tot == top_tot[:, None])
            has_entries = ev_valid.any(axis=-1)
            n_top = jnp.sum(rep & is_top_ev, axis=-1)
            # sort path takes the FIRST top segment in locus-ascending
            # order == the smallest tied locus
            top_loc = jnp.min(
                jnp.where(is_top_ev, ev_locus, NAN32), axis=-1)
            sel_top = ev_valid & (ev_locus == top_loc[:, None])
            top_f = jnp.max(jnp.where(sel_top, tot_f, 0), axis=-1)
            top_r = jnp.max(jnp.where(sel_top, tot_r, 0), axis=-1)
            tie = (n_top > 1) & has_entries

            BIGI = jnp.int32(0x7FFFFFF0)
            m_lvl = jnp.min(
                jnp.where(rep & is_top_ev, nm_max, BIGI), axis=-1,
                keepdims=True)                         # (P, 1)
            cand_rep = rep & is_top_ev & (nm_max == m_lvl)
            nC = jnp.sum(cand_rep, axis=-1)
            winner1 = jnp.min(
                jnp.where(cand_rep, ev_locus, NAN32), axis=-1)
            # candidate events at their locus' max level m — direct in
            # event space (the sort path needs a scatter back via g_src)
            e_cand = is_top_ev & (nm_max == m_lvl) \
                & (ev_nm_mask == m_lvl)
        else:
            # per-(pair, locus) totals: in-row sort + prefix-sum
            # differences at segment starts (scatter-free).  Secondary
            # key -nmapped puts each locus segment's max-nmapped slot
            # FIRST (its last event in the reference's nmapped-ascending
            # scan, needed for the tie-break); g_src tracks the event
            # slot for the scatter back.
            # payload packing: f/r (< 2^8) and the slot id ride one i32
            # through the sort — 3 arrays instead of 5 moves 40% less
            # payload through lax.sort's passes.  Keys (locus, -nm) stay
            # exact, so the scan-order semantics are untouched.
            IDXB = max(EV - 1, 1).bit_length()
            assert 16 + IDXB <= 31, ("event width too large to pack", EV)
            e_pk = (ev_f << (8 + IDXB)) | (ev_r << IDXB) | ev_idx
            g_loc, g_negnm, g_pk = jax.lax.sort(
                (ev_locus, -ev_nm_mask, e_pk), dimension=-1, num_keys=2)
            g_f = g_pk >> (8 + IDXB)
            g_r = (g_pk >> IDXB) & 0xFF
            g_src = g_pk & ((1 << IDXB) - 1)
            g_nm = -g_negnm
            g_valid = g_loc != NAN32
            segnew = g_valid & jnp.concatenate(
                [jnp.ones((P, 1), bool),
                 (g_loc[:, 1:] != g_loc[:, :-1])], axis=1)
            # per-segment totals = prefix-sum difference between this
            # segment start and the next.  The next-start prefix value is
            # a reverse cumulative min over (segnew ? prefix : +inf) —
            # prefix sums are non-decreasing, so the nearest later
            # segment start is the min.  O(P*E) scans, no gather.
            gcf = jnp.concatenate([jnp.zeros((P, 1), jnp.int32),
                                   jnp.cumsum(g_f, axis=-1)], axis=-1)
            gcr = jnp.concatenate([jnp.zeros((P, 1), jnp.int32),
                                   jnp.cumsum(g_r, axis=-1)], axis=-1)
            BIG = jnp.int32(0x7FFFFFFF)
            segnew_pad = jnp.concatenate(
                [segnew, jnp.ones((P, 1), bool)], axis=1)  # sentinel at E
            mcf = jnp.where(segnew_pad, gcf, BIG)
            mcr = jnp.where(segnew_pad, gcr, BIG)
            gcf_end = jax.lax.associative_scan(
                jnp.minimum, mcf, axis=1, reverse=True)[:, 1:]
            gcr_end = jax.lax.associative_scan(
                jnp.minimum, mcr, axis=1, reverse=True)[:, 1:]
            seg_f = jnp.where(segnew, gcf_end - gcf[:, :-1], 0)
            seg_r = jnp.where(segnew, gcr_end - gcr[:, :-1], 0)

            seg_tot = jnp.where(segnew, seg_f + seg_r, -1)
            top_tot = jnp.max(seg_tot, axis=-1)
            is_top = segnew & (seg_tot == top_tot[:, None])
            n_top = jnp.sum(is_top, axis=-1)
            top_seg = _first_true_idx(is_top)
            top_loc = _take_rows(g_loc, top_seg)
            top_f = _take_rows(seg_f, top_seg)
            top_r = _take_rows(seg_r, top_seg)
            has_entries = segnew.any(axis=-1)

            tie = (n_top > 1) & has_entries

            # ---- scan-order tie resolution (updatetop2 semantics) ----
            # The reference's winner among full-total-tied loci is the
            # FIRST to reach the max during the nmapped-ascending entry
            # scan (updatetop2, aQueryFasta_thread.cpp:331-347) == the
            # tied locus whose LAST contributing entry is earliest in
            # scan order.  Scan order is (nmappedloci asc,
            # libstdc++-introsort tie order among equal nmapped, vv
            # position).  The introsort tie order is host territory, but
            # most ties are invariant to it:
            #   * the tied locus with the strictly smallest max-nmapped
            #     wins outright (all its events precede the others' last
            #     events);
            #   * when several tied loci share the same max-nmapped
            #     level m, the winner is decided iff every m-level run
            #     containing a candidate contains ALL candidates
            #     (identical run sets) with a consistent first-candidate
            #     (vv order) across those runs.
            # Anything else (plus expansion overflow and the test2
            # boundary, whose partial catch-up sums are path-dependent)
            # still referees.
            BIGI = jnp.int32(0x7FFFFFF0)
            seg_nm = jnp.where(segnew, g_nm, 0)   # max nm leads each seg
            m_lvl = jnp.min(jnp.where(is_top, seg_nm, BIGI), axis=-1,
                            keepdims=True)            # (P,1)
            cand_seg = is_top & (seg_nm == m_lvl)
            nC = jnp.sum(cand_seg, axis=-1)           # (P,)
            winner1 = jnp.min(
                jnp.where(cand_seg, g_loc, NAN32), axis=-1)

            # slots of candidate loci at their max level m: broadcast
            # the candidate flag across each segment, mark nm == m slots
            g_cand = (_seg_bcast(cand_seg, segnew, False)
                      & (g_nm == m_lvl) & g_valid)
            e_cand = _row_scatter_bool(g_cand, g_src, EV)
        # per-run candidate census via prefix sums over event slots
        # (under SPLIT every W-plane even event is its own 1-slot run)
        ccum = jnp.concatenate(
            [jnp.zeros((P, 1), jnp.int32),
             jnp.cumsum(e_cand.astype(jnp.int32), axis=-1)], axis=-1)
        run_end = jnp.minimum(ev_starts + ev_run_nm, EV)
        c_start, = _row_gather([ccum], jnp.clip(ev_starts, 0, EV))
        c_end, = _row_gather([ccum], run_end)
        ccr = c_end - c_start                     # candidates in my run
        c_before = ccum[:, :-1] - c_start         # candidates before me
        firstflag = e_cand & (c_before == 0)
        ok_counts = ~jnp.any(e_cand & (ccr != nC[:, None]), axis=-1)
        floc_min = jnp.min(jnp.where(firstflag, ev_locus, NAN32), axis=-1)
        floc_max = jnp.max(jnp.where(firstflag, ev_locus, 0), axis=-1)
        multi_ok = ok_counts & (floc_min == floc_max) & (floc_min != NAN32)
        tie_res = tie & jnp.where(nC == 1, True, multi_ok)
        win_loc = jnp.where(nC == 1, winner1, floc_min)

        # winner's own fwd/rev split feeds the accept tests
        use_win = tie & tie_res
        if VOTE_EQ:
            wsel = ev_valid & (ev_locus == win_loc[:, None])
            win_f = jnp.max(jnp.where(wsel, tot_f, 0), axis=-1)
            win_r = jnp.max(jnp.where(wsel, tot_r, 0), axis=-1)
        else:
            wseg = _first_true_idx(segnew & (g_loc == win_loc[:, None]))
            win_f = _take_rows(seg_f, wseg)
            win_r = _take_rows(seg_r, wseg)
        top_loc = jnp.where(use_win, win_loc, top_loc)
        top_f = jnp.where(use_win, win_f, top_f)
        top_r = jnp.where(use_win, win_r, top_r)

        test1 = (top_f >= cth) & (top_r >= cth)
        test2 = (top_f + top_r) >= 2 * cth
        vote_pass = (test1 | test2) & has_entries & pair_kf
        referee = pair_kf & ((tie & ~tie_res) | overflow
                             | (~test1 & test2))

        dst0 = jnp.where(has_entries, top_loc, NAN32)
        hf = (pair_kf & ~vote_pass & ~referee)[:, None].repeat(2, 1)
        hf = (hf.reshape(-1) & (kf == 0)).astype(jnp.int32)  # non-kf'd mates

        if DEBUG_STOP == 'vote':
            s2 = dict(state); s2['stats'] = state['stats'].at[0].add(
                (top_loc.sum() + top_f.sum() + top_r.sum()
                 + n_top.sum() + overflow.sum()).astype(state['stats'].dtype))
            return s2, dict(x=s2['stats'][0])
        # QC: drop pairs whose assigned locus fails the mask (:2059-2062)
        if qc_arr is not None:
            qc_ok = qc_arr[jnp.clip(dst0, 0, nloci).astype(jnp.int32)] == 1
            qc_drop = vote_pass & ~referee & ~qc_ok
        else:
            qc_ok = jnp.ones((P,), bool)
            qc_drop = jnp.zeros((P,), bool)

        # pairs counted on device: passed vote + QC, not referee'd
        dev_pair = vote_pass & ~referee & qc_ok

        # bait filter: per-read kmer count profile vs FP [mi,ma] windows
        # (bfilter_FPSv1 :1377-1419); violation removes BOTH mates
        if bait_lv is not None:
            # quality-masked bait (qString2qMask, h:1038-1078): masked
            # k-mers are excluded from the count profile entirely, exactly
            # as the host skips them when building kc
            bklo, bkhi = klo, khi
            if qmask is not None:
                bklo = jnp.where(qmask, klo, EMPTY)
                bkhi = jnp.where(qmask, khi, EMPTY)
            bs_hi, bs_lo = jax.lax.sort((bkhi, bklo), dimension=-1,
                                        num_keys=2)
            bs_valid = ~((bs_hi == EMPTY) & (bs_lo == EMPTY))
            bnew = bs_valid & jnp.concatenate(
                [jnp.ones((2 * P, 1), bool),
                 (bs_hi[:, 1:] != bs_hi[:, :-1])
                 | (bs_lo[:, 1:] != bs_lo[:, :-1])], axis=1)
            # per-kmer count = run length = next run start - own position
            # (probes live at run-START positions; u8 wrap per kc8_t)
            bnxt = _next_true_idx_excl(bnew)
            bused = jnp.sum(bs_valid, axis=-1, keepdims=True)
            bposW = jnp.arange(NKW, dtype=jnp.int32)[None, :]
            bcnt = jnp.where(
                bnew, jnp.minimum(bnxt, bused) - bposW, 0) & 0xFF
            bq_lo = jnp.where(bnew, bs_lo, EMPTY)
            bq_hi = jnp.where(bnew, bs_hi, EMPTY)
            bfound, bval, _ = dt.lookup_bucket_jax(
                drp.bait_tab, bq_lo, bq_hi,
                q_loc=dst0[:, None].repeat(2, 1).reshape(-1)[:, None]
                .repeat(NKW, 1),
                levels_dev=bait_lv)
            bfound = bfound & bnew
            mi = (bval >> 8).astype(jnp.int32)
            ma = (bval & 0xFF).astype(jnp.int32)
            viol = bfound & ((bcnt < mi) | (bcnt > ma))
            bf = viol.any(axis=-1) & dev_pair.repeat(2)   # (2P,)
            bf_pair = bf.reshape(P, 2).any(axis=1)
        else:
            bf = jnp.zeros((2 * P,), bool)
            bf_pair = jnp.zeros((P,), bool)

        # ---- TR/flank annotation vs dst0 ----
        # Single-locus k-mers (even dbi encoding) carry their annotation
        # in the dbi row's second value plane: (km, dst) is in the trfl
        # DB iff dst == the k-mer's own locus, so no composite probe is
        # needed.  Only multi-locus (odd/vv) k-mers probe the (shrunken)
        # composite table; all other lanes are masked to a constant
        # bucket-0 query, which hits one cached row.  Identical
        # (afound, aval) to probing the full table.
        dst0_read = dst0[:, None].repeat(2, 1).reshape(-1)  # (2P,)
        q_loc = dst0_read[:, None].repeat(NKW, 1)
        ev_hit = found & ((val & 1) == 0) & ((val >> 1) == q_loc)
        need = found & ((val & 1) == 1)
        pq_lo = jnp.where(need, klo, EMPTY)
        pq_hi = jnp.where(need, khi, EMPTY)
        pq_loc = jnp.where(need, q_loc, 0)
        if "trfl" in probe_fns:
            afound, aval = probe_fns["trfl"](pq_lo, pq_hi, pq_loc)
        else:
            afound, aval, _ = dt.lookup_bucket_jax(
                drp.trfl_tab, pq_lo, pq_hi, q_loc=pq_loc,
                levels_dev=trfl_lv)
        afound = (afound | ev_hit) & kvalid
        aval = jnp.where(ev_hit, annv, aval)
        afound = afound & dev_pair.repeat(2)[:, None]
        ann = jnp.where(afound, (aval & 3).astype(jnp.int32), 0)
        base = tb["loff"][jnp.clip(dst0_read, 0, nloci).astype(jnp.int32)]
        slot = base[:, None] + (aval >> 3).astype(jnp.int32)

        if DEBUG_STOP == 'annot':
            s2 = dict(state); s2['stats'] = state['stats'].at[0].add(
                (ann.sum() + slot.sum()).astype(state['stats'].dtype))
            return s2, dict(x=s2['stats'][0])
        # ---- assignTRkmc state machine (vectorized) ----
        lk = _seg_last_nonzero_excl(ann)              # last known before i
        known = ann > 0
        trans = known & (lk > 0) & (ann != lk)
        cumtrans = jnp.cumsum(trans.astype(jnp.int32), axis=-1)
        nt_total = cumtrans[:, -1]
        ti1 = _first_true_idx(trans)                  # width if none
        ti2 = _first_true_idx(trans & (cumtrans == 2))
        fk = _first_true_idx(known)
        bs = jnp.where(fk < NKW, _take_rows(ann, fk), 0)
        ntr = jnp.sum(ann == 2, axis=-1)

        idx_known = jnp.where(known, jnp.arange(NKW, dtype=jnp.int32), -1)
        lki = _cummax(idx_known)                      # last known idx <= i
        prev1 = _take_rows(ann, ti1 - 1)
        adj1 = (nt_total >= 1) & (prev1 == 0)
        p1 = _take_rows(lki, ti1 - 1) + 1
        si1 = jnp.where(adj1, p1, -1)
        ei1 = jnp.where(adj1, ti1, -1)
        prev2 = _take_rows(ann, ti2 - 1)
        adj2 = (nt_total >= 2) & (prev2 == 0)
        p2 = _take_rows(lki, ti2 - 1) + 1
        si2 = jnp.where(adj2, p2, -1)
        ei2 = jnp.where(adj2, ti2, -1)

        rm_entry = (kf == 1) | bf_pair.repeat(2)      # (2P,)
        nt_rec = jnp.where(
            (bs == 2) & (nt_total >= 2), 2,
            jnp.where((bs == 1) & (nt_total >= 3), 3, nt_total))
        af_early = ((bs == 2) & (nt_total >= 2)) | (
            (bs == 1) & (nt_total >= 3))
        af_nt0 = (nt_total == 0) & (bs != 2)
        af_nt2 = (nt_total == 2) & (bs == 1) & (ntr < cfg.nm_tr)
        af = jnp.where(rm_entry, 0, (af_early | af_nt0 | af_nt2))
        af = af.astype(jnp.int32) & dev_pair.repeat(2).astype(jnp.int32)
        rm = jnp.where(dev_pair.repeat(2),
                       (rm_entry.astype(jnp.int32) | af), 1)

        ok = (af == 0) & ~rm_entry & dev_pair.repeat(2)
        nkr = nk                                       # (2P,)
        mid1 = jnp.where(si1 >= 0, (si1 + ei1) // 2, ti1)
        mid2 = jnp.where(si2 >= 0, (si2 + ei2) // 2, ti2)
        si = jnp.where(nt_total == 0, 0,
             jnp.where(nt_total == 1,
                       jnp.where(bs == 1, mid1, 0),
                       mid1))
        ei = jnp.where(nt_total == 0, nkr,
             jnp.where(nt_total == 1,
                       jnp.where(bs == 1, nkr, mid1),
                       mid2))
        si_ = jnp.where(nt_total == 0, 0,
              jnp.where(nt_total == 1,
                        jnp.where(bs == 1,
                                  jnp.where(si1 >= 0, ei1, ti1), 0),
                        jnp.where(ei1 >= 0, ei1, ti1)))
        ei_ = jnp.where(nt_total == 0, nkr,
              jnp.where(nt_total == 1,
                        jnp.where(bs == 1, nkr,
                                  jnp.where(si1 >= 0, si1, ti1)),
                        jnp.where(si2 >= 0, si2, ti2)))
        si = jnp.where(ok, si, -1)
        ei = jnp.where(ok, ei, -1)
        si_ = jnp.where(ok, si_, -1)
        ei_ = jnp.where(ok, ei_, -1)
        nt_out = jnp.where(rm_entry & dev_pair.repeat(2), -1, nt_rec)
        bs_out = jnp.where(rm_entry & dev_pair.repeat(2), -1, bs)
        ti_out = jnp.where(
            rm_entry & dev_pair.repeat(2), -1,
            jnp.where(nt_total >= 1, ti1, -1))

        if DEBUG_STOP == 'assign':
            return state, dict(x=si.sum() + ei.sum() + nt_rec.sum())
        # ---- accumulation ----
        rm_p = rm.reshape(P, 2)
        counted = dev_pair & ~(rm_p.all(axis=1))
        nmate = jnp.where(counted, 2 - rm_p.sum(axis=1), 0)
        dest = jnp.where(counted, dst0, nloci).astype(jnp.int32)
        dcl = jnp.clip(dest, 0, nloci)  # nloci row = trash
        seglen = jnp.maximum(ei - si, 0).reshape(P, 2).sum(axis=1)

        counts = state["counts"]
        thr_out = {}
        if threading:
            # ---- DFA walk (graph threading fast path) ----
            # A mate is "clean" if its whole non-canonical k-mer stream
            # follows graph out-edges from position 0 with no Ns or
            # homopolymer stalls; such walks match isThreadFeasible's
            # no-correction path exactly, so device handles them and the
            # rest fall back to the host threading engine.
            nclo, nchi = ex["nclo"], ex["nchi"]
            gfound, gmask, _ = dt.lookup_bucket_jax(
                drp.graph_tab, nclo, nchi, q_loc=q_loc, levels_dev=graph_lv)
            pos = jnp.arange(NKW, dtype=jnp.int32)[None, :]
            in_read = pos < nk[:, None]
            no_n = (kvalid | ~in_read).all(axis=-1)
            same_prev = ((nclo[:, 1:] == nclo[:, :-1])
                         & (nchi[:, 1:] == nchi[:, :-1]) & in_read[:, 1:])
            no_homo = ~(same_prev.any(axis=-1))
            nb = (nclo & 3).astype(jnp.uint32)
            trans_ok = gfound[:, :-1] & (
                ((gmask[:, :-1] >> nb[:, 1:]) & 1) == 1)
            trans_ok = trans_ok | ~in_read[:, 1:]
            node_ok = gfound | ~in_read
            clean = (no_n & no_homo & trans_ok.all(axis=-1)
                     & node_ok.all(axis=-1) & (nk > 0)
                     & dev_pair.repeat(2))
            clean_pair = clean.reshape(P, 2).all(axis=1)
            thr_dev = dev_pair & clean_pair
            in_tr = afound & (((aval >> 2) & 1) == 1)
            tr_member = ((ann == 2) | in_tr) & kvalid
            do_count = tr_member & in_read & thr_dev.repeat(2)[:, None]
            cslot = jnp.where(do_count, slot, drp.nslots)
            counts = counts.at[cslot.reshape(-1)].add(1, mode="drop")
            nmapread = state["nmapread"]
            kmc = state["kmc"]
            counted = thr_dev
            dest = jnp.where(thr_dev, dst0, nloci).astype(jnp.int32)
            thr_out = dict(clean=clean, clean_pair=clean_pair,
                           tr_member=tr_member.astype(jnp.uint8))
        else:
            do_count = (ann == 2) & ((rm == 0) & counted.repeat(2))[:, None]
            cslot = jnp.where(do_count, slot, drp.nslots)
            counts = counts.at[cslot.reshape(-1)].add(1, mode="drop")
            nmapread = state["nmapread"].at[dcl].add(
                jnp.where(counted, nmate, 0).astype(jnp.uint32),
                mode="drop")
            kmc = state["kmc"].at[dcl].add(
                jnp.where(counted, seglen, 0).astype(jnp.uint32),
                mode="drop")

        # stats exclude referee'd pairs entirely; the host oracle re-counts
        # their full funnel when it reprocesses them
        stats = state["stats"]
        stats = stats.at[0].add(2 * jnp.sum(live & ~referee))     # nReads
        stats = stats.at[1].add(jnp.sum(live & ~pair_nonshort))   # nShort
        stats = stats.at[2].add(2 * jnp.sum(pair_nonshort & ~pair_sub))
        stats = stats.at[3].add(jnp.sum(jnp.where(
            (pair_sub & ~referee).repeat(2), kf, 0)))             # nKmerFilt
        stats = stats.at[4].add(jnp.sum(hf))                      # nLocusAsgn
        stats = stats.at[5].add(2 * jnp.sum(dev_pair))
        stats = stats.at[6].add(jnp.sum(jnp.where(counted, nmate, 0)))
        stats = stats.at[7].add(jnp.sum(jnp.where(
            qc_drop, 2 - kf.reshape(P, 2).sum(axis=1), 0)))   # nQCFiltered
        stats = stats.at[8].add(jnp.sum(bf & (kf == 0)))      # nBaitFilt
        new_state = dict(counts=counts, nmapread=nmapread, kmc=kmc,
                         stats=stats)

        out = dict(
            pair_alive=pair_kf, vote_pass=vote_pass, referee=referee,
            # referee reason masks (overlap possible): unresolved tie /
            # expansion overflow / test2-only boundary — which one
            # dominates decides the right mitigation (tie logic vs
            # larger E vs none)
            referee_tie=pair_kf & tie & ~tie_res,
            referee_ovf=pair_kf & overflow,
            referee_t2=pair_kf & (~test1 & test2),
            # all four masks packed into one u8 so the runner pays ONE
            # device->host fetch per step
            referee_pack=(
                referee.astype(jnp.uint8)
                | ((pair_kf & tie & ~tie_res).astype(jnp.uint8) << 1)
                | ((pair_kf & overflow).astype(jnp.uint8) << 2)
                | ((pair_kf & (~test1 & test2)).astype(jnp.uint8) << 3)),
            dst0=dst0, counted=counted, dest=dest, qc_drop=qc_drop,
            bf=bf.astype(jnp.int32),
            kf=kf, hf=hf, rm=rm, af=af,
            nt=nt_out, bs=bs_out, ti=ti_out, si=si, ei=ei,
            si_=si_, ei_=ei_, nk=nk,
            sub_drop=pair_nonshort & ~pair_sub,
            nonshort=pair_nonshort,
            **thr_out,
        )
        if with_annot:
            out["ann"] = ann.astype(jnp.uint8)
        if tre_lv is not None:
            efound, _, _ = dt.lookup_bucket_jax(
                drp.tre_tab, ex["elo"], ex["ehi"],
                q_loc=dst0_read[:, None].repeat(NE, 1), levels_dev=tre_lv)
            pos_e = jnp.arange(NE, dtype=jnp.int32)[None, :]
            in_seg = (pos_e >= si_[:, None]) & (pos_e < (ei_ - 1)[:, None])
            novel = (~efound) & ex["evalid"] & in_seg & (rm == 0)[:, None]
            novel = novel & counted.repeat(2)[:, None]
            out["novel_edge"] = novel
            # bit-packed copy for the native runner: one small async
            # fetch per step ((2P, ceil(NE/8)) u8) instead of pulling
            # the whole bool plane through the blocking result path
            out["novel_pack"] = jnp.packbits(novel, axis=-1)
        return new_state, out

    if not jit:
        return step, tabs
    jitted = jax.jit(step, donate_argnums=(1,))
    if with_qual:
        return lambda state, codes, rlen, live, qmask: jitted(
            tabs, state, codes, rlen, live, qmask)
    return lambda state, codes, rlen, live: jitted(
        tabs, state, codes, rlen, live)


def init_state(drp: DeviceRPGG):
    return dict(
        counts=jnp.zeros(drp.nslots + 1, jnp.uint32),
        nmapread=jnp.zeros(drp.nloci + 1, jnp.uint32),
        kmc=jnp.zeros(drp.nloci + 1, jnp.uint32),
        stats=jnp.zeros(9, jnp.int64 if jax.config.jax_enable_x64
                        else jnp.int32),
    )
