"""Device-aligner runner: streams read batches through the jitted device
step, routes referee-flagged pairs through the host oracle, and assembles
bit-exact outputs (.kam / .tr.kmers / .trkmc.ar / .tr.summary.txt / .bub).

The device accumulates TR-k-mer counts in a flat u32 array laid out in
.trkmc.ar order; referee'd pairs are masked out on device and recomputed by
host_align.process_pair against the same RPGG (their counts live in the
RPGG's dicts), so the final genotype is device_counts + host_counts.
"""

from __future__ import annotations

import os
from collections import deque

import numpy as np

import jax

from ..io import binary as bio
from ..ops import kmers_np as K
from ..utils.stdumap import StdUmapOrder
from . import device_align as da
from .host_align import (AlignConfig, HostAligner, RPGG, iter_fasta_pairs, _kam_row, ReadAsgn)


_DECODE = np.full(256, ord("N"), dtype=np.uint8)
_DECODE[:4] = np.frombuffer(b"ACGT", dtype=np.uint8)


def _decode(codes: np.ndarray, rlen: int) -> str:
    return _DECODE[codes[:rlen]].tobytes().decode()


def _decode_qual(quals: np.ndarray, rlen: int) -> str:
    return quals[:rlen].tobytes().decode()


class DeviceAlignRunner:
    def __init__(self, rpgg: RPGG, cfg: AlignConfig, batch_pairs: int = 4096,
                 max_read_len: int = 256, expand_cap: int = 512,
                 retry_expand: int | list = 0, drp=None):
        # expand_cap bounds the per-pair (kmer -> loci) expansion; pairs
        # exceeding it fall to the host referee (exact).  Smaller caps cut
        # device time ~35% but blow up the referee rate on RPGGs with
        # heavily shared motifs -- tune per index.
        # retry_expand enables the tiered scheme on the native counting
        # path: overflow pairs re-batch through progressively larger-E
        # jitted steps (an int = one tier; a list = a ladder, e.g.
        # [4096, 16384]) before any host fallback -- the common case gets
        # the small-E step time while real-motif panels (where a TR
        # read's k-mers legitimately map to many loci) stay on device.
        # Tier batch sizes shrink as E grows so the (P, E) working set
        # stays bounded.
        # rpgg may be a host_align.RPGG (dict-backed, built from the text
        # formats) or a flat_rpgg.FlatRPGG view; with `drp` given the
        # device index is taken as-is (production-scale runs build it
        # directly from flat arrays, skipping the dict detour entirely)
        self.rpgg = rpgg
        self.cfg = cfg
        self.P = batch_pairs
        self.L = max_read_len
        self.drp = drp if drp is not None else \
            da.DeviceRPGG.build(rpgg, with_tre=cfg.output_bubbles)
        if cfg.threading:
            self.drp.add_graph(rpgg)
        # fastq + bait needs the reference's quality mask in the bait
        # count profile (aQueryFasta_thread.h:1038-1078); the mask is
        # computed host-side (vectorized) and fed to the device step
        self.with_qual = bool(cfg.is_fastq and cfg.bait
                              and self.drp.bait_tab is not None)
        self.step = self._build_step(
            expand_cap, with_annot=cfg.okam or cfg.threading,
            with_qual=self.with_qual)
        self.state = self._init_state()
        # host oracle handles referee'd pairs (counts go into rpgg dicts);
        # the C++ engine (native/dtk_align.cpp) runs supported configs
        # ~10x faster with identical state updates
        self.host = HostAligner(rpgg, cfg)
        self.referee = self.host
        if not os.environ.get("DTK_NO_NATIVE_REFEREE"):
            from . import native_referee as nr

            if nr.available() and nr.supported(cfg):
                # pooled: engine calls fan over threads (GIL released in
                # C), verdicts apply in submission order at drain —
                # sequential semantics, ~nthreads x the referee tail
                self.referee = nr.ParallelReferee(self.host)
        self.kam_rows: list[str] = []
        self.extract_rows: list[str] = []
        self.aln_rows: list[str] = []
        self.n_referee = 0
        self.referee_reasons = {"tie": 0, "ovf": 0, "t2": 0}
        self.n_host_thread = 0
        self.expand_cap = expand_cap
        if not retry_expand:
            ladder = []
        elif isinstance(retry_expand, int):
            ladder = [retry_expand]
        else:
            ladder = list(retry_expand)
        assert all(b > a for a, b in zip([expand_cap] + ladder, ladder)), \
            ("retry ladder must strictly grow", expand_cap, ladder)
        self.retry_E = ladder                     # truthy iff tiers exist
        self.retry_P = [self._tier_P(E) for E in ladder]
        self.retry_steps: list = [None] * len(ladder)   # built lazily
        self.n_retried = 0
        self._ckpt_pool = None
        self._ckpt_fut = None

    def _tier_P(self, E: int) -> int:
        """Batch size for a retry tier: keep P*E (the vote working set)
        within ~4x the primary step's."""
        scale = max(1, E // (4 * self.expand_cap))
        return max(128, self.P // scale)

    # -- step construction hooks (overridden by the sharded runner) --

    def _build_step(self, expand_cap, with_annot, with_qual, P=None):
        return da.make_step(
            self.drp, self.cfg, P or self.P, self.L,
            expand_cap=expand_cap, with_annot=with_annot,
            with_bubbles=self.cfg.output_bubbles,
            threading=self.cfg.threading, with_qual=with_qual)

    def _init_state(self):
        return da.init_state(self.drp)

    def _build_prefilter(self, Pp: int):
        """Returns step(codes, rlen, live) -> survive mask (Pp,)."""
        cfg = self.cfg
        if os.environ.get("DTK_PREFILTER_HOSTQ", "1") != "0":
            # host-sampled queries: upload ~32 B/read instead of the
            # L-byte code rows (transfer is the wall on ingest-bound
            # runs); decision-identical
            qstep = da.make_prefilter_step_q(self.drp, cfg, Pp)
            k, nf = cfg.ksize, cfg.n_filter
            from ..io.native_reader import sample_queries

            def _pre(codes, rlen, live, _q=qstep, _k=k, _nf=nf,
                     _s=sample_queries):
                qlo, qhi, valid, nonshort = _s(codes, rlen, _k, _nf)
                return _q(qlo, qhi, valid, nonshort, live)

            return _pre
        return da.make_prefilter_step(self.drp, cfg, Pp, self.L)

    def _dev_state(self, key: str) -> np.ndarray:
        """Device accumulator as a host array (merged over shards)."""
        return np.asarray(self.state[key])

    # -- batching --

    def run_file_native(self, path: str, checkpoint: str | None = None,
                        checkpoint_every: int | None = None,
                        prefilter: bool = False):
        """Production ingest: the C reader packs batches directly; read
        strings are only materialized (decoded from the 2-bit codes) for
        referee-flagged pairs.

        With ``prefilter`` a cheap sampled-kmer device pass drops
        non-matching pairs first (the reference subfilter; genome-wide
        ~99% of pairs die there) and only densely re-packed survivors run
        the full pipeline.

        ``-bu`` bubbles run on this path too (the reference emits them in
        its one monolithic pass, aQueryFasta_thread.cpp:2161-2166): the
        device counts novel (k+1)-mer edges per read and ships them as a
        bit-packed plane with the referee mask; the host resolves edge
        values for flagged reads only (rare) and merges batch-local maps
        at the reference's reads_per_batch flush cadence, so the .bub
        output is byte-identical to the slow path / reference.

        ``checkpoint_every=None`` (the default) auto-sizes the save
        cadence from the MEASURED save cost so overhead stays <5%: the
        first save calibrates after 60 s, then the interval is 20x the
        last save's wall (snapshot fetch + npz write).  A fixed
        pair-count cadence is still accepted."""
        import time as _time

        cfg = self.cfg
        bub = cfg.output_bubbles
        assert not cfg.extract, "-e extract mode uses run_file"
        # okam/simmode ride the fast path too: the reference emits .kam
        # in its one monolithic pass (writeKmerAssignments, :2169-2175);
        # rows are assembled from the device outputs per pair, titles
        # stream through the repack buffers, src parses from the title
        thr_mode = cfg.threading
        okam = cfg.okam and not thr_mode   # threading never writes .kam
        sim = cfg.simmode
        # threading mode on the funnel: the device DFA resolves clean
        # walks; pairs needing error correction fan their (thread-safe,
        # GIL-released) native engine calls over a worker pool at
        # step-fetch time and apply results in pair order — the walks
        # run on all host cores inside the device-queue shadow
        thr_pool = None
        thr_batch_pool = None
        if thr_mode and getattr(self.host, "_nthr", None) is not None:
            from .native_thread import ParallelThreader

            thr_pool = ParallelThreader(self.host._nthr, cfg)
            # batched fallback calls MUST serialize: each dtk_thread_pairs
            # call merges into the shared per-locus CountMaps at its end,
            # and two concurrent merges would race on the unordered_maps.
            # One worker = one call in flight (its internal threads give
            # the parallelism); later steps' batches queue behind it.
            from concurrent.futures import ThreadPoolExecutor

            thr_batch_pool = ThreadPoolExecutor(1)
        # okam/-bu side outputs are order-sensitive (.kam rows interleave
        # device and referee rows in pair order; .bub bytes depend on the
        # batch-local map insert order), while the retry ladder resolves
        # overflow pairs OUT of order.  Ordered mode restores pair order
        # at apply time: every pair entering a full step gets an ordinal,
        # its side effects (kam row / bubble inserts / referee call) are
        # buffered per ordinal, and a cursor applies them strictly in
        # ordinal order — deferred pairs leave a hole that their retry
        # tier (or the referee) fills later.  Memory is bounded by the
        # retry-buffer capacity times the row size (holes resolve at
        # tier-flush cadence).  Checkpoints in ordered mode force-flush
        # the ladder first (partial tier batches are output-invariant:
        # per-pair results don't depend on batch composition), so no
        # pending-effect state needs serializing; the kam sink's byte
        # high-water mark and the bubble maps ride in the checkpoint.
        ordered = okam or bub or thr_mode
        ord_next = 0                     # next ordinal to apply
        ord_pend: dict[int, tuple] = {}  # ordinal -> effect tuple list
        n_ord = 0                        # ordinals assigned so far
        from ..io.native_reader import NativeBatchReader

        wq = self.with_qual
        # titles ride along for .kam rows / .aln rows / simmode src
        wt = okam or (thr_mode and (cfg.aln or bool(sim)))
        # prefilter dispatches carry DTK_PREFILTER_MULT x the full-step
        # batch: the prefilter's per-read device cost is tiny, so bigger
        # dispatches amortize the per-call dispatch and fetch cost
        # without touching full-step shapes
        Pp = self.P * (int(os.environ.get("DTK_PREFILTER_MULT", "4"))
                       if prefilter else 1)
        if prefilter:
            if getattr(self, "prefilter_P", None) != Pp:
                self.prefilter_step = self._build_prefilter(Pp)
                self.prefilter_P = Pp
            self.n_prefiltered = 0
            buf_codes = np.full((2 * self.P, self.L), 255, dtype=np.uint8)
            buf_rlen = np.zeros(2 * self.P, dtype=np.int32)
            buf_quals = np.zeros((2 * self.P, self.L), dtype=np.uint8) \
                if wq else None
            buf_titles = np.empty(self.P, dtype=object) if wt else None
        nbuf = 0

        done, pre_state = (self._load_checkpoint(checkpoint)
                           if checkpoint else (0, None))
        if pre_state is not None:
            # the saved cursor granularity and the pending buffers are
            # only meaningful under the writing run's configuration —
            # a silent mismatch would drop buffered pairs or replay/skip
            # reader batches, so refuse loudly instead
            def _require(key, cur, what):
                if key in pre_state and int(pre_state[key]) != int(cur):
                    raise ValueError(
                        f"checkpoint resume config mismatch: {what} was "
                        f"{int(pre_state[key])} in the checkpointing run, "
                        f"now {int(cur)}")

            _require("cfg_P", self.P, "batch_pairs")
            _require("cfg_retry_E", sum(self.retry_E), "retry_expand")
            _require("cfg_prefilter", int(bool(prefilter)), "prefilter")
            _require("cfg_okam", int(okam), "okam (.kam output)")
            _require("cfg_bub", int(bub), "output_bubbles (-bu)")
            if prefilter:
                _require("pre_P", Pp,
                         "prefilter dispatch size (DTK_PREFILTER_MULT)")
            # pre-cfg_* checkpoints: infer the writing run's mode from
            # which buffers it saved rather than dropping them silently
            if "buf_codes" in pre_state and not prefilter:
                raise ValueError("checkpoint was written by a prefilter "
                                 "run; resume with prefilter=True")
            if "ret_codes" in pre_state and not self.retry_E \
                    and int(pre_state.get("nret", 0)) > 0:
                raise ValueError("checkpoint holds pending retry-buffer "
                                 "pairs; resume with the same retry_expand")
        if prefilter and pre_state is not None:
            if "buf_codes" not in pre_state:
                raise ValueError("checkpoint was written without "
                                 "prefilter; resume with prefilter=False")
            # resume the survivor repack buffer saved with the cursor
            buf_codes = pre_state["buf_codes"]
            buf_rlen = pre_state["buf_rlen"]
            nbuf = int(pre_state["nbuf"])
            self.n_prefiltered = int(pre_state["n_prefiltered"])
            if wq and "buf_quals" in pre_state:
                buf_quals = pre_state["buf_quals"]
        cursor = 0
        since = 0
        # auto cadence (checkpoint_every=None): first save calibrates at
        # 60 s, then interval = 20x the measured save wall (<5% overhead)
        auto_ck = checkpoint is not None and checkpoint_every is None
        ck_interval = 60.0
        last_save = _time.time()

        def ckpt_due():
            nonlocal ck_interval
            if not checkpoint:
                return False
            if not auto_ck:
                return since >= checkpoint_every
            wall = getattr(self, "_last_ckpt_wall", None)
            if wall is not None:
                ck_interval = max(20.0 * wall, 60.0)
            return _time.time() - last_save >= ck_interval

        reader = NativeBatchReader(
            path, Pp, self.L, is_fastq=cfg.is_fastq,
            min_read_size=cfg.cth + cfg.ksize - 1, with_titles=wt,
            with_quals=wq)
        depth = int(os.environ.get("DTK_READER_PREFETCH", "4"))
        if depth > 0:
            from ..io.prefetch import PrefetchIterator

            reader = PrefetchIterator(reader, depth)

        # tiered expansion: overflow pairs from the small-E primary step
        # re-batch through progressively larger-E device steps before any
        # host fallback (referee_reasons then count such pairs once per
        # step that flagged them)
        ntier = len(self.retry_E)
        ret_codes, ret_rlen, ret_quals, nret = [], [], [], []
        ret_titles, ret_ords = [], []
        for t in range(ntier):
            # tier-0 keys keep the round-2 single-tier names so old
            # checkpoints resume
            pre = "ret" if t == 0 else f"ret{t}"
            nkey = "nret" if t == 0 else f"nret{t}"
            Pt = self.retry_P[t]
            if pre_state is not None and f"{pre}_codes" in pre_state:
                ret_codes.append(pre_state[f"{pre}_codes"])
                ret_rlen.append(pre_state[f"{pre}_rlen"])
                ret_quals.append(pre_state.get(f"{pre}_quals"))
                nret.append(int(pre_state[nkey]))
            else:
                ret_codes.append(np.full((2 * Pt, self.L), 255,
                                         dtype=np.uint8))
                ret_rlen.append(np.zeros(2 * Pt, dtype=np.int32))
                ret_quals.append(np.zeros((2 * Pt, self.L), dtype=np.uint8)
                                 if wq else None)
                nret.append(0)
            # titles/ordinals ride only in ordered mode, whose
            # checkpoints force-drain the ladder first (never saved)
            ret_titles.append(np.empty(Pt, dtype=object) if wt else None)
            ret_ords.append(np.zeros(Pt, dtype=np.int64)
                            if ordered else None)
        if ntier and pre_state is not None and "n_retried" in pre_state:
            self.n_retried = int(pre_state["n_retried"])

        ref_submit = getattr(self.referee, "submit", None)
        ref_flush = getattr(self.referee, "flush", lambda: None)
        from .host_align import (parse_read_name_sim1,
                                 parse_read_name_sim2)

        def pair_src(title):
            if sim == 2:
                return parse_read_name_sim2(title, self.rpgg.nloci)
            if sim == 1:
                return parse_read_name_sim1(title)
            return -1

        def host_pair(codes, rlen, quals, i, titles=None):
            self.n_referee += 1
            s1 = _decode(codes[2 * i], rlen[2 * i])
            s2 = _decode(codes[2 * i + 1], rlen[2 * i + 1])
            qs = (None, None)
            if cfg.is_fastq and quals is not None:
                qs = (_decode_qual(quals[2 * i], rlen[2 * i]),
                      _decode_qual(quals[2 * i + 1], rlen[2 * i + 1]))
            # native titles come '>'-stripped and pruned
            title = ">" + titles[i] if titles is not None else ">r"
            src = pair_src(title) if sim else -1
            if okam:
                # synchronous: the referee's freshly appended .kam row
                # moves into the runner's sink in pair order
                nrow0 = len(self.host.kam_rows)
                self.referee.process_pair(title, s1, s2, src, qs)
                if len(self.host.kam_rows) > nrow0:
                    self.kam_rows.append(self.host.kam_rows.pop())
            elif ref_submit is not None:
                ref_submit(title, s1, s2, src, qs)
            else:
                self.referee.process_pair(title, s1, s2, src, qs)

        # full steps are dispatched, then PROCESSED a few steps later
        # (fs_pending): the packed referee mask travels device->host via
        # an async copy so the per-step result fetch overlaps the next
        # steps' compute.
        # FIFO processing keeps referee/retry side effects in dispatch
        # order, so outputs are identical to the synchronous loop.
        fs_pending: deque = deque()
        fs_window = 3

        KAM_KEYS = ("nonshort", "sub_drop", "pair_alive", "qc_drop",
                    "vote_pass", "counted", "dest", "dst0", "kf", "hf",
                    "bf", "rm", "af", "nt", "bs", "ti", "si", "ei", "nk",
                    "ann")
        THR_KEYS = ("nonshort", "sub_drop", "pair_alive", "qc_drop",
                    "vote_pass", "dst0", "clean_pair", "tr_member", "nk")
        AUX_KEYS = KAM_KEYS if okam else (THR_KEYS if thr_mode else None)

        def run_step(step_fn, liveP, codes, rlen, hi, quals, next_tier,
                     lo=0, titles=None, ords=None):
            live = np.zeros(liveP, dtype=bool)
            live[lo:hi] = True
            if wq:
                qm = da.qmask_batch(quals, rlen, cfg.qth, cfg.ksize)
                self.state, out = step_fn(
                    self.state, codes, rlen, live, qm)
            else:
                self.state, out = step_fn(self.state, codes, rlen, live)
            pack = out["referee_pack"]
            extras = (out["novel_pack"], out["dest"]) if bub else ()
            kam_out = {k: out[k] for k in AUX_KEYS} if AUX_KEYS else None
            for a in (pack,) + extras + (tuple(kam_out.values())
                                         if kam_out else ()):
                try:
                    a.copy_to_host_async()
                except AttributeError:
                    pass
            fs_pending.append((pack, extras, codes, rlen, hi, quals,
                               next_tier, lo, titles, kam_out, ords))

        def apply_effect(e):
            tag = e[0]
            if tag == "kam":
                self.kam_rows.append(e[1])
            elif tag == "aln":
                self.aln_rows.append(e[1])
            elif tag == "bub":
                self._add_bubbles_codes(e[1], e[2], e[3], e[4])
            elif tag == "thr":
                # host threading fallback: engine calls were fanned over
                # the pool at step-fetch time; the pair-order apply here
                # only consumes futures + does counts / the .aln row
                _, title, s1, s2, src, dst0_i, futs = e
                self.n_host_thread += 1
                self.host.stats["nThreadingReads"] += 2
                rows = self.host.aln_rows
                n0 = len(rows)
                results = None
                if futs is not None:
                    results = (futs[0].result(), futs[1].result())
                self.host._thread_pair(title, s1, s2, src, dst0_i,
                                       results=results)
                if len(rows) > n0:
                    self.aln_rows.append(rows.pop())
            elif tag == "thrb":
                # batched fallback (dtk_thread_pairs): the C++ call did
                # the walks, corrections AND k-mer counting for the
                # whole step in one shot; this apply only reads the
                # per-slot status (+ ready RLE strings in aln mode)
                _, title, s1, s2, src, dest, fut, j = e
                self.n_host_thread += 1
                host = self.host
                host.stats["nThreadingReads"] += 2
                status, cg_rows = fut.result()
                a0, a1 = int(status[2 * j]), int(status[2 * j + 1])
                if a0 or a1:
                    host.stats["nFeasibleReads"] += (
                        int(bool(a0)) + int(bool(a1)))
                else:
                    dest = host.g.nloci
                if self.cfg.aln:
                    if self.cfg.simmode:
                        keep = (not self.cfg.aln_minimal) or (
                            src != host.g.nloci or dest != host.g.nloci)
                    else:
                        keep = (not self.cfg.aln_minimal) \
                            or dest != host.g.nloci
                    if keep:
                        c2, t2 = cg_rows[2 * j + 1].decode().split(
                            "\t", 1)
                        c1, t1 = cg_rows[2 * j].decode().split("\t", 1)
                        src_s = "." if src == -1 else str(src)
                        self.aln_rows.append(
                            f"{src_s}\t{dest}\t{title}\t{s2}\t{s1}\t"
                            f"{c2}\t{t2}\t{c1}\t{t1}\n")
            else:                               # referee (synchronous)
                _, title, s1, s2, src, qs = e
                self.n_referee += 1
                if okam:
                    nrow0 = len(self.host.kam_rows)
                    self.referee.process_pair(title, s1, s2, src, qs)
                    if len(self.host.kam_rows) > nrow0:
                        self.kam_rows.append(self.host.kam_rows.pop())
                elif thr_mode and cfg.aln:
                    n0 = len(self.host.aln_rows)
                    self.referee.process_pair(title, s1, s2, src, qs)
                    if len(self.host.aln_rows) > n0:
                        self.aln_rows.append(self.host.aln_rows.pop())
                else:
                    self.referee.process_pair(title, s1, s2, src, qs)

        def emit(o, effs):
            nonlocal ord_next
            ord_pend[o] = effs
            while ord_next in ord_pend:
                for e in ord_pend.pop(ord_next):
                    apply_effect(e)
                ord_next += 1

        def defer_pair(t, codes, rlen, quals, titles, i, o):
            self.n_retried += 1
            j = nret[t]
            ret_codes[t][2 * j] = codes[2 * i]
            ret_codes[t][2 * j + 1] = codes[2 * i + 1]
            ret_rlen[t][2 * j] = rlen[2 * i]
            ret_rlen[t][2 * j + 1] = rlen[2 * i + 1]
            if wq:
                ret_quals[t][2 * j] = quals[2 * i]
                ret_quals[t][2 * j + 1] = quals[2 * i + 1]
            if wt:
                ret_titles[t][j] = titles[i]
            if ordered:
                ret_ords[t][j] = o
            nret[t] += 1
            if nret[t] == self.retry_P[t]:
                flush_retry(t)

        def ref_effect(codes, rlen, quals, i, titles):
            """Captures the referee call's inputs now (pure decode);
            the call itself runs at ordinal-apply time so its kam/bubble
            side effects land in pair order."""
            s1 = _decode(codes[2 * i], rlen[2 * i])
            s2 = _decode(codes[2 * i + 1], rlen[2 * i + 1])
            qs = (None, None)
            if cfg.is_fastq and quals is not None:
                qs = (_decode_qual(quals[2 * i], rlen[2 * i]),
                      _decode_qual(quals[2 * i + 1], rlen[2 * i + 1]))
            title = ">" + titles[i] if titles is not None else ">r"
            src = pair_src(title) if sim else -1
            return ("ref", title, s1, s2, src, qs)

        def process_step():
            (pack, extras, codes, rlen, n, quals,
             next_tier, lo, titles, kam_out, ords) = fs_pending.popleft()
            pk = np.asarray(pack)[:n]
            referee = (pk & 1) != 0
            for bit, key in ((2, "tie"), (4, "ovf"), (8, "t2")):
                self.referee_reasons[key] += int(((pk & bit) != 0).sum())
            if next_tier is not None:
                ovf = ((pk & 4) != 0) & referee
            else:
                ovf = np.zeros(n, dtype=bool)
            if bub:
                novp = np.asarray(extras[0])[: 2 * n]
                has = novp.any(axis=1)
                pair_bub = (has[0::2] | has[1::2]) & ~referee
                dest_arr = np.asarray(extras[1])[:n]
            else:
                pair_bub = np.zeros(n, dtype=bool)
            if kam_out is not None:
                ko = {k: np.asarray(v) for k, v in kam_out.items()}
            # threading fallback BATCH: gather every pair of this step
            # that needs host correction and walk them in ONE native
            # call (dtk_thread_pairs: internal worker threads, counting
            # in C++).  The per-pair path (a ctypes call plus Python
            # list/dict work per pair) serializes the fallback; the
            # batch removes all per-pair Python from the hot path.  DTK_THREAD_BATCH=0
            # restores the per-pair path for A/B.
            thr_batch = None
            if (ordered and thr_mode and thr_pool is not None
                    and os.environ.get("DTK_THREAD_BATCH", "1") != "0"
                    and hasattr(self.host._nthr, "thread_pairs")):
                alive_m = (ko["nonshort"][:n] & ~ko["sub_drop"][:n]
                           & ko["pair_alive"][:n] & ~ko["qc_drop"][:n]
                           & ko["vote_pass"][:n])
                fb = np.zeros(n, dtype=bool)
                fb[lo:] = (alive_m[lo:] & ~ko["clean_pair"][lo:n]
                           & ~referee[lo:] & ~ovf[lo:])
                bidx = np.nonzero(fb)[0]
                if len(bidx):
                    nthr = self.host._nthr
                    bdests = [int(d) for d in ko["dst0"][bidx]]
                    for d in bdests:
                        nthr.prepare(d, self.host.g.graphs[d],
                                     self.host.g.tr_counts[d])
                    rows = np.empty(2 * len(bidx), dtype=np.int64)
                    rows[0::2] = 2 * bidx
                    rows[1::2] = 2 * bidx + 1
                    fut = thr_batch_pool.submit(
                        nthr.thread_pairs, bdests, codes[rows],
                        np.asarray(rlen)[rows], cfg.thread_cth,
                        cfg.correction, cfg.ksize, cfg.maxncorrection,
                        0, cfg.aln)
                    thr_batch = (fut, {int(i): j
                                       for j, i in enumerate(bidx)})
            if ordered:
                # ordinal-buffered effects: deferred pairs leave a hole
                # their retry tier fills; everything applies in pair order
                for i in range(lo, n):
                    o = int(ords[i])
                    if ovf[i]:
                        defer_pair(next_tier, codes, rlen, quals, titles,
                                   i, o)
                        continue
                    effs = []
                    if referee[i]:
                        effs.append(ref_effect(codes, rlen, quals, i,
                                               titles))
                    elif thr_mode:
                        alive = (ko["nonshort"][i]
                                 and not ko["sub_drop"][i]
                                 and ko["pair_alive"][i]
                                 and not ko["qc_drop"][i]
                                 and ko["vote_pass"][i])
                        if alive:
                            dst0_i = int(ko["dst0"][i])
                            if not ko["clean_pair"][i]:
                                title = (">" + titles[i]
                                         if titles is not None else ">r")
                                srcv = pair_src(title) if sim else -1
                                if thr_batch is not None:
                                    # sequences only needed for the
                                    # .aln row; counting mode skips the
                                    # decode entirely
                                    s1 = s2 = None
                                    if cfg.aln:
                                        s1 = _decode(codes[2 * i],
                                                     rlen[2 * i])
                                        s2 = _decode(codes[2 * i + 1],
                                                     rlen[2 * i + 1])
                                    effs.append((
                                        "thrb", title, s1, s2, srcv,
                                        dst0_i, thr_batch[0],
                                        thr_batch[1][i]))
                                else:
                                    s1 = _decode(codes[2 * i],
                                                 rlen[2 * i])
                                    s2 = _decode(codes[2 * i + 1],
                                                 rlen[2 * i + 1])
                                    futs = None
                                    if thr_pool is not None:
                                        self.host._nthr.prepare(
                                            dst0_i,
                                            self.host.g.graphs[dst0_i],
                                            self.host.g.tr_counts[
                                                dst0_i])
                                        futs = (thr_pool.submit_read(
                                                    dst0_i, s1),
                                                thr_pool.submit_read(
                                                    dst0_i, s2))
                                    effs.append(("thr", title, s1, s2,
                                                 srcv, dst0_i, futs))
                            elif cfg.aln:
                                effs.append(("aln", self._thread_aln_row(
                                    ko, i, codes, rlen, titles,
                                    pair_src if sim else None)))
                    else:
                        if pair_bub[i]:
                            d = int(dest_arr[i])
                            for m in (0, 1):
                                ridx = 2 * i + m
                                if has[ridx]:
                                    effs.append((
                                        "bub", d, codes[ridx].copy(),
                                        int(rlen[ridx]),
                                        np.unpackbits(novp[ridx])))
                        if okam:
                            row = self._kam_device_row(
                                ko, codes, rlen, quals, titles, i)
                            if row is not None:
                                effs.append(("kam", row))
                    emit(o, effs)
                return
            # counting mode: only flagged pairs need host work; order of
            # referee side effects is irrelevant (count adds commute)
            todo = np.nonzero(referee)[0]
            for i in todo:
                if not ovf[i]:
                    host_pair(codes, rlen, quals, i, titles)
                else:
                    defer_pair(next_tier, codes, rlen, quals, titles,
                               int(i), 0)

        def drain_steps(to: int = 0):
            while len(fs_pending) > to:
                process_step()

        def flush_retry(t: int):
            if not nret[t]:
                return
            Pt = self.retry_P[t]
            if self.retry_steps[t] is None:
                # okam tiers need the annotation plane for .kam rows
                self.retry_steps[t] = self._build_step(
                    self.retry_E[t], with_annot=okam, with_qual=wq,
                    P=Pt)
            nr_, nret[t] = nret[t], 0
            rc, rr, rq = ret_codes[t], ret_rlen[t], ret_quals[t]
            rt, ro = ret_titles[t], ret_ords[t]
            ret_codes[t] = np.full((2 * Pt, self.L), 255, dtype=np.uint8)
            ret_rlen[t] = np.zeros(2 * Pt, dtype=np.int32)
            if wq:
                ret_quals[t] = np.zeros((2 * Pt, self.L), dtype=np.uint8)
            if wt:
                ret_titles[t] = np.empty(Pt, dtype=object)
            if ordered:
                ret_ords[t] = np.zeros(Pt, dtype=np.int64)
            run_step(self.retry_steps[t], Pt, rc, rr, nr_, rq,
                     next_tier=t + 1 if t + 1 < ntier else None,
                     titles=rt, ords=ro)

        def full_step(codes, rlen, n, quals=None, lo=0, titles=None):
            nonlocal n_ord
            ords = None
            if ordered:
                # fresh consecutive ordinals for pairs entering the
                # primary step (slot-indexed; slots < lo belong to an
                # earlier dispatch of the same buffer)
                ords = np.zeros(n, dtype=np.int64)
                ords[lo:] = np.arange(n_ord, n_ord + (n - lo))
                n_ord += n - lo
            run_step(self.step, self.P, codes, rlen, n, quals,
                     next_tier=0 if ntier else None, lo=lo, titles=titles,
                     ords=ords)
            drain_steps(fs_window)

        def drain_ladder():
            """Resolve every in-flight and deferred pair: tier flushes
            cascade (a tier's overflow lands in the next tier's buffer)
            and the final tier's overflow referees on the host."""
            drain_steps()
            for t in range(ntier):
                flush_retry(t)
                drain_steps()
            if ordered:
                assert not ord_pend, "unresolved ordinals after drain"

        # -bu flush cadence: the reference merges batch-local bubble maps
        # into the global DB every reads_per_batch reads (accumBubbles
        # under semwriter); the .bub byte layout depends on that merge
        # order, so the native path barriers at the same pair boundaries
        Bflush = max(cfg.reads_per_batch // 2, 1)
        # resume: every flush boundary <= the saved cursor had already
        # fired in the writing run (the restored _bub_batch is the
        # mid-segment state) — realign so no boundary replays
        next_flush = (done // Bflush + 1) * Bflush

        def step_buf():
            nonlocal nbuf, buf_codes, buf_rlen, buf_quals, buf_titles
            if not nbuf:
                return
            full_step(buf_codes, buf_rlen, nbuf, buf_quals,
                      titles=buf_titles)
            buf_codes = np.full((2 * self.P, self.L), 255, dtype=np.uint8)
            buf_rlen = np.zeros(2 * self.P, dtype=np.int32)
            if wq:
                buf_quals = np.zeros((2 * self.P, self.L), dtype=np.uint8)
            if wt:
                buf_titles = np.empty(self.P, dtype=object)
            nbuf = 0

        def copy_survivors(sel, codes, rlen, quals, titles=None):
            # block-copy survivors into the repack buffer (chunked at
            # full-step boundaries); row indices interleave the two mates
            nonlocal nbuf
            taken = 0
            while taken < len(sel):
                chunk = sel[taken: taken + (self.P - nbuf)]
                taken += len(chunk)
                src = np.stack([2 * chunk, 2 * chunk + 1], axis=1).ravel()
                dst = slice(2 * nbuf, 2 * (nbuf + len(chunk)))
                buf_codes[dst] = codes[src]
                buf_rlen[dst] = rlen[src]
                if wq:
                    buf_quals[dst] = quals[src]
                if wt:
                    buf_titles[nbuf: nbuf + len(chunk)] = \
                        np.asarray(titles, dtype=object)[chunk]
                nbuf += len(chunk)
                if nbuf == self.P:
                    step_buf()

        def batch_flush_barrier():
            # everything dispatched so far must land (referee + bubble
            # side effects) before the batch-local maps merge; with a
            # retry ladder, deferred pre-boundary pairs force-flush
            # through their tiers here (partial tier batches are
            # output-invariant — per-pair results don't depend on batch
            # composition)
            nonlocal next_flush
            step_buf()
            drain_ladder()
            self.host.flush_batch()
            next_flush += Bflush

        def save_ckpt():
            # referee/retry side effects must be complete up to the saved
            # cursor; in-flight full steps are part of checkpoint state
            if ordered:
                # ordered mode refuses to serialize pending effects —
                # force the ladder dry instead, then snapshot the kam
                # sink high-water mark + bubble maps
                drain_ladder()
            else:
                drain_steps()
            ref_flush()
            # config fingerprint — resume refuses on mismatch (pending
            # buffers + cursor granularity assume this configuration)
            extra = dict(cfg_P=self.P, cfg_retry_E=sum(self.retry_E),
                         cfg_prefilter=int(bool(prefilter)),
                         cfg_okam=int(okam), cfg_bub=int(bub))
            if ordered:
                import pickle

                from ..io.rowsink import RowSink

                if okam:
                    kr = self.kam_rows
                    if isinstance(kr, RowSink) and kr.path is not None:
                        extra["kam_offset"] = kr.byte_offset()
                        extra["kam_nrows"] = kr.n_written
                    else:
                        extra["kam_rows_pkl"] = np.frombuffer(
                            pickle.dumps(list(kr)), np.uint8)
                if bub:
                    extra["bub_pkl"] = np.frombuffer(pickle.dumps(
                        (self.host.bub_orders, self.host.bub_counts,
                         self.host._bub_batch)), np.uint8)
            if prefilter:
                extra.update(buf_codes=buf_codes, buf_rlen=buf_rlen,
                             nbuf=nbuf, n_prefiltered=self.n_prefiltered,
                             pre_P=Pp)
                if wq:
                    extra["buf_quals"] = buf_quals
            for t in range(ntier):
                pre = "ret" if t == 0 else f"ret{t}"
                nkey = "nret" if t == 0 else f"nret{t}"
                extra[f"{pre}_codes"] = ret_codes[t]
                extra[f"{pre}_rlen"] = ret_rlen[t]
                extra[nkey] = nret[t]
                extra["n_retried"] = self.n_retried
                if wq:
                    extra[f"{pre}_quals"] = ret_quals[t]
            self._save_checkpoint(checkpoint, cursor, extra,
                                  defer=True)

        pending: deque = deque()
        pre_window = int(os.environ.get("DTK_PREFILTER_WINDOW", "8"))

        def drain_one():
            nonlocal cursor, since
            codes, rlen, quals, titles, n, fut = pending.popleft()
            surv = np.asarray(fut)[:n]
            idx = np.nonzero(surv)[0]
            self.n_prefiltered += int(n - len(idx))
            if not bub:
                copy_survivors(idx, codes, rlen, quals, titles)
            else:
                # survivors strictly segment-by-segment: all pairs before
                # a flush boundary must be processed + merged before any
                # pair after it enters the repack buffer
                p = 0
                while True:
                    rel = next_flush - cursor
                    q = int(np.searchsorted(idx[p:], rel)) + p
                    copy_survivors(idx[p:q], codes, rlen, quals, titles)
                    p = q
                    if rel > n:
                        break
                    batch_flush_barrier()
            cursor += n
            since += n
            if ckpt_due():
                save_ckpt()
                since = 0
                last_save = _time.time()

        try:
            for rec in reader:
                codes, rlen, n = rec[0], rec[1], rec[2]
                titles = rec[3] if wt else None
                quals = rec[4] if wq else None
                if cursor + n <= done:
                    cursor += n
                    continue
                if cursor < done:
                    raise ValueError(
                        "checkpoint cursor is not aligned to this run's "
                        "dispatch size — resume with the same batch_pairs"
                        "/prefilter configuration as the checkpointing run")
                if prefilter:
                    live = np.zeros(Pp, dtype=bool)
                    live[:n] = True
                    # async window: keep several prefilter dispatches in
                    # flight so host repack + device transfer latency (RTT
                    # per dispatch) overlaps device compute; the reader
                    # allocates fresh arrays per batch, so queueing without
                    # copies is safe.  Checkpoint cursor advances on drain.
                    fut = self.prefilter_step(codes, rlen, live)
                    # start the device->host copy of the survivor mask NOW:
                    # with the async copy the bytes are on the host by the
                    # time the window drains, instead of a blocking fetch
                    # per dispatch
                    try:
                        fut.copy_to_host_async()
                    except AttributeError:
                        pass
                    pending.append((codes, rlen, quals, titles, n, fut))
                    if len(pending) >= pre_window:
                        drain_one()
                else:
                    if not bub:
                        full_step(codes, rlen, n, quals, titles=titles)
                    else:
                        # split the dispatch at flush boundaries (live
                        # range [lo, hi)); merge between the halves
                        lo = 0
                        while next_flush - cursor <= n:
                            rel = next_flush - cursor
                            if rel > lo:
                                full_step(codes, rlen, rel, quals, lo=lo,
                                          titles=titles)
                                lo = rel
                            batch_flush_barrier()
                        if n > lo:
                            full_step(codes, rlen, n, quals, lo=lo,
                                      titles=titles)
                    cursor += n
                    since += n
                    if ckpt_due():
                        save_ckpt()
                        since = 0
                        last_save = _time.time()
            # the pending-window drain runs INSIDE the try: a crash here
            # (it dispatches full steps and can save checkpoints) must
            # still close the reader and join any deferred write —
            # escaping without the join races the background npz against
            # whatever the caller does next (observed as a flaky
            # missing-checkpoint after an abort)
            while pending:
                drain_one()
            step_buf()
            drain_ladder()
            ref_flush()
            self.host.flush_batch()
            # batched threading counts live in native CountMaps until a
            # boundary; the final outputs read the Python dicts
            self._drain_native_counts()
        finally:
            # abandoning mid-file (exception above) must not leak the
            # reader's FILE* / prefetch producer thread, and any deferred
            # checkpoint write must land before we surface the failure (a
            # graceful abort keeps the newest durable state; a hard kill
            # resumes from the previously completed file)
            reader.close()
            if thr_batch_pool is not None:
                thr_batch_pool.shutdown(wait=True)
            if thr_pool is not None:
                thr_pool.close()
            if checkpoint:
                self._ckpt_join()
        if checkpoint:
            if since:
                save_ckpt()
            self._ckpt_join()

    def run_file(self, path: str, checkpoint: str | None = None,
                 checkpoint_every: int = 1_000_000):
        """Stream the file; with ``checkpoint`` set, periodically persist
        the count state (genotype state is just int arrays, SURVEY §5) and
        resume from the last saved pair cursor after a crash.

        Checkpointing supports the production counting mode (no kam/bubble
        side outputs)."""
        cfg = self.cfg
        if checkpoint is not None:
            assert not cfg.okam and not cfg.output_bubbles, \
                "checkpointing covers counting mode only"
        done = (self._load_checkpoint(checkpoint)[0] if checkpoint else 0)
        cursor = 0
        since = 0
        min_read_size = cfg.cth + cfg.ksize - 1
        for batch in iter_fasta_pairs(
            path, min_read_size, self.rpgg.nloci, cfg.simmode,
            cfg.reads_per_batch // 2, is_fastq=cfg.is_fastq,
        ):
            for i in range(0, len(batch), self.P):
                chunk = batch[i : i + self.P]
                if cursor + len(chunk) <= done:
                    cursor += len(chunk)
                    continue
                assert cursor >= done, "checkpoint not chunk-aligned"
                self._run_chunk(chunk)
                cursor += len(chunk)
                since += len(chunk)
                if checkpoint and since >= checkpoint_every:
                    self._save_checkpoint(checkpoint, cursor)
                    since = 0
            self.host.flush_batch()
        if checkpoint and since:
            self._save_checkpoint(checkpoint, cursor)

    def _save_checkpoint(self, path: str, cursor: int,
                         extra: dict | None = None, defer: bool = False):
        """Persist count state + cursor.

        ``defer=True`` (the production funnel path) makes the save
        asynchronous: the device state is snapshotted ON DEVICE (the
        dispatch loop keeps donating the live buffers), its host copy
        starts immediately, and a background thread writes the npz once
        the transfer lands — at production index scale the counts fetch
        is hundreds of MB, which would otherwise stall the funnel at
        every checkpoint.  The file
        becomes durable up to one checkpoint interval late; the cursor
        inside is always consistent with its own snapshot, so resume
        semantics are unchanged (a crash loses at most two intervals of
        work instead of one)."""
        self._ckpt_join()
        if not defer:
            state = {k: np.asarray(v) for k, v in self.state.items()}
            self._ckpt_write(path, cursor, state,
                             self._host_snapshot(), extra)
            return
        import jax.numpy as jnp

        snap = {k: jnp.array(v, copy=True)
                for k, v in self.state.items()}
        for v in snap.values():
            try:
                v.copy_to_host_async()
            except AttributeError:
                pass
        hsnap = self._host_snapshot()
        # extra carries the live repack/retry buffers — copy them at
        # snapshot time (the loop mutates them in place afterwards)
        ex = None if extra is None else {
            k: (np.array(v) if isinstance(v, np.ndarray) else v)
            for k, v in extra.items()}
        if self._ckpt_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._ckpt_pool = ThreadPoolExecutor(1)
        self._ckpt_fut = self._ckpt_pool.submit(
            self._ckpt_write, path, cursor, snap, hsnap, ex)

    def _drain_native_counts(self):
        """Merge deferred batched-threading counts (native CountMaps)
        into the per-locus Python dicts.  Called at checkpoint-snapshot
        and finalize boundaries — both run after drain_ladder, so every
        merged count belongs to a pair at or before the cursor (adds
        commute; a resume replays only pairs past the snapshot)."""
        nthr = getattr(self.host, "_nthr", None)
        trc = getattr(self.host.g, "tr_counts", None)
        if nthr is not None and trc is not None \
                and hasattr(nthr, "drain_counts_into"):
            nthr.drain_counts_into(trc)

    def _host_snapshot(self):
        self._drain_native_counts()
        return dict(host_counts=self.host.flat_counts().copy(),
                    host_nmapread=self.host.nmapread.copy(),
                    host_kmc=self.host.kmc.copy(),
                    n_referee=self.n_referee)

    def _ckpt_write(self, path, cursor, state, hsnap, extra):
        import time as _time

        import numpy as _np

        t0 = _time.time()
        state = {k: np.asarray(v) for k, v in state.items()}
        _np.savez(path + ".tmp.npz", cursor=cursor, **hsnap,
                  **{f"dev_{k}": v for k, v in state.items()},
                  **{f"x_{k}": v for k, v in (extra or {}).items()})
        os.replace(path + ".tmp.npz", path)
        # measured save wall (device->host fetch + npz write) feeds the
        # auto cadence: interval = 20x wall keeps overhead <5%
        self._last_ckpt_wall = _time.time() - t0

    def _ckpt_join(self):
        fut = getattr(self, "_ckpt_fut", None)
        if fut is not None:
            self._ckpt_fut = None
            fut.result()

    def _load_checkpoint(self, path: str) -> tuple[int, dict | None]:
        """Returns (pair cursor, extra-state dict or None)."""
        if not os.path.exists(path):
            return 0, None
        z = np.load(path)
        import jax.numpy as jnp

        self.state = {k[4:]: jnp.asarray(z[k]) for k in z.files
                      if k.startswith("dev_")}
        # restore host-side (referee) counts into the shared RPGG dicts
        flat = z["host_counts"]
        fc = getattr(self.rpgg, "flat_counts", None)
        if fc is not None:
            # flat host view: counts restore as one array copy (the
            # dict walk below is 1e8+ Python ops at production scale)
            fc()[:] = flat
        else:
            p = 0
            for li in range(self.rpgg.nloci):
                cnt = self.rpgg.tr_counts[li]
                for km in self.rpgg.tr_orders[li]:
                    cnt[km] = int(flat[p])
                    p += 1
        self.host.nmapread = z["host_nmapread"].copy()
        self.host.kmc = z["host_kmc"].copy()
        self.n_referee = int(z["n_referee"])
        extra = {k[2:]: z[k] for k in z.files if k.startswith("x_")}
        # okam/-bu mode mismatch must be diagnosed BEFORE any side-state
        # restore (a counting-mode resume would otherwise trip on the
        # kam sink binding instead of the real configuration error)
        # compare the EFFECTIVE okam (threading never writes .kam, so
        # the save path records 0 there regardless of the raw flag)
        eff_okam = int(self.cfg.okam and not self.cfg.threading)
        for key, cur, what in (("cfg_okam", eff_okam,
                                "okam (.kam output)"),
                               ("cfg_bub", int(self.cfg.output_bubbles),
                                "output_bubbles (-bu)")):
            if key in extra and int(extra[key]) != cur:
                raise ValueError(
                    f"checkpoint resume config mismatch: {what} was "
                    f"{int(extra[key])} in the checkpointing run, now "
                    f"{cur}")
        # ordered-mode (okam/-bu) side state: truncate the kam sink back
        # to the checkpoint's byte high-water mark (rows streamed after
        # the save are replayed on resume) and restore the bubble maps
        if "kam_offset" in extra:
            from ..io.rowsink import RowSink

            kr = self.kam_rows
            if isinstance(kr, RowSink) and kr.path is not None:
                kr.truncate_to(int(extra["kam_offset"]),
                               int(extra["kam_nrows"]))
            else:
                raise ValueError(
                    "checkpoint recorded a streamed .kam high-water "
                    "mark; bind kam_rows to a RowSink(path, append="
                    "True) before resuming")
        if "kam_rows_pkl" in extra:
            import pickle

            self.kam_rows = pickle.loads(extra["kam_rows_pkl"].tobytes())
        if "bub_pkl" in extra:
            import pickle

            (self.host.bub_orders, self.host.bub_counts,
             self.host._bub_batch) = pickle.loads(
                extra["bub_pkl"].tobytes())
        return int(z["cursor"]), (extra or None)

    def _run_chunk(self, pairs):
        n = len(pairs)
        codes = np.full((2 * self.P, self.L), 255, dtype=np.uint8)
        rlen = np.zeros(2 * self.P, dtype=np.int32)
        live = np.zeros(self.P, dtype=bool)
        quals = np.zeros((2 * self.P, self.L), dtype=np.uint8) \
            if self.with_qual else None
        for i, rec in enumerate(pairs):
            s1, s2 = rec[1], rec[2]
            c1 = K.encode_bases(s1)[: self.L]
            c2 = K.encode_bases(s2)[: self.L]
            codes[2 * i, : len(c1)] = c1
            codes[2 * i + 1, : len(c2)] = c2
            rlen[2 * i] = len(c1)
            rlen[2 * i + 1] = len(c2)
            live[i] = True
            if quals is not None:
                q1 = np.frombuffer(rec[4].encode(), np.uint8)[: self.L]
                q2 = np.frombuffer(rec[5].encode(), np.uint8)[: self.L]
                quals[2 * i, : len(q1)] = q1
                quals[2 * i + 1, : len(q2)] = q2
        if self.with_qual:
            qm = da.qmask_batch(quals, rlen, self.cfg.qth, self.cfg.ksize)
            self.state, out = self.step(self.state, codes, rlen, live, qm)
        else:
            self.state, out = self.step(self.state, codes, rlen, live)
        out = {k: np.asarray(v) for k, v in out.items()}
        self._post_chunk(pairs, out, n)

    def _post_chunk(self, pairs, out, n):
        if self.cfg.extract and not self.cfg.threading:
            self._post_chunk_extract(pairs, out)
            return
        if self.cfg.threading:
            self._post_chunk_threading(pairs, out)
            return
        cfg = self.cfg
        nloci = self.rpgg.nloci
        referee = out["referee"]
        for key in ("tie", "ovf", "t2"):
            mask = out.get(f"referee_{key}")
            if mask is not None:
                self.referee_reasons[key] += int(
                    np.asarray(mask[: len(pairs)]).sum())
        for i, rec in enumerate(pairs):
            title, s1, s2, src = rec[:4]
            quals = tuple(rec[4:6]) if len(rec) > 4 else (None, None)
            if referee[i]:
                self.n_referee += 1
                nrow0 = len(self.host.kam_rows)
                self.referee.process_pair(title, s1, s2, src, quals)
                if len(self.host.kam_rows) > nrow0:
                    self.kam_rows.append(self.host.kam_rows.pop())
                continue
            if not out["nonshort"][i] or out["sub_drop"][i]:
                continue
            if not out["pair_alive"][i]:
                continue
            if out["qc_drop"][i]:
                continue
            dest = int(out["dest"][i]) if out["counted"][i] else nloci
            if not out["vote_pass"][i]:
                dest = nloci
            dst0 = int(out["dst0"][i])
            # bubbles: recompute novel-edge values host-side (rare)
            if cfg.output_bubbles and out["counted"][i]:
                for m, seq in ((0, s1), (1, s2)):
                    ridx = 2 * i + m
                    nov = out["novel_edge"][ridx]
                    if nov.any():
                        self._add_bubbles(dest, seq, nov)
                    elif out["rm"][ridx] == 0:
                        # still need deterministic no-op (no novel edges)
                        pass
            if cfg.okam and ((src != nloci and src != -1) or dest != nloci):
                self.kam_rows.append(
                    self._kam_from_device(title, src, dest, dst0, out, i,
                                          s1, s2, quals))

    def _post_chunk_extract(self, pairs, out):
        """-e mode: emit vote-assigned pairs, no counting (QC/bait do
        not apply; the reference loads only the dbi here)."""
        host = self.host
        for i, rec in enumerate(pairs):
            title, s1, s2, src = rec[:4]
            quals = tuple(rec[4:6]) if len(rec) > 4 else (None, None)
            if out["referee"][i]:
                self.n_referee += 1
                n0 = len(host.extract_rows)
                host.process_pair(title, s1, s2, src, quals)  # py path
                if len(host.extract_rows) > n0:
                    self.extract_rows.append(host.extract_rows.pop())
                continue
            if (not out["nonshort"][i] or out["sub_drop"][i]
                    or not out["pair_alive"][i]
                    or not out["vote_pass"][i]):
                continue
            host._record_extract(title, s1, s2, int(out["dst0"][i]), quals)
            self.extract_rows.append(host.extract_rows.pop())

    def write_extract(self, fh):
        from ..io.rowsink import finalize_rows_fh

        finalize_rows_fh(self.extract_rows, fh)

    def _post_chunk_threading(self, pairs, out):
        """Threading mode: device handles clean-walk pairs; everything
        else goes through the host threading engine (exact)."""
        cfg = self.cfg
        nloci = self.rpgg.nloci
        rows = self.host.extract_rows if cfg.extract else self.host.aln_rows
        dest_rows = self.extract_rows if cfg.extract else self.aln_rows
        for i, rec in enumerate(pairs):
            title, s1, s2, src = rec[:4]
            quals = tuple(rec[4:6]) if len(rec) > 4 else (None, None)
            if out["referee"][i]:
                self.n_referee += 1
                n0 = len(rows)
                self.host.process_pair(title, s1, s2, src, quals)
                if len(rows) > n0:
                    dest_rows.append(rows.pop())
                continue
            if (not out["nonshort"][i] or out["sub_drop"][i]
                    or not out["pair_alive"][i] or out["qc_drop"][i]
                    or not out["vote_pass"][i]):
                continue
            dst0 = int(out["dst0"][i])
            if not out["clean_pair"][i]:
                self.n_host_thread += 1
                n0 = len(rows)
                self.host.stats["nThreadingReads"] += 2
                self.host._thread_pair(title, s1, s2, src, dst0)
                if len(rows) > n0:
                    dest_rows.append(rows.pop())
                continue
            if cfg.extract:
                # clean walk => both mates feasible
                self.host._record_extract(title, s1, s2, dst0, quals)
                self.extract_rows.append(self.host.extract_rows.pop())
                continue
            # device-handled clean pair: aln row is all-matches
            if cfg.aln:
                keep = True
                if cfg.aln_minimal and not cfg.simmode:
                    keep = True  # dest != nloci by construction
                src_s = "." if src == -1 else str(src)
                ann2 = self._annot_str(out, 2 * i + 1)
                ann1 = self._annot_str(out, 2 * i)
                self.aln_rows.append(
                    f"{src_s}\t{dst0}\t{title}\t{s2}\t{s1}\t"
                    f"{len(s2)}=\t{ann2}\t{len(s1)}=\t{ann1}\n")

    def _annot_str(self, out, ridx):
        from .threading import write_annot

        nk = int(out["nk"][ridx])
        tm = out["tr_member"][ridx][:nk]
        return write_annot(["=" if x else "." for x in tm])

    def _thread_aln_row(self, ko, i, codes, rlen, titles, pair_src=None):
        """Native-path twin of _post_chunk_threading's device-clean
        branch: a clean DFA walk is an all-match CIGAR, annotations come
        from the tr_member plane."""
        title = ">" + titles[i] if titles is not None else ">r"
        src = pair_src(title) if pair_src is not None else -1
        src_s = "." if src == -1 else str(src)
        dst0 = int(ko["dst0"][i])
        s1 = _decode(codes[2 * i], rlen[2 * i])
        s2 = _decode(codes[2 * i + 1], rlen[2 * i + 1])
        ann2 = self._annot_str(ko, 2 * i + 1)
        ann1 = self._annot_str(ko, 2 * i)
        return (f"{src_s}\t{dst0}\t{title}\t{s2}\t{s1}\t"
                f"{len(s2)}=\t{ann2}\t{len(s1)}=\t{ann1}\n")

    def write_aln(self, path):
        from ..io.rowsink import finalize_rows

        finalize_rows(self.aln_rows, path)

    def _kam_device_row(self, ko, codes, rlen, quals, titles, i):
        """Native-path twin of _post_chunk's device-pair .kam emission:
        the same filter/field logic over the async-fetched out planes,
        seqs decoded from the packed codes only for emitted rows.
        Returns the row string, or None when the pair emits nothing."""
        cfg = self.cfg
        nloci = self.rpgg.nloci
        if not ko["nonshort"][i] or ko["sub_drop"][i]:
            return None
        if not ko["pair_alive"][i]:
            return None
        if ko["qc_drop"][i]:
            return None
        title = ">" + titles[i]          # native titles are '>'-stripped
        src = -1
        if cfg.simmode == 2:
            from .host_align import parse_read_name_sim2

            src = parse_read_name_sim2(title, nloci)
        elif cfg.simmode == 1:
            from .host_align import parse_read_name_sim1

            src = parse_read_name_sim1(title)
        dest = int(ko["dest"][i]) if ko["counted"][i] else nloci
        if not ko["vote_pass"][i]:
            dest = nloci
        if not ((src != nloci and src != -1) or dest != nloci):
            return None
        dst0 = int(ko["dst0"][i])
        s1 = _decode(codes[2 * i], rlen[2 * i])
        s2 = _decode(codes[2 * i + 1], rlen[2 * i + 1])
        qs = (None, None)
        if cfg.is_fastq and quals is not None:
            qs = (_decode_qual(quals[2 * i], rlen[2 * i]),
                  _decode_qual(quals[2 * i + 1], rlen[2 * i + 1]))
        return self._kam_from_device(title, src, dest, dst0, ko, i, s1,
                                     s2, qs)

    def _add_bubbles_codes(self, dest, codes_row, rl, novel_bits):
        """Native-path twin of _add_bubbles: reads arrive as 2-bit codes,
        so edge values come straight from the packed row (no string
        decode)."""
        _, edges = K.seq_to_kmers_and_edges(codes_row[:rl], self.cfg.ksize)
        ent = self.host._bub_batch.get(dest)
        if ent is None:
            ent = (StdUmapOrder(), {})
            self.host._bub_batch[dest] = ent
        order, counts = ent
        for pos in np.nonzero(novel_bits[: len(edges)])[0]:
            e = int(edges[pos])
            order.insert(e)
            counts[e] = counts.get(e, 0) + 1

    def _add_bubbles(self, dest, seq, novel_mask):
        _, edges = K.seq_to_kmers_and_edges(
            K.encode_bases(seq), self.cfg.ksize)
        ent = self.host._bub_batch.get(dest)
        if ent is None:
            ent = (StdUmapOrder(), {})
            self.host._bub_batch[dest] = ent
        order, counts = ent
        for pos in np.where(novel_mask[: len(edges)])[0]:
            e = int(edges[pos])
            order.insert(e)
            counts[e] = counts.get(e, 0) + 1

    def _kam_from_device(self, title, src, dest, dst0, out, i, s1, s2,
                         quals=(None, None)):
        # assignTRkmc fields are populated whenever the pair passed the vote
        # (even if both mates were then af-removed, dest -> nloci); pairs
        # that failed the vote keep struct defaults (reference :2056-2062)
        ran_asgn = bool(out["vote_pass"][i])
        rs = []
        for m in (0, 1):
            ridx = 2 * i + m
            r = ReadAsgn()
            r.kf = int(out["kf"][ridx])
            r.hf = int(out["hf"][ridx])
            r.bf = int(out["bf"][ridx])
            r.rm = int(out["rm"][ridx])
            r.af = int(out["af"][ridx])
            if ran_asgn:
                r.nt = int(out["nt"][ridx])
                r.bs = int(out["bs"][ridx])
                r.ti = int(out["ti"][ridx])
                r.si = int(out["si"][ridx])
                r.ei = int(out["ei"][ridx])
                nk = int(out["nk"][ridx])
                r.as_ = out["ann"][ridx][:nk].tolist()
            rs.append(r)
        return _kam_row(title, src, dest, dst0, rs[0], rs[1], s1, s2,
                        self.cfg.is_fastq, quals[0] or ".", quals[1] or ".")

    # -- outputs --

    def flat_counts(self) -> np.ndarray:
        dev = self._dev_state("counts")[:-1].astype(np.uint64)
        return dev + self.host.flat_counts()

    def write_trkmc_ar(self, path):
        bio.write_karray(path, self.flat_counts())

    def write_tr_kmers(self, path):
        flat = self.flat_counts()
        off = self.drp.locus_offsets
        with open(path, "w") as f:
            for i in range(self.rpgg.nloci):
                f.write(f">{i}\n")
                cnts = flat[off[i] : off[i + 1]]
                for km, c in zip(self.rpgg.tr_orders[i], cnts):
                    f.write(f"{km}\t{c}\n")

    def write_summary(self, path):
        nmap = self._dev_state("nmapread")[:-1] + self.host.nmapread
        kmc = self._dev_state("kmc")[:-1].astype(np.uint64) + \
            self.host.kmc
        with open(path, "w") as f:
            for i in range(self.rpgg.nloci):
                f.write(f"{nmap[i]}\t{kmc[i]}\n")

    def write_kam(self, path):
        from ..io.rowsink import finalize_rows

        finalize_rows(self.kam_rows, path)

    def write_bubbles(self, path, threshold: int = 5):
        self.host.write_bubbles(path, threshold)
