"""Host-exact aligner: a from-scratch, bit-exact implementation of
``danbing-tk align`` (asgn counting mode, the live default at reference
HEAD -- src/aQueryFasta_thread.cpp:1803-2283, countMode=2).

Role in the framework
---------------------
This is the *compatibility oracle* and referee: it reproduces the reference
outputs byte-for-byte (.kam, .tr.kmers, .trkmc.ar, .tr.summary.txt,
.bub.kmdb) and defines the per-pair semantics that the device engine
(engine/device_align.py) implements in vectorized fixed-shape form.  The
device engine routes the rare pairs whose outcome depends on the
reference's early-stop scan-order (ties / test2 boundary) through
``process_pair`` here, guaranteeing end-to-end bit-exactness at device
speed.

Implementation-defined details replicated:
  * unordered_map iteration order (utils.stdumap) for all output files
  * std::sort tie order in the locus-vote preprocessing (native lib)
  * the qn/qm field swap in kam rows (reference callsite passes qm before
    qn into assign(..., qn_, qm_), aQueryFasta_thread.cpp:2171-2172)
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from dataclasses import dataclass, field

import numpy as np

from ..io import binary as bio
from ..io import text as tio
from ..ops import kmers_np as K
from ..utils.stdumap import StdUmapOrder

NAN64 = 0xFFFFFFFFFFFFFFFF
NAN32 = 0xFFFFFFFF

_ROOT = os.path.join(os.path.dirname(__file__), "..", "..")
_LIBPATH = os.path.join(_ROOT, "build", "libdtk_native.so")
_lib = None


def _native():
    global _lib
    if _lib is None:
        if not os.path.exists(_LIBPATH):
            subprocess.run(
                ["make", "-C", os.path.join(_ROOT, "native")], check=True
            )
        _lib = ctypes.CDLL(_LIBPATH)
        _lib.dtk_sort_index_by_value.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64),
        ]
    return _lib


def gxx_sort_index(data: np.ndarray) -> np.ndarray:
    """Index order of libstdc++ std::sort by value (unstable tie order)."""
    data = np.ascontiguousarray(data, dtype=np.uint64)
    idx = np.empty(len(data), dtype=np.uint64)
    _native().dtk_sort_index_by_value(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        len(data),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    return idx


@dataclass
class AlignConfig:
    ksize: int = 21
    cth: int = 10            # -cth Cthreshold
    n_filter: int = 4        # -kf INT1
    nm_filter: int = 1       # -kf INT2
    nm_tr: int = 40          # -c
    max_nt: int = 2
    okam: bool = True        # kam output on (default; -ka turns off)
    bait: bool = False
    qc: bool = False
    simmode: int = 0
    output_bubbles: bool = False
    qth: int = 20
    is_fastq: bool = False
    reads_per_batch: int = 300000
    # threading mode (-g/-gc/-gcc; reference v1.3.1 behavior, see
    # engine/threading.py)
    threading: bool = False
    thread_cth: int = 100
    correction: bool = True
    maxncorrection: int = 4
    track_bait: bool = False  # -tb: record first-violator bait kmers
    tc: bool = False         # -gcc sanity check
    aln: bool = False        # -a
    aln_minimal: bool = False  # -ae
    # -e 1|2: emit vote-assigned read pairs (1: title; 2: title:locus) and
    # skip all counting/output (reference loads only the dbi in this mode,
    # aQueryFasta_thread.cpp:2484-2488, branch :2094-2100, writer
    # :1618-1645); QC/bait do not apply
    extract: int = 0


class RPGG:
    """Host-resident RPGG index bundle (pref.kmers.dbi/.fl.kdb/.tre.kdb/
    .tr.kmers [+ .bt.kmdb bait, + qc])."""

    def __init__(self, pref: str, bait: bool = False,
                 qc_file: str | None = None, trim: int = 0):
        self.pref = pref
        keys, vals, vv = bio.read_index_dbi(pref + ".kmers.dbi")
        self.dbi = dict(zip(keys.tolist(), vals.tolist()))
        self.vv = vv
        # -t selects an alternate trKmerDB (aQueryFasta_thread.cpp:2389)
        trf = (pref + f".tr.trim{trim}.kmers") if trim \
            else (pref + ".tr.kmers")
        self.nloci = tio.count_loci(trf)
        # trKmerDB: per-locus {kmer: 0} with recorded insertion order
        self.tr_orders = [StdUmapOrder() for _ in range(self.nloci)]
        self.tr_counts: list[dict] = [dict() for _ in range(self.nloci)]
        idx = -1
        with open(trf, "rb") as f:
            for line in f:
                if line.startswith(b">"):
                    idx += 1
                else:
                    km = int(line.split()[0])
                    self.tr_orders[idx].insert(km)
                    self.tr_counts[idx][km] = 0
        fli, fks = bio.read_kset_db(pref + ".fl.kdb")
        self.fl_sets = _split_sets(fli, fks)
        ei, es = bio.read_kset_db(pref + ".tre.kdb")
        self.tre_sets = _split_sets(ei, es)
        self.bait_dbs = None
        if bait:
            pf = pref + (".qc.bt.kmdb" if qc_file else ".bt.kmdb")
            bi, bks, bvs = bio.read_kmap_db(pf)
            self.bait_dbs = _split_maps(bi, bks, bvs)
        self.qc_filter = (
            tio.read_qc_file(qc_file, self.nloci) if qc_file else None
        )
        self.graphs = None  # loaded on demand for threading mode

    def load_graphs(self):
        """Per-locus dBG: kmer -> 4-bit out-edge mask (pref.graph.kmers)."""
        if self.graphs is None:
            dbs = tio.read_kmer_file(self.pref + ".graph.kmers")
            # readGraphKmers ORs masks; counts here already merged
            self.graphs = dbs
        return self.graphs


def _split_sets(index, ks):
    out, p = [], 0
    for n in index.tolist():
        out.append(set(ks[p : p + n].tolist()))
        p += n
    return out


def _split_maps(index, ks, vs):
    out, p = [], 0
    for n in index.tolist():
        out.append(dict(zip(ks[p : p + n].tolist(), vs[p : p + n].tolist())))
        p += n
    return out


@dataclass
class ReadAsgn:
    """km_asgn_read_t equivalent."""
    kf: int = 0
    hf: int = 0
    bf: int = 0
    qf: int = 0
    af: int = 0
    rm: int = 0
    qn: int = 0
    qm: int = 0
    si: int = -1
    ei: int = -1
    nt: int = 0
    bs: int = 0
    ti: int = -1
    si_: int = -1
    ei_: int = -1
    as_: list = field(default_factory=list)


def subfilter(kmers1, kmers2, dbi, n_filter, nm_filter) -> bool:
    """True = drop pair (both mates must pass).  Samples n_filter positions
    i*floor(L/(n-1)) plus the last; counts index membership."""
    for kmers in (kmers1, kmers2):
        L = len(kmers)
        S = L // (n_filter - 1)
        h = 0
        for i in range(n_filter):
            i1 = i * S if i != n_filter - 1 else L - 1
            if int(kmers[i1]) in dbi:
                h += 1
                if h >= nm_filter:
                    break
        if h < nm_filter:
            return True
    return False


def kfilter(kmers, dbi, cth):
    """Returns (found list[(kmer,val)], kf). found emptied on failure."""
    nk = len(kmers)
    if nk < cth:
        return [], 1
    max_ns = nk - cth
    ns = 0
    found = []
    for km in kmers:
        km = int(km)
        v = dbi.get(km)
        if v is None:
            ns += 1
            if ns > max_ns:
                return [], 1
        else:
            found.append((km, v))
    return found, 0


def fillstats(vv, its1, its2):
    """countDupRemove + nmappedloci sort + remain suffix-sums.

    its*: lists of (kmer, val).  Returns (entries, dup, remain) where
    entries = [(kmer, val)] unique sorted by (kmer, then libstdc++ sort tie
    order of nmappedloci), dup = [(fwd, rev)], remain = suffix counts.
    """
    agg: dict[int, list] = {}
    for km, v in its1:
        e = agg.get(km)
        if e is None:
            agg[km] = [v, 1, 0]
        else:
            e[1] += 1
    for km, v in its2:
        e = agg.get(km)
        if e is None:
            agg[km] = [v, 0, 1]
        else:
            e[2] += 1
    kms = sorted(agg.keys())
    vals = [agg[km][0] for km in kms]
    dup = [(agg[km][1], agg[km][2]) for km in kms]
    nmapped = np.array(
        [vv[v >> 1] if (v & 1) else 1 for v in vals], dtype=np.uint64
    )
    order = gxx_sort_index(nmapped)
    entries = [(kms[i], vals[i]) for i in order]
    dup = [dup[i] for i in order]
    n = len(entries)
    dupsum = sum(f + r for f, r in dup)
    remain = [0] * n
    if n:
        remain[0] = dupsum - dup[0][0] - dup[0][1]
        for i in range(1, n - 1):
            remain[i] = remain[i - 1] - dup[i][0] - dup[i][1]
    return entries, dup, remain


def _expand_loci(vv, v):
    if v & 1:
        off = v >> 1
        n = int(vv[off])
        return [int(x) for x in vv[off + 1 : off + 1 + n]]
    return [v >> 1]


def find_matching_locus(vv, entries, dup, remain, cth):
    """Early-stopped top-2 vote; returns (top_idx, top_fc, top_rc)."""
    hits1: dict[int, int] = {}
    hits2: dict[int, int] = {}
    top = [NAN32, 0, 0]     # idx, fc, rc
    second = [NAN32, 0, 0]

    def update(cf, ind, cr):
        if cf + cr > top[1] + top[2]:
            if top[0] != ind:
                second[:] = top
                top[0] = ind
            top[1] = cf
            top[2] = cr
        elif cf + cr > second[1] + second[2]:
            second[0] = ind
            second[1] = cf
            second[2] = cr

    n = len(entries)
    for i in range(n):
        v = entries[i][1]
        f, r = dup[i]
        for locus in _expand_loci(vv, v):
            h1 = hits1.get(locus, 0) + f
            h2 = hits2.get(locus, 0) + r
            hits1[locus] = h1
            hits2[locus] = h2
            update(h1, locus, h2)
        if not ((top[1] + top[2] - second[1] - second[2]) < remain[i]):
            j = i
            while ((top[1] < cth and cth - top[1] <= remain[j])
                   or (top[2] < cth and cth - top[2] <= remain[j])):
                j += 1
                if j >= n:
                    break
                vj = entries[j][1]
                fj, rj = dup[j]
                if vj & 1:
                    for locus in _expand_loci(vv, vj):
                        if locus == top[0]:
                            top[1] += fj
                            top[2] += rj
                            break
                else:
                    if (vj >> 1) == top[0]:
                        top[1] += fj
                        top[2] += rj
            break
    return top[0], top[1], top[2]


def count_hit(vv, its1, its2, nloci, cth, r1: ReadAsgn, r2: ReadAsgn):
    """countHit equivalent. Returns (destLocus, dst0). Sets hf/rm flags."""
    entries, dup, remain = fillstats(vv, its1, its2)
    tri0, fc, rc = find_matching_locus(vv, entries, dup, remain, cth)
    test1 = fc >= cth and rc >= cth
    test2 = (fc + rc) >= 2 * cth
    if (test1 or test2) and tri0 != NAN32:
        return tri0, tri0
    if not r1.rm:
        r1.hf = 1
    if not r2.rm:
        r2.hf = 1
    r1.rm = 1
    r2.rm = 1
    return nloci, tri0


def bfilter_fps(baitdb: dict, kmers, qmask=None, track=False):
    """bfilter_FPSv1: per-read kmer count profile vs FP [min,max] windows.

    The boolean outcome is iteration-order independent; with ``track``
    (the -tb bait tracker) the FIRST violator in the reference's kc8_t
    hash order is returned as (True, kmer), so the count map iterates in
    replayed libstdc++ order (aQueryFasta_thread.cpp:1377-1397)."""
    if not len(kmers):
        return (False, None) if track else False
    kc: dict[int, int] = {}
    order = StdUmapOrder() if track else None
    for i, km in enumerate(kmers):
        if qmask is not None and not qmask[i]:
            continue
        km = int(km)
        if track and km not in kc:
            order.insert(km)
        kc[km] = kc.get(km, 0) + 1
    for km in (order if track else kc):
        th = baitdb.get(km)
        if th is not None:
            c = kc[km]
            mi, ma = th >> 8, th & 0xFF
            if c < mi or c > ma:
                return (True, km) if track else True
    return (False, None) if track else False


def assign_trkmc(kmers, tr_counts: dict, fl_set: set, r: ReadAsgn,
                 okam: bool, nm_tr: int, max_nt: int = 2):
    """assignTRkmc (aQueryFasta_thread.cpp:1450-1556), exact.

    Returns list of kmers annotated TR (state 2) for count accumulation.
    Sets r.as_, r.si/ei/si_/ei_/nt/bs/ti and r.af/r.rm.
    """
    if not okam and r.rm:
        return []
    nk = len(kmers)
    ntr = 0
    as_ = [0] * nk
    for i in range(nk):
        km = int(kmers[i])
        if km in fl_set:
            as_[i] = 1
        elif km in tr_counts:
            as_[i] = 2
            ntr += 1
    r.as_ = as_
    if r.rm:
        r.nt = -1
        r.bs = -1
        r.ti = -1
        return []

    s_ = 0
    s__ = 0
    ti1 = -1
    ti2 = -1
    si1 = ei1 = -1
    si2 = ei2 = -1
    nt = 0
    bs = 0
    for i in range(nk):
        s = as_[i]
        if s and s__:
            if s != s__:
                nt += 1
                if nt > max_nt:
                    r.nt = nt
                    r.bs = bs
                    r.ti = ti1
                    r.af = 1
                    r.rm = 1
                    return []
                if nt == 1:
                    ti1 = i
                    if s_:
                        si1 = -1
                        ei1 = -1
                elif nt == 2:
                    if bs == 2:
                        r.nt = nt
                        r.bs = bs
                        r.ti = ti1
                        r.af = 1
                        r.rm = 1
                        return []
                    ti2 = i
                    if s_:
                        si2 = -1
                        ei2 = -1
        if not bs and s:
            bs = s
        if not s:
            if nt == 0:
                if not s_:
                    ei1 += 1
                else:
                    si1 = i
                    ei1 = i + 1
            if nt == 1:
                if not s_:
                    ei2 += 1
                else:
                    si2 = i
                    ei2 = i + 1
        s_ = s
        if s:
            s__ = s

    r.nt = nt
    r.bs = bs
    r.ti = ti1
    if nt == 0:
        if bs != 2:
            r.af = 1
            r.rm = 1
            return []
        r.si, r.ei, r.si_, r.ei_ = 0, nk, 0, nk
    elif nt == 1:
        if bs == 1:
            r.si = (si1 + ei1) // 2 if si1 >= 0 else ti1
            r.ei = nk
            r.si_ = ei1 if si1 >= 0 else ti1
            r.ei_ = nk
        else:
            r.si = 0
            r.ei = (si1 + ei1) // 2 if si1 >= 0 else ti1
            r.si_ = 0
            r.ei_ = si1 if si1 >= 0 else ti1
    else:
        if ntr < nm_tr:
            r.af = 1
            r.rm = 1
            return []
        r.si = (si1 + ei1) // 2 if si1 >= 0 else ti1
        r.ei = (si2 + ei2) // 2 if si2 >= 0 else ti2
        r.si_ = ei1 if ei1 >= 0 else ti1
        r.ei_ = si2 if si2 >= 0 else ti2
    return [int(kmers[i]) for i in range(nk) if as_[i] == 2]


def count_novel_edges(edges, r: ReadAsgn, tre_set: set, bu: StdUmapOrder,
                      bu_counts: dict):
    """countNovelEdges: (k+1)-mers inside observed TR segment not in the
    locus edge set -> bubble counts (first-touch order recorded)."""
    si, ei = r.si_, r.ei_ - 1
    assert ei >= si
    for i in range(si, ei):
        e = int(edges[i])
        if e == NAN64:
            continue
        if e not in tre_set:
            bu.insert(e)
            bu_counts[e] = bu_counts.get(e, 0) + 1


def annot2str(as_: list) -> str:
    if not as_:
        return "*"
    chs = "*.="
    out = []
    ct = 1
    a0 = as_[0]
    for a1 in as_[1:]:
        if a0 != a1:
            out.append(f"{ct}{chs[a0]}")
            ct = 1
        else:
            ct += 1
        a0 = a1
    out.append(f"{ct}{chs[a0]}")
    return "".join(out)


def prune_pe_info(title: str) -> str:
    if len(title) >= 2 and title[-2] == "/" and title[-1] in "12":
        return title[:-2]
    return title


def qstring_to_qmask(qual: str, qth: int, ksize: int) -> list[bool]:
    """qString2qMask (aQueryFasta_thread.h:1043-1078): qkm[i] True iff all
    bases of k-mer window i have quality >= qth; exact port including the
    two-pointer run structure."""
    nq = len(qual)
    nk = nq - ksize + 1
    qs = [ord(c) - 33 for c in qual]
    qkm = [False] * max(nk, 0)
    qi = 0
    ki = 0
    if nk <= 0:
        return qkm
    while qs[qi] < qth:
        qi += 1
        ki += 1
        if qi >= nk:
            return qkm
    while qi < nk:
        passed = True
        qj = qi
        while qi < qj + ksize:
            if qs[qi] < qth:
                passed = False
                ki = qi
                while qs[qi] < qth:
                    qi += 1
                    ki += 1
                    if qi >= nk:
                        return qkm
                break
            qi += 1
        if passed:
            qkm[ki] = True
            ki += 1
            if qi >= nk:
                return qkm
            while qs[qi] >= qth:
                qkm[ki] = True
                qi += 1
                ki += 1
                if qi >= nk:
                    return qkm
            ki = qi
            while qs[qi] < qth:
                qi += 1
                ki += 1
                if qi >= nk:
                    return qkm
    return qkm


def parse_read_name_sim2(title: str, nloci: int) -> int:
    """simmode 2: >$CHR:$START-$END:$LOCUS -> locus (nloci if '.')."""
    p1 = title.find(":")
    p2 = title.find(":", p1 + 1)
    val = title[p2 + 1 :]
    return nloci if val[:1] == "." else int(val)


def parse_read_name_sim1(title: str) -> int:
    """simmode 1: >$LOCUS.$IND -> locus (reads grouped by locus; the
    reference tracks group boundaries per read, equivalent per pair for
    grouped input -- parseReadName aQueryFasta_thread.cpp:477-490)."""
    return int(title[1 : title.find(".")])


def iter_fasta_pairs(path: str, min_read_size: int, nloci: int,
                     simmode: int = 0, batch_pairs: int = 150000,
                     is_fastq: bool = False):
    """Streams batches of paired reads, replicating the reference reader
    (title-hashmap pairing of a samtools-fasta/-fastq -n stream; the
    second occurrence becomes seq1, the stored first occurrence seq2).

    Yields lists of (title, seq1, seq2, src_locus[, qual1, qual2]).
    """
    read_db: dict[str, str] = {}
    fq_db: dict[str, tuple[str, str]] = {}
    batch = []
    with open(path) as f:
        title = None
        if is_fastq:
            while True:
                title = f.readline().rstrip("\n")
                if not title:
                    break
                seq = f.readline().rstrip("\n")
                f.readline()
                qual = f.readline().rstrip("\n")
                title = prune_pe_info(">" + title[1:])
                prev = fq_db.pop(title, None)
                if prev is None:
                    fq_db[title] = (seq, qual)
                    continue
                if (len(seq) < min_read_size
                        or len(prev[0]) < min_read_size):
                    continue
                src = (parse_read_name_sim2(title, nloci) if simmode == 2
                       else parse_read_name_sim1(title) if simmode == 1
                       else -1)
                batch.append((title, seq, prev[0], src, qual, prev[1]))
                if len(batch) >= batch_pairs:
                    yield batch
                    batch = []
            if batch:
                yield batch
            return
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                title = prune_pe_info(line)
            else:
                seq = line
                prev = read_db.pop(title, None)
                if prev is None:
                    read_db[title] = seq
                else:
                    if len(seq) < min_read_size or len(prev) < min_read_size:
                        continue
                    src = (
                        parse_read_name_sim2(title, nloci) if simmode == 2
                        else parse_read_name_sim1(title) if simmode == 1
                        else -1
                    )
                    batch.append((title, seq, prev, src))
                    if len(batch) >= batch_pairs:
                        yield batch
                        batch = []
    if batch:
        yield batch


class HostAligner:
    """End-to-end exact re-implementation of the align main + CountWords
    worker (single logical thread; batches processed sequentially)."""

    def __init__(self, rpgg: RPGG, cfg: AlignConfig):
        self.g = rpgg
        self.cfg = cfg
        self.nmapread = np.zeros(rpgg.nloci, dtype=np.uint64)
        self.kmc = np.zeros(rpgg.nloci, dtype=np.uint64)
        # global bubbleDB (accumulated per batch in batch-local-map order,
        # matching accumBubbles aQueryFasta_thread.cpp:1599-1606)
        self.bub_orders = [StdUmapOrder() for _ in range(rpgg.nloci)]
        self.bub_counts: list[dict] = [dict() for _ in range(rpgg.nloci)]
        # batch-local bubbles: locus -> (StdUmapOrder, counts)
        self._bub_batch: dict[int, tuple[StdUmapOrder, dict]] = {}
        # -tb bait-hit tracker (btTK), same per-locus order machinery
        self.bt_orders = [StdUmapOrder() for _ in range(rpgg.nloci)]
        self.bt_counts: list[dict] = [dict() for _ in range(rpgg.nloci)]
        self._bt_batch: dict[int, tuple[StdUmapOrder, dict]] = {}
        self.kam_rows: list[str] = []
        self.aln_rows: list[str] = []
        self.extract_rows: list[str] = []
        self.stats = dict(
            nReads=0, nShort=0, nSubFiltered=0, nKmerFiltered=0,
            nBaitFiltered=0, nQualFiltered=0, nLocusAssignFiltered=0,
            nQCFiltered=0, nThreadingReads=0, nFeasibleReads=0, nAsgnReads=0,
        )
        if cfg.threading:
            rpgg.load_graphs()
        # native (C++) threading engine: same algorithm at C++ speed;
        # opt-out via DTK_NO_NATIVE_THREAD=1 (thread_check needs the
        # Python Cigar objects, so -gcc keeps the Python path)
        self._nthr = None
        if cfg.threading and not cfg.tc and not os.environ.get(
                "DTK_NO_NATIVE_THREAD"):
            from . import native_thread as nthr

            if nthr.available():
                self._nthr = nthr.NativeThreader()

    def run_file(self, path: str):
        cfg = self.cfg
        min_read_size = cfg.cth + cfg.ksize - 1
        for batch in iter_fasta_pairs(
            path, min_read_size, self.g.nloci, cfg.simmode,
            cfg.reads_per_batch // 2, is_fastq=cfg.is_fastq,
        ):
            for rec in batch:
                title, seq1, seq2, src = rec[:4]
                quals = rec[4:6] if len(rec) > 4 else (None, None)
                self.stats["nReads"] += 2
                self.process_pair(title, seq1, seq2, src, quals)
            self.flush_batch()

    def flush_batch(self):
        """accumBubbles: merge batch-local bubble maps into the global DB in
        batch-local iteration order."""
        for locus, (order, counts) in self._bub_batch.items():
            go, gc = self.bub_orders[locus], self.bub_counts[locus]
            for km in order:
                go.insert(km)
                gc[km] = gc.get(km, 0) + counts[km]
        self._bub_batch = {}
        # accumBaitKmerHits (:1608-1616); outer tri order is irrelevant
        # (per-locus DBs), inner kmer order is the batch-local hash order
        for locus, (order, counts) in self._bt_batch.items():
            go, gc = self.bt_orders[locus], self.bt_counts[locus]
            for km in order:
                go.insert(km)
                gc[km] = gc.get(km, 0) + counts[km]
        self._bt_batch = {}

    def process_pair(self, title: str, seq1: str, seq2: str, src: int = -1,
                     quals=(None, None)):
        cfg, g = self.cfg, self.g
        st = self.stats
        k = cfg.ksize
        caks1, caes1 = K.seq_to_kmers_and_edges(K.encode_bases(seq1), k)
        caks2, caes2 = K.seq_to_kmers_and_edges(K.encode_bases(seq2), k)
        if not _nonempty(caks1) or not _nonempty(caks2):
            st["nShort"] += 1
            return
        if cfg.n_filter and cfg.nm_filter:
            if subfilter(caks1, caks2, g.dbi, cfg.n_filter, cfg.nm_filter):
                st["nSubFiltered"] += 2
                return
        r1, r2 = ReadAsgn(), ReadAsgn()
        its1, r1.kf = kfilter(caks1, g.dbi, cfg.cth)
        its2, r2.kf = kfilter(caks2, g.dbi, cfg.cth)
        r1.rm |= r1.kf
        r2.rm |= r2.kf
        st["nKmerFiltered"] += r1.kf + r2.kf
        if r1.rm and r2.rm:
            return
        dest, dst0 = count_hit(g.vv, its1, its2, g.nloci, cfg.cth, r1, r2)
        st["nLocusAssignFiltered"] += r1.hf + r2.hf
        if dest == g.nloci:
            return
        if cfg.qc and not g.qc_filter[dest]:
            st["nQCFiltered"] += 2 - r1.rm - r2.rm
            return

        st["nThreadingReads"] += 2

        if cfg.threading:
            self._thread_pair(title, seq1, seq2, src, dest)
            return
        st["nFeasibleReads"] += 2

        if cfg.extract:
            self._record_extract(title, seq1, seq2, dest, quals)
            return

        if cfg.bait:
            bdb = g.bait_dbs[dest]
            tb = cfg.track_bait
            if cfg.is_fastq:
                qkm1 = qstring_to_qmask(quals[0], cfg.qth, cfg.ksize)
                qkm2 = qstring_to_qmask(quals[1], cfg.qth, cfg.ksize)
                bf1 = bfilter_fps(bdb, caks1, qkm1, track=tb)
                bf2 = bfilter_fps(bdb, caks2, qkm2, track=tb)
            else:
                bf1 = bfilter_fps(bdb, caks1, track=tb)
                bf2 = bfilter_fps(bdb, caks2, track=tb)
            if tb:
                for bf, vkm in (bf1, bf2):
                    if bf:
                        ent = self._bt_batch.get(dest)
                        if ent is None:
                            ent = (StdUmapOrder(), {})
                            self._bt_batch[dest] = ent
                        if vkm not in ent[1]:
                            ent[0].insert(vkm)
                        ent[1][vkm] = ent[1].get(vkm, 0) + 1
                bf1, bf2 = bf1[0], bf2[0]
            r1.bf, r2.bf = int(bf1), int(bf2)
            if bf1 or bf2:
                st["nBaitFiltered"] += (r1.bf & (not r1.rm)) + (
                    r2.bf & (not r2.rm))
                r1.rm = 1
                r2.rm = 1
                dest = g.nloci

        trk1 = trk2 = []
        if cfg.okam or not r1.rm or not r2.rm:
            trc = g.tr_counts[dst0]
            fls = g.fl_sets[dst0]
            trk1 = assign_trkmc(caks1, trc, fls, r1, cfg.okam, cfg.nm_tr,
                                cfg.max_nt)
            trk2 = assign_trkmc(caks2, trc, fls, r2, cfg.okam, cfg.nm_tr,
                                cfg.max_nt)
        if r1.rm and r2.rm:
            dest = g.nloci
        else:
            n = 2 - r1.rm - r2.rm
            self.nmapread[dest] += n
            st["nAsgnReads"] += n
            self.kmc[dest] += (r1.ei - r1.si) + (r2.ei - r2.si)
            trc = g.tr_counts[dst0]
            if not r1.rm:
                for km in trk1:
                    trc[km] += 1
            if not r2.rm:
                for km in trk2:
                    trc[km] += 1
            if cfg.output_bubbles:
                tre = g.tre_sets[dest]
                ent = self._bub_batch.get(dest)
                if ent is None:
                    ent = (StdUmapOrder(), {})
                    self._bub_batch[dest] = ent
                if not r1.rm:
                    count_novel_edges(caes1, r1, tre, ent[0], ent[1])
                if not r2.rm:
                    count_novel_edges(caes2, r2, tre, ent[0], ent[1])

        if cfg.okam and ((src != g.nloci and src != -1) or dest != g.nloci):
            self.kam_rows.append(
                _kam_row(title, src, dest, dst0, r1, r2, seq1, seq2,
                         cfg.is_fastq, quals[0] or ".", quals[1] or ".")
            )

    def _record_extract(self, title, seq1, seq2, dest, quals=(None, None)):
        """writeExtractedReads: mate 2 first (the reference walks its
        read array backwards), title verbatim (+':locus' for -e 2),
        fastq form keeps '@' + quality lines."""
        cfg = self.cfg
        t = title if not cfg.is_fastq else "@" + title[1:]
        if cfg.extract != 1:
            t = f"{t}:{dest}"
        if cfg.is_fastq:
            self.extract_rows.append(
                f"{t}\n{seq2}\n+\n{quals[1]}\n"
                f"{t}\n{seq1}\n+\n{quals[0]}\n")
        else:
            self.extract_rows.append(f"{t}\n{seq2}\n{t}\n{seq1}\n")

    def _thread_pair(self, title, seq1, seq2, src, dest, results=None):
        """Threading-mode branch (re-enabled v1.3.1 behavior; counting =
        aln mode over the corrected kmer streams of aligned mates).

        ``results``: optional precomputed engine outputs
        ((st, es, tr, kmers) per mate) — the native funnel fans the
        thread-safe engine calls over a pool and applies them here in
        pair order."""
        from . import threading as thr

        cfg, g = self.cfg, self.g
        k = cfg.ksize
        trc = g.tr_counts[dest]
        if results is not None:
            (alned0, es1, tr1, ak0), (alned1, es2, tr2, ak1) = results
        elif self._nthr is not None:
            gf = g.graphs[dest]
            self._nthr.prepare(dest, gf, trc)
            alned0, es1, tr1, ak0 = self._nthr.thread_read(
                dest, seq1, cfg.thread_cth, cfg.correction, k,
                cfg.maxncorrection)
            alned1, es2, tr2, ak1 = self._nthr.thread_read(
                dest, seq2, cfg.thread_cth, cfg.correction, k,
                cfg.maxncorrection)
        else:
            gf = g.graphs[dest]
            cg1 = thr.Cigar(seq1, k)
            alned0, _, ak0 = thr.is_thread_feasible(
                gf, seq1, cfg.thread_cth, cfg.correction, cg1, trc, k,
                cfg.maxncorrection)
            cg2 = thr.Cigar(seq2, k)
            alned1, _, ak1 = thr.is_thread_feasible(
                gf, seq2, cfg.thread_cth, cfg.correction, cg2, trc, k,
                cfg.maxncorrection)
            if cfg.tc:
                if alned0:
                    thr.thread_check(gf, seq1, ak0, cg1, k)
                if alned1:
                    thr.thread_check(gf, seq2, ak1, cg2, k)
            es1, tr1 = cg1.es, cg1.tr
            es2, tr2 = cg2.es, cg2.tr
        if cfg.extract:
            if alned0 or alned1:
                self._record_extract(title, seq1, seq2, dest)
            return
        if alned0 or alned1:
            # canonicalize the whole corrected k-mer stream in ONE
            # vectorized pass (per-kmer to_ca built a numpy array per
            # call and dominated the fallback at 33 pairs/s; trc updates
            # are commutative adds, so batch order is free)
            kml = []
            if alned0:
                kml.extend(km for km in ak0 if km != thr.NAN64)
            if alned1:
                kml.extend(km for km in ak1 if km != thr.NAN64)
            cak: dict[int, int] = {}
            if kml:
                arr = np.array(kml, dtype=np.uint64)
                ca_arr = np.minimum(arr, K.revcomp_kmers(arr, k))
                for ca in ca_arr.tolist():
                    cak[ca] = cak.get(ca, 0) + 1
            for km, c in cak.items():
                if km in trc:
                    trc[km] += c
            self.stats["nFeasibleReads"] += int(bool(alned0)) + int(
                bool(alned1))
        else:
            dest = g.nloci

        if cfg.aln:
            if cfg.simmode:
                keep = (not cfg.aln_minimal) or (src != g.nloci
                                                 or dest != g.nloci)
            else:
                keep = (not cfg.aln_minimal) or dest != g.nloci
            if keep:
                src_s = "." if src == -1 else str(src)
                self.aln_rows.append(
                    f"{src_s}\t{dest}\t{title}\t{seq2}\t{seq1}\t"
                    f"{thr.write_cigar(es2)}\t{thr.write_annot(tr2)}\t"
                    f"{thr.write_cigar(es1)}\t{thr.write_annot(tr1)}\n"
                )

    # ---- outputs ----

    def write_btk(self, path: str):
        """dumpBaitKmerHits -> dumpKmerMapDB('btk', ...) u64 values."""
        index, ks, vs = [], [], []
        for i in range(self.g.nloci):
            cnt = self.bt_counts[i]
            for km in self.bt_orders[i]:
                ks.append(km)
                vs.append(cnt[km])
            index.append(len(cnt))
        bio.write_kmap_db(path, np.array(index, np.uint64),
                          np.array(ks, np.uint64),
                          np.array(vs, np.uint64))

    def write_extract(self, fh):
        from ..io.rowsink import finalize_rows_fh

        finalize_rows_fh(self.extract_rows, fh)

    def write_aln(self, path: str):
        from ..io.rowsink import finalize_rows

        finalize_rows(self.aln_rows, path)

    def write_kam(self, path: str):
        from ..io.rowsink import finalize_rows

        finalize_rows(self.kam_rows, path)

    def write_tr_kmers(self, path: str):
        """-on output: writeKmersWithName in map iteration order."""
        with open(path, "w") as f:
            for i in range(self.g.nloci):
                f.write(f">{i}\n")
                cnt = self.g.tr_counts[i]
                for km in self.g.tr_orders[i]:
                    f.write(f"{km}\t{cnt[km]}\n")

    def flat_counts(self) -> np.ndarray:
        fc = getattr(self.g, "flat_counts", None)
        if fc is not None:
            # flat host view: counts already live in trkmc flatten order
            return fc()
        out = []
        for i in range(self.g.nloci):
            cnt = self.g.tr_counts[i]
            out.extend(cnt[km] for km in self.g.tr_orders[i])
        return np.asarray(out, dtype=np.uint64)

    def write_trkmc_ar(self, path: str):
        bio.write_karray(path, self.flat_counts())

    def write_summary(self, path: str):
        with open(path, "w") as f:
            for i in range(self.g.nloci):
                f.write(f"{self.nmapread[i]}\t{self.kmc[i]}\n")

    def write_bubbles(self, path: str, threshold: int = 5):
        index, ks, vs = [], [], []
        for i in range(self.g.nloci):
            cnt = self.bub_counts[i]
            nskip = 0
            for km in self.bub_orders[i]:
                c = cnt[km]
                if c >= threshold:
                    ks.append(km)
                    vs.append(c)
                else:
                    nskip += 1
            index.append(len(cnt) - nskip)
        # dumpKmerMapDB declares vs as vector<uint64_t> regardless of the
        # map's value type (aQueryFasta_thread.h:998-1004) -> 8-byte values
        bio.write_kmap_db(path, np.array(index, np.uint64),
                          np.array(ks, np.uint64), np.array(vs, np.uint64))


def _nonempty(kmers) -> bool:
    return len(kmers) > 0 and bool((kmers != NAN64).any())


def _fmt(v) -> str:
    return "." if v == -1 else str(v)


def _kam_row(title, src, dst, dst0, r1: ReadAsgn, r2: ReadAsgn, seq1, seq2,
             is_fastq, qual1=".", qual2="."):
    dst0_out = dst0 if dst != dst0 else -1
    as1 = annot2str(r1.as_)
    as2 = annot2str(r2.as_)
    src_s = "." if src == -1 else str(src)
    # NOTE qn/qm swap: reference passes (.., qm, qn) into assign(.., qn_, qm_)
    f1 = (f"{r1.kf}:{r1.hf}:{r1.bf}:{r1.qf}:{r1.af}:{r1.rm}:"
          f"{r1.qm}:{r1.qn}:{_fmt(r1.si)}:{_fmt(r1.nt)}:{_fmt(r1.bs)}:"
          f"{_fmt(r1.ti)}")
    f2 = (f"{r2.kf}:{r2.hf}:{r2.bf}:{r2.qf}:{r2.af}:{r2.rm}:"
          f"{r2.qm}:{r2.qn}:{_fmt(r2.si)}:{_fmt(r2.nt)}:{_fmt(r2.bs)}:"
          f"{_fmt(r2.ti)}")
    return (
        f"{src_s}\t{dst}\t{dst0_out}\t{r2.ei - r2.si}\t{r1.ei - r1.si}\t"
        f"kf:hf:bf:qf:af:rm:qn:qm:si:nt:bs:ti\t{f2}\t{f1}\t"
        f"{as2}\t{as1}\t{title[1:]}\t{seq2}\t{qual2 if is_fastq else '.'}\t"
        f"{seq1}\t{qual1 if is_fastq else '.'}\n"
    )
