"""ctypes bindings for the native (C++) graph-threading engine.

``build/libdtk_thread.so`` implements the same algorithm as
``engine.threading`` (isThreadFeasible + error correction + CIGAR
surgery) at C++ speed.  The host threading fallback is the serial
bottleneck of threading-mode runs — the device DFA resolves clean walks,
everything else lands here.

The wrapper returns results in the exact shapes ``host_align._thread_pair``
consumes: an ``es`` list compatible with ``threading.write_cigar``, the
``tr`` annotation list for ``write_annot``, and the corrected k-mer
stream (with NAN64 placeholders preserved) for counting.

Validated byte-exact against the Python engine / the reference oracle by
tests/test_native_thread.py.
"""

from __future__ import annotations

import ctypes as C
import os

import numpy as np

_LIB = None


def _find_lib():
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(here, "build", "libdtk_thread.so")


def available() -> bool:
    return os.path.exists(_find_lib())


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = C.CDLL(_find_lib())
    lib.dtk_graph_new.restype = C.c_void_p
    lib.dtk_graph_add.argtypes = [C.c_void_p, C.POINTER(C.c_uint64),
                                  C.POINTER(C.c_uint8), C.c_int64]
    lib.dtk_graph_free.argtypes = [C.c_void_p]
    lib.dtk_thread_read.restype = C.c_int
    lib.dtk_thread_read.argtypes = [
        C.c_void_p, C.c_void_p, C.c_char_p, C.c_int64, C.c_uint64,
        C.c_int, C.c_uint64, C.c_int, C.c_char_p,
        C.POINTER(C.c_int64), C.c_char_p, C.POINTER(C.c_int64),
        C.POINTER(C.c_uint64), C.POINTER(C.c_int64)]
    lib.dtk_counts_new.restype = C.c_void_p
    lib.dtk_counts_free.argtypes = [C.c_void_p]
    lib.dtk_counts_size.restype = C.c_int64
    lib.dtk_counts_size.argtypes = [C.c_void_p]
    lib.dtk_counts_drain.argtypes = [C.c_void_p, C.POINTER(C.c_uint64),
                                     C.POINTER(C.c_uint64)]
    lib.dtk_thread_pairs.restype = C.c_int64
    lib.dtk_thread_pairs.argtypes = [
        C.POINTER(C.c_void_p), C.POINTER(C.c_void_p),
        C.POINTER(C.c_void_p), C.POINTER(C.c_uint8),
        C.POINTER(C.c_int32), C.c_int64, C.c_int64, C.c_uint64,
        C.c_int, C.c_uint64, C.c_int, C.c_int, C.c_int,
        C.POINTER(C.c_uint8), C.c_char_p, C.c_int64,
        C.POINTER(C.c_int64)]
    _LIB = lib
    return lib


class _CGraph:
    __slots__ = ("h", "lib")

    def __init__(self, lib, kv: dict):
        self.lib = lib
        self.h = lib.dtk_graph_new()
        n = len(kv)
        if n:
            keys = np.fromiter(kv.keys(), dtype=np.uint64, count=n)
            vals = np.fromiter((v & 0xFF for v in kv.values()),
                               dtype=np.uint8, count=n)
            lib.dtk_graph_add(
                self.h, keys.ctypes.data_as(C.POINTER(C.c_uint64)),
                vals.ctypes.data_as(C.POINTER(C.c_uint8)), n)

    def __del__(self):
        if self.h:
            self.lib.dtk_graph_free(self.h)
            self.h = None


class NativeThreader:
    """Per-RPGG cache of native graph handles + the thread_read call.

    ``thread_read`` is THREAD-SAFE (per-call scratch buffers; the C++
    walk only reads the shared graph handles), so a pool can fan calls
    across cores — ctypes releases the GIL for the engine's duration.
    ``prepare`` mutates the handle cache and must stay on one thread."""

    def __init__(self):
        self.lib = _load()
        self._graphs: dict[int, _CGraph] = {}
        self._trks: dict[int, _CGraph] = {}
        self._cnts: dict[int, int] = {}   # locus -> CountMap handle

    def __del__(self):
        lib = getattr(self, "lib", None)
        if lib is not None:
            for h in getattr(self, "_cnts", {}).values():
                lib.dtk_counts_free(h)
            self._cnts = {}

    def prepare(self, locus: int, graph: dict, tr_counts: dict):
        if locus not in self._graphs:
            self._graphs[locus] = _CGraph(self.lib, graph)
            self._trks[locus] = _CGraph(
                self.lib, {k: 0 for k in tr_counts})
            self._cnts[locus] = self.lib.dtk_counts_new()

    def prepared(self, locus: int) -> bool:
        return locus in self._graphs

    def thread_pairs(self, dests, codes: np.ndarray, rlens: np.ndarray,
                     thread_cth: int, correction: bool, ksize: int,
                     maxncorrection: int, nworkers: int = 0,
                     want_aln: bool = False):
        """Batched fallback: one C call walks every pair over internal
        worker threads.  codes is (2n, L) u8 2-bit rows (255 = non-ACGT),
        dests the per-pair locus ids (all prepare()d).  Corrected-k-mer
        counts accumulate in the per-locus native CountMaps (drain with
        drain_counts_into at checkpoint/finalize boundaries).

        Returns (status (2n,) u8, cg_rows or None) where cg_rows[r] is
        the ready b"<cigar>\\t<annot>" bytes for mate r (want_aln)."""
        n = len(dests)
        if n == 0:
            return np.zeros(0, np.uint8), [] if want_aln else None
        codes = np.ascontiguousarray(codes, dtype=np.uint8)
        rlens = np.ascontiguousarray(rlens, dtype=np.int32)
        VP = C.c_void_p * n
        gh = VP(*(self._graphs[d].h for d in dests))
        th = VP(*(self._trks[d].h for d in dests))
        ch = VP(*(self._cnts[d] for d in dests))
        status = np.zeros(2 * n, dtype=np.uint8)
        if want_aln:
            # worst case RLE ~2 chars/op + counts; 8x read len is ample
            cg_stride = 8 * int(codes.shape[1])
            cg_buf = np.zeros(2 * n * cg_stride, dtype=np.uint8)
            cg_lens = np.zeros(2 * n, dtype=np.int64)
            cg_ptr = cg_buf.ctypes.data_as(C.c_char_p)
            cl_ptr = cg_lens.ctypes.data_as(C.POINTER(C.c_int64))
        else:
            cg_stride, cg_buf, cg_lens = 0, None, None
            cg_ptr, cl_ptr = C.c_char_p(), C.cast(
                C.c_void_p(), C.POINTER(C.c_int64))
        if nworkers <= 0:
            nworkers = max((os.cpu_count() or 2) - 1, 1)
        self.lib.dtk_thread_pairs(
            gh, th, ch, codes.ctypes.data_as(C.POINTER(C.c_uint8)),
            rlens.ctypes.data_as(C.POINTER(C.c_int32)), n,
            codes.shape[1], thread_cth, int(correction), ksize,
            maxncorrection, nworkers, int(want_aln), status.ctypes
            .data_as(C.POINTER(C.c_uint8)), cg_ptr, cg_stride, cl_ptr)
        if not want_aln:
            return status, None
        rows = cg_buf.reshape(2 * n, cg_stride)
        cg_rows = [rows[r, :cg_lens[r]].tobytes() for r in range(2 * n)]
        return status, cg_rows

    def drain_counts_into(self, tr_counts: list) -> int:
        """Merge every native CountMap into the per-locus Python dicts
        (tr_counts[locus][km] += c) and clear them.  Adds commute, so
        draining at checkpoint/finalize boundaries is exact.  Returns
        the number of distinct (locus, kmer) entries merged."""
        lib = self.lib
        total = 0
        for locus, h in self._cnts.items():
            nsz = lib.dtk_counts_size(h)
            if not nsz:
                continue
            keys = np.empty(nsz, dtype=np.uint64)
            vals = np.empty(nsz, dtype=np.uint64)
            lib.dtk_counts_drain(
                h, keys.ctypes.data_as(C.POINTER(C.c_uint64)),
                vals.ctypes.data_as(C.POINTER(C.c_uint64)))
            trc = tr_counts[locus]
            for km, c in zip(keys.tolist(), vals.tolist()):
                trc[km] += c
            total += nsz
        return total

    def thread_read(self, locus: int, seq: str, thread_cth: int,
                    correction: bool, ksize: int, maxncorrection: int):
        """-> (status, es, tr, kmers); es rows are [type, '', graph_nuc]
        (read nucleotides are never consulted by write_cigar)."""
        cap = 4 * max(len(seq), 64)
        es_buf = C.create_string_buffer(cap)
        tr_buf = C.create_string_buffer(cap)
        km_buf = np.empty(cap, dtype=np.uint64)
        es_len = C.c_int64(cap)
        tr_len = C.c_int64(cap)
        nk = C.c_int64(cap)
        st = self.lib.dtk_thread_read(
            self._graphs[locus].h, self._trks[locus].h,
            seq.encode(), len(seq), thread_cth, int(correction), ksize,
            maxncorrection, es_buf, C.byref(es_len), tr_buf,
            C.byref(tr_len), km_buf.ctypes.data_as(
                C.POINTER(C.c_uint64)), C.byref(nk))
        raw = es_buf.raw[:es_len.value]
        es = []
        i = 0
        while i < len(raw):
            t = chr(raw[i])
            i += 1
            if t in ("X", "D"):
                gch = chr(raw[i])
                i += 1
                es.append([t, "", gch])
            else:
                es.append([t, "", ""])
        tr = [chr(b) for b in tr_buf.raw[:tr_len.value]]
        kmers = [int(x) for x in km_buf[:nk.value]]
        return st, es, tr, kmers


class ParallelThreader:
    """Fans the thread-safe engine calls over a worker pool.

    The native funnel submits both mates' walks as soon as a pair is
    known to need host correction (at step-fetch time) and consumes the
    futures when the pair's ordinal comes up — the engine (ctypes, GIL
    released) runs on all cores inside the device-queue shadow while
    results still apply in pair order."""

    def __init__(self, nthr: NativeThreader, cfg, nworkers: int | None = None):
        from concurrent.futures import ThreadPoolExecutor

        self.nthr = nthr
        self.cfg = cfg
        self.pool = ThreadPoolExecutor(
            nworkers or max((os.cpu_count() or 2) - 1, 1))

    def submit_read(self, dest: int, seq: str):
        cfg = self.cfg
        assert self.nthr.prepared(dest), "prepare() must precede submit"
        return self.pool.submit(
            self.nthr.thread_read, dest, seq, cfg.thread_cth,
            cfg.correction, cfg.ksize, cfg.maxncorrection)

    def close(self):
        self.pool.shutdown(wait=True)
