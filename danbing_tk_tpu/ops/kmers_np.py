"""Host-side (numpy) k-mer primitives.

These implement the exact semantics of the reference danbing-tk L1 kernel layer
(see /root/reference/src/aQueryFasta_thread.h:117-343 and src/kmer.hpp for the
behavioral spec): 2-bit base encoding A/C/G/T -> 0/1/2/3 (case-insensitive),
reverse complement of packed k-mers, canonical k-mer = min(fwd, rc), rolling
k-mer extraction with N-handling (windows containing a non-ACGT base yield the
sentinel 0xFFFF_FFFF_FFFF_FFFF), and (k+1)-mer edge extraction.

This module is the *oracle* for the device (JAX) implementations in
``danbing_tk_tpu.ops.kmers_jax`` and is itself used on the build side (RPGG
construction), where throughput is not critical.

All functions are vectorized numpy; nothing here depends on JAX.
"""

from __future__ import annotations

import numpy as np

NAN64 = np.uint64(0xFFFFFFFFFFFFFFFF)

# ASCII -> 2-bit code; non-ACGT (incl. N) -> 255
_BASE_LUT = np.full(256, 255, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    _BASE_LUT[ord(_c)] = _i
    _BASE_LUT[ord(_c.lower())] = _i

_BASE_CHR = np.frombuffer(b"ACGT", dtype=np.uint8)


def encode_bases(seq: str | bytes) -> np.ndarray:
    """ASCII sequence -> uint8 array of 2-bit codes (255 for non-ACGT)."""
    if isinstance(seq, str):
        seq = seq.encode()
    return _BASE_LUT[np.frombuffer(seq, dtype=np.uint8)]


def decode_kmer(kmer: int, k: int) -> str:
    """Packed k-mer -> ASCII string (big-endian 2-bit packing)."""
    out = bytearray(k)
    kmer = int(kmer)
    for i in range(k - 1, -1, -1):
        out[i] = _BASE_CHR[kmer & 3]
        kmer >>= 2
    return out.decode()


def encode_kmer(seq: str) -> int:
    v = 0
    for c in encode_bases(seq):
        assert c != 255
        v = (v << 2) | int(c)
    return v


def revcomp_kmers(kmers: np.ndarray, k: int) -> np.ndarray:
    """Reverse complement of packed k-mers (vectorized).

    rc[i] = complement of base (k-1-i); complement(b) = 3-b.
    """
    kmers = kmers.astype(np.uint64)
    out = np.zeros_like(kmers)
    v = kmers.copy()
    for _ in range(k):
        out = (out << np.uint64(2)) | (np.uint64(3) - (v & np.uint64(3)))
        v >>= np.uint64(2)
    return out


def seq_to_kmers(
    codes: np.ndarray, k: int, canonical: bool = True
) -> np.ndarray:
    """All k-mers of a 2-bit-coded sequence, positionally aligned.

    Returns array of length ``len(codes)-k+1`` (empty if shorter), with NAN64
    at positions whose window contains an invalid base.  Matches the reference
    ``read2kmers(..., keepN=true)`` semantics: positions before the first valid
    window and after a restart also hold NAN64.
    """
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.uint64)
    valid = codes != 255
    c = np.where(valid, codes, 0).astype(np.uint64)
    # window-validity via cumulative sum of invalid flags
    bad = (~valid).astype(np.int64)
    cbad = np.concatenate([[0], np.cumsum(bad)])
    wvalid = (cbad[k:] - cbad[:-k]) == 0  # length n

    fwd = np.zeros(n, dtype=np.uint64)
    for j in range(k):
        fwd |= c[j : j + n] << np.uint64(2 * (k - 1 - j))
    if canonical:
        rc = np.zeros(n, dtype=np.uint64)
        for j in range(k):
            rc |= (np.uint64(3) - c[j : j + n]) << np.uint64(2 * j)
        fwd = np.minimum(fwd, rc)
    return np.where(wvalid, fwd, NAN64)


def seq_to_kmers_and_edges(codes: np.ndarray, k: int):
    """Canonical k-mers + canonical (k+1)-mer edges, positionally aligned.

    Mirrors reference ``read2kmers_edges`` (aQueryFasta_thread.h:274-311):
      - kmers[i]: canonical k-mer at i, NAN64 if invalid window
      - edges[i]: canonical (k+1)-mer spanning positions i..i+k, NAN64 if
        either adjacent k-mer window is invalid.  Edge is min(fwd_edge,
        rc_edge) where fwd_edge = (fwd_kmer[i]<<2)|base(i+k) and rc_edge is
        its reverse complement.
    Returns (kmers, edges) with len(edges) == len(kmers) - 1.

    Note the reference computes the edge as (kmer_[i]<<2) + (kmer[i+1] % 4)
    over *non-canonical* rolling k-mers, with rcedge = (rckmer[i+1]<<2) +
    (rckmer_[i] % 4); this equals the canonical (k+1)-mer at i.
    """
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=np.uint64)
    kms = seq_to_kmers(codes, k, canonical=True)
    e = seq_to_kmers(codes, k + 1, canonical=True)  # length n-1, NAN-masked
    return kms, e


def count_kmers(
    counter: dict, seq: str, k: int, leftflank: int = 0, rightflank: int = 0,
    count: bool = True,
) -> None:
    """Accumulate canonical k-mer counts of seq[leftflank : len-rightflank]
    into ``counter`` (dict), preserving first-occurrence insertion order
    (Python dicts are insertion-ordered, matching the reference's insertion
    sequence into its hash map -- see buildNuKmers, aQueryFasta_thread.h:185).

    Windows with invalid bases are skipped (not counted).
    """
    codes = encode_bases(seq)
    n = len(codes)
    lo, hi = leftflank, n - rightflank - k + 1
    if hi <= lo:
        return
    kms = seq_to_kmers(codes, k, canonical=True)[lo:hi]
    inc = 1 if count else 0
    for km in kms:
        if km != NAN64:
            km = int(km)
            counter[km] = counter.get(km, 0) + inc


def build_kmer_graph(
    graph: dict, seq: str, k: int, noselfloop: bool = True
) -> None:
    """Accumulate the bidirectional de Bruijn graph of ``seq`` into ``graph``
    (dict kmer -> 4-bit out-edge mask, non-canonical nodes).

    Matches reference buildKmerGraph (aQueryFasta_thread.h:215-243): edges are
    added over the forward strand and over the reverse-complemented sequence;
    bit b of the mask marks an observed out-edge to next base b; terminal
    k-mers are inserted with mask |= 0; self-loop edges suppressed when
    ``noselfloop``.
    """
    for s in (seq, _revcomp_str(seq)):
        codes = encode_bases(s)
        kms = seq_to_kmers(codes, k, canonical=False)
        n = len(kms)
        for i in range(n):
            km = kms[i]
            if km == NAN64:
                continue
            km = int(km)
            nxt = int(kms[i + 1]) if i + 1 < n and kms[i + 1] != NAN64 else -1
            if nxt >= 0:
                b = nxt & 3
                valid = (not noselfloop) or (km != nxt)
                graph[km] = graph.get(km, 0) | ((1 if valid else 0) << b)
            else:
                graph[km] = graph.get(km, 0) | 0


def _revcomp_str(seq: str) -> str:
    comp = str.maketrans("ACGTacgtNn", "TGCAtgcaNn")
    return seq.translate(comp)[::-1]


def sample_subfilter_queries(codes: np.ndarray, rlen: np.ndarray, k: int,
                             nf: int):
    """Host-side subfilter query sampling over a packed (B, L) read batch.

    Decision-identical to the device ``prefilter_sample``
    (engine/device_align.py): the nf evenly-spaced canonical k-mers per
    read (reference subfilter, aQueryFasta_thread.cpp:172-188), EMPTY-
    masked where the window is invalid.  Computing the queries on the
    host lets the prefilter dispatch upload nf u32-pair queries per read
    (~32 B) instead of the full L-byte code row — the transfer is the
    wall on ingest-bound production runs.

    Returns (qlo, qhi) (B, nf) u32, valid (B, nf) bool, nonshort (B,).
    """
    B, L = codes.shape
    NKW = L - k + 1
    nk = np.maximum(rlen.astype(np.int32) - (k - 1), 0)
    S = nk // (nf - 1)
    starts = np.empty((B, nf), np.int32)
    for j in range(nf - 1):
        starts[:, j] = j * S
    starts[:, nf - 1] = nk - 1
    np.clip(starts, 0, NKW - 1, out=starts)

    rows = np.arange(B)[:, None, None]
    win = codes[rows, starts[..., None] + np.arange(k)]      # (B, nf, k)
    wvalid = (win != 255).all(axis=-1) & (starts + k <= rlen[:, None])
    c = win.astype(np.uint64)
    fwd = np.zeros((B, nf), np.uint64)
    rc = np.zeros((B, nf), np.uint64)
    for j in range(k):
        fwd |= c[..., j] << np.uint64(2 * (k - 1 - j))
        rc |= (np.uint64(3) - c[..., j]) << np.uint64(2 * j)
    km = np.minimum(fwd, rc)
    valid = wvalid & (starts < nk[:, None])
    sent = np.uint64(0xFFFFFFFF)
    qlo = np.where(valid, km & sent, sent).astype(np.uint32)
    qhi = np.where(valid, km >> np.uint64(32), sent).astype(np.uint32)
    return qlo, qhi, valid, nk > 0
