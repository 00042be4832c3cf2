"""Device (JAX) k-mer extraction over padded read batches.

Re-derivation of the reference rolling-kmer semantics
(aQueryFasta_thread.h:246-311) as fixed-shape vectorized ops:

  input : codes (B, L) uint8 -- 2-bit base codes, 255 = invalid (N / pad)
          rlen  (B,)   int32 -- read lengths
  output: per-window canonical k-mers as u32 (lo, hi) planes, plus a
          validity mask; and canonical (k+1)-mer edges.

K-mers are *bit-packed*, so the "rolling" construction becomes k shifted
ORs per plane with no carries: base j of a window occupies bit slot
2*(k-1-j) (forward) or 2*j complemented (reverse).  The engine runs with
64-bit types off, so keys live as (lo, hi) u32 pairs end-to-end; lo
holds key bits [0,32) and hi bits [32,64).  Windows containing an invalid base
or overrunning the read length are masked to the EMPTY sentinel
(0xFFFFFFFF in both planes), mirroring the reference's -1ULL.

Costs: O(k * B * NK) elementwise ops; XLA fuses the shifted ORs.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

EMPTY = np.uint32(0xFFFFFFFF)


def _window_pack(c: jnp.ndarray, k: int, reverse: bool):
    """Pack k 2-bit codes per window into (lo, hi) u32 planes.

    c: (..., L) uint32 codes (invalid already zeroed).
    Returns (lo, hi): (..., L-k+1).
    """
    L = c.shape[-1]
    n = L - k + 1
    lo = jnp.zeros(c.shape[:-1] + (n,), dtype=jnp.uint32)
    hi = jnp.zeros_like(lo)
    for j in range(k):
        b = c[..., j : j + n]
        if reverse:
            b = jnp.uint32(3) - b
            t = 2 * j
        else:
            t = 2 * (k - 1 - j)
        if t < 32:
            lo = lo | (b << t)
        else:
            hi = hi | (b << (t - 32))
    return lo, hi


def _lt(alo, ahi, blo, bhi):
    """(ahi,alo) < (bhi,blo) as u64 comparison in u32 planes."""
    return (ahi < bhi) | ((ahi == bhi) & (alo < blo))


@functools.partial(jax.jit, static_argnames=("k",))
def extract_kmers_edges(codes: jnp.ndarray, rlen: jnp.ndarray, k: int):
    """Canonical k-mers + (k+1)-mer edges for a read batch.

    codes: (B, L) uint8; rlen: (B,) int32.
    Returns dict with:
      klo, khi   : (B, L-k+1) u32   canonical k-mers (EMPTY if invalid)
      kvalid     : (B, L-k+1) bool
      elo, ehi   : (B, L-k)   u32   canonical (k+1)-mer edges
      evalid     : (B, L-k)   bool
      nk         : (B,)       int32 number of k-mer positions (rlen-k+1, >=0)
      any_valid  : (B,)       bool  read has >= 1 valid k-mer
    """
    B, L = codes.shape
    n = L - k + 1
    valid = codes != np.uint8(255)
    c = jnp.where(valid, codes, 0).astype(jnp.uint32)

    # window validity: all k bases valid and window within read
    bad = (~valid).astype(jnp.int32)
    cbad = jnp.cumsum(bad, axis=-1)
    cbad = jnp.concatenate([jnp.zeros((B, 1), jnp.int32), cbad], axis=-1)
    pos = jnp.arange(n, dtype=jnp.int32)[None, :]
    wvalid_k = (cbad[:, k:] - cbad[:, :-k]) == 0
    wvalid_k &= pos + k <= rlen[:, None]

    flo, fhi = _window_pack(c, k, reverse=False)
    rlo, rhi = _window_pack(c, k, reverse=True)
    use_r = _lt(rlo, rhi, flo, fhi)
    klo = jnp.where(use_r, rlo, flo)
    khi = jnp.where(use_r, rhi, fhi)
    klo = jnp.where(wvalid_k, klo, EMPTY)
    khi = jnp.where(wvalid_k, khi, EMPTY)
    nclo = jnp.where(wvalid_k, flo, EMPTY)   # non-canonical (graph nodes)
    nchi = jnp.where(wvalid_k, fhi, EMPTY)

    # edges: forward (k+1)-mer = fwd[i]<<2 | base[i+k]
    #        rc      (k+1)-mer = rc[i] | (3-base[i+k]) << 2k
    ne = L - k
    b_next = c[:, k : k + ne]
    eflo = (flo[:, :ne] << 2) | b_next
    efhi = (fhi[:, :ne] << 2) | (flo[:, :ne] >> 30)
    nb = jnp.uint32(3) - b_next
    t = 2 * k
    if t < 32:
        erlo = rlo[:, :ne] | (nb << t)
        erhi = rhi[:, :ne]
    else:
        erlo = rlo[:, :ne]
        erhi = rhi[:, :ne] | (nb << (t - 32))
    use_re = _lt(erlo, erhi, eflo, efhi)
    elo = jnp.where(use_re, erlo, eflo)
    ehi = jnp.where(use_re, erhi, efhi)
    wvalid_e = (cbad[:, k + 1 :] - cbad[:, : -(k + 1)]) == 0
    wvalid_e &= jnp.arange(ne, dtype=jnp.int32)[None, :] + k + 1 <= rlen[:, None]
    elo = jnp.where(wvalid_e, elo, EMPTY)
    ehi = jnp.where(wvalid_e, ehi, EMPTY)

    nk = jnp.maximum(rlen - k + 1, 0)
    return dict(
        klo=klo, khi=khi, kvalid=wvalid_k,
        nclo=nclo, nchi=nchi,
        elo=elo, ehi=ehi, evalid=wvalid_e,
        nk=nk, any_valid=wvalid_k.any(axis=-1),
    )


def pack_reads(seqs: list, L: int):
    """Host helper: ASCII reads -> (codes (B,L) u8, rlen (B,) i32)."""
    from .kmers_np import encode_bases

    B = len(seqs)
    codes = np.full((B, L), 255, dtype=np.uint8)
    rlen = np.zeros(B, dtype=np.int32)
    for i, s in enumerate(seqs):
        cs = encode_bases(s)[:L]
        codes[i, : len(cs)] = cs
        rlen[i] = len(cs)
    return codes, rlen
