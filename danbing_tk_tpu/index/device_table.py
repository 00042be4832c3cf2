"""Open-addressing hash tables for device-resident k-mer lookup.

The reference probes ``std::unordered_map`` per k-mer (pointer-chasing,
aQueryFasta_thread.cpp:190-245).  On the device we replace this with
flat power-of-two open-addressing tables in device memory, probed by
vectorized gathers.  Keys are canonical k-mers (<= 62 bits) split into
u32 (lo, hi) planes, so all device arithmetic is 32-bit (the engine runs
with 64-bit types off).

Three table flavors:
  * KmerTable       : kmer -> u32 value          (kmerDBi)
  * LocusKmerTable  : (kmer, locus) -> u32 value (TR/flank annotation,
                      TR-count slot ids, tre edge membership, bait windows)

Empty slots hold key = 0xFFFFFFFF in both planes (no valid <=62-bit kmer
maps there).  Load factor is capped at 0.6; probe loops are bounded by the
max displacement recorded at build time so the XLA while-loop has a static
trip bound.
"""

from __future__ import annotations

import numpy as np

EMPTY = np.uint32(0xFFFFFFFF)


def _mix32_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x7FEB352D)
    x ^= x >> np.uint32(15)
    x *= np.uint32(0x846CA68B)
    x ^= x >> np.uint32(16)
    return x


def hash_u32_np(lo, hi, locus=None) -> np.ndarray:
    h = _mix32_np(np.asarray(hi, np.uint32))
    if locus is not None:
        h = _mix32_np(h ^ np.asarray(locus, np.uint32))
    return _mix32_np(np.asarray(lo, np.uint32) ^ h)


def _table_size(n: int, max_load: float = 0.6) -> int:
    size = 64
    while size * max_load < n:
        size *= 2
    return size


class OATable:
    """Host-built open-addressing table; arrays are plain numpy, uploaded to
    device by the engine.  ``locus`` plane is present only for composite
    keys."""

    def __init__(self, key_lo, key_hi, locus, val, max_probes):
        self.key_lo = key_lo
        self.key_hi = key_hi
        self.locus = locus
        self.val = val
        self.max_probes = int(max_probes)
        self.size = len(key_lo)

    @property
    def nbytes(self):
        n = self.key_lo.nbytes + self.key_hi.nbytes + self.val.nbytes
        if self.locus is not None:
            n += self.locus.nbytes
        return n


def build_table(keys: np.ndarray, vals: np.ndarray,
                loci: np.ndarray | None = None,
                max_load: float = 0.6) -> OATable:
    """Vectorized linear-probe insertion (batched rounds)."""
    keys = np.asarray(keys, dtype=np.uint64)
    vals = np.asarray(vals, dtype=np.uint32)
    n = len(keys)
    size = _table_size(n, max_load)
    mask = np.uint32(size - 1)
    t_lo = np.full(size, EMPTY, dtype=np.uint32)
    t_hi = np.full(size, EMPTY, dtype=np.uint32)
    t_loc = np.full(size, EMPTY, dtype=np.uint32) if loci is not None else None
    t_val = np.zeros(size, dtype=np.uint32)

    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    loc = None if loci is None else np.asarray(loci, dtype=np.uint32)
    slot = hash_u32_np(lo, hi, loc) & mask

    pending = np.arange(n)
    probes = 0
    max_probes = 0
    while len(pending):
        probes += 1
        s = slot[pending]
        # claim: first pending writer per slot wins this round
        order = np.argsort(s, kind="stable")
        s_sorted = s[order]
        first = np.ones(len(s_sorted), dtype=bool)
        first[1:] = s_sorted[1:] != s_sorted[:-1]
        winners_sorted = order[first]
        win = pending[winners_sorted]
        s_win = s[winners_sorted]
        free = t_lo[s_win] == EMPTY
        if t_hi is not None:
            free &= t_hi[s_win] == EMPTY
        placed = win[free]
        sp = s_win[free]
        t_lo[sp] = lo[placed]
        t_hi[sp] = hi[placed]
        if t_loc is not None:
            t_loc[sp] = loc[placed]
        t_val[sp] = vals[placed]
        placed_mask = np.zeros(n, dtype=bool)
        placed_mask[placed] = True
        still = pending[~placed_mask[pending]]
        if len(still):
            slot[still] = (slot[still] + 1) & mask
        if len(placed):
            max_probes = probes
        pending = still
        assert probes <= size, "table build diverged"
    return OATable(t_lo, t_hi, t_loc, t_val, max_probes)


def lookup_np(tab: OATable, keys: np.ndarray,
              loci: np.ndarray | None = None):
    """Host-side probe (oracle for the JAX version).

    Returns (found bool[n], val u32[n])."""
    keys = np.asarray(keys, dtype=np.uint64)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    loc = None if loci is None else np.asarray(loci, dtype=np.uint32)
    mask = np.uint32(tab.size - 1)
    slot = hash_u32_np(lo, hi, loc) & mask
    found = np.zeros(len(keys), dtype=bool)
    val = np.zeros(len(keys), dtype=np.uint32)
    active = np.ones(len(keys), dtype=bool)
    for _ in range(tab.max_probes + 1):
        if not active.any():
            break
        s = slot[active]
        klo, khi = tab.key_lo[s], tab.key_hi[s]
        match = (klo == lo[active]) & (khi == hi[active])
        if tab.locus is not None:
            match &= tab.locus[s] == loc[active]
        empty = (klo == EMPTY) & (khi == EMPTY)
        idx = np.where(active)[0]
        hitidx = idx[match]
        found[hitidx] = True
        val[hitidx] = tab.val[s[match]]
        done = match | empty
        active[idx[done]] = False
        slot[idx[~done]] = (slot[idx[~done]] + 1) & mask
    return found, val


# ---------------- JAX probe ----------------

# ---------------- Bucketized multi-level table (device fast path) -------
#
# Linear probing needs a data-dependent probe loop (max displacement ~50 at
# load 0.6), which costs one device-memory gather round per probe for
# EVERY lane.  The bucketized layout instead packs ~lambda keys per 8-slot bucket
# in ONE contiguous row, so a single gather fetches all candidates;
# overflowing keys cascade into geometrically smaller levels (2-3 total).
# Lookup = one wide gather per level, fully vectorized, no loops.

BUCKET = 8


def _salted_hash_np(lo, hi, locus, salt: int):
    s = np.uint32((0x9E3779B9 * (salt + 1)) & 0xFFFFFFFF)
    h = _mix32_np(np.asarray(hi, np.uint32) ^ s)
    if locus is not None:
        h = _mix32_np(h ^ np.asarray(locus, np.uint32))
    return _mix32_np(np.asarray(lo, np.uint32) ^ h)


class BucketTable:
    """levels: list of (packed (nb, BUCKET, W) u32, salt).  Plane layout
    per slot: lo, hi, [locus if composite], val, [val2 if nval == 2] —
    W = 2 + composite + nval.  A second value plane rides in the SAME
    row, so the same row gather fetches it: the dbi table uses it to
    carry the TR/flank
    annotation of single-locus k-mers, eliminating most composite-table
    annotation probes."""

    def __init__(self, levels, composite: bool, nval: int = 1):
        self.levels = levels
        self.composite = composite
        self.nval = nval

    @property
    def nbytes(self):
        return sum(t.nbytes for t, _ in self.levels)


def build_bucket_table(keys, vals, loci=None, lam: float = 5.0,
                       max_levels: int = 8,
                       fat_threshold: int = 0,
                       vals2=None) -> BucketTable:
    """vals=None builds a membership-only table (nval=0, 2-plane rows):
    lookups return found + a zero val.  The prefilter uses this — it only
    needs membership, and the narrower row measurably speeds the gather
    at level-0 bucket density."""
    keys = np.asarray(keys, dtype=np.uint64)
    vals = None if vals is None else np.asarray(vals, dtype=np.uint32)
    composite = loci is not None
    nval = (0 if vals is None else 1) + (0 if vals2 is None else 1)
    assert not (vals is None and vals2 is not None)
    W = 2 + int(composite) + nval
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    loc = None if loci is None else np.asarray(loci, dtype=np.uint32)
    v2 = None if vals2 is None else np.asarray(vals2, dtype=np.uint32)

    # idx=None means the identity (level 0) — at 1e9+ keys the arange
    # alone is ~10 GB, and the full-scale build is RAM-bound
    idx = None
    nidx = len(keys)
    levels = []
    salt = 0
    nlevel = 0
    while nidx:
        assert salt < max_levels + 16, "bucket table cascade diverged"
        # every level costs one full-width gather per probe at lookup
        # time, so the cascade depth IS the probe cost: level 0 packs
        # dense (lam keys/bucket); later levels go sparse (<=1 key/bucket
        # expected) and search up to 16 salts for a zero-overflow layout,
        # making 2 levels the norm at any table size.
        # (fat_threshold enables a single-level lam=0.5 layout for small
        # tables: a 16x bigger table for one gather less per probe; it
        # defaults off.)
        fat = len(keys) <= fat_threshold
        if fat:
            level_lam, ntry = 0.5, 16
        else:
            level_lam = lam if nlevel == 0 else 1.0
            ntry = 1 if nlevel == 0 else 16
        nb = 64
        while nb * level_lam < nidx:
            nb *= 2

        def _at(a):
            return a if idx is None else a[idx]

        best = None
        for s in range(salt, salt + ntry):
            b = _salted_hash_np(_at(lo), _at(hi),
                                None if loc is None else _at(loc),
                                s) & np.uint32(nb - 1)
            order = np.argsort(b, kind="stable")
            b_sorted = b[order]
            del b
            # rank within bucket (frees between salts bound the search's
            # working set; at 1e9+ keys each temp is ~10 GB)
            first = np.ones(len(order), dtype=bool)
            first[1:] = b_sorted[1:] != b_sorted[:-1]
            grp = np.cumsum(first) - 1
            pos = np.arange(len(order)) - np.flatnonzero(first)[grp]
            del first, grp
            fits = pos < BUCKET
            nover = int((~fits).sum())
            if best is None or nover < best[0]:
                best = (nover, s, order, b_sorted,
                        pos.astype(np.uint8, copy=False) if nover == 0
                        else pos, fits)
            if nover == 0:
                break
        _, s, order, b_sorted, pos, fits = best
        del best
        sel = order[fits] if idx is None else idx[order[fits]]
        bb = b_sorted[fits]
        pp = pos[fits].astype(np.uint8)
        next_idx = order[~fits] if idx is None else idx[order[~fits]]
        del order, b_sorted, pos, fits
        tab = np.full((nb, BUCKET, W), EMPTY, dtype=np.uint32)
        tab[bb, pp, 0] = lo[sel]
        tab[bb, pp, 1] = hi[sel]
        if composite:
            tab[bb, pp, 2] = loc[sel]
        vp = 2 + int(composite)
        if vals is not None:
            tab[bb, pp, vp] = vals[sel]
        if v2 is not None:
            tab[bb, pp, vp + 1] = v2[sel]
        del sel, bb, pp
        # store rows FLAT (nb, BUCKET*W): one 2-D row gather per probe;
        # lookups reshape after the gather
        levels.append((tab.reshape(nb, BUCKET * W), s))
        idx = next_idx
        nidx = len(idx)
        salt = s + 1
        nlevel += 1
    return BucketTable(levels, composite, nval)


def lookup_bucket_np(tab: BucketTable, keys, loci=None):
    """Host-side probe.  Always returns (found, val, val2); val2 is a
    zeros plane when the table has no second value plane, so call-site
    arity never depends on table configuration (round-2 advice)."""
    keys = np.asarray(keys, dtype=np.uint64)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    loc = None if loci is None else np.asarray(loci, dtype=np.uint32)
    nval = getattr(tab, "nval", 1)
    W = 2 + int(tab.composite) + nval
    vp = 2 + int(tab.composite)
    found = np.zeros(len(keys), dtype=bool)
    val = np.zeros(len(keys), dtype=np.uint32)
    val2 = np.zeros(len(keys), dtype=np.uint32)
    for t, salt in tab.levels:
        nb = t.shape[0]
        b = _salted_hash_np(lo, hi, loc, salt) & np.uint32(nb - 1)
        rows = t[b].reshape(len(b), BUCKET, W)
        m = (rows[:, :, 0] == lo[:, None]) & (rows[:, :, 1] == hi[:, None])
        if tab.composite:
            m &= rows[:, :, 2] == loc[:, None]
        hit = m.any(axis=1)
        new = hit & ~found
        if nval >= 1:
            v = np.where(m, rows[:, :, vp], 0).max(axis=1)
            val[new] = v[new]
        if nval == 2:
            v2 = np.where(m, rows[:, :, vp + 1], 0).max(axis=1)
            val2[new] = v2[new]
        found |= hit
    return found, val, val2


def bucket_index_jax(q_lo, q_hi, q_loc, salt, nb):
    """Bucket index for one level (device-side twin of _salted_hash_np)."""
    import jax.numpy as jnp

    def mix32(x):
        x = x.astype(jnp.uint32)
        x = x ^ (x >> 16)
        x = x * np.uint32(0x7FEB352D)
        x = x ^ (x >> 15)
        x = x * np.uint32(0x846CA68B)
        x = x ^ (x >> 16)
        return x

    s = np.uint32((0x9E3779B9 * (salt + 1)) & 0xFFFFFFFF)
    h = mix32(q_hi ^ s)
    if q_loc is not None:
        h = mix32(h ^ q_loc.astype(jnp.uint32))
    return (mix32(q_lo ^ h) & np.uint32(nb - 1)).astype(jnp.int32)


def lookup_bucket_jax(tab: BucketTable, q_lo, q_hi, q_loc=None,
                      levels_dev=None):
    """Device probe: one gather per level (2-3 total), no loops.

    levels_dev: optional pre-uploaded [(jnp tab, salt)] to avoid re-upload.
    EMPTY-key queries never match (EMPTY slots hold EMPTY in the locus
    plane too, but a real query's (lo,hi) can't be all-ones for k<=31).
    Always returns (found, val, val2); val2 is zeros when the table has
    no second value plane, keeping call-site arity fixed.
    """
    import jax.numpy as jnp

    nval = getattr(tab, "nval", 1)
    W = 2 + int(tab.composite) + nval
    vp = 2 + int(tab.composite)
    levels = levels_dev if levels_dev is not None else [
        (jnp.asarray(t), s) for t, s in tab.levels]

    found = jnp.zeros(q_lo.shape, dtype=jnp.bool_)
    val = jnp.zeros(q_lo.shape, dtype=jnp.uint32)
    val2 = jnp.zeros(q_lo.shape, dtype=jnp.uint32)
    for t, salt in levels:
        nb = t.shape[0]
        b = bucket_index_jax(q_lo, q_hi, q_loc, salt, nb)
        rows = t[b].reshape(b.shape + (BUCKET, W))
        m = (rows[..., 0] == q_lo[..., None]) & \
            (rows[..., 1] == q_hi[..., None])
        if tab.composite:
            m &= rows[..., 2] == q_loc[..., None]
        hit = m.any(axis=-1)
        new = hit & ~found
        if nval >= 1:
            v = jnp.where(m, rows[..., vp], 0).max(axis=-1)
            val = jnp.where(new, v, val)
        if nval == 2:
            v2 = jnp.where(m, rows[..., vp + 1], 0).max(axis=-1)
            val2 = jnp.where(new, v2, val2)
        found = found | hit
    return found, val, val2


def lookup_jax(t_lo, t_hi, t_val, q_lo, q_hi, max_probes: int,
               t_loc=None, q_loc=None):
    """Vectorized device probe: returns (found bool[...], val u32[...]).

    All-lane bounded linear probing; max_probes is a static bound from the
    build.  Query shapes are arbitrary; tables are 1-D device arrays.
    """
    import jax
    import jax.numpy as jnp

    size = t_lo.shape[0]
    mask = np.uint32(size - 1)

    def mix32(x):
        x = x.astype(jnp.uint32)
        x = x ^ (x >> 16)
        x = x * np.uint32(0x7FEB352D)
        x = x ^ (x >> 15)
        x = x * np.uint32(0x846CA68B)
        x = x ^ (x >> 16)
        return x

    h = mix32(q_hi)
    if q_loc is not None:
        h = mix32(h ^ q_loc.astype(jnp.uint32))
    slot = (mix32(q_lo ^ h) & mask).astype(jnp.uint32)

    found = jnp.zeros(slot.shape, dtype=jnp.bool_)
    val = jnp.zeros(slot.shape, dtype=jnp.uint32)
    active = jnp.ones(slot.shape, dtype=jnp.bool_)

    def body(i, carry):
        slot, found, val, active = carry
        s = slot.astype(jnp.int32)
        klo = t_lo[s]
        khi = t_hi[s]
        match = (klo == q_lo) & (khi == q_hi)
        if t_loc is not None:
            match &= t_loc[s] == q_loc
        empty = (klo == EMPTY) & (khi == EMPTY)
        hit = active & match
        found = found | hit
        val = jnp.where(hit, t_val[s], val)
        active = active & ~(match | empty)
        slot = jnp.where(active, (slot + 1) & mask, slot)
        return slot, found, val, active

    slot, found, val, active = jax.lax.fori_loop(
        0, max_probes + 1, body, (slot, found, val, active)
    )
    return found, val
