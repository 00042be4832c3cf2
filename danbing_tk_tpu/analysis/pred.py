"""Bias correction (`danbing-tk-pred` equivalent, reference src/pred.cpp +
pred.h).

Pipeline (pred.h:166-233):
  1. stack per-sample .trkmc.ar into a (nk, ns) matrix, cast f32
  2. normalize each sample by read depth; transpose -> (ns, nk)
  3. per locus: B = GT[:, ikmer_idx] / ikmer_count;
     bias = rowmean(B); bias /= mean(bias);
     GT[:, locus_block] /= bias[:, None]; Bias[:, tri] = bias
  4. write raw GT, corrected GT (binary u32 dims + f32 data) and the bias
     matrix (TSV)

The per-locus loop is a ragged-segment computation; on device it becomes a
segment-mean over the ikmer columns, summed column by column in the
reference's order (a scan over a padded index plane), so one jitted call
covers all loci and every run gives the same bits.  All arithmetic is
float32 like the reference's Eigen path; where the backend divides
IEEE-exactly (the CPU) the result equals the numpy path's bits, while
XLA's GPU division (div.full.f32) may land up to 2 ulp off per divide.

Deviation: the reference leaves Bias columns of skipped loci (no kmers or
no invariant kmers) as uninitialized memory (pred.h:218); we write 0.
The reference's Eigen submodule is absent, so the oracle compiles
pred.cpp against a minimal Eigen-compatible shim (tools/eigen_lite) and
asserts byte-identical outputs (tests/test_pred.py); spec tests pin the
zero-mean/NaN edge cases the binary leaves undefined.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..io import binary as bio

_libc = ctypes.CDLL(None)
_libc.strtof.restype = ctypes.c_float
_libc.strtof.argtypes = [ctypes.c_char_p, ctypes.c_void_p]


def _parse_f32(s: str) -> np.float32:
    """Decimal -> f32 in ONE rounding via libc strtof, matching the
    reference's stof (pred.h:46).  np.float32(s) would round via f64
    first and can land 1 ulp off at half-ulp boundaries."""
    return np.float32(_libc.strtof(s.encode(), None))


def load_gt(trkmc_paths: list[str], nk: int) -> np.ndarray:
    """-> (nk, ns) float32 from per-sample .trkmc.ar files."""
    cols = []
    for p in trkmc_paths:
        v = bio.read_karray(p)
        assert len(v) == nk, f"{p}: nk {len(v)} != {nk}"
        cols.append(v)
    return np.stack(cols, axis=1).astype(np.float32)


def norm_read_depth(gt: np.ndarray, rds) -> np.ndarray:
    """(nk, ns) / depth -> transpose (ns, nk), float32."""
    rds = np.asarray(rds, dtype=np.float32)
    return (gt / rds[None, :]).T.copy()


def bias_correction_np(gt: np.ndarray, nk_cum, nik_cum, iki, ikc):
    """Reference bias_correction in numpy f32.  Mutates gt, returns Bias
    (ns, n_tr) with zeros for skipped loci."""
    ns = gt.shape[0]
    n_tr = len(nk_cum)
    bias_mat = np.zeros((ns, n_tr), dtype=np.float32)
    for tri in range(n_tr):
        si = nk_cum[tri - 1] if tri else 0
        ei = nk_cum[tri]
        isi = nik_cum[tri - 1] if tri else 0
        iei = nik_cum[tri]
        if si == ei or isi == iei:
            continue
        ikis = iki[isi:iei]
        ikmc = ikc[isi:iei].astype(np.float32)
        B = gt[:, ikis] / ikmc[None, :]
        # strictly SEQUENTIAL f32 sums (cumsum), matching naive C++
        # accumulation (the executed-reference oracle's eigen_lite shim);
        # np.mean's pairwise blocking differs in the last ulp
        bias = np.cumsum(B, axis=1, dtype=np.float32)[:, -1] \
            / np.float32(B.shape[1])
        m = np.cumsum(bias, dtype=np.float32)[-1] / np.float32(len(bias))
        if m == 0.0:
            # no sample has any invariant-kmer coverage at this locus:
            # the reference (pred.cpp, Eigen) would divide by zero and
            # poison the locus with NaN/inf; we pin the semantics to
            # "skip" (counts untouched, bias row stays 0) instead.
            continue
        bias = bias / m
        with np.errstate(divide="ignore"):
            # a single zero-bias sample still yields inf for that
            # sample's columns, matching the reference's arithmetic
            gt[:, si:ei] = gt[:, si:ei] / bias[:, None]
        bias_mat[:, tri] = bias
    return bias_mat


def _sequential_sum(xs, init, term=lambda x: x):
    """acc = init + term(xs[0]) + term(xs[1]) + ... in exactly that order
    (f32, one rounding per add, like the reference's naive loops).  A
    scatter-add or a tree reduction would reorder the sums, and on a GPU
    a scatter-add runs in atomic order, which changes between runs."""
    import jax

    return jax.lax.scan(lambda acc, x: (acc + term(x), None), init, xs)[0]


def bias_correction_jax(gt, nk_cum, nik_cum, iki, ikc):
    """Device version: per-locus mean over invariant-kmer columns, summed
    in the same order as bias_correction_np (see the module docstring
    for the division rounding).

    gt: (ns, nk) f32.  Returns (corrected_gt, bias_mat).
    """
    import jax.numpy as jnp

    ns, nk = gt.shape
    n_tr = len(nk_cum)
    nk_cum = np.asarray(nk_cum, dtype=np.int64)
    nik_cum = np.asarray(nik_cum, dtype=np.int64)
    iki = np.asarray(iki, dtype=np.int64)
    # locus id per kmer column (host-precomputed)
    col_locus = np.searchsorted(nk_cum, np.arange(nk), side="right")
    nik_start = np.concatenate([[0], nik_cum[:-1]])
    nik_per = nik_cum - nik_start
    has_ik = (nik_per > 0) & (np.diff(np.concatenate([[0], nk_cum])) > 0)
    # (maxnik, n_tr) plane of each locus's ratio columns in order; the
    # padding points at an all-zero column (adding +0.0 is exact)
    maxnik = max(int(nik_per.max(initial=0)), 1)
    j = np.arange(maxnik)[:, None]
    cols = np.where(j < nik_per[None, :], nik_start[None, :] + j, len(iki))

    gt = jnp.asarray(gt)
    ratios = gt[:, iki] / jnp.asarray(ikc, jnp.float32)[None, :]
    ratios = jnp.concatenate([ratios, jnp.zeros((ns, 1), jnp.float32)],
                             axis=1)
    # per-sample mean ratio over each locus's invariant kmers
    rT = ratios.T                                  # (nik + 1, ns)
    sums = _sequential_sum(jnp.asarray(cols),
                           jnp.zeros((n_tr, ns), jnp.float32),
                           lambda c: rT[c]).T
    denom = jnp.asarray(np.maximum(nik_per, 1), jnp.float32)
    bias = sums / denom[None, :]                   # (ns, n_tr)
    # normalize each locus's bias vector to mean 1 over samples; a
    # zero-mean locus (no invariant coverage anywhere) is skipped
    # entirely, matching bias_correction_np's pinned semantics
    mean_bias = (_sequential_sum(bias, jnp.zeros((n_tr,), jnp.float32))
                 / jnp.float32(ns))[None, :]
    active = jnp.asarray(has_ik)[None, :] & (mean_bias != 0.0)
    bias = bias / jnp.where(active, mean_bias, 1.0)
    div = jnp.where(active[0][col_locus][None, :],
                    bias[:, col_locus], 1.0)
    corrected = gt / div
    bias_out = jnp.where(active, bias, 0.0)
    return corrected, bias_out


def run_pred(gt_meta_path: str, ikmer_meta_path: str, out_raw: str,
             out_corrected: str, out_bias: str, use_jax: bool = False):
    """Full danbing-tk-pred flow (pred.cpp:15-83)."""
    fns, rds = [], []
    with open(gt_meta_path) as f:
        for line in f:
            a, b = line.rstrip("\n").split("\t")
            fns.append(a)
            rds.append(_parse_f32(b))
    nk_cum, nik_cum, iki, ikc = bio.read_ikmer_meta(ikmer_meta_path)
    nk = int(nk_cum[-1])
    gt = load_gt(fns, nk)
    gt = norm_read_depth(gt, rds)
    bio.write_gt_matrix(out_raw, gt)
    if use_jax:
        corrected, bias = bias_correction_jax(gt, nk_cum, nik_cum, iki, ikc)
        gt = np.asarray(corrected)
        bias = np.asarray(bias)
    else:
        bias = bias_correction_np(gt, nk_cum, nik_cum, iki, ikc)
    bio.write_gt_matrix(out_corrected, gt)
    with open(out_bias, "w") as f:
        for row in bias:
            f.write("\t".join(_fmt_f32(x) for x in row) + "\n")


def _fmt_f32(x: np.float32) -> str:
    """Eigen StreamPrecision float formatting (~std::ostream << float)."""
    return f"{float(x):g}"
