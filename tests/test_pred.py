"""Bias correction spec tests: numpy mirror vs hand computation, JAX vs
numpy, full-flow IO round trip using golden .trkmc.ar files."""

import os

import numpy as np
import pytest

from danbing_tk_tpu.analysis import pred
from danbing_tk_tpu.io import binary as bio


def _toy():
    # 3 loci: nk per locus = [3, 2, 4]; ikmers: locus0 -> kmers 0,2 (kc 2,1)
    # locus1 -> none; locus2 -> kmer 5 (kc 3)
    nk_cum = np.array([3, 5, 9], dtype=np.uint32)
    nik_cum = np.array([2, 2, 3], dtype=np.uint32)
    iki = np.array([0, 2, 5], dtype=np.uint32)
    ikc = np.array([2, 1, 3], dtype=np.uint8)
    gt = np.arange(2 * 9, dtype=np.float32).reshape(2, 9) + 1.0
    return nk_cum, nik_cum, iki, ikc, gt


def test_bias_correction_hand_checked():
    nk_cum, nik_cum, iki, ikc, gt = _toy()
    g = gt.copy()
    bias = pred.bias_correction_np(g, nk_cum, nik_cum, iki, ikc)
    # locus0 sample0: B = [1/2, 3/1] -> mean 1.75 ; sample1: [10/2, 12/1]
    # -> mean 8.5 ; bias mean = 5.125 -> [0.341463, 1.658537]
    b0 = np.array([1.75, 8.5], dtype=np.float32)
    b0 = b0 / b0.mean()
    np.testing.assert_allclose(bias[:, 0], b0, rtol=1e-6)
    np.testing.assert_allclose(g[:, :3], gt[:, :3] / b0[:, None], rtol=1e-6)
    # locus1: skipped (no ikmers) -> untouched, bias 0
    assert (bias[:, 1] == 0).all()
    np.testing.assert_array_equal(g[:, 3:5], gt[:, 3:5])
    # locus2
    b2 = np.array([(6 / 3), (15 / 3)], dtype=np.float32)
    b2 = b2 / b2.mean()
    np.testing.assert_allclose(bias[:, 2], b2, rtol=1e-6)


def test_jax_matches_numpy():
    nk_cum, nik_cum, iki, ikc, gt = _toy()
    g = gt.copy()
    bias_np = pred.bias_correction_np(g, nk_cum, nik_cum, iki, ikc)
    corr_jax, bias_jax = pred.bias_correction_jax(
        gt.copy(), nk_cum, nik_cum, iki, ikc)
    np.testing.assert_allclose(np.asarray(corr_jax), g, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(bias_jax), bias_np, rtol=1e-5)


SAMPLES = (("out.trkmc.ar", "30.0"), ("out.sim.trkmc.ar", "28.5"),
           ("out.fq.trkmc.ar", "31.7"), ("out.bait.trkmc.ar", "29.3"))


def _write_fixture(golden_dir, tmp_path, stride=0, nsamples=2):
    """gt.meta / ikmer.meta over golden genotypes used as samples;
    returns the number of kmer columns.  Invariant kmers: the first of
    each locus with count 2, or with ``stride`` every stride-th kmer of
    each locus with counts 1-3 (many terms per locus sum)."""
    from danbing_tk_tpu.apps.ktools import ksi

    nk_cum = np.array(ksi(os.path.join(golden_dir, "pan.tr.kmers")),
                      dtype=np.uint32)
    iki, nik, ikc = [], [], []
    prev = 0
    for c in nk_cum:
        if c > prev:
            cols = range(prev, c, stride) if stride else [prev]
            iki.extend(cols)
            ikc.extend((i % 3) + 1 if stride else 2 for i in cols)
        nik.append(len(iki))
        prev = c
    bio.write_ikmer_meta(tmp_path / "ikmer.meta", nk_cum,
                         np.array(nik, np.uint32),
                         np.array(iki, np.uint32),
                         np.array(ikc, np.uint8))
    with open(tmp_path / "gt.meta", "w") as f:
        for name, depth in SAMPLES[:nsamples]:
            f.write(f"{golden_dir}/{name}\t{depth}\n")
    return int(nk_cum[-1])


def test_full_flow_io(golden_dir, tmp_path):
    # use the golden genotype twice as two "samples"
    flat = bio.read_karray(os.path.join(golden_dir, "out.trkmc.ar"))
    nk = _write_fixture(golden_dir, tmp_path)
    assert nk == len(flat)
    pred.run_pred(str(tmp_path / "gt.meta"), str(tmp_path / "ikmer.meta"),
                  str(tmp_path / "raw.gt"), str(tmp_path / "corr.gt"),
                  str(tmp_path / "bias.tsv"))
    raw = bio.read_gt_matrix(str(tmp_path / "raw.gt"))
    corr = bio.read_gt_matrix(str(tmp_path / "corr.gt"))
    assert raw.shape == (2, nk) and corr.shape == (2, nk)
    np.testing.assert_allclose(raw[0], flat.astype(np.float32) / 30.0)
    # jax path agrees
    pred.run_pred(str(tmp_path / "gt.meta"), str(tmp_path / "ikmer.meta"),
                  str(tmp_path / "raw2.gt"), str(tmp_path / "corr2.gt"),
                  str(tmp_path / "bias2.tsv"), use_jax=True)
    corr2 = bio.read_gt_matrix(str(tmp_path / "corr2.gt"))
    np.testing.assert_allclose(corr2, corr, rtol=2e-5)


def test_zero_mean_bias_locus_skipped():
    """A locus whose invariant-kmer coverage is zero in EVERY sample is
    skipped (counts untouched, bias row 0) instead of poisoning the
    matrix with NaN/inf — pinned divergence from the reference's Eigen
    divide-by-zero; numpy and JAX paths agree and neither warns."""
    nk_cum, nik_cum, iki, ikc, gt = _toy()
    gt = gt.copy()
    gt[:, [0, 2]] = 0.0  # locus0's invariant kmers: zero everywhere
    g = gt.copy()
    with np.errstate(invalid="raise", divide="raise"):
        bias = pred.bias_correction_np(g, nk_cum, nik_cum, iki, ikc)
    assert (bias[:, 0] == 0).all()
    np.testing.assert_array_equal(g[:, :3], gt[:, :3])
    assert np.isfinite(g).all()
    corr_jax, bias_jax = pred.bias_correction_jax(
        gt.copy(), nk_cum, nik_cum, iki, ikc)
    np.testing.assert_allclose(np.asarray(corr_jax), g, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(bias_jax), bias, rtol=1e-5)


def test_jax_bits_equal_numpy(golden_dir, tmp_path):
    """The device path sums in the numpy path's order, so the corrected
    matrix and the printed bias table are byte-identical."""
    _write_fixture(golden_dir, tmp_path, stride=3, nsamples=4)
    for tag, use_jax in (("np", False), ("jax", True)):
        pred.run_pred(str(tmp_path / "gt.meta"),
                      str(tmp_path / "ikmer.meta"),
                      str(tmp_path / f"raw.{tag}"),
                      str(tmp_path / f"corr.{tag}"),
                      str(tmp_path / f"bias.{tag}"), use_jax=use_jax)
    for name in ("raw", "corr", "bias"):
        assert (tmp_path / f"{name}.jax").read_bytes() == \
            (tmp_path / f"{name}.np").read_bytes(), name
