"""The step's in-row gathers and scatter at the real widths of the
production shapes (160-wide read rows: W = 2 x 140 k-mer windows,
E = 768 expansion slots, W + E event slots) against numpy references."""

import numpy as np
import pytest

import jax.numpy as jnp

from danbing_tk_tpu.engine import device_align as da
from danbing_tk_tpu.ops import kmers_np as K

NKW, E = 140, 768
W = 2 * NKW
EV = W + E
P = 24


def _expansion(rng, case):
    """(P, W) per-position expansion counts for one test case."""
    nm = np.where(rng.random((P, W)) < 0.08, rng.integers(1, 33, (P, W)), 0)
    if case == "empty_rows":
        nm[::2] = 0                    # rows with no expansion at all
    elif case == "overflow":
        nm *= 5                        # totals far past E
    return np.cumsum(nm, axis=1).astype(np.int32)


@pytest.mark.parametrize("case", ["mixed", "empty_rows", "overflow"])
@pytest.mark.parametrize("bits", [16, 32])
def test_expand_gather_matches_numpy(case, bits):
    rng = np.random.default_rng(bits + len(case))
    csum = _expansion(rng, case)
    if bits == 32:
        vals = [rng.integers(0, 2 ** 32, (P, W), dtype=np.uint32),
                rng.integers(0, 2 ** 31, (P, W), dtype=np.uint32)]
    else:
        vals = [rng.integers(0, 2 ** 16, (P, W)).astype(np.int32),
                rng.integers(0, 2 ** 8, (P, W)).astype(np.int32)]
    got = da._expand_gather([jnp.asarray(v) for v in vals],
                            jnp.asarray(csum), E)
    ref = da.expand_gather_np(vals, csum, E)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(g), r)
    if case == "empty_rows":
        assert not np.asarray(got[0])[::2].any()


def test_expand_gather_np_is_a_plain_repeat():
    """The reference itself on a hand-checked row: positions 1 and 3
    expand into 2 and 3 slots."""
    csum = np.array([[0, 2, 2, 5]], np.int32)
    v = np.array([[7, 8, 9, 10]], np.int32)
    out, = da.expand_gather_np([v], csum, 6)
    np.testing.assert_array_equal(out, [[8, 8, 10, 10, 10, 0]])


def test_row_gather_census_width():
    rng = np.random.default_rng(1)
    ccum = np.cumsum(rng.integers(0, 2, (P, EV + 1)), 1).astype(np.int32)
    idx = rng.integers(0, EV + 1, (P, EV)).astype(np.int32)
    got, = da._row_gather([jnp.asarray(ccum)], jnp.asarray(idx))
    np.testing.assert_array_equal(np.asarray(got),
                                  np.take_along_axis(ccum, idx, 1))


def test_row_scatter_bool_permutation():
    rng = np.random.default_rng(2)
    perm = np.argsort(rng.random((P, EV)), axis=1).astype(np.int32)
    mask = rng.random((P, EV)) < 0.3
    want = np.zeros((P, EV), bool)
    np.put_along_axis(want, perm, mask, 1)
    got = da._row_scatter_bool(jnp.asarray(mask), jnp.asarray(perm), EV)
    np.testing.assert_array_equal(np.asarray(got), want)


def test_prefilter_sample_matches_host_sampler():
    """Device sampling of the nf subfilter queries (160-wide rows) equals
    the host sampler, including N bases and short reads."""
    rng = np.random.default_rng(3)
    k, nf, L = 21, 4, 160
    codes = rng.integers(0, 4, (2 * P, L)).astype(np.uint8)
    rlen = rng.integers(0, L + 1, 2 * P).astype(np.int32)
    codes[rng.random((2 * P, L)) < 0.03] = 255
    for i in range(2 * P):
        codes[i, rlen[i]:] = 255
    qlo, qhi, valid, nk = da.prefilter_sample(
        jnp.asarray(codes), jnp.asarray(rlen), k, nf, L)
    hlo, hhi, hvalid, _ = K.sample_subfilter_queries(codes, rlen, k, nf)
    np.testing.assert_array_equal(np.asarray(valid), hvalid)
    np.testing.assert_array_equal(np.asarray(qlo), hlo)
    np.testing.assert_array_equal(np.asarray(qhi), hhi)
