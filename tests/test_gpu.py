"""Tests that need an NVIDIA GPU (marker `gpu`; they skip elsewhere).
Run on a GPU host with:  JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import os

import numpy as np
import pytest

from danbing_tk_tpu.engine.host_align import AlignConfig, RPGG


@pytest.mark.gpu
def test_funnel_counts_equal_golden_on_gpu(golden_dir):
    from danbing_tk_tpu.engine.align_runner import DeviceAlignRunner
    from danbing_tk_tpu.io.binary import read_karray

    cfg = AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1, okam=False)
    run = DeviceAlignRunner(RPGG(os.path.join(golden_dir, "pan")), cfg,
                            batch_pairs=1024, max_read_len=192,
                            expand_cap=128, retry_expand=512)
    run.run_file_native(os.path.join(golden_dir, "reads.fa"),
                        prefilter=True)
    gold = read_karray(os.path.join(golden_dir, "out.trkmc.ar"))
    np.testing.assert_array_equal(run.flat_counts(), gold)


@pytest.mark.gpu
def test_expand_gather_full_batch_on_gpu():
    import jax.numpy as jnp

    from danbing_tk_tpu.engine import device_align as da

    P, W, E = 4096, 280, 768
    rng = np.random.default_rng(0)
    nm = np.where(rng.random((P, W)) < 0.08, rng.integers(1, 33, (P, W)), 0)
    csum = np.cumsum(nm, axis=1).astype(np.int32)
    v = rng.integers(0, 2 ** 32, (P, W), dtype=np.uint32)
    got, = da._expand_gather([jnp.asarray(v)], jnp.asarray(csum), E)
    ref, = da.expand_gather_np([v], csum, E)
    np.testing.assert_array_equal(np.asarray(got), ref)
