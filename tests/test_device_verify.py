"""Device-side full-matrix verification (utils/device_verify.py).

The device-side twin of the reference's every-element host check
(sextans-host.cpp:262-290): f64 oracle recomputed on device in blocks,
only scalars fetched. Must agree with golden_spmm_exact and catch a
single poisoned element anywhere in C.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from sextans_tpu.format.coo import COOMatrix
from sextans_tpu.format.csr import CSRMatrix
from sextans_tpu.ops.golden import golden_spmm_exact
from sextans_tpu.utils.device_verify import device_full_check


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    m, k, n = 1000, 700, 96
    coo = COOMatrix.random(m, k, 24000, seed=1)
    csr = CSRMatrix.from_coo(coo)
    b = rng.standard_normal((k, n)).astype(np.float32)
    c = rng.standard_normal((m, n)).astype(np.float32)
    exact = golden_spmm_exact(csr, b, 0.85, -2.06, c)
    return csr, b, c, exact


def test_clean_result_near_zero_error(problem):
    csr, b, c, exact = problem
    res = device_full_check(
        jnp.asarray(exact.astype(np.float32)), csr, b, 0.85, -2.06, c,
        block_rows=256, edge_chunk=2048,
    )
    # f32 rounding of the exact result is the only error source
    assert res["max_abs_vs_f64"] < 1e-4
    assert res["blocks"] == 4  # ceil(1000 / 256) — ragged tail included
    assert res["c_max_abs"] == pytest.approx(np.abs(exact).max(), rel=1e-6)


@pytest.mark.parametrize("poison_row", [0, 777, 999])
def test_catches_single_poisoned_element(problem, poison_row):
    csr, b, c, exact = problem
    bad = exact.astype(np.float32).copy()
    bad[poison_row, 5] += np.float32(3e-3)
    res = device_full_check(
        jnp.asarray(bad), csr, b, 0.85, -2.06, c,
        block_rows=256, edge_chunk=2048,
    )
    assert res["max_abs_vs_f64"] > 2.5e-3


def test_beta_zero_and_tiny_edge_cases():
    coo = COOMatrix(
        (5, 3), np.array([2]), np.array([1]), np.array([2.0], np.float32)
    )
    csr = CSRMatrix.from_coo(coo)
    b = np.ones((3, 8), np.float32)
    want = golden_spmm_exact(csr, b, 1.0, 0.0, None)
    res = device_full_check(
        jnp.asarray(want.astype(np.float32)), csr, b, 1.0, 0.0, None,
        block_rows=4, edge_chunk=8,
    )
    assert res["max_abs_vs_f64"] == 0.0
    assert res["c_max_abs"] == 2.0


def test_shape_mismatch_rejected(problem):
    csr, b, c, _ = problem
    with pytest.raises(ValueError, match="got_dev must be"):
        device_full_check(jnp.zeros((10, 10)), csr, b, 1.0, 0.0, None)
