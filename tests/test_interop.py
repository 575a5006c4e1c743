"""Interop surface: scipy.sparse / jax BCOO / dense arrays in and out.

The switch-over path for users arriving from other sparse stacks: any of
these containers must flow through ``sx.prepare``/``sx.spmm`` and match the
golden oracle (the reference accepts only .mtx files — this is a superset,
src/sextans-host.cpp:33-48).
"""

import numpy as np
import pytest

import sextans_tpu as sx
from sextans_tpu.format.coo import COOMatrix
from sextans_tpu.format.csr import CSRMatrix
from sextans_tpu.ops.golden import golden_spmm_exact


@pytest.fixture(scope="module")
def problem():
    coo = COOMatrix.random(300, 250, 4000, seed=5)
    rng = np.random.default_rng(1)
    b = rng.standard_normal((250, 24)).astype(np.float32)
    c = rng.standard_normal((300, 24)).astype(np.float32)
    want = golden_spmm_exact(CSRMatrix.from_coo(coo), b, 0.85, -2.06, c)
    return coo, b, c, want


def _run(a, b, c):
    return np.asarray(
        sx.spmm(a, b, 0.85, -2.06, c, backend="auto")
    )


def test_scipy_round_trip(problem):
    coo, b, c, want = problem
    sp = pytest.importorskip("scipy.sparse")
    s = coo.to_scipy()
    assert isinstance(s, sp.coo_matrix)
    back = COOMatrix.from_scipy(s.tocsr())
    assert back.sorted_by_row().vals == pytest.approx(
        coo.sorted_by_row().vals
    )
    got = _run(s.tocsr(), b, c)
    assert np.abs(got - want).max() < 1e-4


def test_scipy_duplicates_summed():
    sp = pytest.importorskip("scipy.sparse")
    s = sp.coo_matrix(
        (np.float32([1.5, 2.5, 3.0]), ([0, 0, 1], [2, 2, 0])), shape=(2, 4)
    )
    coo = COOMatrix.from_scipy(s)
    dense = coo.to_dense()
    assert dense[0, 2] == 4.0 and dense[1, 0] == 3.0 and coo.nnz == 2


def test_bcoo_round_trip(problem):
    coo, b, c, want = problem
    bcoo = coo.to_bcoo()
    back = COOMatrix.from_bcoo(bcoo)
    np.testing.assert_array_equal(
        back.to_dense(), coo.to_dense()
    )
    got = _run(bcoo, b, c)
    assert np.abs(got - want).max() < 1e-4


def test_bcoo_duplicates_and_padding():
    from jax.experimental import sparse as jsparse
    import jax.numpy as jnp

    # duplicate coordinate + an out-of-range padding coordinate (rows == m)
    indices = jnp.array([[0, 1], [0, 1], [2, 3], [3, 0]], dtype=jnp.int32)
    data = jnp.float32([1.0, 2.0, 5.0, 99.0])
    bcoo = jsparse.BCOO((data, indices), shape=(3, 4))
    coo = COOMatrix.from_bcoo(bcoo)
    dense = coo.to_dense()
    assert dense[0, 1] == 3.0 and dense[2, 3] == 5.0 and coo.nnz == 2


def test_bcoo_batched_rejected():
    from jax.experimental import sparse as jsparse
    import jax.numpy as jnp

    dense = jnp.zeros((2, 3, 4)).at[0, 1, 2].set(1.0)
    batched = jsparse.BCOO.fromdense(dense, n_batch=1)
    with pytest.raises(ValueError, match="unbatched"):
        COOMatrix.from_bcoo(batched)


def test_dense_input(problem):
    coo, b, c, want = problem
    got = _run(coo.to_dense(), b, c)
    assert np.abs(got - want).max() < 1e-4


def test_dense_keeps_negative_zero_drops_positive_zero():
    dense = np.zeros((2, 2), dtype=np.float32)
    dense[0, 0] = -0.0
    dense[1, 1] = 7.0
    coo = COOMatrix.from_dense(dense)
    # +0.0 dropped; -0.0 kept (bitwise-zero rule, src/sparse_helper.h:145)
    assert coo.nnz == 2
    kept = {(int(r), int(cc)) for r, cc in zip(coo.rows, coo.cols)}
    assert kept == {(0, 0), (1, 1)}


def test_unsupported_type_raises():
    with pytest.raises(TypeError, match="unsupported"):
        sx.prepare("not a matrix")
