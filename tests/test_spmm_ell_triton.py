"""Pallas/Triton ELL kernel (ops/spmm_ell_triton.py) in interpret mode
against the XLA ELL engine and the float64 oracle: hub-row folds, C at M
rows and at the padded row count, N not a power of two and wider than one
N tile, beta=0 without C, and pad slots under non-finite B."""

import jax.numpy as jnp
import numpy as np
import pytest

from sextans_tpu.format.coo import COOMatrix
from sextans_tpu.format.csr import CSRMatrix
from sextans_tpu.format.pack_ell import pack_ell
from sextans_tpu.ops.golden import golden_spmm_exact
from sextans_tpu.ops.spmm_ell_triton import ell_blocks, spmm_ell_triton
from sextans_tpu.ops.spmm_ell_xla import spmm_ell_padded
from sextans_tpu.utils.config import SpmmConfig
from sextans_tpu.utils.verify import verify

ALPHA, BETA = 0.85, -2.06


def _hub_matrix(m=150, k=170, seed=10):
    """Random rows plus one row of degree 120, which spills into virtual
    rows at R=4."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([np.full(120, 3), rng.integers(0, m, 900)])
    cols = rng.integers(0, k, rows.size)
    lin = np.unique(rows.astype(np.int64) * k + cols)
    return COOMatrix((m, k), lin // k, lin % k,
                     rng.standard_normal(lin.size).astype(np.float32))


def _engines(p, b, c, *, with_c=True, alpha=ALPHA, beta=BETA):
    args = (jnp.asarray(p.vals), jnp.asarray(p.cols),
            jnp.asarray(p.fold_rows), jnp.asarray(b), jnp.asarray(c),
            jnp.float32(alpha), jnp.float32(beta))
    kw = dict(m_base=p.m_base, with_c=with_c)
    tri = np.asarray(spmm_ell_triton(*args, interpret=True, **kw))
    xla = np.asarray(spmm_ell_padded(*args, **kw))
    return tri, xla


@pytest.mark.parametrize("n", [16, 37, 128, 200])
def test_triton_ell_matches_oracle_and_xla(n):
    coo = _hub_matrix()
    p = pack_ell(coo, SpmmConfig(tile_m=32), slots_per_row=4)
    assert p.n_virt > 0
    rng = np.random.default_rng(n)
    b = rng.standard_normal((coo.shape[1], n)).astype(np.float32)
    c = rng.standard_normal((coo.shape[0], n)).astype(np.float32)
    tri, xla = _engines(p, b, c)
    assert tri.shape == (coo.shape[0], n)
    want = golden_spmm_exact(CSRMatrix.from_coo(coo), b, ALPHA, BETA, c)
    assert verify(want, tri).passed
    assert np.abs(tri - want).max() < 1e-4
    np.testing.assert_allclose(tri, xla, rtol=1e-5, atol=1e-5)


def test_triton_ell_c_at_padded_rows():
    """C at m_padded rows (the sharded and served callers): the first M
    rows are the product, the rest are scratch."""
    coo = _hub_matrix(m=97, k=60, seed=3)
    p = pack_ell(coo, SpmmConfig(tile_m=64), slots_per_row=4)
    assert p.m_padded > 97
    rng = np.random.default_rng(4)
    b = rng.standard_normal((60, 24)).astype(np.float32)
    c = np.zeros((p.m_padded, 24), np.float32)
    c[:97] = rng.standard_normal((97, 24))
    tri, xla = _engines(p, b, c)
    assert tri.shape == (p.m_padded, 24)
    want = golden_spmm_exact(CSRMatrix.from_coo(coo), b, ALPHA, BETA, c[:97])
    assert verify(want, tri[:97]).passed
    np.testing.assert_allclose(tri[:97], xla[:97], rtol=1e-5, atol=1e-5)


def test_triton_ell_beta_zero_without_c():
    coo = _hub_matrix(seed=5)
    p = pack_ell(coo, SpmmConfig(tile_m=32), slots_per_row=4)
    rng = np.random.default_rng(6)
    b = rng.standard_normal((coo.shape[1], 20)).astype(np.float32)
    # C only gives the row count; its values must not be read
    c = np.full((coo.shape[0], 20), np.nan, np.float32)
    tri, xla = _engines(p, b, c, with_c=False, alpha=1.5, beta=0.0)
    want = golden_spmm_exact(CSRMatrix.from_coo(coo), b, 1.5, 0.0, None)
    assert np.isfinite(tri).all()
    assert verify(want, tri).passed
    np.testing.assert_allclose(tri, xla, rtol=1e-5, atol=1e-5)


def test_triton_ell_pad_slots_skip_nonfinite_b():
    """Pad slots (value 0, column 0) load nothing: a NaN row 0 of B reaches
    only the rows that really use column 0."""
    coo = COOMatrix.random(64, 96, 200, seed=6)
    rng = np.random.default_rng(7)
    b = rng.standard_normal((96, 16)).astype(np.float32)
    b[0, :] = np.nan
    p = pack_ell(coo, SpmmConfig(tile_m=32), slots_per_row=8)
    c = np.zeros((64, 16), np.float32)
    tri, _ = _engines(p, b, c, with_c=False, alpha=1.0, beta=0.0)
    uses_col0 = np.zeros(64, bool)
    uses_col0[coo.rows[coo.cols == 0]] = True
    assert np.isfinite(tri[~uses_col0]).all()
    want = golden_spmm_exact(CSRMatrix.from_coo(coo), b, 1.0, 0.0, None)
    np.testing.assert_allclose(tri[~uses_col0], want[~uses_col0],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [1, 16, 100, 128, 512])
def test_ell_blocks_are_powers_of_two(n):
    block_m, block_n = ell_blocks(n)
    assert block_n & (block_n - 1) == 0 and block_n <= 128
    assert block_n >= min(n, 128)
    assert block_m & (block_m - 1) == 0 and 16 <= block_m <= 256
