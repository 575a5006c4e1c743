"""ELL gather engine (ops/spmm_ell_xla.py) through SpmmPlan vs the oracle.

Covers N below, at and above 128 (including N not a power of two), odd K,
hub-row splits and folds, beta=0 without C, the repeat chain, empty rows and
pad slots under non-finite B.
"""

import numpy as np
import pytest

from sextans_tpu.format.coo import COOMatrix
from sextans_tpu.format.csr import CSRMatrix
from sextans_tpu.format.pack_ell import pack_ell
from sextans_tpu.ops.golden import golden_spmm_exact
from sextans_tpu.ops.plan import SpmmPlan
from sextans_tpu.utils.config import SpmmConfig
from sextans_tpu.utils.verify import verify

CFG = SpmmConfig(tile_m=64)
BACKEND = "ell"


def _run(coo, n, cfg=CFG, alpha=0.85, beta=-2.06, c=None, seed=0, **pk):
    rng = np.random.default_rng(seed)
    m, k = coo.shape
    b = rng.standard_normal((k, n)).astype(np.float32)
    if beta != 0.0 and c is None:
        c = rng.standard_normal((m, n)).astype(np.float32)
    packed = pack_ell(coo, cfg, **pk)
    plan = SpmmPlan(packed, n, backend=BACKEND)
    got = np.asarray(plan(b, alpha, beta, c))
    want = golden_spmm_exact(CSRMatrix.from_coo(coo), b, alpha, beta, c)
    return got, want, packed


@pytest.mark.parametrize("n", [16, 96, 128, 200])
def test_ell_pallas_matches_golden(n):
    coo = COOMatrix.random(500, 700, 4000, seed=1)
    got, want, _ = _run(coo, n)
    assert got.shape == want.shape == (500, n)
    res = verify(want, got)
    assert res.passed, res


def test_ell_pallas_k_not_chunk_aligned():
    # an odd K: B is gathered whole, with no K padding or windowing
    coo = COOMatrix.random(300, 515, 2500, seed=2)
    got, want, _ = _run(coo, 64)
    assert verify(want, got).passed


def test_ell_pallas_hub_rows_split_and_fold():
    rng = np.random.default_rng(3)
    m, k = 128, 600
    hub_cols = rng.choice(k, 500, replace=False)
    rows = np.concatenate([np.full(500, 7), rng.integers(0, m, 300)])
    cols = np.concatenate([hub_cols, rng.integers(0, k, 300)])
    vals = rng.standard_normal(rows.size).astype(np.float32)
    coo = COOMatrix((m, k), rows, cols, vals)
    packed = pack_ell(coo, CFG, slots_per_row=4)
    assert packed.n_virt >= 500 // 4 - 1
    got, want, _ = _run(coo, 32, slots_per_row=4)
    res = verify(want, got)
    assert res.passed, res


def test_ell_pallas_beta_zero_fast_path_and_repeat():
    coo = COOMatrix.random(200, 300, 1500, seed=4)
    rng = np.random.default_rng(5)
    b = rng.standard_normal((300, 24)).astype(np.float32)
    packed = pack_ell(coo, CFG)
    plan = SpmmPlan(packed, 24, backend=BACKEND)
    got = np.asarray(plan(b, 1.5))
    want = golden_spmm_exact(CSRMatrix.from_coo(coo), b, 1.5, 0.0, None)
    assert verify(want, got).passed
    c0 = rng.standard_normal((200, 24)).astype(np.float32)
    got2 = np.asarray(plan.repeat(b, 0.5, 0.25, c0, times=3))
    want2 = c0
    for _ in range(3):
        want2 = golden_spmm_exact(
            CSRMatrix.from_coo(coo), b, 0.5, 0.25, want2
        ).astype(np.float32)
    assert verify(want2, got2).passed


def test_ell_pallas_empty_rows_exact_zero():
    rows = np.array([5], dtype=np.int64)
    cols = np.array([1], dtype=np.int64)
    vals = np.array([2.5], dtype=np.float32)
    coo = COOMatrix((10, 4), rows, cols, vals)
    packed = pack_ell(coo, SpmmConfig(tile_m=8))
    plan = SpmmPlan(packed, 8, backend=BACKEND)
    got = np.asarray(plan(np.ones((4, 8), np.float32), 2.0, 0.0))
    assert got[5] == pytest.approx(5.0)
    mask = np.ones(10, bool)
    mask[5] = False
    np.testing.assert_array_equal(got[mask], 0.0)


def test_ell_pallas_nonfinite_b_pad_immunity():
    # pad slots (value 0, column 0) load nothing — non-finite values in B
    # must not leak into rows through their pads
    coo = COOMatrix.random(64, 96, 200, seed=6)
    rng = np.random.default_rng(7)
    b = rng.standard_normal((96, 16)).astype(np.float32)
    b[0, :] = np.nan  # chunk 0 is the pad-fetch target
    b[50, :] = np.inf
    referenced = np.unique(coo.cols)
    packed = pack_ell(coo, CFG, slots_per_row=8)
    plan = SpmmPlan(packed, 16, backend=BACKEND)
    got = np.asarray(plan(b, 1.0, 0.0))
    want = golden_spmm_exact(CSRMatrix.from_coo(coo), b, 1.0, 0.0, None)
    # rows whose edges avoid the poisoned B rows must be finite and exact
    clean = np.ones(64, bool)
    for rr, cc in zip(coo.rows, coo.cols):
        if cc in (0, 50):
            clean[rr] = False
    assert np.isfinite(got[clean]).all()
    np.testing.assert_allclose(got[clean], want[clean], rtol=1e-5, atol=1e-5)
    del referenced


def test_ell_pallas_wide_n_panel_loop():
    # n > 1024: nine 128-column tiles, the last one partial
    coo = COOMatrix.random(96, 128, 600, seed=8)
    got, want, _ = _run(coo, 1100, cfg=SpmmConfig(tile_m=32), beta=0.0)
    assert got.shape == (96, 1100)
    assert verify(want, got).passed


def test_ell_pallas_chooser_engine_models():
    from sextans_tpu.utils.autotune import choose_config_ell

    coo = COOMatrix.random(4096, 4096, 16384, seed=9)
    res = choose_config_ell(coo, n=64, top=2)
    assert res and all(t.fmt == "ell" for t in res)
    assert all(t.config.ell_r is not None for t in res)
    # the byte model grows with slot count: a degree-1 matrix at the same
    # m must cost less
    rows = np.arange(4096, dtype=np.int64)
    thin = COOMatrix((4096, 4096), rows, rows, np.ones(4096, np.float32))
    res_thin = choose_config_ell(thin, n=64, top=1)
    assert res_thin[0].predicted_cost < res[0].predicted_cost
    # end-to-end on the chosen config
    got, want, _ = _run(coo, 64, cfg=res[0].config, beta=0.0)
    assert verify(want, got).passed


@pytest.mark.parametrize("n,with_c", [(37, True), (37, False), (128, False)])
def test_ell_engine_direct_with_and_without_c(n, with_c):
    """The engine called directly on padded operands, hub folds included,
    with and without the C stream, against the oracle."""
    import jax.numpy as jnp

    from sextans_tpu.ops.spmm_ell_xla import spmm_ell_padded

    rng = np.random.default_rng(10)
    m, k = 150, 170
    rows = np.concatenate([np.full(120, 3), rng.integers(0, m, 900)])
    cols = rng.integers(0, k, rows.size)
    lin = np.unique(rows.astype(np.int64) * k + cols)
    coo = COOMatrix((m, k), lin // k, lin % k,
                    rng.standard_normal(lin.size).astype(np.float32))
    p = pack_ell(coo, SpmmConfig(tile_m=32), slots_per_row=4)
    assert p.n_virt > 0
    b = rng.standard_normal((k, n)).astype(np.float32)
    c = np.zeros((p.m_padded, n), np.float32)
    c[:m] = rng.standard_normal((m, n))
    got = np.asarray(spmm_ell_padded(
        jnp.asarray(p.vals), jnp.asarray(p.cols), jnp.asarray(p.fold_rows),
        jnp.asarray(b), jnp.asarray(c), jnp.float32(0.85),
        jnp.float32(-2.06), m_base=p.m_base, with_c=with_c))[:m]
    want = golden_spmm_exact(CSRMatrix.from_coo(coo), b, 0.85,
                             -2.06 if with_c else 0.0,
                             c[:m] if with_c else None)
    assert verify(want, got).passed
    assert np.abs(got - want).max() < 1e-4
