"""Hybrid structure-split SpMM: diagonals + dense head + residue."""

import numpy as np
import pytest

from sextans_tpu.format.coo import COOMatrix
from sextans_tpu.format.csr import CSRMatrix
from sextans_tpu.ops.golden import golden_spmm_exact
from sextans_tpu.ops.hybrid import HybridSpmmPlan, split_structure
from sextans_tpu.utils.config import SpmmConfig

CFG = SpmmConfig(tile_m=64, window_k=256, block_k=8, group_blocks=16)


def _check(coo, n=32, seed=0, alpha=0.85, beta=-2.06, **split_kw):
    rng = np.random.default_rng(seed)
    m, k = coo.shape
    b = rng.standard_normal((k, n)).astype(np.float32)
    c = rng.standard_normal((m, n)).astype(np.float32)
    split = split_structure(coo, **split_kw)
    assert (split.diag_nnz + split.head_nnz + split.head_row_nnz
            + split.residue.nnz) == coo.nnz
    plan = HybridSpmmPlan(split, n, residue_config=CFG, residue_fmt="vpu",
                          backend="xla")
    got = np.asarray(plan(b, alpha, beta, c))
    want = golden_spmm_exact(CSRMatrix.from_coo(coo), b, alpha, beta, c)
    err = np.abs(got - want).max()
    assert err < 5e-4, (split.summary(), err)
    return split, plan


def _stencil(m, offsets, seed=0):
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    base = np.arange(m, dtype=np.int64)
    for off in offsets:
        d = base + off
        ok = (d >= 0) & (d < m)
        rows.append(base[ok])
        cols.append(d[ok])
    rows = np.concatenate(rows).astype(np.int32)
    cols = np.concatenate(cols).astype(np.int32)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    vals[vals == 0] = 1.0
    return COOMatrix((m, m), rows, cols, vals)


def test_pure_stencil_goes_to_diagonals():
    coo = _stencil(500, (-7, -1, 0, 1, 7))
    split, _ = _check(coo)
    assert split.diag_offsets.tolist() == [-7, -1, 0, 1, 7]
    assert split.residue.nnz == 0  # all five diagonals lifted


def test_powerlaw_head_absorbs_hubs():
    rng = np.random.default_rng(3)
    m = 2000
    # 50 hub columns take most edges, the rest are scattered
    hub_cols = rng.choice(m, 50, replace=False)
    hr = rng.integers(0, m, 12000)
    hc = hub_cols[rng.integers(0, 50, 12000)]
    sr = rng.integers(0, m, 3000)
    sc = rng.integers(0, m, 3000)
    rows = np.concatenate([hr, sr]).astype(np.int32)
    cols = np.concatenate([hc, sc]).astype(np.int32)
    lin = rows.astype(np.int64) * m + cols
    _, keep = np.unique(lin, return_index=True)
    vals = rng.standard_normal(keep.size).astype(np.float32)
    vals[vals == 0] = 1.0
    coo = COOMatrix((m, m), rows[keep], cols[keep], vals)
    split, _ = _check(coo, head_min_degree_frac=0.02, min_head_cols=8)
    assert split.head_cols.size >= 50
    assert split.head_nnz > 0.5 * coo.nnz


def test_mixed_structure_and_epilogue():
    # diagonal + hubs + random residue, beta=0 path too
    coo_d = _stencil(600, (0, 3))
    rng = np.random.default_rng(5)
    extra_r = rng.integers(0, 600, 2000).astype(np.int32)
    extra_c = rng.integers(0, 600, 2000).astype(np.int32)
    hub_r = rng.integers(0, 600, 3000).astype(np.int32)
    hub_c = np.full(3000, 17, dtype=np.int32)
    rows = np.concatenate([coo_d.rows, extra_r, hub_r])
    cols = np.concatenate([coo_d.cols, extra_c, hub_c])
    lin = rows.astype(np.int64) * 600 + cols
    _, keep = np.unique(lin, return_index=True)
    vals = rng.standard_normal(keep.size).astype(np.float32)
    vals[vals == 0] = 1.0
    coo = COOMatrix((600, 600), rows[keep], cols[keep], vals)
    split, plan = _check(coo, min_head_cols=1)
    assert split.diag_offsets.size >= 2
    assert split.residue.nnz > 0
    # beta=0, no C
    rng = np.random.default_rng(6)
    b = rng.standard_normal((600, 32)).astype(np.float32)
    got = np.asarray(plan(b, 1.5, 0.0, None))
    want = golden_spmm_exact(CSRMatrix.from_coo(coo), b, 1.5, 0.0, None)
    assert np.abs(got - want).max() < 5e-4


def test_nonsquare_diagonals():
    m, k = 300, 500
    base = np.arange(m, dtype=np.int64)
    rows = np.concatenate([base, base]).astype(np.int32)
    cols = np.concatenate([base + 150, base + 10]).astype(np.int32)
    vals = np.ones(rows.size, dtype=np.float32)
    coo = COOMatrix((m, k), rows, cols, vals)
    split, _ = _check(coo)
    assert set(split.diag_offsets.tolist()) == {10, 150}
    assert split.residue.nnz == 0


def test_hybrid_repeat_chains():
    coo = _stencil(400, (-1, 0, 1))
    rng = np.random.default_rng(8)
    b = rng.standard_normal((400, 16)).astype(np.float32)
    c = rng.standard_normal((400, 16)).astype(np.float32)
    split = split_structure(coo)
    plan = HybridSpmmPlan(split, 16, residue_config=CFG, residue_fmt="vpu",
                          backend="xla")
    one = np.asarray(plan(b, 0.5, 0.25, c))
    two = np.asarray(plan(b, 0.5, 0.25, one))
    chained = np.asarray(plan.repeat(b, 0.5, 0.25, c, times=2))
    np.testing.assert_allclose(chained, two, rtol=1e-5, atol=1e-5)


def test_head_rows_absorb_hub_rows():
    """Dense rows (circuit power nets) are lifted into a dense (R, K)
    matmul whose output scatter-adds into the R owning C rows."""
    rng = np.random.default_rng(11)
    m = 1500
    hub_rows = rng.choice(m, 12, replace=False)
    hr = np.repeat(hub_rows, 400)
    hc = rng.integers(0, m, hr.size)
    sr = rng.integers(0, m, 2000)
    sc = rng.integers(0, m, 2000)
    rows = np.concatenate([hr, sr]).astype(np.int32)
    cols = np.concatenate([hc, sc]).astype(np.int32)
    lin = rows.astype(np.int64) * m + cols
    _, keep = np.unique(lin, return_index=True)
    vals = rng.standard_normal(keep.size).astype(np.float32)
    vals[vals == 0] = 1.0
    coo = COOMatrix((m, m), rows[keep], cols[keep], vals)
    split, _ = _check(coo, min_head_rows=4, head_min_degree_frac=0.5)
    assert split.head_rows.size >= 12
    assert split.head_row_nnz > 0.5 * coo.nnz


def test_dia_pallas_kernel_path_matches():
    """The fused diagonal part (offsets on both sides of the main diagonal,
    reaching past the matrix edge) must match the oracle, single call and
    in the repeat chain."""
    coo = _stencil(700, (-70, -1, 0, 1, 3, 200))
    rng = np.random.default_rng(9)
    b = rng.standard_normal((700, 40)).astype(np.float32)
    c = rng.standard_normal((700, 40)).astype(np.float32)
    split = split_structure(coo)
    assert split.residue.nnz == 0
    want = golden_spmm_exact(CSRMatrix.from_coo(coo), b, 0.85, -2.06, c)
    plan = HybridSpmmPlan(split, 40, residue_config=CFG, residue_fmt="vpu",
                          backend="xla")
    got = np.asarray(plan(b, 0.85, -2.06, c))
    assert np.abs(got - want).max() < 5e-4
    # repeat chain through the kernel path too
    two = np.asarray(plan(b, 0.85, -2.06, got))
    chained = np.asarray(plan.repeat(b, 0.85, -2.06, c, times=2))
    np.testing.assert_allclose(chained, two, rtol=1e-5, atol=1e-4)


def test_cost_based_head_widens_when_it_pays():
    """Round-3 lever: with n given, the head threshold is the marginal
    break-even degree — on a power-law matrix this lifts MORE hub columns
    than the fixed 0.4% rule (webgraph-class: 226 -> ~600 cols)."""
    rng = np.random.default_rng(6)
    m = 20000
    pop = rng.zipf(1.8, size=m).astype(np.float64)
    pop /= pop.sum()
    rows = rng.integers(0, m, size=16 * m)
    cols = rng.choice(m, size=16 * m, p=pop)
    lin = rows.astype(np.int64) * m + cols
    _, keep = np.unique(lin, return_index=True)
    coo = COOMatrix(
        (m, m), rows[keep].astype(np.int32), cols[keep].astype(np.int32),
        np.ones(keep.size, np.float32),
    )
    fixed = split_structure(coo)
    adaptive = split_structure(coo, n=512)
    assert adaptive.head_cols.size > fixed.head_cols.size
    assert adaptive.residue.nnz < fixed.residue.nnz
    # decomposition still exact
    total = (adaptive.diag_nnz + adaptive.head_nnz + adaptive.head_row_nnz
             + adaptive.residue.nnz)
    assert total == coo.nnz


def test_cost_based_head_memory_cap():
    """1M-row matrices must not allocate multi-GB dense heads."""
    from sextans_tpu.ops.hybrid import _cost_based_degree

    # threshold scales with M: at m=1e6, n=512 the break-even degree is
    # >1000, so only true hubs lift
    assert _cost_based_degree(10**6, 512, length=10**6) > 1000
    assert _cost_based_degree(10**5, 512, length=10**5) < 200


def test_cost_based_diag_lift_circuit_band():
    """Round-3: a +-60 band of ~3%-dense diagonals (scircuit-class) lifts
    fully under the cost-based rule (a diagonal costs m*4 bytes of values;
    the B reads of all diagonals fuse into one pass); the fixed 15% rule
    leaves them to the residue."""
    rng = np.random.default_rng(9)
    m = 20000
    diag = np.arange(m, dtype=np.int64)
    lr = rng.integers(0, m, m * 4)
    lc = np.clip(lr + rng.integers(-60, 61, m * 4), 0, m - 1)
    rows = np.concatenate([diag, lr])
    cols = np.concatenate([diag, lc])
    lin = rows * m + cols
    _, keep = np.unique(lin, return_index=True)
    coo = COOMatrix((m, m), rows[keep].astype(np.int32),
                    cols[keep].astype(np.int32),
                    np.ones(keep.size, np.float32))
    fixed = split_structure(coo)
    adaptive = split_structure(coo, n=512)
    assert fixed.diag_offsets.size <= 2  # only the main diagonal qualifies
    assert adaptive.diag_offsets.size > 100  # the whole band lifts
    assert adaptive.residue.nnz < 0.05 * coo.nnz


def test_dia_ct_kernel_matches_standard():
    """Skinny-N diagonal part (N=16, not a multiple of any tile) vs a dense
    float64 reference, with offsets past both matrix edges."""
    rng = np.random.default_rng(4)
    m, n = 160, 16
    offsets = (-70, -1, 0, 3, 65)
    coo = _stencil(m, offsets, seed=4)
    split = split_structure(coo, diag_min_density=0.0)
    assert sorted(int(o) for o in split.diag_offsets) == list(offsets)
    assert split.residue.nnz == 0
    b = rng.standard_normal((m, n)).astype(np.float32)
    c = rng.standard_normal((m, n)).astype(np.float32)
    a = np.zeros((m, m), np.float64)
    a[coo.rows, coo.cols] = coo.vals
    want = 1.3 * (a @ b.astype(np.float64)) - 0.4 * c
    plan = HybridSpmmPlan(split, n, residue_config=CFG, residue_fmt="vpu",
                          backend="xla")
    got = np.asarray(plan(b, 1.3, -0.4, c))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_hybrid_plan_uses_dia_ct_at_skinny_n():
    """End-to-end: HybridSpmmPlan on a banded matrix at N=16 (auto residue
    format and engine) matches golden."""
    import jax.numpy as jnp

    from sextans_tpu.format.csr import CSRMatrix
    from sextans_tpu.ops.golden import golden_spmm
    from sextans_tpu.ops.hybrid import HybridSpmmPlan

    rng = np.random.default_rng(11)
    m = 2000
    diag = np.arange(m, dtype=np.int64)
    lr = rng.integers(0, m, m * 3)
    lc = np.clip(lr + rng.integers(-20, 21, m * 3), 0, m - 1)
    rows = np.concatenate([diag, lr])
    cols = np.concatenate([diag, lc])
    lin = rows * m + cols
    _, keep = np.unique(lin, return_index=True)
    vals = rng.standard_normal(keep.size).astype(np.float32)
    vals[vals == 0] = 1.0
    coo = COOMatrix((m, m), rows[keep].astype(np.int32),
                    cols[keep].astype(np.int32), vals)
    s = split_structure(coo, n=16)
    assert s.diag_offsets.size > 10
    plan = HybridSpmmPlan(s, 16)
    b = rng.standard_normal((m, 16)).astype(np.float32)
    c = rng.standard_normal((m, 16)).astype(np.float32)
    got = np.asarray(plan(jnp.asarray(b), 0.85, -2.06, jnp.asarray(c)))
    want = golden_spmm(CSRMatrix.from_coo(coo), b, 0.85, -2.06, c)
    assert np.max(np.abs(got - want)) < 1e-3
