"""Row-sharded hybrid plan on the virtual 8-CPU mesh (hwsim analog).

Closes VERDICT r4 gap #6: the hybrid structure split must run multi-chip
with the same single-datapath property as the reference
(src/sextans.cpp:886-983 — every matrix, one datapath)."""

import numpy as np
import pytest

from sextans_tpu.format.coo import COOMatrix
from sextans_tpu.format.csr import CSRMatrix
from sextans_tpu.ops.golden import golden_spmm_exact
from sextans_tpu.ops.hybrid import split_structure
from sextans_tpu.parallel.hybrid_sharded import ShardedHybridPlan
from sextans_tpu.parallel.sharding import make_mesh
from sextans_tpu.utils.config import SpmmConfig

CFG = SpmmConfig(tile_m=32, window_k=128, block_k=8, group_blocks=16)


def _structured(m, k, seed=0, hub_col=True, hub_row=True, diags=(0, 1, -2)):
    """Stencil diagonals + hub column + hub row + scattered residue."""
    rng = np.random.default_rng(seed)
    rows_l, cols_l = [], []
    r = np.arange(m, dtype=np.int64)
    for d in diags:
        sel = (r + d >= 0) & (r + d < k)
        rows_l.append(r[sel])
        cols_l.append(r[sel] + d)
    if hub_col:
        rows_l.append(np.arange(m, dtype=np.int64))
        cols_l.append(np.full(m, min(11, k - 1), dtype=np.int64))
    if hub_row:
        hr = min(m - 1, 2 * m // 3)
        rows_l.append(np.full(k, hr, dtype=np.int64))
        cols_l.append(np.arange(k, dtype=np.int64))
    rows_l.append(rng.integers(0, m, 1500))
    cols_l.append(rng.integers(0, k, 1500))
    lin = np.unique(np.concatenate(rows_l) * k + np.concatenate(cols_l))
    return COOMatrix(
        (m, k), (lin // k).astype(np.int32), (lin % k).astype(np.int32),
        rng.standard_normal(lin.size).astype(np.float32),
    )


def _check(split, n, n_shards, coo, backend="xla", residue_fmt=None,
           alpha=0.85, beta=-2.06):
    rng = np.random.default_rng(7)
    b = rng.standard_normal((coo.shape[1], n)).astype(np.float32)
    c = rng.standard_normal((coo.shape[0], n)).astype(np.float32)
    plan = ShardedHybridPlan(
        split, n, mesh=make_mesh(n_shards),
        residue_config=CFG, residue_fmt=residue_fmt or "vpu",
        backend=backend,
    )
    got = np.asarray(plan(b, alpha, beta, c))
    want = golden_spmm_exact(CSRMatrix.from_coo(coo), b, alpha, beta, c)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) < 1e-4
    return plan


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_sharded_hybrid_matches_golden(n_shards):
    coo = _structured(320, 320, seed=n_shards)
    split = split_structure(coo, n=32)
    assert split.diag_offsets.size > 0  # the split must be non-trivial
    _check(split, 32, n_shards, coo)


def test_sharded_hybrid_uneven_rows():
    """M not divisible by the slab grid: pad rows must stay silent."""
    coo = _structured(301, 275, seed=3)
    split = split_structure(coo, n=16)
    _check(split, 16, 4, coo)


def test_sharded_hybrid_hub_row_crosses_shards():
    """Hub rows owned by different shards (each must land exactly once)."""
    m = k = 256
    rng = np.random.default_rng(5)
    rows = np.concatenate([
        np.full(k, 10, dtype=np.int64),       # hub row on shard 0
        np.full(k, 200, dtype=np.int64),      # hub row on a later shard
        rng.integers(0, m, 2000),
    ])
    cols = np.concatenate([
        np.arange(k, dtype=np.int64),
        np.arange(k, dtype=np.int64),
        rng.integers(0, k, 2000),
    ])
    lin = np.unique(rows * k + cols)
    coo = COOMatrix((m, k), (lin // k).astype(np.int32),
                    (lin % k).astype(np.int32),
                    rng.standard_normal(lin.size).astype(np.float32))
    split = split_structure(coo, n=16, min_head_rows=2)
    assert split.head_rows.size >= 2
    _check(split, 16, 4, coo)


def test_sharded_hybrid_no_residue():
    """Pure-structure matrix: residue empty, dense parts carry everything."""
    m = k = 256
    r = np.arange(m, dtype=np.int64)
    lin = np.unique(np.concatenate([r * k + r, r * k + np.minimum(r + 1, k - 1)]))
    rng = np.random.default_rng(9)
    coo = COOMatrix((m, k), (lin // k).astype(np.int32),
                    (lin % k).astype(np.int32),
                    rng.standard_normal(lin.size).astype(np.float32))
    split = split_structure(coo)
    assert split.residue.nnz == 0
    _check(split, 16, 4, coo)


def test_sharded_hybrid_repeat_chain():
    """The in-device repeat chain composes the full hybrid step."""
    import jax.numpy as jnp

    coo = _structured(256, 256, seed=11)
    split = split_structure(coo, n=16)
    rng = np.random.default_rng(8)
    b = rng.standard_normal((256, 16)).astype(np.float32)
    c = rng.standard_normal((256, 16)).astype(np.float32)
    plan = ShardedHybridPlan(
        split, 16, mesh=make_mesh(4), residue_config=CFG,
        residue_fmt="vpu", backend="xla",
    )
    got2 = np.asarray(plan.repeat(b, 0.85, -2.06, c, times=2))
    want1 = np.asarray(plan(b, 0.85, -2.06, jnp.asarray(c)))
    want2 = np.asarray(plan(b, 0.85, -2.06, jnp.asarray(want1)))
    np.testing.assert_allclose(got2, want2, rtol=0, atol=1e-5)


def test_sharded_hybrid_shape_errors():
    coo = _structured(128, 128, seed=13)
    split = split_structure(coo, n=16)
    plan = ShardedHybridPlan(
        split, 16, mesh=make_mesh(2), residue_config=CFG,
        residue_fmt="vpu", backend="xla",
    )
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError):
        plan(rng.standard_normal((64, 16)).astype(np.float32))
    with pytest.raises(ValueError):
        plan(rng.standard_normal((128, 16)).astype(np.float32),
             0.85, -2.06, None)
