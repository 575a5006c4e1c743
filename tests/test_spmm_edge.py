"""Edge format: pack + engine vs the golden oracle.

The swsim-analog coverage (SURVEY.md §4) for the third packed format —
the structure-independent per-nonzero path (format/pack_edge.py + the edge
engine of ops/spmm_xla.py), the parity answer to the reference PEG's
arbitrary-column decode (src/sextans.cpp:388-419).
"""

import numpy as np
import pytest

from sextans_tpu.format.coo import COOMatrix
from sextans_tpu.format.csr import CSRMatrix
from sextans_tpu.format.pack_edge import PackedSpMatrixEdge, pack_edge
from sextans_tpu.ops.golden import golden_spmm_exact
from sextans_tpu.ops.plan import SpmmPlan
from sextans_tpu.utils.config import SpmmConfig
from sextans_tpu.utils.verify import verify

CFG = SpmmConfig(tile_m=256, window_k=256, edge_chunk=128)


def _run(coo, n, cfg=CFG, alpha=0.85, beta=-2.06, c=None, seed=0, **pk):
    rng = np.random.default_rng(seed)
    m, k = coo.shape
    b = rng.standard_normal((k, n)).astype(np.float32)
    if beta != 0.0 and c is None:
        c = rng.standard_normal((m, n)).astype(np.float32)
    packed = pack_edge(coo, cfg, **pk)
    plan = SpmmPlan(packed, n, backend="edge")
    got = np.asarray(plan(b, alpha, beta, c))
    want = golden_spmm_exact(CSRMatrix.from_coo(coo), b, alpha, beta, c)
    return got, want


def test_edge_matches_golden_basic():
    coo = COOMatrix.random(500, 700, 4000, seed=1)
    got, want = _run(coo, 96)
    res = verify(want, got)
    assert res.passed, res
    assert res.max_abs_err < 1e-5, res


def test_edge_scattered_powerlaw():
    """The format's home turf: scattered matrix where block fill collapses."""
    rng = np.random.default_rng(7)
    m = k = 2000
    nnz = 12000
    rows = rng.integers(0, m, nnz).astype(np.int32)
    # zipf-ish column skew
    cols = np.minimum((rng.pareto(1.2, nnz) * 10).astype(np.int64), k - 1)
    cols = cols.astype(np.int32)
    vals = rng.standard_normal(nnz).astype(np.float32)
    coo = COOMatrix((m, k), rows, cols, vals)  # duplicates get summed
    got, want = _run(coo, 128)
    res = verify(want, got)
    assert res.passed, res


def test_edge_beta_zero_no_c():
    coo = COOMatrix.random(300, 300, 2500, seed=3)
    got, want = _run(coo, 64, alpha=1.5, beta=0.0)
    assert verify(want, got).passed


def test_edge_multi_window_multi_tile():
    """Rows/cols spanning several M-tiles and K-windows; chunk smaller than
    most jobs so rows split across chunks (double-flush path)."""
    cfg = SpmmConfig(tile_m=64, window_k=64, edge_chunk=32)
    coo = COOMatrix.random(400, 500, 6000, seed=4)
    got, want = _run(coo, 96, cfg=cfg)
    res = verify(want, got)
    assert res.passed, res


def test_edge_dense_rows():
    """A few dense rows exercise long register runs within one chunk."""
    m, k = 128, 512
    rng = np.random.default_rng(5)
    rows = np.repeat(np.array([3, 50, 100], np.int32), k)
    cols = np.tile(np.arange(k, dtype=np.int32), 3)
    vals = rng.standard_normal(3 * k).astype(np.float32)
    coo = COOMatrix((m, k), rows, cols, vals)
    got, want = _run(coo, 96, cfg=SpmmConfig(tile_m=128, window_k=256,
                                             edge_chunk=64))
    assert verify(want, got).passed


def test_edge_empty_matrix():
    coo = COOMatrix((64, 64), np.empty(0, np.int32), np.empty(0, np.int32),
                    np.empty(0, np.float32))
    got, want = _run(coo, 32)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_edge_pack_stats_exact_bytes():
    coo = COOMatrix.random(500, 700, 4000, seed=1)
    p = pack_edge(coo, CFG)
    # 8 bytes per packed slot (f32 val + i32 meta), no block inflation
    assert p.stats.a_bytes == 8 * p.n_chunks * CFG.edge_chunk
    assert p.stats.bytes_per_nnz < 8 * 3  # padding ≤ 3x on this density
    assert p.stats.block_fill == p.nnz / p.stats.slots


def test_edge_pack_meta_roundtrip():
    """Decode the packed meta words back to coordinates and compare."""
    from sextans_tpu.format.pack_edge import COL_SHIFT, ROW_SHIFT

    coo = COOMatrix.random(300, 400, 3000, seed=9)
    cfg = SpmmConfig(tile_m=128, window_k=128, edge_chunk=64)
    p = pack_edge(coo, cfg)
    got = {}
    for c in range(p.n_chunks):
        mt, kw = int(p.chunk_mtile[c]), int(p.chunk_kwin[c])
        for e in range(cfg.edge_chunk):
            v = float(p.vals[c, 0, e])
            w = int(p.meta[c, 0, e])
            if v == 0.0:
                continue
            r = mt * cfg.tile_m + (w >> ROW_SHIFT)
            cc = kw * cfg.window_k + (
                (w >> COL_SHIFT) & ((1 << (ROW_SHIFT - COL_SHIFT)) - 1)
            )
            got[(r, cc)] = got.get((r, cc), 0.0) + v
    want = {}
    for r, cc, v in zip(coo.rows, coo.cols, coo.vals):
        want[(int(r), int(cc))] = want.get((int(r), int(cc)), 0.0) + float(v)
    want = {k_: v for k_, v in want.items() if v != 0.0}
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6)


def test_edge_save_load_roundtrip(tmp_path):
    coo = COOMatrix.random(300, 400, 3000, seed=11)
    cfg = SpmmConfig(tile_m=128, window_k=128, edge_chunk=64)
    p = pack_edge(coo, cfg)
    f = tmp_path / "edge.npz"
    p.save(f)
    q = PackedSpMatrixEdge.load(f)
    assert q.shape == p.shape and q.nnz == p.nnz
    assert q.config.edge_chunk == 64 and q.config.tile_m == 128
    np.testing.assert_array_equal(q.vals, p.vals)
    np.testing.assert_array_equal(q.meta, p.meta)
    np.testing.assert_array_equal(q.chunk_mtile, p.chunk_mtile)
    assert q.stats.a_bytes == p.stats.a_bytes


def test_edge_capacity_limits():
    coo = COOMatrix.random(64, 64, 100, seed=1)
    with pytest.raises(ValueError, match="tile_m"):
        pack_edge(coo, SpmmConfig(tile_m=32768, window_k=256))
    with pytest.raises(ValueError, match="window_k"):
        pack_edge(coo, SpmmConfig(tile_m=256, window_k=65536))


def test_edge_reorder_cols():
    """Degree-sorted column pack: the plan must feed B in permuted order."""
    coo = COOMatrix.random(300, 400, 3000, seed=13)
    rng = np.random.default_rng(0)
    m, k = coo.shape
    b = rng.standard_normal((k, 64)).astype(np.float32)
    c = rng.standard_normal((m, 64)).astype(np.float32)
    packed = pack_edge(coo, SpmmConfig(tile_m=128, window_k=128,
                                       edge_chunk=64), reorder_cols=True)
    assert packed.col_perm is not None
    plan = SpmmPlan(packed, 64, backend="edge")
    got = np.asarray(plan(b, 0.85, -2.06, c))
    want = golden_spmm_exact(CSRMatrix.from_coo(coo), b, 0.85, -2.06, c)
    assert verify(want, got).passed


@pytest.mark.parametrize("edge_chunk", [16, 64, 256])
def test_edge_chunk_sizes_match_golden(edge_chunk):
    """Chunk size only changes where jobs are cut: short runs, runs
    straddling chunks and tail padding give the same answer."""
    cfg = SpmmConfig(tile_m=128, window_k=128, edge_chunk=edge_chunk)
    coo = COOMatrix.random(400, 500, 6000, seed=21)
    got, want = _run(coo, 96, cfg=cfg)
    res = verify(want, got)
    assert res.passed, res


def test_edge_dense_rows_straddle_chunks():
    """Dense rows straddle several chunks: every edge still lands in its
    row."""
    m, k = 64, 1024
    rng = np.random.default_rng(6)
    rows = np.repeat(np.array([1, 2, 63], np.int32), k)
    cols = np.tile(np.arange(k, dtype=np.int32), 3)
    vals = rng.standard_normal(3 * k).astype(np.float32)
    coo = COOMatrix((m, k), rows, cols, vals)
    cfg = SpmmConfig(tile_m=64, window_k=512, edge_chunk=32)
    got, want = _run(coo, 64, cfg=cfg)
    assert verify(want, got).passed


def test_edge_pack_accounting():
    coo = COOMatrix.random(300, 400, 3000, seed=23)
    cfg = SpmmConfig(tile_m=128, window_k=128, edge_chunk=64)
    p = pack_edge(coo, cfg)
    assert p.stats.slots == p.n_chunks * 64
    assert p.stats.pad_blocks == p.stats.slots - 3000
    assert p.stats.a_bytes == 8 * p.n_chunks * 64


def test_masked_edge_kernel_tolerates_nonfinite_b():
    """Inf/NaN in B rows that only padding references must not leak into C
    (0*Inf = NaN at pad slots): the engine drops pad slots."""
    import jax.numpy as jnp

    from sextans_tpu.ops.plan import SpmmPlan

    rng = np.random.default_rng(3)
    m, k, n = 64, 96, 16
    rows = rng.integers(1, m, 300).astype(np.int32)  # row 0 untouched
    cols = rng.integers(1, k, 300).astype(np.int32)  # col 0 untouched
    vals = rng.standard_normal(300).astype(np.float32)
    vals[vals == 0] = 1.0
    coo = COOMatrix((m, k), rows, cols, vals)
    cfg = SpmmConfig(tile_m=32, window_k=32, edge_chunk=64)
    packed = pack_edge(coo, cfg)
    b = rng.standard_normal((k, n)).astype(np.float32)
    b[0, :] = np.inf  # first row of the first K-window: pad-slot target
    c = rng.standard_normal((m, n)).astype(np.float32)
    plan = SpmmPlan(packed, n, backend="edge")
    got = np.asarray(plan(jnp.asarray(b), 0.85, -2.06, jnp.asarray(c)))
    assert np.isfinite(got).all()
    # A never references col 0, so the Inf row must not affect the result
    from sextans_tpu.format.csr import CSRMatrix
    from sextans_tpu.ops.golden import golden_spmm

    b_clean = b.copy()
    b_clean[0, :] = 0.0
    want = golden_spmm(CSRMatrix.from_coo(coo), b_clean, 0.85, -2.06, c)
    assert np.max(np.abs(got - want)) < 1e-4


def test_unmasked_edge_kernel_documented_precondition():
    """A single edge leaves most of its chunk as padding, all pointing at
    column 0 of the window; an Inf there must not reach C."""
    import jax.numpy as jnp

    from sextans_tpu.ops.plan import SpmmPlan

    rng = np.random.default_rng(4)
    m, k, n = 32, 32, 16
    # single edge at (1, 1): slot padding references col 0
    coo = COOMatrix((m, k), np.array([1], np.int32), np.array([1], np.int32),
                    np.array([2.0], np.float32))
    cfg = SpmmConfig(tile_m=32, window_k=32, edge_chunk=64)
    packed = pack_edge(coo, cfg)
    b = np.ones((k, n), np.float32)
    b[0, :] = np.inf
    plan = SpmmPlan(packed, n, backend="edge")
    got = np.asarray(plan(jnp.asarray(b), 1.0, 0.0, None))
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[1], np.full(n, 2.0, np.float32))
    assert not got[np.arange(m) != 1].any()


@pytest.mark.parametrize("level", [1, 2])
def test_edge_precise_mode_tightens_error(level):
    """Precise (float64) accumulation over hub rows' long chains must land
    within ~2 ulp of the f64 oracle (the same contract the block and slab
    engines honor — docs/ACCURACY.md)."""
    rng = np.random.default_rng(3)
    m, k, n = 64, 4096, 16
    # 8 hub rows x full-K degree: a 4096-edge serial chain per register
    rows = np.repeat(np.arange(8, dtype=np.int32), k)
    cols = np.tile(np.arange(k, dtype=np.int32), 8)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    coo = COOMatrix((m, k), rows, cols, vals)
    b = rng.standard_normal((k, n)).astype(np.float32)
    c = rng.standard_normal((m, n)).astype(np.float32)
    want = golden_spmm_exact(CSRMatrix.from_coo(coo), b, 0.85, -2.06, c)
    ulp = float(np.spacing(np.float32(np.abs(want).max())))

    errs = {}
    for precise in (False, True):
        cfg = SpmmConfig(tile_m=64, window_k=512, edge_chunk=128,
                         precise=level if precise else 0)
        packed = pack_edge(coo, cfg)
        got = np.asarray(
            SpmmPlan(packed, n, backend="edge")(b, 0.85, -2.06, c)
        )
        errs[precise] = float(np.abs(got - want).max())
    assert errs[True] <= errs[False], errs
    assert errs[True] <= 2.5 * ulp, (errs, ulp)


def test_edge_precise_masked_compose():
    """precise composes with IEEE-clean padding under non-finite B."""
    coo = COOMatrix.random(300, 400, 2500, seed=11)
    rng = np.random.default_rng(0)
    m, k = coo.shape
    n = 32
    b = rng.standard_normal((k, n)).astype(np.float32)
    b[0, :] = np.inf  # first row of window 0: pad slots would hit it
    c = rng.standard_normal((m, n)).astype(np.float32)
    cfg = SpmmConfig(tile_m=128, window_k=256, edge_chunk=128,
                     precise=True)
    # keep column 0 out of the real pattern so golden stays finite
    keep = coo.cols != 0
    coo = COOMatrix((m, k), coo.rows[keep], coo.cols[keep], coo.vals[keep])
    packed = pack_edge(coo, cfg)
    got = np.asarray(
        SpmmPlan(packed, n, backend="edge")(b, 0.85, -2.06, c)
    )
    want = golden_spmm_exact(CSRMatrix.from_coo(coo), b, 0.85, -2.06, c)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() < 1e-4


def test_edge_engine_precise_needs_x64():
    """Precise accumulates in float64: called without x64 the engine raises
    a typed error instead of silently accumulating in float32."""
    import jax.numpy as jnp

    from sextans_tpu.ops.spmm_xla import spmm_edge_padded

    vals = jnp.zeros((1, 1, 8), jnp.float32)
    meta = jnp.ones((1, 1, 8), jnp.int32)
    b = jnp.zeros((8, 4), jnp.float32)
    c = jnp.zeros((8, 4), jnp.float32)
    with pytest.raises(ValueError, match="x64"):
        spmm_edge_padded(
            vals, meta, jnp.zeros((2,), jnp.int32), jnp.zeros((1,), jnp.int32),
            b, c, jnp.float32(1.0), jnp.float32(0.0),
            tile_m=8, window_k=8, precise=1,
        )
