"""Pack pass tests: the packed block format must reconstruct A exactly and
honor its structural invariants (SURVEY.md §7 Phase 1)."""

import numpy as np
import pytest

from sextans_tpu.format.coo import COOMatrix
from sextans_tpu.format.pack import PackedSpMatrix, pack
from sextans_tpu.utils.config import SpmmConfig


def unpack_to_dense(p: PackedSpMatrix) -> np.ndarray:
    """Reassemble the dense matrix from packed arrays (test-only)."""
    cfg = p.config
    G, bk = cfg.group_blocks, cfg.block_k
    dense = np.zeros((p.m_padded, p.k_padded), dtype=np.float64)
    vals = p.vals.reshape(p.n_groups, 8, G, bk).transpose(0, 2, 1, 3)
    for g in range(p.n_groups):
        mt = p.group_mtile[g]
        kw = p.group_kwin[g]
        for i in range(G):
            r0 = mt * cfg.tile_m + 8 * p.qrow[g, i]
            c0 = kw * cfg.window_k + p.bcol[g, i]
            dense[r0 : r0 + 8, c0 : c0 + bk] += vals[g, i]
    return dense


CONFIGS = [
    SpmmConfig(tile_m=64, window_k=128, block_k=8, group_blocks=16),
    SpmmConfig(tile_m=32, window_k=64, block_k=4, group_blocks=32),
    SpmmConfig(tile_m=16, window_k=32, block_k=1, group_blocks=128),
    SpmmConfig(tile_m=128, window_k=256, block_k=16, group_blocks=8),
]


@pytest.mark.parametrize("cfg", CONFIGS)
def test_pack_reconstructs_matrix(cfg):
    coo = COOMatrix.random(100, 150, 800, seed=11)
    p = pack(coo, cfg)
    got = unpack_to_dense(p)[:100, :150]
    np.testing.assert_allclose(got, coo.to_dense(), atol=1e-6)


def test_pack_invariants():
    cfg = SpmmConfig(tile_m=64, window_k=128, block_k=8, group_blocks=16)
    coo = COOMatrix.random(200, 300, 1500, seed=5, banded=True, bandwidth=40)
    p = pack(coo, cfg)
    G = cfg.group_blocks
    assert p.vals.shape == (p.n_groups, 8, G * cfg.block_k)
    assert p.group_mtile.shape == (p.n_groups + 1,)
    assert p.group_mtile[-1] == -1
    # every group's blocks stay inside the tile/window
    assert p.qrow.max() < cfg.tile_m // 8
    assert p.bcol.max() < cfg.window_k
    assert p.bcol.min() >= 0
    # block starts aligned to block_k
    assert np.all(p.bcol % cfg.block_k == 0)
    # group m-tiles are valid
    assert p.group_mtile[:-1].min() >= 0
    assert p.group_mtile[:-1].max() < p.n_mtiles


def test_every_mtile_covered():
    """M-tiles without nonzeros must still get an epilogue group."""
    cfg = SpmmConfig(tile_m=16, window_k=64, block_k=8, group_blocks=16)
    # all nonzeros in rows 0-7 → tiles beyond row 16 are empty
    coo = COOMatrix(
        (64, 64),
        rows=np.array([0, 3, 7], dtype=np.int32),
        cols=np.array([5, 10, 60], dtype=np.int32),
        vals=np.array([1.0, 2.0, 3.0], dtype=np.float32),
    )
    p = pack(coo, cfg)
    covered = set(int(x) for x in p.group_mtile[:-1])
    assert covered == set(range(p.n_mtiles))
    assert p.stats.empty_mtiles == 3


def test_groups_same_mtile_consecutive():
    """Kernel correctness requires each m-tile's groups to be contiguous."""
    cfg = SpmmConfig(tile_m=32, window_k=64, block_k=8, group_blocks=16)
    coo = COOMatrix.random(256, 256, 3000, seed=9)
    p = pack(coo, cfg)
    mts = p.group_mtile[:-1]
    seen = set()
    prev = None
    for mt in mts:
        if mt != prev:
            assert mt not in seen, "m-tile groups are not contiguous"
            seen.add(int(mt))
            prev = mt


def test_duplicates_sum_in_pack():
    cfg = SpmmConfig(tile_m=16, window_k=32, block_k=8, group_blocks=16)
    coo = COOMatrix(
        (8, 8),
        rows=np.array([1, 1], dtype=np.int32),
        cols=np.array([2, 2], dtype=np.int32),
        vals=np.array([1.5, 2.5], dtype=np.float32),
    )
    p = pack(coo, cfg)
    dense = unpack_to_dense(p)
    assert dense[1, 2] == 4.0


def test_empty_matrix():
    cfg = SpmmConfig(tile_m=16, window_k=32, block_k=8, group_blocks=16)
    coo = COOMatrix((40, 40), np.array([], np.int32), np.array([], np.int32), np.array([], np.float32))
    p = pack(coo, cfg)
    assert p.nnz == 0
    assert set(int(x) for x in p.group_mtile[:-1]) == set(range(p.n_mtiles))


def test_stats_accounting():
    cfg = SpmmConfig(tile_m=64, window_k=128, block_k=8, group_blocks=16)
    coo = COOMatrix.random(100, 100, 500, seed=2)
    p = pack(coo, cfg)
    s = p.stats
    assert s.nnz == 500
    assert s.slots == s.blocks * 8 * cfg.block_k
    assert 0 < s.block_fill <= 1.0
    assert 0 < s.group_fill <= 1.0
    assert s.groups * cfg.group_blocks == s.blocks + s.pad_blocks


def test_save_load_roundtrip(tmp_path):
    cfg = SpmmConfig(tile_m=64, window_k=128, block_k=8, group_blocks=16)
    coo = COOMatrix.random(90, 110, 700, seed=13)
    p = pack(coo, cfg)
    f = tmp_path / "packed.npz"
    p.save(f)
    q = PackedSpMatrix.load(f)
    np.testing.assert_array_equal(p.vals, q.vals)
    np.testing.assert_array_equal(p.qrow, q.qrow)
    np.testing.assert_array_equal(p.bcol, q.bcol)
    np.testing.assert_array_equal(p.group_mtile, q.group_mtile)
    assert q.config == p.config
    assert q.stats == p.stats


def test_save_load_roundtrips_tuned_kernel_knobs(tmp_path):
    """An autotuned config (geometry and precise) must survive
    --save-packed: a loaded plan must not silently fall back to defaults."""
    cfg = SpmmConfig(
        tile_m=64, window_k=128, block_k=4, group_blocks=32, precise=1,
    )
    coo = COOMatrix.random(90, 110, 700, seed=13)
    p = pack(coo, cfg)
    f = tmp_path / "packed.npz"
    p.save(f)
    q = PackedSpMatrix.load(f)
    assert q.config == cfg
    # the fast path round-trips too
    p2 = pack(coo, cfg.with_(precise=0))
    p2.save(f)
    assert PackedSpMatrix.load(f).config.precise == 0


def test_interleave_spreads_stripes():
    """Interleaved schedule should avoid long same-stripe runs when possible."""
    cfg = SpmmConfig(tile_m=64, window_k=4096, block_k=8, group_blocks=64)
    # dense-ish band: many blocks per stripe
    coo = COOMatrix.random(64, 4096, 8000, seed=21)
    p_int = pack(coo, cfg)
    p_no = pack(coo, cfg.with_(interleave=False))

    def max_run(qr):
        best = run = 1
        flat = qr.reshape(-1)
        for a, b in zip(flat[:-1], flat[1:]):
            run = run + 1 if a == b else 1
            best = max(best, run)
        return best

    assert max_run(p_int.qrow) <= max_run(p_no.qrow)


# ---- native (C++) pack parity ----

def _native_available():
    from sextans_tpu.runtime import native

    return native.available()


@pytest.mark.skipif(not _native_available(), reason="native runtime not built")
@pytest.mark.parametrize("cfg", CONFIGS)
def test_native_pack_bit_identical(cfg):
    """C++ pack (runtime/packer.cpp) must match the NumPy reference exactly."""
    coo = COOMatrix.random(250, 333, 4000, seed=17)
    a = pack(coo, cfg, impl="numpy")
    b = pack(coo, cfg, impl="native")
    np.testing.assert_array_equal(a.vals, b.vals)
    np.testing.assert_array_equal(a.qrow, b.qrow)
    np.testing.assert_array_equal(a.bcol, b.bcol)
    np.testing.assert_array_equal(a.group_mtile, b.group_mtile)
    np.testing.assert_array_equal(a.group_kwin, b.group_kwin)
    assert a.stats == b.stats


@pytest.mark.skipif(not _native_available(), reason="native runtime not built")
def test_native_pack_no_interleave():
    cfg = SpmmConfig(tile_m=64, window_k=128, block_k=8, group_blocks=16,
                     interleave=False)
    coo = COOMatrix.random(200, 200, 3000, seed=23)
    a = pack(coo, cfg, impl="numpy")
    b = pack(coo, cfg, impl="native")
    np.testing.assert_array_equal(a.vals, b.vals)
    np.testing.assert_array_equal(a.qrow, b.qrow)


@pytest.mark.skipif(not _native_available(), reason="native runtime not built")
def test_native_pack_duplicates_and_empty_tiles():
    cfg = SpmmConfig(tile_m=16, window_k=64, block_k=8, group_blocks=16)
    coo = COOMatrix(
        (64, 64),
        rows=np.array([0, 0, 7], dtype=np.int32),
        cols=np.array([5, 5, 60], dtype=np.int32),
        vals=np.array([1.5, 2.5, 3.0], dtype=np.float32),
    )
    a = pack(coo, cfg, impl="numpy")
    b = pack(coo, cfg, impl="native")
    np.testing.assert_array_equal(a.vals, b.vals)
    np.testing.assert_array_equal(a.group_mtile, b.group_mtile)
    assert b.stats.empty_mtiles == 3


def test_reorder_cols_correctness_and_roundtrip(tmp_path):
    """Degree-sorted column reorder must preserve results (B permuted on
    device via col_perm) and survive save/load."""
    from sextans_tpu.format.csr import CSRMatrix
    from sextans_tpu.ops.golden import golden_spmm_exact
    from sextans_tpu.ops.plan import SpmmPlan

    cfg = SpmmConfig(tile_m=32, window_k=64, block_k=8, group_blocks=16)
    coo = COOMatrix.random(120, 90, 900, seed=77)
    p = pack(coo, cfg, reorder_cols=True)
    assert p.col_perm is not None and len(p.col_perm) == 90
    assert sorted(p.col_perm.tolist()) == list(range(90))

    rng = np.random.default_rng(1)
    b = rng.standard_normal((90, 16)).astype(np.float32)
    c = rng.standard_normal((120, 16)).astype(np.float32)
    want = golden_spmm_exact(CSRMatrix.from_coo(coo), b, 1.5, -0.5, c)
    got = np.asarray(SpmmPlan(p, 16, backend="xla")(b, 1.5, -0.5, c))
    assert np.max(np.abs(got - want)) < 1e-4

    f = tmp_path / "re.npz"
    p.save(f)
    q = PackedSpMatrix.load(f)
    np.testing.assert_array_equal(p.col_perm, q.col_perm)
    got2 = np.asarray(SpmmPlan(q, 16, backend="xla")(b, 1.5, -0.5, c))
    np.testing.assert_allclose(got, got2)


def test_reorder_cols_reduces_jobs_on_skewed():
    import sys
    from pathlib import Path as _P

    sys.path.insert(0, str(_P(__file__).resolve().parent.parent))
    from benchmarks.matrices import powerlaw_like

    coo = powerlaw_like(3000, avg_degree=8, seed=3)
    cfg = SpmmConfig(tile_m=512, window_k=2048, block_k=8, group_blocks=256)
    plain = pack(coo, cfg)
    reord = pack(coo, cfg, reorder_cols=True)
    assert reord.stats.jobs <= plain.stats.jobs
    assert reord.stats.blocks <= plain.stats.blocks
