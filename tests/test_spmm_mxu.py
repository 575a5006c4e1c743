"""Dense-slab format: pack + engine vs the golden oracle.

The swsim-analog coverage (SURVEY.md §4) for the second packed format:
format/pack_mxu.py + the slab engine of ops/spmm_xla.py.
"""

import numpy as np
import pytest

from sextans_tpu.format.coo import COOMatrix
from sextans_tpu.format.csr import CSRMatrix
from sextans_tpu.format.pack_mxu import pack_mxu
from sextans_tpu.ops.golden import golden_spmm_exact
from sextans_tpu.ops.plan import SpmmPlan
from sextans_tpu.utils.config import SpmmConfig
from sextans_tpu.utils.verify import verify


def _run(coo, n, cfg, alpha=0.85, beta=-2.06, c=None, seed=0, **plan_kw):
    rng = np.random.default_rng(seed)
    m, k = coo.shape
    b = rng.standard_normal((k, n)).astype(np.float32)
    if beta != 0.0 and c is None:
        c = rng.standard_normal((m, n)).astype(np.float32)
    packed = pack_mxu(coo, cfg)
    plan = SpmmPlan(packed, n, backend="mxu", **plan_kw)
    got = np.asarray(plan(b, alpha, beta, c))
    want = golden_spmm_exact(CSRMatrix.from_coo(coo), b, alpha, beta, c)
    return got, want


CFG = SpmmConfig(tile_m=256, window_k=256, block_k=8, group_blocks=16)


def test_mxu_matches_golden_basic():
    coo = COOMatrix.random(500, 700, 4000, seed=1)
    got, want = _run(coo, 96, CFG)
    res = verify(want, got)
    assert res.passed, res
    assert res.max_abs_err < 1e-5, res


@pytest.mark.parametrize("bk", [8, 16, 32])
def test_mxu_block_k_sweep(bk):
    coo = COOMatrix.random(300, 512, 2500, seed=2)
    cfg = SpmmConfig(tile_m=128, window_k=256, block_k=bk, group_blocks=8)
    got, want = _run(coo, 64, cfg)
    assert verify(want, got).passed


def test_mxu_beta_zero_no_c_fast_path():
    coo = COOMatrix.random(200, 300, 1500, seed=3)
    got, want = _run(coo, 32, CFG, alpha=1.5, beta=0.0)
    assert verify(want, got).passed


def test_mxu_empty_mtiles_still_scaled():
    # rows only in the first 128 rows -> later M-tiles have no blocks but
    # must still produce beta*C
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 100, 800).astype(np.int32)
    cols = rng.integers(0, 600, 800).astype(np.int32)
    vals = rng.standard_normal(800).astype(np.float32)
    coo = COOMatrix((700, 600), rows, cols, vals)
    got, want = _run(coo, 16, CFG)
    assert verify(want, got).passed


def test_mxu_ragged_dims_padding():
    coo = COOMatrix.random(130, 129, 900, seed=5)
    cfg = SpmmConfig(tile_m=128, window_k=128, block_k=8, group_blocks=8)
    got, want = _run(coo, 17, cfg)
    assert verify(want, got).passed


def test_mxu_rejects_bad_config():
    coo = COOMatrix.random(64, 64, 100, seed=6)
    with pytest.raises(ValueError, match="tile_m"):
        pack_mxu(coo, SpmmConfig(tile_m=64, window_k=128, block_k=8, group_blocks=8))
    with pytest.raises(ValueError, match="block_k"):
        pack_mxu(coo, SpmmConfig(tile_m=128, window_k=128, block_k=4, group_blocks=32))


def test_mxu_backend_format_mismatch_raises():
    from sextans_tpu.format.pack import pack

    coo = COOMatrix.random(64, 64, 100, seed=7)
    packed_vpu = pack(coo, SpmmConfig(tile_m=64, window_k=128, block_k=8, group_blocks=16))
    with pytest.raises(ValueError, match="backend"):
        SpmmPlan(packed_vpu, 16, backend="mxu")
    packed_mxu = pack_mxu(coo, SpmmConfig(tile_m=128, window_k=128, block_k=8, group_blocks=8))
    with pytest.raises(ValueError, match="backend"):
        SpmmPlan(packed_mxu, 16, backend="xla")


def test_mxu_duplicate_coordinates_sum():
    rows = np.array([3, 3, 130, 3], dtype=np.int32)
    cols = np.array([7, 7, 40, 7], dtype=np.int32)
    vals = np.array([1.0, 2.0, 5.0, 0.5], dtype=np.float32)
    coo = COOMatrix((256, 128), rows, cols, vals)
    cfg = SpmmConfig(tile_m=128, window_k=128, block_k=8, group_blocks=8)
    got, want = _run(coo, 8, cfg, alpha=1.0, beta=0.0)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_mxu_repeat_chain_matches_single():
    coo = COOMatrix.random(200, 200, 1000, seed=8)
    rng = np.random.default_rng(9)
    b = rng.standard_normal((200, 32)).astype(np.float32)
    c = rng.standard_normal((200, 32)).astype(np.float32)
    packed = pack_mxu(coo, CFG)
    plan = SpmmPlan(packed, 32, backend="mxu")
    one = np.asarray(plan(b, 0.5, 0.25, c))
    two = np.asarray(plan(b, 0.5, 0.25, one))
    chained = np.asarray(plan.repeat(b, 0.5, 0.25, c, times=2))
    np.testing.assert_allclose(chained, two, rtol=1e-5, atol=1e-5)


def test_mxu_pack_stats():
    coo = COOMatrix.random(500, 700, 4000, seed=1)
    p = pack_mxu(coo, CFG)
    s = p.stats
    assert s.nnz == 4000
    assert s.slots == s.blocks * CFG.block_k * 128
    assert 0 < s.block_fill <= 1.0
    assert s.groups * CFG.group_blocks == s.blocks + s.pad_blocks


def test_precise_mode_tightens_error_both_kernels():
    """Precise (float64) accumulation must land within ~2 ulp of the f64
    oracle on a long-accumulation workload (docs/ACCURACY.md), for the
    block and the slab engines."""
    from sextans_tpu.format.pack import pack

    rng = np.random.default_rng(0)
    m, k, n = 64, 4096, 16
    rows = np.repeat(np.arange(8, dtype=np.int32), k)
    cols = np.tile(np.arange(k, dtype=np.int32), 8)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    coo = COOMatrix((m, k), rows, cols, vals)
    b = rng.standard_normal((k, n)).astype(np.float32)
    c = rng.standard_normal((m, n)).astype(np.float32)
    want = golden_spmm_exact(CSRMatrix.from_coo(coo), b, 0.85, -2.06, c)
    ulp = float(np.spacing(np.float32(np.abs(want).max())))

    for fmt, be in (("vpu", "xla"), ("mxu", "mxu")):
        errs = {}
        for precise in (False, True):
            cfg = SpmmConfig(tile_m=128, window_k=512, block_k=8,
                             group_blocks=16, precise=precise)
            packed = pack(coo, cfg) if fmt == "vpu" else pack_mxu(coo, cfg)
            got = np.asarray(SpmmPlan(packed, n, backend=be)(b, 0.85, -2.06, c))
            errs[precise] = float(np.abs(got - want).max())
        assert errs[True] <= errs[False], (fmt, errs)
        assert errs[True] <= 2.5 * ulp, (fmt, errs, ulp)


def test_slab_engine_chunked_scan_matches_one_chunk(monkeypatch):
    """Many small block chunks (the lax.scan path) give the one-chunk
    result: the chunking bounds memory, never changes the sum's terms."""
    import jax.numpy as jnp

    from sextans_tpu.ops import spmm_xla

    coo = COOMatrix.random(300, 260, 2500, seed=12)
    cfg = SpmmConfig(tile_m=128, window_k=128, block_k=8, group_blocks=4)
    p = pack_mxu(coo, cfg)
    rng = np.random.default_rng(13)
    b = jnp.asarray(rng.standard_normal((p.k_padded, 24)).astype(np.float32))
    c = jnp.asarray(rng.standard_normal((p.m_padded, 24)).astype(np.float32))
    args = (jnp.asarray(p.vals), jnp.asarray(p.qm), jnp.asarray(p.bcol),
            jnp.asarray(p.group_mtile), jnp.asarray(p.group_kwin), b, c,
            jnp.float32(0.85), jnp.float32(-2.06))
    kw = dict(tile_m=128, window_k=128, block_k=8, group_blocks=4)
    one = np.asarray(spmm_xla.spmm_slab_padded.__wrapped__(*args, **kw))
    monkeypatch.setattr(spmm_xla, "CHUNK_BYTES", 4 * 24 * (8 + 4 * 128) * 7)
    many = np.asarray(spmm_xla.spmm_slab_padded.__wrapped__(*args, **kw))
    np.testing.assert_allclose(many, one, rtol=1e-6, atol=1e-5)
    want = golden_spmm_exact(
        CSRMatrix.from_coo(coo), np.asarray(b)[:260], 0.85, -2.06,
        np.asarray(c)[:300],
    )
    assert verify(want, many[:300]).passed


def test_native_mxu_pack_bit_identical():
    """C++ MXU packer must produce bit-identical arrays to NumPy."""
    from sextans_tpu.runtime import native

    if not native.available_mxu():
        pytest.skip("native runtime unavailable")
    for seed, cfg in [
        (1, SpmmConfig(tile_m=256, window_k=256, block_k=8, group_blocks=16)),
        (2, SpmmConfig(tile_m=128, window_k=512, block_k=32, group_blocks=4)),
    ]:
        coo = COOMatrix.random(500, 700, 4000, seed=seed)
        a = pack_mxu(coo, cfg, impl="numpy")
        b = pack_mxu(coo, cfg, impl="native")
        np.testing.assert_array_equal(a.vals, b.vals)
        np.testing.assert_array_equal(a.qm, b.qm)
        np.testing.assert_array_equal(a.bcol, b.bcol)
        np.testing.assert_array_equal(a.group_mtile, b.group_mtile)
        np.testing.assert_array_equal(a.group_kwin, b.group_kwin)
        assert a.stats == b.stats
    # duplicate coordinates sum in input order on both paths
    rows = np.array([3, 3, 130, 3], dtype=np.int32)
    cols = np.array([7, 7, 40, 7], dtype=np.int32)
    vals = np.array([1.0, 2.0, 5.0, 0.5], dtype=np.float32)
    coo = COOMatrix((256, 128), rows, cols, vals)
    cfg = SpmmConfig(tile_m=128, window_k=128, block_k=8, group_blocks=8)
    np.testing.assert_array_equal(
        pack_mxu(coo, cfg, impl="numpy").vals,
        pack_mxu(coo, cfg, impl="native").vals,
    )


def test_mxu_save_load_roundtrip(tmp_path):
    from sextans_tpu.format.pack_mxu import PackedSpMatrixMXU

    coo = COOMatrix.random(500, 700, 4000, seed=1)
    cfg = CFG.with_(precise=True)
    p = pack_mxu(coo, cfg)
    f = tmp_path / "packed_mxu.npz"
    p.save(f)
    q = PackedSpMatrixMXU.load(f)
    np.testing.assert_array_equal(p.vals, q.vals)
    np.testing.assert_array_equal(p.qm, q.qm)
    np.testing.assert_array_equal(p.bcol, q.bcol)
    np.testing.assert_array_equal(p.group_mtile, q.group_mtile)
    assert q.config == cfg
    assert q.stats == p.stats
    # format marker rejects cross-loading
    with pytest.raises(ValueError, match="MXU"):
        from sextans_tpu.format.pack import pack

        vp = pack(coo, SpmmConfig(tile_m=64, window_k=128, block_k=8,
                                  group_blocks=16))
        f2 = tmp_path / "packed_vpu.npz"
        vp.save(f2)
        PackedSpMatrixMXU.load(f2)
