"""Disk pack cache (format/pack_cache.py) + device-upload memo (ops/plan.py)."""

import numpy as np
import pytest

from sextans_tpu.format.coo import COOMatrix
from sextans_tpu.format.pack_cache import PackCache, pack_signature
from sextans_tpu.ops.plan import SpmmPlan
from sextans_tpu.utils.config import SpmmConfig


def _coo(seed=0, m=64, k=96, nnz=300):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, m, nnz).astype(np.int32)
    cols = rng.integers(0, k, nnz).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(np.float32)
    vals[vals == 0] = 1.0
    return COOMatrix((m, k), rows, cols, vals)


CFG = SpmmConfig(tile_m=32, window_k=64, block_k=8, group_blocks=16)


@pytest.mark.parametrize("fmt", ["vpu", "mxu", "edge"])
def test_roundtrip_all_formats(tmp_path, fmt):
    coo = _coo(m=256)
    cfg = CFG.with_(tile_m=128) if fmt == "mxu" else CFG
    cache = PackCache(root=tmp_path)
    p1 = cache.get_or_pack("t", coo, cfg, fmt)
    assert cache.misses == 1
    # memory hit
    p2 = cache.get_or_pack("t", coo, cfg, fmt)
    assert cache.hits == 1
    np.testing.assert_array_equal(p1.vals, p2.vals)
    # disk hit from a fresh cache instance
    cache2 = PackCache(root=tmp_path)
    p3 = cache2.get_or_pack("t", coo, cfg, fmt)
    assert cache2.disk_hits == 1 and cache2.misses == 0
    np.testing.assert_array_equal(p1.vals, p3.vals)
    np.testing.assert_array_equal(p1.group_mtile, p3.group_mtile)
    np.testing.assert_array_equal(p1.group_kwin, p3.group_kwin)


def test_kernel_knobs_share_one_pack(tmp_path):
    coo = _coo()
    cache = PackCache(root=tmp_path)
    p1 = cache.get_or_pack("t", coo, CFG, "vpu")
    p2 = cache.get_or_pack("t", coo, CFG.with_(precise=True), "vpu")
    assert cache.misses == 1 and cache.hits == 1  # knobs outside the key
    assert p2.config.precise and not p1.config.precise
    assert p2.vals is p1.vals  # shared bytes, different config


def test_content_change_does_not_alias(tmp_path):
    cache = PackCache(root=tmp_path)
    p1 = cache.get_or_pack("same-name", _coo(seed=1), CFG, "vpu")
    p2 = cache.get_or_pack("same-name", _coo(seed=2), CFG, "vpu")
    assert cache.misses == 2
    assert not np.array_equal(p1.vals, p2.vals)


def test_signature_separates_formats_and_reorder():
    sigs = {
        pack_signature(CFG, "vpu", False),
        pack_signature(CFG, "vpu", True),
        pack_signature(CFG, "mxu", False),
        pack_signature(CFG, "edge", False),
    }
    assert len(sigs) == 4


def test_device_upload_memo_across_n(tmp_path):
    coo = _coo()
    cache = PackCache(root=tmp_path)
    p1 = cache.get_or_pack("t", coo, CFG, "vpu")
    p2 = cache.get_or_pack("t", coo, CFG.with_(precise=True), "vpu")
    plan16 = SpmmPlan(p1, 16, backend="xla")
    plan32 = SpmmPlan(p2, 32, backend="xla")
    # one upload serves every N (and every kernel-knob variant)
    assert plan16._dev[0] is plan32._dev[0]
    b = np.ones((coo.shape[1], 16), np.float32)
    from sextans_tpu.format.csr import CSRMatrix
    from sextans_tpu.ops.golden import golden_spmm

    want = golden_spmm(CSRMatrix.from_coo(coo), b, 1.0, 0.0, None)
    np.testing.assert_allclose(np.asarray(plan16(b)), want, rtol=1e-5, atol=1e-5)


def test_correct_result_through_disk_cache(tmp_path):
    coo = _coo(seed=5)
    cache = PackCache(root=tmp_path)
    cache.get_or_pack("t", coo, CFG, "edge")
    fresh = PackCache(root=tmp_path)
    pe = fresh.get_or_pack("t", coo, CFG, "edge")
    assert fresh.disk_hits == 1
    plan = SpmmPlan(pe, 16, backend="edge")
    b = np.ones((coo.shape[1], 16), np.float32)
    from sextans_tpu.format.csr import CSRMatrix
    from sextans_tpu.ops.golden import golden_spmm

    want = golden_spmm(CSRMatrix.from_coo(coo), b, 1.0, 0.0, None)
    np.testing.assert_allclose(np.asarray(plan(b)), want, rtol=1e-5, atol=1e-5)


def test_hybrid_split_save_load_round_trip(tmp_path):
    from sextans_tpu.ops.hybrid import HybridSplit, split_structure

    coo = _coo(seed=7)
    split = split_structure(coo, n=16)
    path = tmp_path / "split.npz"
    split.save(path)
    back = HybridSplit.load(path)
    assert (back.m, back.k, back.nnz) == (split.m, split.k, split.nnz)
    np.testing.assert_array_equal(back.diag_offsets, split.diag_offsets)
    np.testing.assert_array_equal(back.diag_vals, split.diag_vals)
    np.testing.assert_array_equal(back.head_cols, split.head_cols)
    np.testing.assert_array_equal(back.head_dense, split.head_dense)
    np.testing.assert_array_equal(back.head_rows, split.head_rows)
    np.testing.assert_array_equal(
        back.head_rows_dense, split.head_rows_dense
    )
    np.testing.assert_array_equal(back.residue.rows, split.residue.rows)
    np.testing.assert_array_equal(back.residue.vals, split.residue.vals)


def test_get_or_split_disk_round_trip(tmp_path):
    coo = _coo(seed=9)
    cache = PackCache(root=tmp_path)
    s1 = cache.get_or_split("t", coo, n=32)
    assert cache.misses == 1
    s2 = cache.get_or_split("t", coo, n=32)
    assert cache.hits == 1 and s2 is s1
    fresh = PackCache(root=tmp_path)
    s3 = fresh.get_or_split("t", coo, n=32)
    assert fresh.disk_hits == 1
    assert s3.summary() == s1.summary()
    # a different n is a different decomposition key
    fresh.get_or_split("t", coo, n=512)
    assert fresh.misses == 1


def test_get_or_split_version_invalidates(tmp_path, monkeypatch):
    import sextans_tpu.ops.hybrid as hybrid_mod

    coo = _coo(seed=9)
    cache = PackCache(root=tmp_path)
    cache.get_or_split("t", coo, n=32)
    monkeypatch.setattr(hybrid_mod, "SPLIT_VERSION", 9999)
    fresh = PackCache(root=tmp_path)
    fresh.get_or_split("t", coo, n=32)
    assert fresh.misses == 1 and fresh.disk_hits == 0


def test_hybrid_plan_residue_through_cache(tmp_path):
    from sextans_tpu.ops.hybrid import HybridSpmmPlan, split_structure
    from sextans_tpu.format.csr import CSRMatrix
    from sextans_tpu.ops.golden import golden_spmm

    coo = _coo(seed=11)
    split = split_structure(coo, n=16)
    cache = PackCache(root=tmp_path)
    cfg = CFG
    plan = HybridSpmmPlan(
        split, 16, backend="xla", residue_config=cfg, residue_fmt="vpu",
        pack_cache=cache, cache_name="t@n16-residue"
    )
    assert cache.misses == 1
    b = np.ones((coo.shape[1], 16), np.float32)
    want = golden_spmm(CSRMatrix.from_coo(coo), b, 1.0, 0.0, None)
    np.testing.assert_allclose(
        np.asarray(plan(b, 1.0, 0.0, None)), want, rtol=1e-5, atol=1e-5
    )
    # second build hits the cache (memory or disk) instead of re-packing
    plan2 = HybridSpmmPlan(
        split, 16, backend="xla", residue_config=cfg, residue_fmt="vpu",
        pack_cache=cache, cache_name="t@n16-residue"
    )
    assert cache.misses == 1
    np.testing.assert_allclose(
        np.asarray(plan2(b, 1.0, 0.0, None)), want, rtol=1e-5, atol=1e-5
    )


def test_raw_memmap_cache_roundtrip(tmp_path, monkeypatch):
    """Packs above SEXTANS_PACK_RAW_BYTES go to the raw npy-dir store and
    load back memmapped, byte-identical, for every format."""
    import numpy as np

    from sextans_tpu.format.coo import COOMatrix
    from sextans_tpu.format.csr import CSRMatrix
    from sextans_tpu.format.pack_cache import PackCache
    from sextans_tpu.ops.golden import golden_spmm_exact
    from sextans_tpu.ops.plan import SpmmPlan
    from sextans_tpu.utils.config import SpmmConfig
    from sextans_tpu.utils.verify import verify

    monkeypatch.setenv("SEXTANS_PACK_RAW_BYTES", "1")  # force raw for all
    coo = COOMatrix.random(300, 400, 3000, seed=11)
    cfgs = {
        "vpu": SpmmConfig(tile_m=64),
        "mxu": SpmmConfig(tile_m=128, window_k=1024, block_k=128,
                          group_blocks=2),
        "edge": SpmmConfig(tile_m=64, edge_chunk=512),
        "ell": SpmmConfig(tile_m=64, ell_r=4),
    }
    backends = {"vpu": "xla", "mxu": "mxu", "edge": "edge", "ell": "ell"}
    rng = np.random.default_rng(12)
    b = rng.standard_normal((400, 16)).astype(np.float32)
    want = golden_spmm_exact(CSRMatrix.from_coo(coo), b, 1.0, 0.0, None)
    for fmt, cfg in cfgs.items():
        cache = PackCache(tmp_path / fmt)
        p1 = cache.get_or_pack("m", coo, cfg, fmt)
        assert cache.misses == 1
        raw_dirs = list((tmp_path / fmt).glob("*.raw"))
        assert len(raw_dirs) == 1 and raw_dirs[0].is_dir(), fmt
        # fresh cache object: disk (raw) hit, arrays byte-identical
        cache2 = PackCache(tmp_path / fmt)
        p2 = cache2.get_or_pack("m", coo, cfg, fmt)
        assert cache2.disk_hits == 1, fmt
        np.testing.assert_array_equal(p1.vals, p2.vals)
        assert isinstance(p2.vals, np.memmap) or p2.vals.base is not None
        got = np.asarray(SpmmPlan(p2, 16, backend=backends[fmt])(b, 1.0, 0.0))
        assert verify(want, got).passed, fmt
