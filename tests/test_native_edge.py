"""Native C++ edge packer must be bit-identical to the NumPy pack_edge."""

import numpy as np
import pytest

from sextans_tpu.format.coo import COOMatrix
from sextans_tpu.format.pack_edge import pack_edge
from sextans_tpu.runtime import native
from sextans_tpu.utils.config import SpmmConfig

pytestmark = pytest.mark.skipif(
    not native.available_edge(), reason="native runtime unavailable"
)


def _coo(seed=0, m=300, k=260, nnz=3000):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, m, nnz).astype(np.int32)
    cols = rng.integers(0, k, nnz).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(np.float32)
    vals[vals == 0] = 1.0
    return COOMatrix((m, k), rows, cols, vals)


CFGS = [
    SpmmConfig(tile_m=64, window_k=64, edge_chunk=64),
    SpmmConfig(tile_m=64, window_k=32, edge_chunk=16),
    SpmmConfig(tile_m=128, window_k=256, edge_chunk=256),
    SpmmConfig(tile_m=32, window_k=128, edge_chunk=32),
]


@pytest.mark.parametrize("cfg", CFGS)
@pytest.mark.parametrize("seed", [0, 3, 9])
def test_native_matches_numpy(cfg, seed):
    coo = _coo(seed=seed)
    a = pack_edge(coo, cfg, impl="numpy")
    b = pack_edge(coo, cfg, impl="native")
    np.testing.assert_array_equal(a.meta, b.meta)
    np.testing.assert_array_equal(a.vals, b.vals)
    np.testing.assert_array_equal(a.chunk_mtile, b.chunk_mtile)
    np.testing.assert_array_equal(a.chunk_kwin, b.chunk_kwin)
    assert a.stats == b.stats


def test_native_empty_mtiles_and_duplicates():
    # rows clustered at the top; duplicate coordinates are separate edges
    coo = COOMatrix(
        (256, 64),
        rows=np.array([0, 0, 1, 1, 1], np.int32),
        cols=np.array([5, 5, 9, 9, 2], np.int32),
        vals=np.array([1.0, 2.0, 3.0, 4.0, 5.0], np.float32),
    )
    cfg = SpmmConfig(tile_m=32, window_k=32, edge_chunk=32)
    a = pack_edge(coo, cfg, impl="numpy")
    b = pack_edge(coo, cfg, impl="native")
    np.testing.assert_array_equal(a.meta, b.meta)
    np.testing.assert_array_equal(a.vals, b.vals)
    np.testing.assert_array_equal(a.chunk_mtile, b.chunk_mtile)


def test_native_large_random_stable():
    """>1M edges exercises the radix-sort path (stability matters for
    duplicate coordinates)."""
    rng = np.random.default_rng(7)
    nnz = 1_200_000
    m = k = 4096
    rows = rng.integers(0, m, nnz).astype(np.int32)
    cols = rng.integers(0, k, nnz).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(np.float32)
    vals[vals == 0] = 1.0
    coo = COOMatrix((m, k), rows, cols, vals)
    cfg = SpmmConfig(tile_m=512, window_k=1024, edge_chunk=512)
    a = pack_edge(coo, cfg, impl="numpy")
    b = pack_edge(coo, cfg, impl="native")
    np.testing.assert_array_equal(a.meta, b.meta)
    np.testing.assert_array_equal(a.vals, b.vals)
    np.testing.assert_array_equal(a.chunk_mtile, b.chunk_mtile)
    np.testing.assert_array_equal(a.chunk_kwin, b.chunk_kwin)
