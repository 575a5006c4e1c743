"""slot_map must reproduce each pack pass bit-exactly via scatter-add."""

import numpy as np
import pytest

from sextans_tpu.format.coo import COOMatrix
from sextans_tpu.format.pack import pack
from sextans_tpu.format.pack_edge import pack_edge
from sextans_tpu.format.pack_mxu import pack_mxu
from sextans_tpu.format.slots import slot_map
from sextans_tpu.utils.config import SpmmConfig


def _coo(seed=0, m=300, k=260, nnz=2500):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, m, nnz).astype(np.int32)
    cols = rng.integers(0, k, nnz).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(np.float32)
    vals[vals == 0] = 1.0
    return COOMatrix((m, k), rows, cols, vals)


def _scatter(slots, vals, shape):
    flat = np.zeros(int(np.prod(shape)), dtype=np.float32)
    np.add.at(flat, slots, vals)
    return flat.reshape(shape)


CASES = [
    ("vpu", SpmmConfig(tile_m=64, window_k=64, block_k=8, group_blocks=16)),
    ("vpu", SpmmConfig(tile_m=64, window_k=64, block_k=8, group_blocks=16,
                       interleave=False)),
    ("vpu", SpmmConfig(tile_m=32, window_k=128, block_k=4, group_blocks=32)),
    ("mxu", SpmmConfig(tile_m=128, window_k=256, block_k=8, group_blocks=4)),
    ("mxu", SpmmConfig(tile_m=256, window_k=128, block_k=16, group_blocks=2)),
    ("edge", SpmmConfig(tile_m=64, window_k=64, edge_chunk=64)),
    ("edge", SpmmConfig(tile_m=32, window_k=128, edge_chunk=16)),
    ("ell", SpmmConfig(tile_m=32, ell_r=4)),
    ("ell", SpmmConfig(tile_m=32)),  # auto slots-per-row
]


@pytest.mark.parametrize("fmt,cfg", CASES)
@pytest.mark.parametrize("seed", [0, 7])
def test_scatter_reproduces_pack(fmt, cfg, seed):
    coo = _coo(seed=seed)
    if fmt == "vpu":
        packed = pack(coo, cfg, impl="numpy")
    elif fmt == "mxu":
        packed = pack_mxu(coo, cfg, impl="numpy")
    elif fmt == "ell":
        from sextans_tpu.format.pack_ell import pack_ell

        packed = pack_ell(coo, cfg)
    else:
        packed = pack_edge(coo, cfg)
    slots = slot_map(coo, cfg, fmt)
    assert slots.shape == (coo.nnz,)
    got = _scatter(slots, coo.vals, packed.vals.shape)
    np.testing.assert_array_equal(got, packed.vals)


def test_duplicates_sum_like_pack():
    coo = COOMatrix(
        (16, 16),
        rows=np.array([3, 3, 3], np.int32),
        cols=np.array([5, 5, 7], np.int32),
        vals=np.array([1.0, 2.0, 4.0], np.float32),
    )
    cfg = SpmmConfig(tile_m=16, window_k=16, block_k=8, group_blocks=16)
    packed = pack(coo, cfg, impl="numpy")
    slots = slot_map(coo, cfg, "vpu")
    got = _scatter(slots, coo.vals, packed.vals.shape)
    np.testing.assert_array_equal(got, packed.vals)


def test_reorder_cols_consistent():
    coo = _coo(seed=3)
    cfg = SpmmConfig(tile_m=64, window_k=64, block_k=8, group_blocks=16)
    packed = pack(coo, cfg, impl="numpy", reorder_cols=True)
    slots = slot_map(coo, cfg, "vpu", reorder_cols=True)
    got = _scatter(slots, coo.vals, packed.vals.shape)
    np.testing.assert_array_equal(got, packed.vals)
