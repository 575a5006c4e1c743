"""2-D degree reorder (row_perm + col_perm) correctness through SpmmPlan."""

import numpy as np
import pytest

from sextans_tpu.format.coo import COOMatrix
from sextans_tpu.format.csr import CSRMatrix
from sextans_tpu.format.pack import pack, reorder_rows
from sextans_tpu.format.pack_edge import pack_edge
from sextans_tpu.format.pack_mxu import pack_mxu
from sextans_tpu.ops.golden import golden_spmm
from sextans_tpu.ops.plan import SpmmPlan
from sextans_tpu.utils.config import SpmmConfig


def _powerlaw(m=400, k=300, nnz=4000, seed=0):
    rng = np.random.default_rng(seed)
    rp = rng.zipf(1.7, size=m).astype(np.float64)
    cp = rng.zipf(1.7, size=k).astype(np.float64)
    rows = rng.choice(m, size=nnz, p=rp / rp.sum()).astype(np.int32)
    cols = rng.choice(k, size=nnz, p=cp / cp.sum()).astype(np.int32)
    lin = rows.astype(np.int64) * k + cols
    _, keep = np.unique(lin, return_index=True)
    vals = rng.standard_normal(keep.size).astype(np.float32)
    vals[vals == 0] = 1.0
    return COOMatrix((m, k), rows[keep], cols[keep], vals)


def test_reorder_rows_is_a_permutation():
    coo = _powerlaw()
    re, rp = reorder_rows(coo)
    np.testing.assert_array_equal(np.sort(rp), np.arange(coo.shape[0]))
    # reordered[i, :] == coo[rp[i], :]
    d0 = coo.to_dense()
    d1 = re.to_dense()
    np.testing.assert_array_equal(d1, d0[rp])


@pytest.mark.parametrize("fmt,backend,cfg", [
    ("vpu", "xla",
     SpmmConfig(tile_m=64, window_k=64, block_k=8, group_blocks=16)),
    ("vpu", "auto",
     SpmmConfig(tile_m=64, window_k=64, block_k=4, group_blocks=32)),
    ("mxu", "mxu",
     SpmmConfig(tile_m=128, window_k=128, block_k=8, group_blocks=4)),
    ("edge", "edge",
     SpmmConfig(tile_m=64, window_k=64, edge_chunk=128)),
])
def test_reorder2d_matches_golden(fmt, backend, cfg):
    coo = _powerlaw(seed=5)
    m, k = coo.shape
    if fmt == "vpu":
        packed = pack(coo, cfg, reorder_cols=True, reorder_rows_=True)
    elif fmt == "mxu":
        packed = pack_mxu(coo, cfg, reorder_cols=True, reorder_rows_=True)
    else:
        packed = pack_edge(coo, cfg, reorder_cols=True, reorder_rows_=True)
    assert packed.row_perm is not None and packed.col_perm is not None
    plan = SpmmPlan(packed, 16, backend=backend)
    rng = np.random.default_rng(1)
    b = rng.standard_normal((k, 16)).astype(np.float32)
    c = rng.standard_normal((m, 16)).astype(np.float32)
    want = golden_spmm(CSRMatrix.from_coo(coo), b, 0.85, -2.06, c)
    got = np.asarray(plan(b, 0.85, -2.06, c))
    assert np.max(np.abs(got - want)) < 1e-4
    # beta=0 fast path (no-C kernel) must also unpermute
    want0 = golden_spmm(CSRMatrix.from_coo(coo), b, 1.0, 0.0, None)
    got0 = np.asarray(plan(b, 1.0, 0.0, None))
    assert np.max(np.abs(got0 - want0)) < 1e-4


def test_reorder2d_repeat_chain():
    coo = _powerlaw(seed=9)
    cfg = SpmmConfig(tile_m=64, window_k=64, block_k=8, group_blocks=16)
    packed = pack(coo, cfg, reorder_cols=True, reorder_rows_=True)
    plan = SpmmPlan(packed, 16, backend="xla")
    rng = np.random.default_rng(2)
    b = rng.standard_normal((coo.shape[1], 16)).astype(np.float32)
    c = rng.standard_normal((coo.shape[0], 16)).astype(np.float32)
    csr = CSRMatrix.from_coo(coo)
    want = c
    for _ in range(3):
        want = golden_spmm(csr, b, 0.85, -2.06, want)
    got = np.asarray(plan.repeat(b, 0.85, -2.06, c, times=3))
    assert np.max(np.abs(got - want)) < 1e-3


def test_reorder2d_improves_fill_on_powerlaw():
    """The point of the 2-D reorder: hub rows x hub cols cluster into
    denser blocks than either 1-D sort alone."""
    coo = _powerlaw(m=2000, k=2000, nnz=30000, seed=3)
    cfg = SpmmConfig(tile_m=64, window_k=256, block_k=8, group_blocks=16)
    base = pack(coo, cfg).stats.block_fill
    cols1d = pack(coo, cfg, reorder_cols=True).stats.block_fill
    both = pack(coo, cfg, reorder_cols=True, reorder_rows_=True).stats.block_fill
    assert both > base
    assert both >= cols1d


def test_row_perm_save_load_roundtrip(tmp_path):
    coo = _powerlaw(seed=11)
    cfg = SpmmConfig(tile_m=64, window_k=64, block_k=8, group_blocks=16)
    packed = pack(coo, cfg, reorder_cols=True, reorder_rows_=True)
    f = tmp_path / "p.npz"
    packed.save(f)
    from sextans_tpu.format.pack import PackedSpMatrix

    loaded = PackedSpMatrix.load(f)
    np.testing.assert_array_equal(loaded.row_perm, packed.row_perm)
    np.testing.assert_array_equal(loaded.col_perm, packed.col_perm)
