"""Shape-generic serving (ops/serve.py): the "one bitstream" analog.

The reference runs arbitrary matrix sizes on one compiled bitstream
(src/sextans.h:20-26 — sizes are kernel arguments). Here: a second,
never-seen matrix in the same shape bucket must reuse the first's
compiled kernel — asserted via the kernel jit's cache size, not timing.
"""

import numpy as np
import pytest

from sextans_tpu.format.coo import COOMatrix
from sextans_tpu.format.csr import CSRMatrix
from sextans_tpu.ops.golden import golden_spmm_exact
from sextans_tpu.ops.serve import SpmmServer, bucket_up, bucketize_pack
from sextans_tpu.utils.config import SpmmConfig

CFG = SpmmConfig(tile_m=64, window_k=256, block_k=8, group_blocks=16)


def _coo(m, k, nnz, seed):
    rng = np.random.default_rng(seed)
    lin = rng.choice(m * k, size=nnz, replace=False).astype(np.int64)
    return COOMatrix(
        (m, k), (lin // k).astype(np.int32), (lin % k).astype(np.int32),
        rng.standard_normal(nnz).astype(np.float32),
    )


def test_bucket_up_series():
    assert bucket_up(1) == 1
    assert bucket_up(5) == 5  # 1,2,3,4,5 are all buckets early on
    b = bucket_up(1000)
    assert b >= 1000
    # geometric growth: the next bucket is <= 25% above
    assert b <= int(np.ceil(1000 * 1.25))
    assert bucket_up(b) == b  # idempotent on bucket values


def test_bucketize_pack_preserves_product():
    from sextans_tpu.format.pack import pack

    coo = _coo(200, 300, 2500, seed=0)
    packed = pack(coo, CFG)
    bucketed = bucketize_pack(packed)
    assert bucketed.n_groups >= packed.n_groups
    assert bucketed.n_mtiles >= packed.n_mtiles
    assert bucketed.n_kwins >= packed.n_kwins
    # padded groups must contribute zeros: run both through the plan
    from sextans_tpu.ops.plan import SpmmPlan

    rng = np.random.default_rng(1)
    b = rng.standard_normal((300, 16)).astype(np.float32)
    c = rng.standard_normal((200, 16)).astype(np.float32)
    base = np.asarray(SpmmPlan(packed, 16, backend="xla")(b, 0.85, -2.06, c))
    buck = np.asarray(SpmmPlan(bucketed, 16, backend="xla")(b, 0.85, -2.06, c))
    np.testing.assert_allclose(base, buck, rtol=0, atol=1e-5)


@pytest.mark.parametrize("fmt,backend", [("vpu", "xla")])
def test_server_correct_and_zero_recompile(fmt, backend):
    server = SpmmServer(16, config=CFG, fmt=fmt, backend=backend)
    # two DIFFERENT matrices with different (m, k, nnz) in one bucket
    coo1 = _coo(190, 280, 2400, seed=2)
    coo2 = _coo(185, 295, 2500, seed=3)
    rng = np.random.default_rng(4)

    from sextans_tpu.ops.spmm_xla import spmm_xla_padded

    p1 = server.plan(coo1)
    assert p1.bucket_new
    b1 = rng.standard_normal((280, 16)).astype(np.float32)
    c1 = rng.standard_normal((190, 16)).astype(np.float32)
    got1 = p1(b1, 0.85, -2.06, c1)
    want1 = golden_spmm_exact(CSRMatrix.from_coo(coo1), b1, 0.85, -2.06, c1)
    assert np.abs(got1 - want1).max() < 1e-4
    cache_after_first = spmm_xla_padded._cache_size()

    p2 = server.plan(coo2)
    assert not p2.bucket_new  # same bucket family
    b2 = rng.standard_normal((295, 16)).astype(np.float32)
    c2 = rng.standard_normal((185, 16)).astype(np.float32)
    got2 = p2(b2, 0.85, -2.06, c2)
    want2 = golden_spmm_exact(CSRMatrix.from_coo(coo2), b2, 0.85, -2.06, c2)
    assert np.abs(got2 - want2).max() < 1e-4
    # THE property: serving the second matrix compiled nothing new
    assert spmm_xla_padded._cache_size() == cache_after_first


def test_server_pallas_interpret_rejected():
    # a backend that is not an engine of the format is refused
    with pytest.raises(ValueError):
        SpmmServer(16, config=CFG, fmt="mxu", backend="mxu_interpret")
    # auto on the CPU test platform: the plain-XLA engine of each format
    assert SpmmServer(16, config=CFG, fmt="ell").backend == "ell"
    assert SpmmServer(16, config=CFG, fmt="mxu").backend == "mxu"
    with pytest.raises(ValueError):
        SpmmServer(16, config=CFG, fmt="bogus")


def test_server_beta_zero_and_shape_errors():
    server = SpmmServer(16, config=CFG, backend="xla")
    coo = _coo(100, 120, 800, seed=6)
    p = server.plan(coo)
    rng = np.random.default_rng(7)
    b = rng.standard_normal((120, 16)).astype(np.float32)
    got = p(b, 2.0, 0.0)
    want = golden_spmm_exact(CSRMatrix.from_coo(coo), b, 2.0, 0.0, None)
    assert np.abs(got - want).max() < 1e-4
    with pytest.raises(ValueError):
        p(b[:50])
    with pytest.raises(ValueError):
        p(b, 1.0, 1.0, None)


def test_server_edge_format_buckets():
    """Edge-format packs bucketize on chunk count: two near-size matrices
    share a bucket, and the second is served correctly with zero
    recompiles of the edge engine."""
    from sextans_tpu.ops.spmm_xla import spmm_edge_padded

    cfg = SpmmConfig(tile_m=64, window_k=256, edge_chunk=256)
    server = SpmmServer(16, config=cfg, fmt="edge")
    assert server.backend == "edge"
    coo1 = _coo(100, 120, 800, seed=8)
    coo2 = _coo(101, 121, 810, seed=9)
    rng = np.random.default_rng(10)
    p1 = server.plan(coo1)
    b1 = rng.standard_normal((120, 16)).astype(np.float32)
    c1 = rng.standard_normal((100, 16)).astype(np.float32)
    got1 = p1(b1, 0.85, -2.06, c1)
    want1 = golden_spmm_exact(CSRMatrix.from_coo(coo1), b1, 0.85, -2.06, c1)
    assert np.abs(got1 - want1).max() < 1e-4
    cache_after_first = spmm_edge_padded._cache_size()
    p2 = server.plan(coo2)
    assert not p2.bucket_new
    assert server.bucket_signature(p1.packed) == server.bucket_signature(
        p2.packed
    )
    b2 = rng.standard_normal((121, 16)).astype(np.float32)
    got2 = p2(b2, 1.0, 0.0)
    want2 = golden_spmm_exact(CSRMatrix.from_coo(coo2), b2, 1.0, 0.0, None)
    assert np.abs(got2 - want2).max() < 1e-4
    assert spmm_edge_padded._cache_size() == cache_after_first


def _coo_fixed_degree(m, k, deg, seed):
    """Every row has exactly ``deg`` nonzeros — keeps n_virt=0 at R>=deg."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(m, dtype=np.int32), deg)
    cols = np.concatenate(
        [rng.choice(k, size=deg, replace=False) for _ in range(m)]
    ).astype(np.int32)
    return COOMatrix(
        (m, k), rows, cols,
        rng.standard_normal(m * deg).astype(np.float32),
    )


def test_server_ell_correct_and_zero_recompile():
    """ELL serving: two near-size low-degree matrices must land in one
    bucket and share the compiled engine."""
    cfg = SpmmConfig(tile_m=64, ell_r=4)
    server = SpmmServer(16, config=cfg, fmt="ell", backend="ell")
    # 180 and 183 both bucket to 185 rows; 280 and 285 both to K=290
    coo1 = _coo_fixed_degree(180, 280, 3, seed=11)
    coo2 = _coo_fixed_degree(183, 285, 3, seed=12)
    rng = np.random.default_rng(13)

    from sextans_tpu.ops.spmm_ell_xla import spmm_ell_padded

    p1 = server.plan(coo1)
    assert p1.bucket_new
    b1 = rng.standard_normal((280, 16)).astype(np.float32)
    c1 = rng.standard_normal((180, 16)).astype(np.float32)
    got1 = p1(b1, 0.85, -2.06, c1)
    want1 = golden_spmm_exact(CSRMatrix.from_coo(coo1), b1, 0.85, -2.06, c1)
    assert np.abs(got1 - want1).max() < 1e-4
    cache_after_first = spmm_ell_padded._cache_size()

    p2 = server.plan(coo2)
    assert not p2.bucket_new
    b2 = rng.standard_normal((285, 16)).astype(np.float32)
    c2 = rng.standard_normal((183, 16)).astype(np.float32)
    got2 = p2(b2, 0.85, -2.06, c2)
    want2 = golden_spmm_exact(CSRMatrix.from_coo(coo2), b2, 0.85, -2.06, c2)
    assert np.abs(got2 - want2).max() < 1e-4
    assert spmm_ell_padded._cache_size() == cache_after_first


def test_server_ell_hub_rows_fold_with_bucket_padding():
    """A power-law matrix with hub rows: virtual-row count gets bucket-
    padded, and pad folds (0.0 into the last real fold target, keeping
    fold_rows ascending for the engine's sorted scatter-add) must not
    perturb the product."""
    cfg = SpmmConfig(tile_m=64, ell_r=2)
    m, k = 150, 200
    rng = np.random.default_rng(21)
    rows = [np.repeat(np.arange(m, dtype=np.int32), 2)]
    cols = [np.tile(rng.choice(k, size=2, replace=False), m).astype(np.int32)]
    # three hub rows of degree 40 -> 20 chunks each at R=2 -> 57 virt rows
    for hub in (5, 70, 140):
        rows.append(np.full(40, hub, dtype=np.int32))
        cols.append(rng.choice(k, size=40, replace=False).astype(np.int32))
    rr = np.concatenate(rows)
    cc = np.concatenate(cols)
    lin = rr.astype(np.int64) * k + cc
    _, keep = np.unique(lin, return_index=True)
    coo = COOMatrix(
        (m, k), rr[keep], cc[keep],
        rng.standard_normal(keep.size).astype(np.float32),
    )
    server = SpmmServer(16, config=cfg, fmt="ell", backend="ell")
    p = server.plan(coo)
    packed = p.packed
    assert packed.n_virt > 0
    # fold_rows stays ascending after bucket padding (sorted scatter-add)
    assert np.all(np.diff(packed.fold_rows) >= 0)
    b = rng.standard_normal((k, 16)).astype(np.float32)
    c = rng.standard_normal((m, 16)).astype(np.float32)
    got = p(b, 0.85, -2.06, c)
    want = golden_spmm_exact(CSRMatrix.from_coo(coo), b, 0.85, -2.06, c)
    assert np.abs(got - want).max() < 1e-4


def test_server_ell_pallas_backend_rejected():
    with pytest.raises(ValueError):
        SpmmServer(16, config=SpmmConfig(ell_r=4), fmt="ell",
                   backend="ell_pallas")


def test_serveplan_rejects_reordered_pack():
    """A degree-reordered pack needs B[col_perm]/C[row_perm] plumbing that
    only SpmmPlan has — ServePlan must refuse it rather than serve silently
    wrong values (and bucket padding must not drop the perm record)."""
    from sextans_tpu.format.pack import pack
    from sextans_tpu.ops.serve import ServePlan

    coo = _coo(96, 512, 600, seed=31)
    packed = pack(coo, CFG, reorder_cols=True)
    assert packed.col_perm is not None
    bucketed = bucketize_pack(packed)
    # _pad_shard_groups must carry the permutation through the padding
    assert bucketed.col_perm is not None
    with pytest.raises(ValueError, match="reordered"):
        ServePlan(bucketed, 16, backend="xla")
