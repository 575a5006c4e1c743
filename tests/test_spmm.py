"""End-to-end SpMM correctness: golden oracle vs the block engine, named and
chosen by ``backend="auto"``.

The acceptance gate mirrors the reference host verifier
(src/sextans-host.cpp:262-289) plus the stricter 1e-6 max-abs-error
north star vs a float64 oracle (BASELINE.md)."""

import numpy as np
import pytest

from sextans_tpu.format.coo import COOMatrix
from sextans_tpu.format.csr import CSRMatrix
from sextans_tpu.format.pack import pack
from sextans_tpu.ops.golden import golden_spmm, golden_spmm_exact
from sextans_tpu.ops.spmm import spmm
from sextans_tpu.utils.config import SpmmConfig
from sextans_tpu.utils.verify import verify

ALPHA, BETA = 0.85, -2.06  # reference defaults (src/sextans-host.cpp:29-30)

CFG = SpmmConfig(tile_m=64, window_k=128, block_k=8, group_blocks=16)


def _problem(m, k, n, nnz, seed=0, banded=False):
    coo = COOMatrix.random(m, k, nnz, seed=seed, banded=banded)
    rng = np.random.default_rng(seed + 1)
    b = rng.standard_normal((k, n)).astype(np.float32)
    c = rng.standard_normal((m, n)).astype(np.float32)
    return coo, b, c


def test_golden_matches_float64_oracle():
    coo, b, c = _problem(60, 80, 32, 400)
    csr = CSRMatrix.from_coo(coo)
    got = golden_spmm(csr, b, ALPHA, BETA, c)
    want = golden_spmm_exact(csr, b, ALPHA, BETA, c)
    assert np.max(np.abs(got - want)) < 1e-4


def test_golden_matches_dense():
    coo, b, c = _problem(33, 47, 8, 300, seed=3)
    csr = CSRMatrix.from_coo(coo)
    got = golden_spmm(csr, b, ALPHA, BETA, c)
    want = ALPHA * coo.to_dense().astype(np.float64) @ b.astype(np.float64) + BETA * c
    assert np.max(np.abs(got - want)) < 1e-3


@pytest.mark.parametrize("backend", ["xla", "auto"])
@pytest.mark.parametrize(
    "m,k,n,nnz,banded",
    [
        (60, 80, 32, 500, False),
        (64, 128, 128, 800, False),
        (100, 90, 16, 700, True),
        (130, 257, 100, 2000, False),  # ragged everything
        (8, 8, 8, 10, False),  # tiny
    ],
)
def test_backends_match_golden(backend, m, k, n, nnz, banded):
    coo, b, c = _problem(m, k, n, nnz, seed=m + n, banded=banded)
    csr = CSRMatrix.from_coo(coo)
    want = golden_spmm_exact(csr, b, ALPHA, BETA, c)
    got = np.asarray(spmm(coo, b, ALPHA, BETA, c, backend=backend, config=CFG))
    assert got.shape == (m, n)
    res = verify(want, got)
    assert res.passed, str(res)
    assert res.max_abs_err < 1e-4, str(res)


@pytest.mark.parametrize("backend", ["xla", "auto"])
def test_beta_zero_no_c(backend):
    coo, b, _ = _problem(50, 60, 24, 400, seed=9)
    csr = CSRMatrix.from_coo(coo)
    want = golden_spmm_exact(csr, b, 1.0, 0.0, None)
    got = np.asarray(spmm(coo, b, backend=backend, config=CFG))
    assert np.max(np.abs(got - want)) < 1e-5


@pytest.mark.parametrize("backend", ["xla", "auto"])
def test_alpha_beta_variants(backend):
    coo, b, c = _problem(40, 40, 16, 250, seed=17)
    csr = CSRMatrix.from_coo(coo)
    for alpha, beta in [(1.0, 0.0), (0.0, 1.0), (2.5, 0.5), (-1.0, 3.0)]:
        want = golden_spmm_exact(csr, b, alpha, beta, c)
        got = np.asarray(spmm(coo, b, alpha, beta, c, backend=backend, config=CFG))
        assert np.max(np.abs(got - want)) < 1e-4, (alpha, beta)


@pytest.mark.parametrize("block_k", [1, 2, 4, 8, 16])
def test_block_k_sweep(block_k):
    cfg = SpmmConfig(
        tile_m=32, window_k=128, block_k=block_k, group_blocks=128
    )
    coo, b, c = _problem(70, 130, 16, 900, seed=23)
    csr = CSRMatrix.from_coo(coo)
    want = golden_spmm_exact(csr, b, ALPHA, BETA, c)
    got = np.asarray(spmm(coo, b, ALPHA, BETA, c, backend="xla", config=cfg))
    assert np.max(np.abs(got - want)) < 1e-4


def test_empty_rows_get_beta_c():
    """Rows with no nonzeros must still produce beta*C (epilogue coverage)."""
    cfg = SpmmConfig(tile_m=16, window_k=64, block_k=8, group_blocks=16)
    coo = COOMatrix(
        (64, 64),
        rows=np.array([0], dtype=np.int32),
        cols=np.array([0], dtype=np.int32),
        vals=np.array([2.0], dtype=np.float32),
    )
    rng = np.random.default_rng(0)
    b = rng.standard_normal((64, 8)).astype(np.float32)
    c = rng.standard_normal((64, 8)).astype(np.float32)
    for backend in ("xla", "auto"):
        got = np.asarray(spmm(coo, b, ALPHA, BETA, c, backend=backend, config=cfg))
        want = golden_spmm_exact(CSRMatrix.from_coo(coo), b, ALPHA, BETA, c)
        assert np.max(np.abs(got - want)) < 1e-5, backend


def test_packed_reuse_across_n():
    """One packed matrix serves multiple N (A preprocessing is N-independent,
    like the reference's edge stream reused per N-slab)."""
    coo, b, c = _problem(60, 80, 32, 500, seed=31)
    packed = pack(coo, CFG)
    csr = CSRMatrix.from_coo(coo)
    for n in (8, 32, 100):
        bn = b[:, :1].repeat(n, axis=1) if n > b.shape[1] else b[:, :n]
        want = golden_spmm_exact(csr, bn, 1.0, 0.0, None)
        got = np.asarray(spmm(packed, bn, backend="xla"))
        assert np.max(np.abs(got - want)) < 1e-5


def test_nasa4704_end_to_end(nasa4704_path):
    """The reference's canonical swsim test: nasa4704 x N=16, alpha/beta defaults
    (CMakeLists.txt:48-51), B=1.0, C=(m+1)(n+1)/M/N (src/sextans-host.cpp:100-112)."""
    from sextans_tpu.io.mtx import read_mtx

    coo = read_mtx(nasa4704_path)
    m, k = coo.shape
    n = 16
    b = np.ones((k, n), dtype=np.float32)
    mm, nn = np.meshgrid(np.arange(m), np.arange(n), indexing="ij")
    c = ((mm + 1.0) * (nn + 1.0) / m / n).astype(np.float32)
    csr = CSRMatrix.from_coo(coo)
    want = golden_spmm_exact(csr, b, ALPHA, BETA, c)
    cfg = SpmmConfig(tile_m=512, window_k=2048, block_k=8, group_blocks=256)
    got = np.asarray(spmm(coo, b, ALPHA, BETA, c, backend="xla", config=cfg))
    res = verify(want, got)
    assert res.passed, str(res)
    assert res.max_abs_err < 1e-4


@pytest.mark.parametrize(
    "group_blocks,interleave", [(16, True), (32, False), (64, True), (128, False)]
)
def test_kernel_microarch_knobs(group_blocks, interleave):
    """Group size and stripe interleave change the packed order, never the
    result."""
    cfg = SpmmConfig(
        tile_m=64, window_k=128, block_k=8, group_blocks=group_blocks,
        interleave=interleave,
    )
    coo, b, c = _problem(100, 150, 16, 1200, seed=51)
    csr = CSRMatrix.from_coo(coo)
    want = golden_spmm_exact(csr, b, ALPHA, BETA, c)
    got = np.asarray(
        spmm(coo, b, ALPHA, BETA, c, backend="auto", config=cfg)
    )
    assert np.max(np.abs(got - want)) < 1e-4


def test_package_all_exports_resolve():
    """Every name in sextans_tpu.__all__ must be importable (round 5 added
    SpmmServer/ServePlan/bucketize_pack/ShardedHybridPlan at top level)."""
    import sextans_tpu as sx

    missing = [n for n in sx.__all__ if not hasattr(sx, n)]
    assert not missing, missing
    assert sx.SpmmServer is not None
    assert sx.ShardedHybridPlan is not None
