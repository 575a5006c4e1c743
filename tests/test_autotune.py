"""Autotuner tests (analytic mode, and measured mode on the CPU)."""

import numpy as np

from sextans_tpu.format.coo import COOMatrix
from sextans_tpu.utils.autotune import autotune, block_counts, choose_config
from sextans_tpu.utils.config import SpmmConfig


def test_block_counts_exact():
    # 3 nonzeros: (0,0), (0,7), (0,8) → bk=8: blocks {cols 0-7, 8-15} = 2;
    # bk=4: {0-3},{4-7},{8-11} = 3; bk=1: 3
    coo = COOMatrix(
        (8, 16),
        rows=np.array([0, 0, 0], np.int32),
        cols=np.array([0, 7, 8], np.int32),
        vals=np.ones(3, np.float32),
    )
    counts = block_counts(coo, (1, 4, 8, 16))
    assert counts[1] == 3
    assert counts[4] == 3
    assert counts[8] == 2
    assert counts[16] == 1


def test_choose_config_scattered_is_scalar_bound():
    """Fully scattered matrix: every nonzero is its own block at ANY bk, so
    wider blocks only gather more unused B rows — the byte model picks a
    narrow block (bk=1 pays more group padding, 128-block groups)."""
    coo = COOMatrix.random(4096, 4096, 8000, seed=1)  # ~0.05% density
    best = choose_config(coo, SpmmConfig())[0]
    assert best.config.block_k <= 2


def test_choose_config_prefers_big_bk_for_dense_band():
    """Dense band: blocks are full → larger bk amortizes per-block cost."""
    rows = np.repeat(np.arange(256, dtype=np.int32), 64)
    cols = (rows // 8 * 8 + np.tile(np.arange(64, dtype=np.int32) % 64, 256)) % 256
    coo = COOMatrix((256, 256), rows, cols % 256, np.ones(rows.size, np.float32))
    best = choose_config(coo, SpmmConfig())[0]
    assert best.config.block_k >= 8


def test_choose_config_valid_configs():
    coo = COOMatrix.random(500, 500, 5000, seed=3)
    for r in choose_config(coo, SpmmConfig(), top=5):
        # constructor validates; block_k/group_blocks consistency implied
        assert r.config.group_blocks % max(1, 128 // r.config.block_k) == 0
        assert r.predicted_cost > 0


def test_autotune_measured_cpu():
    coo = COOMatrix.random(300, 300, 3000, seed=5)
    cfg = SpmmConfig(tile_m=64, window_k=256)
    best = autotune(coo, 16, base=cfg, block_ks=(4, 8), candidates=2,
                    backend="xla", rp_time=2)
    assert best.measured_ms is not None and best.measured_ms > 0


# ---- MXU format autotuning (round 2) ----

def test_choose_config_mxu_valid():
    from sextans_tpu.utils.autotune import choose_config_mxu

    coo = COOMatrix.random(1000, 1000, 20000, seed=7, banded=True, bandwidth=200)
    for r in choose_config_mxu(coo, SpmmConfig(), top=4):
        assert r.fmt == "mxu"
        assert r.config.tile_m % 128 == 0
        assert r.config.block_k % 8 == 0
        assert r.config.window_k % r.config.block_k == 0
        assert r.predicted_cost > 0


def test_choose_backend_prefers_mxu_on_dense_band():
    """A dense-banded (FEM-like) matrix: deep 128-wide slabs are nearly as
    full as 8x8 blocks, so the MXU family should win the analytic ranking."""
    from sextans_tpu.utils.autotune import choose_backend

    coo = COOMatrix.random(2000, 2000, 200000, seed=8, banded=True, bandwidth=300)
    best = choose_backend(coo, n=512)[0]
    assert best.fmt == "mxu"


def test_choose_backend_prefers_gather_family_on_scattered():
    """Uniformly random low-degree sparse: 128-wide slabs are
    catastrophically empty (fill ~ nnz density), so the MXU dense-slab
    family must lose; the winner is a scatter-tolerant family — the ELL
    HBM-gather path (modeled bandwidth-bound, round 3) or the VPU 8x8
    block format."""
    from sextans_tpu.utils.autotune import choose_backend

    coo = COOMatrix.random(20000, 20000, 60000, seed=9)
    best = choose_backend(coo, n=512)[0]
    assert best.fmt in ("vpu", "ell", "edge")
