"""Randomized cross-config stress: pack + both backends vs golden across a
spread of shapes, densities, and tiling configs (seeded, deterministic)."""

import numpy as np
import pytest

from sextans_tpu.format.coo import COOMatrix
from sextans_tpu.format.csr import CSRMatrix
from sextans_tpu.ops.golden import golden_spmm_exact
from sextans_tpu.ops.spmm import spmm
from sextans_tpu.utils.config import SpmmConfig


@pytest.mark.parametrize("trial", range(8))
def test_random_configs_and_shapes(trial):
    rng = np.random.default_rng(1000 + trial)
    m = int(rng.integers(1, 400))
    k = int(rng.integers(1, 400))
    n = int(rng.integers(1, 70))
    density = float(rng.uniform(0.001, 0.2))
    nnz = max(1, int(m * k * density))
    coo = COOMatrix.random(m, k, min(nnz, m * k // 2 + 1), seed=trial)

    bk = int(rng.choice([1, 2, 4, 8, 16]))
    tile_m = 8 * int(rng.integers(1, 9))
    window_k = bk * 8 * int(rng.integers(1, 6))
    chunk = max(1, 128 // bk)
    group_blocks = chunk * int(rng.integers(1, 5))
    cfg = SpmmConfig(
        tile_m=tile_m,
        window_k=window_k,
        block_k=bk,
        group_blocks=group_blocks,
        interleave=bool(rng.integers(0, 2)),
    )

    b = rng.standard_normal((k, n)).astype(np.float32)
    c = rng.standard_normal((m, n)).astype(np.float32)
    alpha = float(rng.normal())
    beta = float(rng.normal())

    want = golden_spmm_exact(CSRMatrix.from_coo(coo), b, alpha, beta, c)
    for backend in ("xla", "auto"):
        got = np.asarray(spmm(coo, b, alpha, beta, c, backend=backend, config=cfg))
        err = np.max(np.abs(got - want))
        scale = max(1.0, np.max(np.abs(want)))
        assert err < 1e-4 * scale, (
            f"trial={trial} backend={backend} cfg={cfg} err={err}"
        )
