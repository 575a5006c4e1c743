"""Multi-device row-block sharded SpMM tests on the virtual 8-CPU mesh
(the `hwsim` analog — SURVEY.md §4)."""

import jax
import numpy as np
import pytest

from sextans_tpu.format.coo import COOMatrix
from sextans_tpu.format.csr import CSRMatrix
from sextans_tpu.ops.golden import golden_spmm_exact
from sextans_tpu.parallel.partition import pack_sharded
from sextans_tpu.parallel.sharding import make_mesh, spmm_sharded
from sextans_tpu.utils.config import SpmmConfig

CFG = SpmmConfig(tile_m=32, window_k=128, block_k=8, group_blocks=16)


def _problem(m, k, n, nnz, seed=0):
    coo = COOMatrix.random(m, k, nnz, seed=seed)
    rng = np.random.default_rng(seed + 1)
    b = rng.standard_normal((k, n)).astype(np.float32)
    c = rng.standard_normal((m, n)).astype(np.float32)
    return coo, b, c


def test_eight_devices_available():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_sharded_matches_golden(n_shards):
    coo, b, c = _problem(300, 200, 64, 3000, seed=n_shards)
    sharded = pack_sharded(coo, n_shards, CFG)
    want = golden_spmm_exact(CSRMatrix.from_coo(coo), b, 0.85, -2.06, c)
    got = np.asarray(
        spmm_sharded(sharded, b, 0.85, -2.06, c, backend="xla")
    )
    assert got.shape == (300, 64)
    assert np.max(np.abs(got - want)) < 1e-4


def test_sharded_uneven_rows():
    """M not divisible by shard count — padding slabs must stay silent."""
    coo, b, c = _problem(173, 97, 16, 900, seed=3)
    sharded = pack_sharded(coo, 8, CFG)
    want = golden_spmm_exact(CSRMatrix.from_coo(coo), b, 2.0, 0.5, c)
    got = np.asarray(spmm_sharded(sharded, b, 2.0, 0.5, c, backend="xla"))
    assert np.max(np.abs(got - want)) < 1e-4


def test_sharded_empty_shard():
    """All nonzeros in the first rows — later shards are pure epilogue."""
    coo = COOMatrix(
        (256, 64),
        rows=np.array([0, 1, 2], dtype=np.int32),
        cols=np.array([0, 5, 9], dtype=np.int32),
        vals=np.array([1.0, 2.0, 3.0], dtype=np.float32),
    )
    rng = np.random.default_rng(0)
    b = rng.standard_normal((64, 8)).astype(np.float32)
    c = rng.standard_normal((256, 8)).astype(np.float32)
    sharded = pack_sharded(coo, 4, CFG)
    want = golden_spmm_exact(CSRMatrix.from_coo(coo), b, 1.0, -1.0, c)
    got = np.asarray(spmm_sharded(sharded, b, 1.0, -1.0, c, backend="xla"))
    assert np.max(np.abs(got - want)) < 1e-5


def test_output_row_sharded():
    """Result C rows must land on the device owning the A row slab."""
    coo, b, c = _problem(256, 128, 16, 1500, seed=11)
    sharded = pack_sharded(coo, 8, CFG)
    mesh = make_mesh(8)
    out = spmm_sharded(sharded, b, 1.0, 0.0, mesh=mesh, backend="xla")
    # before slicing to (m, n) the result is row-sharded; slicing keeps it
    assert len(out.devices()) == 8


def test_mesh_size_mismatch_raises():
    coo, b, _ = _problem(64, 64, 8, 200, seed=5)
    sharded = pack_sharded(coo, 4, CFG)
    with pytest.raises(ValueError, match="mesh"):
        spmm_sharded(sharded, b, mesh=make_mesh(2), backend="xla")


# ---- K-sharded (reduce-scatter) formulation ----

from sextans_tpu.parallel.partition import pack_sharded_k
from sextans_tpu.parallel.sharding import spmm_sharded_k


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_k_sharded_matches_golden(n_shards):
    coo, b, c = _problem(300, 520, 32, 4000, seed=40 + n_shards)
    sharded = pack_sharded_k(coo, n_shards, CFG)
    assert sharded.mode == "col"
    want = golden_spmm_exact(CSRMatrix.from_coo(coo), b, 0.85, -2.06, c)
    got = np.asarray(spmm_sharded_k(sharded, b, 0.85, -2.06, c, backend="xla"))
    assert got.shape == (300, 32)
    assert np.max(np.abs(got - want)) < 1e-4


def test_k_sharded_uneven_k():
    """K not divisible by shards — empty column slabs must contribute zero."""
    coo, b, c = _problem(100, 130, 16, 800, seed=77)
    sharded = pack_sharded_k(coo, 8, CFG)
    want = golden_spmm_exact(CSRMatrix.from_coo(coo), b, 1.0, 1.0, c)
    got = np.asarray(spmm_sharded_k(sharded, b, 1.0, 1.0, c, backend="xla"))
    assert np.max(np.abs(got - want)) < 1e-4


def test_k_sharded_rejects_row_pack():
    coo, b, _ = _problem(64, 64, 8, 300, seed=9)
    sharded = pack_sharded(coo, 2, CFG)
    with pytest.raises(ValueError, match="pack_sharded_k"):
        spmm_sharded_k(sharded, b, backend="xla")


def test_sharded_plan_reuse():
    from sextans_tpu.parallel.sharding import ShardedSpmmPlan

    coo, b, c = _problem(128, 96, 16, 1000, seed=60)
    sharded = pack_sharded(coo, 4, CFG)
    plan = ShardedSpmmPlan(sharded, 16, backend="xla")
    want = golden_spmm_exact(CSRMatrix.from_coo(coo), b, 1.5, -0.5, c)
    got1 = np.asarray(plan(b, 1.5, -0.5, c))
    got2 = np.asarray(plan(b * 2, 1.5, -0.5, c))
    assert np.max(np.abs(got1 - want)) < 1e-4
    # second call reuses the compiled program with new operands
    want2 = golden_spmm_exact(CSRMatrix.from_coo(coo), b * 2, 1.5, -0.5, c)
    assert np.max(np.abs(got2 - want2)) < 1e-4
    with pytest.raises(ValueError, match="row"):
        ShardedSpmmPlan(pack_sharded_k(coo, 4, CFG), 16, backend="xla")


# ---- sharded engine choice, repeat loops, K-shard plan ----

def test_row_sharded_pallas_interpret_under_shard_map():
    """The engine ``backend="auto"`` picks, under shard_map on the CPU
    mesh."""
    coo, b, c = _problem(300, 200, 32, 3000, seed=11)
    sharded = pack_sharded(coo, 4, CFG)
    want = golden_spmm_exact(CSRMatrix.from_coo(coo), b, 0.85, -2.06, c)
    got = np.asarray(
        spmm_sharded(sharded, b, 0.85, -2.06, c, backend="auto")
    )
    assert np.max(np.abs(got - want)) < 1e-4


def test_k_sharded_pallas_interpret_under_shard_map():
    from sextans_tpu.parallel.partition import pack_sharded_k
    from sextans_tpu.parallel.sharding import spmm_sharded_k

    coo, b, c = _problem(200, 500, 32, 4000, seed=12)
    sharded = pack_sharded_k(coo, 4, CFG)
    want = golden_spmm_exact(CSRMatrix.from_coo(coo), b, 0.85, -2.06, c)
    got = np.asarray(
        spmm_sharded_k(sharded, b, 0.85, -2.06, c, backend="auto")
    )
    assert np.max(np.abs(got - want)) < 1e-4


def test_row_sharded_repeat_chains():
    from sextans_tpu.parallel.sharding import ShardedSpmmPlan

    coo, b, c = _problem(300, 200, 16, 2500, seed=13)
    sharded = pack_sharded(coo, 4, CFG)
    plan = ShardedSpmmPlan(sharded, 16, backend="xla")
    one = np.asarray(plan(b, 0.5, 0.25, c))
    two = np.asarray(plan(b, 0.5, 0.25, one))
    chained = np.asarray(plan.repeat(b, 0.5, 0.25, c, times=2))
    np.testing.assert_allclose(chained, two, rtol=1e-5, atol=1e-5)


def test_k_sharded_plan_device_resident_and_repeat():
    from sextans_tpu.parallel.partition import pack_sharded_k
    from sextans_tpu.parallel.sharding import ShardedSpmmPlanK, spmm_sharded_k

    coo, b, c = _problem(200, 500, 16, 3000, seed=14)
    sharded = pack_sharded_k(coo, 4, CFG)
    plan = ShardedSpmmPlanK(sharded, 16, backend="xla")
    want = golden_spmm_exact(CSRMatrix.from_coo(coo), b, 0.85, -2.06, c)
    got = np.asarray(plan(b, 0.85, -2.06, c))
    assert np.max(np.abs(got - want)) < 1e-4
    # repeat chain == two sequential applications
    one = np.asarray(plan(b, 0.5, 0.25, c))
    two = np.asarray(plan(b, 0.5, 0.25, one))
    chained = np.asarray(plan.repeat(b, 0.5, 0.25, c, times=2))
    np.testing.assert_allclose(chained, two, rtol=1e-5, atol=1e-5)
    # the one-shot wrapper reuses one plan per (n, backend, mesh) key
    spmm_sharded_k(sharded, b, 0.85, -2.06, c, backend="xla")
    spmm_sharded_k(sharded, b, 1.0, 0.0, None, backend="xla")
    assert len(sharded._plan_cache) == 1


def test_k_sharded_plan_rejects_row_pack():
    from sextans_tpu.parallel.sharding import ShardedSpmmPlanK

    coo, b, c = _problem(100, 100, 16, 500, seed=15)
    sharded = pack_sharded(coo, 2, CFG)
    with pytest.raises(ValueError, match="pack_sharded_k"):
        ShardedSpmmPlanK(sharded, 16)


def test_row_sharded_mxu_format():
    """Dense-slab format under shard_map on the CPU mesh."""
    from sextans_tpu.parallel.partition import pack_sharded
    from sextans_tpu.parallel.sharding import ShardedSpmmPlan

    cfg = SpmmConfig(tile_m=128, window_k=128, block_k=8, group_blocks=8)
    coo, b, c = _problem(300, 200, 32, 3000, seed=21)
    sharded = pack_sharded(coo, 4, cfg, fmt="mxu")
    assert sharded.fmt == "mxu"
    plan = ShardedSpmmPlan(sharded, 32)  # auto -> the slab engine
    assert plan.backend == "mxu"
    want = golden_spmm_exact(CSRMatrix.from_coo(coo), b, 0.85, -2.06, c)
    got = np.asarray(plan(b, 0.85, -2.06, c))
    assert np.max(np.abs(got - want)) < 1e-4


def test_k_sharded_mxu_format():
    from sextans_tpu.parallel.partition import pack_sharded_k
    from sextans_tpu.parallel.sharding import ShardedSpmmPlanK

    cfg = SpmmConfig(tile_m=128, window_k=128, block_k=8, group_blocks=8)
    coo, b, c = _problem(200, 500, 32, 3000, seed=22)
    sharded = pack_sharded_k(coo, 4, cfg, fmt="mxu")
    plan = ShardedSpmmPlanK(sharded, 32)
    want = golden_spmm_exact(CSRMatrix.from_coo(coo), b, 0.85, -2.06, c)
    got = np.asarray(plan(b, 0.85, -2.06, c))
    assert np.max(np.abs(got - want)) < 1e-4


def test_sharded_format_backend_mismatch():
    from sextans_tpu.parallel.partition import pack_sharded
    from sextans_tpu.parallel.sharding import ShardedSpmmPlan

    coo, b, c = _problem(100, 100, 16, 500, seed=23)
    sharded = pack_sharded(coo, 2, CFG)  # vpu format
    with pytest.raises(ValueError, match="does not match"):
        ShardedSpmmPlan(sharded, 16, backend="mxu")


@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_edge_format_matches_golden(n_shards):
    """Row-block sharding of the edge format under shard_map on the CPU
    mesh."""
    from sextans_tpu.parallel.sharding import ShardedSpmmPlan

    cfg = SpmmConfig(tile_m=32, window_k=128, edge_chunk=64)
    coo, b, c = _problem(300, 200, 128, 3000, seed=40 + n_shards)
    sharded = pack_sharded(coo, n_shards, cfg, fmt="edge")
    plan = ShardedSpmmPlan(sharded, 128, backend="edge")
    want = golden_spmm_exact(CSRMatrix.from_coo(coo), b, 0.85, -2.06, c)
    got = np.asarray(plan(b, 0.85, -2.06, c))
    assert np.max(np.abs(got - want)) < 1e-4


@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_ell_format_matches_golden(n_shards):
    """Row-block sharding of the ELL gather format: pure-XLA engine under
    shard_map on the CPU mesh, incl. hub rows split into virtual rows on
    some shards only (fold-table padding must stay exact)."""
    from sextans_tpu.parallel.sharding import ShardedSpmmPlan

    cfg = SpmmConfig(tile_m=32, ell_r=2)  # tiny R forces virtual rows
    coo, b, c = _problem(300, 200, 64, 3000, seed=50 + n_shards)
    sharded = pack_sharded(coo, n_shards, cfg, fmt="ell")
    assert sharded.fmt == "ell"
    plan = ShardedSpmmPlan(sharded, 64, backend="ell")
    want = golden_spmm_exact(CSRMatrix.from_coo(coo), b, 0.85, -2.06, c)
    got = np.asarray(plan(b, 0.85, -2.06, c))
    assert got.shape == (300, 64)
    assert np.max(np.abs(got - want)) < 1e-4
    # repeat chain
    got2 = np.asarray(plan.repeat(b, 0.5, 0.25, c, times=2))
    want2 = c
    for _ in range(2):
        want2 = golden_spmm_exact(
            CSRMatrix.from_coo(coo), b, 0.5, 0.25, want2
        ).astype(np.float32)
    assert np.max(np.abs(got2 - want2)) < 1e-4


@pytest.mark.parametrize("n_shards", [2, 8])
def test_k_sharded_ell_format_matches_golden(n_shards):
    """K-sharded ELL: each chip gathers from its own B K-slab, partials
    psum_scatter over the mesh; hub-row fold runs before the reduction."""
    from sextans_tpu.parallel.partition import pack_sharded_k
    from sextans_tpu.parallel.sharding import ShardedSpmmPlanK

    cfg = SpmmConfig(tile_m=32, window_k=128, ell_r=2)
    coo, b, c = _problem(300, 500, 64, 4000, seed=60 + n_shards)
    sharded = pack_sharded_k(coo, n_shards, cfg, fmt="ell")
    assert sharded.mode == "col" and sharded.fmt == "ell"
    plan = ShardedSpmmPlanK(sharded, 64, backend="ell")
    want = golden_spmm_exact(CSRMatrix.from_coo(coo), b, 0.85, -2.06, c)
    got = np.asarray(plan(b, 0.85, -2.06, c))
    assert got.shape == (300, 64)
    assert np.max(np.abs(got - want)) < 1e-4
    got2 = np.asarray(plan.repeat(b, 0.5, 0.25, c, times=2))
    want2 = c
    for _ in range(2):
        want2 = golden_spmm_exact(
            CSRMatrix.from_coo(coo), b, 0.5, 0.25, want2
        ).astype(np.float32)
    assert np.max(np.abs(got2 - want2)) < 1e-4


def test_sharded_ell_gate_is_global_not_per_shard():
    """A skewed matrix that packs fine globally must shard-pack fine too:
    the inflation gate runs once on the global (row-shard) / joint
    per-shard (K-shard) degree histogram, not per shard-local slab — a
    nearly-empty row slab or K slab previously raised the pack_ell
    inflation ValueError on exactly the power-law inputs ELL targets
    (round-3 advisor, parallel/partition.py)."""
    from sextans_tpu.parallel.partition import pack_sharded_k

    rng = np.random.default_rng(7)
    m = k = 40_000
    # all mass in the FIRST row slab / FIRST K slab; the rest nearly empty
    nnz = 120_000
    rows = np.concatenate([
        rng.integers(0, m // 8, nnz - 64),
        rng.integers(m // 8, m, 64),  # a few strays in the empty slabs
    ]).astype(np.int64)
    cols = np.concatenate([
        rng.integers(0, k // 8, nnz - 64),
        rng.integers(k // 8, k, 64),
    ]).astype(np.int64)
    order = np.lexsort((cols, rows))
    coo = COOMatrix((m, k), rows[order], cols[order],
                    rng.standard_normal(nnz).astype(np.float32))
    cfg = SpmmConfig(tile_m=128, window_k=4096)
    # global pack is fine (gate would pass): sharded packs must not raise
    for sharded in (
        pack_sharded(coo, 8, cfg, fmt="ell"),
        pack_sharded_k(coo, 8, cfg, fmt="ell"),
    ):
        assert sharded.fmt == "ell"
    # and a matrix whose GLOBAL histogram violates the gate still raises
    m2 = 2_000_000
    coo2 = COOMatrix(
        (m2, 64),
        np.arange(0, m2, 13, dtype=np.int64),
        np.zeros((m2 + 12) // 13, np.int64),
        np.ones((m2 + 12) // 13, np.float32),
    )
    with pytest.raises(ValueError, match="inflation"):
        pack_sharded(coo2, 8, SpmmConfig(tile_m=128, ell_r=8), fmt="ell")


def test_k_sharded_edge_format_matches_golden():
    """K-sharded edge format: psum_scatter of C partials on the CPU mesh."""
    from sextans_tpu.parallel.sharding import ShardedSpmmPlanK
    from sextans_tpu.parallel.partition import pack_sharded_k

    cfg = SpmmConfig(tile_m=32, window_k=128, edge_chunk=64)
    coo, b, c = _problem(256, 300, 128, 3000, seed=51)
    sharded = pack_sharded_k(coo, 4, cfg, fmt="edge")
    plan = ShardedSpmmPlanK(sharded, 128, backend="edge")
    want = golden_spmm_exact(CSRMatrix.from_coo(coo), b, 0.85, -2.06, c)
    got = np.asarray(plan(b, 0.85, -2.06, c))
    assert np.max(np.abs(got - want)) < 1e-4


# ---- nnz-balanced (LPT tile-assigned) row sharding ----


def _powerlaw(m, k, nnz, seed=0):
    """Skewed rows: a few row-tiles hold most of the nonzeros."""
    rng = np.random.default_rng(seed)
    pop = rng.zipf(1.6, size=m).astype(np.float64)
    pop /= pop.sum()
    rows = rng.choice(m, size=nnz, p=pop).astype(np.int32)
    cols = rng.integers(0, k, size=nnz).astype(np.int32)
    lin = rows.astype(np.int64) * k + cols
    _, keep = np.unique(lin, return_index=True)
    vals = rng.standard_normal(keep.size).astype(np.float32)
    vals[vals == 0] = 1.0
    return COOMatrix((m, k), rows[keep], cols[keep], vals)


@pytest.mark.parametrize("fmt,backend", [
    ("vpu", "xla"), ("mxu", "mxu"), ("edge", "edge"),
    ("ell", "ell"),
])
def test_balanced_matches_golden(fmt, backend):
    cfg = CFG.with_(tile_m=128) if fmt == "mxu" else CFG
    coo, b, c = _problem(300, 200, 64, 3000, seed=11)
    sharded = pack_sharded(coo, 4, cfg, fmt=fmt, balance="nnz")
    assert sharded.tile_assign is not None
    # tile_assign is a permutation of all padded tiles
    flat = np.sort(sharded.tile_assign.reshape(-1))
    np.testing.assert_array_equal(flat, np.arange(flat.size))
    want = golden_spmm_exact(CSRMatrix.from_coo(coo), b, 0.85, -2.06, c)
    got = np.asarray(
        spmm_sharded(sharded, b, 0.85, -2.06, c, backend=backend)
    )
    assert np.max(np.abs(got - want)) < 1e-4


def test_balanced_beats_contiguous_on_powerlaw():
    """VERDICT round-2 item 4: shard-imbalance ratio <= 1.2x on a skewed
    matrix where contiguous slabs are badly imbalanced."""
    coo = _powerlaw(4096, 512, 60000, seed=7)
    cfg = CFG.with_(tile_m=64)
    cont = pack_sharded(coo, 8, cfg, balance="contiguous")
    bal = pack_sharded(coo, 8, cfg, balance="nnz")
    assert bal.shard_nnz.sum() == coo.nnz == cont.shard_nnz.sum()
    assert bal.nnz_imbalance <= 1.2
    assert bal.nnz_imbalance <= cont.nnz_imbalance
    # balanced packing also bounds the padded group count (= kernel steps,
    # the real per-shard time) by the balance
    rng = np.random.default_rng(0)
    b = rng.standard_normal((512, 16)).astype(np.float32)
    c = rng.standard_normal((4096, 16)).astype(np.float32)
    want = golden_spmm_exact(CSRMatrix.from_coo(coo), b, 1.5, -0.5, c)
    got = np.asarray(spmm_sharded(bal, b, 1.5, -0.5, c, backend="xla"))
    assert np.max(np.abs(got - want)) < 1e-4


def test_balanced_repeat_chain():
    from sextans_tpu.parallel.sharding import ShardedSpmmPlan

    coo, b, c = _problem(300, 200, 32, 2500, seed=13)
    sharded = pack_sharded(coo, 4, CFG, balance="nnz")
    plan = ShardedSpmmPlan(sharded, 32, backend="xla")
    csr = CSRMatrix.from_coo(coo)
    want = c
    for _ in range(3):
        want = golden_spmm_exact(csr, b, 0.85, -2.06, want).astype(np.float32)
    got = np.asarray(plan.repeat(b, 0.85, -2.06, c, times=3))
    assert np.max(np.abs(got - want)) < 1e-3


def test_balance_rejects_unknown():
    coo, _, _ = _problem(64, 64, 8, 100)
    with pytest.raises(ValueError, match="balance"):
        pack_sharded(coo, 2, CFG, balance="rows")
