"""Per-shard byte model (parallel/ici_model.py) vs the compiled mesh
programs.

The correctness bar is structural: the byte terms the model predicts for
each shard mode must equal the collective shapes XLA actually compiles on
the 8-device virtual CPU mesh — row-shard steps contain NO ring
collectives, K-shard steps contain exactly the reduce-scatter the model
prices.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from sextans_tpu.format.coo import COOMatrix
from sextans_tpu.parallel.ici_model import (
    choose_sharded_config,
    collective_bytes,
    collective_shapes,
)
from sextans_tpu.parallel.partition import pack_sharded, pack_sharded_k
from sextans_tpu.parallel.sharding import ShardedSpmmPlan, ShardedSpmmPlanK
from sextans_tpu.utils.config import SpmmConfig

S = 8
CFG = SpmmConfig(tile_m=64, window_k=1024)


@pytest.fixture(scope="module")
def coo():
    return COOMatrix.random(1600, 1500, 24000, seed=21)


def _compiled_text(plan, b, c):
    args = (*plan._dev, jnp.asarray(b), jnp.asarray(c),
            jnp.float32(1.0), jnp.float32(0.5))
    return plan._jit.lower(*args).compile().as_text()


def test_k_shard_reduce_scatter_bytes_match_model(coo):
    n = 64
    sharded = pack_sharded_k(coo, S, CFG)
    plan = ShardedSpmmPlanK(sharded, n, backend="xla")
    rng = np.random.default_rng(0)
    b = rng.standard_normal((coo.shape[1], n)).astype(np.float32)
    c = rng.standard_normal((coo.shape[0], n)).astype(np.float32)
    colls = collective_shapes(_compiled_text(plan, b, c))
    rs = [x for x in colls if x["op"] == "reduce-scatter"]
    assert rs, f"K-shard step must contain a reduce-scatter, got {colls}"
    model = collective_bytes(
        "col", S, sharded.m_padded, S * sharded.k_padded, n
    )
    # the model prices per-chip ring traffic: operand bytes * (S-1)/S.
    # the compiled op's OUTPUT shard is operand/S; its operand is the full
    # partial — match on the full-operand element count
    operand_elems = sharded.m_padded * n
    total_rs_elems = sum(x["elems"] for x in rs)
    # reduce-scatter output is the per-chip slab: operand/S elements
    assert total_rs_elems in (operand_elems, operand_elems // S), (
        total_rs_elems, operand_elems)
    assert model["reduce-scatter"] == pytest.approx(
        operand_elems * 4.0 * (S - 1) / S
    )


def test_row_shard_step_has_no_ring_collectives(coo):
    n = 64
    sharded = pack_sharded(coo, S, CFG)
    plan = ShardedSpmmPlan(sharded, n, backend="xla")
    rng = np.random.default_rng(0)
    b = rng.standard_normal((coo.shape[1], n)).astype(np.float32)
    c = rng.standard_normal((coo.shape[0], n)).astype(np.float32)
    colls = collective_shapes(_compiled_text(plan, b, c))
    ring = [x for x in colls if x["op"] in ("reduce-scatter", "all-reduce")]
    assert not ring, f"row-shard step must not reduce over ICI: {ring}"
    model = collective_bytes("row", S, sharded.m_padded,
                             sharded.k_padded, n)
    assert set(model) == {"b_broadcast_ingest"}


def test_choose_sharded_config_uses_shard_local_stats():
    # 7 uniform low-degree shards + 1 dense-block shard: global stats say
    # one thing, the straggler shard another — the choice must report the
    # straggler and price the max shard, not the mean
    rng = np.random.default_rng(3)
    m, k = 1024, 1024
    rows_u = rng.integers(0, 896, 4000)
    cols_u = rng.integers(0, k, 4000)
    rows_d = np.repeat(np.arange(896, 1024), 256)
    cols_d = np.tile(rng.integers(0, k, 256), 128)
    coo = COOMatrix(
        (m, k),
        np.concatenate([rows_u, rows_d]).astype(np.int64),
        np.concatenate([cols_u, cols_d]).astype(np.int64),
        np.ones(4000 + 128 * 256, np.float32),
    )
    choice = choose_sharded_config(coo, 8, n=128, base=SpmmConfig(tile_m=64))
    assert len(choice["per_shard"]) == 8
    per_bytes = [p["bytes"] for p in choice["per_shard"]]
    assert choice["max_shard_bytes"] >= np.mean(per_bytes)
    assert sum(choice["votes"].values()) == 8


def test_choose_sharded_config_k_mode_slabs(coo):
    """K mode prices each device's column slab; every shard votes."""
    choice = choose_sharded_config(coo, 4, n=128, mode="col", base=CFG)
    assert len(choice["per_shard"]) == 4
    assert sum(choice["votes"].values()) == 4
    assert choice["max_shard_bytes"] == max(
        p["bytes"] for p in choice["per_shard"]
    )


def test_pack_sharded_auto_and_ell_pallas_mesh(coo):
    """pack_sharded_auto resolves (fmt, config) per shard stats; the
    sharded ELL engine matches the float64 oracle on the mesh."""
    from sextans_tpu.format.csr import CSRMatrix
    from sextans_tpu.ops.golden import golden_spmm_exact
    from sextans_tpu.parallel.partition import pack_sharded_auto
    from sextans_tpu.utils.verify import verify

    sharded, choice = pack_sharded_auto(coo, S, n=64, base=CFG)
    assert sharded.n_shards == S
    assert choice["fmt"] == sharded.fmt
    assert len(choice["per_shard"]) == S

    # ELL on the mesh, row- and K-sharded, agrees with golden
    ell = pack_sharded(coo, S, SpmmConfig(tile_m=64, ell_r=4), fmt="ell")
    rng = np.random.default_rng(5)
    b = rng.standard_normal((coo.shape[1], 64)).astype(np.float32)
    c = rng.standard_normal((coo.shape[0], 64)).astype(np.float32)
    want = golden_spmm_exact(CSRMatrix.from_coo(coo), b, 0.85, -2.06, c)
    for bk in ("ell", "auto"):
        plan = ShardedSpmmPlan(ell, 64, backend=bk)
        got = np.asarray(plan(b, 0.85, -2.06, c))
        assert verify(want, got).passed, bk

    ellk = pack_sharded_k(coo, S, SpmmConfig(tile_m=64, ell_r=4), fmt="ell")
    for bk in ("ell", "auto"):
        plank = ShardedSpmmPlanK(ellk, 64, backend=bk)
        got = np.asarray(plank(b, 0.85, -2.06, c))
        assert verify(want, got).passed, f"k-shard {bk}"
