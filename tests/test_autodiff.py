"""Differentiable SpMM tests (ops/autodiff.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sextans_tpu.format.coo import COOMatrix
from sextans_tpu.ops.autodiff import spmm_op
from sextans_tpu.utils.config import SpmmConfig

CFG = SpmmConfig(tile_m=32, window_k=128, block_k=8, group_blocks=16)


def _setup(m=60, k=80, n=16, nnz=500, seed=3):
    coo = COOMatrix.random(m, k, nnz, seed=seed)
    rng = np.random.default_rng(seed + 1)
    b = jnp.asarray(rng.standard_normal((k, n)).astype(np.float32))
    c = jnp.asarray(rng.standard_normal((m, n)).astype(np.float32))
    return coo, b, c


def test_forward_matches_dense():
    coo, b, c = _setup()
    op = spmm_op(coo, 16, 0.85, -2.06, backend="xla", config=CFG)
    dense = jnp.asarray(coo.to_dense())
    want = 0.85 * dense @ b + (-2.06) * c
    got = op(b, c)
    assert np.max(np.abs(np.asarray(got - want))) < 1e-4


def test_grad_wrt_b_is_alpha_at_g():
    coo, b, c = _setup(seed=7)
    alpha, beta = 1.7, 0.3
    op = spmm_op(coo, 16, alpha, beta, backend="xla", config=CFG)
    g = jnp.asarray(
        np.random.default_rng(9).standard_normal((60, 16)).astype(np.float32)
    )
    _, vjp = jax.vjp(op, b, c)
    db, dc = vjp(g)
    dense = np.asarray(coo.to_dense(), dtype=np.float64)
    want_db = alpha * dense.T @ np.asarray(g, dtype=np.float64)
    want_dc = beta * np.asarray(g, dtype=np.float64)
    assert np.max(np.abs(np.asarray(db) - want_db)) < 1e-4
    assert np.max(np.abs(np.asarray(dc) - want_dc)) < 1e-5


def test_grad_of_scalar_loss():
    coo, b, c = _setup(seed=11)
    op = spmm_op(coo, 16, 1.0, 0.5, backend="xla", config=CFG)

    def loss(b_):
        return jnp.sum(op(b_, c) ** 2)

    g_auto = jax.grad(loss)(b)
    # finite differences on a few coordinates
    rng = np.random.default_rng(0)
    for _ in range(4):
        i, j = rng.integers(0, b.shape[0]), rng.integers(0, b.shape[1])
        eps = 1e-2
        bp = b.at[i, j].add(eps)
        bm = b.at[i, j].add(-eps)
        fd = (loss(bp) - loss(bm)) / (2 * eps)
        assert abs(float(g_auto[i, j]) - float(fd)) < 2e-1 + 0.05 * abs(float(fd))


def test_jit_compatible():
    coo, b, c = _setup(seed=13)
    op = spmm_op(coo, 16, 1.0, 0.0, backend="xla", config=CFG)
    f = jax.jit(lambda b_, c_: op(b_, c_).sum())
    assert np.isfinite(float(f(b, c)))


# ---- full differentiable form: op(vals, b, c, alpha, beta) ----

from sextans_tpu.ops.autodiff import spmm_value_op  # noqa: E402


def _dense_of(coo, vals):
    d = np.zeros(coo.shape, dtype=np.float64)
    np.add.at(d, (coo.rows, coo.cols), np.asarray(vals, dtype=np.float64))
    return d


@pytest.mark.parametrize("fmt,cfg", [
    ("vpu", CFG),
    ("mxu", SpmmConfig(tile_m=128, window_k=128, block_k=8, group_blocks=4)),
    ("edge", SpmmConfig(tile_m=64, window_k=128, edge_chunk=128)),
    ("ell", SpmmConfig(tile_m=32, ell_r=4)),
])
def test_value_op_all_grads(fmt, cfg):
    coo, b, c = _setup(seed=21)
    op = spmm_value_op(coo, 16, backend="auto", config=cfg, fmt=fmt)
    vals = jnp.asarray(coo.vals)
    alpha, beta = jnp.float32(1.3), jnp.float32(-0.7)
    g = jnp.asarray(
        np.random.default_rng(5).standard_normal((60, 16)).astype(np.float32)
    )

    out, vjp = jax.vjp(op, vals, b, c, alpha, beta)
    dvals, db, dc, dalpha, dbeta = vjp(g)

    dense = _dense_of(coo, vals)
    g64 = np.asarray(g, dtype=np.float64)
    b64 = np.asarray(b, dtype=np.float64)
    # forward
    want = 1.3 * dense @ b64 + (-0.7) * np.asarray(c, np.float64)
    assert np.max(np.abs(np.asarray(out) - want)) < 1e-3
    # dB = alpha A^T G ; dC = beta G
    assert np.max(np.abs(np.asarray(db) - 1.3 * dense.T @ g64)) < 1e-3
    assert np.max(np.abs(np.asarray(dc) - (-0.7) * g64)) < 1e-5
    # dvals (SDDMM): alpha * (G B^T) sampled at the pattern
    want_dvals = 1.3 * np.einsum(
        "en,en->e", g64[coo.rows], b64[coo.cols]
    )
    assert np.max(np.abs(np.asarray(dvals) - want_dvals)) < 1e-3
    # dalpha = <G, A@B>, dbeta = <G, C>
    assert abs(float(dalpha) - float(np.vdot(g64, dense @ b64))) < 1e-2
    assert abs(float(dbeta) - float(np.vdot(g64, np.asarray(c, np.float64)))) < 1e-2


def test_value_op_finite_differences():
    """jax.grad vs central finite differences on vals, alpha, beta."""
    coo, b, c = _setup(m=40, k=50, n=8, nnz=200, seed=31)
    cfg = SpmmConfig(tile_m=32, window_k=64, block_k=8, group_blocks=16)
    op = spmm_value_op(coo, 8, backend="xla", config=cfg)
    vals0 = jnp.asarray(coo.vals)

    def loss(vals, alpha, beta):
        return jnp.sum(op(vals, b, c, alpha, beta) ** 2)

    gv, ga, gb = jax.grad(loss, argnums=(0, 1, 2))(vals0, 0.9, -0.4)
    rng = np.random.default_rng(2)
    for idx in rng.integers(0, coo.nnz, size=4):
        eps = 1e-2
        fp = loss(vals0.at[idx].add(eps), 0.9, -0.4)
        fm = loss(vals0.at[idx].add(-eps), 0.9, -0.4)
        fd = (float(fp) - float(fm)) / (2 * eps)
        assert abs(float(gv[idx]) - fd) < 2e-1 + 0.05 * abs(fd)
    eps = 1e-2
    fd_a = (float(loss(vals0, 0.9 + eps, -0.4))
            - float(loss(vals0, 0.9 - eps, -0.4))) / (2 * eps)
    assert abs(float(ga) - fd_a) < 2e-1 + 0.01 * abs(fd_a)
    fd_b = (float(loss(vals0, 0.9, -0.4 + eps))
            - float(loss(vals0, 0.9, -0.4 - eps))) / (2 * eps)
    assert abs(float(gb) - fd_b) < 2e-1 + 0.01 * abs(fd_b)


def test_value_op_under_jit_and_grad_composition():
    coo, b, c = _setup(seed=41)
    op = spmm_value_op(coo, 16, backend="xla", config=CFG)
    vals = jnp.asarray(coo.vals)

    @jax.jit
    def train_step(vals, b, alpha):
        def loss(v, b_, a_):
            return jnp.mean(op(v, b_, c, a_, jnp.float32(0.1)) ** 2)

        l, grads = jax.value_and_grad(loss, argnums=(0, 1, 2))(vals, b, alpha)
        return l, grads

    l, (gv, gb2, ga) = train_step(vals, b, jnp.float32(1.0))
    assert np.isfinite(float(l))
    assert gv.shape == (coo.nnz,) and np.isfinite(np.asarray(gv)).all()
    assert gb2.shape == b.shape and np.isfinite(np.asarray(gb2)).all()
    assert np.isfinite(float(ga))
