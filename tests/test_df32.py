"""Double-float32 primitives (ops/df32.py) and the precise paths.

The EFT identities (two_sum/two_prod exactness) are asserted on raw jit —
the XLA CPU backend is strict for isolated ops. The precise engines
accumulate in float64 and are asserted to the FAITHFUL band (~1-2 ulp of
max|C|); the hybrid precise composition combines its parts with the EFTs,
whose residuals XLA:CPU may perturb by contracting mul+add chains into FMA
inside larger programs (documented in ops/df32.py).
"""

import numpy as np
import pytest

import jax

from sextans_tpu.format.coo import COOMatrix
from sextans_tpu.format.csr import CSRMatrix
from sextans_tpu.format.pack import pack
from sextans_tpu.ops.df32 import acc_step, compensated_epilogue, two_prod, two_sum
from sextans_tpu.ops.golden import golden_spmm_exact
from sextans_tpu.ops.plan import SpmmPlan
from sextans_tpu.utils.config import SpmmConfig


def _rand_coo(rng, m, k, nnz):
    lin = rng.choice(m * k, size=nnz, replace=False).astype(np.int64)
    return COOMatrix(
        (m, k),
        (lin // k).astype(np.int32),
        (lin % k).astype(np.int32),
        rng.standard_normal(nnz).astype(np.float32),
    )


def test_two_sum_exact():
    rng = np.random.default_rng(0)
    a = (
        rng.standard_normal(4096)
        * 10.0 ** rng.integers(-6, 6, 4096).astype(np.float64)
    ).astype(np.float32)
    b = (
        rng.standard_normal(4096)
        * 10.0 ** rng.integers(-6, 6, 4096).astype(np.float64)
    ).astype(np.float32)
    s, e = jax.jit(two_sum)(a, b)
    lhs = np.asarray(s).astype(np.float64) + np.asarray(e).astype(np.float64)
    np.testing.assert_array_equal(
        lhs, a.astype(np.float64) + b.astype(np.float64)
    )


def test_two_prod_exact():
    rng = np.random.default_rng(1)
    a = rng.standard_normal(4096).astype(np.float32)
    b = rng.standard_normal(4096).astype(np.float32)
    p, e = jax.jit(two_prod)(a, b)
    lhs = np.asarray(p).astype(np.float64) + np.asarray(e).astype(np.float64)
    np.testing.assert_array_equal(
        lhs, a.astype(np.float64) * b.astype(np.float64)
    )


def test_acc_step_dot_product_near_floor():
    """A 512-term EFT dot via acc_step lands within ~1 ulp of f64 (the
    faithful band; exact on strict backends)."""
    rng = np.random.default_rng(2)
    k = 512
    x = rng.standard_normal(k).astype(np.float32)
    y = rng.standard_normal(k).astype(np.float32)

    @jax.jit
    def eft_dot(x, y):
        acc = jax.numpy.float32(0.0)
        comp = jax.numpy.float32(0.0)
        for j in range(k):
            p, pe = two_prod(x[j], y[j])
            acc, comp = acc_step(acc, comp, p, pe)
        return compensated_epilogue(jax.numpy.float32(1.0), acc, comp)

    got = float(eft_dot(x, y))
    exact = float(np.dot(x.astype(np.float64), y.astype(np.float64)))
    assert abs(got - exact) <= 1.5 * np.spacing(np.float32(abs(exact)))


def test_compensated_epilogue_alpha_beta():
    rng = np.random.default_rng(3)
    total = rng.standard_normal((8, 128)).astype(np.float32) * 10
    comp = (rng.standard_normal((8, 128)) * 1e-6).astype(np.float32)
    cin = rng.standard_normal((8, 128)).astype(np.float32)
    alpha, beta = np.float32(0.85), np.float32(-2.06)
    got = np.asarray(
        jax.jit(compensated_epilogue)(alpha, total, comp, beta, cin)
    ).astype(np.float64)
    exact = np.float64(alpha) * (
        total.astype(np.float64) - comp.astype(np.float64)
    ) + np.float64(beta) * cin.astype(np.float64)
    err = np.abs(got - exact)
    tol = 1.5 * np.spacing(np.abs(exact).astype(np.float32)).astype(np.float64)
    assert (err <= tol).all()


@pytest.mark.parametrize("precise", [1, 2])
def test_vpu_precise_levels_faithful(precise):
    """Both precise levels hold the faithful band vs the f64 oracle and
    level>=1 beats the plain kernel."""
    rng = np.random.default_rng(4)
    m = k = 256
    coo = _rand_coo(rng, m, k, 6000)
    csr = CSRMatrix.from_coo(coo)
    n = 16
    b = rng.standard_normal((k, n)).astype(np.float32)
    c = rng.standard_normal((m, n)).astype(np.float32)
    exact = golden_spmm_exact(csr, b, 0.85, -2.06, c)
    ulp = np.spacing(np.float32(np.abs(exact).max()))

    cfgk = dict(tile_m=128, window_k=256, group_blocks=16)
    base = SpmmPlan(pack(coo, SpmmConfig(**cfgk)), n, backend="xla")
    err0 = np.abs(np.asarray(base(b, 0.85, -2.06, c)) - exact).max()
    p = SpmmPlan(pack(coo, SpmmConfig(precise=precise, **cfgk)), n,
                 backend="xla")
    err = np.abs(np.asarray(p(b, 0.85, -2.06, c)) - exact).max()
    assert err <= 2.0 * ulp  # faithful band (CPU contraction caveat)
    assert err <= err0


def test_ell_pallas_precise_with_fold():
    """ELL precise: float64 slot accumulation and hub fold (the plan enables
    x64 itself) — a hub-heavy matrix exercises the virtual-row fold, and
    ``auto`` takes the float64 engine for a precise pack."""
    from sextans_tpu.format.pack_ell import pack_ell

    rng = np.random.default_rng(5)
    m = k = 256
    rows = rng.integers(0, m, 4000).astype(np.int32)
    rows[:1500] = 7  # hub row
    cols = rng.integers(0, k, 4000).astype(np.int32)
    # dedupe to keep pack-vs-oracle bitwise comparable
    lin = np.unique(rows.astype(np.int64) * k + cols)
    coo = COOMatrix((m, k), (lin // k).astype(np.int32),
                    (lin % k).astype(np.int32),
                    rng.standard_normal(lin.size).astype(np.float32))
    csr = CSRMatrix.from_coo(coo)
    n = 16
    b = rng.standard_normal((k, n)).astype(np.float32)
    c = rng.standard_normal((m, n)).astype(np.float32)
    exact = golden_spmm_exact(csr, b, 0.85, -2.06, c)
    ulp = np.spacing(np.float32(np.abs(exact).max()))

    pk = pack_ell(coo, SpmmConfig(precise=True, tile_m=256))
    assert pk.fold_rows.size > 0, "hub row must produce virtual rows"
    plan = SpmmPlan(pk, n, backend="auto")
    assert plan.backend == "ell"
    got = np.asarray(plan(b, 0.85, -2.06, c))
    err = np.abs(got - exact).max()
    assert err <= 2.0 * ulp


def test_hybrid_precise_composition():
    """HybridSpmmPlan(precise=...) matches the f64 oracle to the faithful
    band on a diag+hub+residue matrix."""
    from sextans_tpu.ops.hybrid import HybridSpmmPlan, split_structure

    rng = np.random.default_rng(6)
    m = k = 384
    # stencil diagonals + hub column + scattered residue
    rows_d = np.arange(m, dtype=np.int32)
    entries = [
        (rows_d, rows_d),
        (rows_d[:-1], rows_d[:-1] + 1),
        (np.arange(m, dtype=np.int32), np.full(m, 11, dtype=np.int32)),
    ]
    rr = rng.integers(0, m, 2000).astype(np.int32)
    cc = rng.integers(0, k, 2000).astype(np.int32)
    entries.append((rr, cc))
    rows = np.concatenate([e[0] for e in entries])
    cols = np.concatenate([e[1] for e in entries])
    lin = np.unique(rows.astype(np.int64) * k + cols)
    coo = COOMatrix((m, k), (lin // k).astype(np.int32),
                    (lin % k).astype(np.int32),
                    rng.standard_normal(lin.size).astype(np.float32))
    csr = CSRMatrix.from_coo(coo)
    n = 16
    b = rng.standard_normal((k, n)).astype(np.float32)
    c = rng.standard_normal((m, n)).astype(np.float32)
    exact = golden_spmm_exact(csr, b, 0.85, -2.06, c)
    ulp = np.spacing(np.float32(np.abs(exact).max()))

    split = split_structure(coo, n=n)
    fast = HybridSpmmPlan(split, n)
    err_fast = np.abs(np.asarray(fast(b, 0.85, -2.06, c)) - exact).max()
    prec = HybridSpmmPlan(split, n, precise=2)
    err_prec = np.abs(np.asarray(prec(b, 0.85, -2.06, c)) - exact).max()
    assert err_prec <= 2.0 * ulp
    assert err_prec <= err_fast


def test_precise_config_levels_validate():
    assert SpmmConfig(precise=2).precise == 2
    with pytest.raises(ValueError):
        SpmmConfig(precise=3)
