"""Differentiable SpMM: gradients through C = alpha * A @ B + beta * C.

Beyond-reference capability that falls naturally out of a JAX-native design:
the reference is a fixed-function accelerator (no training story), but a JAX
SpMM framework slots into learned pipelines — graph networks and sparse
attention need gradients w.r.t. *everything*:

    d/dB     = alpha * A^T @ G            (another SpMM, transpose pack)
    d/dC     = beta * G
    d/dvals  = alpha * (G @ B^T)|_pattern (SDDMM, sampled at A's nonzeros)
    d/dalpha = <G, A@B>
    d/dbeta  = <G, C>

``spmm_value_op`` exposes the full form op(vals, b, c, alpha, beta): A's
*structure* is static (packed once, steering arrays fixed) while A's
*values* are a traced input — they are scattered into the packed buffer on
device through the COO→slot map (format/slots.py), so the forward runs the
same engines as the inference path. ``spmm_op`` keeps the simple
op(b, c) convenience with vals/alpha/beta closed over.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from sextans_tpu.format.coo import COOMatrix
from sextans_tpu.format.slots import slot_map
from sextans_tpu.ops.plan import SpmmPlan
from sextans_tpu.utils.config import SpmmConfig, round_up

__all__ = ["spmm_op", "spmm_value_op"]

_SDDMM_CHUNK = 65536  # bounds the (chunk, N) gather intermediates


def _pack_fmt(a: COOMatrix, cfg: SpmmConfig, fmt: str):
    if fmt == "mxu":
        from sextans_tpu.format.pack_mxu import pack_mxu

        return pack_mxu(a, cfg)
    if fmt == "edge":
        from sextans_tpu.format.pack_edge import pack_edge

        return pack_edge(a, cfg)
    if fmt == "ell":
        from sextans_tpu.format.pack_ell import pack_ell

        return pack_ell(a, cfg)
    from sextans_tpu.format.pack import pack

    return pack(a, cfg)


def _sddmm(g, b, rows, cols):
    """dvals[e] = g[rows[e], :] . b[cols[e], :], chunked so the gathered
    (chunk, N) intermediates never exceed ~_SDDMM_CHUNK * N floats."""
    nnz = rows.shape[0]
    if nnz <= _SDDMM_CHUNK:
        return jnp.einsum("en,en->e", g[rows], b[cols])
    pad = round_up(nnz, _SDDMM_CHUNK) - nnz
    rp = jnp.pad(rows, (0, pad)).reshape(-1, _SDDMM_CHUNK)
    cp = jnp.pad(cols, (0, pad)).reshape(-1, _SDDMM_CHUNK)

    def chunk(rc):
        r, c = rc
        return jnp.einsum("en,en->e", g[r], b[c])

    out = jax.lax.map(chunk, (rp, cp))
    return out.reshape(-1)[:nnz]


def spmm_value_op(
    a: COOMatrix,
    n: int,
    *,
    backend: str = "auto",
    config: Optional[SpmmConfig] = None,
    fmt: str = "vpu",
):
    """Build the fully differentiable ``op(vals, b, c, alpha, beta)``.

    * ``vals`` — (nnz,) values of A in ``a``'s COO entry order (the
      structure — coordinates, tiling, steering — is baked at build time);
    * gradients flow to all five arguments (see module docstring);
    * ``fmt`` selects the packed format ("vpu", "mxu", "edge", "ell") for
      both the forward product and the A^T backward product.

    The returned callable is jit-compatible and works under
    ``jax.grad`` / ``jax.vjp`` / ``jax.value_and_grad``.
    """
    cfg = config or SpmmConfig()
    m, k = a.shape
    packed = _pack_fmt(a, cfg, fmt)
    packed_t = _pack_fmt(a.transpose(), cfg, fmt)
    fwd_plan = SpmmPlan(packed, n, backend=backend)
    bwd_plan = SpmmPlan(packed_t, n, backend=bwd_backend(backend, fwd_plan))
    slots = jnp.asarray(slot_map(a, cfg, fmt))
    slots_t = jnp.asarray(slot_map(a.transpose(), cfg, fmt))
    vshape = packed.vals.shape
    vtshape = packed_t.vals.shape
    rows_dev = jnp.asarray(a.rows.astype(np.int32))
    cols_dev = jnp.asarray(a.cols.astype(np.int32))

    def _scatter(vals, slot_idx, shape):
        flat = jnp.zeros((int(np.prod(shape)),), jnp.float32)
        return flat.at[slot_idx].add(vals).reshape(shape)

    def _ab(vals, b):
        """A(vals) @ b — unscaled product through the packed kernel."""
        pv = _scatter(vals, slots, vshape)
        return fwd_plan._jit_noc((pv, *fwd_plan._dev[1:]), b, jnp.float32(1.0))

    def _atg(vals, g):
        """A(vals)^T @ g through the transpose pack."""
        pv = _scatter(vals, slots_t, vtshape)
        return bwd_plan._jit_noc((pv, *bwd_plan._dev[1:]), g, jnp.float32(1.0))

    @jax.custom_vjp
    def op(vals, b, c, alpha, beta):
        ab = _ab(vals, b)
        return alpha * ab + beta * c

    def op_fwd(vals, b, c, alpha, beta):
        ab = _ab(vals, b)
        return alpha * ab + beta * c, (vals, b, c, alpha, beta, ab)

    def op_bwd(res, g):
        vals, b, c, alpha, beta, ab = res
        g = g.astype(jnp.float32)
        db = alpha * _atg(vals, g)
        dc = beta * g
        dvals = alpha * _sddmm(g, b, rows_dev, cols_dev)
        dalpha = jnp.vdot(g, ab)
        dbeta = jnp.vdot(g, c)
        return dvals, db, dc, dalpha, dbeta

    op.defvjp(op_fwd, op_bwd)
    return op


def bwd_backend(backend: str, fwd_plan: SpmmPlan) -> str:
    """The transpose pack is the same format family, so reuse the forward
    plan's *resolved* backend (an explicit request passes through)."""
    return backend if backend != "auto" else fwd_plan.backend


def spmm_op(
    a: COOMatrix,
    n: int,
    alpha: float = 1.0,
    beta: float = 0.0,
    *,
    backend: str = "auto",
    config: Optional[SpmmConfig] = None,
    fmt: str = "vpu",
):
    """Convenience wrapper: ``f(b, c) -> alpha*A@b + beta*c`` with A's
    values, alpha, and beta closed over as constants. Differentiable w.r.t.
    ``b`` and ``c``; use :func:`spmm_value_op` for d/dvals (SDDMM) and
    traced alpha/beta."""
    full = spmm_value_op(a, n, backend=backend, config=config, fmt=fmt)
    vals0 = jnp.asarray(a.vals.astype(np.float32))
    al, be = jnp.float32(alpha), jnp.float32(beta)

    def op(b, c):
        return full(vals0, b, c, al, be)

    return op
