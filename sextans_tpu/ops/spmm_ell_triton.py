"""Pallas/Triton ELL gather kernel for the GPU (format/pack_ell.py).

    AB[i, :] = sum_r vals[i, r] * B[cols[i, r], :]

One program per (row block x N tile). The R slots are looped inside the
program: each loads the block's column indices and values and gathers the
B rows with one array-indexed load into registers, skipping pad slots
(value 0), so a non-finite B row cannot leak through them. The accumulator
stays in registers and the alpha/beta epilogue is fused into the store.
There is no ``pl.dot``, so nothing runs in TF32.

C comes at the caller's row count ``m_c`` (at least ``m_base``, the real
rows) and the result has the same rows: a plan passes C unpadded and gets
exactly M rows back, with no padded copy of C or of the result. Rows from
``m_base`` on are scratch for the caller to drop. Virtual hub rows run as a
second launch of the same kernel without C and are folded into their real
rows by one scatter-add.

The kernel accumulates in float32 only; precise packs take the XLA engine
(ops/engines.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["spmm_ell_triton", "ell_blocks"]

# Accumulator elements per program: block_m * block_n float32 values spread
# over NUM_WARPS * 32 threads (32 registers each). 4096 beat 8192 and 16384
# on the H100 at N = 16, 128 and 512 (PERF.md).
ACC_ELEMS = 4096
NUM_WARPS = 4
NUM_STAGES = 3


def ell_blocks(n: int) -> tuple[int, int]:
    """``(block_m, block_n)`` for output width ``n``: a power-of-two N tile
    of at most 128 columns and as many rows as fill ``ACC_ELEMS``."""
    block_n = min(128, pl.next_power_of_2(max(n, 1)))
    block_m = max(16, min(256, ACC_ELEMS // block_n))
    return block_m, block_n


def _kernel(ab_ref, vals_ref, cols_ref, b_ref, *refs, row0, n_rows, r, n,
            block_m, block_n, with_c):
    c_ref, out_ref = refs if with_c else (None, refs[0])
    local = pl.program_id(0) * block_m + jnp.arange(block_m, dtype=jnp.int32)
    ncol = pl.program_id(1) * block_n + jnp.arange(block_n, dtype=jnp.int32)
    row_ok = local < n_rows
    col_ok = ncol < n
    rows = (row0 + local)[:, None]

    def slot(s, acc):
        s_col = jnp.full((block_m, 1), s, jnp.int32)
        v = plgpu.load(vals_ref.at[rows, s_col], mask=row_ok[:, None],
                       other=0.0)
        col = plgpu.load(cols_ref.at[rows, s_col], mask=row_ok[:, None],
                         other=0)
        brow = plgpu.load(b_ref.at[col, ncol[None, :]],
                          mask=(v != 0.0) & col_ok[None, :], other=0.0)
        return acc + v * brow

    acc = jax.lax.fori_loop(
        0, r, slot, jnp.zeros((block_m, block_n), jnp.float32)
    )
    out = ab_ref[0] * acc
    idx = (local[:, None], ncol[None, :])
    mask = row_ok[:, None] & col_ok[None, :]
    if with_c:
        out = out + ab_ref[1] * plgpu.load(c_ref.at[idx], mask=mask, other=0.0)
    plgpu.store(out_ref.at[idx], out, mask=mask)


def _launch(ab, vals, cols, b, c, *, row0, n_rows, interpret):
    """alpha * (rows row0 .. row0+n_rows of A) @ B (+ beta * C) as an
    (n_rows, N) array."""
    n = b.shape[1]
    block_m, block_n = ell_blocks(n)
    with_c = c is not None
    kernel = partial(_kernel, row0=row0, n_rows=n_rows, r=vals.shape[1], n=n,
                     block_m=block_m, block_n=block_n, with_c=with_c)
    return pl.pallas_call(
        kernel,
        grid=(pl.cdiv(n_rows, block_m), pl.cdiv(n, block_n)),
        out_shape=jax.ShapeDtypeStruct((n_rows, n), jnp.float32),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=interpret,
        name="spmm_ell_gather",
    )(ab, vals, cols, b, *((c,) if with_c else ()))


@partial(jax.jit, static_argnames=("m_base", "with_c", "interpret"))
def spmm_ell_triton(
    vals: jax.Array,  # (m_padded, R) f32
    cols: jax.Array,  # (m_padded, R) i32
    fold_rows: jax.Array,  # (n_virt,) i32 — real row per virtual row
    b: jax.Array,  # (k, n) f32
    c: jax.Array,  # (m_c, n) f32, m_base <= m_c <= m_padded
    alpha: jax.Array,
    beta: jax.Array,
    *,
    m_base: int,
    with_c: bool = True,
    interpret: bool = False,
) -> jax.Array:
    """``alpha * A @ B + beta * C`` as an (m_c, n) array; with
    ``with_c=False`` C only gives the row count. ``interpret`` runs the
    kernel in the Pallas interpreter (tests on the CPU)."""
    m_c = c.shape[0]
    ab = jnp.stack([alpha, beta]).astype(jnp.float32)
    out = _launch(ab, vals, cols, b, c if with_c else None, row0=0,
                  n_rows=m_c, interpret=interpret)
    n_virt = fold_rows.shape[0]
    if n_virt:
        virt = _launch(ab, vals, cols, b, None, row0=m_base, n_rows=n_virt,
                       interpret=interpret)
        out = out.at[fold_rows].add(virt, indices_are_sorted=True,
                                    unique_indices=False)
    return out
