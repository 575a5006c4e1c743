"""Plain-XLA gather SpMM engine over the ELL format (format/pack_ell.py).

    AB[i, :] = sum_r vals[i, r] * B[cols[i, r], :]

The R slot terms are one elementwise expression over all rows, which XLA
fuses into a single gather-multiply-add loop writing AB once, so the cost
is bytes: about ``m_padded * R`` gathered B rows per call, whatever the
sparsity pattern (the pack caps slot inflation). Pad slots (value 0) are
selected away, so a non-finite B row cannot leak into rows through them.
Hub rows split at pack time into virtual rows are folded back with one
scatter-add before the alpha/beta epilogue.

C comes at the caller's row count ``m_c`` (``m_base <= m_c <= m_padded``)
and the result has the same rows, so a plan passes C unpadded and gets
exactly M rows back; rows from ``m_base`` on are scratch.

``precise`` accumulates the slots, the fold and the epilogue in float64
and needs x64 enabled at trace time.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from sextans_tpu.ops.spmm_xla import acc_dtype

__all__ = ["spmm_ell_padded", "fold_hub_rows"]


def fold_hub_rows(ab: jax.Array, fold_rows: jax.Array, m_base: int):
    """Add virtual rows [m_base, m_base + n_virt) of ``ab`` into their real
    rows ``fold_rows`` (ascending, duplicates accumulate). The virtual rows
    themselves stay in ``ab``; callers slice them away."""
    n_virt = fold_rows.shape[0]
    if not n_virt:
        return ab
    return ab.at[fold_rows].add(
        jax.lax.dynamic_slice_in_dim(ab, m_base, n_virt, 0),
        indices_are_sorted=True,
        unique_indices=False,
    )


@partial(jax.jit, static_argnames=("m_base", "with_c", "precise"))
def spmm_ell_padded(
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
    precise: int = 0,
) -> jax.Array:
    acc_dt = acc_dtype(precise)

    def slot(r_i):
        # pad slots (value 0) contribute 0 even where B holds Inf or NaN
        v = vals[:, r_i, None].astype(acc_dt)
        term = v * jnp.take(b, cols[:, r_i], axis=0).astype(acc_dt)
        return jnp.where(v != 0, term, 0)

    ab = slot(0)
    for r_i in range(1, vals.shape[1]):
        ab = ab + slot(r_i)
    ab = fold_hub_rows(ab, fold_rows, m_base)[: c.shape[0]]
    out = alpha.astype(acc_dt) * ab
    if with_c:
        out = out + beta.astype(acc_dt) * c.astype(acc_dt)
    return out.astype(jnp.float32)
